"""The port's serving stack (``repro_torch.serve``, ``launch``) against
the reference's, and its own invariants.

The reference's ``ServeEngine`` and the port's run the reduced qwen2 in
float32 on the same weights (moved over with ``bridge.params_from_jax``).

Tolerances and what is held exact:
  * greedy token streams, reference vs port: equal.  The two compute the
    same f32 logits to ~1e-6, far inside the gaps between top logits of
    this model, so argmax agrees;
  * sampled streams cannot be compared across the packages: the
    reference keys its draws on threefry ``fold_in``, the port on a
    counter-based hash (``launch/steps.py``);
  * paged vs dense within the port: token streams equal, greedy and
    sampled.  The paged engine prefills one row at a time ``(1, C)``, the
    dense one all rows ``(B, C)``.  Torch's CPU kernels do not give a row
    the same bits at batch 1 and at batch B (a (1, d) x (d, n) product
    differs from the same row of a (B, d) one; over this model's prefill
    the logits differ by ~7e-7), so the two engines' prefill logits are
    held at 1e-5 and their token streams equal;
  * a request's sampled tokens do not depend on its row or on the batch
    around it: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jax_reduced_config
from repro.models.model import make_model as jax_make_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.api.runner import SERVE_RESULT_KEYS as JAX_SERVE_RESULT_KEYS
from repro_torch import bridge
from repro_torch.api import SERVE_RESULT_KEYS, make_serve_result
from repro_torch.configs.base import get_reduced_config
from repro_torch.launch import serve as launcher
from repro_torch.launch.steps import make_serve_step, request_keys, sample_tokens
from repro_torch.models import Model
from repro_torch.serve import (
    BlockAllocator,
    CacheExhausted,
    Request,
    ServeConfig,
    ServeEngine,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
F32 = dict(param_dtype="float32", cache_dtype="float32")
# (prompt length, new tokens, arrival step): 6 requests whose page demand
# (13 pages of 8 slots) exceeds the 8 allocatable pages of the pool below
SPEC = [(5, 4, 0), (12, 6, 0), (3, 8, 1), (17, 3, 2), (9, 5, 4), (6, 7, 5)]


def _prompts():
    rng = np.random.default_rng(3)
    return [tuple(int(t) for t in rng.integers(0, 512, L)) for L, _, _ in SPEC]


def _requests(cls=Request):
    return [cls(rid=i + 1, prompt=p, max_new_tokens=g, arrival=a)
            for i, (p, (_, g, a)) in enumerate(zip(_prompts(), SPEC))]


def _cfg(cls=ServeConfig, **kw):
    base = dict(batch_rows=3, prefill_chunk=8, token_budget=11, block_size=8,
                num_blocks=9, max_seq=32)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced_config("qwen2-1.5b"), **F32)
    cfg = dataclasses.replace(get_reduced_config("qwen2-1.5b"), **F32)
    jmodel = jax_make_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device=CPU)
    return jmodel, jparams, Model(cfg), params


def test_greedy_engine_matches_reference(models):
    jmodel, jparams, model, params = models
    want = JServeEngine(jmodel, jparams, _cfg(JServeConfig),
                        paged=True).run(_requests(JRequest))
    engine = ServeEngine(model, params, _cfg(), paged=True, device=CPU)
    got = engine.run(_requests())
    assert got["outputs"] == want["outputs"]
    for key in ("completed", "admitted", "preempted", "steps",
                "prefill_chunks", "tokens_prefilled", "tokens_decoded"):
        assert got[key] == want[key], key
    assert engine.allocator.used_blocks == 0  # every page released
    assert engine.decode_steps > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_paged_engine_equals_dense_engine(models, temperature):
    _, _, model, params = models
    cfg = _cfg(temperature=temperature, top_k=8, seed=42)
    paged = ServeEngine(model, params, cfg, paged=True, device=CPU)
    dense = ServeEngine(model, params, cfg, paged=False, device=CPU)
    a, b = paged.run(_requests()), dense.run(_requests())
    assert a["completed"] == b["completed"] == len(SPEC)
    assert a["outputs"] == b["outputs"]


def test_row_prefill_and_batch_prefill_logits_agree(models):
    """The paged engine's (1, C) per-row prefill against the dense
    engine's (B, C) prefill on the same prompts: within 1e-5."""
    _, _, model, params = models
    B, C = 3, 8
    prompts = torch.tensor([list(range(i, i + C)) for i in (3, 40, 100)],
                           dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    dense = model.prefill_step(params, model.init_cache(B, 32, device=CPU),
                               prompts, pos)[0]
    cache = model.init_paged_cache(1 + B * 4, 8, device=CPU)
    tables = torch.arange(1, 1 + B * 4, dtype=torch.int32).reshape(B, 4)
    rows = torch.cat([
        model.prefill_step(params, cache, prompts[r:r + 1], pos[r:r + 1],
                           tables[r:r + 1])[0] for r in range(B)
    ])
    assert (rows - dense).abs().max().item() < 1e-5


def test_preemption_reproduces_the_unpressured_outputs(models):
    """A pool of 4 allocatable pages forces cache-pressure preemption;
    recompute-on-restart with per-request sampling streams still gives
    the outputs of a roomy run."""
    _, _, model, params = models
    kw = dict(temperature=0.8, top_k=8, seed=7)
    roomy = ServeEngine(model, params, _cfg(num_blocks=13, **kw), device=CPU)
    tight = ServeEngine(model, params, _cfg(num_blocks=5, **kw), device=CPU)
    a, b = roomy.run(_requests()), tight.run(_requests())
    assert b["preempted"] > 0 and b["completed"] == len(SPEC)
    assert a["outputs"] == b["outputs"]


def test_engine_counters_and_reset(models):
    _, _, model, params = models
    engine = ServeEngine(model, params, _cfg(num_blocks=13), device=CPU)
    first = engine.run(_requests())
    engine.reset()
    second = engine.run(_requests())
    assert first["outputs"] == second["outputs"]
    assert set(first) == set(SERVE_RESULT_KEYS)
    assert first["tokens_prefilled"] == sum(L for L, _, _ in SPEC)
    assert first["tokens_decoded"] == sum(g - 1 for _, g, _ in SPEC)
    assert 0 < first["cache_occupancy_mean"] <= first["cache_occupancy_peak"] <= 1
    assert first["ttft_p95"] >= first["ttft_p50"] >= 0


def test_engine_defaults_to_the_card(models):
    _, _, model, params = models
    if torch.cuda.is_available():
        assert ServeEngine(model, params, _cfg()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, params, _cfg())


# ---------------------------------------------------------------- sampling


def test_sampling_keyed_by_request_not_row():
    """A request's draw is a function of (seed, rid, token index): moving
    it to another row, or changing the batch around it, changes nothing."""
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 64), np.float32))
    rids = torch.tensor([11, 22, 33, 44], dtype=torch.int32)
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    toks = sample_tokens(logits, request_keys(7, rids, idx),
                         temperature=0.7, top_k=8)
    perm = torch.tensor([2, 0, 3, 1])
    toks_p = sample_tokens(logits[perm], request_keys(7, rids[perm],
                                                      idx[perm]),
                           temperature=0.7, top_k=8)
    assert torch.equal(toks_p, toks[perm])
    alone = sample_tokens(logits[1:2], request_keys(7, rids[1:2], idx[1:2]),
                          temperature=0.7, top_k=8)
    assert alone.item() == toks[1].item()
    toks_s = sample_tokens(logits, request_keys(8, rids, idx),
                           temperature=0.7, top_k=8)
    assert not torch.equal(toks_s, toks)


def test_sampling_greedy_default_top_k_and_distribution():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((3, 32), np.float32))
    keys = request_keys(0, torch.tensor([1, 2, 3]), torch.tensor([0, 0, 0]))
    greedy = torch.argmax(logits, dim=-1).int()
    assert torch.equal(sample_tokens(logits, keys), greedy)
    assert torch.equal(sample_tokens(logits, keys, temperature=2.0, top_k=1),
                       greedy)
    # the Gumbel-max draws follow softmax(logits / T): 20k draws of one
    # request's token stream against 4 categories
    row = torch.tensor([[1.0, 0.0, -1.0, 0.5]])
    n = 20_000
    keys = request_keys(3, torch.full((n,), 5), torch.arange(n))
    draws = sample_tokens(row.expand(n, 4), keys, temperature=1.0)
    freq = torch.bincount(draws.long(), minlength=4).float() / n
    assert (freq - torch.softmax(row[0], -1)).abs().max().item() < 0.015
    top2 = sample_tokens(row.expand(n, 4), keys, temperature=1.0, top_k=2)
    assert set(top2.tolist()) == {0, 3}


def test_serve_step_greedy_and_sampled(models):
    """The static loop's step: greedy by default; with a temperature it
    draws from the per-request streams, as the engine does."""
    _, _, model, params = models
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    logits = model.decode_step(params, model.init_cache(2, 8, device=CPU),
                               toks, pos)[0][:, 0]
    greedy, _ = make_serve_step(model)(
        params, model.init_cache(2, 8, device=CPU), toks, pos)
    assert torch.equal(greedy[:, 0], torch.argmax(logits, -1).int())
    rids, idx = torch.tensor([3, 4]), torch.tensor([1, 2])
    drawn, _ = make_serve_step(model, temperature=0.8, top_k=8, seed=5)(
        params, model.init_cache(2, 8, device=CPU), toks, pos, rids, idx)
    want = sample_tokens(logits, request_keys(5, rids, idx), temperature=0.8,
                         top_k=8)
    assert drawn.shape == (2, 1) and torch.equal(drawn[:, 0], want)


# ------------------------------------------------- copies of the reference


def test_allocator_and_scheduler_copies_behave_as_the_reference():
    alloc = BlockAllocator(5)
    assert [alloc.alloc() for _ in range(4)] == [1, 2, 3, 4]
    with pytest.raises(CacheExhausted):
        alloc.alloc()
    alloc.release(3)
    alloc.release(2)
    assert alloc.alloc() == 2
    with pytest.raises(ValueError):
        alloc.release(0)
    with pytest.raises(ValueError):
        _cfg(max_seq=30).validate()


def test_serve_result_schema_matches_reference():
    assert SERVE_RESULT_KEYS == JAX_SERVE_RESULT_KEYS
    res = make_serve_result(outputs={1: [2, 3]}, seconds=2.0,
                            tokens_prefilled=10, tokens_decoded=10)
    assert res["preempted"] == 0 and res["tokens_per_s"] == pytest.approx(10.0)
    with pytest.raises(TypeError):
        make_serve_result(outputs={}, seconds=1.0, bogus=1)


def test_launcher_serves_engine_then_static(capsys):
    launcher.main(["--arch", "qwen2-1.5b", "--device", "cpu", "--batch", "2",
                   "--gen", "3", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "4 requests x 3 tokens (continuous batching, paged KV)" in out
    assert "2 streams x 3 tokens (static batch)" in out
