"""The port's LLM learner step (``Model.forward``, ``launch/steps.py``,
``launch/specs.py``, ``launch/train.py``, the optimizer schedules) against
the reference on the CPU, on the reduced qwen2 (2 layers, d 256, 4 heads
over 2 KV heads, h 64, vocab 512) in float32.

Weights are initialised by the JAX package and moved over with
``bridge.params_from_jax``; the batch is the reference's ``make_batch``
handed over as numpy.  Tolerances:
  * 2e-5 abs for logits and values (the same float32 arithmetic summed in
    another order through two layers);
  * 1e-5 abs for the loss metrics; 1e-6 abs + 1e-4 * |g| for gradients
    (sums over the batch, the sequence and a 512-wide vocabulary in
    another order);
  * 1e-6 abs for the updated params.  Adam's first step is
    lr * g / (|g| + 1e-8), close to lr * sign(g) and well conditioned
    wherever |g| >> 1e-8; the comparison is made where |g| >= 1e-6 and the
    rest is asserted to move by at most lr (+ 1e-6 for the float32
    rounding of p + u near |p| = 1).
  * 1e-6 rel for schedules.
"""

import dataclasses
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_reduced_config as jax_reduced_config
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.models.model import make_model as jax_make_model
from repro_torch import bridge, optim
from repro_torch.configs.base import get_reduced_config
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import specs, steps, train
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4


def _cfgs(**kw):
    kw = {"param_dtype": "float32", **kw}
    return (dataclasses.replace(jax_reduced_config("qwen2-1.5b"), **kw),
            dataclasses.replace(get_reduced_config("qwen2-1.5b"), **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(unroll: bool):
    jcfg, _ = _cfgs()
    return jax.jit(jax_make_model(jcfg, unroll=unroll).init)(jax.random.key(0))


def _models(unroll=False, **kw):
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jcfg, cfg = _cfgs(**kw)
    jparams = _jax_params(unroll)
    model = Model(cfg, unroll=unroll)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device=CPU, stacked=model.stacked)
    return jax_make_model(jcfg, unroll=unroll), jparams, model, params


@functools.lru_cache(maxsize=None)
def _jax_batch(B=2, T=32):
    jcfg, _ = _cfgs()
    return jspecs.make_batch(jcfg, B, T, rng=jax.random.key(1))


def _torch_batch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def _err(want, got) -> float:
    return float(np.abs(np.asarray(want, np.float64)
                        - got.detach().double().numpy()).max())


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("remat", ["layer", "none"])
@pytest.mark.parametrize("unroll", [False, True])
def test_forward_matches_reference(unroll, remat):
    jmodel, jparams, model, params = _models(unroll, remat=remat)
    assert model.stacked == (not unroll) == ("blocks" in params)
    jbatch = _jax_batch()
    want_logits, want_values, want_aux = jax.jit(jmodel.forward)(jparams,
                                                                 jbatch)
    logits, values, aux = model.forward(params, _torch_batch(jbatch))
    assert logits.dtype == values.dtype == aux.dtype == torch.float32
    assert logits.shape == (2, 32, 512) and values.shape == (2, 32)
    assert aux.shape == () and aux.item() == float(want_aux) == 0.0
    assert _err(want_logits, logits) < 2e-5
    assert _err(want_values, values) < 2e-5


@pytest.mark.parametrize("remat,per_step", [("layer", 2), ("none", 1)])
def test_remat_recomputes_each_layer_forward_once(monkeypatch, remat,
                                                  per_step):
    """With remat "layer" the backward reruns each layer's forward, so the
    attention forward runs 2 x layers times a step (the count chip_smoke
    holds the kernel's launches to); without remat once a layer."""
    _, _, model, params = _models(remat=remat)
    calls = []
    plain = fa_ref.flash_attention_ref

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(fa_ref, "flash_attention_ref", counted)
    grad_fn = steps.make_grad_fn(model)
    grad_fn(params, _torch_batch(_jax_batch()))
    assert len(calls) == per_step * model.cfg.num_layers


def test_prefill_step_matches_reference():
    jmodel, jparams, model, params = _models()
    jbatch = _jax_batch()
    want = jax.jit(jsteps.make_prefill_step(jmodel))(jparams, jbatch)
    got = steps.make_prefill_step(model)(params, _torch_batch(jbatch))
    for w, g in zip(want, got):
        assert not g.requires_grad and _err(w, g) < 2e-5


# --------------------------------------------------------------- train step


@pytest.mark.parametrize("unroll", [False, True])
def test_loss_metrics_and_gradients_match_reference(unroll):
    jmodel, jparams, model, params = _models(unroll)
    jbatch = _jax_batch()
    hp = jsteps.TrainHParams()
    jgrads, jmetrics = jax.jit(jax.grad(jsteps.make_loss_fn(jmodel, hp),
                                        has_aux=True))(jparams, jbatch)
    grads, metrics = steps.make_grad_fn(model, steps.TrainHParams())(
        params, _torch_batch(jbatch))
    assert set(metrics) == set(jmetrics) == set(steps.METRIC_KEYS)
    for k in metrics:
        assert metrics[k].shape == () and not metrics[k].requires_grad
        assert abs(float(jmetrics[k]) - metrics[k].item()) < 1e-5, k
    got, want = _flat(grads), _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.all(np.abs(w - g) <= 1e-6 + 1e-4 * np.abs(w)), k


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jmodel, jparams, model, params = _models(microbatches=microbatches)
    jbatch = _jax_batch()
    jopt = jsteps.make_optimizer(jsteps.TrainHParams())
    jgrads, _ = jax.jit(jax.grad(jsteps.make_loss_fn(
        jmodel, jsteps.TrainHParams()), has_aux=True))(jparams, jbatch)
    jstep = jax.jit(jsteps.make_train_step(jmodel, jopt))
    want_params, want_state, want_metrics = jstep(jparams, jopt.init(jparams),
                                                  jbatch)
    opt = steps.make_optimizer(steps.TrainHParams())
    step = steps.make_train_step(model, opt)
    before = tree_map(torch.clone, params)
    got_params, state, metrics = step(params, opt.init(params),
                                      _torch_batch(jbatch))
    assert all(a is b for a, b in zip(leaves(got_params), leaves(params)))
    for k in steps.METRIC_KEYS:
        assert abs(float(want_metrics[k]) - metrics[k].item()) < 1e-5, k
    assert int(state[1].count) == int(want_state[1].count) == 1
    g = _flat(jax.tree.map(np.asarray, jgrads))
    w = _flat(jax.tree.map(np.asarray, want_params))
    b = _flat(before)
    for k, p in _flat(got_params).items():
        p = p.numpy()
        well = np.abs(g[k]) >= 1e-6
        assert np.all(np.abs(w[k] - p)[well] <= 1e-6), k
        assert np.all(np.abs(p - b[k].numpy()) <= LR + 1e-6), k


def test_microbatched_gradients_are_the_mean_of_the_slices():
    _, _, model, params = _models(microbatches=2)
    batch = _torch_batch(_jax_batch(B=4, T=16))
    grad_fn = steps.make_grad_fn(model)
    halves = [grad_fn(params, {k: v[i:i + 2] for k, v in batch.items()})[0]
              for i in (0, 2)]
    want = tree_map(lambda a, b: (a + b) / 2, *halves)
    captured = {}
    opt = optim.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (captured.update(g=g) or
                                            tree_map(torch.zeros_like, g), s))
    steps.make_train_step(model, opt)(params, (), batch)
    for a, b in zip(leaves(captured["g"]), leaves(want)):
        assert a.dtype == torch.float32
        assert torch.allclose(a, b, atol=1e-7)
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(model, opt)(
            params, (), {k: v[:3] for k, v in batch.items()})


# --------------------------------------------------------------- optimizers


def test_warmup_cosine_matches_reference():
    want = joptim.warmup_cosine(LR, warmup=10, total_steps=100)
    got = optim.warmup_cosine(LR, warmup=10, total_steps=100)
    for c in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        w = float(want(jnp.int32(c)))
        g = got(torch.tensor(c, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.shape == ()
        assert abs(w - g.item()) <= 1e-6 * LR, c
    short = optim.warmup_cosine(LR, warmup=10, total_steps=5)  # train.py's
    assert short(torch.tensor(0, dtype=torch.int32)).item() == 0.0


@pytest.mark.parametrize("make", ["adam", "rmsprop"])
def test_optimizers_take_a_schedule(make):
    rng = np.random.default_rng(4)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in p.items()} for _ in range(3)]
    sched = dict(base=0.1, warmup=2, total_steps=6)
    opt = getattr(optim, make)(optim.warmup_cosine(**sched), clip_norm=1.0)
    params = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    state = opt.init(params)
    if make == "adam":  # the reference's adam takes a schedule
        jopt = joptim.adam(joptim.warmup_cosine(**sched), clip_norm=1.0)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        jstate = jopt.init(jp)
    for i, g in enumerate(gs):
        updates, state = opt.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, params)
        params = optim.apply_updates(params, updates)
        if make == "adam":
            ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
            jp = joptim.apply_updates(jp, ju)
            for k in p:
                assert _err(jp[k], params[k]) < 1e-6, (i, k)
    assert int(state[-1]) == 3  # the schedule's count
    if make == "rmsprop":  # lr(0) = 0: the first update moves nothing
        first = getattr(optim, make)(optim.warmup_cosine(**sched))
        u, _ = first.update({k: torch.ones_like(v) for k, v in params.items()},
                            first.init(params), params)
        assert all(float(x.abs().max()) == 0.0 for x in leaves(u))


# --------------------------------------------------------------- batch, CLI


def test_make_batch_has_the_reference_fields():
    jcfg, cfg = _cfgs()
    want = jspecs.make_batch(jcfg, 3, 7, rng=jax.random.key(0))
    got = specs.make_batch(cfg, 3, 7, torch.Generator().manual_seed(0),
                           device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    tok = got["tokens"]
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
    assert bool((got["discounts"] == 0.99).all())
    assert bool((got["behaviour_logp"] <= 0).all())
    again = specs.make_batch(cfg, 3, 7, torch.Generator().manual_seed(0),
                             device="cpu")
    assert all(torch.equal(again[k], got[k]) for k in got)
    with pytest.raises(NotImplementedError, match="Queue 1 #10"):
        specs.make_batch(dataclasses.replace(cfg, family="vlm"), 1, 4,
                         device="cpu")


def test_train_cli_prints_finite_losses_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [ln.split() for ln in proc.stdout.splitlines()
             if ln.startswith("step")]
    assert [ln[1] for ln in lines] == ["0", "2"]
    for ln in lines:
        assert ln[2] == "loss" and ln[4] == "ce" and ln[6] == "tok/s"
        assert math.isfinite(float(ln[3])) and math.isfinite(float(ln[5]))


def test_train_returns_metrics_of_every_step():
    out = train.train("qwen2-1.5b", steps=2, batch=2, seq=16, device="cpu")
    assert len(out["metrics"]) == len(out["step_seconds"]) == 2
    assert all(math.isfinite(v) for m in out["metrics"] for v in m.values())
    assert out["n_params"] == sum(x.numel() for x in leaves(out["params"]))


def test_train_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 #1"):
        train.main(["--arch", "qwen2-1.5b", "--moe-impl", "a2a",
                    "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        train.main(["--arch", "qwen2-1.5b", "--ckpt", "x.npz",
                    "--device", "cpu"])
    # a windowed attention sublayer is ported (#9a): it matches the
    # reference's, forward and gradients, at a window of 2 over 4 steps
    jmodel, jparams, model, params = _models()
    x = np.random.default_rng(0).standard_normal(
        (1, 4, model.cfg.d_model)).astype(np.float32)
    names = ("attn_norm", "attn")
    jp = {n: jax.tree.map(lambda t: t[0], jparams["blocks"][n]) for n in names}
    p = {n: tree_map(lambda t: t[0].detach().requires_grad_(),
                     params["blocks"][n]) for n in names}

    def jfwd(jp, x):
        return jtf.attn_sublayer(jp, x, jnp.arange(4), jmodel.cfg, window=2)

    want = jfwd(jp, jnp.asarray(x))
    # a mean, as the loss is, so the 1e-6 floor is at the loss's scale
    jg, jgx = jax.grad(lambda *a: jnp.mean(jfwd(*a) ** 2), argnums=(0, 1))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tf.attn_sublayer(p, xt, torch.arange(4), model.cfg, window=2)
    (out * out).mean().backward()
    assert _err(want, out) < 2e-5
    assert np.all(np.abs(np.asarray(jgx) - xt.grad.numpy())
                  <= 1e-6 + 1e-4 * np.abs(np.asarray(jgx)))
    got, ref_g = _flat(tree_map(lambda t: t.grad, p)), _flat(jg)
    assert set(got) == set(ref_g)
    for k, w in ref_g.items():
        w = np.asarray(w)
        assert np.all(np.abs(w - got[k].numpy()) <= 1e-6 + 1e-4 * np.abs(w)), k


def test_train_without_device_raises_where_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen2-1.5b", "--steps", "1"])
