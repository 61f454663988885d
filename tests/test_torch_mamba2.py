"""The port's Mamba-2 path (``configs/mamba2_1p3b.py``, ``models/mamba2.py``,
the ssm branch of ``models/model.py``, ``bridge``, ``launch/steps.py`` and
``launch/train.py --arch mamba2-1.3b``) against the reference on the CPU,
on the reduced mamba2 (2 layers, d 256, d_inner 512, 16 heads of P 32,
N 16, chunk 32, vocab 512).

Weights are initialised by the JAX package and moved over with
``bridge.params_from_jax``; token ids, activations and batches come from
seeds and are handed over as numpy.  Tolerances (max abs error):
  * 2e-5 for float32 block outputs, logits and values (the qwen2 path's
    pin, ``tests/test_torch_train.py``): the same float32 arithmetic
    summed in another order; the scan's cumulative decays are summed in
    float64 here and in float32 by the reference, a difference of a few
    ulps of |cum| <= ~60 at chunk 32;
  * bfloat16 outputs are held to the float32 reference on the same
    weights: the port's bf16 error must be within BF16_SLACK of the
    reference's own bf16 error.  The two frameworks round to bf16 at
    other places (jax's silu rounds the sigmoid before the product; the
    matmuls accumulate in another order), so neither bf16 result is the
    other's oracle;
  * 1e-5 for the loss metrics, 1e-6 + 1e-4 * |g| for gradients, and 1e-6
    for params after one Adam step where |g| >= 1e-6, as for qwen2
    (``tests/test_torch_train.py``);
  * exact for the bridge.
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

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_reduced_config as jax_reduced_config
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import mamba2 as jmamba2
from repro.models.model import make_model as jax_make_model
from repro_torch import bridge
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import steps, train
from repro_torch.models import mamba2
from repro_torch.models.model import Model
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b"
LR = 3e-4
BF16_SLACK = 1.25  # the port's bf16 error over the reference's, at most


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced_config(ARCH), **kw),
            dataclasses.replace(get_reduced_config(ARCH), **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


@functools.lru_cache(maxsize=None)
def _jax_params(f32: bool, unroll: bool):
    jcfg, _ = _cfgs(**({"param_dtype": "float32"} if f32 else {}))
    return jax.jit(jax_make_model(jcfg, unroll=unroll).init)(
        jax.random.key(0))


def _models(unroll=False, f32=True, **kw):
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jcfg, cfg = _cfgs(**({"param_dtype": "float32"} if f32 else {}), **kw)
    jparams = _jax_params(f32, unroll)
    model = Model(cfg, unroll=unroll)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device=CPU, stacked=model.stacked)
    return jax_make_model(jcfg, unroll=unroll), jparams, model, params


@functools.lru_cache(maxsize=None)
def _jax_batch(B=2, T=64):
    jcfg, _ = _cfgs()
    return jspecs.make_batch(jcfg, B, T, rng=jax.random.key(1))


def _torch_batch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


# ----------------------------------------------------------- config, params


def test_config_matches_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.d_inner, port.ssm_heads) == (ref.d_inner, ref.ssm_heads)
        assert port.param_count() == ref.param_count()
    full = get_config(ARCH)
    assert (full.d_inner, full.ssm_heads, full.ssm_head_dim) == (4096, 64, 64)
    shapes = jax.eval_shape(jax_make_model(jax_get_config(ARCH)).init,
                            jax.random.key(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(shapes)) == \
        1_343_742_976


@pytest.mark.parametrize("unroll", [False, True])
def test_param_tree_has_the_reference_paths_shapes_dtypes(unroll):
    jcfg, cfg = _cfgs()
    want = _flat(jax.eval_shape(jax_make_model(jcfg, unroll=unroll).init,
                                jax.random.key(0)))
    model = Model(cfg, unroll=unroll)
    assert model.stacked == (not unroll)
    got = _flat(model.init(0, device=CPU))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    prefix = "layer_1/" if unroll else "blocks/"
    assert got[prefix + "mixer/A_log"].dtype == torch.float32
    assert got[prefix + "mixer/in_proj"].dtype == torch.bfloat16


def test_init_constants_match_reference():
    _, cfg = _cfgs()
    p = Model(cfg).init(3, device=CPU)["blocks"]["mixer"]
    assert float(p["A_log"].abs().max()) == 0.0
    assert bool((p["dt_bias"] == 0.5).all()) and bool((p["D"] == 1.0).all())
    assert float(p["conv_b"].abs().max()) == 0.0
    assert abs(float(p["conv_w"].float().std()) - 0.1) < 0.01
    again = Model(cfg).init(3, device=CPU)["blocks"]["mixer"]
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(again)))


@pytest.mark.parametrize("unroll", [False, True])
def test_bridge_carries_the_ssm_tree(unroll):
    """bf16 leaves and the float32 conv_b, A_log, dt_bias and D of a bf16
    model arrive bit for bit, and relayout to the other layer layout and
    back."""
    _, cfg = _cfgs()
    jparams = jax.tree.map(np.asarray, _jax_params(False, unroll))
    want = _flat(jparams)
    same = bridge.params_from_jax(jparams, cfg, device=CPU)
    got = _flat(same)
    assert set(got) == set(want)
    for k, w in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        assert np.array_equal(got[k].float().numpy(), w.astype(np.float32)), k
    dtypes = {k.rsplit("/", 1)[-1]: str(v.dtype) for k, v in want.items()}
    assert dtypes["A_log"] == dtypes["D"] == dtypes["conv_b"] == "float32"
    assert dtypes["in_proj"] == "bfloat16"
    other = bridge.params_from_jax(jparams, cfg, device=CPU, stacked=unroll)
    assert ("blocks" in other) == unroll
    back = _flat(bridge.relayout(other, cfg.num_layers, stacked=not unroll))
    assert set(back) == set(got)
    assert all(torch.equal(back[k], got[k]) for k in got)


# ----------------------------------------------------------------- block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    C = mamba2.conv_dim(cfg)
    p = {"conv_w": (0.1 * rng.standard_normal((4, C))).astype(np.float32),
         "conv_b": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    u = rng.standard_normal((2, 20, C)).astype(np.float32)
    want = jmamba2._causal_conv({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(u).astype(dtype), 4)
    tdt = getattr(torch, dtype)
    got = mamba2._causal_conv({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(u).to(tdt), 4)
    assert got.dtype == tdt
    assert _err(want, got) < (2e-5 if dtype == "float32" else 2e-2)


def _block(f32: bool, x: np.ndarray):
    """(the reference's block output, the port's) on the same weights."""
    jcfg, cfg = _cfgs(**({"param_dtype": "float32"} if f32 else {}))
    jparams = _jax_params(f32, True)["layer_0"]["mixer"]
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device=CPU)
    want = jax.jit(lambda p, x: jmamba2.mamba2_block(p, x, jcfg))(
        jparams, jnp.asarray(x).astype(jnp.float32 if f32 else jnp.bfloat16))
    got = mamba2.mamba2_block(params, torch.from_numpy(x).to(
        torch.float32 if f32 else torch.bfloat16), cfg)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    return want, got


def test_mamba2_block_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 64, 256)).astype(
        np.float32)
    want, got = _block(True, x)
    assert _err(want, got) < 2e-5
    # bf16 (same weights rounded): as close to the float32 block as the
    # reference's bf16 block is
    want16, got16 = _block(False, x)
    assert _err(want, got16) <= BF16_SLACK * _err(want, want16)


# --------------------------------------------------------------- forward


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
    assert logits.shape == (2, 64, 512) and values.shape == (2, 64)
    assert aux.shape == () and aux.item() == float(want_aux) == 0.0
    assert _err(want_logits, logits) < 2e-5
    assert _err(want_values, values) < 2e-5


def test_bf16_forward_is_as_close_to_float32_as_the_reference():
    jmodel, jparams, _, _ = _models()
    jmodel16, jparams16, model16, params16 = _models(f32=False)
    jbatch = _jax_batch()
    want = jax.jit(jmodel.forward)(jparams, jbatch)[:2]
    ref16 = jax.jit(jmodel16.forward)(jparams16, jbatch)[:2]
    got16 = model16.forward(params16, _torch_batch(jbatch))[:2]
    for w, r, g in zip(want, ref16, got16):
        assert _err(w, g) <= BF16_SLACK * _err(w, r)


@pytest.mark.parametrize("remat,per_step", [("layer", 2), ("none", 1)])
def test_remat_runs_the_scan_forward_twice_a_layer_a_step(monkeypatch, remat,
                                                          per_step):
    """With remat "layer" the backward reruns each layer's forward, so the
    scan's forward runs 2 x layers times a step (the count chip_smoke holds
    the kernel's launches to) and its backward none; without remat once a
    layer."""
    _, _, model, params = _models(remat=remat)
    calls = []
    plain = ssd_ref.ssd_chunk_scan_ref

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(ssd_ref, "ssd_chunk_scan_ref", counted)
    steps.make_grad_fn(model)(params, _torch_batch(_jax_batch()))
    assert len(calls) == per_step * model.cfg.num_layers


def test_prefill_step_matches_reference():
    jmodel, jparams, model, params = _models()
    jbatch = _jax_batch()
    want = jax.jit(jsteps.make_prefill_step(jmodel))(jparams, jbatch)
    got = steps.make_prefill_step(model)(params, _torch_batch(jbatch))
    for w, g in zip(want, got):
        assert not g.requires_grad and _err(w, g) < 2e-5


# ------------------------------------------------------------ train step


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
        assert abs(float(jmetrics[k]) - metrics[k].item()) < 1e-5, k
    got, want = _flat(grads), _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.all(np.abs(w - g) <= 1e-6 + 1e-4 * np.abs(w)), k


def test_train_step_matches_reference():
    jmodel, jparams, model, params = _models()
    jbatch = _jax_batch()
    hp = jsteps.TrainHParams()
    jgrads, _ = jax.jit(jax.grad(jsteps.make_loss_fn(jmodel, hp),
                                 has_aux=True))(jparams, jbatch)
    jopt = jsteps.make_optimizer(hp)
    want_params, _, want_metrics = jax.jit(jsteps.make_train_step(
        jmodel, jopt))(jparams, jopt.init(jparams), jbatch)
    opt = steps.make_optimizer(steps.TrainHParams())
    before = tree_map(torch.clone, params)
    got_params, _, metrics = steps.make_train_step(model, opt)(
        params, opt.init(params), _torch_batch(jbatch))
    for k in steps.METRIC_KEYS:
        assert abs(float(want_metrics[k]) - metrics[k].item()) < 1e-5, k
    g = _flat(jax.tree.map(np.asarray, jgrads))
    w = _flat(jax.tree.map(np.asarray, want_params))
    b = _flat(before)
    for k, p in _flat(got_params).items():
        p = p.numpy()
        well = np.abs(g[k]) >= 1e-6
        assert np.all(np.abs(w[k] - p)[well] <= 1e-6), k
        assert np.all(np.abs(p - b[k].numpy()) <= LR + 1e-6), k


def test_published_chunk_gives_finite_gradients_where_the_reference_does_not():
    """The reduced model at the published chunk of 256 over 256 steps: the
    reference's chunk VJP puts NaN in every layer's gradients (all of
    A_log's and dt_bias's), so its global norm is NaN and one clipped step
    makes every param NaN (ROADMAP Queue 3); the port's gradients are
    finite, and its loss is the reference's."""
    jmodel, jparams, model, params = _models(ssm_chunk=256)
    jbatch = _jax_batch(T=256)
    hp = jsteps.TrainHParams()
    jgrads, jmetrics = jax.jit(jax.grad(jsteps.make_loss_fn(jmodel, hp),
                                        has_aux=True))(jparams, jbatch)
    flat = _flat(jgrads)
    assert all(bool(jnp.isnan(v).all()) for k, v in flat.items()
               if k.endswith(("A_log", "dt_bias", "mixer/norm/scale")))
    assert all(bool(jnp.isnan(v).any()) for k, v in flat.items()
               if k.startswith("blocks/"))
    # so the global norm is NaN, and a clipped step makes every param NaN
    assert bool(jnp.isnan(sum(jnp.sum(v.astype(jnp.float32) ** 2)
                              for v in flat.values())))
    grads, metrics = steps.make_grad_fn(model)(params, _torch_batch(jbatch))
    assert all(bool(torch.isfinite(x).all()) for x in leaves(grads))
    assert abs(float(jmetrics["loss"]) - metrics["loss"].item()) < 1e-5


# ------------------------------------------------------- refusals and CLI


def test_ssm_decode_and_serving_entry_points_raise():
    _, cfg = _cfgs()
    model = Model(cfg)
    params = model.init(0, device=CPU)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 1 #10c"):
        model.init_cache(1, 8, device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 #10c"):
        model.decode_step(params, {}, tok, 0)
    with pytest.raises(ValueError, match="prefill_step supports dense/moe"):
        model.prefill_step(params, {}, tok, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="paged cache supports dense/moe"):
        model.init_paged_cache(3, 4, device=CPU)


def test_train_cli_prints_finite_losses_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("mamba2-1.3b: 0.9M params on cpu")
    lines = [ln.split() for ln in proc.stdout.splitlines()
             if ln.startswith("step")]
    assert [ln[1] for ln in lines] == ["0", "1"]
    for ln in lines:
        assert ln[2] == "loss" and ln[4] == "ce" and ln[6] == "tok/s"
        assert math.isfinite(float(ln[3])) and math.isfinite(float(ln[5]))
    assert abs(float(lines[0][5]) - math.log(512)) < 0.5


def test_train_returns_metrics_and_the_param_count():
    out = train.train(ARCH, steps=1, batch=2, seq=32, device="cpu")
    assert out["cfg"].family == "ssm"
    assert out["n_params"] == sum(x.numel() for x in leaves(out["params"]))
    assert all(math.isfinite(v) for v in out["metrics"][0].values())
