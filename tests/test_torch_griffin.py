"""The port's Griffin path (``configs/recurrentgemma_2b.py``,
``models/attention.py:sliding_window_attention``, the windowed
``attn_sublayer``, ``models/griffin.py``, the hybrid branch of
``models/model.py``, ``bridge``, ``launch/steps.py`` and
``launch/train.py --arch recurrentgemma-2b``) against the reference on
the CPU, on the reduced recurrentgemma (3 layers RRA, d 256, 4 heads over
1 KV head, h 64, RG-LRU width 256, window 64, vocab 512).

Weights are initialised by the JAX package and moved over with
``bridge.params_from_jax``; activations and batches come from seeds and
are handed over as numpy.  Tolerances (max abs error):
  * 2e-5 for float32 forwards (attention, the block, logits and values),
    the reference's float32 pin (``tests/test_kernels.py:20-21``): the
    same float32 arithmetic summed in another order, and the RG-LRU scan
    associated another way (``tests/test_torch_rglru_scan.py``);
  * 2e-2 for bfloat16 attention (the reference's bf16 pin); a bf16 block
    or model is held to the float32 reference on the same weights, within
    BF16_SLACK of the reference's own bf16 error, since the two frameworks
    round to bf16 at other places;
  * 1e-5 for the loss metrics, 1e-6 + 1e-4 * |g| for gradients, and 1e-6
    for params after one Adam step where |g| >= 1e-6, as for qwen2
    (``tests/test_torch_train.py``);
  * exact for the bridge and for the embedding scale.
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
from repro.models import attention as jattn
from repro.models import griffin as jgriffin
from repro.models.model import make_model as jax_make_model
from repro_torch import bridge
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.launch import steps, train
from repro_torch.models import attention as attn
from repro_torch.models import griffin
from repro_torch.models.model import Model
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
SEQ = 128  # > the reduced window of 64, so the previous-block path runs
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


def _grads_close(want, got) -> bool:
    want, got = _np(want), _np(got)
    return bool(np.all(np.abs(want - got) <= 1e-6 + 1e-4 * np.abs(want)))


@functools.lru_cache(maxsize=None)
def _jax_params(f32: bool):
    jcfg, _ = _cfgs(**({"param_dtype": "float32"} if f32 else {}))
    return jax.jit(jax_make_model(jcfg).init)(jax.random.key(0))


def _models(f32=True, **kw):
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jcfg, cfg = _cfgs(**({"param_dtype": "float32"} if f32 else {}), **kw)
    jparams = _jax_params(f32)
    model = Model(cfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device=CPU, stacked=model.stacked)
    return jax_make_model(jcfg), jparams, model, params


@functools.lru_cache(maxsize=None)
def _jax_batch(B=2, T=SEQ):
    jcfg, _ = _cfgs()
    return jspecs.make_batch(jcfg, B, T, rng=jax.random.key(1))


def _torch_batch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


# ----------------------------------------------------------- config, params


def test_config_matches_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert get_config(ARCH).param_count() == 2_563_768_320
    shapes = jax.eval_shape(jax_make_model(jax_get_config(ARCH)).init,
                            jax.random.key(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(shapes)) == \
        2_894_576_640


def test_param_tree_has_the_reference_paths_shapes_dtypes():
    jcfg, cfg = _cfgs()
    want = _flat(jax.eval_shape(jax_make_model(jcfg).init,
                                jax.random.key(0)))
    model = Model(cfg)
    assert not model.stacked and model.kinds == ["R", "R", "A"]
    got = _flat(model.init(0, device=CPU))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    assert got["layer_0/recurrent/lam"].dtype == torch.float32
    assert got["layer_0/recurrent/w_a"].dtype == torch.bfloat16
    assert "layer_2/attn/wq" in got and "layer_2/recurrent/lam" not in got


def test_init_constants_match_reference():
    _, cfg = _cfgs()
    p = Model(cfg).init(3, device=CPU)["layer_1"]["recurrent"]
    assert bool((p["lam"] == 0.7).all())
    for name in ("b_a", "b_x", "conv_b"):
        assert p[name].dtype == torch.float32
        assert float(p[name].abs().max()) == 0.0
    assert abs(float(p["conv_w"].float().std()) - 0.1) < 0.01
    again = Model(cfg).init(3, device=CPU)["layer_1"]["recurrent"]
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(again)))


def test_bridge_carries_the_hybrid_tree():
    """bf16 leaves and the float32 lam, biases and norm scales of a bf16
    model arrive bit for bit, in the layer_{i} layout."""
    _, cfg = _cfgs()
    jparams = jax.tree.map(np.asarray, _jax_params(False))
    want = _flat(jparams)
    got = _flat(bridge.params_from_jax(jparams, cfg, device=CPU,
                                       stacked=False))
    assert set(got) == set(want)
    for k, w in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        assert np.array_equal(got[k].float().numpy(), w.astype(np.float32)), k
    dtypes = {k.rsplit("/", 1)[-1]: str(v.dtype) for k, v in want.items()}
    assert dtypes["lam"] == dtypes["b_a"] == dtypes["conv_b"] == "float32"
    assert dtypes["w_branch1"] == "bfloat16"


def test_gemma_embedding_scale_rounds_to_the_param_dtype():
    """sqrt(2560) = 50.596 is 50.5 in bf16: the reference rounds the scale
    first, and so does the port, bit for bit."""
    jmodel, jparams, model, params = _models(f32=False)
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6)
    full = get_config(ARCH)
    assert float(torch.tensor(math.sqrt(full.d_model),
                              dtype=torch.bfloat16)) == 50.5
    want = jmodel._embed(jparams, jnp.asarray(tokens))
    got = model._embed(params, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(want), _np(got))


# ------------------------------------------------- sliding-window attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window,K,softcap", [
    (40, 64, 1, 0.0),   # T < window: one block of T
    (64, 64, 2, 0.0),   # T = window
    (100, 32, 1, 0.0),  # T > window, not a multiple: padding, previous block
    (100, 32, 2, 30.0),  # GQA with the softcap
])
def test_sliding_window_attention_matches_reference(T, window, K, softcap,
                                                     dtype):
    B, H, h = 2, 4, 16
    rng = np.random.default_rng(T + window + K)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, h), (B, T, K, h), (B, T, K, h)))
    do = rng.standard_normal((B, T, H, h)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    js = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda *a: jattn.sliding_window_attention(
        *a, window=window, softcap=softcap), *js)
    jgrads = vjp(jnp.asarray(do).astype(jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    got = attn.sliding_window_attention(*ts, window=window, softcap=softcap)
    got.backward(torch.from_numpy(do).to(tdt))
    assert got.dtype == tdt and got.shape == (B, T, H, h)
    assert _err(want, got) < tol
    for w, t in zip(jgrads, ts):
        assert t.grad.dtype == tdt
        if dtype == "float32":
            assert _err(w, t.grad) < 1e-4
        else:
            assert _err(w, t.grad) < tol * max(float(np.abs(_np(w)).max()),
                                               1.0)


def test_sliding_window_attention_is_local_and_causal():
    """Query t sees keys t - window + 1 .. t only: changing a key outside
    that range changes nothing."""
    B, T, H, K, h, window = 1, 50, 2, 1, 8, 16
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, T, H, h), (B, T, K, h), (B, T, K, h)))
    out = attn.sliding_window_attention(q, k, v, window=window)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20], v2[:, 20] = 5.0, 5.0
    out2 = attn.sliding_window_attention(q, k2, v2, window=window)
    changed = (out2 - out).abs().amax(dim=(0, 2, 3)) > 0
    assert changed.nonzero().flatten().tolist() == list(range(20, 36))


# ----------------------------------------------------------------- block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_and_gates_match_reference(dtype):
    _, cfg = _cfgs()
    jp = jax.tree.map(np.asarray, _jax_params(True)["layer_0"]["recurrent"])
    rng = np.random.default_rng(2)
    jp = {**jp, "conv_b": (0.1 * rng.standard_normal(cfg.rnn_width)).astype(
        np.float32), "b_a": (0.1 * rng.standard_normal(cfg.rnn_width)).astype(
        np.float32)}
    p = bridge.params_from_jax(jp, device=CPU)
    u = rng.standard_normal((2, 20, cfg.rnn_width)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jgriffin._conv1d(jp, jnp.asarray(u).astype(jdt), 4)
    got = griffin._conv1d(p, torch.from_numpy(u).to(tdt), 4)
    assert got.dtype == tdt
    assert _err(want, got) < (2e-5 if dtype == "float32" else 2e-2)
    want_a, want_i = jgriffin._rglru_gates(jp, jnp.asarray(u).astype(jdt))
    got_a, got_i = griffin._rglru_gates(p, torch.from_numpy(u).to(tdt))
    assert got_a.dtype == got_i.dtype == torch.float32
    assert _err(want_a, got_a) < 2e-5 and _err(want_i, got_i) < 2e-5


def _block(f32: bool, x: np.ndarray, dy: np.ndarray | None = None):
    """The reference's and the port's recurrent block on the same weights
    -> (want, got, the reference's grads, the port's grads)."""
    jcfg, cfg = _cfgs(**({"param_dtype": "float32"} if f32 else {}))
    jp = _jax_params(f32)["layer_0"]["recurrent"]
    p = tree_map(lambda t: t.requires_grad_(), bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), device=CPU))
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.bfloat16, torch.bfloat16))
    want, vjp = jax.vjp(lambda p, x: jgriffin.recurrent_block(p, x, jcfg),
                        jp, jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = griffin.recurrent_block(p, xt, cfg)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    if dy is None:
        return want, got, None, None
    jg = vjp(jnp.asarray(dy).astype(jdt))
    got.backward(torch.from_numpy(dy).to(tdt))
    return want, got, jg, ({**tree_map(lambda t: t.grad, p)}, xt.grad)


def test_recurrent_block_forward_and_gradients_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 256)).astype(np.float32)
    dy = (rng.standard_normal((2, 64, 256)) / (2 * 64 * 256)).astype(
        np.float32)
    want, got, (jgp, jgx), (gp, gx) = _block(True, x, dy)
    assert _err(want, got) < 2e-5
    assert _grads_close(jgx, gx)
    want_g, got_g = _flat(jax.tree.map(np.asarray, jgp)), _flat(gp)
    assert set(want_g) == set(got_g)
    for k, w in want_g.items():
        assert got_g[k].dtype == torch.float32, k
        assert _grads_close(w, got_g[k]), k
    # bf16 (same weights rounded): as close to the float32 block as the
    # reference's bf16 block is
    want16, got16, _, _ = _block(False, x)
    assert _err(want, got16) <= BF16_SLACK * _err(want, want16)


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("remat", ["layer", "none"])
def test_forward_matches_reference(remat):
    jmodel, jparams, model, params = _models(remat=remat)
    jbatch = _jax_batch()
    want_logits, want_values, want_aux = jax.jit(jmodel.forward)(jparams,
                                                                 jbatch)
    logits, values, aux = model.forward(params, _torch_batch(jbatch))
    assert logits.dtype == values.dtype == aux.dtype == torch.float32
    assert logits.shape == (2, SEQ, 512) and values.shape == (2, SEQ)
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
def test_remat_runs_the_scan_forward_twice_a_recurrent_layer_a_step(
        monkeypatch, remat, per_step):
    """With remat "layer" the backward reruns each layer's forward, so the
    scan's forward runs 2 x (recurrent layers) times a step (the count
    chip_smoke holds the kernel's launches to); without remat once."""
    _, _, model, params = _models(remat=remat)
    calls = []
    plain = rg_ref.rglru_scan_ref

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(rg_ref, "rglru_scan_ref", counted)
    steps.make_grad_fn(model)(params, _torch_batch(_jax_batch()))
    assert len(calls) == per_step * model.kinds.count("R") == per_step * 2


# ------------------------------------------------------------ train step


def test_loss_metrics_and_gradients_match_reference():
    jmodel, jparams, model, params = _models()
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


# ------------------------------------------------------- refusals and CLI


def test_hybrid_decode_and_serving_entry_points_raise():
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
    with pytest.raises(ValueError, match="layer pattern 'RG'"):
        Model(dataclasses.replace(cfg, layer_pattern="RG"))


def test_train_cli_prints_finite_losses_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "128"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("recurrentgemma-2b: ")
    lines = [ln.split() for ln in proc.stdout.splitlines()
             if ln.startswith("step")]
    assert [ln[1] for ln in lines] == ["0", "1"]
    for ln in lines:
        assert ln[2] == "loss" and ln[4] == "ce" and ln[6] == "tok/s"
        assert math.isfinite(float(ln[3])) and math.isfinite(float(ln[5]))
    assert abs(float(lines[0][5]) - math.log(512)) < 0.5


def test_train_returns_metrics_and_the_param_count():
    out = train.train(ARCH, steps=1, batch=2, seq=64, device="cpu")
    assert out["cfg"].family == "hybrid"
    assert out["n_params"] == sum(x.numel() for x in leaves(out["params"]))
    assert all(math.isfinite(v) for v in out["metrics"][0].values())
