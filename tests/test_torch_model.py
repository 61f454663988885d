"""The port's model path (``repro_torch.models``, ``param``, ``bridge``)
against the reference's on the same weights and inputs.

Weights are initialised by the JAX package and moved over with
``bridge.params_from_jax``; token ids and activations come from numpy
seeds.  The reduced qwen2 config (2 layers, d=256, 4 heads over 2 KV
heads, h=64) is run in an f32 variant (``param_dtype = cache_dtype =
float32``) and in bf16.

Tolerances (max abs error):
  * 1e-5 for single f32 layers (norm, RoPE, projections, attention):
    the same f32 arithmetic summed in another order, and ``pow``/``cos``
    of another library;
  * 1e-4 for f32 logits and values through the whole model (those
    differences compound over 2 layers, a vocab-wide unembedding and the
    value head);
  * 2e-2 for bf16 (the reference's own bf16 tolerance,
    ``tests/test_kernels.py:20-21``): the two frameworks round to bf16 at
    different places, and the reference's CPU decode casts the
    probabilities to bf16 before the PV product where the port's plain
    decode (like the kernels) stays in f32;
  * exact for pure data movement (cache writes, the bridge).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jax_reduced_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.model import make_model as jax_make_model
from repro_torch import bridge
from repro_torch.configs.base import get_reduced_config
from repro_torch.models import attention as attn
from repro_torch.models import layers, transformer as tf
from repro_torch.models.model import Model

torch.set_num_threads(2)

CPU = torch.device("cpu")
F32 = dict(param_dtype="float32", cache_dtype="float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _t(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _to_np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced_config("qwen2-1.5b"), **kw),
            dataclasses.replace(get_reduced_config("qwen2-1.5b"), **kw))


@functools.lru_cache(maxsize=None)
def _jax_model(f32: bool, unroll: bool):
    """(jax model, jax params, port model, port params on the same weights),
    built once per variant for the whole module."""
    jcfg, cfg = _cfgs(**(F32 if f32 else {}))
    jmodel = jax_make_model(jcfg, unroll=unroll)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    params = bridge.params_from_jax(_to_np_tree(jparams), cfg, device=CPU)
    return jmodel, jparams, Model(cfg, unroll=unroll), params


@functools.lru_cache(maxsize=None)
def _jax_steps(f32: bool, unroll: bool):
    """The reference's jitted (prefill_step, decode_step), compiled once
    per variant and shape."""
    jmodel = _jax_model(f32, unroll)[0]
    return jax.jit(jmodel.prefill_step), jax.jit(jmodel.decode_step)


# ------------------------------------------------------------ params/bridge


@pytest.mark.parametrize("unroll", [False, True])
def test_param_tree_has_the_reference_paths_shapes_dtypes(unroll):
    jcfg, cfg = _cfgs()
    jparams = jax.eval_shape(jax_make_model(jcfg, unroll=unroll).init,
                             jax.random.key(0))
    params = Model(cfg, unroll=unroll).init(0, device=CPU)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jparams).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(params).items()}
    assert got == want


def test_init_is_seeded_and_fan_in_scaled():
    _, cfg = _cfgs(**F32)
    a = Model(cfg).init(torch.Generator().manual_seed(3), device=CPU)
    b = Model(cfg).init(3, device=CPU)
    for k, v in _flat(a).items():
        assert torch.equal(v, _flat(b)[k]), k
    wq = a["blocks"]["attn"]["wq"]  # (L, d, H, h): fan-in d * H per layer
    fan_in = cfg.d_model * cfg.num_heads
    assert abs(wq.std().item() * fan_in**0.5 - 1.0) < 0.05
    assert torch.equal(a["blocks"]["attn"]["bq"], torch.zeros_like(
        a["blocks"]["attn"]["bq"]))


def test_bridge_is_bit_exact_and_relayouts():
    _, cfg = _cfgs()
    jparams = _to_np_tree(_jax_model(False, False)[1])
    params = bridge.params_from_jax(jparams, cfg, device=CPU)
    for k, v in _flat(jparams).items():
        t = _flat(params)[k]
        if v.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  v.view(np.int16)), k
        else:
            assert np.array_equal(t.numpy(), v), k
    looped = bridge.params_from_jax(jparams, cfg, device=CPU, stacked=False)
    assert "blocks" not in looped and "layer_1" in looped
    assert torch.equal(looped["layer_1"]["mlp"]["w_up"],
                       params["blocks"]["mlp"]["w_up"][1])
    back = bridge.relayout(looped, cfg.num_layers, stacked=True)
    for k, v in _flat(params).items():
        assert torch.equal(_flat(back)[k], v), k


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64), np.float32)
    scale = rng.standard_normal((64,), np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    assert _err(jlayers.rms_norm({"scale": jnp.asarray(scale)}, jx, 1e-6),
                layers.rms_norm({"scale": _t(scale)}, tx, 1e-6)) < tol
    for positions in (np.arange(5)[None], np.array([[3, 4, 5, 6, 7],
                                                    [90, 91, 92, 93, 94]])):
        want = jlayers.apply_rope(jx, jnp.asarray(positions), 1e6)
        got = layers.apply_rope(tx, torch.from_numpy(positions), 1e6)
        assert got.dtype == tx.dtype and _err(want, got) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_project_with_bias_and_output_project(dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    d, H, K, h = 32, 4, 2, 16
    rng = np.random.default_rng(1)
    shapes = {"wq": (d, H, h), "wk": (d, K, h), "wv": (d, K, h),
              "wo": (H, h, d), "bq": (H, h), "bk": (K, h), "bv": (K, h)}
    p = {k: 0.2 * rng.standard_normal(s, np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.float32 if k[0] == "b" else dtype)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k[0] == "b" else getattr(torch, dtype))
        for k, v in jp.items()}
    x = rng.standard_normal((2, 3, d), np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tp["wq"].dtype)
    pos = np.array([[0, 1, 2], [7, 8, 9]])
    want = jattn.qkv_project(jp, jx, positions=jnp.asarray(pos),
                             rope_theta=1e4)
    got = attn.qkv_project(tp, tx, positions=torch.from_numpy(pos),
                           rope_theta=1e4)
    for w, g in zip(want, got):
        assert g.dtype == tx.dtype and _err(w, g) < tol
    assert _err(jattn.output_project(jp, want[0]),
                attn.output_project(tp, got[0])) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_decode_attention_matches_reference(dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    B, C, S, H, K, h = 2, 4, 16, 4, 2, 32
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal(s, np.float32)
            for s in ((B, C, H, h), (B, S, K, h), (B, S, K, h))]
    js = [jnp.asarray(a, dtype) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype)) for j in js]
    pos = np.array([0, 9], np.int32)
    want = jattn.chunk_decode_attention(*js, jnp.asarray(pos))
    got = attn.chunk_decode_attention(*ts, torch.from_numpy(pos))
    assert got.dtype == ts[0].dtype and _err(want, got) < tol


# ----------------------------------------------------------- cache updates


def test_dense_cache_updates_drop_out_of_range_like_the_reference():
    B, S, K, h, C = 3, 8, 2, 4, 4
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((B, S, K, h), np.float32)
    k = rng.standard_normal((B, C, K, h), np.float32)
    v = rng.standard_normal((B, C, K, h), np.float32)
    # row 0 fully in range, row 1 straddles the end, row 2 parked past it;
    # then every row partly out of range
    for pos in (np.array([1, 6, S], np.int32), np.array([5, 6, 7], np.int32)):
        wk, wv = jattn.update_kv_cache_chunk(
            jnp.asarray(cache), jnp.asarray(cache), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(pos))
        gk, gv = attn.update_kv_cache_chunk(_t(cache), _t(cache), _t(k),
                                            _t(v), torch.from_numpy(pos))
        assert np.array_equal(_np(wk), _np(gk))
        assert np.array_equal(_np(wv), _np(gv))
        for b in range(B):  # slots before the chunk keep their values
            assert np.array_equal(_np(gk)[b, :pos[b]], cache[b, :pos[b]])
    # the lockstep path: a scalar start, clamped into range as the
    # reference's dynamic_update_slice does
    for p in (3, S + 5):
        wk, _ = jattn.update_kv_cache(jnp.asarray(cache), jnp.asarray(cache),
                                      jnp.asarray(k[:, :1]), jnp.asarray(v[:, :1]),
                                      jnp.int32(p))
        gk, _ = attn.update_kv_cache(_t(cache), _t(cache), _t(k[:, :1]),
                                     _t(v[:, :1]), p)
        assert np.array_equal(_np(wk), _np(gk))


def test_paged_cache_update_sends_out_of_range_to_scratch_page():
    P, bs, K, h, B, nb, C = 7, 4, 1, 2, 2, 3, 4
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((P, bs, K, h), np.float32)
    k = rng.standard_normal((B, C, K, h), np.float32)
    tables = np.array([[3, 1, 5], [6, 0, 0]], np.int32)
    pos = np.array([2, nb * bs], np.int32)  # row 1 parked past its table
    wk, _ = jattn.update_paged_kv_cache(jnp.asarray(pool), jnp.asarray(pool),
                                        jnp.asarray(k), jnp.asarray(k),
                                        jnp.asarray(tables), jnp.asarray(pos))
    gk, _ = attn.update_paged_kv_cache(_t(pool), _t(pool), _t(k), _t(k),
                                       torch.from_numpy(tables),
                                       torch.from_numpy(pos))
    # live pages match exactly; every parked write went to page 0, slot 0
    # (which of the racing duplicates lands there is unspecified)
    assert np.array_equal(_np(wk)[1:], _np(gk)[1:])
    assert np.array_equal(_np(gk)[0, 1:], pool[0, 1:])
    assert any(np.array_equal(_np(gk)[0, 0], k[1, i]) for i in range(C))
    assert np.array_equal(_np(gk)[3, 2:], k[0, :2])  # pos 2, 3 on page 3
    assert np.array_equal(_np(gk)[1, :2], k[0, 2:])  # pos 4, 5 on page 1


def test_decode_sublayer_with_window_matches_reference():
    """The dense decode sublayer with a sliding window (S > window), the
    path the dense kernel's window argument serves."""
    jcfg, cfg = _cfgs(**F32)
    _, jparams, _, p = _jax_model(True, True)
    rng = np.random.default_rng(5)
    B, S, W = 2, 32, 8
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    cache = rng.standard_normal((B, S, cfg.num_kv_heads, cfg.head_dim),
                                np.float32)
    pos = np.array([5, 20], np.int32)
    jc = {"k": jnp.asarray(cache), "v": jnp.asarray(cache) * 0.5}
    step = jax.jit(jtf.attn_sublayer_decode, static_argnums=(4,),
                   static_argnames=("window",))
    want, wc = step(jparams["layer_0"], jc, jnp.asarray(x), jnp.asarray(pos),
                    jcfg, window=W)
    tc = {"k": _t(cache), "v": _t(cache) * 0.5}
    got, gc = tf.attn_sublayer_decode(p["layer_0"], tc, _t(x),
                                      torch.from_numpy(pos), cfg, window=W)
    assert _err(want, got) < 1e-5
    assert _err(wc["k"], gc["k"]) < 1e-5


# ----------------------------------------------------------- whole model


def _f32_cfg():
    return _cfgs(**F32)[1]


def _run_both(f32, unroll, paged, steps=3):
    """Prefill a (B, C) chunk, then decode ``steps`` tokens at ragged
    per-row positions, through both packages on the same weights.  Returns
    (jax logits, torch logits, jax values, torch values) per call, and the
    two final caches."""
    jmodel, jparams, model, params = _jax_model(f32, unroll)
    jprefill, jdecode = _jax_steps(f32, unroll)
    cfg = model.cfg
    B, C, bs, nb = 2, 6, 8, 4
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    if paged:
        jcache, _ = jmodel.init_paged_cache(1 + B * nb, bs)
        cache = model.init_paged_cache(1 + B * nb, bs, device=CPU)
        tables = np.array([[4, 2, 7, 0], [1, 8, 0, 0]], np.int32)
        jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    else:
        jcache, _ = jmodel.init_cache(B, nb * bs)
        cache = model.init_cache(B, nb * bs, device=CPU)
        jt = tt = None
    out = []
    pos0 = np.array([0, 2], np.int32)  # row 1 starts mid-sequence
    jl, jv, jcache = jprefill(jparams, jcache, jnp.asarray(prompt),
                              jnp.asarray(pos0), jt)
    tl, tv, cache = model.prefill_step(params, cache, torch.from_numpy(prompt),
                                       torch.from_numpy(pos0), tt)
    out.append((jl, tl, jv, tv))
    for i in range(steps):
        pos = np.array([C + i, C + 2 + 3 * i], np.int32)
        jl, jv, jcache = jdecode(jparams, jcache, jnp.asarray(toks[i]),
                                 jnp.asarray(pos), jt)
        tl, tv, cache = model.decode_step(params, cache,
                                          torch.from_numpy(toks[i]),
                                          torch.from_numpy(pos), tt)
        out.append((jl, tl, jv, tv))
    return out, jcache, cache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("unroll", [False, True], ids=["stacked", "looped"])
def test_prefill_and_decode_match_reference_f32(unroll, paged):
    out, jcache, cache = _run_both(True, unroll, paged)
    for jl, tl, jv, tv in out:
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        assert _err(jl, tl) < 1e-4 and _err(jv, tv) < 1e-4
    want = _flat(bridge.cache_from_jax(_to_np_tree(jcache), _f32_cfg(),
                                       device=CPU))
    got = _flat(cache)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and _err(want[k], got[k]) < 1e-5, k


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_and_decode_match_reference_bf16(paged):
    out, _, _ = _run_both(False, False, paged, steps=2)
    for jl, tl, jv, tv in out:
        assert _err(jl, tl) < 2e-2 and _err(jv, tv) < 2e-2


def test_stacked_and_looped_layouts_agree():
    _, cfg = _cfgs(**F32)
    stacked = Model(cfg)
    params = stacked.init(4, device=CPU)
    looped = Model(cfg, unroll=True)
    lparams = bridge.relayout(params, cfg.num_layers, stacked=False)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    a = stacked.decode_step(params, stacked.init_cache(2, 8, device=CPU),
                            toks, pos)
    b = looped.decode_step(lparams, looped.init_cache(2, 8, device=CPU),
                           toks, pos)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_model_refuses_what_the_port_does_not_run():
    _, cfg = _cfgs()
    for kw, word in ((dict(family="moe"), "moe"),
                     (dict(layer_pattern="LLG", sliding_window=8), "pattern"),
                     (dict(attn_logit_softcap=50.0), "softcap"),
                     (dict(cache_dtype="float8_e4m3fn"), "float8")):
        with pytest.raises(ValueError, match=word):
            Model(dataclasses.replace(cfg, **kw))
    # the hybrid family runs its forward; its decode state waits for #10c
    hybrid = Model(get_reduced_config("recurrentgemma-2b"))
    with pytest.raises(NotImplementedError, match="hybrid decode state.*#10c"):
        hybrid.init_cache(1, 8, device=CPU)
    with pytest.raises(NotImplementedError, match="hybrid decode state.*#10c"):
        hybrid.decode_step({}, {}, torch.zeros((1, 1), dtype=torch.int32), 0)


def test_entry_points_default_to_the_card():
    _, cfg = _cfgs()
    model = Model(cfg)
    if torch.cuda.is_available():
        assert model.init_cache(1, 8)["blocks"]["k"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_paged_cache(3, 4)
