"""The port's flash attention (``repro_torch.kernels.flash_attention`` and
``models.attention.full_attention``) against the reference on the CPU:
the Pallas kernel in interpret mode, its jnp oracle ``attention_ref``,
the chunked forward ``_fa_forward`` and the custom VJP of
``repro.models.attention.full_attention``.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances (max abs error): 2e-5 in float32 and 2e-2 in bfloat16 for the
forwards, the reference's own (``tests/test_kernels.py:20-21``): the same
online softmax summed in another order, and in bf16 rounded at other
places; 1e-5 abs + 1e-4 * |ref| for the float32 gradients (sums over T
and S in another order, through exp).

The CUDA kernel runs only on the card: the ``gpu`` tests here skip
without one, and ``chip_smoke.py`` holds the kernel against the plain
version at the training shape.  Its two variants (v1 on ``mma.sync``, v2
on TMA and ``wgmma``) are chosen by a static rule on (dtype, head_dim),
which the CPU tests pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention as attn

torch.set_num_threads(2)

# tests/test_kernels.py:27-36
SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 0),
    (2, 128, 128, 4, 1, 64, False, 0),  # MQA, non-causal
    (1, 256, 256, 2, 2, 64, True, 64),  # sliding window
    (1, 128, 128, 8, 2, 128, True, 0),  # GQA 4:1, wide head
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(B, T, S, H, K, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, h), (B, S, K, h), (B, S, K, h))]


def _to_jax(xs, jdt):
    return [jnp.asarray(x).astype(jdt) for x in xs]


def _to_torch(xs, tdt):
    """The same values as ``_to_jax``: bf16 rounds to nearest even in both
    packages, so the tensors hold the jnp arrays' bits."""
    return [torch.from_numpy(x).to(tdt) for x in xs]


def _err(want, got) -> float:
    return float(np.abs(np.asarray(jnp.asarray(want, jnp.float32))
                        - got.float().numpy()).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,S,H,K,h,causal,window", SHAPES)
def test_plain_forward_matches_pallas_and_oracle(B, T, S, H, K, h, causal,
                                                 window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    xs = _qkv(B, T, S, H, K, h, T + H + h)
    js, ts = _to_jax(xs, jdt), _to_torch(xs, tdt)
    got, lse = ref.flash_attention_ref(*ts, causal=causal, window=window,
                                       chunk=64)
    naive = ref.attention_ref(*ts, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, T, H, h)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    pallas = flash_attention_pallas(*js, causal=causal, window=window,
                                    block_q=64, block_kv=64, interpret=True)
    oracle = jax_attention_ref(*js, causal=causal, window=window)
    for want in (pallas, oracle):
        assert _err(want, got) < tol
        assert _err(want, naive) < tol


@pytest.mark.parametrize("causal,softcap",
                         [(True, 0.0), (False, 0.0), (True, 30.0),
                          (False, 30.0)])
def test_out_and_lse_match_fa_forward_at_ragged_s(causal, softcap):
    """T = S = 100 with 32-row chunks: the last chunk is 4 real rows and
    28 masked ones.  Logits scaled up so that softcap 30 bites."""
    xs = _qkv(2, 100, 100, 4, 2, 64, 7)
    xs[0] = xs[0] * 4.0
    want_out, want_lse = jattn._fa_forward(*_to_jax(xs, jnp.float32), causal,
                                           32, softcap)
    got_out, got_lse = ref.flash_attention_ref(
        *_to_torch(xs, torch.float32), causal=causal, softcap=softcap,
        chunk=32)
    assert _err(want_out, got_out) < 2e-5
    assert _err(np.asarray(want_lse).reshape(2, 4, 100), got_lse) < 2e-5


@pytest.mark.parametrize("T,S,causal,softcap,chunk",
                         [(64, 64, True, 0.0, 1024), (100, 100, True, 0.0, 32),
                          (48, 80, False, 0.0, 32), (100, 100, True, 30.0, 32)])
def test_full_attention_gradients_match_jax_vjp(T, S, causal, softcap, chunk):
    B, H, K, h = 2, 4, 2, 32
    xs = _qkv(B, T, S, H, K, h, T + S)
    xs[0] = xs[0] * 3.0
    do = np.random.default_rng(1).standard_normal((B, T, H, h)).astype(
        np.float32)
    fwd = lambda q, k, v: jattn.full_attention(  # noqa: E731
        q, k, v, causal=causal, chunk=chunk, softcap=softcap)
    want_out, vjp = jax.vjp(fwd, *_to_jax(xs, jnp.float32))
    want_grads = vjp(jnp.asarray(do))

    ts = [t.requires_grad_() for t in _to_torch(xs, torch.float32)]
    out = attn.full_attention(*ts, causal=causal, chunk=chunk,
                              softcap=softcap)
    out.backward(torch.from_numpy(do))
    assert _err(want_out, out.detach()) < 2e-5
    for want, t in zip(want_grads, ts):
        want = np.asarray(want)
        got = t.grad.numpy()
        assert np.all(np.abs(want - got) <= 1e-5 + 1e-4 * np.abs(want))


def test_full_attention_in_bf16_keeps_dtypes_and_matches_jax():
    xs = _qkv(1, 96, 96, 4, 2, 64, 3)
    do = np.random.default_rng(2).standard_normal((1, 96, 4, 64)).astype(
        np.float32)
    want_out, vjp = jax.vjp(lambda q, k, v: jattn.full_attention(q, k, v),
                            *_to_jax(xs, jnp.bfloat16))
    want_grads = vjp(jnp.asarray(do).astype(jnp.bfloat16))
    ts = [t.requires_grad_() for t in _to_torch(xs, torch.bfloat16)]
    out = attn.full_attention(*ts)
    out.backward(torch.from_numpy(do).bfloat16())
    assert out.dtype == torch.bfloat16
    assert _err(want_out, out.detach()) < 2e-2
    for want, t in zip(want_grads, ts):
        assert t.grad.dtype == torch.bfloat16
        scale = float(np.abs(np.asarray(want, np.float32)).max())
        assert _err(want, t.grad) < 2e-2 * max(scale, 1.0)


def test_ops_sends_cpu_tensors_to_the_plain_version():
    ts = _to_torch(_qkv(1, 40, 40, 4, 2, 32, 5), torch.float32)
    out, lse = ops.flash_attention(*ts, causal=True, softcap=20.0, chunk=16)
    want, want_lse = ref.flash_attention_ref(*ts, causal=True, softcap=20.0,
                                             chunk=16)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert fa.LAUNCHES == {"flash_attention": 0}


def _zeros(dtype, T=16, H=4, K=2, h=128):
    return [torch.zeros(1, T, n, h, dtype=dtype) for n in (H, K, K)]


def _strided(t):  # the same shape with heads outermost in memory
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _misaligned(t):  # the same shape, one element past a 16-byte boundary
    shifted = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    return shifted


def _with(i, f):
    """q, k and v as ``_zeros`` makes them, the i-th passed through f."""
    def make(dtype):
        ts = _zeros(dtype)
        ts[i] = f(ts[i])
        return ts
    return make


# Every refusal but the last comes before the device check, so it shows on
# the CPU; the last is the device check itself.
REFUSALS = {
    "head_dim 16": (lambda d: _zeros(d, h=16), ValueError, "head_dim 16"),
    "head_dim 96": (lambda d: _zeros(d, h=96), ValueError, "head_dim 96"),
    "head_dim 512": (lambda d: _zeros(d, h=512), ValueError, "head_dim 512"),
    "float16": (lambda d: _zeros(torch.float16), TypeError, "float16"),
    "H % K": (lambda d: _zeros(d, H=6, K=4), ValueError, "multiple"),
    "strided q": (_with(0, _strided), ValueError, "q must be contiguous"),
    "strided v": (_with(2, _strided), ValueError, "v must be contiguous"),
    "misaligned k": (_with(1, _misaligned), ValueError,
                     "k must start on a 16-byte"),
    "cpu": (_zeros, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(case):
    """A wrapper launches its kernel or raises: nothing is sent to the
    plain version, and nothing is built or launched for a refused call, in
    either dtype, whichever variant the rule would pick."""
    make, exc, match = REFUSALS[case]
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(exc, match=match):
            fa.flash_attention_cuda(*make(dtype))
    assert fa.LAUNCHES == {"flash_attention": 0}
    assert fa.VARIANT_LAUNCHES == {"v1": 0, "v2": 0}


@pytest.mark.parametrize("dtype,h,want", [
    (torch.bfloat16, 64, "v2"), (torch.bfloat16, 128, "v2"),
    (torch.bfloat16, 32, "v1"), (torch.bfloat16, 256, "v1"),
    (torch.float32, 32, "v1"), (torch.float32, 64, "v1"),
    (torch.float32, 128, "v1"), (torch.float32, 256, "v1"),
])
def test_variant_rule_sends_bf16_h64_and_h128_to_v2(dtype, h, want):
    assert fa.variant(dtype, h) == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_matches_plain_version_on_card(cuda, dtype):
    """Each variant where the rule sends it: v2 at every bf16 case of h 64
    or 128, v1 at the float32 cases and at h 32 and 256."""
    _, tdt, tol = DTYPES[dtype]
    cases = [(*s, 0.0) for s in SHAPES] + [
        (1, 100, 100, 4, 2, 64, True, 0, 30.0),  # ragged, softcap
        (1, 100, 100, 4, 2, 128, False, 0, 0.0),  # ragged, non-causal
        (2, 77, 300, 4, 2, 128, False, 0, 0.0),  # ragged T and S
        (2, 77, 300, 4, 2, 256, False, 0, 0.0),  # ragged T and S, h 256
        (2, 512, 512, 12, 2, 128, True, 0, 0.0),  # the training heads
        (1, 2047, 2047, 12, 2, 128, True, 0, 0.0),  # G 6, ragged T
        (1, 300, 300, 6, 1, 64, True, 64, 0.0),  # G 6, window across tiles
        (1, 256, 256, 4, 1, 128, True, 0, 30.0),  # G 4, softcap
    ]
    for B, T, S, H, K, h, causal, window, cap in cases:
        ts = [t.to(cuda, tdt) for t in
              _to_torch(_qkv(B, T, S, H, K, h, T + S), torch.float32)]
        which = fa.variant(tdt, h)
        before = fa.LAUNCHES["flash_attention"]
        before_variant = fa.VARIANT_LAUNCHES[which]
        out, lse = ops.flash_attention(*ts, causal=causal, window=window,
                                       softcap=cap)
        assert fa.LAUNCHES["flash_attention"] == before + 1
        assert fa.VARIANT_LAUNCHES[which] == before_variant + 1
        want, want_lse = ref.flash_attention_ref(*ts, causal=causal,
                                                 window=window, softcap=cap)
        assert out.dtype == tdt and bool(torch.isfinite(out).all())
        assert bool(torch.isfinite(lse).all())
        assert (out.float() - want.float()).abs().max().item() < tol, (
            which, B, T, S, H, K, h)
        assert (lse - want_lse).abs().max().item() < 1e-4, (which, h)
