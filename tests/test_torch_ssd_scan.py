"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the
reference on the CPU: the Pallas kernel in interpret mode, its sequential
oracle ``ssd_scan_ref``, the chunk ``_ssd_one_chunk`` and the custom-VJP
chunk scan ``_ssd_chunk_scan`` of ``repro/kernels/ssd_scan/ops.py``.

Inputs are drawn with numpy from a seed, as the reference's kernel test
draws them (``tests/test_kernels.py:55-74``): x ~ N(0, 1),
dt = softplus(N(0, 1)), A = -exp(N(0, 1) / 2), B and C ~ 0.3 N(0, 1); dt
and A stay float32, x, B and C take the dtype under test.  Tolerances (max
abs error):
  * 1e-4 in float32 and 0.05 in bfloat16 for the forwards, the
    reference's own pin for the chunked scan against the sequential
    oracle: the same products summed in another order, and in bf16 y
    rounded from float32 values that differ in the last bits;
  * 1e-5 + 1e-4 * |ref| for float32 gradients against the reference's
    VJP: sums over chunks, Q and N in another order, through exp (dA sums
    over every step of every row);
  * 1e-3 for gradients against autodiff of the sequential oracle, the
    reference's own pin for that comparison (``tests/test_perf_features.py:
    144-161``).

The CUDA kernel runs only on the card: the ``gpu`` test here skips
without one, and ``chip_smoke.py`` holds the kernel against the plain
version at the training shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import _ssd_chunk_scan, _ssd_one_chunk
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd

torch.set_num_threads(2)

# tests/test_kernels.py:55-58: (B, T, H, P, N, Q)
SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64),
          (2, 64, 8, 16, 8, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _inputs(B, T, H, P, N, seed, *, dt_shift=0.0, A=None):
    """numpy (x, dt, A, Bm, Cm), float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, T, H)) + dt_shift,
                      0.0).astype(np.float32)
    if A is None:
        A = -np.exp(0.5 * rng.standard_normal(H))
    A = np.broadcast_to(np.asarray(A, np.float32), (H,)).copy()
    Bm = (0.3 * rng.standard_normal((B, T, N))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((B, T, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


def _to_jax(xs, jdt):
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in xs)
    return x.astype(jdt), dt, A, Bm.astype(jdt), Cm.astype(jdt)


def _to_torch(xs, tdt):
    """The same values as ``_to_jax``: bf16 rounds to nearest even in both
    packages."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in xs)
    return x.to(tdt), dt, A, Bm.to(tdt), Cm.to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _close(want, got, atol=1e-5, rtol=1e-4) -> bool:
    want, got = _np(want), _np(got)
    return bool(np.all(np.abs(want - got) <= atol + rtol * np.abs(want)))


# ------------------------------------------------------------- forwards


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,P,N,Q", SHAPES)
def test_plain_chunk_scan_matches_pallas_and_oracle(B, T, H, P, N, Q, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    xs = _inputs(B, T, H, P, N, T + P)
    y, S, S_prevs = ref.ssd_chunk_scan_ref(*_to_torch(xs, tdt), Q)
    assert y.dtype == tdt and y.shape == (B, T, H, P)
    assert S.dtype == S_prevs.dtype == torch.float32
    assert S.shape == (B, H, P, N) and S_prevs.shape == (T // Q, B, H, P, N)
    js = _to_jax(xs, jdt)
    pallas = ssd_scan_pallas(*js, chunk=Q, interpret=True)
    oracle = jax_ssd_scan_ref(*js)
    for want_y, want_S in (pallas, oracle):
        assert _err(want_y, y) < tol
        assert _err(want_S, S) < tol


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sequential_oracle_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    xs = _inputs(2, 48, 3, 16, 8, 1)
    y, S = ref.ssd_scan_ref(*_to_torch(xs, tdt))
    want_y, want_S = jax_ssd_scan_ref(*_to_jax(xs, jdt))
    assert y.dtype == tdt and S.dtype == torch.float32
    assert _err(want_y, y) < (2e-5 if dtype == "float32" else 2e-2)
    assert _err(want_S, S) < 2e-5


def test_states_entering_each_chunk_are_the_oracles_prefix_states():
    B, T, H, P, N, Q = 2, 96, 3, 16, 8, 32
    xs = _inputs(B, T, H, P, N, 2)
    _, _, S_prevs = ref.ssd_chunk_scan_ref(*_to_torch(xs, torch.float32), Q)
    assert float(S_prevs[0].abs().max()) == 0.0
    for c in range(1, T // Q):
        prefix = [a[:, :c * Q] if a.ndim > 1 else a for a in xs]
        _, want = jax_ssd_scan_ref(*_to_jax(prefix, jnp.float32))
        assert _err(want, S_prevs[c]) < 1e-4


def test_one_chunk_matches_reference():
    B, Q, H, P, N = 2, 16, 3, 8, 8
    x, dt, A, Bm, Cm = _inputs(B, Q, H, P, N, 3)
    S_prev = np.random.default_rng(4).standard_normal(
        (B, H, P, N)).astype(np.float32)
    args = (S_prev, x, dt, Bm, Cm, A)
    want_y, want_S = _ssd_one_chunk(*(jnp.asarray(a) for a in args))
    y, S = ref.ssd_one_chunk(*(torch.from_numpy(a) for a in args))
    assert _err(want_y, y) < 2e-5 and _err(want_S, S) < 2e-5


# ------------------------------------------------------------- gradients


@pytest.mark.parametrize("B,T,H,P,N,Q", [(2, 64, 4, 16, 8, 4),
                                         (2, 128, 4, 32, 16, 32)])
def test_gradients_match_reference_vjp(B, T, H, P, N, Q):
    """At the reference's chunk 4 (``tests/test_perf_features.py:144``) and
    chunk 32 (the reduced config) shapes, where its VJP is finite; the
    cotangent of the final state is nonzero too."""
    xs = _inputs(B, T, H, P, N, T + Q)
    rng = np.random.default_rng(5)
    dy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dS = rng.standard_normal((B, H, P, N)).astype(np.float32)
    (want_y, want_S), vjp = jax.vjp(
        lambda *a: _ssd_chunk_scan(*a, T // Q), *_to_jax(xs, jnp.float32))
    want = vjp((jnp.asarray(dy), jnp.asarray(dS)))
    ts = [t.requires_grad_() for t in _to_torch(xs, torch.float32)]
    y, S = ops.ssd_scan(*ts, chunk=Q)
    torch.autograd.backward((y, S), (torch.from_numpy(dy),
                                     torch.from_numpy(dS)))
    assert _err(want_y, y) < 1e-4 and _err(want_S, S) < 1e-4
    for w, t in zip(want, ts):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        assert _close(w, t.grad)


def test_chunk_256_gradients_are_finite_where_the_reference_vjp_is_nan():
    """One 256-step chunk pair at the model's init values (A = -1,
    dt = softplus(N(0, 1) + 0.5)): inside a chunk cum_t - cum_s reaches
    ~250 for s > t, the reference's exp overflows before its mask, and its
    VJP gives NaN for dt and A (ROADMAP Queue 3).  The port masks before
    the exponential: its gradients are finite and match autodiff of the
    sequential oracle."""
    B, T, H, P, N, Q = 1, 512, 2, 8, 8, 256
    xs = _inputs(B, T, H, P, N, 6, dt_shift=0.5, A=-1.0)
    js = _to_jax(xs, jnp.float32)
    args = tuple(range(5))
    chunked = jax.grad(lambda *a: jnp.sum(_ssd_chunk_scan(*a, T // Q)[0]),
                       argnums=args)(*js)
    assert bool(jnp.isnan(chunked[1]).all()) and bool(
        jnp.isnan(chunked[2]).all())
    assert all(bool(jnp.isfinite(chunked[i]).all()) for i in (0, 3, 4))
    oracle = jax.grad(lambda *a: jnp.sum(jax_ssd_scan_ref(*a)[0]),
                      argnums=args)(*js)
    ts = [t.requires_grad_() for t in _to_torch(xs, torch.float32)]
    ops.ssd_scan(*ts, chunk=Q)[0].sum().backward()
    for w, t in zip(oracle, ts):
        assert bool(torch.isfinite(t.grad).all())
        assert _err(w, t.grad) < 1e-3


def test_bf16_gradients_keep_dtypes_and_match_reference():
    B, T, H, P, N, Q = 2, 64, 4, 16, 8, 16
    xs = _inputs(B, T, H, P, N, 7)
    dy = np.random.default_rng(8).standard_normal((B, T, H, P)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: _ssd_chunk_scan(*a, T // Q)[0],
                     *_to_jax(xs, jnp.bfloat16))
    want = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    ts = [t.requires_grad_() for t in _to_torch(xs, torch.bfloat16)]
    y, _ = ops.ssd_scan(*ts, chunk=Q)
    y.backward(torch.from_numpy(dy).bfloat16())
    assert y.dtype == torch.bfloat16
    for w, t in zip(want, ts):
        assert t.grad.dtype == t.dtype and str(w.dtype) == str(
            t.dtype).removeprefix("torch.")
        scale = float(np.abs(_np(w)).max())
        assert _err(w, t.grad) < 2e-2 * max(scale, 1.0)


# ------------------------------------------------------------- dispatch


def test_ops_sends_cpu_tensors_to_the_plain_version():
    xs = _to_torch(_inputs(2, 64, 4, 16, 8, 9), torch.float32)
    before = dict(ssd.LAUNCHES)
    got = ops.ssd_chunk_scan(*xs, 32)
    want = ref.ssd_chunk_scan_ref(*xs, 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    y, S = ops.ssd_scan(*xs, chunk=32)
    assert torch.equal(y, want[0]) and torch.equal(S, want[1])
    assert ssd.LAUNCHES == before


def test_ssd_scan_refuses_init_state_and_ragged_chunks():
    xs = _to_torch(_inputs(1, 48, 2, 16, 8, 10), torch.float32)
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.ssd_scan(*xs, torch.zeros(1, 2, 16, 8), chunk=16)
    with pytest.raises(ValueError, match="divisible"):
        ops.ssd_scan(*xs, chunk=32)
    with pytest.raises(ValueError, match="divisible"):
        ref.ssd_chunk_scan_ref(*xs, 32)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """A wrapper launches its kernel or raises: nothing is sent to the
    plain version, and nothing is built for a refused call."""
    x, dt, A, Bm, Cm = _to_torch(_inputs(1, 64, 2, 16, 8, 11), torch.float32)
    before = dict(ssd.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError, match="float16"):
        ssd.ssd_scan_cuda(x.half(), dt, A, Bm.half(), Cm.half(), chunk=16)
    with pytest.raises(TypeError, match="Bm"):
        ssd.ssd_scan_cuda(x, dt, A, Bm.bfloat16(), Cm, chunk=16)
    with pytest.raises(TypeError, match="dt"):
        ssd.ssd_scan_cuda(x, dt.double(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="head dim P=8"):
        ssd.ssd_scan_cuda(x[..., :8], dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="state size N=6"):
        ssd.ssd_scan_cuda(x, dt, A, Bm[..., :6], Cm[..., :6], chunk=16)
    with pytest.raises(ValueError, match="chunks of 48"):
        ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="dense"):
        ssd.ssd_scan_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                          dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan_cuda(x, dt.transpose(1, 2).contiguous().transpose(1, 2),
                          A, Bm, Cm, chunk=16)
    assert ssd.LAUNCHES == before


def test_ops_hands_strided_views_to_the_kernel_in_place():
    """The model's x, B and C are views of the convolution's output: their
    inner dimensions are dense, so ops passes them on without a copy."""
    wide = torch.randn(2, 32, 4 * 16 + 2 * 8)
    x = wide[..., :64].reshape(2, 32, 4, 16)
    Bm = wide[..., 64:72]
    assert ops._inner_dense(x, 2) is x and ops._inner_dense(Bm, 1) is Bm
    odd = x.transpose(2, 3)
    assert ops._inner_dense(odd, 2).is_contiguous()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_matches_plain_version_on_card(cuda, dtype):
    _, tdt, tol = DTYPES[dtype]
    cases = SHAPES + [(2, 128, 16, 32, 16, 32),  # the reduced mamba2
                      (1, 100, 2, 64, 16, 50),  # a chunk of 50 rows
                      (2, 512, 8, 64, 128, 256)]  # the full-width heads
    for B, T, H, P, N, Q in cases:
        xs = [t.to(cuda) for t in _to_torch(_inputs(B, T, H, P, N, T + H),
                                            tdt)]
        before = ssd.LAUNCHES["ssd_scan"]
        got = ops.ssd_chunk_scan(*xs, Q)
        assert ssd.LAUNCHES["ssd_scan"] == before + 1
        want = ref.ssd_chunk_scan_ref(*xs, Q)
        assert got[0].dtype == tdt
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            assert (g.float() - w.float()).abs().max().item() < tol
