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
Beside the flat forward bounds, checks that scale with the output
(``_scaled_errors``): y within half a bf16 ulp (2**-8 of |want|) plus
1e-4 * max|want| of the plain version computed in float32 on the same
inputs, and the states within 1e-4 * max|want|.  At the full-width shape
|y| reaches ~45, where the flat bf16 bound is smaller than one bf16 ulp of
the largest outputs and larger than most of the others.

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
# the kernel's edge shapes (B, T, H, P, N, Q): one chunk (T = Q = 256), a
# chunk of 48 rows (not a multiple of the kernel's 16-row tiles or its
# 128-row query tiles), N 1 (no whole 16-byte chunk of B and C) and N 128
# at P 16
EDGE_SHAPES = [(1, 256, 4, 64, 128, 256), (1, 96, 2, 32, 16, 48),
               (2, 64, 4, 16, 1, 32), (2, 128, 4, 16, 128, 64)]
BF16_HALF_ULP = 2.0**-8
SCALED_TOL = 1e-4


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
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _close(want, got, atol=1e-5, rtol=1e-4) -> bool:
    want, got = _np(want), _np(got)
    return bool(np.all(np.abs(want - got) <= atol + rtol * np.abs(want)))


def _scaled_errors(got, want, want32):
    """(y, S_final, S_prevs) against the plain version: y's largest excess
    over half a bf16 ulp of the float32 result (``want32``, computed on the
    same inputs in float32), and each state's largest error, all over their
    max|want| (where that is 0, as for S_prevs of one chunk, the error
    must be 0).  Within SCALED_TOL each when only the rounding differs."""
    def rel(err, want):
        scale = float(np.abs(_np(want)).max())
        return err / scale if scale else (0.0 if err == 0 else np.inf)

    y, y32 = _np(got[0]), _np(want32[0])
    errs = [rel(float((np.abs(y - y32) - BF16_HALF_ULP * np.abs(y32)).max()),
                y32)]
    errs += [rel(_err(g, w), w) for g, w in zip(got[1:], want[1:])]
    return errs


def _strided(xs):
    """x, Bm and Cm as views of one (B, T, H P + 2 N) tensor, as
    mamba2_block hands them to the scan (the convolution's output)."""
    x, dt, A, Bm, Cm = xs
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    wide = torch.cat([x.reshape(B, T, H * P), Bm, Cm], dim=-1)
    return (wide[..., :H * P].reshape(B, T, H, P), dt, A,
            wide[..., H * P:H * P + N], wide[..., H * P + N:])


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
@pytest.mark.parametrize("B,T,H,P,N,Q", SHAPES)
def test_staged_ref_matches_pallas_and_plain(B, T, H, P, N, Q, dtype):
    """The kernel's stages in plain PyTorch (scores once per (row, chunk),
    chunk states, the state pass, y) against the Pallas kernel in
    interpret mode and the plain chunk scan."""
    jdt, tdt, tol = DTYPES[dtype]
    xs = _inputs(B, T, H, P, N, T + P)
    ts = _to_torch(xs, tdt)
    got = ref.ssd_staged_ref(*ts, Q)
    assert got[0].dtype == tdt and got[0].shape == (B, T, H, P)
    assert got[2].shape == (T // Q, B, H, P, N)
    assert float(got[2][0].abs().max()) == 0.0
    pallas = ssd_scan_pallas(*_to_jax(xs, jdt), chunk=Q, interpret=True)
    assert _err(pallas[0], got[0]) < tol and _err(pallas[1], got[1]) < tol
    plain = ref.ssd_chunk_scan_ref(*ts, Q)
    assert all(_err(w, g) < tol for w, g in zip(plain, got))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,P,N,Q", EDGE_SHAPES)
def test_staged_ref_meets_the_scaled_bounds_at_edge_shapes(B, T, H, P, N, Q,
                                                           dtype):
    """At the kernel's edge shapes the staged version agrees with the plain
    chunk scan within the flat bounds and within the bounds that scale
    with the output, which ``chip_smoke.py`` and the ``gpu`` test hold the
    kernel to."""
    _, tdt, tol = DTYPES[dtype]
    ts = _to_torch(_inputs(B, T, H, P, N, T + N), tdt)
    got = ref.ssd_staged_ref(*ts, Q)
    want = ref.ssd_chunk_scan_ref(*ts, Q)
    want32 = ref.ssd_chunk_scan_ref(*(t.float() for t in ts), Q)
    assert all(_err(w, g) < tol for w, g in zip(want, got))
    assert max(_scaled_errors(got, want, want32)) <= SCALED_TOL
    assert float(got[2][0].abs().max()) == 0.0


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,Q", EDGE_SHAPES)
def test_cuda_wrapper_takes_the_edge_shapes(B, T, H, P, N, Q, strided):
    """Every edge shape, dense and as the model's strided views, passes the
    wrapper's checks in both dtypes and is refused only for lying on the
    CPU: nothing is launched and nothing is built."""
    before = dict(ssd.LAUNCHES)
    for tdt in (torch.float32, torch.bfloat16):
        xs = _to_torch(_inputs(B, T, H, P, N, 12), tdt)
        if strided:
            xs = _strided(xs)
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            ssd.ssd_scan_cuda(*xs, chunk=Q)
    assert ssd.LAUNCHES == before


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
    """The kernel against the plain chunk scan at the reference's shapes,
    the reduced and full-width heads, the edge shapes and the full-width
    training shape as strided views: the flat bounds, the bounds that
    scale with the output (also against the staged form), and S_prevs[0]
    exactly 0."""
    _, tdt, tol = DTYPES[dtype]
    cases = [(s, False) for s in SHAPES + EDGE_SHAPES + [
        (2, 128, 16, 32, 16, 32),  # the reduced mamba2
        (1, 100, 2, 64, 16, 50),  # a chunk of 50 rows
        (2, 512, 8, 64, 128, 256)]]  # the full-width heads
    cases += [((2, 2048, 64, 64, 128, 256), True),  # the training shape
              ((2, 64, 4, 16, 1, 32), True)]
    for (B, T, H, P, N, Q), strided in cases:
        xs = [t.to(cuda) for t in _to_torch(_inputs(B, T, H, P, N, T + H),
                                            tdt)]
        if strided:
            xs = _strided(xs)
        before = ssd.LAUNCHES["ssd_scan"]
        got = ops.ssd_chunk_scan(*xs, Q)
        assert ssd.LAUNCHES["ssd_scan"] == before + 1
        want = ref.ssd_chunk_scan_ref(*xs, Q)
        want32 = ref.ssd_chunk_scan_ref(*(t.float() for t in xs), Q)
        staged32 = ref.ssd_staged_ref(*(t.float() for t in xs), Q)
        assert got[0].dtype == tdt
        assert float(got[2][0].abs().max()) == 0.0
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            assert (g.float() - w.float()).abs().max().item() < tol
        # the staged form rounds y to bf16 elsewhere than the plain version
        # does, so a bf16 y may sit one ulp from it: held in float32
        for w, w32 in ((want, want32), (staged32, staged32)):
            assert max(_scaled_errors(got, w, w32)) <= SCALED_TOL, (
                (B, T, H, P, N, Q), strided)
