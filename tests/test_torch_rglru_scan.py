"""The port's RG-LRU scan (``repro_torch.kernels.rglru_scan``) against the
reference on the CPU: the Pallas kernel in interpret mode, the sequential
oracle ``rglru_scan_ref``, and the associative scan ``_assoc_scan`` with
its custom VJP (``repro/kernels/rglru_scan/ops.py``).

Inputs are drawn with numpy from a seed as the reference's kernel test
draws them (``tests/test_kernels.py:80-95``): x ~ N(0, 1), a and i the
sigmoid of N(0, 1).  Tolerances (max abs error) are the reference's:
  * 2e-5 in float32 and 2e-2 in bfloat16 for the forward
    (``tests/test_kernels.py:20-21``): the log-depth scan associates the
    sum another way than the sequential oracle, and a bf16 y is rounded
    from float32 values that differ in the last bits;
  * 1e-4 for float32 gradients (``tests/test_kernels.py:98``), as
    1e-5 + 1e-4 * |ref| where the reference's own gradient is large (the
    max(beta, 1e-6) guard at a = 1 makes da ~ 1e6).

The CUDA kernel runs only on the card: the ``gpu`` test here skips
without one, and ``chip_smoke.py`` holds the kernel against the plain
version at Griffin's full-width training shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import _assoc_scan, _assoc_scan_fwd_impl
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro.kernels.rglru_scan.rglru_scan import rglru_scan_pallas
from repro_torch.kernels.rglru_scan import ops, ref
from repro_torch.kernels.rglru_scan import rglru_scan as rg

torch.set_num_threads(2)

# tests/test_kernels.py:80-83: (B, T, W, block_t, block_w)
SHAPES = [(2, 64, 128, 32, 64), (1, 128, 256, 64, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _inputs(B, T, W, seed):
    """numpy (x, a, gate_i), float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    a = _sigmoid(rng.standard_normal((B, T, W))).astype(np.float32)
    gi = _sigmoid(rng.standard_normal((B, T, W))).astype(np.float32)
    return x, a, gi


def _to_jax(xs, dtypes):
    return [jnp.asarray(v).astype(d) for v, d in zip(xs, dtypes)]


def _to_torch(xs, dtypes):
    """The same values as ``_to_jax``: bf16 rounds to nearest even in both
    packages."""
    return [torch.from_numpy(v).to(d) for v, d in zip(xs, dtypes)]


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
@pytest.mark.parametrize("B,T,W,bt,bw", SHAPES)
def test_plain_scan_matches_pallas_assoc_and_oracle(B, T, W, bt, bw, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    xs = _inputs(B, T, W, T + W)
    ts = _to_torch(xs, [tdt] * 3)
    y, h_T = ops.rglru_scan(*ts)
    assert y.dtype == tdt and y.shape == (B, T, W)
    assert h_T.dtype == torch.float32 and h_T.shape == (B, W)
    assert torch.equal(h_T, y[:, -1].float())
    js = _to_jax(xs, [jdt] * 3)
    y_ref, hT_ref = jax_rglru_scan_ref(*js)
    y_a, hT_a = _assoc_scan(*js, None)
    y_p, hT_p = rglru_scan_pallas(*js, block_t=bt, block_w=bw,
                                  interpret=True)
    for want in (y_ref, y_a, y_p):
        assert _err(want, y) < tol
    for want in (hT_ref, hT_a, hT_p):
        assert _err(want, h_T) < tol
    # the float32 states the backward reads, as _assoc_core_fwd saves them
    _, h = ref.rglru_scan_ref(*ts)
    _, want_h = _assoc_scan_fwd_impl(*js, None)
    assert h.dtype == torch.float32 and _err(want_h, h) < 2e-5


@pytest.mark.parametrize("B,T,W,bt,bw", SHAPES)
def test_mixed_dtypes_as_griffin_hands_them_over(B, T, W, bt, bw):
    """x in bf16 (the conv output in the param dtype), a and i in float32
    (``_rglru_gates``): y comes back in bf16, the states in float32."""
    xs = _inputs(B, T, W, 3 * T + W)
    ts = _to_torch(xs, [torch.bfloat16, torch.float32, torch.float32])
    y, h_T = ops.rglru_scan(*ts)
    assert y.dtype == torch.bfloat16 and torch.equal(h_T, y[:, -1].float())
    js = _to_jax(xs, [jnp.bfloat16, jnp.float32, jnp.float32])
    for want_y, want_h in (jax_rglru_scan_ref(*js), _assoc_scan(*js, None),
                           rglru_scan_pallas(*js, block_t=bt, block_w=bw,
                                             interpret=True)):
        assert _err(want_y, y) < 2e-2 and _err(want_h, h_T) < 2e-2
    _, h = ref.rglru_scan_ref(*ts)
    assert _err(_assoc_scan_fwd_impl(*js, None)[1], h) < 2e-5


def test_long_sequence_where_products_of_a_underflow():
    """Over 2048 steps a product of a's reaches ~1e-600, far below float32;
    the log-depth scan never forms a closed form that divides by it."""
    xs = _inputs(2, 2048, 8, 4)
    y, h = ref.rglru_scan_ref(*_to_torch(xs, [torch.float32] * 3))
    assert float(torch.from_numpy(xs[1]).double().log().sum(1).min()) < -1000
    assert bool(torch.isfinite(h).all())
    want_y, want_h = jax_rglru_scan_ref(*_to_jax(xs, [jnp.float32] * 3))
    assert _err(want_y, y) < 2e-5 and _err(want_h, h[:, -1]) < 2e-5


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_scan_is_the_first_order_recurrence(reverse):
    """``linear_scan`` against the reference's ``associative_scan`` with its
    ``combine``, forwards and backwards in time, at a T that is not a
    power of two."""
    rng = np.random.default_rng(5)
    a = _sigmoid(rng.standard_normal((2, 37, 6))).astype(np.float32)
    b = rng.standard_normal((2, 37, 6)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)),
                                       axis=1, reverse=reverse)
    got = ref.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                          reverse=reverse)
    assert _err(want, got) < 2e-5


# ------------------------------------------------------------- gradients


def _jax_vjp(xs, dtypes, dy):
    """The reference's VJP through ``_assoc_scan`` (its custom VJP) with
    cotangents for y and h_T = y[:, -1] as float32."""
    dy_y, dy_h = dy
    _, vjp = jax.vjp(lambda *a: _assoc_scan(*a, None), *_to_jax(xs, dtypes))
    return vjp((jnp.asarray(dy_y).astype(dtypes[0]), jnp.asarray(dy_h)))


def _port_grads(xs, dtypes, dy):
    ts = [t.requires_grad_() for t in _to_torch(xs, dtypes)]
    y, h_T = ops.rglru_scan(*ts)
    torch.autograd.backward(
        (y, h_T), (torch.from_numpy(dy[0]).to(dtypes[0]),
                   torch.from_numpy(dy[1])))
    return [t.grad for t in ts]


def _cotangents(B, T, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, W)).astype(np.float32),
            rng.standard_normal((B, W)).astype(np.float32))


@pytest.mark.parametrize("B,T,W", [(2, 24, 8), (2, 64, 128)])
def test_gradients_match_reference_vjp_and_oracle_autodiff(B, T, W):
    xs = _inputs(B, T, W, 7 + T)
    dy = _cotangents(B, T, W, 9)
    f32 = [torch.float32] * 3
    got = _port_grads(xs, f32, dy)
    want = _jax_vjp(xs, [jnp.float32] * 3, dy)

    def oracle_loss(*args):
        y, h_T = jax_rglru_scan_ref(*args)
        return jnp.sum(y * dy[0]) + jnp.sum(h_T * dy[1])

    oracle = jax.grad(oracle_loss, argnums=(0, 1, 2))(
        *_to_jax(xs, [jnp.float32] * 3))
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.float32 and g.shape == (B, T, W)
        assert _err(w, g) < 1e-4 and _err(o, g) < 1e-4


def test_gradients_where_beta_vanishes_take_the_guard():
    """a = 1 (and the largest float32 below 1) gives beta = 0 (and
    ~3.5e-4): da's a / max(beta, 1e-6) term is ~1e6 there, finite, and
    equal to the reference's VJP; autodiff of the oracle is not finite at
    beta = 0, which is what the guard is for."""
    B, T, W = 2, 32, 16
    x, a, gi = _inputs(B, T, W, 11)
    a[:, 5, :4] = 1.0
    a[:, 9, 4:8] = np.nextafter(np.float32(1.0), np.float32(0.0))
    xs = (x, a, gi)
    dy = _cotangents(B, T, W, 12)
    got = _port_grads(xs, [torch.float32] * 3, dy)
    want = _jax_vjp(xs, [jnp.float32] * 3, dy)
    assert float(got[1].abs().max()) > 1e5
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _close(w, g)
    oracle = jax.grad(lambda *v: jnp.sum(jax_rglru_scan_ref(*v)[0] * dy[0]),
                      argnums=1)(*_to_jax(xs, [jnp.float32] * 3))
    assert not bool(jnp.isfinite(oracle).all())


@pytest.mark.parametrize("dtypes", [("bfloat16",) * 3,
                                    ("bfloat16", "float32", "float32")],
                         ids=["bf16", "griffin-mix"])
def test_low_precision_gradients_keep_each_inputs_dtype(dtypes):
    B, T, W = 2, 64, 32
    xs = _inputs(B, T, W, 13)
    dy = _cotangents(B, T, W, 14)
    got = _port_grads(xs, [getattr(torch, d) for d in dtypes], dy)
    want = _jax_vjp(xs, [getattr(jnp, d) for d in dtypes], dy)
    for g, w, d in zip(got, want, dtypes):
        assert str(g.dtype) == f"torch.{d}" and str(w.dtype) == d
        scale = float(np.abs(_np(w)).max())
        assert _err(w, g) < (2e-2 if d == "bfloat16" else 1e-4) * max(scale,
                                                                      1.0)


def test_remat_style_recompute_gives_the_same_gradients():
    """The forward under ``torch.utils.checkpoint`` (the model's remat)
    reruns the scan in backward: the same gradients as without it."""
    xs = _inputs(1, 48, 16, 15)
    dy = torch.from_numpy(_cotangents(1, 48, 16, 16)[0])
    grads = []
    for remat in (False, True):
        ts = [t.requires_grad_() for t in _to_torch(xs, [torch.float32] * 3)]
        fn = lambda *a: ops.rglru_scan(*a)[0]  # noqa: E731
        y = (torch.utils.checkpoint.checkpoint(fn, *ts, use_reentrant=False)
             if remat else fn(*ts))
        y.backward(dy)
        grads.append([t.grad for t in ts])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ------------------------------------------------------------- dispatch


def test_ops_sends_cpu_tensors_to_the_plain_version():
    ts = _to_torch(_inputs(2, 64, 32, 17), [torch.float32] * 3)
    before = dict(rg.LAUNCHES)
    got = ops.rglru_scan_fwd(*ts)
    want = ref.rglru_scan_ref(*ts)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    y, h_T = ops.rglru_scan(*ts)
    assert torch.equal(y, want[0]) and torch.equal(h_T, want[0][:, -1])
    assert rg.LAUNCHES == before


def test_rglru_scan_refuses_a_stored_state():
    ts = _to_torch(_inputs(1, 16, 8, 18), [torch.float32] * 3)
    with pytest.raises(NotImplementedError, match="Queue 1 #6"):
        ops.rglru_scan(*ts, h0=torch.zeros(1, 8))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """A wrapper launches its kernel or raises: nothing is sent to the
    plain version, and nothing is built for a refused call.  The block
    contract is the Pallas kernel's: T in blocks of min(256, T) steps, W in
    blocks of min(512, W) channels."""
    x, a, gi = _to_torch(_inputs(1, 64, 32, 19), [torch.float32] * 3)
    before = dict(rg.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_scan_cuda(x, a, gi)
    with pytest.raises(ValueError, match="must divide blocks"):
        rg.rglru_scan_cuda(*(torch.zeros(1, 300, 32) for _ in range(3)))
    with pytest.raises(ValueError, match="must divide blocks"):
        rg.rglru_scan_cuda(*(torch.zeros(1, 64, 600) for _ in range(3)))
    with pytest.raises(TypeError, match="float16"):
        rg.rglru_scan_cuda(x.half(), a, gi)
    with pytest.raises(TypeError, match="gate_i"):
        rg.rglru_scan_cuda(x, a, gi.double())
    with pytest.raises(ValueError, match="a must be"):
        rg.rglru_scan_cuda(x, a[:, :32], gi)
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan_cuda(x, a.transpose(1, 2).contiguous().transpose(1, 2),
                           gi)
    with pytest.raises(ValueError, match=r"\(B, T, W\)"):
        rg.rglru_scan_cuda(x[0], a[0], gi[0])
    # blocks of min(256, T) and min(512, W): any T <= 256 and W <= 512 pass
    rg.check_blocks(100, 96)
    rg.check_blocks(2048, 2560)
    assert rg.LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("float32",) * 3, ("bfloat16",) * 3,
                                    ("bfloat16", "float32", "float32")],
                         ids=["f32", "bf16", "griffin-mix"])
def test_kernel_matches_plain_version_on_card(cuda, dtypes):
    tdts = [getattr(torch, d) for d in dtypes]
    tol = 2e-2 if dtypes[0] == "bfloat16" else 2e-5
    cases = [s[:3] for s in SHAPES] + [
        (3, 100, 100),  # T and W below their blocks, a partial channel block
        (2, 1, 64),  # one step
        (2, 512, 2560)]  # Griffin's width
    for B, T, W in cases:
        ts = [t.to(cuda) for t in _to_torch(_inputs(B, T, W, T + W), tdts)]
        before = rg.LAUNCHES["rglru_scan"]
        got = ops.rglru_scan_fwd(*ts)
        assert rg.LAUNCHES["rglru_scan"] == before + 1
        want = ref.rglru_scan_ref(*ts)
        assert got[0].dtype == tdts[0] and got[1].dtype == torch.float32
        for g, w, t in zip(got, want, (tol, 2e-5)):
            assert bool(torch.isfinite(g).all())
            assert (g.float() - w.float()).abs().max().item() < t
