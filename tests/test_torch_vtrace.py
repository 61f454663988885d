"""The port's V-trace (``repro_torch.kernels.vtrace``) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the
CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance 1e-5 abs, as the reference holds its kernel against its oracle
(``tests/test_kernels.py:142-161``): all three compute in float32, in
another order of operations.

The CUDA kernel runs only on the card: the ``gpu`` test here skips without
one, and ``chip_smoke.py`` holds the kernel against the plain version at
the learner's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vtrace.ref import vtrace_ref as jax_vtrace_ref
from repro.kernels.vtrace.vtrace import vtrace_pallas
from repro_torch.kernels.vtrace import ops, ref
from repro_torch.kernels.vtrace import vtrace as vt

torch.set_num_threads(2)

SHAPES = [(8, 32), (16, 100), (4, 7), (10, 12), (5, 9), (3, 6), (32, 20)]
CLIPS = [dict(), dict(clip_rho=0.9, clip_c=0.8, lambda_=0.95)]


def _inputs(B: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((B, T)) * 0.3).astype(np.float32),
        ((rng.random((B, T)) > 0.1) * 0.99).astype(np.float32),
        rng.standard_normal((B, T)).astype(np.float32),
        rng.standard_normal((B, T)).astype(np.float32),
        rng.standard_normal((B,)).astype(np.float32),
    ]


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j) - t.numpy()).max())


@pytest.mark.parametrize("clips", CLIPS, ids=["default", "clipped"])
@pytest.mark.parametrize("B,T", SHAPES)
def test_plain_vtrace_matches_pallas_and_jnp_oracle(B, T, clips):
    xs = _inputs(B, T, B * T)
    js = [jnp.asarray(x) for x in xs]
    got = ref.vtrace_ref(*(torch.from_numpy(x) for x in xs), **clips)
    bb = min(4, B)  # rows not a multiple of the block are padded there
    for want in (vtrace_pallas(*js, block_b=bb, interpret=True, **clips),
                 jax_vtrace_ref(*js, **clips)):
        assert _err(want.vs, got.vs) < 1e-5
        assert _err(want.pg_advantages, got.pg_advantages) < 1e-5
    assert got.vs.dtype == torch.float32 and got.vs.shape == (B, T)


def test_ops_sends_cpu_tensors_to_the_plain_version_without_grad():
    xs = [torch.from_numpy(x) for x in _inputs(6, 9, 1)]
    xs[0].requires_grad_(True)
    xs[3].requires_grad_(True)
    out = ops.vtrace(*xs, clip_rho=0.9)
    want = ref.vtrace_ref(*(x.detach() for x in xs), clip_rho=0.9)
    assert torch.equal(out.vs, want.vs)
    assert torch.equal(out.pg_advantages, want.pg_advantages)
    assert not out.vs.requires_grad and not out.pg_advantages.requires_grad
    # float64 and non-contiguous inputs are upcast/packed, not refused
    x64 = [x.detach().double().t().contiguous().t() for x in xs[:4]]
    out64 = ops.vtrace(*x64, xs[4].detach(), clip_rho=0.9)
    assert out64.vs.dtype == torch.float32
    assert torch.allclose(out64.vs, want.vs, atol=1e-6)
    assert vt.LAUNCHES == {"vtrace": 0}


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_inputs():
    """A wrapper launches its kernel or raises: a CPU tensor is refused
    before anything is built, never sent to the plain version."""
    xs = [torch.from_numpy(x) for x in _inputs(4, 5, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        vt.vtrace_cuda(*xs)
    assert vt.LAUNCHES == {"vtrace": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("clips", CLIPS, ids=["default", "clipped"])
def test_kernel_matches_plain_version_on_card(cuda, clips):
    for B, T in SHAPES + [(300, 50)]:
        xs = [torch.from_numpy(x).to(cuda) for x in _inputs(B, T, T)]
        before = vt.LAUNCHES["vtrace"]
        got = ops.vtrace(*xs, **clips)
        assert vt.LAUNCHES["vtrace"] == before + 1
        want = ref.vtrace_ref(*xs, **clips)
        for g, w in zip(got, want):
            assert ((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all()
    bad = [x.double() for x in xs]
    with pytest.raises(TypeError):
        vt.vtrace_cuda(*bad)
    with pytest.raises(ValueError, match="T >= 1"):
        vt.vtrace_cuda(*(x[:, :0].contiguous() for x in xs[:4]), xs[4])
    with pytest.raises(ValueError, match="contiguous"):
        vt.vtrace_cuda(*(x.t().contiguous().t() for x in xs[:4]), xs[4])
