"""The port's V-trace (``repro_torch.kernels.vtrace``) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the
CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance 1e-5 abs, as the reference holds its kernel against its oracle
(``tests/test_kernels.py:142-161``): all three compute in float32, in
another order of operations.

The staged version (``ref.vtrace_segmented_ref``) is the kernel's two-level
scan over time in plain PyTorch; it is held to the same references at the
same tolerance, under the kernel's own split (``vtrace.plan``) and under
splits chosen to reach the scan's edges on small shapes.  Rows of 2,047
steps and more take 1e-5 + 1e-5 * |ref| instead: with discounts of 0.99
and c near 1, |acc| grows to ~100 |delta|, each reordered step of the scan
rounds at that size, and a flat 1e-5 would hold long rows to a few ulps of
their largest terms.

The CUDA kernel runs only on the card: the ``gpu`` tests here skip without
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
    """The sweep, the LLM learners' (2, 2047) on their own inputs, a large
    batch, one row, T = 1, and rows past one chunk of shared memory (the
    carry between chunks); a repeated call gives the same bits."""
    cases = [(B, T, _inputs(B, T, T)) for B, T in
             SHAPES + [(300, 50), (4096, 100), (1, 200), (64, 1), (1, 1),
                       (3, 14081), (1, 20000)]]
    cases.append((2, 2047, _learner_inputs(2, 2047, 7)))
    for B, T, np_xs in cases:
        xs = [torch.from_numpy(x).to(cuda) for x in np_xs]
        before = vt.LAUNCHES["vtrace"]
        got = ops.vtrace(*xs, **clips)
        assert vt.LAUNCHES["vtrace"] == before + 1
        again = ops.vtrace(*xs, **clips)
        want = ref.vtrace_ref(*xs, **clips)
        for g, a, w in zip(got, again, want):
            assert ((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all(), (B, T)
            assert torch.equal(g, a), (B, T)
    bad = [x.double() for x in xs]
    with pytest.raises(TypeError):
        vt.vtrace_cuda(*bad)
    with pytest.raises(ValueError, match="T >= 1"):
        vt.vtrace_cuda(*(x[:, :0].contiguous() for x in xs[:4]), xs[4])
    with pytest.raises(ValueError, match="contiguous"):
        vt.vtrace_cuda(*(x.t().contiguous().t() for x in xs[:4]), xs[4])


# ------------------------------------------------- the staged version


def _learner_inputs(B: int, T: int, seed: int):
    """The LLM learner's V-trace inputs as ``repro_torch/launch/specs.py``
    draws them: discounts 0.99 throughout, rewards N(0, 0.1^2), behaviour
    log-probs -|N(0, 1)|; the target log-probs are drawn the same way
    (log_rhos = target - behaviour), values and the bootstrap N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    return [
        (np.abs(rng.standard_normal((B, T)))
         - np.abs(rng.standard_normal((B, T)))).astype(np.float32),
        np.full((B, T), 0.99, np.float32),
        (0.1 * rng.standard_normal((B, T))).astype(np.float32),
        (0.1 * rng.standard_normal((B, T))).astype(np.float32),
        (0.1 * rng.standard_normal((B,))).astype(np.float32),
    ]


def _split(B: int, T: int, P: int, L: int):
    """A plan of P threads a row and L steps a segment: what the staged
    version reads of it."""
    return vt.plan(B, T)._replace(row_threads=P, seg=L, chunk=P * L)


def _hold(xs, plan, clips, scaled: bool):
    js = [jnp.asarray(x) for x in xs]
    got = ref.vtrace_segmented_ref(*(torch.from_numpy(x) for x in xs),
                                   plan=plan, **clips)
    B = xs[0].shape[0]
    for want in (vtrace_pallas(*js, block_b=min(4, B), interpret=True,
                               **clips),
                 jax_vtrace_ref(*js, **clips)):
        for w, g in ((want.vs, got.vs), (want.pg_advantages,
                                         got.pg_advantages)):
            w = np.asarray(w)
            tol = 1e-5 + (1e-5 * np.abs(w) if scaled else 0.0)
            assert (np.abs(w - g.numpy()) <= tol).all(), _err(w, g)
    assert got.vs.dtype == torch.float32 and got.vs.shape == xs[3].shape
    return got


@pytest.mark.parametrize("clips", CLIPS, ids=["default", "clipped"])
@pytest.mark.parametrize("B,T", SHAPES)
def test_segmented_ref_matches_pallas_and_jnp_oracle(B, T, clips):
    _hold(_inputs(B, T, B * T), vt.plan(B, T), clips, scaled=False)


@pytest.mark.parametrize("clips", CLIPS, ids=["default", "clipped"])
def test_segmented_ref_on_the_llm_learners_inputs(clips):
    """(2, 2047): the LLM learners' call, one row a block of 256 segments
    of 9 steps."""
    plan = vt.plan(2, 2047)
    assert (plan.row_threads, plan.seg, plan.chunks) == (256, 9, 1)
    _hold(_learner_inputs(2, 2047, 7), plan, clips, scaled=True)


def test_segmented_ref_past_one_chunk_of_shared_memory():
    """T 20,000: two chunks of 256 x 41 steps, the carry passed between
    them."""
    plan = vt.plan(1, 20000)
    assert plan.chunks == 2 and plan.chunk < 20000
    _hold(_learner_inputs(1, 20000, 8), plan, {}, scaled=True)
    _hold(_inputs(1, 20000, 9), plan, {}, scaled=True)


# (B, T, P, L): T = 1; T shorter than the row's segments (most threads
# idle); T not a multiple of L; one-step segments within a warp and across
# warps; several chunks within a warp's segments and across warps
EDGE_SPLITS = [(3, 1, 1, 1), (3, 1, 256, 1), (2, 5, 256, 1), (4, 40, 64, 3),
               (3, 100, 16, 7), (5, 23, 8, 3), (2, 90, 32, 1), (2, 300, 256, 1),
               (3, 300, 32, 3), (2, 600, 256, 1), (2, 700, 64, 5)]


@pytest.mark.parametrize("clips", CLIPS, ids=["default", "clipped"])
@pytest.mark.parametrize("B,T,P,L", EDGE_SPLITS)
def test_segmented_ref_at_the_scans_edges(B, T, P, L, clips):
    _hold(_inputs(B, T, T + P), _split(B, T, P, L), clips, scaled=T >= 300)


@pytest.mark.parametrize("B,T,P,L", [(3, 100, 16, 7), (2, 300, 32, 3),
                                     (2, 600, 256, 1)])
def test_segmented_ref_with_a_zero_discount_at_segment_edges(B, T, P, L):
    """A discount of 0 exactly at a segment's last step, at the next one's
    first, and at a chunk's edges: the maps there are (0, delta) and
    nothing carries across."""
    xs = _inputs(B, T, 11)
    C = P * L
    for t in (L - 1, L, 3 * L - 1, C - 1, C, T - 1):
        if t < T:
            xs[1][:, t] = 0.0
    got = _hold(xs, _split(B, T, P, L), {}, scaled=T >= 300)
    # at gamma_t = 0, vs_t = V_t + delta_t: the carry does not reach it
    rho = np.minimum(1.0, np.exp(xs[0][:, L - 1]))
    want = xs[3][:, L - 1] + rho * (xs[2][:, L - 1] - xs[3][:, L - 1])
    assert np.abs(got.vs[:, L - 1].numpy() - want).max() < 1e-5


# ---------------------------------------------------------------- plan


PLAN_SHAPES = [(B, T) for B in (1, 2, 3, 7, 32, 33, 257, 4096, 40000)
               for T in (1, 2, 3, 7, 9, 10, 20, 33, 100, 256, 2047, 2304,
                         2305, 14080, 14081, 20000)]


@pytest.mark.parametrize("B,T", PLAN_SHAPES)
def test_plan_covers_every_step_once_and_fits(B, T):
    p = vt.plan(B, T)
    P, R, L, C = p.row_threads, p.rows, p.seg, p.chunk
    assert P & (P - 1) == 0 and P * R == vt.THREADS
    assert L % 2 == 1 and L <= vt.SEG_MAX and C == P * L
    assert p.chunks == -(-T // C) and p.blocks == -(-B // R)
    # row b is thread group b % R of block b // R: whole within one block
    assert (p.blocks - 1) * R < B <= p.blocks * R
    # step t is segment (t % C) // L of chunk t // C: within the row's P
    # threads, each step once
    t = np.arange(T)
    seg, chunk = (t % C) // L, t // C
    assert seg.max() < P and chunk.max() < p.chunks
    assert len(set(zip(chunk.tolist(), seg.tolist(), (t % L).tolist()))) == T
    # a slab row holds a chunk and a 3-float head, 16-byte aligned; the
    # block's four slabs and its scratch fit shared memory
    assert p.stride % 4 == 0 and p.stride >= min(C, T) + 3
    if R > 1 and (L * P) % 4 == 0:
        assert p.stride % 32 == (L * P) % 32  # rows continue the bank pattern
    assert p.smem == 4 * (4 * R * p.stride + 2 * R + 2 * vt.THREADS // 32)
    assert p.smem <= vt.SMEM_MAX


def test_plan_at_the_callers_shapes():
    """The split the .cu header names for each caller's shape."""
    assert vt.plan(2, 2047)[:5] == (256, 1, 9, 2304, 1)
    assert vt.plan(4096, 100)[:5] == (16, 16, 7, 112, 1)
    assert vt.plan(4096, 100).blocks == 256
    assert vt.plan(32, 20)[:5] == (8, 32, 3, 24, 1)
    assert vt.plan(1, 20000)[:5] == (256, 1, 41, 10496, 2)
    with pytest.raises(ValueError):
        vt.plan(0, 5)
    with pytest.raises(ValueError):
        vt.plan(3, 0)


@pytest.mark.gpu
def test_library_plan_is_the_python_plan(cuda):
    for B, T in PLAN_SHAPES:
        assert vt.library_plan(B, T) == vt.plan(B, T), (B, T)


@pytest.mark.gpu
@pytest.mark.parametrize("clips", CLIPS, ids=["default", "clipped"])
def test_kernel_is_the_staged_version_bit_for_bit_on_card(cuda, clips):
    """Both round every step once, in the same order (the .cu header)."""
    for B, T in [(32, 20), (2, 2047), (4096, 100), (1, 20000), (3, 6)]:
        xs = [torch.from_numpy(x).to(cuda) for x in _inputs(B, T, 5)]
        got = vt.vtrace_cuda(*xs, **clips)
        want = ref.vtrace_segmented_ref(*xs, plan=vt.plan(B, T), **clips)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (B, T)
