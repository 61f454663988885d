"""The port's flash-decode (``repro_torch.kernels.flash_decode``) against
the reference's Pallas kernels run in interpret mode on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; a
bf16 input is rounded once, identically, on both sides.

Tolerances (max abs error), as the reference holds its kernels against
its oracles (``tests/test_kernels.py:20-21``):
  * float32: 2e-5 — both compute in f32, only the summation order differs;
  * bfloat16: 2e-2 — both compute in f32 from the same bf16 inputs, and the
    outputs round to bf16 (one ulp of bf16 near 1 is 7.8e-3).  On the card
    the kernels' bf16 outputs are also held within half a bf16 ulp (2**-8
    of the magnitude) plus 2e-5 of the plain version in float32.
Within the port, dispatch and the paged-vs-dense identity are exact.

``ref.split_decode_ref`` is the kernels' own arithmetic written plainly:
the cache cut into ``plan``'s splits, a partial per live split, merged in
split order.  It is held against the Pallas kernels at the edges of a
split (rows at pos 0, splits wholly masked, a window, S not a multiple of
the split, G 1 and 16, h 64 to 256, bs 16 and 32).

The CUDA kernels themselves run only on the card: the ``gpu`` tests here
skip without one, and ``chip_smoke.py`` holds the kernels against these
plain versions at the serving shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.flash_decode import (
    flash_decode_pallas,
    flash_decode_pallas_paged,
)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import flash_decode as fd
from repro_torch.kernels.flash_decode import ops, ref
from repro_torch.kernels.vtrace import vtrace as vt

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(x: np.ndarray, dtype: str):
    """One f32 numpy array -> (jax array, torch tensor) of ``dtype``,
    bit-identical."""
    j = jnp.asarray(x, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype)
    )
    return j, t


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


def _paged_inputs(seed: int, B: int, nb: int, bs: int, H: int, K: int,
                  h: int):
    rng = np.random.default_rng(seed)
    P = 1 + B * nb
    q = rng.standard_normal((B, 1, H, h), np.float32)
    kp = rng.standard_normal((P, bs, K, h), np.float32)
    vp = rng.standard_normal((P, bs, K, h), np.float32)
    tables = (1 + rng.permutation(P - 1)[: B * nb]).reshape(B, nb)
    return q, kp, vp, tables.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,K,h,pos,window,bs",
    [
        (2, 256, 4, 2, 64, 100, 0, 64),
        (1, 512, 8, 1, 32, 511, 0, 128),  # MQA, full cache
        (2, 256, 4, 4, 64, 200, 64, 64),  # MHA + sliding window
        (1, 128, 8, 2, 128, 0, 0, 64),  # first token
    ],
)
def test_decode_ref_matches_jax_pallas(B, S, H, K, h, pos, window, bs, dtype):
    rng = np.random.default_rng(S + pos)
    qj, qt = _pair(rng.standard_normal((B, 1, H, h), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, K, h), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, K, h), np.float32), dtype)
    want = flash_decode_pallas(qj, kj, vj, jnp.int32(pos), window=window,
                               block_s=bs, interpret=True)
    got = ref.decode_attention_ref(qt, kt, vt, pos, window=window)
    assert got.dtype == qt.dtype and got.shape == (B, 1, H, h)
    assert _err(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_ragged_rows_and_block_not_s(dtype):
    """Rows at pos 0, 7 and 31 in one batch, with S (32) != the Pallas
    block (16); the per-row batch equals the scalar calls to within
    1e-6 (torch's CPU einsum sums a batch of 3 in another order than a
    batch of 1, so the bits may differ; the masks may not)."""
    S, H, K, h = 32, 4, 2, 64
    rng = np.random.default_rng(17)
    qj, qt = _pair(rng.standard_normal((3, 1, H, h), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((3, S, K, h), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((3, S, K, h), np.float32), dtype)
    pos = np.array([0, 7, 31], np.int32)
    want = flash_decode_pallas(qj, kj, vj, jnp.asarray(pos), block_s=16,
                               interpret=True)
    got = ref.decode_attention_ref(qt, kt, vt, torch.from_numpy(pos))
    assert _err(want, got) < TOL[dtype]
    for b in range(3):
        row = ref.decode_attention_ref(qt[b:b + 1], kt[b:b + 1], vt[b:b + 1],
                                       int(pos[b]))
        assert (got[b:b + 1].float() - row.float()).abs().max() <= \
            (1e-6 if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_matches_jax_pallas_paged(dtype):
    """A scrambled logical->physical page layout (page 0 reserved) with
    ragged positions: the port's paged version matches the reference's
    paged kernel, and equals the port's dense version on the gathered
    cache bit for bit."""
    B, nb, bs, H, K, h = 3, 4, 8, 4, 2, 32
    q, kp, vp, tables = _paged_inputs(23, B, nb, bs, H, K, h)
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(kp, dtype)
    vj, vt = _pair(vp, dtype)
    pos = np.array([0, 9, 31], np.int32)
    want = flash_decode_pallas_paged(qj, kj, vj, jnp.asarray(tables),
                                     jnp.asarray(pos), interpret=True)
    tt, pt = torch.from_numpy(tables), torch.from_numpy(pos)
    got = ref.paged_decode_attention_ref(qt, kt, vt, tt, pt)
    assert _err(want, got) < TOL[dtype]
    dense = ref.decode_attention_ref(qt, ref.gather_pages(kt, tt),
                                     ref.gather_pages(vt, tt), pt)
    assert torch.equal(got, dense)


# The split-and-combine arithmetic of the kernels (``ref.split_decode_ref``)
# at the edges of the split: a row at pos 0 (every split past the first
# wholly masked), a window (splits before it wholly masked), S not a
# multiple of the split, G 1 and 16, h 64, 128 and 256.
# (B, S, H, K, h, pos, window, Pallas block_s, split)
SPLIT_CASES = {
    "pos0_ragged_S": (3, 96, 4, 2, 64, [0, 40, 95], 0, 32, 64),
    "window_G1": (2, 256, 2, 2, 128, [255, 130], 100, 64, 64),
    "G16": (2, 128, 16, 1, 64, [0, 127], 0, 64, 64),
    "h256_ragged_S": (1, 192, 8, 2, 256, [150], 0, 64, 128),
    "serving_heads": (4, 256, 12, 2, 128, [0, 63, 64, 255], 0, 64, 64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_ref_matches_jax_pallas(case, dtype):
    """Per-split partials combined in split order match the reference's
    Pallas kernel in interpret mode and the one-shot plain version, at the
    given split and at the kernels' own plan."""
    B, S, H, K, h, pos, window, block_s, split = SPLIT_CASES[case]
    rng = np.random.default_rng(S + h + H)
    qj, qt = _pair(rng.standard_normal((B, 1, H, h), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, K, h), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, K, h), np.float32), dtype)
    pos = np.asarray(pos, np.int32)
    want = flash_decode_pallas(qj, kj, vj, jnp.asarray(pos), window=window,
                               block_s=block_s, interpret=True)
    pt = torch.from_numpy(pos)
    plain = ref.decode_attention_ref(qt, kt, vt, pt, window=window)
    for sp in (split, fd.plan(S, B, H, K).split):
        got = ref.split_decode_ref(qt, kt, vt, pt, window=window, split=sp)
        assert got.dtype == qt.dtype and got.shape == (B, 1, H, h)
        assert _err(want, got) < TOL[dtype]
        assert (got.float() - plain.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [16, 32, 24])
def test_split_paged_ref_matches_jax_pallas_paged(bs, dtype):
    """The paged split-and-combine over a scrambled page pool (96 logical
    rows: one full split of 64 and a ragged one; with pages of 24 a page
    straddles the split) matches the reference's paged kernel, and equals
    the dense split version on the gathered cache bit for bit."""
    B, nb, H, K, h = 3, 96 // bs, 12, 2, 64
    q, kp, vp, tables = _paged_inputs(bs, B, nb, bs, H, K, h)
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(kp, dtype)
    vj, vt = _pair(vp, dtype)
    pos = np.array([0, 37, nb * bs - 1], np.int32)
    want = flash_decode_pallas_paged(qj, kj, vj, jnp.asarray(tables),
                                     jnp.asarray(pos), interpret=True)
    tt, pt = torch.from_numpy(tables), torch.from_numpy(pos)
    split = fd.plan(nb * bs, B, H, K).split
    got = ref.split_paged_decode_ref(qt, kt, vt, tt, pt, split=split)
    assert _err(want, got) < TOL[dtype]
    dense = ref.split_decode_ref(qt, ref.gather_pages(kt, tt),
                                 ref.gather_pages(vt, tt), pt, split=split)
    assert torch.equal(got, dense)


def test_split_ref_gives_zero_for_a_row_with_no_live_position():
    """pos far past a windowed cache leaves no live row: the kernels' and
    the Pallas kernel's untouched accumulator gives 0 (the one-shot plain
    version would average V); the other row is unaffected."""
    S, H, K, h = 64, 4, 2, 32
    rng = np.random.default_rng(3)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 for shape in ((2, 1, H, h), (2, S, K, h), (2, S, K, h)))
    pos = torch.tensor([200, 40], dtype=torch.int32)
    got = ref.split_decode_ref(q, kc, vc, pos, window=16, split=32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ref.decode_attention_ref(q[1:], kc[1:], vc[1:], 40, window=16)
    assert (got[1:] - want).abs().max().item() < TOL["float32"]


@pytest.mark.parametrize("S", [1, 63, 64, 65, 96, 256, 2048, 2049, 4096,
                               1 << 20])
def test_plan_splits_both_layouts_alike(S):
    """The plan depends on the allocated length alone (dense S, paged
    nb * bs), so both layouts split one logical cache at the same rows:
    whole 64-row tiles a split, at most ``SPLITS`` splits, covering S and
    no more than one split past it; the batch and heads set only the
    grids."""
    B, H, K = 8, 12, 2
    p = fd.plan(S, B, H, K)
    assert p.split % fd.TILE == 0 and p.split >= fd.TILE
    assert (p.n_split - 1) * p.split < S <= p.n_split * p.split
    assert p.n_split <= fd.SPLITS
    assert p.grid == (p.n_split, K, B) and p.combine_grid == (H // K, K, B)
    other = fd.plan(S, 3, 16, 1)
    assert (other.split, other.n_split) == (p.split, p.n_split)
    if S <= fd.TILE * fd.SPLITS:
        assert p.split == fd.TILE


def test_plan_refuses_what_no_kernel_takes():
    for args in ((0, 1, 2, 1), (64, 0, 2, 1), (64, 1, 3, 2), (64, 1, 2, 0)):
        with pytest.raises(ValueError):
            fd.plan(*args)


def test_gather_pages_layout_and_idle_rows():
    """Logical position s of row b is pages[table[b, s // bs], s % bs]; an
    all-zero table row (an idle engine row) reads the scratch page, and a
    position past the table (``pos = max_seq``) attends to every slot."""
    B, nb, bs, H, K, h = 2, 3, 4, 2, 1, 8
    q, kp, vp, tables = _paged_inputs(5, B, nb, bs, H, K, h)
    tables[1] = 0
    kt, tt = torch.from_numpy(kp), torch.from_numpy(tables)
    g = ref.gather_pages(kt, tt)
    assert g.shape == (B, nb * bs, K, h)
    for s in range(nb * bs):
        assert torch.equal(g[0, s], kt[tables[0, s // bs], s % bs])
        assert torch.equal(g[1, s], kt[0, s % bs])
    out = ref.paged_decode_attention_ref(
        torch.from_numpy(q), kt, torch.from_numpy(vp), tt,
        torch.tensor([5, nb * bs], dtype=torch.int32),
    )
    assert torch.isfinite(out).all()


def test_ops_sends_cpu_tensors_to_plain_versions_and_guards_window():
    B, nb, bs, H, K, h = 2, 3, 8, 2, 1, 32
    q, kp, vp, tables = _paged_inputs(29, B, nb, bs, H, K, h)
    qt, kt, vt, tt = (torch.from_numpy(x) for x in (q, kp, vp, tables))
    pos = torch.tensor([4, 20], dtype=torch.int32)
    paged = ops.flash_decode(qt, kt, vt, pos, block_tables=tt)
    assert torch.equal(paged,
                       ref.paged_decode_attention_ref(qt, kt, vt, tt, pos))
    kc, vc = ref.gather_pages(kt, tt), ref.gather_pages(vt, tt)
    dense = ops.flash_decode(qt, kc, vc, pos, window=8)
    assert torch.equal(dense, ref.decode_attention_ref(qt, kc, vc, pos,
                                                       window=8))
    with pytest.raises(ValueError):
        ops.flash_decode(qt, kt, vt, pos, block_tables=tt, window=8)


def test_kernel_wrappers_take_only_cuda_tensors():
    """A wrapper launches its kernel or raises: a CPU tensor is refused
    before anything is built, never sent to the plain version."""
    q = torch.zeros(1, 1, 2, 8)
    kc = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_cuda(q, kc, kc, 0)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_paged_cuda(q, kc, kc,
                                   torch.zeros(1, 1, dtype=torch.int32), 0)
    assert fd.LAUNCHES == {"flash_decode": 0, "flash_decode_paged": 0,
                           "flash_decode_combine": 0}


def test_build_targets_hopper_and_keys_on_source(tmp_path):
    """Both CUDA sources build through the one loader, for sm_90a, into
    build/kernels under a name keyed on the source's bytes."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert "fast-math" not in flags
    paths = {}
    for source in (fd.SOURCE, vt.SOURCE):
        path = paths[source.stem] = _build.library_path(source)
        assert path.parent == _build.BUILD_DIR and path.parent.name == "kernels"
        assert path.parent.parent.name == "build"
        assert path.name.startswith(source.stem + "-") and path.suffix == ".so"
        edited = tmp_path / source.name
        edited.write_bytes(source.read_bytes() + b"\n")
        assert _build.library_path(edited).name != path.name
    assert set(paths) == {"flash_decode", "vtrace"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# (B, nb, bs, H, K, h, pos): the serving shape (S 256), a long cache (S
# 4096), G 16 at h 256 over a ragged S, G 1 with bs 32, and pages of 24
# (not a power of two) that straddle the 64-row splits
CARD_SHAPES = [
    (8, 16, 16, 12, 2, 128, [0, 31, 32, 100, 127, 200, 254, 255]),
    (8, 256, 16, 12, 2, 128, [0, 255, 256, 1000, 2047, 3000, 4000, 4095]),
    (3, 12, 16, 16, 1, 256, [0, 17, 191]),
    (2, 5, 32, 2, 2, 64, [159, 64]),
    (2, 5, 24, 12, 2, 128, [119, 50]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(CARD_SHAPES)))
def test_kernels_match_plain_versions_on_card(cuda, dtype, shape):
    """Both kernels against the plain versions (and the split version for
    the window), paged == dense on the gathered cache bit for bit, the
    same call twice the same bits, and one launch of each kernel a call.
    In bf16 each output is also within half a bf16 ulp (2**-8 of its
    magnitude) plus the float32 tolerance of the plain version computed
    in float32 on the same inputs: a bound that scales with the output,
    where the flat 2e-2 is as large as a long row's outputs."""
    B, nb, bs, H, K, h, pos = CARD_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(shape)
    S, P = nb * bs, 1 + B * nb

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, kp, vp = randn(B, 1, H, h), randn(P, bs, K, h), randn(P, bs, K, h)
    tables = (1 + torch.randperm(P - 1, generator=gen, device=cuda))
    tables = tables.reshape(B, nb).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kc, vc = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    tol = TOL[str(dtype).split(".")[1]]
    for window in (0, 10):
        before = dict(fd.LAUNCHES)
        got = fd.flash_decode_cuda(q, kc, vc, pos, window=window)
        assert fd.LAUNCHES["flash_decode"] == before["flash_decode"] + 1
        assert fd.LAUNCHES["flash_decode_combine"] == \
            before["flash_decode_combine"] + 1
        want = ref.decode_attention_ref(q, kc, vc, pos, window=window)
        assert (got.float() - want.float()).abs().max().item() < tol
        if dtype == torch.bfloat16:
            exact = ref.decode_attention_ref(q.float(), kc.float(),
                                             vc.float(), pos, window=window)
            excess = (got.float() - exact).abs() - 2**-8 * exact.abs()
            assert excess.max().item() <= TOL["float32"]
        split = ref.split_decode_ref(q, kc, vc, pos, window=window,
                                     split=fd.plan(S, B, H, K).split)
        assert (got.float() - split.float()).abs().max().item() < tol
        assert torch.equal(got, fd.flash_decode_cuda(q, kc, vc, pos,
                                                     window=window))
    paged = fd.flash_decode_paged_cuda(q, kp, vp, tables, pos)
    assert torch.equal(paged, fd.flash_decode_cuda(q, kc, vc, pos))
    assert torch.equal(paged, fd.flash_decode_paged_cuda(q, kp, vp, tables,
                                                         pos))
