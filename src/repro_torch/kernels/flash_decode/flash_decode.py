"""Build, load and launch the Hopper flash-decode kernels
(``flash_decode.cu``): ``flash_decode_cuda`` for a dense ``(B, S, K, h)``
cache and ``flash_decode_paged_cuda`` for a ``(P, bs, K, h)`` page pool
through a ``(B, nb)`` block table.  They replace the reference's
``flash_decode_pallas`` and ``flash_decode_pallas_paged``.

Each call is two launches on the current stream: the split kernel
(``dense_kernel`` or ``paged_kernel``), one block per (split, kv head,
row), which writes per-split partials to float32 scratch allocated here,
then ``combine_kernel``, which merges a row's live splits in split order.
``plan`` gives the split length and the grids from the allocated length
alone (``S``, or ``nb * bs``): nothing reads ``pos`` on the host.

The source is compiled at first use with ``nvcc`` for sm_90a and loaded
with ctypes (``kernels/_build.py``).  Nothing here runs at import: the CPU
tests import this module on machines with no ``nvcc`` and no card.

``LAUNCHES`` counts the launches of each kernel.  A wrapper adds one where
it launches, and nowhere else; callers that need a count over a run set it
to 0 first (``reset_launches``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("flash_decode.cu")

LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0,
            "flash_decode_combine": 0}

TILE = 64  # a split is whole tiles of either dtype (kMaxTile in flash_decode.cu)
SPLITS = 32  # splits a row of a long cache is cut into, at most

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


class Plan(NamedTuple):
    split: int  # logical rows a split: the same for dense and paged
    n_split: int  # splits over the allocated length
    grid: tuple[int, int, int]  # split kernel: (n_split, K, B)
    combine_grid: tuple[int, int, int]  # (G, K, B)


def plan(S: int, B: int, H: int, K: int) -> Plan:
    """The launch of a decode over an allocated length ``S`` (dense S, or
    paged ``nb * bs``) for B rows of H query and K kv heads.  It depends on
    the allocated length only, so the dense and the paged kernel split one
    logical cache at the same rows."""
    if S <= 0 or B <= 0 or K <= 0 or H % K:
        raise ValueError(f"no decode plan for S={S}, B={B}, H={H}, K={K}")
    split = TILE * -(-S // (SPLITS * TILE))
    n_split = -(-S // split)
    return Plan(split, n_split, (n_split, K, B), (H // K, K, B))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_dense.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, i, f, i, p]
        lib.flash_decode_dense.restype = i
        lib.flash_decode_paged.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                           i, i, i, i, f, i, p]
        lib.flash_decode_paged.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; the kernel runs on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.is_floating_point() and t.data_ptr() % 16:  # read 16 bytes at a time
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _pos_vector(pos, batch: int, device: torch.device) -> torch.Tensor:
    """int, 0-d or (B,) position -> the contiguous (B,) int32 vector."""
    if isinstance(pos, int):
        return torch.full((batch,), pos, dtype=torch.int32, device=device)
    pos = pos.to(device=device, dtype=torch.int32).reshape(-1)
    return pos.expand(batch).contiguous()


def _check_query(q: torch.Tensor, K: int) -> tuple[int, int, int, int]:
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash decode takes float32 or bfloat16, not {q.dtype}")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, h), got {tuple(q.shape)}")
    B, _, H, h = q.shape
    if H % K or H // K > 16 or h % 8 or h > 256:
        raise ValueError(f"unsupported heads: H={H}, K={K}, h={h} (need "
                         "H % K == 0, H // K <= 16, h % 8 == 0, h <= 256)")
    _check("q", q, q.device)
    return B, H, K, h


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _partials(q: torch.Tensor, p: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch for the split kernel: acc (B, K, n_split, G, h) and (m, l)
    (B, K, n_split, G, 2), float32.  Only live splits write theirs, and
    the combine reads only those."""
    G, K, B = p.combine_grid
    h = q.shape[-1]
    acc = torch.empty((B, K, p.n_split, G, h), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((B, K, p.n_split, G, 2), dtype=torch.float32,
                     device=q.device)
    return acc, ml


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos, *,
                      window: int = 0) -> torch.Tensor:
    """q (B, 1, H, h); k/v (B, S, K, h) of q's dtype; pos an int, 0-d or
    (B,) tensor -> (B, 1, H, h) in q's dtype."""
    B, H, K, h = _check_query(q, k_cache.shape[2])
    S = k_cache.shape[1]
    if k_cache.shape != (B, S, K, h) or v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v must be (B, S, K, h) = {(B, S, K, h)}, got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    _check("k_cache", k_cache, q.device, q.dtype)
    _check("v_cache", v_cache, q.device, q.dtype)
    p = plan(S, B, H, K)
    pos = _pos_vector(pos, B, q.device)
    acc, ml = _partials(q, p)
    out = torch.empty_like(q)
    err = _library().flash_decode_dense(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        acc.data_ptr(), ml.data_ptr(), out.data_ptr(), B, S, H, K, h, window,
        p.split, h**-0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    LAUNCHES["flash_decode_combine"] += 1
    return out


def flash_decode_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            pos) -> torch.Tensor:
    """q (B, 1, H, h); pools (P, bs, K, h) of q's dtype; block_tables
    (B, nb) int32 whose entries lie in [0, P); pos an int, 0-d or (B,)
    tensor -> (B, 1, H, h).  Global attention only."""
    B, H, K, h = _check_query(q, k_pages.shape[2])
    P, bs = k_pages.shape[0], k_pages.shape[1]
    if k_pages.shape != (P, bs, K, h) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools must be (P, bs, K, h) = {(P, bs, K, h)}, "
                         f"got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B, nb), got "
                         f"{tuple(block_tables.shape)}")
    _check("k_pages", k_pages, q.device, q.dtype)
    _check("v_pages", v_pages, q.device, q.dtype)
    _check("block_tables", block_tables, q.device, torch.int32)
    nb = block_tables.shape[1]
    p = plan(nb * bs, B, H, K)
    pos = _pos_vector(pos, B, q.device)
    acc, ml = _partials(q, p)
    out = torch.empty_like(q)
    err = _library().flash_decode_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), acc.data_ptr(),
        ml.data_ptr(), out.data_ptr(), B, bs, nb, H, K, h, p.split, h**-0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_decode_paged")
    LAUNCHES["flash_decode_paged"] += 1
    LAUNCHES["flash_decode_combine"] += 1
    return out
