"""Build, load and launch the Hopper SSD chunk scan (``ssd_scan.cu``):
``ssd_scan_cuda`` replaces the reference's ``ssd_scan_pallas`` and also
returns the state entering each chunk, which the backward needs.  One call
launches the source's four stages in order on the current stream (the
head-free scores, the chunk states, the state pass, y), into scratch the
wrapper allocates.

The source is compiled at first use with ``nvcc`` for sm_90a and loaded
with ctypes (``kernels/_build.py``).  Nothing here runs at import: the CPU
tests import this module on machines with no ``nvcc`` and no card.

``LAUNCHES["ssd_scan"]`` counts the kernel's launches, one a call for the
four stages: the wrapper adds one where it launches, and nowhere else;
callers that need a count over a run set it to 0 first
(``reset_launches``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("ssd_scan.cu")

LAUNCHES = {"ssd_scan": 0}

HEAD_DIMS = (16, 32, 64)  # the kernel's instantiations of P
STATE_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)  # N: a power of two <= 128
MAX_CHUNK = 1024
# rows of the output stage's query tiles (kWA in ssd_scan.cu): the scores'
# scratch is (B, T / Q, Qp, Qp) with Qp = Q rounded up to a multiple of it
QUERY_TILE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                     i, i, q, q, q, q, q, q, i, p]
        lib.ssd_scan_fwd.restype = i
        _lib = lib
    return _lib


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256):
    """x (B, T, H, P); dt (B, T, H) and A (H,) float32; Bm, Cm (B, T, N) of
    x's dtype (float32 or bfloat16); all on one CUDA device; chunks of
    Q = min(chunk, T) steps, T % Q == 0 -> (y (B, T, H, P) in x's dtype,
    S_final (B, H, P, N) float32, S_prevs (nc, B, H, P, N) float32),
    computed on the current stream from a zero state.

    x, Bm and Cm are read in place through their batch and time strides,
    so each needs only its inner dimensions dense: x's (H, P) and the
    N of Bm and Cm.  dt and A must be contiguous."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the SSD scan takes float32 or bfloat16 x, not "
                        f"{x.dtype}")
    if x.ndim != 4 or Bm.ndim != 3:
        raise ValueError(f"x must be (B, T, H, P) and Bm, Cm (B, T, N), got "
                         f"{tuple(x.shape)} / {tuple(Bm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim P={P} is not taken: the kernel is built "
                         f"for P in {HEAD_DIMS}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N} is not taken: the kernel takes a "
                         f"power of two up to 128")
    if T < 1 or chunk < 1:
        raise ValueError(f"T={T} and chunk={chunk} must be >= 1")
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"T={T} must divide into chunks of {Q}")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} is longer than the kernel's "
                         f"{MAX_CHUNK}")
    for name, t, shape, dtype in (("dt", dt, (B, T, H), torch.float32),
                                  ("A", A, (H,), torch.float32),
                                  ("Bm", Bm, (B, T, N), x.dtype),
                                  ("Cm", Cm, (B, T, N), x.dtype)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("dt and A must be contiguous")
    if x.stride(3) != 1 or (H > 1 and x.stride(2) != P):
        raise ValueError(f"x's (H, P) must be dense, got strides "
                         f"{x.stride()}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if N > 1 and t.stride(2) != 1:
            raise ValueError(f"{name}'s N must be dense, got strides "
                             f"{t.stride()}")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {x.device}")
    nc = T // Q
    Qp = -(-Q // QUERY_TILE) * QUERY_TILE
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    s_final = torch.empty((B, H, P, N), **f32)
    s_prevs = torch.empty((nc, B, H, P, N), **f32)
    gram = torch.empty((B, nc, Qp, Qp), **f32)  # C B^T once per (b, chunk)
    cum = torch.empty((B, H, nc, Q), **f32)
    err = _library().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), s_final.data_ptr(), s_prevs.data_ptr(),
        gram.data_ptr(), cum.data_ptr(), B, T, H, P, N, Q, x.stride(0),
        x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, s_final, s_prevs
