"""Build, load and launch the Hopper RG-LRU scan (``rglru_scan.cu``):
``rglru_scan_cuda`` replaces the reference's ``rglru_scan_pallas`` and also
returns the float32 state after each step, which the backward needs.

The source is compiled at first use with ``nvcc`` for sm_90a and loaded
with ctypes (``kernels/_build.py``).  Nothing here runs at import: the CPU
tests import this module on machines with no ``nvcc`` and no card.

``LAUNCHES["rglru_scan"]`` counts the kernel's launches: the wrapper adds
one where it launches, and nowhere else; callers that need a count over a
run set it to 0 first (``reset_launches``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("rglru_scan.cu")

LAUNCHES = {"rglru_scan": 0}

# the Pallas kernel's blocks: T must divide into blocks of min(256, T)
# steps and W into blocks of min(512, W) channels
BLOCK_T, BLOCK_W = 256, 512
_DTYPES = (torch.float32, torch.bfloat16)
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.rglru_scan_fwd.restype = i
        _lib = lib
    return _lib


def check_blocks(T: int, W: int) -> None:
    """The Pallas kernel's contract on (T, W)."""
    bt, bw = min(BLOCK_T, T), min(BLOCK_W, W)
    if T < 1 or W < 1 or T % bt or W % bw:
        raise ValueError(f"(T={T}, W={W}) must divide blocks ({bt}, {bw})")


def rglru_scan_cuda(x: torch.Tensor, a: torch.Tensor, gate_i: torch.Tensor):
    """x, a, gate_i (B, T, W) contiguous on one CUDA device, each float32
    or bfloat16 -> (y (B, T, W) in x's dtype, h (B, T, W) float32, the
    state after each step), computed on the current stream from a zero
    state."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, W), got {tuple(x.shape)}")
    B, T, W = x.shape
    check_blocks(T, W)
    for name, t in (("x", x), ("a", a), ("gate_i", gate_i)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 "
                            "or bfloat16")
        if t.shape != x.shape:
            raise ValueError(f"{name} must be {tuple(x.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {x.device}")
    y = torch.empty_like(x)
    h = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    bf16 = [int(t.dtype == torch.bfloat16) for t in (x, a, gate_i)]
    err = _library().rglru_scan_fwd(
        x.data_ptr(), a.data_ptr(), gate_i.data_ptr(), y.data_ptr(),
        h.data_ptr(), B, T, W, *bf16,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    LAUNCHES["rglru_scan"] += 1
    return y, h
