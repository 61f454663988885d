"""Build, load and launch the Hopper flash-attention forward
(``flash_attention.cu``): ``flash_attention_cuda`` replaces the
reference's ``flash_attention_pallas`` and also returns the row
log-sum-exp the backward needs.

The source holds two variants of the kernel and ``variant(dtype, h)``
picks one by a static rule: v2 (TMA, ``wgmma``, warp specialisation) for
bfloat16 at h 64 and 128, v1 (``mma.sync``) for float32 and for h 32 and
256.  A failure of either raises; nothing falls back to the other.

The source is compiled at first use with ``nvcc`` for sm_90a and loaded
with ctypes (``kernels/_build.py``).  Nothing here runs at import: the CPU
tests import this module on machines with no ``nvcc`` and no card.

``LAUNCHES["flash_attention"]`` counts the kernel's launches, and
``VARIANT_LAUNCHES`` the launches of each variant: the wrapper adds one
to both where it launches, and nowhere else; callers that need a count
over a run set them to 0 first (``reset_launches``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("flash_attention.cu")

LAUNCHES = {"flash_attention": 0}
VARIANT_LAUNCHES = {"v1": 0, "v2": 0}

HEAD_DIMS = (32, 64, 128, 256)  # v1's instantiations
V2_HEAD_DIMS = (64, 128)  # v2's, in bfloat16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    VARIANT_LAUNCHES.update(v1=0, v2=0)


def variant(dtype: torch.dtype, h: int) -> str:
    """The kernel that computes a call of this dtype and head_dim: "v2"
    for bfloat16 at h 64 and 128, "v1" for every other case the wrapper
    takes."""
    return "v2" if dtype == torch.bfloat16 and h in V2_HEAD_DIMS else "v1"


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, i, f, f, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd_v2.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               i, i, i, f, f, p]
        lib.flash_attention_fwd_v2.restype = i
        _lib = lib
    return _lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """q (B, T, H, h); k, v (B, S, K, h) of q's dtype (float32 or
    bfloat16), contiguous, on one CUDA device -> (out (B, T, H, h) in q's
    dtype, lse (B, H, T) float32), computed on the current stream."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, T, H, h) and k, v (B, S, K, h), got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    B, T, H, h = q.shape
    S, K = k.shape[1], k.shape[2]
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} is not taken: the kernel is built for "
                         f"head_dim in {HEAD_DIMS}")
    if K < 1 or H % K:
        raise ValueError(f"H={H} query heads must be a multiple of K={K}")
    if T < 1 or S < 1:
        raise ValueError(f"T={T} and S={S} must be >= 1")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S, K, h):
            raise ValueError(f"{name} must be {(B, S, K, h)}, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # v1 reads 16 bytes at a time; v2's TMA too
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    which = variant(q.dtype, h)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, S, H, K, h, int(causal), window, h**-0.5,
            softcap)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if which == "v2":
        err = _library().flash_attention_fwd_v2(*args, stream)
    else:
        err = _library().flash_attention_fwd(*args, _DTYPES[q.dtype], stream)
    if err != 0:  # a negative code is the CUresult of a tensor map's encoding
        raise RuntimeError(f"flash_attention {which} launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[which] += 1
    return out, lse
