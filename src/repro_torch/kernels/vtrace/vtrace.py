"""Build, load and launch the Hopper V-trace kernel (``vtrace.cu``):
``vtrace_cuda`` replaces the reference's ``vtrace_pallas``.

The source is compiled at first use with ``nvcc`` for sm_90a and loaded
with ctypes (``kernels/_build.py``).  Nothing here runs at import: the CPU
tests import this module on machines with no ``nvcc`` and no card.

``LAUNCHES["vtrace"]`` counts the kernel's launches: the wrapper adds one
where it launches, and nowhere else; callers that need a count over a run
set it to 0 first (``reset_launches``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vtrace.ref import VTraceOutput

SOURCE = Path(__file__).with_name("vtrace.cu")

LAUNCHES = {"vtrace": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["vtrace"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vtrace_f32.argtypes = [p, p, p, p, p, p, p, i, i, f, f, f, p]
        lib.vtrace_f32.restype = i
        _lib = lib
    return _lib


def vtrace_cuda(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    *,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    lambda_: float = 1.0,
) -> VTraceOutput:
    """(B, T) float32 log_rhos, discounts, rewards, values and the (B,)
    bootstrap, contiguous, on one CUDA device -> vs and pg_advantages,
    (B, T) float32, computed on the current stream of that device."""
    device = log_rhos.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {device}")
    if log_rhos.ndim != 2 or log_rhos.shape[1] < 1:
        raise ValueError(f"log_rhos must be (B, T) with T >= 1, got "
                         f"{tuple(log_rhos.shape)}")
    B, T = log_rhos.shape
    for name, t, shape in (("log_rhos", log_rhos, (B, T)),
                           ("discounts", discounts, (B, T)),
                           ("rewards", rewards, (B, T)),
                           ("values", values, (B, T)),
                           ("bootstrap_value", bootstrap_value, (B,))):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; the kernel runs on "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    vs = torch.empty_like(values)
    adv = torch.empty_like(values)
    err = _library().vtrace_f32(
        log_rhos.data_ptr(), discounts.data_ptr(), rewards.data_ptr(),
        values.data_ptr(), bootstrap_value.data_ptr(), vs.data_ptr(),
        adv.data_ptr(), B, T, clip_rho, clip_c, lambda_,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"vtrace launch failed: CUDA error {err}")
    LAUNCHES["vtrace"] += 1
    return VTraceOutput(vs=vs, pg_advantages=adv)
