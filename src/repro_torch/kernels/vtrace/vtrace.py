"""Build, load and launch the Hopper V-trace kernel (``vtrace.cu``):
``vtrace_cuda`` replaces the reference's ``vtrace_pallas``.

The kernel is a two-level scan over time: each thread reduces a segment of
one row, a row's segments are scanned within its block, and each thread
re-runs its segment from the carry it gets.  ``plan(B, T)`` is the split
the launcher computes from (B, T) alone (``make_plan`` in ``vtrace.cu``
holds the same rule; ``library_plan`` asks the built library for it, so
the card can hold the two against each other), and
``ref.vtrace_segmented_ref`` is the same scan in plain PyTorch.

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
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vtrace.ref import VTraceOutput

SOURCE = Path(__file__).with_name("vtrace.cu")

LAUNCHES = {"vtrace": 0}

THREADS = 256  # a block (kThreads in vtrace.cu)
SEG_TARGET = 9  # a row takes threads until its segments are this short
SEG_MAX = 55  # the longest segment: a chunk of 256 x 55 steps fits a block
FILL = 132 * THREADS  # threads that give each of the H100's SMs a block
# shared memory a block may use on sm_90 (cudaFuncSetAttribute's limit)
SMEM_MAX = 232448

_lib: ctypes.CDLL | None = None


class Plan(NamedTuple):
    row_threads: int  # P: threads a row, one segment each (a power of two)
    rows: int  # R: rows a block, THREADS // P
    seg: int  # L: steps a segment (odd: see vtrace.cu on shared banks)
    chunk: int  # steps a chunk, P * L; a row is walked chunk by chunk
    chunks: int  # chunks a row
    stride: int  # floats from one row of a shared slab to the next
    smem: int  # dynamic shared memory a block, bytes
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _odd(n: int) -> int:
    return n | 1


def plan(B: int, T: int) -> Plan:
    """The kernel's split of a (B, T) batch.  A row takes threads, a power
    of two, until its segments are at most SEG_TARGET steps (or the row
    fills the block); then, while B rows leave the card short of FILL
    threads, each row takes twice as many while that shortens its
    segments.  A row longer than a block's shared memory holds (past
    256 x SEG_MAX steps) is cut into chunks of equal length, walked from
    the last."""
    if B <= 0 or T <= 0:
        raise ValueError(f"no V-trace plan for B={B}, T={T}")
    P = 1
    while P < THREADS and _odd(_cdiv(T, P)) > SEG_TARGET:
        P *= 2
    while (P < THREADS and B * P < FILL
           and _odd(_cdiv(T, 2 * P)) < _odd(_cdiv(T, P))):
        P *= 2
    L = _odd(_cdiv(T, P))
    if L > SEG_MAX:  # only at P == THREADS
        L = _odd(_cdiv(T, THREADS * _cdiv(T, THREADS * SEG_MAX)))
    R = THREADS // P
    C = P * L
    # a slab row holds a chunk and up to 3 floats of head, so that 16-byte
    # aligned runs of the inputs land on 16-byte aligned shared memory; with
    # several rows a block it is padded so that the threads of a warp
    # reading step j of their segments, across rows, hit distinct banks
    stride = _cdiv(min(C, T) + 3, 4) * 4
    if R > 1 and (L * P) % 4 == 0:
        while stride % 32 != (L * P) % 32:
            stride += 4
    smem = 4 * (4 * R * stride + 2 * R + 2 * (THREADS // 32))
    return Plan(P, R, L, C, _cdiv(T, C), stride, smem, _cdiv(B, R))


def reset_launches() -> None:
    LAUNCHES["vtrace"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vtrace_f32.argtypes = [p, p, p, p, p, p, p, i, i, f, f, f, p]
        lib.vtrace_f32.restype = i
        lib.vtrace_plan.argtypes = [i, i, p]
        lib.vtrace_plan.restype = None
        _lib = lib
    return _lib


def library_plan(B: int, T: int) -> Plan:
    """The split the built kernel's launcher computes for (B, T): equal to
    ``plan(B, T)`` where the two rules agree (needs ``nvcc``)."""
    out = (ctypes.c_int * len(Plan._fields))()
    _library().vtrace_plan(B, T, out)
    return Plan(*out)


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
