"""V-trace dispatch by tensor device: the port of
``repro/kernels/vtrace/ops.py``.

A CUDA ``log_rhos`` goes to the Hopper kernel (which raises on what it does
not take); a CPU one goes to the plain version in ``ref.py``.  There is no
other route: nothing falls back from the kernel to the plain version.

No gradient flows through the V-trace targets (IMPALA treats vs and the
advantages as constants; the reference wraps them in ``stop_gradient``):
the inputs are detached, upcast to contiguous float32, and the outputs
carry no grad.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.vtrace import ref
from repro_torch.kernels.vtrace.ref import VTraceOutput
from repro_torch.kernels.vtrace.vtrace import vtrace_cuda


def vtrace(
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
    args = [x.detach().float().contiguous()
            for x in (log_rhos, discounts, rewards, values, bootstrap_value)]
    kw = dict(clip_rho=clip_rho, clip_c=clip_c, lambda_=lambda_)
    if log_rhos.device.type == "cuda":
        return vtrace_cuda(*args, **kw)
    if log_rhos.device.type != "cpu":
        raise ValueError(f"vtrace runs on cuda or cpu, not {log_rhos.device}")
    return ref.vtrace_ref(*args, **kw)
