"""The RG-LRU scan with its gradient: the port of ``rglru_scan`` and of the
zero-state custom-VJP scan ``_assoc_scan_core`` of
``repro/kernels/rglru_scan/ops.py``.

The forward goes by tensor device: a CUDA ``x`` goes to the Hopper kernel
(which raises on what it does not take), a CPU ``x`` to the plain
``ref.rglru_scan_ref``.  There is no other route: nothing falls back from
the kernel to the plain version.  Both return the float32 states, which
the forward saves beside the inputs, as ``_assoc_core_fwd`` does.

The backward is ``_assoc_core_bwd`` (the zero-state case of
``_assoc_core_h0_bwd``) line for line, in plain PyTorch: one reverse
log-depth scan g_t = dy_t + a_{t+1} g_{t+1}, then elementwise

    dx_t = g_t beta_t i_t,   di_t = g_t beta_t x_t,
    da_t = g_t (h_{t-1} - a_t / max(beta_t, 1e-6) i_t x_t).

On a TPU the reference sends the zero-state scan to its Pallas kernel,
which has no backward (``ops.py:161-166``); the port pairs its kernel
with this one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import ref
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan_cuda


def rglru_scan_fwd(x, a, gate_i):
    """-> (y in x's dtype, h float32): the kernel for CUDA tensors, the
    plain scan for CPU tensors."""
    if x.device.type == "cuda":
        return rglru_scan_cuda(x.contiguous(), a.contiguous(),
                               gate_i.contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"the RG-LRU scan runs on cuda or cpu, not "
                         f"{x.device}")
    return ref.rglru_scan_ref(x, a, gate_i)


def rglru_scan_bwd(x, a, gate_i, h, dy):
    """``_assoc_core_bwd``: the cotangents of (x, a, gate_i), each in its
    input's dtype, from that of y, with h the float32 states."""
    xf, af, gif, dyf = x.float(), a.float(), gate_i.float(), dy.float()
    beta = torch.sqrt(torch.clamp(1.0 - af**2, min=0.0))
    a_next = torch.cat([af[:, 1:], torch.zeros_like(af[:, :1])], dim=1)
    g = ref.linear_scan(a_next, dyf, reverse=True)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    dx = g * beta * gif
    di = g * beta * xf
    dbeta_da = -af / torch.clamp(beta, min=1e-6)
    da = g * (h_prev + dbeta_da * gif * xf)
    return dx.to(x.dtype), da.to(a.dtype), di.to(gate_i.dtype)


class _RGLRUScan(torch.autograd.Function):
    """The reference's ``_assoc_scan_core``: the forward saves
    (x, a, gate_i, h) as ``_assoc_core_fwd`` does; the backward is
    ``rglru_scan_bwd``."""

    @staticmethod
    def forward(ctx, x, a, gate_i):
        y, h = rglru_scan_fwd(x, a, gate_i)
        ctx.save_for_backward(x, a, gate_i, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        return rglru_scan_bwd(*ctx.saved_tensors, dy)


def rglru_scan(x: torch.Tensor, a: torch.Tensor, gate_i: torch.Tensor,
               h0: torch.Tensor | None = None):
    """RG-LRU scan from a zero state.  x, a, gate_i: (B, T, W) -> y
    (B, T, W) in x's dtype, h_T (B, W) float32.  h_T is ``y[:, -1]`` cast
    to float32, as the Pallas kernel returns it, not the float32 state."""
    if h0 is not None:
        raise NotImplementedError(
            "h0: a scan from a stored state (the reference's "
            "_assoc_scan_core_h0, the R2D2 path) is not ported yet: ROADMAP "
            "Queue 1 #6")
    y = _RGLRUScan.apply(x, a, gate_i)
    return y, y[:, -1].float()
