"""Plain PyTorch version of the RG-LRU scan: the port of
``_assoc_scan_fwd_impl`` of ``repro/kernels/rglru_scan/ops.py``, the
zero-state forward that the Hopper kernel is held against.

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (i_t * x_t),  h_{-1} = 0

Shapes: x, a, i (B, T, W), each float32 or bfloat16 on its own (Griffin
hands over x in the param dtype and a, i in float32).  Every input is
upcast to float32; y comes back in x's dtype beside the float32 states.

``linear_scan`` is the log-depth first-order scan (Hillis-Steele: log2 T
rounds of the reference's ``combine``, each over the whole sequence),
written once for the forward and, with ``reverse=True``, for the
backward's g_t = dy_t + a_{t+1} g_{t+1}.  It never forms a cumulative
product of a as a closed form: over 2048 steps that underflows.
"""

from __future__ import annotations

import torch


def linear_scan(a: torch.Tensor, b: torch.Tensor, *,
                reverse: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1 (from the end
    when ``reverse``: h_t = a_t h_{t+1} + b_t).  a, b float32 (B, T, W)."""
    if reverse:
        return linear_scan(a.flip(1), b.flip(1)).flip(1)
    T = a.shape[1]
    shift = 1
    while shift < T:
        # combine(c1, c2) = (a1 a2, b1 a2 + b2), c1 the element `shift`
        # steps earlier; the first `shift` elements have no partner yet
        b = torch.cat([b[:, :shift], b[:, :-shift] * a[:, shift:]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def rglru_scan_ref(x: torch.Tensor, a: torch.Tensor, gate_i: torch.Tensor):
    """-> (y (B, T, W) in x's dtype, h (B, T, W) float32, the state after
    each step)."""
    af = a.float()
    beta = torch.sqrt(torch.clamp(1.0 - af**2, min=0.0))
    u = beta * (gate_i.float() * x.float())
    h = linear_scan(af, u)
    return h.to(x.dtype), h
