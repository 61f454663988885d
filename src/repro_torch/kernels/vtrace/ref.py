"""The plain PyTorch version of V-trace (IMPALA, Espeholt et al. 2018): the
port of ``repro/kernels/vtrace/ref.py``.  What the CPU runs, and what the
kernel (``vtrace.cu``) is held against on the card.

Batch-major (B, T) throughout:

    rho_t   = min(clip_rho, exp(log pi - log mu))
    c_t     = lambda * min(clip_c, exp(log pi - log mu))
    delta_t = rho_t * (r_t + gamma_t * V_{t+1} - V_t)
    vs_t    = V_t + delta_t + gamma_t * c_t * (vs_{t+1} - V_{t+1})
    adv_t   = rho_t * (r_t + gamma_t * vs_{t+1} - V_t)

Inputs are upcast to float32 as the reference does; the reverse recursion
is a loop over T, vectorised over B.

``vtrace_segmented_ref`` computes the same targets as the kernel does (a
two-level scan over time, ``vtrace.cu``), in the kernel's order of
operations, so the card can hold the two against each other step by step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class VTraceOutput(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor


def vtrace_ref(
    log_rhos: torch.Tensor,  # (B, T) log pi - log mu
    discounts: torch.Tensor,  # (B, T) gamma_t (0 at episode ends)
    rewards: torch.Tensor,  # (B, T)
    values: torch.Tensor,  # (B, T) V(s_t)
    bootstrap_value: torch.Tensor,  # (B,) V(s_T)
    *,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    lambda_: float = 1.0,
) -> VTraceOutput:
    rhos = torch.exp(log_rhos.float())
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    cs = lambda_ * torch.clamp(rhos, max=clip_c)
    values = values.float()
    rewards = rewards.float()
    discounts = discounts.float()
    boot = bootstrap_value.float()[:, None]

    values_tp1 = torch.cat([values[:, 1:], boot], dim=1)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)
    errs = torch.empty_like(values)  # vs_t - V_t
    acc = torch.zeros_like(boot[:, 0])
    for t in reversed(range(values.shape[1])):
        acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
        errs[:, t] = acc
    vs = values + errs

    vs_tp1 = torch.cat([vs[:, 1:], boot], dim=1)
    pg_adv = clipped_rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceOutput(vs=vs, pg_advantages=pg_adv)


def vtrace_segmented_ref(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    *,
    plan,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    lambda_: float = 1.0,
) -> VTraceOutput:
    """V-trace as the kernel computes it under ``plan`` (a ``vtrace.Plan``:
    its ``row_threads`` P, ``seg`` L and ``chunk`` are read).

    The recursion acc_t = delta_t + g_t * acc_{t+1}, g_t = gamma_t * c_t,
    is affine, and maps (G, D): acc -> D + G * acc compose as
    (G1, D1) o (G2, D2) = (G1 G2, D1 + G1 D2).  A row is cut into chunks of
    P * L steps, walked from the last; a chunk into P segments of L steps,
    one a thread.  Pass 1 reduces each segment to its map; the maps are
    scanned from the end of the row, first within groups of min(P, 32)
    segments (a warp, by shuffles: Kogge-Stone, distance 1, 2, 4, ...),
    then across a row's warps; pass 2 re-runs each segment from its carry
    in the plain version's order.  Every step rounds as the kernel rounds
    it: one float32 operation at a time, in the same order."""
    lr, d, r, v = (x.float() for x in (log_rhos, discounts, rewards, values))
    boot = bootstrap_value.float()
    B, T = v.shape
    dev = v.device
    P, L, C = plan.row_threads, plan.seg, plan.chunk
    W = min(P, 32)
    rho = torch.exp(lr)
    clipped = torch.clamp(rho, max=clip_rho)
    g = d * (lambda_ * torch.clamp(rho, max=clip_c))
    v_tp1 = torch.cat([v[:, 1:], boot[:, None]], dim=1)
    delta = clipped * (r + d * v_tp1 - v)

    lane = torch.arange(P, device=dev) % W
    seg_start = torch.arange(P, device=dev) * L
    vs = torch.empty_like(v)
    adv = torch.empty_like(v)
    row_acc = torch.zeros(B, device=dev)  # acc at the step after the chunk
    for t0 in reversed(range(0, T, C)):
        tc = min(C, T - t0)

        def segs(x, fill=0.0):  # (B, tc) of the chunk -> (B, P, L)
            return F.pad(x[:, t0:t0 + tc], (0, P * L - tc),
                         value=fill).view(B, P, L)

        dl, gl = segs(delta), segs(g, 1.0)  # pads are identity steps
        G = torch.ones(B, P, device=dev)
        D = torch.zeros(B, P, device=dev)
        for j in reversed(range(L)):  # pass 1
            D = dl[..., j] + gl[..., j] * D
            G = gl[..., j] * G

        def later(x, off):  # x of the segment ``off`` places later
            return torch.cat([x[:, off:], x[:, :off]], dim=1)

        off = 1
        while off < W:  # within a warp
            ok = lane + off < W
            G2, D2 = later(G, off), later(D, off)
            D = torch.where(ok, D + G * D2, D)
            G = torch.where(ok, G * G2, G)
            off *= 2
        cw = row_acc[:, None].expand(B, P)
        if P > 32:  # across a row's warps: the carry at each warp's end
            nw = P // 32
            c = [row_acc] * nw
            for w in reversed(range(nw - 1)):
                c[w] = D[:, 32 * (w + 1)] + G[:, 32 * (w + 1)] * c[w + 1]
            cw = torch.stack(c, dim=1).repeat_interleave(32, dim=1)
        carry = torch.where(lane + 1 < W,
                            later(D, 1) + later(G, 1) * cw, cw)

        v_end = v_tp1[:, t0 + (seg_start + L).clamp(max=tc) - 1]  # V_e
        vl, rl, dd, cl = segs(v), segs(r), segs(d), segs(clipped)
        acc, vs_next = carry, v_end + carry
        out_vs = torch.empty(B, P, L, device=dev)
        out_adv = torch.empty(B, P, L, device=dev)
        for j in reversed(range(L)):  # pass 2
            real = seg_start + j < tc
            a = dl[..., j] + gl[..., j] * acc
            vs_t = vl[..., j] + a
            out_adv[..., j] = cl[..., j] * (rl[..., j] + dd[..., j] * vs_next
                                            - vl[..., j])
            out_vs[..., j] = vs_t
            acc = torch.where(real, a, acc)
            vs_next = torch.where(real, vs_t, vs_next)
        vs[:, t0:t0 + tc] = out_vs.view(B, P * L)[:, :tc]
        adv[:, t0:t0 + tc] = out_adv.view(B, P * L)[:, :tc]
        row_acc = acc[:, 0]
    return VTraceOutput(vs=vs, pg_advantages=adv)
