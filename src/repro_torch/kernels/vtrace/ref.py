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
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
