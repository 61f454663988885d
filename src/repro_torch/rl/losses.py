"""RL losses: the port of the policy-gradient, entropy and IMPALA (V-trace
actor-critic) parts of ``repro/rl/losses.py``.

The V-trace targets come from ``kernels/vtrace/ops.py``: the Hopper
kernel on the card, the plain version on the CPU, with no gradient
through them in either case.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.vtrace.ops import vtrace


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """logits (..., A), actions (...) -> log pi(a|s), as logit[a] -
    logsumexp(logits) in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, actions.long()[..., None])[..., 0]
    return chosen - lse


def entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def policy_gradient_loss(logits: torch.Tensor, actions: torch.Tensor,
                         advantages: torch.Tensor) -> torch.Tensor:
    return -torch.mean(log_prob(logits, actions) * advantages.detach())


class ImpalaLossOut(NamedTuple):
    total: torch.Tensor
    pg: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor
    mean_rho: torch.Tensor


def impala_loss(
    logits: torch.Tensor,  # (B, T, A) learner policy
    values: torch.Tensor,  # (B, T)
    actions: torch.Tensor,  # (B, T)
    behaviour_logp: torch.Tensor,  # (B, T) log mu(a|s) from the actor
    rewards: torch.Tensor,  # (B, T)
    discounts: torch.Tensor,  # (B, T)
    bootstrap_value: torch.Tensor,  # (B,)
    *,
    entropy_cost: float = 0.01,
    value_cost: float = 0.5,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
) -> ImpalaLossOut:
    """The V-trace actor-critic loss (Espeholt et al. 2018, eq. 1-4): the
    uniform-weight case of ``weighted_impala_loss``."""
    out = weighted_impala_loss(
        logits, values, actions, behaviour_logp, rewards, discounts,
        bootstrap_value, importance_weights=None,
        entropy_cost=entropy_cost, value_cost=value_cost,
        clip_rho=clip_rho, clip_c=clip_c,
    )
    return ImpalaLossOut(total=out.total, pg=out.pg, value=out.value,
                         entropy=out.entropy, mean_rho=out.mean_rho)


class WeightedImpalaOut(NamedTuple):
    total: torch.Tensor
    pg: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor
    mean_rho: torch.Tensor
    per_seq_td: torch.Tensor  # (B,) |vs - V| per sequence -> replay priorities


def weighted_impala_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    behaviour_logp: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
    *,
    importance_weights: torch.Tensor | None = None,  # (B,) replay IS weights
    entropy_cost: float = 0.01,
    value_cost: float = 0.5,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
) -> WeightedImpalaOut:
    """V-trace loss with per-sequence importance weights (None: uniform),
    and the per-sequence TD magnitudes a replay ring takes as priorities."""
    target_logp = log_prob(logits, actions)
    log_rhos = target_logp - behaviour_logp
    vt = vtrace(log_rhos, discounts, rewards, values, bootstrap_value,
                clip_rho=clip_rho, clip_c=clip_c)
    if importance_weights is None:
        w = torch.ones(values.shape[:1], dtype=torch.float32,
                       device=values.device)
    else:
        w = importance_weights.detach()
    wn = w[:, None]
    pg = -torch.mean(wn * target_logp * vt.pg_advantages)
    value = 0.5 * torch.mean(wn * torch.square(vt.vs - values))
    ent = torch.mean(wn * entropy(logits))
    total = pg + value_cost * value - entropy_cost * ent
    per_seq_td = torch.mean(torch.abs(vt.vs - values), dim=1).detach()
    return WeightedImpalaOut(
        total=total, pg=pg, value=value, entropy=ent,
        mean_rho=torch.mean(torch.exp(log_rhos)), per_seq_td=per_seq_td,
    )
