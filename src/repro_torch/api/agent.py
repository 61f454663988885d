"""The Podracer agent protocol: the port of ``repro/api/agent.py``.

    init(generator, obs_shape)        -> params (on the generator's device)
    initial_carry(batch)              -> carry tree (() if none)
    act(params, obs, generator, carry) -> (actions, ActAux, carry)
    loss(params, traj, weights=None)  -> (scalar, LossAux)

Randomness is a ``torch.Generator`` where the reference passes a JAX key.
Capabilities are declared on an ``AgentSpec`` and checked once, when a
runner is built, by ``resolve_agent``.  The reference's adapter for agents
that declare no spec is not ported: such an agent is refused.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves


class ActAux(NamedTuple):
    """Per-step acting outputs besides the actions: ``logp``, the
    behaviour log-probability of the sampled action, and ``extras``, an
    agent's own per-step data (a dict keyed by ``AgentSpec.extras_keys``,
    or ``()``)."""

    logp: torch.Tensor
    extras: Any = ()


class LossAux(NamedTuple):
    """Loss auxiliaries: learner ``metrics`` (a flat dict of scalars) and
    per-sequence replay ``priorities`` (``()`` unless the agent declares
    ``replay=True``)."""

    metrics: Any
    priorities: Any = ()


@dataclasses.dataclass(frozen=True)
class AgentSpec:
    """Declared agent capabilities: ``recurrent`` (threads a nonempty,
    all-zero initial carry), ``replay`` (applies importance weights and
    returns priorities), ``extras_keys`` (the keys of ``ActAux.extras``)."""

    recurrent: bool = False
    replay: bool = False
    extras_keys: tuple[str, ...] = ()

    def __post_init__(self):
        keys = self.extras_keys
        if isinstance(keys, str):
            keys = (keys,)  # a bare string is ONE key, not its characters
        keys = tuple(keys)
        for k in keys:
            if not isinstance(k, str):
                raise TypeError(
                    f"extras_keys must be strings, got {type(k).__name__}"
                )
        object.__setattr__(self, "extras_keys", keys)


_POS_KINDS = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn) -> tuple[list[inspect.Parameter], bool]:
    params = inspect.signature(fn).parameters.values()
    return ([p for p in params if p.kind in _POS_KINDS],
            any(p.kind is inspect.Parameter.VAR_POSITIONAL for p in params))


def validate_agent(agent, spec: AgentSpec) -> None:
    """Check an agent against the protocol, raising ValueError with a
    fix-it message on the first violation."""
    name = type(agent).__name__
    for method in ("init", "act", "loss", "initial_carry"):
        if not callable(getattr(agent, method, None)):
            raise ValueError(
                f"{name} does not implement the agent protocol: missing "
                f"{method}() (see repro_torch/api/agent.py)"
            )
    act_pos, var_pos = _positional(agent.act)
    if not var_pos and len(act_pos) < 4:
        raise ValueError(
            f"{name}.act takes {len(act_pos)} positional arguments; the "
            "protocol is act(params, obs, generator, carry) -> (actions, "
            "ActAux(logp, extras), carry), and feed-forward agents receive "
            "(and return) the empty () carry"
        )
    if not var_pos and act_pos[3].name != "carry":
        raise ValueError(
            f"{name}.act's 4th positional parameter is {act_pos[3].name!r}, "
            "but runners pass the carry there; rename it and make other "
            "knobs keyword-only"
        )
    loss_pos, var_pos = _positional(agent.loss)
    if not var_pos and len(loss_pos) < 3:
        raise ValueError(
            f"{name}.loss takes {len(loss_pos)} positional arguments; the "
            "protocol is loss(params, trajectory, weights=None) -> (scalar, "
            "LossAux(metrics, priorities))"
        )
    carry = leaves(agent.initial_carry(1))
    if spec.recurrent and not carry:
        raise ValueError(
            f"{name} declares AgentSpec(recurrent=True) but initial_carry "
            "returns an empty tree"
        )
    if not spec.recurrent and carry:
        raise ValueError(
            f"{name}.initial_carry returns a nonempty carry but its "
            "AgentSpec has recurrent=False; declare recurrent=True"
        )
    if any(bool(torch.any(c != 0)) for c in carry):
        raise ValueError(
            f"{name}.initial_carry must be all zeros in every leaf: episode "
            "resets restore zero state"
        )


def resolve_agent(agent) -> tuple[Any, AgentSpec]:
    """``(agent, its validated AgentSpec)``; an agent with no declared
    ``spec`` is refused."""
    spec = getattr(agent, "spec", None)
    if not isinstance(spec, AgentSpec):
        raise ValueError(
            f"{type(agent).__name__} declares no AgentSpec: give it a class "
            "attribute spec = AgentSpec(...) (the reference's adapter for "
            "spec-less agents is not ported)"
        )
    validate_agent(agent, spec)
    return agent, spec
