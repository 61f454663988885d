"""Trajectories and the actor's device trajectory ring: the port of
``repro/data/trajectory.py``.

``Trajectory`` is batch-major (B, T, ...).  A Sebulba actor thread fills a
``DeviceTrajectoryBuffer``, preallocated (B, T, ...) tensors on its device
that ``buffer_add`` writes one step at a time IN PLACE (the reference
threads the ring through a donated jit to the same end).  Its cursors are
host ints: the actor knows them, so no step reads them from the device.

Rewards and discounts of step t are known on the host only after the env
consumed action t, so they arrive one step late: ``buffer_add`` writes
them at slot t-1 (``has_prev`` gates the first write after an init or a
drain), and the final step's land in ``buffer_drain`` with the bootstrap
observation.  ``buffer_drain`` hands the ring's tensors themselves to the
trajectory (no copy, as the reference's donation aliases them) and gives
the actor a fresh zeroed ring.

Agent extras and recurrent carries are not ported with this slice:
``Trajectory.extras`` and ``init_carry`` stay ``()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


class Trajectory(NamedTuple):
    obs: torch.Tensor  # (B, T, ...)
    actions: torch.Tensor  # (B, T) int64
    rewards: torch.Tensor  # (B, T) float32
    discounts: torch.Tensor  # (B, T) float32
    behaviour_logp: torch.Tensor  # (B, T) float32
    bootstrap_obs: torch.Tensor  # (B, ...) obs at T (for the bootstrap value)
    extras: Any = ()
    init_carry: Any = ()


@dataclasses.dataclass
class DeviceTrajectoryBuffer:
    """One actor thread's ring: (B, T, ...) storage and two host cursors."""

    obs: torch.Tensor  # (B, T, ...)
    actions: torch.Tensor  # (B, T)
    rewards: torch.Tensor  # (B, T) float32
    discounts: torch.Tensor  # (B, T) float32
    behaviour_logp: torch.Tensor  # (B, T)
    t: int = 0  # write cursor, wraps mod T
    has_prev: bool = False  # a step since init/drain awaits its reward

    @property
    def length(self) -> int:
        return self.actions.shape[1]

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.obs, self.actions, self.rewards, self.discounts,
                self.behaviour_logp)


def device_buffer_init(length: int, obs: torch.Tensor, actions: torch.Tensor,
                       logp: torch.Tensor) -> DeviceTrajectoryBuffer:
    """A zeroed ring for ``length`` steps shaped after one step's (B, ...)
    ``obs``, ``actions`` and ``logp`` (their dtypes and device)."""

    def alloc(x):
        return torch.zeros((x.shape[0], length) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)

    B = actions.shape[0]
    f32 = dict(dtype=torch.float32, device=actions.device)
    return DeviceTrajectoryBuffer(
        obs=alloc(obs), actions=alloc(actions),
        rewards=torch.zeros((B, length), **f32),
        discounts=torch.zeros((B, length), **f32),
        behaviour_logp=alloc(logp),
    )


def buffer_add(buf: DeviceTrajectoryBuffer, obs: torch.Tensor,
               actions: torch.Tensor, logp: torch.Tensor,
               rew_disc: torch.Tensor) -> DeviceTrajectoryBuffer:
    """Write one env step at the cursor, in place.  ``rew_disc`` is the
    (2, B) float32 [rewards; discounts] of the PREVIOUS step, written at
    slot t-1 (mod T) when ``has_prev``.  Returns ``buf``."""
    t = buf.t
    if buf.has_prev:
        prev = (t - 1) % buf.length
        buf.rewards[:, prev] = rew_disc[0]
        buf.discounts[:, prev] = rew_disc[1]
    buf.obs[:, t] = obs
    buf.actions[:, t] = actions
    buf.behaviour_logp[:, t] = logp
    buf.t = (t + 1) % buf.length
    buf.has_prev = True
    return buf


def buffer_drain(buf: DeviceTrajectoryBuffer, rew_disc: torch.Tensor,
                 bootstrap_obs: torch.Tensor
                 ) -> tuple[Trajectory, DeviceTrajectoryBuffer]:
    """Complete the trajectory: the last step's (2, B) ``rew_disc`` in, the
    ring's own tensors out as the trajectory, a fresh zeroed ring back."""
    T = buf.length
    buf.rewards[:, T - 1] = rew_disc[0]
    buf.discounts[:, T - 1] = rew_disc[1]
    traj = Trajectory(
        obs=buf.obs, actions=buf.actions, rewards=buf.rewards,
        discounts=buf.discounts, behaviour_logp=buf.behaviour_logp,
        bootstrap_obs=bootstrap_obs,
    )
    fresh = DeviceTrajectoryBuffer(*(torch.zeros_like(x)
                                     for x in buf.tensors()))
    return traj, fresh


def split_for_learners(traj: Trajectory, num_learners: int) -> list[Trajectory]:
    """Split a trajectory batch along B into ``num_learners`` equal shards
    (views; empty fields stay empty)."""

    def split(x):
        if isinstance(x, torch.Tensor):
            if x.shape[0] % num_learners:
                raise ValueError(f"batch {x.shape[0]} does not split into "
                                 f"{num_learners} equal shards")
            return x.chunk(num_learners, dim=0)
        return (x,) * num_learners

    parts = [split(x) for x in traj]
    return [Trajectory(*(p[i] for p in parts)) for i in range(num_learners)]
