"""Device topology for Sebulba: the port of ``repro/core/topology.py``.

Sebulba splits a host's devices into disjoint actor and learner sets
(paper Fig. 1c / Fig. 3).  With a single device, as on one H100, the same
device plays both roles (the reference's single-device fallback); the
port then runs actors and learner on separate CUDA streams.  The
reference's multi-host carving of a pod is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class CoreSplit:
    actor_devices: tuple[torch.device, ...]
    learner_devices: tuple[torch.device, ...]

    @property
    def num_actors(self) -> int:
        return len(self.actor_devices)

    @property
    def num_learners(self) -> int:
        return len(self.learner_devices)


def split_devices(num_actor_cores: int,
                  devices: Sequence[torch.device | str]) -> CoreSplit:
    """Split ``devices`` into ``num_actor_cores`` actor devices and the
    rest as learners; exactly one device plays both roles."""
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) == 1:
        return CoreSplit(actor_devices=devices, learner_devices=devices)
    if not 0 < num_actor_cores < len(devices):
        raise ValueError(
            f"cannot split {len(devices)} device(s) into {num_actor_cores} "
            "actor device(s) + at least one learner device: need 0 < "
            "num_actor_cores < the device count, or exactly one device "
            "(which then plays both roles)"
        )
    return CoreSplit(actor_devices=devices[:num_actor_cores],
                     learner_devices=devices[num_actor_cores:])
