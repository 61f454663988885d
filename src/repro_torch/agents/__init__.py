"""Agents speaking the ``repro_torch.api`` protocol."""

from repro_torch.agents.impala import ConvActorCritic, ImpalaAgent  # noqa: F401
