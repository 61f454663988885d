"""Podracer core: Sebulba (on-policy, host envs) and its device topology."""

from repro_torch.core.sebulba import Sebulba, SebulbaConfig  # noqa: F401
from repro_torch.core.topology import CoreSplit, split_devices  # noqa: F401
