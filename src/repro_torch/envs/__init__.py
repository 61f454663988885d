"""Host environments for Sebulba."""

from repro_torch.envs.batched_env import BatchedHostEnv  # noqa: F401
from repro_torch.envs.host_env import HostPong, spawn_ball  # noqa: F401
