from repro_torch.data.trajectory import (  # noqa: F401
    DeviceTrajectoryBuffer,
    Trajectory,
    buffer_add,
    buffer_drain,
    device_buffer_init,
    split_for_learners,
)
