"""Sebulba running IMPALA/V-trace on host environments (paper Fig. 3): the
PyTorch twin of ``examples/sebulba_impala.py``, on-policy over host envs.

    PYTHONPATH=src python -m repro_torch.launch.sebulba_impala --frames 64000
    PYTHONPATH=src python -m repro_torch.launch.sebulba_impala --device cpu \
        --frames 2000

It runs on the card unless ``--device cpu`` is given.  On one device the
device plays actor and learner, with each actor thread and the learner on
their own CUDA stream.
"""

from __future__ import annotations

import argparse

from repro_torch import optim
from repro_torch.agents.impala import ConvActorCritic
from repro_torch.core.sebulba import Sebulba, SebulbaConfig
from repro_torch.envs import BatchedHostEnv, HostPong


def build(*, actor_batch: int = 32, trajectory: int = 20,
          device=None) -> Sebulba:
    """The example's configuration: ConvActorCritic (16, 32) channels, one
    residual block, hidden 256, on 16x16 HostPong frames; two actor threads
    of ``actor_batch`` envs; RMSProp 3e-4 with the global norm clipped
    at 1."""
    return Sebulba(
        env_factory=lambda seed: HostPong(seed=seed),
        make_batched_env=lambda f, n: BatchedHostEnv(f, n),
        network=ConvActorCritic(HostPong.num_actions, channels=(16, 32),
                                blocks=1),
        optimizer=optim.rmsprop(3e-4, clip_norm=1.0),
        config=SebulbaConfig(threads_per_actor_core=2,
                             actor_batch_size=actor_batch,
                             trajectory_length=trajectory),
        device=device,
    )


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50_000)
    ap.add_argument("--actor-batch", type=int, default=32)
    ap.add_argument("--trajectory", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    seb = build(actor_batch=args.actor_batch, trajectory=args.trajectory,
                device=args.device)
    print(f"device: {seb.split.learner_devices[0]} (actor and learner)")
    out = seb.fit(0, total_frames=args.frames, log_every=25)
    print(
        f"\n{out['frames']:,} frames in {out['seconds']:.1f}s "
        f"-> {out['fps']:,.0f} FPS, {out['updates']} updates, "
        f"mean return {out['mean_return']:.2f}"
    )
    return out


if __name__ == "__main__":
    main()
