"""Train batches: the port of ``make_batch`` of ``repro/launch/specs.py``.

A batch is a token trajectory plus the V-trace fields the learner's loss
reads, with the reference's dtypes and distributions.  The draws come
from a ``torch.Generator`` (threefry cannot be reproduced in torch), so
the two packages agree on fields and distributions, not on values; the
tests hand the reference's batch over as numpy.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def make_batch(cfg: ArchConfig, batch_size: int, seq_len: int,
               generator: torch.Generator | None = None,
               device: str | torch.device | None = None) -> dict:
    """A random (B, T) batch on ``device`` (default: the card):
    ``tokens`` int32 uniform in [0, vocab), ``rewards`` N(0, 0.1^2),
    ``discounts`` 0.99, ``behaviour_logp`` -|N(0, 1)|, float32."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches (stub modality embeddings) are not ported "
            "yet: ROADMAP Queue 1 #10")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    shape = (batch_size, seq_len)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "tokens": torch.randint(0, cfg.vocab_size, shape, generator=generator,
                                dtype=torch.int32, device=dev),
        "rewards": torch.randn(shape, generator=generator, **f32) * 0.1,
        "discounts": torch.full(shape, 0.99, **f32),
        "behaviour_logp": -torch.randn(shape, generator=generator,
                                       **f32).abs(),
    }
