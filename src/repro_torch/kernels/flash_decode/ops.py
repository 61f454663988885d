"""Flash-decode dispatch by tensor device: the port of
``repro/kernels/flash_decode/ops.py``.

A CUDA ``q`` goes to the Hopper kernels (which raise on what they do not
take); a CPU ``q`` goes to the plain versions in ``ref.py``.  There is no
other route: nothing falls back from the kernel to the plain version.

``pos`` is an int, a 0-d tensor or a (B,) int32 vector of per-row
positions.  ``block_tables`` switches to the paged layout: ``k_cache`` /
``v_cache`` are then ``(P, bs, K, h)`` page pools and the ``(B, nb)``
table maps each row's logical blocks onto them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import ref
from repro_torch.kernels.flash_decode.flash_decode import (
    flash_decode_cuda,
    flash_decode_paged_cuda,
)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos, *,
                 block_tables: torch.Tensor | None = None,
                 window: int = 0) -> torch.Tensor:
    if block_tables is not None and window:
        raise ValueError(
            "paged decode is global-attention only: sliding-window layers "
            "keep the dense per-row cache (window=0 required with "
            "block_tables)"
        )
    if q.device.type == "cuda":
        if block_tables is not None:
            return flash_decode_paged_cuda(q, k_cache, v_cache,
                                           block_tables, pos)
        return flash_decode_cuda(q, k_cache, v_cache, pos, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash decode runs on cuda or cpu, not {q.device}")
    if block_tables is not None:
        return ref.paged_decode_attention_ref(q, k_cache, v_cache,
                                              block_tables, pos)
    return ref.decode_attention_ref(q, k_cache, v_cache, pos, window=window)
