"""Flash-attention forward dispatch by tensor device: the port of
``repro/kernels/flash_attention/ops.py``.

A CUDA ``q`` goes to the Hopper kernel (which raises on what it does not
take); a CPU ``q`` goes to the plain chunked version in ``ref.py``
(``chunk`` sets its KV chunk; the kernel's tile is fixed).  There is no
other route: nothing falls back from the kernel to the plain version.

Returns ``(out (B, T, H, h), lse (B, H, T) float32)``: the backward in
``models/attention.py`` takes the row log-sum-exp from the forward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, chunk: int = 1024):
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, softcap=softcap)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, chunk=chunk)
