"""Plain PyTorch version of single-token decode attention against a KV
cache: the port of ``repro/kernels/flash_decode/ref.py``.

q: (B, 1, H, h); k_cache/v_cache: (B, S, K, h); pos: a Python int, a 0-d
tensor, or per-row (B,) int32 — row b attends to cache entries <= pos[b]
(and > pos[b] - window when window > 0).  Everything computes in float32,
as the kernels do; the output takes q's dtype.

``gather_pages`` lays a block-table-mapped page pool out as the dense
(B, S, K, h) cache, so the paged version is the dense one over gathered
pages.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _valid_mask(S: int, pos: torch.Tensor, window: int) -> torch.Tensor:
    """-> (S,) for a scalar pos, (B, S) for per-row pos."""
    k_pos = torch.arange(S, device=pos.device)
    if pos.ndim == 0:
        valid = k_pos <= pos
        if window:
            valid &= k_pos > pos - window
        return valid
    valid = k_pos[None, :] <= pos[:, None]
    if window:
        valid &= k_pos[None, :] > (pos[:, None] - window)
    return valid


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos, *,
                         window: int = 0) -> torch.Tensor:
    B, _, H, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, h).float() * (h**-0.5)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    valid = _valid_mask(S, torch.as_tensor(pos, device=q.device), window)
    mask = valid[None, None, None, :] if valid.ndim == 1 else \
        valid[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, h).to(q.dtype)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pages: (P, bs, K, h); block_tables: (B, nb) int32 page ids -> dense
    (B, nb*bs, K, h).  Logical position s of row b lives at
    pages[block_tables[b, s // bs], s % bs]."""
    B, nb = block_tables.shape
    _, bs, K, h = pages.shape
    return pages[block_tables.long()].reshape(B, nb * bs, K, h)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor, pos, *,
                               window: int = 0) -> torch.Tensor:
    """Gather the pages to the dense layout, then run the dense version.
    Positions past ``pos`` are masked to exactly NEG_INF before the
    softmax, so whatever an unmapped or stale page holds cannot reach the
    output."""
    kc = gather_pages(k_pages, block_tables)
    vc = gather_pages(v_pages, block_tables)
    return decode_attention_ref(q, kc, vc, pos, window=window)
