"""Plain PyTorch version of single-token decode attention against a KV
cache: the port of ``repro/kernels/flash_decode/ref.py``.

q: (B, 1, H, h); k_cache/v_cache: (B, S, K, h); pos: a Python int, a 0-d
tensor, or per-row (B,) int32 — row b attends to cache entries <= pos[b]
(and > pos[b] - window when window > 0).  Everything computes in float32,
as the kernels do; the output takes q's dtype.

``gather_pages`` lays a block-table-mapped page pool out as the dense
(B, S, K, h) cache, so the paged version is the dense one over gathered
pages.

``split_decode_ref`` is the arithmetic of the Hopper kernels written
plainly: the cache cut into splits of ``split`` logical rows (the kernels
take theirs from ``flash_decode.plan``), one partial (m, l, acc) per split
that holds a live row, merged in split order with the log-sum-exp
rescale.  A row with no live row gives 0, as
the kernels and the Pallas kernel do (the one-shot version averages V
there); the serving path never asks for one.
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


def split_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, split: int,
                     window: int = 0) -> torch.Tensor:
    """The split-and-combine decode over splits of ``split`` rows."""
    B, _, H, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    n = -(-S // split)
    pad = n * split - S
    kc = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64).reshape(-1)
    pos = pos.expand(B)
    hi = torch.clamp(pos, max=S - 1)
    lo = torch.clamp(pos - window + 1, min=0) if window else torch.zeros_like(pos)
    s = torch.arange(n * split, device=q.device)
    valid = (s[None, :] >= lo[:, None]) & (s[None, :] <= hi[:, None])
    qg = q.reshape(B, K, G, h).float() * (h**-0.5)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, kc)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    logits = logits.reshape(B, K, G, n, split)
    m_s = logits.amax(dim=-1)  # (B, K, G, n)
    p = torch.exp(logits - m_s[..., None])
    l_s = p.sum(dim=-1)
    acc_s = torch.einsum("bkgnt,bntkh->bkgnh", p,
                         vc.reshape(B, n, split, K, h))
    live = valid.reshape(B, n, split).any(dim=-1)[:, None, None, :]
    m = torch.where(live, m_s, -torch.inf).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m_s - m), 0.0)
    l = torch.zeros_like(m[..., 0])
    acc = torch.zeros_like(acc_s[..., 0, :])
    for i in range(n):  # in split order
        l = l + w[..., i] * l_s[..., i]
        acc = acc + w[..., i, None] * acc_s[..., i, :]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, h).to(q.dtype)


def split_paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos, *, split: int) -> torch.Tensor:
    """The split-and-combine decode over gathered pages: the same splits
    of the same logical rows as the dense cache of length nb * bs."""
    return split_decode_ref(q, gather_pages(k_pages, block_tables),
                            gather_pages(v_pages, block_tables), pos,
                            split=split)
