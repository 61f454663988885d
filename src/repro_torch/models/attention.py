"""GQA attention: the port of the training forward (``full_attention``,
``sliding_window_attention``), decode and prefill parts of
``repro/models/attention.py``.

``full_attention`` runs its forward through ``kernels/flash_attention``
(the Hopper kernel on the card) and its backward as the reference's
flash-attention VJP in plain PyTorch.  ``sliding_window_attention``, the
windowed layers' training forward, is plain PyTorch with autograd, as the
reference's is jnp: routing it through the kernel, which takes a window,
would need a windowed ``_fa_bwd`` that the reference does not have.
Single-token decode goes through ``kernels/flash_decode`` (the Hopper
kernels on the card); chunked prefill is ``chunk_decode_attention`` here.
The cache updates write IN PLACE and return the same tensors, where the
reference returns new arrays: the port keeps one cache alive instead of
two.

``decode_attention`` (the reference's jnp decode, which casts the
probabilities to the cache dtype before the PV product) is not ported:
the port's decode on the CPU is the kernels' own plain version, which
stays in float32 as the kernels do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.param import ParamBuilder, fan_in_init, zeros_init

NEG_INF = layers.NEG_INF


class AttnDims(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int


def init_attention(b: ParamBuilder, name: str, dims: AttnDims, *,
                   qkv_bias: bool = False) -> None:
    d, H, K, h = dims
    with b.scope(name):
        b.param("wq", (d, H, h), fan_in_init())
        b.param("wk", (d, K, h), fan_in_init())
        b.param("wv", (d, K, h), fan_in_init())
        b.param("wo", (H, h, d), fan_in_init())
        if qkv_bias:
            b.param("bq", (H, h), zeros_init(), dtype=torch.float32)
            b.param("bk", (K, h), zeros_init(), dtype=torch.float32)
            b.param("bv", (K, h), zeros_init(), dtype=torch.float32)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, d) x (d, N, h) -> (B, T, N, h)."""
    d, n, h = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * h)).unflatten(-1, (n, h))


def qkv_project(params, x: torch.Tensor, *, positions: torch.Tensor | None,
                rope_theta: float):
    """x: (B, T, D) -> q (B,T,H,h), k/v (B,T,K,h), RoPE applied.  The
    float32 biases are cast to the activation dtype before the add, as
    in the reference."""
    dt = x.dtype
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if positions is not None:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    return q, k, v


def output_project(params, out: torch.Tensor) -> torch.Tensor:
    """out: (B, T, H, h) -> (B, T, D)."""
    wo = params["wo"].to(out.dtype)
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _fa_bwd(q, k, v, out, lse, do, causal: bool, chunk: int,
            softcap: float):
    """Flash-attention backward, line for line the reference's ``_fa_bwd``:
    recompute p per KV chunk from (q, k, lse) instead of saving the (T, S)
    probabilities, so O(T * chunk) memory lives at once.

        p    = exp(q k^T * s - lse)
        dv   = p^T do
        dp   = do v^T
        ds   = p * (dp - delta),  delta_t = sum_h do_t * out_t
        dq  += ds k * s ;  dk  = ds^T q * s
    """
    B, T, H, h = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    sm = h**-0.5
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, T, K, G, h).float()  # unscaled
    dog = do.reshape(B, T, K, G, h).float()
    outg = out.reshape(B, T, K, G, h).float()
    delta = torch.einsum("btkgh,btkgh->bkgt", dog, outg)  # (B, K, G, T)
    lse = lse.reshape(B, K, G, T)
    q_pos = torch.arange(T, device=q.device)
    dq = torch.zeros((B, T, K, G, h), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(n_chunks):
        kb = k[:, i * chunk:(i + 1) * chunk].float()
        vb = v[:, i * chunk:(i + 1) * chunk].float()
        logits = sm * torch.einsum("btkgh,bskh->bkgts", qg, kb)
        if softcap > 0:
            tanh_arg = logits / softcap
            logits_capped = softcap * torch.tanh(tanh_arg)
        else:
            logits_capped = logits
        k_pos = i * chunk + torch.arange(chunk, device=q.device)
        valid = k_pos < S
        if causal:
            mask = valid[None, :] & (k_pos[None, :] <= q_pos[:, None])
        else:
            mask = valid[None, :]
        p = torch.where(mask, torch.exp(logits_capped - lse[..., None]), 0.0)
        dv = torch.einsum("bkgts,btkgh->bskh", p, dog)
        dp = torch.einsum("btkgh,bskh->bkgts", dog, vb)
        ds = p * (dp - delta[..., None])
        if softcap > 0:  # chain rule through the softcap tanh
            ds = ds * (1.0 - torch.tanh(tanh_arg) ** 2)
        dq = dq + sm * torch.einsum("bkgts,bskh->btkgh", ds, kb)
        dks.append(sm * torch.einsum("bkgts,btkgh->bskh", ds, qg))
        dvs.append(dv)
    dk = torch.cat(dks, dim=1)[:, :S]
    dv = torch.cat(dvs, dim=1)[:, :S]
    return dq.reshape(B, T, H, h).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_fa`` custom VJP: the forward saves
    (q, k, v, out, lse) as ``_fa_fwd`` does; the backward is ``_fa_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, softcap):
        out, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                          softcap=softcap, chunk=chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, chunk, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, chunk: int = 1024,
                   softcap: float = 0.0) -> torch.Tensor:
    """Online-softmax attention with a flash-attention backward that
    recomputes the probabilities per KV chunk (O(T * chunk) memory, not
    O(T * S)).  q: (B, T, H, h); k, v: (B, S, K, h) -> (B, T, H, h).
    ``chunk`` is the backward's KV chunk and the CPU forward's; the
    kernel's tile is its own."""
    return _FlashAttention.apply(q, k, v, causal, chunk, softcap)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             softcap: float = 0.0) -> torch.Tensor:
    """Causal local attention with window ``window``, blocked O(T * 2W):
    the reference's ``sliding_window_attention`` in plain PyTorch, with
    autograd for its gradient.

    Each query block of W = min(window, T) rows attends to a 2W key slab,
    its own block and the previous one (zeros before block 0), under the
    exact causal + window mask rel = w + W - s in [0, window); block 0
    forbids s < W.  q is scaled by h^-0.5 before the product, the logits
    are float32, and p is cast to v's dtype for PV.
    q: (B, T, H, h); k, v: (B, T, K, h) -> (B, T, H, h)."""
    B, T, H, h = q.shape
    K = k.shape[2]
    G = H // K
    W = min(window, T)
    nb = -(-T // W)
    pad = nb * W - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    qb = q.reshape(B, nb, W, H, h) * (h**-0.5)
    kb = k.reshape(B, nb, W, K, h)
    vb = v.reshape(B, nb, W, K, h)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)  # (B, nb, 2W, K, h)
    v2 = torch.cat([v_prev, vb], dim=2)
    qg = qb.reshape(B, nb, W, K, G, h)
    logits = torch.einsum("bnwkgh,bnskh->bnkgws", qg, k2).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    # query i = n W + w and key j = (n - 1) W + s: rel = i - j
    w_idx = torch.arange(W, device=q.device)[:, None]
    s_idx = torch.arange(2 * W, device=q.device)[None, :]
    rel = (w_idx + W) - s_idx
    mask = (rel >= 0) & (rel < window)
    first = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    mask = mask[None] & ~(first & (s_idx < W)[None])  # (nb, W, 2W)
    logits = torch.where(mask[None, :, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnkgws,bnskh->bnwkgh", p.to(v2.dtype), v2)
    out = out.reshape(B, nb * W, H, h)[:, :T]
    return out.to(q.dtype)


def chunk_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill attention: a (B, C, H, h) query chunk whose row-b
    queries sit at positions pos[b]..pos[b]+C-1, against a (B, S, K, h)
    cache that already holds the chunk's own K/V.  The mask
    s <= pos[b] + i gives causality against the prefix and within the
    chunk.  Global attention only (the serving path)."""
    B, C, H, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, C, K, G, h) * (h**-0.5)
    logits = torch.einsum("bckgh,bskh->bkgcs", qg, k_cache).float()
    q_pos = pos.reshape(-1, 1) + torch.arange(C, device=q.device)[None, :]
    q_pos = q_pos.expand(B, C)
    valid = torch.arange(S, device=q.device)[None, None, :] <= q_pos[..., None]
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, C, H, h).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos):
    """Write the new (B, 1, K, h) kv at position ``pos``: a Python int
    (the lockstep path; clamped into range like the reference's
    ``dynamic_update_slice``) or per-row (B,) int32 positions."""
    if isinstance(pos, int):
        s = min(max(pos, 0), k_cache.shape[1] - 1)
        k_cache[:, s:s + 1] = k.to(k_cache.dtype)
        v_cache[:, s:s + 1] = v.to(v_cache.dtype)
        return k_cache, v_cache
    return update_kv_cache_chunk(k_cache, v_cache, k, v, pos)


def update_kv_cache_chunk(k_cache: torch.Tensor, v_cache: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor):
    """Write a (B, C, K, h) chunk at per-row start positions ``pos`` (row
    b's token i lands at slot pos[b] + i).  Slots past the cache are
    dropped, never clamped: a padded prefill tail or an idle row parked at
    ``pos = max_seq`` must not clobber the cache tail (the reference's
    ``mode="drop"``).

    Without a boolean mask, which would read the mask back to the host:
    each row writes the W = min(C, S) slots of a window [w, w + W) that
    lies inside the cache and holds every in-range slot of its chunk
    (w = pos[b] clamped into [0, S - W]).  A window slot takes the chunk's
    token where the chunk reaches it and its own old value elsewhere, so
    every (row, slot) is written exactly once and no write races another."""
    B, C = k.shape[0], k.shape[1]
    S = k_cache.shape[1]
    W = min(C, S)
    pos = pos.reshape(-1, 1).expand(B, 1).long()
    slots = pos.clamp(0, S - W) + torch.arange(W, device=k.device)[None, :]
    i = slots - pos  # the chunk token that lands on each window slot
    take = ((i >= 0) & (i < C))[..., None, None]
    i = i.clamp(0, C - 1)[..., None, None].expand(B, W, *k.shape[2:])
    b_idx = torch.arange(B, device=k.device)[:, None]
    for cache, new in ((k_cache, k), (v_cache, v)):
        chunk = torch.gather(new.to(cache.dtype), 1, i)
        cache[b_idx, slots] = torch.where(take, chunk, cache[b_idx, slots])
    return k_cache, v_cache


def update_paged_kv_cache(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          block_tables: torch.Tensor, pos: torch.Tensor):
    """Write a (B, C, K, h) chunk into (P, bs, K, h) page pools through a
    (B, nb) block table at per-row start positions ``pos``.

    Logical position p = pos[b] + i lands on page block_tables[b, p // bs]
    at offset p % bs.  Positions past the table go to the reserved
    scratch page 0 at offset 0.  Those duplicate writes race, which is
    harmless only because the allocator never maps page 0 to a live row;
    live rows hold disjoint pages, so their writes never collide."""
    bs = k_pages.shape[1]
    B, C = k.shape[0], k.shape[1]
    nb = block_tables.shape[1]
    p_idx = pos.reshape(-1, 1) + torch.arange(C, device=k.device)[None, :]
    p_idx = p_idx.expand(B, C)
    in_range = p_idx < nb * bs
    blk = torch.clamp(p_idx // bs, max=nb - 1).long()
    phys = torch.gather(block_tables.long(), 1, blk)
    phys = torch.where(in_range, phys, 0)
    off = torch.where(in_range, p_idx % bs, 0).long()
    k_pages[phys, off] = k.to(k_pages.dtype)
    v_pages[phys, off] = v.to(v_pages.dtype)
    return k_pages, v_pages
