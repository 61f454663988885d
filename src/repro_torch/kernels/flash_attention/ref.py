"""Plain PyTorch versions of GQA flash attention: the port of
``repro/kernels/flash_attention/ref.py`` (``attention_ref``, the naive
full softmax) and of the chunked online-softmax forward ``_fa_forward``
of ``repro/models/attention.py`` (``flash_attention_ref``).

q: (B, T, H, h); k, v: (B, S, K, h), H = K * G: query head ``kh * G + g``
reads kv head ``kh``.  Query row t sits at position t and key row s at
position s; ``causal`` keeps s <= t and ``window`` > 0 keeps s > t - window.
Masked logits are set to -1e30, as in the reference.

Both follow the Pallas kernel's arithmetic: q, k and v are upcast to
float32 and q is scaled by h**-0.5 in float32 before the products
(``_fa_forward`` scales q and takes the logits product in the input
dtype; in float32 the two agree).  ``flash_attention_ref`` is what the
Hopper kernel computes and what it is held against on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _valid(q_pos: torch.Tensor, k_pos: torch.Tensor, S: int, causal: bool,
           window: int) -> torch.Tensor:
    """(T, n) mask of the keys each query row may read."""
    valid = (k_pos < S)[None, :].expand(q_pos.shape[0], -1)
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    return valid


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive attention: the whole (T, S) logits matrix at once."""
    B, T, H, h = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, K, H // K, h).float() * (h**-0.5)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k.float())
    ar = torch.arange(max(T, S), device=q.device)
    mask = _valid(ar[:T], ar[:S], S, causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return out.reshape(B, T, H, h).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, chunk: int = 1024):
    """Online softmax over KV chunks of ``chunk`` rows -> (out (B, T, H, h)
    in q's dtype, lse (B, H, T) float32).

    As ``_fa_forward``: S is padded with zero rows to a whole number of
    chunks and the padded keys are masked; the running max starts at
    -inf; ``softcap`` > 0 maps each logit x to softcap * tanh(x / softcap)
    before the mask; l is clamped to 1e-30 before out = acc / l and
    lse = m + log(l).  lse (B, H, T) is the reference's (B, K, G, T) in
    the same memory."""
    B, T, H, h = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, T, K, G, h).float() * (h**-0.5)
    q_pos = torch.arange(T, device=q.device)
    m = torch.full((B, K, G, T), -torch.inf, device=q.device)
    l = torch.zeros((B, K, G, T), device=q.device)
    acc = torch.zeros((B, K, G, T, h), device=q.device)
    for i in range(n_chunks):
        kb = k[:, i * chunk:(i + 1) * chunk].float()
        vb = v[:, i * chunk:(i + 1) * chunk].float()
        logits = torch.einsum("btkgh,bskh->bkgts", qg, kb)
        if softcap > 0:
            logits = softcap * torch.tanh(logits / softcap)
        k_pos = i * chunk + torch.arange(chunk, device=q.device)
        logits = torch.where(_valid(q_pos, k_pos, S, causal, window),
                             logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgts,bskh->bkgth", p, vb)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
    lse = m + torch.log(l_safe)
    return out.reshape(B, T, H, h).to(q.dtype), lse.reshape(B, H, T)
