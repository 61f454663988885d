"""Serve-step factories and seeded sampling: the port of ``sample_tokens``,
``request_keys`` and ``make_serve_step`` from ``repro/launch/steps.py``.

Sampling keys are counter-based: ``request_keys`` hashes
``(seed, request id, token index)`` into one 32-bit key per row, and
``sample_tokens`` hashes ``(key, vocab index)`` into uniform noise for a
Gumbel-max draw.  Everything runs as tensor arithmetic on the logits'
device, with no host round trip and no generator state, so a request's
tokens depend on ``(logits, seed, rid, token index)`` only: not on its
row, the batch around it, or the cache layout.  The reference keys on
threefry ``fold_in``, which torch cannot reproduce, so the two packages
agree on sampled tokens only at temperature 0 (greedy).
"""

from __future__ import annotations

from typing import Callable

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in
    [0, 2^32).  Both multipliers are below 2^31, so no product overflows
    int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def request_keys(seed: int, rids: torch.Tensor,
                 tok_idx: torch.Tensor) -> torch.Tensor:
    """Per-row sampling keys (B,) int64 from request ids and per-request
    token indices."""
    base = _mix32(torch.full_like(rids, (seed ^ 0x5BD1E995) & _M32,
                                  dtype=torch.int64))
    keys = _mix32(base ^ (rids.long() & _M32))
    return _mix32(keys ^ (tok_idx.long() & _M32))


def _gumbel(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,) keys -> (B, V) float32 Gumbel noise, a function of
    (key, vocab index) only."""
    v = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    bits = _mix32(keys[:, None] ^ _mix32(v + 0x3C6EF372)[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Seeded sampling from (B, V) logits with one key per row -> (B,)
    int32.  ``temperature <= 0`` is greedy argmax (the first maximum on a
    tie, as in the reference).  ``top_k > 0`` keeps the logits >= the
    k-th largest before the draw."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).int()
    scaled = logits.float() / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    noisy = scaled + _gumbel(keys, logits.shape[-1])
    return torch.argmax(noisy, dim=-1).int()


def make_serve_step(model, temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0) -> Callable:
    """Serve-loop decode step.  Greedy by default, with the 4-argument
    signature; with ``temperature > 0`` the step also takes per-row
    ``(rids, tok_idx)`` and draws from the per-request streams."""

    if temperature <= 0.0:
        @torch.no_grad()
        def serve_step(params, cache, tokens, pos):
            """One decode step: (B, 1) token -> next (B, 1) token (greedy)."""
            logits, _values, cache = model.decode_step(params, cache, tokens,
                                                       pos)
            return torch.argmax(logits, dim=-1).int(), cache

        return serve_step

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos, rids, tok_idx):
        """One sampled decode step: (B, 1) token -> next (B, 1) token."""
        logits, _values, cache = model.decode_step(params, cache, tokens, pos)
        nxt = sample_tokens(logits[:, 0], request_keys(seed, rids, tok_idx),
                            temperature=temperature, top_k=top_k)
        return nxt[:, None], cache

    return serve_step
