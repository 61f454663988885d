"""Decoder sublayers of the dense and hybrid families: the port of the
training forward, decode, prefill and layer-pattern parts of
``repro/models/transformer.py``.

The training forward (``attn_sublayer``) attends with
``attention.full_attention`` (its forward is ``kernels.flash_attention``),
or with ``attention.sliding_window_attention`` under a checkpoint for a
windowed layer, as the reference wraps it in ``jax.checkpoint``;
single-token decode goes through ``kernels.flash_decode`` (the Hopper
kernels for CUDA tensors, their plain versions for CPU tensors); chunked
prefill attends with ``attention.chunk_decode_attention``.  Cache updates
happen in place (see ``models/attention.py``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_decode import ref as flash_ref
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.param import ParamBuilder

Params = Any


def init_attn_layer(b: ParamBuilder, cfg: ArchConfig) -> None:
    dims = attn.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
    layers.init_rms_norm(b, "attn_norm", cfg.d_model)
    attn.init_attention(b, "attn", dims, qkv_bias=cfg.qkv_bias)


def init_ffn_layer(b: ParamBuilder, cfg: ArchConfig) -> None:
    layers.init_rms_norm(b, "ffn_norm", cfg.d_model)
    layers.init_mlp(b, "mlp", cfg.d_model, cfg.d_ff_dense or cfg.d_ff)


def attn_sublayer(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, *, window: int = 0,
                  theta: float | None = None,
                  causal: bool = True) -> torch.Tensor:
    """Pre-norm self-attention over a whole (B, T, D) sequence at
    ``positions`` (T,), residual added; causal local attention over
    ``window`` keys when ``window`` > 0."""
    h = layers.rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
    q, k, v = attn.qkv_project(
        p["attn"], h, positions=positions if cfg.pos_embed == "rope" else None,
        rope_theta=theta if theta is not None else cfg.rope_theta,
    )
    if window:
        # blocked local attention materialises O(T * 2W) probabilities;
        # checkpoint so they are recomputed (transiently) in backward
        out = checkpoint(attn.sliding_window_attention, q, k, v,
                         window=window, softcap=cfg.attn_logit_softcap,
                         use_reentrant=False)
    else:
        out = attn.full_attention(q, k, v, causal=causal,
                                  softcap=cfg.attn_logit_softcap)
    return x + attn.output_project(p["attn"], out)


def _rope_positions(pos, width: int, device: torch.device) -> torch.Tensor:
    """Decode-time rope positions: scalar pos -> (1, width) lockstep row;
    per-row (B,) pos -> (B, width), row b at pos[b]..pos[b]+width-1."""
    pos = torch.as_tensor(pos, device=device)
    base = pos.reshape(1, 1) if pos.ndim == 0 else pos[:, None]
    if width == 1:
        return base
    return base + torch.arange(width, device=device)[None, :]


def attn_sublayer_decode(p: Params, cache: dict, x: torch.Tensor, pos,
                         cfg: ArchConfig, *, window: int = 0,
                         theta: float | None = None,
                         block_tables: torch.Tensor | None = None):
    """One-token decode.  cache: {"k": (B,S,K,h), "v": ...} dense, or
    {"k": (P,bs,K,h), "v": ...} page pools when ``block_tables`` is given.
    ``pos`` is an int (lockstep) or a (B,) vector of per-row positions."""
    h = layers.rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
    q, k, v = attn.qkv_project(
        p["attn"], h, positions=_rope_positions(pos, 1, x.device),
        rope_theta=theta if theta is not None else cfg.rope_theta,
    )
    if block_tables is not None:
        if window:
            raise ValueError("paged decode supports global attention only; "
                             "sliding-window layers keep the dense cache")
        pos = torch.as_tensor(pos, device=x.device)
        kc, vc = attn.update_paged_kv_cache(cache["k"], cache["v"], k, v,
                                            block_tables, pos)
        out = flash_decode(q, kc, vc, pos, block_tables=block_tables)
    else:
        if window and cache["k"].shape[1] == window:
            raise ValueError("ring-buffer window caches are not ported")
        kc, vc = attn.update_kv_cache(cache["k"], cache["v"], k, v, pos)
        out = flash_decode(q, kc, vc, pos, window=window)
    return x + attn.output_project(p["attn"], out), {"k": kc, "v": vc}


def attn_sublayer_prefill(p: Params, cache: dict, x: torch.Tensor,
                          pos: torch.Tensor, cfg: ArchConfig, *,
                          block_tables: torch.Tensor | None = None):
    """Chunked prefill: a (B, C, D) chunk whose row-b tokens sit at
    positions pos[b]..pos[b]+C-1.  The chunk's K/V is written first, then
    the chunk attends to the whole cache under the per-row position mask,
    so this is C fused copies of ``attn_sublayer_decode``.  Rows past
    their prompt write out of range and are dropped (dense) or land on the
    scratch page (paged)."""
    C = x.shape[1]
    h = layers.rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
    q, k, v = attn.qkv_project(
        p["attn"], h, positions=_rope_positions(pos, C, x.device),
        rope_theta=cfg.rope_theta,
    )
    if block_tables is not None:
        kc, vc = attn.update_paged_kv_cache(cache["k"], cache["v"], k, v,
                                            block_tables, pos)
        out = attn.chunk_decode_attention(
            q, flash_ref.gather_pages(kc, block_tables),
            flash_ref.gather_pages(vc, block_tables), pos,
        )
    else:
        kc, vc = attn.update_kv_cache_chunk(cache["k"], cache["v"], k, v, pos)
        out = attn.chunk_decode_attention(q, kc, vc, pos)
    return x + attn.output_project(p["attn"], out), {"k": kc, "v": vc}


def ffn_sublayer(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = layers.rms_norm(p["ffn_norm"], x, cfg.rms_norm_eps)
    return x + layers.mlp(p["mlp"], h)


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Expand cfg.layer_pattern cyclically over num_layers."""
    pat = cfg.layer_pattern or "G"
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def local_params(cfg: ArchConfig, kind: str) -> tuple[int, float]:
    """(window, rope_theta) for an attention layer of the given kind."""
    if kind == "L" or kind == "A":
        # local layers use the short rope theta (gemma3: 10k local / 1M global)
        return cfg.sliding_window, 10_000.0 if kind == "L" else cfg.rope_theta
    return 0, cfg.rope_theta


def is_uniform(cfg: ArchConfig) -> bool:
    kinds = set(layer_kinds(cfg))
    return len(kinds) == 1 and cfg.cross_attn_every == 0
