"""Shared building blocks: the port of ``repro/models/layers.py``.

Same conventions as the reference: params are nested dicts of tensors,
activations compute in the parameter dtype, and reductions (norms,
softmax, RoPE angles, the SwiGLU gate) in float32 before the cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.param import ParamBuilder, normal_init, ones_init

NEG_INF = -1e30


def init_rms_norm(b: ParamBuilder, name: str, dim: int) -> None:
    with b.scope(name):
        b.param("scale", (dim,), ones_init(), dtype=torch.float32)


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., T, h/2)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, h/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(b: ParamBuilder, name: str, vocab: int, dim: int,
                   tie: bool) -> None:
    with b.scope(name):
        b.param("table", (vocab, dim), normal_init(0.02))
        if not tie:
            b.param("unembed", (dim, vocab), normal_init(0.02))


def embed(params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token ids must lie in [0, vocab): unlike ``jnp.take``, indexing
    raises on an id out of range instead of clamping it."""
    return params["table"][tokens].to(dtype)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Returns float32 logits (B, T, V)."""
    if "unembed" in params:
        return (x @ params["unembed"].to(x.dtype)).float()
    return (x @ params["table"].to(x.dtype).T).float()


def init_mlp(b: ParamBuilder, name: str, d_model: int, d_ff: int) -> None:
    with b.scope(name):
        b.param("w_gate", (d_model, d_ff))
        b.param("w_up", (d_model, d_ff))
        b.param("w_down", (d_ff, d_model))


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_up"].to(dt)
    hidden = F.silu(gate.float()).to(dt) * up
    return hidden @ params["w_down"].to(dt)
