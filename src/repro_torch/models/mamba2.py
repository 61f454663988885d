"""Mamba-2 (SSD) block [arXiv:2405.21060]: the port of the training and
prefill forward of ``repro/models/mamba2.py``.

Block: RMSNorm -> fused in_proj to (z, x, B, C, dt) -> causal depthwise conv
over (x, B, C) -> SSD scan -> D skip -> gated RMSNorm -> out_proj.

The scan is ``kernels/ssd_scan`` (the Hopper kernel on the card, its plain
version on the CPU; the gradient is the reference's chunk VJP).  The
convolution is elementwise work that the reference leaves to XLA, so it is
plain PyTorch here, with the reference's arithmetic.  ``dt`` takes
``F.softplus``, whose linear branch above 20 differs from
``jax.nn.softplus`` by log1p(exp(-20)) ~ 2e-9, below float32 resolution
there.  The decode state and step (``init_mamba2_cache``,
``mamba2_decode_step``) are not ported yet (ROADMAP Queue 1 #10c).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import layers
from repro_torch.param import (ParamBuilder, constant_init, fan_in_init,
                               normal_init, zeros_init)

Params = Any


def conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba2_block(b: ParamBuilder, name: str, cfg: ArchConfig) -> None:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * N + H  # z, x, B, C, dt
    f32 = torch.float32
    with b.scope(name):
        layers.init_rms_norm(b, "norm", d)
        b.param("in_proj", (d, proj_out), fan_in_init())
        b.param("conv_w", (cfg.conv_width, conv_dim(cfg)), normal_init(0.1))
        b.param("conv_b", (conv_dim(cfg),), zeros_init(), dtype=f32)
        b.param("A_log", (H,), constant_init(0.0), dtype=f32)
        b.param("dt_bias", (H,), constant_init(0.5), dtype=f32)
        b.param("D", (H,), constant_init(1.0), dtype=f32)
        layers.init_rms_norm(b, "out_norm", di)
        b.param("out_proj", (di, d), fan_in_init())


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xc = proj[..., di:2 * di]
    Bm = proj[..., 2 * di:2 * di + N]
    Cm = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:2 * di + 2 * N + H]
    return z, xc, Bm, Cm, dt


def _causal_conv(params, u: torch.Tensor, width: int) -> torch.Tensor:
    """Depthwise causal conv along T.  u: (B, T, C).  The sum of ``width``
    shifted products in u's dtype, in the reference's order, then the bias
    cast to u's dtype, then SiLU."""
    T = u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = pad[:, 0:T] * params["conv_w"][0].to(u.dtype)
    for i in range(1, width):
        out = out + pad[:, i:i + T] * params["conv_w"][i].to(u.dtype)
    return F.silu(out + params["conv_b"].float().to(u.dtype))


def mamba2_block(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Train/prefill forward.  x: (B, T, D) -> (B, T, D)."""
    Bsz, T, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    h = layers.rms_norm(params["norm"], x, cfg.rms_norm_eps)
    proj = h @ params["in_proj"].to(h.dtype)
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out = _causal_conv(params, conv_in, cfg.conv_width)
    xc = conv_out[..., :cfg.d_inner]
    Bm = conv_out[..., cfg.d_inner:cfg.d_inner + cfg.ssm_state]
    Cm = conv_out[..., cfg.d_inner + cfg.ssm_state:]
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, T, H)
    A = -torch.exp(params["A_log"])  # (H,) negative decay
    xh = xc.reshape(Bsz, T, H, P)
    y, _ = ssd_scan(xh, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, T))
    y = y + params["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(Bsz, T, cfg.d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    y = layers.rms_norm(params["out_norm"], y, cfg.rms_norm_eps)
    return y @ params["out_proj"].to(y.dtype)
