"""Griffin / RecurrentGemma recurrent block [arXiv:2402.19427]: the port of
the training forward of ``repro/models/griffin.py``.

Recurrent block: RMSNorm -> two branches
  (1) linear d->W, causal depthwise conv(4), RG-LRU
  (2) linear d->W, GeLU (the tanh form: ``jax.nn.gelu``'s default)
  merged multiplicatively -> linear W->d.

RG-LRU: r_t = sigmoid(W_a x_t + b_a); i_t = sigmoid(W_x x_t + b_x);
        a_t = exp(-c * softplus(Lambda) * r_t)  with c = 8;
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).

The gates run in float32 and stay float32, while the conv output x stays
in the param dtype, so the scan (``kernels/rglru_scan``: the Hopper kernel
on the card, its plain version on the CPU, the reference's backward) takes
that mix.  The convolution is a sum of shifted products in x's dtype, in
the reference's order, not ``F.conv1d``, which sums in another.  The
decode state and step (``init_recurrent_cache``, ``recurrent_decode_step``,
the ring-buffer KV cache) are not ported yet (ROADMAP Queue 1 #10c).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models import layers
from repro_torch.param import (ParamBuilder, constant_init, fan_in_init,
                               normal_init, zeros_init)

RGLRU_C = 8.0


def init_recurrent_block(b: ParamBuilder, name: str, cfg: ArchConfig) -> None:
    d, W = cfg.d_model, cfg.rnn_width
    f32 = torch.float32
    with b.scope(name):
        layers.init_rms_norm(b, "norm", d)
        b.param("w_branch1", (d, W), fan_in_init())
        b.param("w_branch2", (d, W), fan_in_init())
        b.param("conv_w", (cfg.rnn_conv_width, W), normal_init(0.1))
        b.param("conv_b", (W,), zeros_init(), dtype=f32)
        # RG-LRU gates
        b.param("w_a", (W, W), fan_in_init())
        b.param("b_a", (W,), zeros_init(), dtype=f32)
        b.param("w_x", (W, W), fan_in_init())
        b.param("b_x", (W,), zeros_init(), dtype=f32)
        # Lambda init so that a^(1/c) ~ U[0.9, 0.999] as in the paper
        b.param("lam", (W,), constant_init(0.7), dtype=f32)
        b.param("w_out", (W, d), fan_in_init())


def _rglru_gates(params, u: torch.Tensor):
    """u: (..., W) conv output.  Returns (a, i) gates, float32.  The
    softplus is ``log(exp(lam) + 1)`` as ``jax.nn.softplus`` computes it."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"].float() + params["b_a"])
    gi = torch.sigmoid(uf @ params["w_x"].float() + params["b_x"])
    lam = params["lam"]
    log_a = -RGLRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    return torch.exp(log_a), gi


def _conv1d(params, u: torch.Tensor, width: int) -> torch.Tensor:
    """Depthwise causal conv along T.  u: (B, T, W).  The sum of ``width``
    shifted products in u's dtype, in the reference's order, then the
    bias cast to u's dtype."""
    T = u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = pad[:, 0:T] * params["conv_w"][0].to(u.dtype)
    for i in range(1, width):
        out = out + pad[:, i:i + T] * params["conv_w"][i].to(u.dtype)
    return out + params["conv_b"].to(u.dtype)


def recurrent_block(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D)."""
    h = layers.rms_norm(params["norm"], x, cfg.rms_norm_eps)
    u = h @ params["w_branch1"].to(h.dtype)  # (B, T, W)
    g = F.gelu((h @ params["w_branch2"].to(h.dtype)).float(),
               approximate="tanh").to(h.dtype)
    u = _conv1d(params, u, cfg.rnn_conv_width)
    a, gi = _rglru_gates(params, u)
    y, _ = rglru_scan(u, a, gi)
    y = y.to(h.dtype) * g
    return y @ params["w_out"].to(y.dtype)
