"""Architecture configuration: the port's copy of ``repro/configs/base.py``
(``ArchConfig``, ``ALIASES``, ``get_config``, ``get_reduced_config``).

Torch-free.  Each ported architecture lives in
``repro_torch/configs/<id>.py`` and exports ``CONFIG`` (the published
hyper-parameters, source cited there) and ``reduced()`` for CPU tests.
``get_config`` raises ``KeyError`` for an architecture the port has no
config module for yet.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity -------------------------------------------------------------
    name: str
    family: Family
    source: str  # citation: arXiv id or HF model card

    # trunk ------------------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention options ------------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 -> full attention
    # layer pattern: e.g. gemma3 "LLLLLG" (5 local : 1 global), griffin "RRA".
    # One char per pattern element: L=local attn, G=global attn, R=recurrent,
    # A=(local) attn, X=cross-attn insert, S=self-attn, M=moe, D=dense-ff.
    layer_pattern: str = ""
    attn_logit_softcap: float = 0.0

    # MoE --------------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    d_ff_dense: int = 0  # deepseek: dense FFN width for 'D' pattern layers

    # SSM (mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (griffin/recurrentgemma) -----------------------------------------
    rnn_width: int = 0  # lru width; 0 -> d_model
    rnn_conv_width: int = 4

    # multimodal ---------------------------------------------------------------
    cross_attn_every: int = 0  # vlm: insert a cross-attn layer every N layers
    num_image_tokens: int = 0  # vlm: patch embeddings per image
    num_audio_frames: int = 0  # audio: encoder frames
    encoder_layers: int = 0  # audio: encoder depth (decoder = num_layers)

    # positions: "rope" (default) or "learned" (whisper)
    pos_embed: str = "rope"
    max_position: int = 0  # learned pos table size; 0 -> unused

    # training ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"  # KV-cache dtype; fp8 = quantized serving
    tie_embeddings: bool = True
    rms_norm_eps: float = 1e-6
    # remat: "none" | "layer" | "full"; microbatches: grad-accumulation steps
    remat: str = "layer"
    microbatches: int = 1
    # sharding rule set: "default" | "fsdp"
    sharding_rules: str = "default"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count of a dense, ssm or hybrid model
        (embedding + trunk), as the reference approximates it: a hybrid
        layer counts as an attention layer, the RG-LRU block standing in
        for attention at a similar size."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd, H, K = self.head_dim, self.num_heads, self.num_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, s = self.d_inner, self.ssm_state
            # in_proj (2*di + 2*groups*s + heads), conv, dt, out_proj
            return emb + L * (d * (2 * di + 2 * s + self.ssm_heads)
                              + di * d + 3 * di)
        attn = d * H * hd + 2 * d * K * hd + H * hd * d
        return emb + L * (attn + 3 * d * self.d_ff)


ARCH_IDS = [
    "mamba2_1p3b",
    "gemma3_4b",
    "recurrentgemma_2b",
    "granite_moe_1b",
    "llama3_405b",
    "deepseek_moe_16b",
    "qwen2_1p5b",
    "llama32_vision_11b",
    "whisper_medium",
    "qwen3_4b",
]

# CLI aliases matching the reference's table exactly.
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "gemma3-4b": "gemma3_4b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "llama3-405b": "llama3_405b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-1.5b": "qwen2_1p5b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-medium": "whisper_medium",
    "qwen3-4b": "qwen3_4b",
}


def _config_module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    try:
        return importlib.import_module(f"repro_torch.configs.{arch}")
    except ModuleNotFoundError as e:
        if e.name != f"repro_torch.configs.{arch}":
            raise
        raise KeyError(f"arch {arch!r} is not ported yet") from None


def get_config(arch: str) -> ArchConfig:
    return _config_module(arch).CONFIG


def get_reduced_config(arch: str) -> ArchConfig:
    return _config_module(arch).reduced()
