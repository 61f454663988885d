"""qwen2-1.5b — GQA with QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, head_dim=128,
QKV bias, rope theta 1e6.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
