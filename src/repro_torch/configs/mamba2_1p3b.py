"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 attn-free, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, ssm heads = 4096/64 = 64.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    head_dim=1,  # unused (attn-free); nonzero to bypass d_model//H
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
    )
