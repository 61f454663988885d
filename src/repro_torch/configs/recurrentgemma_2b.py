"""recurrentgemma-2b — Griffin: RG-LRU + local attention 1:2 [arXiv:2402.19427].

26L d_model=2560 10H (GQA/MQA kv=1) d_ff=7680 vocab=256000, head_dim=256,
block pattern RRA (2 recurrent : 1 local-attention), lru width 2560,
local attention window 2048.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    sliding_window=2048,
    layer_pattern="RRA",
    rnn_width=2560,
    rnn_conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,  # one full RRA block
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
        rnn_width=256,
    )
