"""Continuous-batching LM serving, ported from ``repro/serve``: the paged
KV cache bookkeeping (``blocks``), the sarathi-style scheduler
(``scheduler``) and ``ServeEngine`` (``engine``)."""

from repro_torch.serve.blocks import BlockAllocator, CacheExhausted, RowTables
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request, Scheduler, ServeConfig

__all__ = [
    "BlockAllocator",
    "CacheExhausted",
    "Request",
    "RowTables",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
]
