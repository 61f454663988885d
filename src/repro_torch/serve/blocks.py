"""Paged-KV-cache bookkeeping: free-list page allocator + block tables.

The port's copy of ``repro/serve/blocks.py`` (numpy only; the port
imports nothing from the reference).

The device side is dumb on purpose: ``Model.init_paged_cache`` allocates
per-layer page pools ``(P, bs, K, h)`` and the kernels consume a single
shared ``(B, nb)`` int32 block table (the paged flash-decode kernel reads
it to address each page).  Everything stateful lives
here, on the host, in plain Python — the same host-control / device-data
split the Sebulba actors use.

Invariants the rest of the serving stack leans on:

  * **Page 0 is reserved scratch.**  It is never handed out, so an
    all-zero table row is "inactive", and out-of-range writes (padded
    prefill tails, idle decode rows) redirect to page 0 where nothing
    ever reads them back.
  * **Live rows hold disjoint pages** — allocation is exclusive, so the
    per-step scatter write never races between rows.
  * **Allocation is deterministic**: the free list is a LIFO stack, so
    the same admission/eviction sequence always yields the same physical
    page assignment (the paged-vs-dense bit-exactness tests rely on
    replayable layouts, including after reuse).
"""

from __future__ import annotations

import numpy as np


class CacheExhausted(Exception):
    """No free pages left — the scheduler's cue to preempt a request."""


class BlockAllocator:
    """LIFO free-list allocator over physical pages 1..num_blocks-1."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                "num_blocks must be >= 2: page 0 is reserved scratch"
            )
        self.num_blocks = num_blocks
        # stack ordered so the first pops hand out 1, 2, 3, ...
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise CacheExhausted("no free KV-cache pages")
        return self._free.pop()

    def release(self, block: int) -> None:
        if block == 0:
            raise ValueError("page 0 is reserved scratch, never allocated")
        self._free.append(block)


class RowTables:
    """Host-side ``(B, nb)`` block tables, one row per engine batch slot.

    ``ensure(row, through_pos)`` grows row's mapping until logical
    position ``through_pos`` is backed by a physical page; ``release``
    returns a row's pages to the free list (LIFO, newest first — so the
    next admission replays onto the just-freed pages, exercising reuse).
    """

    def __init__(self, batch_rows: int, blocks_per_row: int, block_size: int,
                 allocator: BlockAllocator):
        self.block_size = block_size
        self.blocks_per_row = blocks_per_row
        self.allocator = allocator
        self._tables = np.zeros((batch_rows, blocks_per_row), np.int32)
        self._counts = np.zeros((batch_rows,), np.int32)

    def ensure(self, row: int, through_pos: int) -> int:
        """Map row's logical blocks through ``through_pos``; returns how
        many pages were newly allocated.  Raises :class:`CacheExhausted`
        (after rolling back nothing — already-mapped pages stay mapped)
        when the pool runs dry mid-growth."""
        need = through_pos // self.block_size + 1
        if need > self.blocks_per_row:
            raise ValueError(
                f"position {through_pos} exceeds the per-row capacity "
                f"{self.blocks_per_row * self.block_size}"
            )
        added = 0
        while self._counts[row] < need:
            self._tables[row, self._counts[row]] = self.allocator.alloc()
            self._counts[row] += 1
            added += 1
        return added

    def release(self, row: int) -> None:
        for i in reversed(range(int(self._counts[row]))):
            self.allocator.release(int(self._tables[row, i]))
        self._tables[row] = 0
        self._counts[row] = 0

    def mapped_blocks(self, row: int) -> int:
        return int(self._counts[row])

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently mapped."""
        return self.allocator.used_blocks / (self.allocator.num_blocks - 1)

    def as_array(self) -> np.ndarray:
        """The (B, nb) int32 table to feed the jitted serve step."""
        return self._tables.copy()
