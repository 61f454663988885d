"""Continuous-batching request scheduler (sarathi-style).

The port's copy of ``repro/serve/scheduler.py`` (numpy only; the port
imports nothing from the reference).

The scheduler is pure host-side bookkeeping over a fixed grid of ``B``
engine rows: it admits requests from a queue into free rows, splits a
fixed per-step **token budget** between decode (one token per active
row, priority) and chunked prefill (whatever budget remains, in fixed
``(B, C)``-shaped chunks so the jitted step never recompiles), evicts
finished rows, and — when the paged cache runs dry — preempts the
YOUNGEST active request (recompute-on-restart: its state resets and it
re-enters at the FRONT of the queue, so completed work is never starved
by a late arrival).

Admission order is deterministic: FIFO by default, or a seeded
pseudo-random permutation (``shuffle_admissions``) keyed on
``(seed, request id)`` via crc32 — stable across processes, unlike
``hash()``.  Combined with per-request sampling streams keyed the same
way (engine), a request's output tokens are a function of
``(params, prompt, seed, rid)`` only — not of what else is in flight.

Position convention (the engine's contract with the model):

  * prompt tokens occupy cache slots ``0..L-1``;
  * prefill of the chunk covering slot ``L-1`` yields the logits that
    sample generated token 1 (the TTFT token);
  * generated token ``g`` is decoded by feeding token ``g-1``'s id at
    position ``L+g-2`` — so a finished request of ``max_new`` tokens has
    written slots ``0..L+max_new-2``.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``arrival`` is the engine step index at
    which the request becomes visible to admission (0 = immediately) —
    staggered arrivals in tests and benchmarks without wall-clock."""

    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival: int = 0

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine + scheduler knobs.  ``token_budget`` caps tokens processed
    per step (decode rows first, leftover to prefill — sarathi's chunked
    interleaving).  ``max_seq`` is the per-row logical capacity; in paged
    mode it must equal ``blocks_per_row * block_size`` and ``num_blocks``
    counts the physical pool INCLUDING the reserved scratch page 0."""

    batch_rows: int = 4
    prefill_chunk: int = 8
    token_budget: int = 12
    block_size: int = 8
    num_blocks: int = 17
    max_seq: int = 64
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    shuffle_admissions: bool = False

    @property
    def blocks_per_row(self) -> int:
        if self.max_seq % self.block_size:
            raise ValueError("max_seq must be a multiple of block_size")
        return self.max_seq // self.block_size

    def validate(self) -> None:
        if self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        _ = self.blocks_per_row


@dataclasses.dataclass
class _RowState:
    rid: int
    prompt: list[int]
    max_new: int
    admit_seq: int          # monotonic admission stamp (youngest = max)
    prefilled: int = 0      # prompt tokens written to cache so far
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def in_decode(self) -> bool:
        return self.prefilled == len(self.prompt) and self.generated

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


@dataclasses.dataclass
class StepPlan:
    """One engine iteration, as fixed-shape arrays (B rows, C-wide
    chunks).  Idle rows carry ``pos = max_seq`` so their writes drop
    (dense) or land on the scratch page (paged) — see models/attention."""

    # prefill dispatch ((B, C); skipped when no row prefills this step)
    prefill_rows: list[int]
    prefill_tokens: np.ndarray
    prefill_pos: np.ndarray
    prefill_len: np.ndarray          # real tokens per row in this chunk
    finish_rows: list[int]           # rows whose prefill completes now
    # decode dispatch ((B, 1); skipped when no row is in decode phase)
    decode_rows: list[int]
    decode_tokens: np.ndarray
    decode_pos: np.ndarray
    rids: np.ndarray                 # (B,) request ids (0 for idle rows)
    tok_idx: np.ndarray              # (B,) per-request token indices


class Scheduler:
    def __init__(self, cfg: ServeConfig):
        cfg.validate()
        self.cfg = cfg
        self._queue: deque[Request] = deque()      # normal arrivals
        self._requeued: deque[Request] = deque()   # preempted, front-of-line
        self.active: dict[int, _RowState] = {}
        self._free_rows = list(range(cfg.batch_rows - 1, -1, -1))
        self._admit_seq = 0
        # counters surfaced through make_serve_result
        self.admitted = 0
        self.preempted = 0
        self.completed: dict[int, list[int]] = {}

    # -------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        slots = len(req.prompt) + req.max_new_tokens - 1
        if slots > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid} needs {slots} cache slots; "
                f"max_seq is {self.cfg.max_seq}"
            )
        self._queue.append(req)

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._requeued)

    @property
    def idle(self) -> bool:
        return not self.active and not self.pending

    # ----------------------------------------------------------- admission

    def _admission_order(self, eligible: list[Request]) -> list[Request]:
        if not self.cfg.shuffle_admissions:
            return eligible
        return sorted(
            eligible,
            key=lambda r: zlib.crc32(f"{self.cfg.seed}:{r.rid}".encode()),
        )

    def admit(self, now: int) -> list[int]:
        """Move eligible requests into free rows.  Preempted requests go
        first (front-of-line, FIFO among themselves); fresh arrivals
        follow in FIFO or seeded order.  Returns admitted rids."""
        admitted = []
        while self._free_rows and self._requeued:
            admitted.append(self._place(self._requeued.popleft()))
        eligible = [r for r in self._queue if r.arrival <= now]
        for req in self._admission_order(eligible):
            if not self._free_rows:
                break
            self._queue.remove(req)
            admitted.append(self._place(req))
        return admitted

    def _place(self, req: Request) -> int:
        row = self._free_rows.pop()
        self.active[row] = _RowState(
            rid=req.rid, prompt=list(req.prompt),
            max_new=req.max_new_tokens, admit_seq=self._admit_seq,
        )
        self._admit_seq += 1
        self.admitted += 1
        return req.rid

    # ---------------------------------------------------------- preemption

    def preempt_youngest(self) -> tuple[int, int] | None:
        """Evict the most recently admitted active request, dropping its
        progress (recompute-on-restart — its per-request sampling streams
        make the rerun produce identical tokens) and requeueing it at the
        front.  Returns ``(row, rid)`` — the engine releases the row's
        pages — or None when nothing can yield."""
        if not self.active:
            return None
        row = max(self.active, key=lambda r: self.active[r].admit_seq)
        st = self.active.pop(row)
        self._free_rows.append(row)
        self._requeued.appendleft(Request(
            rid=st.rid, prompt=tuple(st.prompt),
            max_new_tokens=st.max_new, arrival=0,
        ))
        self.preempted += 1
        return row, st.rid

    # ------------------------------------------------------------ planning

    def plan_step(self) -> StepPlan:
        cfg = self.cfg
        B, C = cfg.batch_rows, cfg.prefill_chunk
        idle_pos = cfg.max_seq  # out-of-range: writes drop / hit scratch
        plan = StepPlan(
            prefill_rows=[], finish_rows=[], decode_rows=[],
            prefill_tokens=np.zeros((B, C), np.int32),
            prefill_pos=np.full((B,), idle_pos, np.int32),
            prefill_len=np.zeros((B,), np.int32),
            decode_tokens=np.zeros((B, 1), np.int32),
            decode_pos=np.full((B,), idle_pos, np.int32),
            rids=np.zeros((B,), np.int32),
            tok_idx=np.zeros((B,), np.int32),
        )
        decode_rows = [r for r, st in sorted(self.active.items())
                       if st.in_decode]
        budget = cfg.token_budget - len(decode_rows)
        for row, st in sorted(self.active.items()):
            plan.rids[row] = st.rid
            if st.in_decode:
                plan.decode_rows.append(row)
                g = len(st.generated)
                plan.decode_tokens[row, 0] = st.generated[-1]
                plan.decode_pos[row] = len(st.prompt) + g - 1
                plan.tok_idx[row] = g  # sampling token g+1
            elif st.prefilled < len(st.prompt) and budget > 0:
                n = min(C, len(st.prompt) - st.prefilled, budget)
                budget -= n
                chunk = st.prompt[st.prefilled:st.prefilled + n]
                plan.prefill_rows.append(row)
                plan.prefill_tokens[row, :n] = chunk
                plan.prefill_pos[row] = st.prefilled
                plan.prefill_len[row] = n
                if st.prefilled + n == len(st.prompt):
                    plan.finish_rows.append(row)
                    plan.tok_idx[row] = 0  # sampling token 1 (TTFT)
        return plan

    # ------------------------------------------------------------- results

    def record_prefill(self, plan: StepPlan,
                       sampled: np.ndarray) -> list[int]:
        """Advance prefill progress; rows in ``finish_rows`` bank their
        first generated token from ``sampled`` (B,).  Returns those rows
        (the engine stamps TTFT on them)."""
        for row in plan.prefill_rows:
            self.active[row].prefilled += int(plan.prefill_len[row])
        for row in plan.finish_rows:
            self.active[row].generated.append(int(sampled[row]))
        return list(plan.finish_rows)

    def record_decode(self, plan: StepPlan, sampled: np.ndarray) -> None:
        for row in plan.decode_rows:
            self.active[row].generated.append(int(sampled[row]))

    def evict_finished(self) -> list[int]:
        """Retire rows whose generation is complete; returns their row
        indices (the engine releases their pages)."""
        rows = [r for r, st in sorted(self.active.items()) if st.done]
        for row in rows:
            st = self.active.pop(row)
            self.completed[st.rid] = list(st.generated)
            self._free_rows.append(row)
        return rows
