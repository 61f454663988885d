"""ServeEngine: the continuous-batching serving loop, ported from
``repro/serve/engine.py``.

One engine iteration is a handful of eager calls at fixed shapes: paged
mode runs one ``(1, C)`` chunked-prefill call per prefilling ROW (the page
pools have no batch dimension, so prefill cost tracks real tokens instead
of billing every idle row) plus an optional ``(B, 1)`` decode step; dense
mode keeps a single ``(B, C)`` prefill call.  Each call is model step +
sampling + an in-place cache update.  Rows not taking part in a call
carry ``pos = max_seq``: their writes drop (dense) or land on the reserved
scratch page (paged), and their outputs are ignored.

Sampling is keyed per REQUEST, not per step (``launch/steps.py``): a
request's token stream is independent of scheduling, batch composition,
row assignment and cache layout, so paged and dense generation agree and
preemption's recompute-on-restart reproduces the same tokens.

Latency accounting: TTFT runs from the moment a request becomes eligible
(its ``arrival`` step reached) to its first sampled token; TPOT is the
mean inter-token time over the remaining tokens.  Each sampled token is
copied to the host before it is recorded, so the host clock sees device
work done.  Results use the ``make_serve_result`` schema.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.api.runner import make_serve_result
from repro_torch.device import resolve_device
from repro_torch.launch.steps import request_keys, sample_tokens
from repro_torch.serve.blocks import BlockAllocator, CacheExhausted, RowTables
from repro_torch.serve.scheduler import Request, Scheduler, ServeConfig

Params = Any


class ServeEngine:
    """Continuous-batching engine over a dense or paged KV cache.

    ``paged=True`` (default) runs the block-table path over the page pools
    from ``Model.init_paged_cache``; ``paged=False`` runs the same
    scheduler over a plain ``(B, max_seq)`` dense cache, the equivalence
    baseline.  The model and its cache live on ``device`` (default: the
    card; CPU only when asked for)."""

    def __init__(self, model, params: Params, cfg: ServeConfig,
                 paged: bool = True, device: str | torch.device | None = None):
        cfg.validate()
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.paged = paged
        self.reset()

    # -------------------------------------------------------------- steps

    @torch.no_grad()
    def _decode(self, tokens, pos, tables, rids, tok_idx) -> torch.Tensor:
        logits, _values, self.cache = self.model.decode_step(
            self.params, self.cache, tokens, pos, tables
        )
        return self._sample(logits[:, 0], rids, tok_idx)

    @torch.no_grad()
    def _prefill(self, tokens, pos, lens, tables, rids,
                 tok_idx) -> torch.Tensor:
        logits, _values, self.cache = self.model.prefill_step(
            self.params, self.cache, tokens, pos, tables
        )
        # the logits of each row's LAST real chunk token sample the first
        # generated token (rows not finishing ignore theirs)
        last = torch.clamp(lens.long() - 1, min=0)
        lg = logits[torch.arange(logits.shape[0], device=logits.device), last]
        return self._sample(lg, rids, tok_idx)

    def _sample(self, logits, rids, tok_idx) -> torch.Tensor:
        cfg = self.cfg
        return sample_tokens(logits, request_keys(cfg.seed, rids, tok_idx),
                             temperature=cfg.temperature, top_k=cfg.top_k)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -------------------------------------------------------------- state

    def reset(self) -> None:
        """Fresh serving state: cache zeroed, queue and counters cleared."""
        cfg = self.cfg
        if self.paged:
            self.cache = self.model.init_paged_cache(
                cfg.num_blocks, cfg.block_size, device=self.device
            )
            self.allocator = BlockAllocator(cfg.num_blocks)
            self.tables = RowTables(cfg.batch_rows, cfg.blocks_per_row,
                                    cfg.block_size, self.allocator)
        else:
            self.cache = self.model.init_cache(cfg.batch_rows, cfg.max_seq,
                                               device=self.device)
            self.allocator = None
            self.tables = None
        self.scheduler = Scheduler(cfg)
        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self.queue_depth_peak = 0
        self._occupancy: list[float] = []
        self._eligible_t: dict[int, float] = {}
        self._first_t: dict[int, float] = {}
        self._finish_t: dict[int, float] = {}
        self._gen_counts: dict[int, int] = {}

    # -------------------------------------------------------------- serve

    def submit(self, req: Request) -> None:
        if self.paged:
            need = (len(req.prompt) + req.max_new_tokens - 2) \
                // self.cfg.block_size + 1
            if need > self.cfg.num_blocks - 1:
                raise ValueError(
                    f"request {req.rid} needs {need} pages; the pool has "
                    f"{self.cfg.num_blocks - 1} allocatable"
                )
        self.scheduler.submit(req)

    def _ensure_pages(self, plan) -> None:
        for row in plan.prefill_rows:
            through = int(plan.prefill_pos[row] + plan.prefill_len[row]) - 1
            self.tables.ensure(row, through)
        for row in plan.decode_rows:
            self.tables.ensure(row, int(plan.decode_pos[row]))

    def _plan_with_preemption(self):
        """Plan the step; on cache exhaustion preempt the youngest active
        request (releasing its pages) and replan.  A lone request always
        fits (checked at submit), so this terminates."""
        while True:
            plan = self.scheduler.plan_step()
            if not self.paged:
                return plan
            try:
                self._ensure_pages(plan)
                return plan
            except CacheExhausted:
                victim = self.scheduler.preempt_youngest()
                if victim is None:
                    raise
                self.tables.release(victim[0])

    def step(self) -> None:
        """One engine iteration: admit -> plan (preempting under cache
        pressure) -> prefill call(s) + at most one decode call -> evict
        finished rows."""
        now = self.steps
        t_now = time.monotonic()
        for req in list(self.scheduler._queue):
            if req.arrival <= now:
                self._eligible_t.setdefault(req.rid, t_now)
        self.scheduler.admit(now)
        self.queue_depth_peak = max(self.queue_depth_peak,
                                    self.scheduler.pending)
        plan = self._plan_with_preemption()
        tables = self._tensor(self.tables.as_array()) if self.paged else None

        if plan.prefill_rows:
            pt = self._tensor(plan.prefill_tokens)
            pp = self._tensor(plan.prefill_pos)
            pl = self._tensor(plan.prefill_len)
            rids = self._tensor(plan.rids)
            ti = self._tensor(plan.tok_idx)
            if self.paged:
                sampled = np.zeros((self.cfg.batch_rows,), np.int32)
                for row in plan.prefill_rows:
                    sl = slice(row, row + 1)
                    nxt = self._prefill(pt[sl], pp[sl], pl[sl], tables[sl],
                                        rids[sl], ti[sl])
                    sampled[row] = int(nxt[0])
                    self.prefill_chunks += 1
            else:
                nxt = self._prefill(pt, pp, pl, None, rids, ti)
                sampled = nxt.cpu().numpy()
                self.prefill_chunks += 1
            finished = self.scheduler.record_prefill(plan, sampled)
            t = time.monotonic()
            for row in finished:
                self._first_t.setdefault(int(plan.rids[row]), t)
            self.tokens_prefilled += int(plan.prefill_len.sum())

        if plan.decode_rows:
            nxt = self._decode(
                self._tensor(plan.decode_tokens),
                self._tensor(plan.decode_pos), tables,
                self._tensor(plan.rids), self._tensor(plan.tok_idx),
            )
            self.scheduler.record_decode(plan, nxt.cpu().numpy())
            self.tokens_decoded += len(plan.decode_rows)
            self.decode_steps += 1

        t = time.monotonic()
        for row in self.scheduler.evict_finished():
            if self.paged:
                self.tables.release(row)
        for rid, toks in self.scheduler.completed.items():
            if rid not in self._finish_t:
                self._finish_t[rid] = t
                self._gen_counts[rid] = len(toks)
        if self.paged:
            self._occupancy.append(self.tables.occupancy())
        else:
            self._occupancy.append(
                len(self.scheduler.active) / self.cfg.batch_rows
            )
        self.steps += 1

    def run(self, requests=None, max_steps: int = 100_000) -> dict:
        """Serve ``requests`` (plus anything already queued) to
        completion and return the ``make_serve_result`` dict."""
        for req in requests or ():
            self.submit(req)
        t0 = time.monotonic()
        while not self.scheduler.idle:
            if self.steps >= max_steps:
                raise RuntimeError(f"serve loop exceeded {max_steps} steps")
            self.step()
        return self.result(seconds=time.monotonic() - t0)

    # ------------------------------------------------------------- result

    def _percentiles(self) -> dict[str, float]:
        ttft = [self._first_t[r] - self._eligible_t.get(r, self._first_t[r])
                for r in self._first_t]
        tpot = [
            (self._finish_t[r] - self._first_t[r]) / (self._gen_counts[r] - 1)
            for r in self._finish_t
            if r in self._first_t and self._gen_counts.get(r, 0) > 1
        ]
        out = {}
        for name, xs in (("ttft", ttft), ("tpot", tpot)):
            out[f"{name}_p50"] = float(np.percentile(xs, 50)) if xs else 0.0
            out[f"{name}_p95"] = float(np.percentile(xs, 95)) if xs else 0.0
        return out

    def result(self, seconds: float = 0.0) -> dict:
        occ = self._occupancy
        return make_serve_result(
            outputs=dict(self.scheduler.completed),
            seconds=seconds,
            completed=len(self.scheduler.completed),
            admitted=self.scheduler.admitted,
            preempted=self.scheduler.preempted,
            steps=self.steps,
            prefill_chunks=self.prefill_chunks,
            tokens_prefilled=self.tokens_prefilled,
            tokens_decoded=self.tokens_decoded,
            queue_depth_peak=self.queue_depth_peak,
            cache_occupancy_peak=max(occ) if occ else 0.0,
            cache_occupancy_mean=float(np.mean(occ)) if occ else 0.0,
            **self._percentiles(),
        )
