"""The serving result schema: the port of ``SERVE_RESULT_KEYS`` and
``make_serve_result`` from ``repro/api/runner.py``."""

from __future__ import annotations

SERVE_RESULT_KEYS = (
    "outputs",
    "completed",
    "admitted",
    "preempted",
    "steps",
    "prefill_chunks",
    "tokens_prefilled",
    "tokens_decoded",
    "tokens_per_s",
    "seconds",
    "queue_depth_peak",
    "cache_occupancy_peak",
    "cache_occupancy_mean",
    "ttft_p50",
    "ttft_p95",
    "tpot_p50",
    "tpot_p95",
)

_SERVE_INT_DEFAULTS = {
    "completed": 0,
    "admitted": 0,
    "preempted": 0,
    "steps": 0,
    "prefill_chunks": 0,
    "tokens_prefilled": 0,
    "tokens_decoded": 0,
    "queue_depth_peak": 0,
}

_SERVE_FLOAT_DEFAULTS = {
    "cache_occupancy_peak": 0.0,
    "cache_occupancy_mean": 0.0,
    "ttft_p50": 0.0,
    "ttft_p95": 0.0,
    "tpot_p50": 0.0,
    "tpot_p95": 0.0,
}


def make_serve_result(*, outputs: dict, seconds: float, **counters) -> dict:
    """Assemble the ServeEngine result: one documented schema
    (``SERVE_RESULT_KEYS``), unset counters default to 0 (absent-as-0,
    never missing), unknown counters raise.

        outputs               {request id: [generated token ids]}
        completed             requests finished
        admitted              queue -> row admissions (re-admissions after
                              a preemption count again)
        preempted             cache-pressure preemptions (recompute-on-
                              restart; outputs stay deterministic)
        steps                 engine iterations
        prefill_chunks        chunked-prefill dispatches
        tokens_prefilled      prompt tokens written through prefill
        tokens_decoded        decode-step tokens processed
        tokens_per_s          (tokens_prefilled + tokens_decoded) / seconds
        seconds               wall-clock of the run
        queue_depth_peak      max requests waiting in the queue
        cache_occupancy_peak  max fraction of KV pages (paged) or rows
                              (dense) in use
        cache_occupancy_mean  mean of the same, over steps
        ttft_p50 / ttft_p95   time-to-first-token percentiles (s)
        tpot_p50 / tpot_p95   time-per-output-token percentiles (s)
    """
    known = set(_SERVE_INT_DEFAULTS) | set(_SERVE_FLOAT_DEFAULTS)
    unknown = set(counters) - known
    if unknown:
        raise TypeError(f"unknown serve counters: {sorted(unknown)}")
    out = {"outputs": dict(outputs), "seconds": float(seconds)}
    for key, default in _SERVE_INT_DEFAULTS.items():
        out[key] = int(counters.get(key, default))
    for key, default in _SERVE_FLOAT_DEFAULTS.items():
        out[key] = float(counters.get(key, default))
    tokens = out["tokens_prefilled"] + out["tokens_decoded"]
    out["tokens_per_s"] = tokens / out["seconds"] if out["seconds"] > 0 else 0.0
    return out
