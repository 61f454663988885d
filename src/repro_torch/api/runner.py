"""The result schemas: the port of ``RESULT_KEYS`` / ``make_result``
(training runners) and ``SERVE_RESULT_KEYS`` / ``make_serve_result``
(``ServeEngine``) from ``repro/api/runner.py``.

A counter that a runner does not have is reported as 0, never missing, so
every result of one kind has one shape.
"""

from __future__ import annotations

from typing import Any

RESULT_KEYS = (
    "params",
    "updates",
    "frames",
    "fps",
    "seconds",
    "param_version",
    "publishes_sent",
    "publishes_skipped",
    "put_blocked",
    "traj_dropped",
    "replay_size",
    "checkpoints_saved",
    "actor_restarts",
    "actor_quarantined",
    "watchdog_stalls",
    "checkpoint_fallbacks",
    "hosts_joined",
    "hosts_lost",
    "reshards",
    "epoch",
    "mean_return",
    "metrics",
    "scenarios",
)

_COUNTER_DEFAULTS = {
    "param_version": 0,
    "publishes_sent": 0,
    "publishes_skipped": 0,
    "put_blocked": 0,
    "traj_dropped": 0,
    "replay_size": 0,
    "checkpoints_saved": 0,
    "actor_restarts": 0,
    "actor_quarantined": 0,
    "watchdog_stalls": 0,
    "checkpoint_fallbacks": 0,
    "hosts_joined": 0,
    "hosts_lost": 0,
    "reshards": 0,
    "epoch": 0,
}


def make_result(*, params: Any, updates: int, frames: int, seconds: float,
                metrics: dict, mean_return: float = float("nan"),
                scenarios: dict | None = None, **counters: int) -> dict:
    """The training result (``RESULT_KEYS``).  Unset counters default to
    0; a counter outside the schema raises.

        params             final parameters (device tree)
        updates            learner updates applied
        frames             env frames generated
        fps                frames / seconds
        seconds            wall clock of the fit
        param_version      params version the actors observe (the init
                           publish is 1, each update adds one)
        publishes_sent     actor-slot param copies made
        publishes_skipped  publishes skipped because the slot's previous
                           publish was not yet picked up
        put_blocked        full-queue retry intervals on the actor side
        traj_dropped       trajectories dropped at shutdown
        mean_return        mean episode return (NaN when none ended)
        metrics            learner metrics, means since the last drain
        scenarios          per-scenario counters of a device-env mix ({})
    and the counters of paths the port does not run yet (replay,
    checkpoints, supervision, multi-host), 0 here.
    """
    unknown = set(counters) - set(_COUNTER_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown result counters: {sorted(unknown)}")
    out = {
        "params": params,
        "updates": int(updates),
        "frames": int(frames),
        "fps": float(frames) / seconds if seconds > 0 else 0.0,
        "seconds": float(seconds),
        "mean_return": float(mean_return),
        "metrics": dict(metrics),
        "scenarios": dict(scenarios) if scenarios else {},
    }
    for key, default in _COUNTER_DEFAULTS.items():
        out[key] = int(counters.get(key, default))
    return out


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
