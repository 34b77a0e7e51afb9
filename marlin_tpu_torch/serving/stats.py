"""Serving observability: per-request latency stats and the slot
occupancy ledger — port of ``marlin_tpu/serving/stats.py`` (the default
engine's ledger).

The decode round has a fixed batch, so every iteration costs the whole
batch's work whether or not a row holds live work:

* ``total_row_iters``  = sum over rounds of iters x batch (executed);
* ``useful_row_iters`` = sum of per-row LIVE iterations (consumed);
* utilization = useful / total.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import metrics as obs_metrics
from ..utils import cost_model as cm

HISTORY = 4096  # per-event history kept for inspection; totals stay exact


def request_stats(req) -> dict:
    """Latency/throughput summary of one finished request. TTFT is submit
    -> admission (the first token is sampled inside the admission
    prefill); decode throughput is emitted tokens over admit -> finish."""
    wait_s = max(0.0, req.admit_time - req.submit_time) \
        if req.admit_round >= 0 else None
    out = {
        "request_id": req.request_id,
        "status": req.status,
        "prompt_len": req.prompt_len,
        "steps": req.steps,
        "emitted": req.emitted,
        "queue_wait_rounds": (req.admit_round - req.submit_round
                              if req.admit_round >= 0 else None),
        "queue_wait_s": wait_s,
        "ttft_s": wait_s,
        "live_iters": req.live_iters,
        "phases": req.phases(),
    }
    if req.status == "done":
        dt = max(req.finish_time - req.admit_time, 1e-9)
        out["decode_rounds"] = req.finish_round - req.admit_round + 1
        out["decode_tok_s"] = req.emitted / dt
    return out


@dataclass
class EngineStats:
    """Engine-level ledger fed by ``ServingEngine`` callbacks, mirrored
    into ``registry`` when one is set (the same series names as the JAX
    package: ``serving_admitted_total``, ``serving_ttft_seconds``, ...)."""

    batch: int
    cfg: object = None
    registry: Optional[obs_metrics.MetricsRegistry] = None
    calibration: Optional[cm.CostCalibration] = None
    n_admitted: int = 0
    n_completed: int = 0
    n_timeout: int = 0
    n_rounds: int = 0
    tokens_out: int = 0
    total_iters: int = 0
    useful_row_iters: int = 0
    rounds: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    completed: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    # Guards deque iteration against appends from the stepping thread.
    _lock: object = field(default_factory=threading.Lock, repr=False)

    PHASE_KEYS = ("queue_wait", "admit", "decode", "total")

    def __post_init__(self):
        if self.calibration is None:
            self.calibration = cm.CostCalibration(registry=self.registry)

    def record_admission(self, req) -> None:
        self.n_admitted += 1
        if self.registry is not None:
            self.registry.counter(
                "serving_admitted_total",
                help="requests admitted into a batch row").inc()
            if req.submit_time:
                self.registry.histogram(
                    "serving_ttft_seconds",
                    help="submit -> first token (admission prefill) "
                         "seconds",
                ).observe(max(0.0, req.admit_time - req.submit_time),
                          exemplar=str(req.request_id))

    def record_timeout(self, req) -> None:
        self.n_timeout += 1
        if self.registry is not None:
            self.registry.counter("serving_timeout_total").inc()

    def record_round(self, round_idx: int, iters: int, occupied: int,
                     live_iters: int) -> None:
        self.n_rounds += 1
        self.total_iters += iters
        self.useful_row_iters += live_iters
        with self._lock:
            self.rounds.append({"round": round_idx, "iters": iters,
                                "occupied": occupied,
                                "live_iters": live_iters})
        if self.registry is not None:
            self.registry.counter("serving_decode_iters_total").inc(iters)
            self.registry.gauge("serving_occupancy").set(occupied)
            self.registry.gauge("serving_utilization").set(
                self.utilization())

    def record_completion(self, req) -> None:
        self.n_completed += 1
        self.tokens_out += req.emitted
        with self._lock:
            self.completed.append(request_stats(req))
        if self.registry is not None:
            self.registry.counter("serving_completed_total").inc()
            self.registry.counter("serving_tokens_out_total").inc(
                req.emitted)
            dt = max(req.finish_time - req.admit_time, 0.0)
            self.registry.histogram(
                "serving_token_latency_seconds").observe(
                    dt / max(req.emitted, 1))
            phases = req.phases()
            for key in self.PHASE_KEYS + ("prefill_dispatch",):
                if key in phases:
                    self.registry.histogram(
                        "serving_phase_seconds", phase=key,
                    ).observe(max(0.0, phases[key]),
                              exemplar=str(req.request_id))

    @property
    def sim_iters(self) -> int:
        """Decode iterations plus one per admission (each request's first
        token comes from its admission prefill)."""
        return self.total_iters + self.n_admitted

    @property
    def total_row_iters(self) -> int:
        return self.total_iters * self.batch

    @property
    def wasted_row_iters(self) -> int:
        return self.total_row_iters - self.useful_row_iters

    def utilization(self) -> float:
        if not self.total_row_iters:
            return 0.0
        return self.useful_row_iters / self.total_row_iters

    def completed_snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.completed)

    def summary(self) -> Dict[str, object]:
        out = {
            "admitted": self.n_admitted,
            "completed": self.n_completed,
            "timeout": self.n_timeout,
            "tokens_out": self.tokens_out,
            "rounds": self.n_rounds,
            "decode_iters": self.total_iters,
            "sim_iters": self.sim_iters,
            "total_row_iters": self.total_row_iters,
            "useful_row_iters": self.useful_row_iters,
            "wasted_row_iters": self.wasted_row_iters,
            "utilization": round(self.utilization(), 4),
        }
        done = [c for c in self.completed_snapshot()
                if c["status"] == "done"]
        if done:
            waits = [c["queue_wait_rounds"] for c in done]
            out["mean_queue_wait_rounds"] = sum(waits) / len(waits)
            out["max_queue_wait_rounds"] = max(waits)
            ttfts = [c["ttft_s"] for c in done if c["ttft_s"] is not None]
            if ttfts:
                out["mean_ttft_s"] = round(sum(ttfts) / len(ttfts), 5)
            for key in self.PHASE_KEYS:
                vals = [c["phases"][key] for c in done
                        if key in c.get("phases", {})]
                if vals:
                    out[f"mean_phase_{key}_s"] = round(
                        sum(vals) / len(vals), 5)
        drift = self.calibration.summary() if self.calibration else {}
        if drift:
            out["cost_model_drift"] = drift
        return out
