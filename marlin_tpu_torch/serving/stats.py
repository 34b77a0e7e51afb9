"""Serving observability: per-request latency stats, the slot occupancy
ledger, the prefix-reuse and admission-byte ledgers, the speculative
acceptance ledger and the crash-recovery ledger — port of
``marlin_tpu/serving/stats.py``. One :class:`EngineStats` spans every
engine incarnation of a supervised serving lifetime
(``ServingEngine.spawn_successor`` hands it on).

The decode round has a fixed batch, so every iteration costs the whole
batch's work whether or not a row holds live work:

* ``total_row_iters``  = sum over rounds of iters x batch (executed);
* ``useful_row_iters`` = sum of per-row LIVE iterations (consumed);
* utilization = useful / total.

:func:`static_schedule_iters` and :func:`static_completed_at_budget`
price the same workload under a static batcher, and
:meth:`EngineStats.reclaimed_flops` the difference.
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
    if req.spec_drafted:
        # Speculative engines: emitted == 1 + live_iters + spec_accepted.
        out["spec_drafted"] = req.spec_drafted
        out["spec_accepted"] = req.spec_accepted
    if req.status == "done":
        dt = max(req.finish_time - req.admit_time, 1e-9)
        out["decode_rounds"] = req.finish_round - req.admit_round + 1
        out["decode_tok_s"] = req.emitted / dt
    return out


def static_schedule_iters(steps_list: List[int], batch: int) -> int:
    """Decode iterations a STATIC batcher spends on this workload: FIFO
    groups of ``batch``, each running until its slowest member is done."""
    total = 0
    for i in range(0, len(steps_list), batch):
        total += max(steps_list[i:i + batch])
    return total


def static_completed_at_budget(steps_list: List[int], batch: int,
                               budget: int) -> int:
    """Requests a STATIC batcher completes within ``budget`` decode
    iterations of this FIFO workload: group i starts after group i - 1's
    slowest member, and a request completes when its own steps elapse
    inside its group's window."""
    t0, completed = 0, 0
    for i in range(0, len(steps_list), batch):
        group = steps_list[i:i + batch]
        completed += sum(1 for s in group if t0 + s <= budget)
        t0 += max(group)
    return completed


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
    # Prefix reuse (serving/prefix.py; zero without a prefix surface):
    # lookups, and the prompt positions and cost-model FLOPs the
    # admissions did not recompute.
    n_prefix_hits: int = 0
    n_prefix_misses: int = 0
    reclaimed_prefill_tokens: int = 0
    reclaimed_prefill_flops: float = 0.0
    # KV bytes moved to satisfy prefix hits: the contiguous engine's row
    # copies; the paged engine aliases pages and bills 0 per hit.
    admission_copy_bytes: float = 0.0
    n_zero_copy_hits: int = 0
    # The current engine incarnation's page pool (serving/pages.py; None
    # when contiguous): every engine rebinds it, the ledger outlives them.
    page_pool: object = None
    # Crash recovery (serving/frontend.py): requests requeued into a
    # successor engine, and requests failed closed as poisoned.
    n_recovered: int = 0
    n_quarantined: int = 0
    # Preemption (scheduler engines, serving/sched.py): rows frozen to the
    # host KV tier and rows thawed back; the difference is rows frozen
    # now plus frozen requests dropped for deadline.
    n_preempted: int = 0
    n_resumed: int = 0
    # Speculative acceptance (zero without spec rounds): lifetime totals,
    # and the per-round EWMA the adaptive draft-length policy reads.
    n_spec_drafted: int = 0
    n_spec_accepted: int = 0
    spec_accept_ewma: Optional[float] = None
    rounds: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    completed: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    quarantined: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    # Guards deque iteration against appends from the stepping thread.
    _lock: object = field(default_factory=threading.Lock, repr=False)

    PHASE_KEYS = ("queue_wait", "admit", "decode", "total")

    # EWMA weight of the per-round acceptance rate (CostCalibration's).
    SPEC_ACCEPT_ALPHA = 0.2

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

    def record_prefix_lookup(self, hit_len: int, prompt_len: int) -> None:
        """One admission's prefix outcome: ``hit_len`` prompt positions
        (0 = miss) whose prefill was skipped, priced by the admission
        cost model's hit-length term when ``cfg`` is set."""
        if hit_len:
            self.n_prefix_hits += 1
            self.reclaimed_prefill_tokens += hit_len
            if self.cfg is not None:
                cold, _ = cm.admission_cost(self.cfg, prompt_len)
                warm, _ = cm.admission_cost(self.cfg, prompt_len,
                                            hit_len=hit_len)
                self.reclaimed_prefill_flops += cold - warm
        else:
            self.n_prefix_misses += 1
        if self.registry is not None:
            name = "serving_prefix_hits_total" if hit_len \
                else "serving_prefix_misses_total"
            self.registry.counter(name).inc()
            if hit_len:
                self.registry.counter(
                    "serving_prefix_reclaimed_prefill_tokens_total").inc(
                        hit_len)

    def record_admission_copy(self, n_bytes: float,
                              zero_copy: bool = False) -> None:
        """One prefix-hit admission's KV byte bill: the row copy on the
        contiguous engine, 0 on the paged one (``zero_copy=True`` counts
        the aliasing hit)."""
        self.admission_copy_bytes += n_bytes
        if self.registry is not None and n_bytes:
            self.registry.counter(
                "serving_admission_copy_bytes_total",
                help="KV bytes copied to satisfy prefix-hit admissions "
                     "(0 by construction on the paged engine)").inc(
                n_bytes)
        if zero_copy:
            self.n_zero_copy_hits += 1
            if self.registry is not None:
                self.registry.counter(
                    "serving_kv_zero_copy_hits_total",
                    help="prefix hits admitted by page-table aliasing "
                         "with zero KV bytes moved").inc()

    def record_spec_round(self, drafted: int, accepted: int,
                          draft_len: int) -> None:
        """One speculative round: ``drafted`` draft positions carried by
        live verify chunks, ``accepted`` of them committed, at
        ``draft_len``. Feeds the totals, the EWMA and the mirrors
        (``serving_spec_drafted_total``, ``serving_spec_accepted_total``,
        ``serving_spec_accept_rate``, ``serving_spec_draft_len``)."""
        self.n_spec_drafted += drafted
        self.n_spec_accepted += accepted
        rate = accepted / drafted if drafted else 0.0
        if self.spec_accept_ewma is None:
            self.spec_accept_ewma = rate
        else:
            a = self.SPEC_ACCEPT_ALPHA
            self.spec_accept_ewma = a * rate \
                + (1.0 - a) * self.spec_accept_ewma
        if self.registry is not None:
            self.registry.counter(
                "serving_spec_drafted_total",
                help="draft positions carried by live speculative "
                     "verify chunks").inc(drafted)
            self.registry.counter(
                "serving_spec_accepted_total",
                help="draft positions committed by speculative "
                     "verification").inc(accepted)
            self.registry.gauge(
                "serving_spec_accept_rate",
                help="EWMA draft-acceptance rate the adaptive "
                     "draft-length policy reads").set(
                round(self.spec_accept_rate(), 4))
            self.registry.gauge(
                "serving_spec_draft_len",
                help="draft length the last speculative round ran "
                     "with").set(draft_len)

    def spec_accept_rate(self) -> float:
        """The rate the draft-length policy reads: the round EWMA once a
        speculative round ran, else the lifetime ratio, else 0.0."""
        if self.spec_accept_ewma is not None:
            return self.spec_accept_ewma
        if self.n_spec_drafted:
            return self.n_spec_accepted / self.n_spec_drafted
        return 0.0

    def prefix_hit_rate(self) -> float:
        total = self.n_prefix_hits + self.n_prefix_misses
        return self.n_prefix_hits / total if total else 0.0

    def record_timeout(self, req) -> None:
        self.n_timeout += 1
        if self.registry is not None:
            self.registry.counter("serving_timeout_total").inc()

    def record_recovery(self, req) -> None:
        """One request requeued into a successor engine after a crash:
        recovered work, not new work."""
        self.n_recovered += 1
        if self.registry is not None:
            self.registry.counter(
                "serving_requests_recovered_total",
                help="requests requeued bit-exactly after an engine "
                     "crash (supervised restart)").inc()

    def record_quarantine(self, req, error) -> None:
        """One request failed closed as poisoned: implicated in
        ``poison_after`` consecutive engine crashes, never requeued
        again."""
        self.n_quarantined += 1
        with self._lock:
            self.quarantined.append({
                "request_id": req.request_id,
                "crash_count": req.crash_count,
                "prompt_len": req.prompt_len,
                "steps": req.steps,
                "error": repr(error)})
        if self.registry is not None:
            self.registry.counter(
                "serving_requests_quarantined_total",
                help="poison requests excluded from crash recovery "
                     "after repeated implication").inc()

    def quarantine_snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.quarantined)

    def record_preempt(self, req) -> None:
        """One live row frozen to the host tier so a higher-class request
        could take its slot or pages; the request is requeued, not done."""
        self.n_preempted += 1
        if self.registry is not None:
            self.registry.counter(
                "serving_preempted_total",
                help="live rows frozen to the host KV tier by the "
                     "scheduler (bit-exact preemption)").inc()

    def record_resume(self, req) -> None:
        """One frozen request thawed back onto a row."""
        self.n_resumed += 1
        if self.registry is not None:
            self.registry.counter(
                "serving_resumed_total",
                help="frozen requests restored onto a device row and "
                     "resumed bit-exactly").inc()

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
            for key in self.PHASE_KEYS + ("prefill_dispatch",
                                          "prefix_copy"):
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

    def flops_per_row_iter(self) -> float:
        """One row's share of one decode iteration's FLOPs (needs
        ``cfg``)."""
        if self.cfg is None:
            raise ValueError("EngineStats needs cfg to price FLOPs")
        flops, _ = cm.decode_step_cost(self.cfg, self.batch)
        return flops / self.batch

    def reclaimed_flops(self, static_row_iters: Optional[int] = None,
                        static_iters: Optional[int] = None) -> float:
        """FLOPs of frozen-row work this engine saved against a static
        batcher on the same workload: (the static waste - this waste)
        priced a row-iteration. Pass the static schedule's row-iterations
        or its iterations (:func:`static_schedule_iters`)."""
        if static_row_iters is None:
            if static_iters is None:
                raise ValueError("pass static_row_iters or static_iters")
            static_row_iters = static_iters * self.batch
        static_waste = static_row_iters - self.useful_row_iters
        return (static_waste - self.wasted_row_iters) \
            * self.flops_per_row_iter()

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
        if self.n_recovered or self.n_quarantined:
            out.update({
                "recovered": self.n_recovered,
                "quarantined": self.n_quarantined,
                "quarantine": self.quarantine_snapshot(),
            })
        if self.n_preempted:
            out.update({
                "preempted": self.n_preempted,
                "resumed": self.n_resumed,
            })
        if self.n_prefix_hits or self.n_prefix_misses:
            out.update({
                "prefix_hits": self.n_prefix_hits,
                "prefix_misses": self.n_prefix_misses,
                "prefix_hit_rate": round(self.prefix_hit_rate(), 4),
                "prefix_reclaimed_prefill_tokens":
                    self.reclaimed_prefill_tokens,
                "prefix_reclaimed_prefill_gflops": round(
                    self.reclaimed_prefill_flops / 1e9, 4),
                "admission_copy_bytes": self.admission_copy_bytes,
                "zero_copy_hits": self.n_zero_copy_hits,
            })
        if self.n_spec_drafted:
            out.update({
                "spec_drafted": self.n_spec_drafted,
                "spec_accepted": self.n_spec_accepted,
                "spec_accept_rate": round(self.spec_accept_rate(), 4),
                "spec_accept_lifetime": round(
                    self.n_spec_accepted / self.n_spec_drafted, 4),
            })
        if self.page_pool is not None:
            out["kv_pages"] = self.page_pool.summary()
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
