"""SLO-aware multi-tenant scheduling: priority classes, per-class quotas,
EDF admission order and the preemption policy — port of
``marlin_tpu/serving/sched.py``.

* **Priority classes** (:class:`ClassSpec`): named classes, by default
  ``interactive`` / ``batch`` / ``best_effort``, ordered by ``rank``
  (lower is more urgent), each with an optional concurrent-row ``quota``,
  an optional queue-wait SLO (``slo_s``), whether its active rows may be
  frozen (``preemptible``) and whether its queued requests may trigger a
  freeze (``can_preempt``).
* **EDF within a class**: each class keeps an earliest-deadline-first
  heap keyed by the earlier of the caller's deadline and ``submit_time +
  slo_s``; requests with neither sort last, FIFO by a submission sequence
  that also breaks ties.
* **Quotas, work-conserving**: :meth:`Scheduler.pop` scans the classes in
  rank order twice, first only those under quota, then all of them, so a
  quota bounds a class only under contention.
* **Preemption policy** (:meth:`Scheduler.preempt_candidate`,
  :meth:`victim_order`, :meth:`preempt_gate`): who may freeze whom, and
  the cost gate ``utils.cost_model.preempt_beneficial``. The freeze itself
  is the engine's (``ServingEngine._preempt_row``).

The scheduler owns no engine state: the :class:`~.queue.AdmissionQueue`
delegates ordering to it and calls every heap method under its own lock.
Scheduling reorders requests and never touches sampling: a request's
tokens are a function of (prompt, steps, seed, request id) alone, so any
order, quota or freeze and thaw gives the same tokens.

Metrics (``serving_sched_*``): ``preemptions_total``, ``resumes_total``
and ``preempt_aborts_total`` counters, per-class ``queue_wait_seconds``
histograms and ``slo_miss_total`` counters, per-class queued gauges.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import cost_model as cm


@dataclass(frozen=True)
class ClassSpec:
    """One priority class (module docstring)."""

    name: str
    rank: int
    quota: Optional[int] = None
    slo_s: Optional[float] = None
    preemptible: bool = True
    can_preempt: bool = False

    def __post_init__(self):
        if not self.name or not self.name.isidentifier():
            raise ValueError(
                f"class name must be a non-empty identifier, got "
                f"{self.name!r}")
        if self.quota is not None and self.quota < 1:
            raise ValueError(
                f"quota must be >= 1 or None, got {self.quota}")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError(
                f"slo_s must be > 0 or None, got {self.slo_s}")


# Interactive traffic preempts, is never frozen and carries the tight SLO;
# batch work is preemptible bulk; best_effort takes what is left.
DEFAULT_CLASSES: Tuple[ClassSpec, ...] = (
    ClassSpec("interactive", rank=0, quota=None, slo_s=1.0,
              preemptible=False, can_preempt=True),
    ClassSpec("batch", rank=1, quota=None, slo_s=None,
              preemptible=True, can_preempt=False),
    ClassSpec("best_effort", rank=2, quota=None, slo_s=None,
              preemptible=True, can_preempt=False),
)


@dataclass
class FrozenRow:
    """What a preempted decoding row leaves on the host besides the KV
    payload the host tier holds under ``host_key``:

    * ``filled`` / ``target``: the row's decode cursor and extent at the
      freeze (its buffer holds tokens [0, filled), its KV slots [0,
      filled - 1)).
    * ``gen``: the request's sampling generator (None when greedy). It
      advances only on the row's live iterations, so handing it back at
      the thaw resumes the stream where the freeze cut it.
    * ``n_pages`` / ``nbytes``: the page complement to reserve again and
      the payload size the tier accounted.
    """

    host_key: str
    filled: int
    target: int
    gen: Optional[torch.Generator]
    n_pages: int
    nbytes: int
    preempt_round: int


class Scheduler:
    """Priority-class EDF admission policy (module docstring).

    ``preempt_margin``: a freeze must look this many times cheaper, in
    modeled bytes, than letting the victim run; <= 0 disables preemption.
    ``max_preempts_per_round`` bounds the rows one round may freeze."""

    def __init__(self, classes: Sequence[ClassSpec] = DEFAULT_CLASSES,
                 default_class: Optional[str] = None,
                 preempt_margin: float = 1.0,
                 max_preempts_per_round: int = 1,
                 registry=None):
        specs = list(classes)
        if not specs:
            raise ValueError("at least one class is required")
        names = [c.name for c in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        if len({c.rank for c in specs}) != len(specs):
            raise ValueError(
                f"class ranks must be unique, got "
                f"{[(c.name, c.rank) for c in specs]}")
        self.classes: Dict[str, ClassSpec] = {c.name: c for c in specs}
        self.by_rank: List[ClassSpec] = sorted(specs,
                                               key=lambda c: c.rank)
        self.default_class = (default_class if default_class is not None
                              else self.by_rank[0].name)
        if self.default_class not in self.classes:
            raise ValueError(
                f"default_class {self.default_class!r} is not one of "
                f"{sorted(self.classes)}")
        if max_preempts_per_round < 0:
            raise ValueError(
                f"max_preempts_per_round must be >= 0, got "
                f"{max_preempts_per_round}")
        self.preempt_margin = float(preempt_margin)
        self.max_preempts_per_round = int(max_preempts_per_round)
        self.metrics = registry
        # Per-class EDF heap of (effective deadline, seq, Request).
        self._heaps: Dict[str, list] = {c.name: [] for c in specs}
        self._seq = 0

    # -- class resolution ---------------------------------------------

    def resolve(self, name: Optional[str]) -> ClassSpec:
        """The ClassSpec of ``name`` (None: the default class); an unknown
        name raises ValueError."""
        if name is None:
            return self.classes[self.default_class]
        spec = self.classes.get(name)
        if spec is None:
            raise ValueError(
                f"unknown scheduling class {name!r}; expected one of "
                f"{sorted(self.classes)}")
        return spec

    def effective_deadline(self, req) -> float:
        """The EDF key: the earlier of the caller's deadline and the
        class SLO's target; +inf with neither."""
        spec = self.classes[req.sched_class]
        dl = math.inf
        if req.deadline_time is not None:
            dl = float(req.deadline_time)
        if spec.slo_s is not None:
            dl = min(dl, req.submit_time + spec.slo_s)
        return dl

    # -- heap surface (called under the AdmissionQueue lock) ----------

    def push(self, req) -> None:
        """Enqueue. The sequence is assigned on first contact, so a
        re-push (a page-pressure probe, a preemption) keeps its place."""
        spec = self.resolve(req.sched_class)
        req.sched_class = spec.name
        if req.sched_seq < 0:
            req.sched_seq = self._seq
            self._seq += 1
        heapq.heappush(self._heaps[spec.name],
                       (self.effective_deadline(req), req.sched_seq, req))

    def __len__(self) -> int:
        return sum(len(h) for h in self._heaps.values())

    def queued_by_class(self) -> Dict[str, int]:
        return {name: len(h) for name, h in self._heaps.items()}

    @staticmethod
    def _expired(req, round_idx: int, now: float) -> bool:
        return ((req.deadline_rounds is not None
                 and round_idx > req.deadline_rounds)
                or (req.deadline_time is not None
                    and now > req.deadline_time))

    def pop(self, round_idx: int, now: float,
            occupancy: Optional[Dict[str, int]] = None):
        """The next admissible request under the quota discipline,
        dropping expired ones (status ``timeout``) on the way: classes
        under quota first, in rank order, then every class. Returns
        ``(request | None, expired_list)``."""
        occupancy = occupancy or {}
        expired: list = []
        for enforce_quota in (True, False):
            for spec in self.by_rank:
                if enforce_quota and spec.quota is not None \
                        and occupancy.get(spec.name, 0) >= spec.quota:
                    continue
                heap = self._heaps[spec.name]
                while heap:
                    _, _, req = heapq.heappop(heap)
                    if self._expired(req, round_idx, now):
                        req.status = "timeout"
                        req.finish_round = round_idx
                        req.finish_time = now
                        expired.append(req)
                        continue
                    return req, expired
        return None, expired

    # -- preemption policy --------------------------------------------

    def preempt_candidate(self, now: float):
        """The queued request most entitled to trigger a freeze: the head
        of the first ``can_preempt`` class in rank order that has one
        (rank wins over deadline across classes); None otherwise."""
        for spec in self.by_rank:
            if not spec.can_preempt:
                continue
            heap = self._heaps[spec.name]
            if heap:
                return heap[0][2]
        return None

    def victim_order(self, candidates, requester_rank: int):
        """The freezable ones of the active ``(req, remaining_steps)``
        pairs, in preference order: only preemptible classes of strictly
        lower priority than ``requester_rank``; lowest priority first,
        then most remaining work, then the newest id."""
        eligible = []
        for req, remaining in candidates:
            spec = self.classes.get(req.sched_class)
            if spec is None or not spec.preemptible:
                continue
            if spec.rank <= requester_rank:
                continue
            eligible.append((spec.rank, remaining, req))
        eligible.sort(key=lambda t: (-t[0], -t[1], -t[2].request_id))
        return [(req, remaining) for _, remaining, req in eligible]

    def preempt_gate(self, cfg, row_len: int,
                     remaining_steps: int) -> bool:
        """The cost gate on one candidate freeze."""
        if self.preempt_margin <= 0:
            return False
        return cm.preempt_beneficial(cfg, row_len, remaining_steps,
                                     margin=self.preempt_margin)

    # -- metrics (engine-called; no scheduler state touched) ----------

    def _counter(self, name: str, help_: str, **labels):
        if self.metrics is not None:
            self.metrics.counter(name, help=help_, **labels).inc()

    def note_admitted(self, req, queue_wait_s: float) -> None:
        """The class's queue-wait histogram and SLO-miss counter, at a
        request's first admission (a thaw does not record again)."""
        if self.metrics is None:
            return
        self.metrics.histogram(
            "serving_sched_queue_wait_seconds", cls=req.sched_class,
            help="queue wait (submit -> admission start) by class",
        ).observe(max(0.0, queue_wait_s), exemplar=str(req.request_id))
        spec = self.classes.get(req.sched_class)
        if spec is not None and spec.slo_s is not None \
                and queue_wait_s > spec.slo_s:
            self._counter("serving_sched_slo_miss_total",
                          "admissions (or drops) past the class "
                          "queue-wait SLO", cls=req.sched_class)

    def note_timeout(self, req) -> None:
        """A deadline drop is an SLO miss for a class that has an SLO."""
        spec = self.classes.get(req.sched_class)
        if spec is not None and spec.slo_s is not None:
            self._counter("serving_sched_slo_miss_total",
                          "admissions (or drops) past the class "
                          "queue-wait SLO", cls=req.sched_class)

    def note_preempt(self, req) -> None:
        self._counter("serving_sched_preemptions_total",
                      "decoding rows frozen and spilled to the host "
                      "tier to admit higher-priority work",
                      cls=req.sched_class)

    def note_resume(self, req) -> None:
        self._counter("serving_sched_resumes_total",
                      "preempted rows restored bit-exactly from the "
                      "host tier", cls=req.sched_class)

    def note_preempt_abort(self, reason: str) -> None:
        self._counter("serving_sched_preempt_aborts_total",
                      "freezes abandoned cleanly (host budget, no "
                      "eligible victim, cost gate)", reason=reason)

    def mirror_queued(self) -> None:
        """Refresh the per-class queued gauges (the round's epilogue)."""
        if self.metrics is None:
            return
        for name, h in self._heaps.items():
            self.metrics.gauge(
                "serving_sched_class_queued",
                help="requests waiting in the class's EDF heap",
                cls=name).set(float(len(h)))

    def spawn_successor(self) -> "Scheduler":
        """A fresh scheduler with this one's policy (classes, default,
        margins) and none of its queued requests."""
        return Scheduler(
            classes=self.by_rank, default_class=self.default_class,
            preempt_margin=self.preempt_margin,
            max_preempts_per_round=self.max_preempts_per_round,
            registry=self.metrics)

    def summary(self) -> dict:
        """The class table, for ``ServingEngine.debug_sched``."""
        return {
            "classes": [
                {"name": c.name, "rank": c.rank, "quota": c.quota,
                 "slo_s": c.slo_s, "preemptible": c.preemptible,
                 "can_preempt": c.can_preempt,
                 "queued": len(self._heaps[c.name])}
                for c in self.by_rank],
            "default_class": self.default_class,
            "preempt_margin": self.preempt_margin,
            "max_preempts_per_round": self.max_preempts_per_round,
        }
