"""Admission queue for the serving engine: FIFO with backpressure,
deadlines and graceful drain, or the order of a scheduler — port of
``marlin_tpu/serving/queue.py``.

* Backpressure: ``submit`` on a full queue raises :class:`QueueFull`.
* Deadlines: ``deadline_rounds`` (engine round index) or
  ``deadline_time`` (absolute ``time.perf_counter()`` instant); a request
  past either is dropped at pop time with status ``timeout``.
* Drain: after ``close`` no submit is accepted; queued work still runs.
* Order: FIFO, or with ``scheduler=`` (serving/sched.Scheduler) its
  classes, quotas and EDF; backpressure, deadlines and locking stay here.

Every public method takes the queue's lock, so concurrent submitters
compose with the single stepping thread that pops at round boundaries.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class QueueFull(RuntimeError):
    """Raised by submit when the pending queue is at ``max_pending``."""


class QueueClosed(RuntimeError):
    """Raised by submit after :meth:`AdmissionQueue.close`."""


@dataclass
class Request:
    """One generation request as the queue and engine track it. Timing
    fields are ``time.perf_counter()`` instants on one clock, filled in as
    the request moves submit -> admit -> finish."""

    request_id: int
    prompt: np.ndarray  # (prompt_len,) int, host-side
    steps: int
    deadline_rounds: Optional[int] = None
    deadline_time: Optional[float] = None
    submit_round: int = 0
    submit_time: float = 0.0
    # Scheduling (serving/sched.py): an opaque caller label, the priority
    # class (empty until a scheduler resolves it) and the scheduler's
    # arrival sequence (assigned once, so a re-push keeps its place).
    tenant: str = "default"
    sched_class: str = ""
    sched_seq: int = -1
    # Preemption: while the request waits frozen (status "preempted"),
    # ``frozen`` is its sched.FrozenRow; ``preempt_count`` counts its
    # freezes and ``restores`` the times its KV came back from the host
    # tier (a prefix restore or a thaw).
    frozen: Optional[object] = None
    preempt_count: int = 0
    restores: int = 0
    row: int = -1
    admit_round: int = -1
    admit_start_time: float = 0.0  # popped from the queue
    admit_time: float = 0.0  # row armed, first token exists
    finish_round: int = -1
    finish_time: float = 0.0
    prefill_s: float = 0.0  # admission dispatch wall-clock
    prefix_copy_s: float = 0.0  # prefix-cache row copy wall-clock
    live_iters: int = 0  # decode iterations this request was live for
    emitted: int = 0  # tokens actually generated (< steps if eos fired)
    # Speculative rounds' acceptance ledger: draft positions this
    # request's live verify chunks carried (draft_len - 1 each) and those
    # that committed. The chunk's own token is billed to live_iters, so
    # emitted == 1 + live_iters + spec_accepted exactly.
    spec_drafted: int = 0
    spec_accepted: int = 0
    # pending -> active -> done | timeout; a preemption detours
    # active -> preempted -> active.
    status: str = "pending"
    tokens: Optional[np.ndarray] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def phases(self) -> dict:
        """Per-phase durations (seconds): ``queue_wait``, ``admit`` and
        ``decode`` are differences of consecutive stamps, so they sum
        exactly to ``total``; ``prefill_dispatch`` and ``prefix_copy``
        ride alongside."""
        out = {}
        if not self.submit_time:
            return out
        if self.admit_start_time:
            out["queue_wait"] = self.admit_start_time - self.submit_time
            if self.admit_time:
                out["admit"] = self.admit_time - self.admit_start_time
                if self.finish_time:
                    out["decode"] = self.finish_time - self.admit_time
        elif self.finish_time:  # timed out while queued
            out["queue_wait"] = self.finish_time - self.submit_time
        if self.finish_time:
            out["total"] = self.finish_time - self.submit_time
        if self.prefill_s:
            out["prefill_dispatch"] = self.prefill_s
        if self.prefix_copy_s:
            out["prefix_copy"] = self.prefix_copy_s
        return out


@dataclass
class AdmissionQueue:
    """FIFO of :class:`Request` with backpressure and deadline drop.

    ``scheduler`` replaces the FIFO order by its per-class EDF heaps.
    ``on_expire`` is called, outside the lock, for each request dropped at
    pop time: the engine releases what a frozen request still holds (its
    pinned host-tier row)."""

    max_pending: int = 64
    scheduler: Optional[object] = None
    on_expire: Optional[object] = None  # callable(Request) -> None
    _q: deque = field(default_factory=deque)
    _closed: bool = False

    def __post_init__(self):
        self._lock = threading.Lock()

    def _pending_locked(self) -> int:
        if self.scheduler is not None:
            return len(self.scheduler)
        return len(self._q)

    def __len__(self) -> int:
        with self._lock:
            return self._pending_locked()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def submit(self, req: Request) -> None:
        with self._lock:  # check-then-append is one atomic decision
            if self._closed:
                raise QueueClosed(
                    "queue is draining (close() was called); no new "
                    "requests")
            pending = self._pending_locked()
            if pending >= self.max_pending:
                raise QueueFull(
                    f"{pending} pending requests >= max_pending "
                    f"{self.max_pending}; retry after the engine drains")
            if self.scheduler is not None:
                self.scheduler.push(req)  # an unknown class raises here
            else:
                self._q.append(req)

    def pop_ready(self, round_idx: int, now: Optional[float] = None,
                  occupancy=None):
        """Next admissible request, in FIFO or the scheduler's order.
        Requests whose deadline round or instant has passed are marked
        ``timeout`` and returned in ``expired``. ``occupancy`` (``{class:
        rows}``) feeds the scheduler's quotas. Returns ``(request | None,
        expired_list)``."""
        expired = []
        req = None
        if now is None:
            now = time.perf_counter()
        with self._lock:
            if self.scheduler is not None:
                req, expired = self.scheduler.pop(round_idx, now,
                                                  occupancy)
            else:
                while self._q:
                    cand = self._q.popleft()
                    if ((cand.deadline_rounds is not None
                            and round_idx > cand.deadline_rounds)
                            or (cand.deadline_time is not None
                                and now > cand.deadline_time)):
                        cand.status = "timeout"
                        cand.finish_round = round_idx
                        cand.finish_time = now
                        expired.append(cand)
                        continue
                    req = cand
                    break
        # Outside the lock: the hook takes the host tier's lock.
        for r in expired:
            if self.scheduler is not None:
                self.scheduler.note_timeout(r)
            if self.on_expire is not None:
                self.on_expire(r)
        return req, expired

    def peek_urgent(self):
        """The queued request most entitled to trigger a preemption (the
        scheduler's ``preempt_candidate``), not popped; None in FIFO mode
        or when none waits."""
        with self._lock:
            if self.scheduler is None:
                return None
            return self.scheduler.preempt_candidate(time.perf_counter())

    def push_front(self, req: Request) -> None:
        """Return a popped but unplaced (or preempted) request to the
        head of the queue: the paged engine's page-pressure path, retried
        once retirements free pages. Bypasses ``max_pending``: the request
        was accepted once already. A scheduler takes it back into its
        class heap under its original sequence."""
        with self._lock:
            if self.scheduler is not None:
                self.scheduler.push(req)
            else:
                self._q.appendleft(req)

    def close(self) -> None:
        """Stop accepting new work; queued requests still drain."""
        with self._lock:
            self._closed = True
