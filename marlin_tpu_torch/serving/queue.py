"""Admission queue for the serving engine: FIFO with backpressure,
deadlines and graceful drain — port of ``marlin_tpu/serving/queue.py``
(the FIFO discipline; scheduler-ordered queues are not ported yet).

* Backpressure: ``submit`` on a full queue raises :class:`QueueFull`.
* Deadlines: ``deadline_rounds`` (engine round index) or
  ``deadline_time`` (absolute ``time.perf_counter()`` instant); a request
  past either is dropped at pop time with status ``timeout``.
* Drain: after ``close`` no submit is accepted; queued work still runs.

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
    status: str = "pending"  # pending -> active -> done | timeout
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
    """FIFO of :class:`Request` with backpressure and deadline drop."""

    max_pending: int = 64
    _q: deque = field(default_factory=deque)
    _closed: bool = False

    def __post_init__(self):
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

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
            if len(self._q) >= self.max_pending:
                raise QueueFull(
                    f"{len(self._q)} pending requests >= max_pending "
                    f"{self.max_pending}; retry after the engine drains")
            self._q.append(req)

    def pop_ready(self, round_idx: int, now: Optional[float] = None):
        """Next admissible request in FIFO order. Requests whose deadline
        round or instant has passed are marked ``timeout`` and returned in
        ``expired``. Returns ``(request | None, expired_list)``."""
        expired = []
        req = None
        if now is None:
            now = time.perf_counter()
        with self._lock:
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
        return req, expired

    def push_front(self, req: Request) -> None:
        """Return a popped but unplaced request to the head of the queue
        (the paged engine's page-pressure path: admission retries it once
        retirements free pages). Bypasses ``max_pending``: the request
        was accepted once already."""
        with self._lock:
            self._q.appendleft(req)

    def close(self) -> None:
        """Stop accepting new work; queued requests still drain."""
        with self._lock:
            self._closed = True
