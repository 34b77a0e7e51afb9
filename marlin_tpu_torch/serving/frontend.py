"""The engine's supervised driver: many submitting threads, one engine
thread — port of ``marlin_tpu/serving/frontend.py``. The HTTP server
(serving/server.py) goes through it and never touches the engine.

``ServingEngine`` is single-threaded by contract: only ``submit`` and
``close`` are thread-safe. :class:`EngineFrontend` is the one place the
two threading models meet:

* the engine runs on a DRIVER thread (:meth:`EngineFrontend.start`),
  stepping rounds while work exists and parking on an event when idle; on
  a CUDA engine the thread sets the engine's device first (the current
  device is per thread);
* submitting threads call :meth:`EngineFrontend.submit`, which registers
  a :class:`FrontendRequest` handle and queues the request in one locked
  section; ``QueueFull`` and ``QueueClosed`` reach the caller;
* after every round the driver fans out: streaming handles get the
  round's new tokens (one host copy of the token buffer a round, only
  while a stream is live) and finished or timed-out requests complete
  their handle. Tokens come straight from the engine's buffer, so a
  stream is the blocking result chunked.

A :class:`~marlin_tpu_torch.serving.jobs.MatrixService` attached as
``matrix`` runs on the same driver thread: one bounded slice of matrix
quanta between decode rounds under LLM load, a larger one when the engine
is idle, each slice credited to the next round event
(``ServingEngine.note_matrix_quanta``).

Drain (:meth:`EngineFrontend.drain`): close admissions (the matrix
service's too), finish the accepted work, seal the run log
(``drain_complete`` and a flush), join the driver.

Supervision: the driver loop runs inside a crash boundary. When the
engine raises, the supervisor delivers what resolved before the crash,
waits for the devices' queued work (an error there, such as a sticky CUDA
fault, fails recovery), captures the ledger, releases the crashed
engine's device state, builds a successor
(``ServingEngine.spawn_successor``), requeues every request that was not
done with its id, deadlines and arrival intact and resumes. Replay is
bitwise by construction: a request's tokens are a function of (prompt,
steps, seed, request id), and the successor runs the same prefill and
decode tile shapes. At most
``max_restarts`` crashes within ``restart_window_s`` are recovered; past
that, or when recovery itself raises, the frontend FAILS CLOSED: every
handle gets :class:`EngineFailed`, submits are refused, ``ready`` goes
false. A request implicated in ``poison_after`` consecutive crashes is
QUARANTINED with :class:`PoisonedRequest` instead of requeued. A matrix
job in flight at a crash replays from its seed, or is quarantined after
``poison_after`` consecutive crashes. Only Python-level faults (planted
ones included) are recovered; the supervisor does not retry a kernel that
failed to build.

The reference's trace calls at the crash boundary (replay link spans,
incidents, tail-kept exemplars) need the tracer of ROADMAP Queue A5: a
frontend over an engine whose tracer is enabled raises
``NotImplementedError`` rather than skip them.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from . import faults

# Closes a streaming handle's chunk queue; never equal to a chunk.
_EOS = object()


class FrontendError(RuntimeError):
    """The driver thread died; carried by every handle it abandoned."""


class EngineFailed(FrontendError):
    """The supervisor spent its restart budget, or recovery itself
    failed, and failed closed: submits are refused and ``ready`` is
    false."""


class PoisonedRequest(FrontendError):
    """This request was in flight across ``poison_after`` consecutive
    engine crashes and is quarantined instead of requeued. Carries
    ``request_id``, ``crash_count`` and ``last_error``."""

    def __init__(self, request_id: int, crash_count: int,
                 last_error: BaseException):
        super().__init__(
            f"request {request_id} quarantined: in flight across "
            f"{crash_count} consecutive engine crashes "
            f"(last: {type(last_error).__name__}: {last_error})")
        self.request_id = request_id
        self.crash_count = crash_count
        self.last_error = last_error


def _drop_frame_locals(exc: BaseException) -> None:
    """Clear the locals of the finished frames in ``exc``'s traceback and
    in those of the exceptions chained to it: a crash's frames hold the
    device tensors the crashed round was using."""
    seen, todo = set(), [exc]
    while todo:
        e = todo.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        todo += [e.__cause__, e.__context__]


def _driver_error(request_id: int, err: BaseException) -> FrontendError:
    if isinstance(err, FrontendError):
        return err
    out = FrontendError(
        f"driver thread failed serving request {request_id}")
    out.__cause__ = err
    return out


class FrontendRequest:
    """One submission's handle: the completion event, the stream's chunk
    queue and, once done, the engine's finished ``Request``. Submitting
    threads call :meth:`result` and :meth:`chunks`; the driver calls the
    underscored methods."""

    def __init__(self, request_id: int, stream: bool, submit_time: float):
        self.request_id = request_id
        self.stream = stream
        self.submit_time = submit_time
        self.first_token_time: Optional[float] = None
        self.done = threading.Event()
        self.request = None  # the engine's Request, set at completion
        self.error: Optional[BaseException] = None
        # The consumer went away: fanout stops feeding the chunk queue,
        # the request itself still completes.
        self.abandoned = False
        # Tokens already pushed (driver thread only).
        self._streamed = 0
        self._chunks: Optional[_queue.Queue] = \
            _queue.Queue() if stream else None

    def result(self, timeout: Optional[float] = None):
        """Block until the request finishes; returns the engine's
        ``Request`` (status ``done`` or ``timeout``). Raises
        :class:`PoisonedRequest` or :class:`EngineFailed` when the
        supervisor gave that verdict, :class:`FrontendError` for another
        driver death, and ``TimeoutError`` after ``timeout`` seconds."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done after {timeout}s")
        if self.error is not None:
            raise _driver_error(self.request_id, self.error)
        return self.request

    def chunks(self, timeout: Optional[float] = None):
        """Yield the token chunks (1-D int32 arrays) in generation order
        as rounds produce them, ending when the request completes; joined
        they are the blocking ``tokens``. Raises the handle's error, or
        ``TimeoutError`` when no chunk comes within ``timeout`` seconds."""
        if self._chunks is None:
            raise ValueError("not a streaming request")
        while True:
            try:
                item = self._chunks.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"request {self.request_id}: no chunk within "
                    f"{timeout}s") from None
            if item is _EOS:
                if self.error is not None:
                    raise _driver_error(self.request_id, self.error)
                return
            yield item

    def _push(self, chunk: np.ndarray, now: float) -> None:
        if self.first_token_time is None:
            self.first_token_time = now
        if self._chunks is not None and len(chunk):
            self._chunks.put(chunk)

    def _complete(self, req, now: float) -> None:
        self.request = req
        if self.first_token_time is None and req.emitted:
            self.first_token_time = now
        if self._chunks is not None:
            self._chunks.put(_EOS)
        self.done.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        if self._chunks is not None:
            self._chunks.put(_EOS)
        self.done.set()


class EngineFrontend:
    """Run a :class:`~marlin_tpu_torch.serving.ServingEngine` on a
    supervised driver thread and bridge concurrent submitters into it
    (module docstring).

    ``idle_wait`` bounds the parked driver's sleep between wake checks.
    ``max_restarts`` engine rebuilds within the sliding
    ``restart_window_s`` are recovered before the frontend fails closed;
    a request in flight across ``poison_after`` consecutive crashes is
    quarantined. ``on_round(engine, round_idx, finished)``, when given,
    runs on the driver thread after each round's fanout (an exception it
    raises is a crash like the engine's). ``matrix``, a
    :class:`~marlin_tpu_torch.serving.jobs.MatrixService` on the engine's
    device, runs its quanta on the driver thread between rounds, inside
    the crash boundary."""

    def __init__(self, engine, idle_wait: float = 0.05,
                 max_restarts: int = 3, restart_window_s: float = 60.0,
                 poison_after: int = 2, on_round=None, matrix=None):
        if matrix is not None and matrix.device != engine.device:
            raise ValueError(
                f"the matrix service runs on {matrix.device}, the engine "
                f"on {engine.device}: the driver thread runs both on one "
                f"device")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        if poison_after < 1:
            raise ValueError(f"poison_after must be >= 1, got "
                             f"{poison_after}")
        self._check_tracer(engine)
        self.engine = engine
        # Its own lock guards its job state; the frontend calls it from
        # the driver thread or through its thread-safe entry points.
        self.matrix = matrix
        self.idle_wait = float(idle_wait)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.poison_after = int(poison_after)
        self.on_round = on_round
        self.metrics = engine.metrics
        self.restarts = 0  # successful rebuilds, lifetime
        # The sliding restart window (driver writes, debug views read).
        self._crash_times: deque = deque()
        self._undelivered: List = []  # the last step's un-fanned-out work
        self._handles: Dict[int, FrontendRequest] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._fatal: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _check_tracer(engine) -> None:
        if engine.tracer.enabled:
            raise NotImplementedError(
                "EngineFrontend over an enabled tracer: the crash "
                "boundary's replay link spans, incidents and kept "
                "exemplars need the tracer of ROADMAP Queue A5")

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "EngineFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(
            target=self._drive, name="marlin-engine-driver", daemon=True)
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        """The driver thread runs and has not failed."""
        return (self._thread is not None and self._thread.is_alive()
                and self._fatal is None)

    @property
    def failure(self) -> Optional[BaseException]:
        """What the driver died of: :class:`EngineFailed` once the
        frontend failed closed; None while it serves."""
        return self._fatal

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def ready(self) -> bool:
        return self.alive and not self.draining

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Close admissions, finish the accepted work, seal the run log
        and stop the driver. Idempotent. True when the driver exited
        within ``timeout``."""
        # Close before flagging, under the lock the supervisor's swap
        # holds: an idle driver that saw the flag with an open queue would
        # exit unsealed, and a close on an engine being discarded would be
        # lost (a successor inherits a closed queue).
        with self._lock:
            self.engine.close()
        if self.matrix is not None:
            self.matrix.close()
        self._draining.set()
        self._wake.set()
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self, timeout: Optional[float] = None) -> bool:
        """Hard stop after the current round; pending handles fail with
        :class:`FrontendError`. True when the driver exited within
        ``timeout``. Prefer :meth:`drain`."""
        self._stopped.set()
        self._wake.set()
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- submission (any thread) ---------------------------------------

    def _raise_if_fatal(self) -> None:
        if self._fatal is not None:
            if isinstance(self._fatal, EngineFailed):
                raise EngineFailed(str(self._fatal))
            raise FrontendError("driver thread died") from self._fatal

    def submit(self, prompt, steps: int,
               deadline_s: Optional[float] = None, stream: bool = False,
               request_id: Optional[int] = None,
               tenant: Optional[str] = None,
               sched_class: Optional[str] = None) -> FrontendRequest:
        """Queue one request; returns its handle. Registering the handle
        and queueing happen under one lock hold, which the fanout and the
        supervisor's capture-and-swap take too: a request lands wholly in
        the crashed engine (and is requeued) or wholly in its successor,
        and no finished request is seen before its handle exists.
        ``QueueFull``, ``QueueClosed`` and ``ValueError`` propagate."""
        self._raise_if_fatal()
        with self._lock:
            # Again under the lock: a submit racing the fail-closed
            # transition must not register a handle nothing will finish.
            self._raise_if_fatal()
            rid = self.engine.submit(prompt, steps, deadline_s=deadline_s,
                                     request_id=request_id, tenant=tenant,
                                     sched_class=sched_class)
            handle = FrontendRequest(rid, stream=stream,
                                     submit_time=time.perf_counter())
            self._handles[rid] = handle
        self._wake.set()
        return handle

    def submit_matrix(self, spec, stream: bool = False):
        """Queue one validated matrix job on the attached service and wake
        the driver; returns its ``MatrixJobHandle``. ``QueueFull`` and
        ``QueueClosed`` propagate; ``ValueError`` when no service is
        attached (the server's 404)."""
        self._raise_if_fatal()
        if self.matrix is None:
            raise ValueError(
                "matrix service not enabled (start with --matrix)")
        handle = self.matrix.submit(spec, stream=stream)
        self._wake.set()
        return handle

    def abandon_stream(self, handle: FrontendRequest) -> None:
        """The stream's consumer went away: stop feeding its chunk queue.
        The request still runs to completion. Idempotent."""
        if handle.abandoned:
            return
        handle.abandoned = True
        self.metrics.counter(
            "serving_streams_abandoned_total",
            help="streams whose consumer left before completion (request "
                 "still completes)").inc()
        self.engine.runlog.emit("stream_abandoned",
                                request_id=handle.request_id)

    # -- debug introspection (any thread) -------------------------------

    def debug_engine(self) -> dict:
        """The engine's snapshot plus the frontend's own state."""
        out = self.engine.debug_snapshot()
        with self._lock:
            out["frontend"] = {"handles": len(self._handles),
                               "alive": self.alive,
                               "draining": self.draining,
                               "restarts": self.restarts,
                               "crashes_in_window": len(self._crash_times),
                               "max_restarts": self.max_restarts,
                               "failed": self._fatal is not None}
        if self.matrix is not None:
            out["matrix"] = self.matrix.summary()
        return out

    def debug_request(self, request_id: int):
        return self.engine.debug_request(request_id)

    def debug_sched(self):
        """The scheduler's state; None on a FIFO engine."""
        return self.engine.debug_sched()

    # -- the driver ------------------------------------------------------

    def _has_work(self) -> bool:
        eng = self.engine
        return bool(len(eng.queue) or eng.slots.n_occupied)

    def _drive(self) -> None:
        """The supervised driver: the loop inside a crash boundary. On an
        engine exception, recover and resume; once the budget is spent or
        recovery raises, fail closed and let the thread die loudly."""
        try:
            dev = self.engine.device
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
        except BaseException as e:  # noqa: BLE001 - fail every waiter
            self._fatal = e
            self._abandon(e)
            raise
        while True:
            try:
                self._drive_loop()
                return  # drained and sealed, or stopped
            except BaseException as e:  # noqa: BLE001 - supervised
                if self._stopped.is_set():
                    self._fatal = e
                    self._abandon(e)
                    raise
                try:
                    recovered = self._recover(e)
                except BaseException as rec_err:  # noqa: BLE001
                    err = EngineFailed(
                        f"recovery failed after engine crash "
                        f"({type(e).__name__}: {e}): "
                        f"{type(rec_err).__name__}: {rec_err}")
                    err.__cause__ = rec_err
                    self._fatal = err
                    self._abandon(err)
                    raise err from rec_err
                if not recovered:
                    raise self._fatal

    def _drive_loop(self) -> None:
        while not self._stopped.is_set():
            eng = self.engine  # re-read: _recover swaps it
            mx = self.matrix
            llm_work = self._has_work()
            mx_work = mx is not None and mx.has_work()
            if not llm_work and not mx_work:
                if self._draining.is_set():
                    eng._seal_drain()
                    return
                self._wake.wait(self.idle_wait)
                self._wake.clear()
                continue
            if not llm_work:
                # Engine idle: the matrix job gets the larger slice; the
                # wake checks between slices keep an LLM arrival's wait
                # at one slice.
                n = mx.run_quanta(mx.quanta_budget(idle=True),
                                  round_idx=eng.round_idx)
                if n:
                    eng.note_matrix_quanta(n)
                continue
            round_idx = eng.round_idx  # step() increments it
            finished = eng.step()
            # Held where _recover can deliver it if the fanout dies
            # (delivery pops the handle, so it happens once).
            self._undelivered = list(finished)
            self._fanout(eng, finished, round_idx)
            self._undelivered = []
            if mx_work:
                # Mixed traffic: one bounded slice of quanta between decode
                # rounds, so a decode round waits at most one slice.
                n = mx.run_quanta(mx.quanta_budget(idle=False),
                                  round_idx=round_idx)
                if n:
                    eng.note_matrix_quanta(n)
            if self.on_round is not None:
                self.on_round(eng, round_idx, finished)
        self._abandon(FrontendError("frontend stopped mid-flight"))

    def _recover(self, exc: BaseException) -> bool:
        """The crash boundary: deliver what resolved before the crash,
        wait for the devices, capture the ledger, quarantine poisoned
        requests, release the crashed engine, build the successor and
        requeue the rest. False when the restart budget is spent (the
        frontend has failed closed)."""
        now = time.perf_counter()
        eng = self.engine
        # 1. What resolved before the crash completes normally: its
        #    tokens are already on the host.
        leftovers, eng._retired_pending = eng._retired_pending, []
        for req in list(self._undelivered) + leftovers:
            self._deliver(req, now)
        self._undelivered = []
        # 2. No kernel may still run against the state about to be
        #    dropped; a device that cannot synchronize (a sticky CUDA
        #    error) fails recovery, and the frontend fails closed.
        eng._sync_device()
        self._check_tracer(eng)
        poisoned: List = []
        poisoned_handles: List = []
        err: Optional[EngineFailed] = None
        # 3. The budget and the capture-and-swap, under the submit lock.
        with self._lock:
            self._crash_times.append(now)
            horizon = now - self.restart_window_s
            while self._crash_times and self._crash_times[0] < horizon:
                self._crash_times.popleft()
            fail_closed = len(self._crash_times) > self.max_restarts
            with eng._submit_lock:
                captured = sorted(eng.requests.values(),
                                  key=lambda r: r.request_id)
            blamed = eng._admitting_rid
            inflight = [r for r in captured if r.admit_start_time]
            eng.runlog.emit(
                "engine_crash", round=eng.round_idx,
                error=f"{type(exc).__name__}: {exc}",
                error_type=type(exc).__name__,
                blamed_request_id=blamed,
                inflight=[r.request_id for r in inflight],
                queued=[r.request_id for r in captured
                        if not r.admit_start_time],
                crashes_in_window=len(self._crash_times))
            if fail_closed:
                err = EngineFailed(
                    f"engine crashed {len(self._crash_times)} times "
                    f"within {self.restart_window_s:.0f}s "
                    f"(max_restarts={self.max_restarts}); failing closed "
                    f"(last: {type(exc).__name__}: {exc})")
                err.__cause__ = exc
                self._fatal = err
                eng.runlog.emit(
                    "engine_failed", round=eng.round_idx,
                    restarts=self.restarts,
                    abandoned=[r.request_id for r in captured],
                    error=f"{type(exc).__name__}: {exc}")
                eng.runlog.flush()
            else:
                # A crash inside one request's own admission work blames
                # that request; a batch-wide one every request in flight.
                implicated = ([r for r in inflight
                               if r.request_id == blamed]
                              if blamed is not None else inflight)
                implicated_ids = {r.request_id for r in implicated}
                # Consecutive, literally: an in-flight request the blame
                # pinned elsewhere starts its streak again, and an
                # implication older than the window is stale.
                for r in inflight:
                    if r.request_id not in implicated_ids:
                        r.crash_count = 0
                for r in implicated:
                    stale = (r.last_crash_time and now - r.last_crash_time
                             > self.restart_window_s)
                    r.crash_count = 1 if stale else r.crash_count + 1
                    r.last_crash_time = now
                poisoned = [r for r in implicated
                            if r.crash_count >= self.poison_after]
                poison_ids = {r.request_id for r in poisoned}
                survivors = [r for r in captured
                             if r.request_id not in poison_ids]
                # 4. One incarnation's device state at a time: the
                #    crashed engine's cache, pool and host rows go before
                #    the successor's are allocated. The crash's frames
                #    would keep what they held alive, so they let go too.
                _drop_frame_locals(exc)
                eng.release()
                new_eng = eng.spawn_successor()
                new_eng.requeue(survivors, crash_time=now)
                self.engine = new_eng
                self.restarts += 1
                self.metrics.counter(
                    "serving_engine_restarts_total",
                    help="supervised engine rebuilds after a crash").inc()
                poisoned_handles = [self._handles.pop(r.request_id, None)
                                    for r in poisoned]
        if fail_closed:
            self._abandon(err)
            return False
        # 5. Quarantine verdicts, outside the lock.
        for req, h in zip(poisoned, poisoned_handles):
            req.status = "poisoned"
            req.finish_time = now
            self.engine.stats.record_quarantine(req, exc)
            self.engine.runlog.emit(
                "quarantine", request_id=req.request_id,
                crash_count=req.crash_count,
                error=f"{type(exc).__name__}: {exc}")
            if h is not None:
                h._fail(PoisonedRequest(req.request_id, req.crash_count,
                                        exc))
        # The matrix job in flight replays from its seed, or is
        # quarantined, as the LLM requests are.
        if self.matrix is not None:
            self.matrix.reset_inflight(exc, now)
        self._wake.set()
        return True

    def _abandon(self, err: BaseException) -> None:
        with self._lock:
            orphans = list(self._handles.values())
            self._handles.clear()
        for h in orphans:
            h._fail(err)
        if self.matrix is not None:
            self.matrix.abandon(err)

    def _fanout(self, eng, finished: List, round_idx: int) -> None:
        """After a round: push new tokens to live streams, complete the
        finished and timed-out handles. ``round_idx`` is the round just
        run, the fault site's coordinate as at every engine site."""
        faults.check("stream_fanout", round_idx=round_idx)
        now = time.perf_counter()
        with self._lock:
            live = [h for h in self._handles.values()
                    if h.stream and not h.abandoned
                    and h.request_id in eng.requests
                    and eng.requests[h.request_id].status == "active"]
        if live:
            buf = eng._buf.cpu().numpy()  # one host copy serves them all
            for h in live:
                req = eng.requests.get(h.request_id)
                if req is None or req.row < 0:
                    continue  # retired, or frozen, this instant
                s = req.prompt_len
                n_vis = min(int(eng._filled[req.row]) - s, req.steps)
                if n_vis > h._streamed:
                    h._push(buf[req.row, s + h._streamed:s + n_vis]
                            .astype(np.int32), now)
                    h._streamed = n_vis
        for req in finished:
            self._deliver(req, now)

    def _deliver(self, req, now: float) -> None:
        """Hand one resolved request to its handle, once: the handle pop
        is the claim, so recovery may run this over the same list
        again."""
        with self._lock:
            h = self._handles.pop(req.request_id, None)
        if h is None:
            return  # submitted to the engine directly, or delivered
        if req.status == "done" and req.tokens is not None \
                and not h.abandoned:
            # The tail past the streamed cursor (eos padding included).
            h._push(np.asarray(req.tokens[h._streamed:], np.int32), now)
        req.delivered_time = now
        if req.finish_time:
            self.metrics.histogram(
                "serving_phase_seconds", phase="stream_delivery",
                help="per-request phase durations, seconds",
            ).observe(max(0.0, now - req.finish_time),
                      exemplar=str(req.request_id))
        if h.first_token_time is not None:
            self.metrics.histogram("serving_http_ttft_seconds").observe(
                h.first_token_time - h.submit_time)
        self.metrics.histogram("serving_http_request_seconds").observe(
            now - h.submit_time)
        h._complete(req, now)
