"""HTTP serving frontend: port of ``marlin_tpu/serving/server.py``,
stdlib only, threaded, drain-aware, over the supervised
:class:`~marlin_tpu_torch.serving.frontend.EngineFrontend`. The routes,
status codes, JSON fields, headers and CLI flags are the reference's, so
``tools/serving_client.py`` and ``tools/runlog_report.py`` run against it
unchanged.

* ``POST /v1/generate``: body ``{"prompt": [ints], "steps": n,
  "deadline_s": t?, "stream": bool?, "request_id": n?, "tenant": s?,
  "sched_class": s?}``. The blocking form returns one JSON object with the
  whole ``tokens`` array; ``stream: true`` returns Server-Sent Events
  (chunked), one ``data:`` event a round's new tokens and a terminal
  ``done`` event, whose concatenation is the blocking array. A request
  that times out queued returns 504. The engine id comes back in
  ``X-Request-Id`` (or the caller's own header value, with the engine id
  in ``X-Engine-Request-Id``). Every response carries the ``timing``
  block: the engine's contiguous phases (queue_wait + admit + decode ==
  total) and the HTTP side's ``http_ttft_s`` / ``http_total_s``.
* ``POST /v1/matrix``: a matrix job (serving/jobs.py), only with a matrix
  service attached (404 otherwise). Typed 400s carry ``code`` and
  ``detail``; the blocking reply is the npz payload verbatim
  (``application/octet-stream``, its meta in ``X-Matrix-Meta``), the
  streamed one SSE progress events and a terminal ``done`` event with the
  npz base64'd.
* ``GET /metrics`` (Prometheus text), ``/healthz`` (200 while the listener
  accepts), ``/readyz`` (200 only while the driver lives and is not
  draining; a TP engine adds its degree and devices), ``/debug/engine``,
  ``/debug/requests/<id>``, ``/debug/sched`` (404 on a FIFO engine).
* ``GET /debug/trace`` answers 501: the trace export, exemplars and
  flight recorder are the tracer of ROADMAP Queue A5, and the frontend
  refuses an enabled tracer; the spans the handler opens on the disabled
  tracer are no-ops. A forwarded ``X-Trace-Context`` is parsed
  (obs/distributed.py) and its trace id and sampled flag recorded on the
  request's ``trace_ctx`` run-log event.

Backpressure maps to status codes: ``QueueFull`` -> 429 with
``Retry-After``; draining or a failed-closed engine -> 503 with
``Retry-After``; a malformed request -> 400; a quarantined request -> 500
with ``status: "poisoned"``. An SSE client that hangs up is detected at
the broken pipe, its fanout stops, and the request still completes.

Threads: handler threads touch no device tensor. Tokens reach them as
host arrays through the frontend's fanout, matrix results as npz bytes
the driver thread encoded.

Graceful drain: SIGTERM (:func:`install_signal_handlers`) or
:meth:`ServingHTTPServer.begin_drain` stops admissions (new requests get
503), lets the driver finish every accepted request, seals the run log,
then closes the listener. ``python -m marlin_tpu_torch.serving.server``
serves a small randomly initialized model on the card, or on the CPU with
``--force-cpu`` (or ``MARLIN_SERVE_FORCE_CPU``); ``MARLIN_FAULT_PLAN``
arms a fault plan (serving/faults.py).
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..obs import distributed as dtrace
from . import faults
from .frontend import EngineFrontend, FrontendError, PoisonedRequest
from .jobs import MatrixJobError
from .queue import QueueClosed, QueueFull

RETRY_AFTER_S = 1  # the hint on 429/503: one engine round is usually enough
CLOSE_TIMEOUT_S = 30.0  # close_now's wait for the driver and the listener

# The refusal of the tracer's surface, for /debug/trace and --trace*.
TRACER_REFUSAL = ("the tracer's export, exemplars and flight recorder are "
                  "not ported to marlin_tpu_torch yet (ROADMAP Queue A5)")


class _Handler(BaseHTTPRequestHandler):
    """One request; the server object carries the shared state."""

    protocol_version = "HTTP/1.1"
    server_version = "marlin-serving/1"

    @property
    def frontend(self) -> EngineFrontend:
        return self.server.frontend

    @property
    def metrics(self):
        return self.server.frontend.metrics

    def log_message(self, fmt, *args):  # the run log, not stderr
        self.server.runlog.emit("http_access", line=fmt % args)

    def _count(self, route: str, code: int) -> None:
        self.metrics.counter("serving_http_requests_total",
                             route=route).inc()
        self.metrics.counter("serving_http_responses_total",
                             code=str(code)).inc()

    def _send_json(self, code: int, obj: dict, route: str,
                   headers: Optional[dict] = None) -> None:
        body = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        self._count(route, code)

    # -- GET -----------------------------------------------------------------

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        path = self.path.partition("?")[0]
        if path == "/metrics":
            body = self.server.registry.prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self._count("/metrics", 200)
        elif path == "/healthz":
            self._send_json(200, {"ok": True}, "/healthz")
        elif path == "/readyz":
            ready = self.frontend.ready
            body = {"ready": ready, "draining": self.frontend.draining,
                    "driver_alive": self.frontend.alive}
            if self.server.tp_degree > 1:
                body["tp_degree"] = self.server.tp_degree
                body["tp_devices"] = self.server.tp_devices
                body["tp_quorum"] = (self.server.tp_devices
                                     >= self.server.tp_degree)
            self._send_json(
                200 if ready else 503, body, "/readyz",
                headers=None if ready else {"Retry-After": RETRY_AFTER_S})
        elif path == "/debug/engine":
            self._send_json(200, self.frontend.debug_engine(),
                            "/debug/engine")
        elif path == "/debug/sched":
            info = self.frontend.debug_sched()
            if info is None:
                self._send_json(
                    404, {"error": "no scheduler on this engine (FIFO "
                          "admission; start with --sched)"},
                    "/debug/sched")
            else:
                self._send_json(200, info, "/debug/sched")
        elif path.startswith("/debug/requests/"):
            route = "/debug/requests"
            try:
                rid = int(path[len("/debug/requests/"):])
            except ValueError:
                self._send_json(400, {"error": "request id must be the "
                                      "integer engine id"}, route)
                return
            info = self.frontend.debug_request(rid)
            if info is None:
                self._send_json(
                    404, {"error": f"request {rid} unknown (never "
                          "submitted, or fell out of the completion "
                          "window)"}, route)
            else:
                self._send_json(200, info, route)
        elif path == "/debug/trace":
            self._send_json(501, {"error": f"/debug/trace: "
                                  f"{TRACER_REFUSAL}"}, "/debug/trace")
        else:
            self._send_json(404, {"error": f"no route {path}"}, path)

    # -- POST /v1/generate ---------------------------------------------------

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path == "/v1/matrix":
            self._post_matrix()
            return
        if path != "/v1/generate":
            self._send_json(404, {"error": f"no route {path}"}, path)
            return
        route = "/v1/generate"
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = np.asarray(body["prompt"], np.int32).reshape(-1)
            steps = int(body["steps"])
            deadline_s = (None if body.get("deadline_s") is None
                          else float(body["deadline_s"]))
            stream = bool(body.get("stream", False))
            # An explicit engine id (a fleet router's assignment).
            request_id = (None if body.get("request_id") is None
                          else int(body["request_id"]))
            tenant = (None if body.get("tenant") is None
                      else str(body["tenant"]))
            sched_class = (None if body.get("sched_class") is None
                           else str(body["sched_class"]))
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"}, route)
            return
        http_id = self.headers.get("X-Request-Id")
        ctx = dtrace.parse(self.headers.get(dtrace.TRACE_HEADER))
        tracer = self.server.tracer  # disabled: its spans are no-ops
        try:
            with tracer.span("http.request", route=route,
                             http_id=http_id or ""):
                handle = self.frontend.submit(
                    prompt, steps, deadline_s=deadline_s, stream=stream,
                    request_id=request_id, tenant=tenant,
                    sched_class=sched_class)
        except QueueFull as e:
            self._send_json(429, {"error": str(e)}, route,
                            headers={"Retry-After": RETRY_AFTER_S})
            return
        except (QueueClosed, FrontendError) as e:
            self._send_json(503, {"error": str(e)}, route,
                            headers={"Retry-After": RETRY_AFTER_S})
            return
        except ValueError as e:
            self._send_json(400, {"error": str(e)}, route)
            return
        # The run log's key is the engine id; the caller's X-Request-Id
        # and a forwarded trace context ride along as correlation.
        if http_id is not None or ctx is not None:
            self.server.runlog.emit(
                "trace_ctx", request_id=handle.request_id,
                **({"http_id": http_id} if http_id is not None else {}),
                **({"trace_id": ctx.trace_id, "sampled": ctx.sampled}
                   if ctx is not None else {}))
        id_headers = {"X-Engine-Request-Id": handle.request_id,
                      "X-Request-Id": http_id or str(handle.request_id)}
        with tracer.span("http.respond", request_id=handle.request_id,
                         http_id=http_id or "", stream=stream):
            if stream:
                self._respond_stream(handle, route, id_headers)
            else:
                self._respond_blocking(handle, route, id_headers)

    # -- POST /v1/matrix -----------------------------------------------------

    def _post_matrix(self) -> None:
        """Matrix-ops-as-a-service: validate (typed 400s) on this thread,
        price and queue on the frontend's driver; reply with the npz
        payload verbatim, or stream progress over SSE."""
        route = "/v1/matrix"
        if self.server.matrix is None:
            self._send_json(404, {"error": "matrix service not "
                                           "enabled (start with "
                                           "--matrix)"}, route)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise MatrixJobError("bad_json",
                                     "body must be a JSON object")
            stream = bool(body.pop("stream", False))
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}",
                                  "code": "bad_json", "detail": {}},
                            route)
            return
        http_id = self.headers.get("X-Request-Id")
        try:
            spec = self.server.matrix.validate(body)
            handle = self.frontend.submit_matrix(spec, stream=stream)
        except MatrixJobError as e:
            self._send_json(400, {"error": str(e), "code": e.code,
                                  "detail": e.detail}, route)
            return
        except QueueFull as e:
            self._send_json(429, {"error": str(e)}, route,
                            headers={"Retry-After": RETRY_AFTER_S})
            return
        except (QueueClosed, FrontendError) as e:
            self._send_json(503, {"error": str(e)}, route,
                            headers={"Retry-After": RETRY_AFTER_S})
            return
        except ValueError as e:
            self._send_json(400, {"error": str(e)}, route)
            return
        id_headers = {"X-Job-Id": handle.job_id,
                      "X-Request-Id": http_id or str(handle.job_id)}
        if stream:
            self._respond_matrix_stream(handle, route, id_headers)
        else:
            self._respond_matrix_blocking(handle, route, id_headers)

    def _respond_matrix_blocking(self, handle, route, id_headers) -> None:
        try:
            payload, meta = handle.result(self.server.request_timeout_s)
        except PoisonedRequest as e:
            self._send_json(500, self._poison_body(e), route,
                            headers=id_headers)
            return
        except (FrontendError, TimeoutError) as e:
            self._send_json(503, {"error": str(e)}, route,
                            headers=id_headers)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("X-Matrix-Meta", json.dumps(meta))
        for k, v in id_headers.items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(payload)
        self._count(route, 200)

    def _respond_matrix_stream(self, handle, route, id_headers) -> None:
        """SSE progress: one ``data:`` event a phase or quantum (the
        service's event dicts), then the terminal ``done`` event with the
        npz payload base64'd. The 200 commits before the outcome is
        known, so a failure is reported in band."""
        self._start_sse(id_headers)
        code = 200
        try:
            for ev in handle.events(self.server.request_timeout_s):
                self._sse(ev)
            payload, meta = handle.result(
                0.0 if handle.done.is_set() else None)
            self._sse({"done": True, "meta": meta,
                       "npz_b64": base64.b64encode(payload).decode()})
            self._chunk(b"")  # terminal zero-length chunk
        except PoisonedRequest as e:
            code = 500  # accounting only: the 200 already went out
            self._sse_done_quietly({"done": True, **self._poison_body(e)})
        except (FrontendError, TimeoutError) as e:
            code = 503
            self._sse_done_quietly({"done": True, "error": str(e)})
        except OSError:
            # The client hung up: stop feeding its event queue; the job
            # still completes.
            code = 499
            self.server.matrix.abandon_stream(handle)
        self._count(route, code)

    # -- generate replies ----------------------------------------------------

    @staticmethod
    def _poison_body(e: PoisonedRequest) -> dict:
        return {"error": str(e), "status": "poisoned",
                "request_id": e.request_id, "crash_count": e.crash_count}

    def _finish_fields(self, req, handle=None) -> dict:
        out = {"request_id": req.request_id, "status": req.status,
               "emitted": req.emitted,
               "prompt_len": req.prompt_len, "steps": req.steps,
               # The engine's contiguous phases (queue_wait + admit +
               # decode == total, one clock) and the sub-attributions.
               "timing": {f"{k}_s": round(v, 6)
                          for k, v in req.phases().items()}}
        if handle is not None:
            # The HTTP side of the same timeline, on the handle's stamps.
            if handle.first_token_time is not None:
                out["timing"]["http_ttft_s"] = round(
                    handle.first_token_time - handle.submit_time, 6)
            out["timing"]["http_total_s"] = round(
                time.perf_counter() - handle.submit_time, 6)
        return out

    def _respond_blocking(self, handle, route, id_headers) -> None:
        try:
            req = handle.result(self.server.request_timeout_s)
        except PoisonedRequest as e:
            # A verdict on this request (500), not on the service: the
            # engine is back up.
            self._send_json(500, self._poison_body(e), route,
                            headers=id_headers)
            return
        except (FrontendError, TimeoutError) as e:
            self._send_json(503, {"error": str(e)}, route,
                            headers=id_headers)
            return
        if req.status != "done":
            # Queued past its deadline: admission never happened.
            self._send_json(504, {"error": "deadline exceeded in queue",
                                  **self._finish_fields(req, handle)},
                            route, headers=id_headers)
            return
        self._send_json(
            200, {**self._finish_fields(req, handle),
                  "tokens": np.asarray(req.tokens).tolist()},
            route, headers=id_headers)

    def _respond_stream(self, handle, route, id_headers) -> None:
        """SSE over chunked transfer: one ``data:`` event a round's new
        tokens, then the terminal ``done`` event. The 200 commits before
        the outcome is known, so a deadline timeout is the done event's
        ``status`` instead of a 504."""
        self._start_sse(id_headers)
        code = 200
        try:
            for chunk in handle.chunks(self.server.request_timeout_s):
                self._sse({"tokens": np.asarray(chunk).tolist()})
            req = handle.result(0.0 if handle.done.is_set() else None)
            self._sse({"done": True, **self._finish_fields(req, handle)})
            self._chunk(b"")  # terminal zero-length chunk
        except PoisonedRequest as e:
            code = 500  # accounting only: the 200 already went out
            self._sse_done_quietly({"done": True, **self._poison_body(e)})
        except (FrontendError, TimeoutError) as e:
            code = 503
            self._sse_done_quietly({"done": True, "error": str(e)})
        except OSError:
            # The client went away mid-stream: stop the fanout feeding a
            # queue nobody reads; the request still completes.
            code = 499
            self.frontend.abandon_stream(handle)
        self._count(route, code)

    # -- SSE framing ---------------------------------------------------------

    def _start_sse(self, id_headers) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in id_headers.items():
            self.send_header(k, str(v))
        self.end_headers()

    def _sse_done_quietly(self, obj: dict) -> None:
        try:
            self._sse(obj)
            self._chunk(b"")
        except OSError:
            pass

    def _sse(self, obj: dict) -> None:
        self._chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")

    def _chunk(self, payload: bytes) -> None:
        self.wfile.write(f"{len(payload):x}\r\n".encode() + payload
                         + b"\r\n")
        self.wfile.flush()


class ServingHTTPServer(ThreadingHTTPServer):
    """The listener and the shared state the handlers read. ``frontend``
    must be a started :class:`EngineFrontend`; the server never touches
    the engine directly."""

    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default backlog of 5 would reset a burst's connects.
    request_queue_size = 128

    def __init__(self, addr, frontend: EngineFrontend,
                 request_timeout_s: Optional[float] = 300.0):
        super().__init__(addr, _Handler)
        self.frontend = frontend
        # The /v1/matrix route exists only with a matrix service.
        self.matrix = frontend.matrix
        self.registry = frontend.metrics
        self.tracer = frontend.engine.tracer
        self.runlog = frontend.engine.runlog
        # The worker group for /readyz: a TP engine is one process over
        # the model axis's devices (models/tp.py's tp_devices).
        self.tp_degree = int(frontend.engine.cfg.tp)
        self.tp_devices = len(frontend.engine.devices)
        self.request_timeout_s = request_timeout_s
        self._drain_once = threading.Lock()
        self._drained = False
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start_background(self) -> "ServingHTTPServer":
        """``serve_forever`` on a daemon thread."""
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="marlin-http-listener",
            daemon=True)
        self._serve_thread.start()
        return self

    def begin_drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain, idempotent and thread-safe: stop admissions
        (new requests get 503), finish the accepted work through the
        engine's drain path (run log sealed), then stop the listener.
        True once the driver exited within ``timeout``."""
        with self._drain_once:
            if self._drained:
                return True
            # A wall-clock field for operators, never read back.
            self.runlog.emit("http_drain_begin", t_wall=time.time())
            ok = self.frontend.drain(timeout)
            self.shutdown()  # returns after serve_forever exits
            if self._serve_thread is not None:
                self._serve_thread.join(timeout)
            self.server_close()
            self._drained = ok
            return ok

    def close_now(self) -> None:
        """Hard teardown (tests): no drain; the driver and the listener
        are each given ``CLOSE_TIMEOUT_S`` to stop."""
        self.frontend.stop(CLOSE_TIMEOUT_S)
        self.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(CLOSE_TIMEOUT_S)
        self.server_close()


def serve(params, cfg, host: str = "127.0.0.1", port: int = 0,
          request_timeout_s: Optional[float] = 300.0,
          max_restarts: int = 3, restart_window_s: float = 60.0,
          poison_after: int = 2, matrix: bool = False,
          matrix_round_budget_s: float = 0.010,
          matrix_max_pending: int = 8,
          **engine_kwargs) -> ServingHTTPServer:
    """Build the engine, the started frontend and the listener; returns
    the server, not yet serving (call ``serve_forever()`` or
    ``start_background()``). ``port=0`` binds an ephemeral port
    (``server.port``). ``engine_kwargs`` go to ``ServingEngine``; its
    ``device`` defaults to ``"cuda"``, and ``params`` must live there.
    ``matrix=True`` attaches a :class:`~marlin_tpu_torch.serving.jobs.
    MatrixService` on the engine's device, sharing its registry and run
    log: ``POST /v1/matrix`` comes alive and the driver interleaves
    matrix quanta with decode rounds."""
    from .engine import ServingEngine

    engine = ServingEngine(params, cfg, **engine_kwargs)
    mx = None
    if matrix:
        from .jobs import MatrixService

        mx = MatrixService(metrics=engine.metrics, runlog=engine.runlog,
                           round_budget_s=matrix_round_budget_s,
                           max_pending=matrix_max_pending,
                           poison_after=poison_after,
                           device=engine.device)
    frontend = EngineFrontend(
        engine, max_restarts=max_restarts,
        restart_window_s=restart_window_s,
        poison_after=poison_after, matrix=mx).start()
    return ServingHTTPServer((host, port), frontend,
                             request_timeout_s=request_timeout_s)


def install_signal_handlers(server: ServingHTTPServer,
                            drain_timeout: Optional[float] = None):
    """SIGTERM/SIGINT -> graceful drain on a helper thread (a signal
    handler must not block; ``serve_forever`` runs until the drain's
    ``shutdown()`` stops it). Returns the Event set when the drain
    completes."""
    import signal

    drained = threading.Event()

    def _drain(signum, frame):
        def go():
            server.begin_drain(drain_timeout)
            drained.set()

        threading.Thread(target=go, name="marlin-drain",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    return drained


def main(argv=None) -> int:
    """Serve a small randomly initialized model: on the card, or on the
    CPU with ``--force-cpu`` / ``MARLIN_SERVE_FORCE_CPU`` (no silent
    fallback). Prints ``SERVING host=... port=...`` once the listener is
    bound, serves until SIGTERM/SIGINT, drains, prints ``DRAINED`` and
    returns 0."""
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds an ephemeral port")
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=2)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--round-steps", type=int, default=8)
    p.add_argument("--max-pending", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-pages", type=int, default=None,
                   help="paged KV pool size (pages); enables the paged "
                        "allocator + zero-copy prefix sharing")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="chunked-prefill chunk size (tokens)")
    p.add_argument("--host-kv-bytes", type=int, default=None,
                   help="host-memory KV tier budget (bytes); evicted "
                        "stored prefixes spill to host buffers and "
                        "restore on a later trie hit (needs --kv-pages)")
    p.add_argument("--spill-dir", default=None,
                   help="directory for durable spill files (.npz); "
                        "shared across replicas it lets any peer adopt "
                        "a sibling's spilled prefix")
    p.add_argument("--restore-min-tokens", type=int, default=None,
                   help="minimum extra hit depth (tokens) before a "
                        "restore beats re-prefill; default from the "
                        "measured cost-model crossover")
    p.add_argument("--matrix", action="store_true",
                   help="attach the matrix-ops job service: POST "
                        "/v1/matrix prices matrix jobs into round "
                        "budgets and interleaves them with decode rounds")
    p.add_argument("--matrix-round-budget-s", type=float, default=0.01,
                   help="matrix quanta wall-clock slice granted "
                        "between decode rounds under mixed traffic")
    p.add_argument("--matrix-max-pending", type=int, default=8,
                   help="matrix job admission bound (429 beyond)")
    p.add_argument("--sched", action="store_true",
                   help="SLO-aware scheduler (serving/sched.py): the "
                        "default interactive/batch/best_effort class "
                        "table with EDF admission; preemption engages "
                        "when --kv-pages and --host-kv-bytes are also "
                        "set")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="supervisor restart budget before fail-closed")
    p.add_argument("--restart-window-s", type=float, default=60.0,
                   help="sliding window the restart budget counts in")
    p.add_argument("--poison-after", type=int, default=2,
                   help="crashes with one request in flight before it "
                        "is quarantined as poison")
    p.add_argument("--runlog", default=None,
                   help="stream engine runlog JSONL to this path")
    p.add_argument("--trace", action="store_true",
                   help=f"refused: {TRACER_REFUSAL}")
    p.add_argument("--trace-sample", type=float, default=None,
                   help=f"refused: {TRACER_REFUSAL}")
    p.add_argument("--trace-exemplar-k", type=int, default=None,
                   help=f"refused: {TRACER_REFUSAL}")
    p.add_argument("--trace-flight-k", type=int, default=None,
                   help=f"refused: {TRACER_REFUSAL}")
    p.add_argument("--trace-export", default=None,
                   help=f"refused: {TRACER_REFUSAL}")
    p.add_argument("--force-cpu", action="store_true",
                   help="serve on the CPU instead of the card")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: shard the model over "
                        "this many devices (one process spanning the "
                        "worker group; on the CPU, that many shards)")
    p.add_argument("--tp-mode", default="gather",
                   choices=("gather", "psum"),
                   help="TP reassembly: 'gather' (bit-exact vs tp=1) "
                        "or 'psum' (fewer collectives, allclose-only)")
    args = p.parse_args(argv)
    if args.trace or args.trace_export is not None or any(
            v is not None for v in (args.trace_sample,
                                    args.trace_exemplar_k,
                                    args.trace_flight_k)):
        p.error(f"--trace*: {TRACER_REFUSAL}")

    from ..models import transformer as tr
    from ..obs.runlog import RunLog
    from .sched import Scheduler

    device = "cpu" if (args.force_cpu or os.environ.get(
        "MARLIN_SERVE_FORCE_CPU")) else "cuda"
    cfg = tr.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model,
        max_len=args.max_len, dtype="float32",
        tp=args.tp, tp_mode=args.tp_mode)
    params = tr.init_params(cfg, seed=args.seed, device=device)
    runlog = RunLog(path=args.runlog) if args.runlog else None
    # Chaos arming: a JSON fault plan in MARLIN_FAULT_PLAN; absent, a
    # no-op.
    plan = faults.install_from_env()
    if plan is not None and runlog is not None:
        runlog.emit("fault_plan", specs=plan.summary())
    server = serve(params, cfg, host=args.host, port=args.port,
                   batch=args.batch, round_steps=args.round_steps,
                   max_pending=args.max_pending,
                   temperature=args.temperature, seed=args.seed,
                   max_restarts=args.max_restarts,
                   restart_window_s=args.restart_window_s,
                   poison_after=args.poison_after,
                   matrix=args.matrix,
                   matrix_round_budget_s=args.matrix_round_budget_s,
                   matrix_max_pending=args.matrix_max_pending,
                   device=device,
                   # `is not None`: an empty RunLog is falsy (__len__).
                   **({"runlog": runlog} if runlog is not None else {}),
                   **({"kv_pages": args.kv_pages}
                      if args.kv_pages is not None else {}),
                   **({"prefill_chunk": args.prefill_chunk}
                      if args.prefill_chunk is not None else {}),
                   **({"host_kv_bytes": args.host_kv_bytes}
                      if args.host_kv_bytes is not None else {}),
                   **({"host_kv_dir": args.spill_dir}
                      if args.spill_dir is not None else {}),
                   **({"restore_min_tokens": args.restore_min_tokens}
                      if args.restore_min_tokens is not None else {}),
                   **({"scheduler": Scheduler()} if args.sched else {}))
    drained = install_signal_handlers(server)
    print(f"SERVING host={args.host} port={server.port}", flush=True)
    try:
        server.serve_forever()
    finally:
        # serve_forever returns through the drain's shutdown(); wait for
        # the drain to seal before reporting.
        drained.wait(60.0)
    print("DRAINED", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
