"""Nested host spans with Chrome/Perfetto export — the part of
``marlin_tpu/obs/trace.py`` the engine and ``generate`` call, with the
same span names (``transformer.generate``, ``transformer.prefill``,
``serving.round``, ...).

A span mirrors into ``torch.profiler.record_function`` so that, under a
``torch.profiler`` trace, host spans land on the same timeline as the
CUDA kernels they launched (the JAX package mirrored into
``jax.profiler.TraceAnnotation``). The default :data:`tracer` starts
disabled, and a span on a disabled tracer is a bare ``yield``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List

import torch


class Tracer:
    """Bounded in-memory span recorder (``trace_event`` complete events,
    microsecond timestamps); spans nest per thread."""

    def __init__(self, enabled: bool = False, max_events: int = 100_000):
        self._enabled = bool(enabled)
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record one nested span; a no-op while disabled."""
        if not self._enabled:
            yield
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dur = time.perf_counter_ns() - t0
            stack.pop()
            args: Dict[str, Any] = dict(attrs)
            args["depth"] = len(stack)
            if parent is not None:
                args["parent"] = parent
            ev = {"name": name, "ph": "X",
                  "ts": (t0 - self._epoch_ns) / 1e3, "dur": dur / 1e3,
                  "pid": 0, "tid": threading.get_ident() % (1 << 31),
                  "args": args}
            with self._lock:
                self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def export(self, path) -> str:
        """Write Chrome/Perfetto trace-event JSON; returns the path."""
        path = str(path)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, f, default=str)
        return path


# Process-default tracer: disabled (free) until someone enables it.
tracer = Tracer()
