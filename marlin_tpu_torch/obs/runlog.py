"""Bounded structured event log (JSONL) for the serving engine — the
counterpart of ``marlin_tpu/obs/runlog.py``, with the same event shape:
one flat dict per event with a ``kind``, a monotonic timestamp ``t`` and
the caller's fields. With ``path`` set every event also streams to that
file; :meth:`RunLog.flush` is the drain path's durability point.
:meth:`RunLog.dumps` and :meth:`RunLog.dump` export the retained window
as JSON Lines, the input of ``tools/runlog_report.py``."""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional


class RunLog:
    """Thread-safe bounded structured event log."""

    def __init__(self, maxlen: int = 4096, clock=time.monotonic,
                 path=None):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self._clock = clock
        self._events: deque = deque(maxlen=maxlen)
        self._n_emitted = 0  # exact, unlike len() past the cap
        self._lock = threading.Lock()
        self.path = str(path) if path is not None else None
        self._sink = open(self.path, "a") if self.path else None

    def emit(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "t": self._clock(), **fields}
        with self._lock:
            self._events.append(ev)
            self._n_emitted += 1
            if self._sink is not None:
                self._sink.write(json.dumps(ev, default=str) + "\n")
        return ev

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()
                os.fsync(self._sink.fileno())

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()
                self._sink.close()
                self._sink = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def n_emitted(self) -> int:
        """Events emitted over the log's life (the deque keeps the last
        ``maxlen``)."""
        with self._lock:
            return self._n_emitted

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dumps(self) -> str:
        """JSON Lines: one event per line."""
        return "\n".join(json.dumps(e, default=str) for e in self.events())

    def dump(self, path) -> str:
        path = str(path)
        with open(path, "w") as f:
            text = self.dumps()
            if text:
                f.write(text + "\n")
        return path
