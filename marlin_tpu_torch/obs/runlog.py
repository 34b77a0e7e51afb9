"""Bounded structured event log (JSONL) for the serving engine — the
counterpart of ``marlin_tpu/obs/runlog.py``, with the same event shape:
one flat dict per event with a ``kind``, a monotonic timestamp ``t`` and
the caller's fields. With ``path`` set every event also streams to that
file; :meth:`RunLog.flush` is the drain path's durability point."""

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
        self._clock = clock
        self._events: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.path = str(path) if path is not None else None
        self._sink = open(self.path, "a") if self.path else None

    def emit(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "t": self._clock(), **fields}
        with self._lock:
            self._events.append(ev)
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

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]
