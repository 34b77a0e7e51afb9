"""Labeled metrics: counters, gauges and fixed-bucket histograms — the
part of ``marlin_tpu/obs/metrics.py`` the serving engine and its ledger
call, with the same series names (``registry.counter("x", route="a")`` is
the ``route="a"`` child of counter family ``x``) and the same JSON
:meth:`MetricsRegistry.snapshot` view."""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Seconds-oriented default buckets (100 us .. 10 s).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter; ``lock`` is the owning registry's."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counters only go up; inc({by})")
        with self._lock:
            self.value += by


class Gauge:
    """Last-value gauge (occupancy, queue depth, utilization)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max; an implicit
    +Inf bucket catches the overflow. ``observe(v, exemplar=id)`` keeps
    ``id`` as the bucket's last exemplar."""

    __slots__ = ("buckets", "bucket_counts", "count", "sum", "min", "max",
                 "exemplars", "_lock")

    def __init__(self, buckets: Sequence[float], lock):
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)):
            raise ValueError(
                f"buckets must be non-empty, ascending, unique: {buckets}")
        self.buckets = bs
        self.bucket_counts = [0] * (len(bs) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.exemplars: Dict[int, str] = {}
        self._lock = lock

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        v = float(value)
        with self._lock:
            i = bisect.bisect_left(self.buckets, v)
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if exemplar is not None:
                self.exemplars[i] = str(exemplar)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count if self.count else 0.0,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": {
                    **{repr(b): c for b, c in zip(self.buckets,
                                                  self.bucket_counts)},
                    "+Inf": self.bucket_counts[-1],
                },
            }


class MetricsRegistry:
    """Named metric families, created on first use; thread-safe. Reusing
    a name with another kind raises."""

    def __init__(self):
        self._lock = threading.RLock()
        # name -> (kind, help, {label key: child})
        self._families: Dict[str, list] = {}

    def _child(self, kind: str, name: str, labels, help: str, make):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = [kind, str(help), {}]
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam[0]}, not a {kind}")
            elif help and not fam[1]:
                fam[1] = str(help)
            key = _label_key(labels)
            child = fam[2].get(key)
            if child is None:
                child = fam[2][key] = make()
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, labels, help,
                           lambda: Counter(self._lock))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, labels, help,
                           lambda: Gauge(self._lock))

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  help: str = "", **labels) -> Histogram:
        return self._child("histogram", name, labels, help,
                           lambda: Histogram(buckets, self._lock))

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view: counters/gauges as {series: value}, histograms
        as {series: {count, sum, mean, min, max, buckets}}."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for name, (kind, _, children) in self._families.items():
                dest = out[kind + "s"]
                for key, child in children.items():
                    dest[_series(name, key)] = (
                        child.summary() if kind == "histogram"
                        else child.value)
        return out


# The process-default registry (the engine's unless a caller wires one).
registry = MetricsRegistry()
