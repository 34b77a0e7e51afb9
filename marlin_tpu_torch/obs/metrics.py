"""Labeled metrics: counters, gauges and fixed-bucket histograms — the
part of ``marlin_tpu/obs/metrics.py`` the serving engine, its ledger and
the HTTP server call, with the same series names
(``registry.counter("x", route="a")`` is the ``route="a"`` child of
counter family ``x``) and the same two exports: the JSON
:meth:`MetricsRegistry.snapshot` view and the Prometheus text exposition
(:meth:`MetricsRegistry.prometheus`, version 0.0.4, byte for byte the
reference's for the same series), which ``GET /metrics`` serves."""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Seconds-oriented default buckets (100 us .. 10 s).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset (op-timing labels
    like ``DenseVecMatrix.multiply`` carry dots)."""
    return _NAME_RE.sub("_", name)


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

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self.value += by

    def dec(self, by: float = 1.0) -> None:
        with self._lock:
            self.value -= by


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

    def _bucket_repr(self, i: int) -> str:
        return repr(self.buckets[i]) if i < len(self.buckets) else "+Inf"

    def summary(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
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
            if self.exemplars:
                out["exemplars"] = {self._bucket_repr(i): x
                                    for i, x in self.exemplars.items()}
        return out


class MetricsRegistry:
    """Named metric families, created on first use; thread-safe. Reusing
    a name with another kind raises; a histogram family keeps the bucket
    layout of its first call."""

    def __init__(self):
        self._lock = threading.RLock()
        # name -> [kind, help, {label key: child}, buckets]
        self._families: Dict[str, list] = {}

    def _child(self, kind: str, name: str, labels, help: str,
               buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = [
                    kind, str(help), {},
                    tuple(buckets) if buckets else None]
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam[0]}, not a {kind}")
            elif help and not fam[1]:
                fam[1] = str(help)
            key = _label_key(labels)
            child = fam[2].get(key)
            if child is None:
                child = fam[2][key] = (
                    Counter(self._lock) if kind == "counter"
                    else Gauge(self._lock) if kind == "gauge"
                    else Histogram(fam[3], self._lock))
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, labels, help)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  help: str = "", **labels) -> Histogram:
        return self._child("histogram", name, labels, help, buckets)

    def remove(self, name: str) -> None:
        """Forget the metric family ``name`` (all its series)."""
        with self._lock:
            self._families.pop(name, None)

    def reset(self) -> None:
        """Forget every family."""
        with self._lock:
            self._families.clear()

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view: counters/gauges as {series: value}, histograms
        as {series: {count, sum, mean, min, max, buckets}}."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for name, (kind, _, children, _) in self._families.items():
                dest = out[kind + "s"]
                for key, child in children.items():
                    dest[_series(name, key)] = (
                        child.summary() if kind == "histogram"
                        else child.value)
        return out

    def dump(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): ``# HELP`` (when
        the family has one) and ``# TYPE`` a family, cumulative
        ``_bucket{le=...}`` lines and ``_sum``/``_count`` for histograms.
        Names are sanitized to the Prometheus charset; help text escapes
        backslash and newline."""
        lines = []
        with self._lock:
            for name in sorted(self._families):
                kind, help_, children, _ = self._families[name]
                pname = _prom_name(name)
                if help_:
                    esc = help_.replace("\\", "\\\\").replace("\n", "\\n")
                    lines.append(f"# HELP {pname} {esc}")
                lines.append(f"# TYPE {pname} {kind}")
                for key in sorted(children):
                    child = children[key]
                    if kind != "histogram":
                        lines.append(
                            f"{_series(pname, key)} {child.value:g}")
                        continue
                    cum = 0
                    for b, c in zip(child.buckets, child.bucket_counts):
                        cum += c
                        lk = key + (("le", f"{b:g}"),)
                        lines.append(
                            f"{_series(pname + '_bucket', lk)} {cum}")
                    lk = key + (("le", "+Inf"),)
                    lines.append(
                        f"{_series(pname + '_bucket', lk)} {child.count}")
                    lines.append(
                        f"{_series(pname + '_sum', key)} {child.sum:g}")
                    lines.append(
                        f"{_series(pname + '_count', key)} {child.count}")
        return "\n".join(lines) + "\n"


# The process-default registry (the engine's unless a caller wires one).
registry = MetricsRegistry()


def snapshot() -> Dict[str, object]:
    return registry.snapshot()


def prometheus() -> str:
    return registry.prometheus()
