"""Op timing, metrics and profiler hooks: port of
``marlin_tpu/utils/timing.py``.

``Metrics``, ``timed`` and ``timeit`` keep the reference's API and record
into the port's ``obs.metrics.registry``; ``fence`` waits for the card
(``torch.cuda.synchronize``) where the reference fetched a scalar, and
``profile_trace`` is ``torch.profiler`` where it was ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Any, Dict, Mapping, Optional

import torch

from ..obs import metrics as _obs_metrics


def fence(*items) -> None:
    """Wait for the device work behind ``items`` (tensors, distributed
    matrices or vectors): the ``MTUtils.evaluate`` counterpart. CPU work
    is already done when the call returns."""
    for x in items:
        local = getattr(x, "local", x)
        if isinstance(local, torch.Tensor) and local.is_cuda:
            torch.cuda.synchronize(local.device)


class Metrics:
    """The reference's registry API over ``obs.metrics``: counters and
    timing histograms; ``summary()`` gives ``{"counters": ...,
    "timings": {name: {count, total_s, mean_s, min_s, max_s}}}``;
    ``reset()`` removes only the series this instance created."""

    def __init__(self, registry: Optional[_obs_metrics.MetricsRegistry]
                 = None):
        self._registry = registry if registry is not None \
            else _obs_metrics.registry
        self._counter_names: set = set()
        self._timing_names: set = set()

    @property
    def registry(self) -> _obs_metrics.MetricsRegistry:
        return self._registry

    @property
    def counters(self) -> Mapping[str, float]:
        """A read-only view; a counter that never fired reads 0.0."""
        from collections import defaultdict
        from types import MappingProxyType

        return MappingProxyType(
            defaultdict(float,
                        {n: self._registry.counter(n).value
                         for n in sorted(self._counter_names)}))

    def incr(self, name: str, by: float = 1.0) -> None:
        self._counter_names.add(name)
        self._registry.counter(name).inc(by)

    def record(self, name: str, seconds: float) -> None:
        self._timing_names.add(name)
        self._registry.histogram(name).observe(seconds)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": dict(self.counters),
                               "timings": {}}
        for name in sorted(self._timing_names):
            h = self._registry.histogram(name)
            if not h.count:
                continue
            out["timings"][name] = {"count": h.count, "total_s": h.sum,
                                    "mean_s": h.sum / h.count,
                                    "min_s": h.min, "max_s": h.max}
        return out

    def dump(self) -> str:
        import json

        return json.dumps(self.summary(), indent=2, sort_keys=True)

    def reset(self) -> None:
        for name in self._counter_names | self._timing_names:
            self._registry.remove(name)
        self._counter_names.clear()
        self._timing_names.clear()


metrics = Metrics()


@contextlib.contextmanager
def timed(name: str, *fence_items, verbose: bool = False):
    """Time a block, fencing the listed items before stopping the clock;
    records a timing sample and ``{name}.calls``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        fence(*fence_items)
        dt = time.perf_counter() - t0
        metrics.record(name, dt)
        metrics.incr(f"{name}.calls")
        if verbose:
            print(f"[marlin_tpu_torch] {name}: {dt * 1e3:.2f} ms")


def timeit(fn=None, *, name: Optional[str] = None):
    """Decorator form of :func:`timed`; fences what the function
    returns inside the timed block."""

    def wrap(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            with timed(label):
                out = f(*args, **kwargs)
                fence(out)
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` around a block (CPU and, where there is one, the
    card); the Chrome trace goes to ``log_dir``/trace.json (default: a
    directory under the temp dir). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "marlin_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
