"""Deterministic fault injection for the serving engine — the part of
``marlin_tpu/serving/faults.py`` the default engine path reads.

Injection sites call :func:`check` (raise or sleep) or :func:`corrupt`
(scribble a sentinel into a fetched host array); each is keyed on the
engine's own deterministic coordinates (round index, request id), so a
fault scenario replays. With no plan installed a site costs one ``None``
test.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from ..obs import metrics as obs_metrics

# The sites the ported engine carries (the JAX package names more).
SITES = ("decode_round", "prefill_chunk", "admission_pop", "runlog_emit")
ACTIONS = ("raise", "delay", "corrupt")


class FaultInjected(RuntimeError):
    """The exception an ``action="raise"`` spec throws."""


class EngineStateCorrupt(RuntimeError):
    """A device fetch failed the engine's sanity bounds; the engine
    raises instead of scheduling on garbage."""


@dataclasses.dataclass
class FaultSpec:
    """One rule: WHERE (``site``), WHAT (``action``) and WHEN (an exact
    ``round``, a ``round_every`` modulus and/or a ``request_id``; None
    means any), at most ``max_fires`` times."""

    site: str
    action: str = "raise"
    round: Optional[int] = None
    round_every: Optional[int] = None
    request_id: Optional[int] = None
    max_fires: int = 1
    delay_s: float = 0.05
    message: str = ""
    fires: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {SITES}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"actions: {ACTIONS}")
        if self.max_fires < 1:
            raise ValueError(f"max_fires must be >= 1, got "
                             f"{self.max_fires}")
        if self.round_every is not None and self.round_every < 1:
            raise ValueError(f"round_every must be >= 1, got "
                             f"{self.round_every}")

    def matches(self, site: str, round_idx: Optional[int],
                request_id: Optional[int]) -> bool:
        if self.site != site or self.fires >= self.max_fires:
            return False
        if self.round is not None and round_idx != self.round:
            return False
        if self.round_every is not None and (
                round_idx is None or round_idx % self.round_every):
            return False
        if self.request_id is not None and request_id != self.request_id:
            return False
        return True


class FaultPlan:
    """An ordered set of :class:`FaultSpec` rules sharing one firing
    lock. Build with ``plan.add(site=..., ...)``; activate with
    :func:`install`."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None):
        self.specs: List[FaultSpec] = list(specs or [])
        self._lock = threading.Lock()

    def add(self, **kw) -> FaultSpec:
        spec = FaultSpec(**kw)
        with self._lock:
            self.specs.append(spec)
        return spec

    def _fire(self, site: str, actions, round_idx, request_id):
        with self._lock:  # match and count as one atomic decision
            for spec in self.specs:
                if spec.action in actions and spec.matches(
                        site, round_idx, request_id):
                    spec.fires += 1
                    obs_metrics.registry.counter(
                        "serving_faults_injected_total", site=site,
                        help="chaos faults fired, by injection site",
                    ).inc()
                    return spec
        return None

    def check(self, site: str, round_idx: Optional[int] = None,
              request_id: Optional[int] = None) -> None:
        spec = self._fire(site, ("raise", "delay"), round_idx, request_id)
        if spec is None:
            return
        if spec.action == "delay":
            time.sleep(spec.delay_s)
            return
        raise FaultInjected(
            spec.message or f"injected fault at {site} "
            f"(round={round_idx}, request_id={request_id})")

    def corrupt(self, site: str, arr, round_idx: Optional[int] = None,
                request_id: Optional[int] = None):
        """A copy of ``arr`` with a -1 sentinel when a ``corrupt`` spec
        matches (outside every legal range, so it is detected); else
        ``arr`` untouched."""
        spec = self._fire(site, ("corrupt",), round_idx, request_id)
        if spec is None:
            return arr
        out = np.array(arr)
        out.flat[:1] = -1
        return out

    def total_fires(self) -> int:
        with self._lock:
            return sum(s.fires for s in self.specs)


_plan: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Activate ``plan`` process-wide; pair with :func:`reset`."""
    global _plan
    _plan = plan
    return plan


def reset() -> None:
    global _plan
    _plan = None


def check(site: str, round_idx: Optional[int] = None,
          request_id: Optional[int] = None) -> None:
    """Hot-path site hook: no-op unless a plan is installed."""
    if _plan is None:
        return
    _plan.check(site, round_idx=round_idx, request_id=request_id)


def corrupt(site: str, arr, round_idx: Optional[int] = None,
            request_id: Optional[int] = None):
    """Hot-path fetch hook: identity unless a plan is installed."""
    if _plan is None:
        return arr
    return _plan.corrupt(site, arr, round_idx=round_idx,
                         request_id=request_id)
