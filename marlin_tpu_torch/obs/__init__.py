"""Observability for the port: metrics, host spans, the run log and the
cross-process trace context."""

from . import distributed
from .distributed import TraceContext
from .metrics import MetricsRegistry, registry
from .runlog import RunLog
from .trace import Tracer, tracer

__all__ = ["MetricsRegistry", "RunLog", "TraceContext", "Tracer",
           "distributed", "registry", "tracer"]
