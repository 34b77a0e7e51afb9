"""Observability for the port: metrics, host spans, the run log."""

from .metrics import MetricsRegistry, registry
from .runlog import RunLog
from .trace import Tracer, tracer

__all__ = ["MetricsRegistry", "RunLog", "Tracer", "registry", "tracer"]
