"""Trace-context propagation across processes: the port's own copy of
``marlin_tpu/obs/distributed.py`` (stdlib only), the wire format the
fleet's front door and a replica's HTTP server share.

The ``X-Trace-Context`` header is W3C-traceparent-shaped
(``00-{trace_id}-{span_id}-{flag}``: a 32-hex trace id, the caller's
16-hex span id, ``01``/``00`` sampled), with DERIVED ids: serving code
draws no entropy (a replayed request reproduces its run), so
:func:`trace_id_for` hashes the router-minted request id, unique within a
fleet run. Two runs of one workload mint the same trace ids.

The server (serving/server.py) decodes the header with :func:`parse` and
records the trace id and the sampled flag on the request's ``trace_ctx``
run-log event; the spans that would join the caller's trace wait for the
tracer of ROADMAP Queue A5.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Optional

# Namespaced X- because the ids are deterministic, not 128-bit random.
TRACE_HEADER = "X-Trace-Context"

_VERSION = "00"
_HEADER_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def trace_id_for(request_id) -> str:
    """32-hex trace id derived from the router-minted request id."""
    digest = hashlib.sha1(
        f"marlin-trace:{request_id}".encode("utf-8")).hexdigest()
    return digest[:32]


def span_id_for(trace_id: str, name: str) -> str:
    """16-hex span id derived from (trace_id, span name)."""
    digest = hashlib.sha1(
        f"{trace_id}:{name}".encode("utf-8")).hexdigest()
    return digest[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's view of a distributed trace: the trace id, the caller's
    span id (the remote parent) and the sampling verdict drawn once at
    the front door."""

    trace_id: str
    span_id: str
    sampled: bool

    def to_header(self) -> str:
        flag = "01" if self.sampled else "00"
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{flag}"


def mint(request_id, sampled: bool) -> TraceContext:
    """Front-door mint: the trace id from the router-assigned request id,
    the parent span the front door's ``fleet.request``."""
    trace_id = trace_id_for(request_id)
    return TraceContext(
        trace_id=trace_id,
        span_id=span_id_for(trace_id, "fleet.request"),
        sampled=bool(sampled),
    )


def parse(header: Optional[str]) -> Optional[TraceContext]:
    """Decode an ``X-Trace-Context`` header; a missing, malformed or
    future-versioned header, or an all-zero id, yields None (the request
    is traced standalone) rather than a rejected request."""
    if not header:
        return None
    m = _HEADER_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version != _VERSION:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id,
                        sampled=bool(int(flags, 16) & 0x01))
