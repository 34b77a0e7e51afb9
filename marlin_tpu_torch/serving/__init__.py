"""Continuous-batching serving for the port: one-shot, chunked and paged
admission, the prefix cache and the page pool, the host KV tier and SLO
scheduling with preemption, the supervised driver that recovers the
engine from a crash (``EngineFrontend``), the matrix-ops job service
(``MatrixService``) and the HTTP server (``serve``)."""

from . import faults
from .engine import ServingEngine
from .faults import (EngineStateCorrupt, FaultInjected, FaultPlan,
                     FaultSpec)
from .frontend import (EngineFailed, EngineFrontend, FrontendError,
                       FrontendRequest, PoisonedRequest)
from .jobs import (MatrixJobError, MatrixJobHandle, MatrixJobSpec,
                   MatrixService, matrix_compute)
from .pages import PAGE, HostKVTier, PagePool
from .prefix import PagedPrefixIndex, PrefixCache, copy_kv_rows
from .queue import AdmissionQueue, QueueClosed, QueueFull, Request
from .sched import DEFAULT_CLASSES, ClassSpec, FrozenRow, Scheduler
from .server import ServingHTTPServer, install_signal_handlers, serve
from .slots import (SlotManager, pad_prompt_len, prefill_chunk_into_row,
                    prefill_chunk_into_row_paged, prefill_into_row,
                    restore_pages_into_pool, restore_row_tokens)
from .stats import (EngineStats, request_stats, static_completed_at_budget,
                    static_schedule_iters)

__all__ = ["AdmissionQueue", "ClassSpec", "DEFAULT_CLASSES", "EngineFailed",
           "EngineFrontend", "EngineStateCorrupt", "EngineStats",
           "FaultInjected", "FaultPlan", "FaultSpec", "FrontendError",
           "FrontendRequest", "FrozenRow", "HostKVTier", "MatrixJobError",
           "MatrixJobHandle", "MatrixJobSpec", "MatrixService", "PAGE",
           "PagePool", "PagedPrefixIndex", "PoisonedRequest", "PrefixCache",
           "QueueClosed", "QueueFull", "Request", "Scheduler",
           "ServingEngine", "ServingHTTPServer", "SlotManager",
           "copy_kv_rows", "faults", "install_signal_handlers",
           "matrix_compute", "pad_prompt_len", "prefill_chunk_into_row",
           "prefill_chunk_into_row_paged", "prefill_into_row",
           "request_stats", "restore_pages_into_pool",
           "restore_row_tokens", "serve", "static_completed_at_budget",
           "static_schedule_iters"]
