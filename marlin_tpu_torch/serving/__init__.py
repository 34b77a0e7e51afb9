"""Continuous-batching serving for the port: one-shot, chunked and paged
admission, the prefix cache and the page pool, the host KV tier and SLO
scheduling with preemption."""

from .engine import ServingEngine
from .pages import PAGE, HostKVTier, PagePool
from .prefix import PagedPrefixIndex, PrefixCache, copy_kv_rows
from .queue import AdmissionQueue, QueueClosed, QueueFull, Request
from .sched import DEFAULT_CLASSES, ClassSpec, FrozenRow, Scheduler
from .slots import (SlotManager, pad_prompt_len, prefill_chunk_into_row,
                    prefill_chunk_into_row_paged, prefill_into_row,
                    restore_pages_into_pool, restore_row_tokens)
from .stats import EngineStats, request_stats

__all__ = ["AdmissionQueue", "ClassSpec", "DEFAULT_CLASSES", "EngineStats",
           "FrozenRow", "HostKVTier", "PAGE", "PagePool",
           "PagedPrefixIndex", "PrefixCache", "QueueClosed", "QueueFull",
           "Request", "Scheduler", "ServingEngine", "SlotManager",
           "copy_kv_rows", "pad_prompt_len", "prefill_chunk_into_row",
           "prefill_chunk_into_row_paged", "prefill_into_row",
           "request_stats", "restore_pages_into_pool",
           "restore_row_tokens"]
