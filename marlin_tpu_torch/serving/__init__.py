"""Continuous-batching serving for the port: one-shot, chunked and paged
admission, the prefix cache and the page pool."""

from .engine import ServingEngine
from .pages import PAGE, PagePool
from .prefix import PagedPrefixIndex, PrefixCache, copy_kv_rows
from .queue import AdmissionQueue, QueueClosed, QueueFull, Request
from .slots import (SlotManager, pad_prompt_len, prefill_chunk_into_row,
                    prefill_chunk_into_row_paged, prefill_into_row)
from .stats import EngineStats, request_stats

__all__ = ["AdmissionQueue", "EngineStats", "PAGE", "PagePool",
           "PagedPrefixIndex", "PrefixCache", "QueueClosed", "QueueFull",
           "Request", "ServingEngine", "SlotManager", "copy_kv_rows",
           "pad_prompt_len", "prefill_chunk_into_row",
           "prefill_chunk_into_row_paged", "prefill_into_row",
           "request_stats"]
