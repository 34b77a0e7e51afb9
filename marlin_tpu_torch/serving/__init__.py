"""Continuous-batching serving for the port (default discipline)."""

from .engine import ServingEngine
from .queue import AdmissionQueue, QueueClosed, QueueFull, Request
from .slots import SlotManager, pad_prompt_len, prefill_into_row
from .stats import EngineStats, request_stats

__all__ = ["AdmissionQueue", "EngineStats", "QueueClosed", "QueueFull",
           "Request", "ServingEngine", "SlotManager", "pad_prompt_len",
           "prefill_into_row", "request_stats"]
