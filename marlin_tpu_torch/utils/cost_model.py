"""Analytic costs the serving engine reads (the part of
``marlin_tpu/utils/cost_model.py`` on the serving path): the decode-step
and admission rooflines and the measured-vs-predicted drift ledger."""

from __future__ import annotations

import threading
from typing import Tuple


def transformer_param_count(cfg) -> int:
    """Parameter count of models/transformer.py's params (embed shared
    with the readout; per-block fused qkv / wo / mlp + biases / two LNs;
    final LN; learned positions unless rope)."""
    d, v, ff = cfg.d_model, cfg.vocab, cfg.d_ff
    kvd = cfg.kv_heads * (d // cfg.n_heads)
    mlp = d * ff + ff + ff * d + d  # w1 + b1 + w2 + b2
    per_block = d * (d + 2 * kvd) + d * d + mlp + 4 * d
    total = v * d + cfg.n_layers * per_block + 2 * d
    if not cfg.rope:
        total += cfg.max_len * d
    return int(total)


def decode_step_cost(cfg, batch: int, param_itemsize: int = 4,
                     cache_itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one decode step at batch ``batch``: the step
    streams the parameters once and the KV cache once (read every slot,
    write one). FLOPs: 2 * params * B for the matmuls plus the cache
    attention."""
    params = transformer_param_count(cfg)
    dh = cfg.d_model // cfg.n_heads
    cache_len = min(cfg.window, cfg.max_len) if cfg.window else cfg.max_len
    cache_elems = 2 * cfg.n_layers * batch * cache_len * cfg.kv_heads * dh
    flops = 2.0 * params * batch + 2.0 * 2.0 * cfg.n_layers * batch \
        * cache_len * cfg.kv_heads * dh * (cfg.n_heads // cfg.kv_heads)
    cache_bytes = float(cache_elems * cache_itemsize)
    byts = params * float(param_itemsize) + cache_bytes \
        + cache_bytes / cache_len
    return flops, float(byts)


def admission_cost(cfg, prompt_len: int,
                   param_itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one one-shot admission prefill of
    ``prompt_len`` positions: 2 * params per position plus the causal
    attention triangle; the parameters stream once, and each position
    writes its K/V to the cache."""
    params = transformer_param_count(cfg)
    dh = cfg.d_model // cfg.n_heads
    tri = prompt_len * (prompt_len + 1) / 2.0
    attn_macs = 2.0 * cfg.n_layers * cfg.n_heads * dh * tri
    flops = 2.0 * params * prompt_len + 2.0 * attn_macs
    pos_bytes = float(2 * cfg.n_layers * cfg.kv_heads * dh * param_itemsize)
    byts = params * float(param_itemsize) + prompt_len * pos_bytes
    return flops, float(byts)


class CostCalibration:
    """EWMA drift ledger: measured wall-clock vs model-predicted cost, per
    op class. ``record(op, predicted_units, measured_s)`` tracks seconds
    per model unit, takes the median of the first ``warmup`` samples as
    the baseline, then keeps an EWMA; ``drift(op)`` = EWMA / baseline
    (1.0 = the model still prices the op as it did at warm-up). Mirrored
    as ``cost_model_drift_ratio{op=...}`` gauges when a registry is
    attached."""

    def __init__(self, alpha: float = 0.2, warmup: int = 5,
                 registry=None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.registry = registry
        self._ops: dict = {}
        # RLock: record() reads drift() for the registry mirror while
        # holding it.
        self._lock = threading.RLock()

    def record(self, op: str, predicted_units: float,
               measured_s: float) -> None:
        """One sample; non-positive samples (an all-idle round predicts
        zero work) carry no ratio and are dropped."""
        if predicted_units <= 0 or measured_s <= 0:
            return
        r = measured_s / predicted_units
        with self._lock:
            st = self._ops.get(op)
            if st is None:
                st = self._ops[op] = {"n": 0, "window": [],
                                      "baseline": None, "ewma": None}
            st["n"] += 1
            if st["baseline"] is None:
                st["window"].append(r)
                w = sorted(st["window"])
                st["ewma"] = w[len(w) // 2]
                if len(st["window"]) >= self.warmup:
                    st["baseline"] = st["ewma"]
                    st["window"] = []
            else:
                st["ewma"] = self.alpha * r + (1 - self.alpha) * st["ewma"]
            if self.registry is not None:
                self.registry.gauge(
                    "cost_model_drift_ratio", op=op,
                    help="EWMA(measured s per model unit) / warmup "
                         "baseline per op class",
                ).set(self.drift(op))

    def drift(self, op: str) -> float:
        with self._lock:
            st = self._ops.get(op)
            if st is None or not st["baseline"]:
                return 1.0
            return st["ewma"] / st["baseline"]

    def summary(self) -> dict:
        with self._lock:
            return {
                op: {
                    "samples": st["n"],
                    "sec_per_unit_ewma": st["ewma"],
                    "sec_per_unit_baseline": st["baseline"],
                    "drift_ratio": round(self.drift(op), 4),
                }
                for op, st in self._ops.items()
            }
