"""Analytic costs (the part of ``marlin_tpu/utils/cost_model.py`` on the
ported paths): the decode-step and admission rooflines and the
measured-vs-predicted drift ledger the serving engine reads, the
flash-attention tile accounting and training-step FLOPs that
chip_smoke.py reads, and the dense GEMM's local and SUMMA costs."""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from ..ops.flash_attention import KERNEL_TILES


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


# -- flash attention tile accounting ----------------------------------------
#
# The CUDA kernels' own plan (csrc/flash_attention_fwd.cu and _bwd.cu):
# their own tiles (KERNEL_TILES, not the TPU's 1024-row VMEM blocks; the
# forward's 128 x 128 by default here, since these functions describe the
# forward's loads), and each query tile visits only the key tiles of its
# causal or window band, so every visited tile pair is live.


def _block_live(i: int, j: int, *, causal: bool, block_q: int,
                block_k: int, window: int) -> bool:
    """The JAX kernels' tile-liveness predicate: causal drops tiles
    strictly above the diagonal, a window those strictly below its band."""
    run = (i * block_q + block_q - 1 >= j * block_k) if causal else True
    if window:
        run = run and (j * block_k + block_k - 1 > i * block_q - window)
    return bool(run)


def attention_block_counts(s: int, block_q: Optional[int] = None,
                           block_k: Optional[int] = None, window: int = 0,
                           causal: bool = True,
                           kv_len: Optional[int] = None) -> dict:
    """Tile accounting of the port's flash kernels at (S queries, kv_len
    keys): ``visited`` = tile pairs the kernel loads (each query tile's
    key sweep: causal stops after the tile's last row, a window starts at
    the band's first key tile), ``live`` = pairs passing the liveness
    predicate. Tiles default to the forward kernel's."""
    block_q = block_q or KERNEL_TILES["fwd"][0]
    block_k = block_k or KERNEL_TILES["fwd"][1]
    kv_len = kv_len if kv_len is not None else s
    n_q = -(-s // block_q)
    n_k = -(-kv_len // block_k)
    visited = 0
    live = 0
    for i in range(n_q):
        hi = n_k
        if causal:
            hi = min(n_k, -(-min(kv_len, (i + 1) * block_q) // block_k))
        lo = 0
        if window:
            lo = max(0, i * block_q - window + 1) // block_k
        for j in range(lo, hi):
            visited += 1
            live += _block_live(i, j, causal=causal, block_q=block_q,
                                block_k=block_k, window=window)
    return {"n_q": n_q, "n_k": n_k, "visited": visited, "live": live}


def flash_attention_cost(s: int, h: int, d: int,
                         block_q: Optional[int] = None,
                         block_k: Optional[int] = None, window: int = 0,
                         causal: bool = True,
                         itemsize: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of the flash forward at (S, H, D): 4*bq*bk*D FLOPs
    (Q K^T + P V) per live tile pair per head; bytes stream one K and one
    V tile per visited pair plus one Q read and one output write per
    query tile. Tiles default to the forward kernel's."""
    block_q = block_q or KERNEL_TILES["fwd"][0]
    block_k = block_k or KERNEL_TILES["fwd"][1]
    c = attention_block_counts(s, block_q, block_k, window=window,
                               causal=causal)
    flops = 4.0 * h * c["live"] * block_q * block_k * d
    byts = itemsize * h * (
        2 * c["visited"] * block_k * d      # K + V tiles per visited pair
        + c["n_q"] * block_q * d            # Q read once per query tile
        + c["n_q"] * block_q * d            # output write
    )
    return flops, float(byts)


def transformer_step_flops(n_params: int, batch: int, s: int,
                           n_layers: int, n_heads: int, d_head: int,
                           window: int = 0, block_q: int = 64,
                           block_k: int = 64) -> float:
    """Model FLOPs of one training step: ``6 * N * T`` for the matmuls
    plus the attention term it leaves out: per layer and sequence, the
    causal flash forward's live-tile FLOPs times 3.5 for forward and
    backward (2 forward products, 5 backward: the recomputed logits, dP,
    dV, dQ, dK), counted at 64 x 64 tiles whatever tiles the kernels use,
    so that model TFLOP/s stays comparable across kernel versions."""
    attn_fwd, _ = flash_attention_cost(s, n_heads, d_head, block_q,
                                       block_k, window=window, causal=True)
    return 6.0 * n_params * batch * s + 3.5 * batch * n_layers * attn_fwd


def gemm_cost(m: int, k: int, n: int, itemsize: int = 4
              ) -> Tuple[float, float]:
    """(flops, bytes) of a local C = A @ B, each operand crossing device
    memory once: A (m, k) and B (k, n) read, C (m, n) written."""
    return 2.0 * m * k * n, float(itemsize) * (m * k + k * n + m * n)


def summa_cost(m: int, k: int, n: int, pr: int, pc: int,
               itemsize: int = 4) -> Tuple[float, float]:
    """Per-device (flops, bytes) of the all-gather SUMMA engine on a
    (pr x pc) mesh: each device gathers A's row panel (m/pr, k) and B's
    column panel (k, n/pc) and writes its (m/pr, n/pc) block."""
    flops = 2.0 * (m / pr) * k * (n / pc)
    byts = itemsize * ((m / pr) * k + k * (n / pc) + (m / pr) * (n / pc))
    return flops, float(byts)
