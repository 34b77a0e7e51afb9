"""Analytic costs (the part of ``marlin_tpu/utils/cost_model.py`` on the
ported paths): the decode-step (and its tensor-parallel split),
speculative-round and admission rooflines
(with the int8 weights' and cache's bytes), the acceptance-adaptive
draft-length policy and the measured-vs-predicted drift ledger the serving
engine reads, the host KV tier's restore and preemption prices and its
measured restore-or-re-prefill crossover, the
flash-attention tile accounting and training-step FLOPs that
chip_smoke.py reads, the dense GEMM's local and SUMMA costs, and the
matrix service's job prices (``matrix_job_cost``, ``matrix_round_budget``,
with ``ell_product_cost``)."""

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


def quantized_weight_counts(cfg) -> Tuple[int, int]:
    """(int8 elements, f32 scales) of ``models/quant.quantize_params_int8``
    on this config: the embed table (a scale a row) and each block's
    dense 2-D weights (a scale an output channel)."""
    d, ff = cfg.d_model, cfg.d_ff
    kvd = cfg.kv_heads * (d // cfg.n_heads)
    q = cfg.vocab * d
    s = cfg.vocab
    for qe, se in ((d * (d + 2 * kvd), d + 2 * kvd), (d * d, d),
                   (d * ff, ff), (ff * d, d)):
        q += cfg.n_layers * qe
        s += cfg.n_layers * se
    return q, s


def _param_bytes(cfg, param_itemsize: int, quant_weights: bool) -> float:
    """Bytes one pass streams of the parameters: int8 weights at 1 byte
    an element, their scales and every float leaf at ``param_itemsize``
    (the compute dtype the scales are cast to)."""
    params = transformer_param_count(cfg)
    if not quant_weights:
        return float(params * param_itemsize)
    q_elems, n_scales = quantized_weight_counts(cfg)
    return q_elems * 1.0 + (n_scales + params - q_elems) \
        * float(param_itemsize)


def _cache_bytes(cfg, batch: int, cache_itemsize: int) -> Tuple[float, int]:
    """(bytes of the whole KV cache, its slots a sequence): int8 slots
    plus one f32 scale a (Dh,) vector when ``cfg.kv_quant``."""
    dh = cfg.d_model // cfg.n_heads
    cache_len = min(cfg.window, cfg.max_len) if cfg.window else cfg.max_len
    cache_elems = 2 * cfg.n_layers * batch * cache_len * cfg.kv_heads * dh
    if getattr(cfg, "kv_quant", ""):
        return cache_elems * 1.0 + (cache_elems // dh) * 4.0, cache_len
    return float(cache_elems * cache_itemsize), cache_len


def decode_step_cost(cfg, batch: int, param_itemsize: int = 4,
                     cache_itemsize: int = 4,
                     quant_weights: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one decode step at batch ``batch``: the step
    streams the parameters once and the KV cache once (read every slot,
    write one). FLOPs: 2 * params * B for the matmuls plus the cache
    attention. ``cfg.kv_quant == "int8"`` prices the cache at 1 byte an
    element plus an f32 scale a vector (``cache_itemsize`` unused);
    ``quant_weights`` the int8 params (:func:`_param_bytes`)."""
    params = transformer_param_count(cfg)
    dh = cfg.d_model // cfg.n_heads
    cache_bytes, cache_len = _cache_bytes(cfg, batch, cache_itemsize)
    flops = 2.0 * params * batch + 2.0 * 2.0 * cfg.n_layers * batch \
        * cache_len * cfg.kv_heads * dh * (cfg.n_heads // cfg.kv_heads)
    byts = _param_bytes(cfg, param_itemsize, quant_weights) + cache_bytes \
        + cache_bytes / cache_len
    return flops, float(byts)


def _tp_replicated_params(cfg) -> int:
    """Leaves the gather-mode TP layout REPLICATES (models/tp.py
    param_specs): the embed/readout table, the final LN, and the learned
    position table; everything else (per-block matmuls and their
    biases) is split over the ``model`` axis."""
    d = cfg.d_model
    rep = cfg.vocab * d + 2 * d
    if not cfg.rope:
        rep += cfg.max_len * d
    return int(rep)


def tp_decode_step_cost(cfg, batch: int, tp: Optional[int] = None,
                        param_itemsize: int = 4,
                        cache_itemsize: int = 4,
                        quant_weights: bool = False
                        ) -> Tuple[float, float]:
    """Per-SHARD (flops, bytes) of one decode step under gather-mode
    tensor parallelism at degree ``tp`` (default ``cfg.tp``).

    Amdahl split of :func:`decode_step_cost`: the per-block matmuls and
    the cache attention shard over the ``model`` axis (heads, KV-head
    groups, MLP columns) and divide by ``tp``; the readout against the
    replicated embed table (and the replicated bias/LN/pos leaves bundled
    into the same ``2 * params * B`` pricing) runs in full on every
    shard. Bytes split the same way: replicated leaves stream on every
    shard, sharded weights and the head-sharded KV cache divide. At the
    typical serving shape the replicated share is the vocab readout, so
    the modeled scaling at TP=4 lands below 4.0 by that fraction."""
    flops1, bytes1 = decode_step_cost(
        cfg, batch, param_itemsize=param_itemsize,
        cache_itemsize=cache_itemsize, quant_weights=quant_weights)
    tp = int(getattr(cfg, "tp", 1) if tp is None else tp)
    if tp <= 1:
        return flops1, bytes1
    rep = _tp_replicated_params(cfg)
    rep_flops = 2.0 * rep * batch
    flops = rep_flops + (flops1 - rep_flops) / tp
    if quant_weights:
        # The embed table is quantized (one f32 scale a vocab row); the
        # other replicated leaves stay float.
        v, d = cfg.vocab, cfg.d_model
        rep_bytes = v * d * 1.0 + v * float(param_itemsize) \
            + (rep - v * d) * float(param_itemsize)
    else:
        rep_bytes = float(rep * param_itemsize)
    byts = rep_bytes + (bytes1 - rep_bytes) / tp
    return flops, float(byts)


def tp_decode_flop_scaling(cfg, batch: int, tp: int,
                           quant_weights: bool = False) -> float:
    """Modeled per-shard FLOP scaling of one decode step, TP=1 over
    TP=``tp``: set by the layout alone (what the replicated readout
    keeps), not by a measurement."""
    flops1, _ = decode_step_cost(cfg, batch, quant_weights=quant_weights)
    flops_tp, _ = tp_decode_step_cost(cfg, batch, tp=tp,
                                      quant_weights=quant_weights)
    return float(flops1 / flops_tp)


def spec_round_cost(cfg, batch: int, draft_len: int,
                    param_itemsize: int = 4, cache_itemsize: int = 4,
                    quant_weights: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of ONE speculative verify chunk at batch B and chunk
    width C = ``draft_len``: FLOPs C times a decode step's, but the
    parameters and the cache stream once a chunk; only the written slots
    grow C-fold. Int8 pricing is :func:`decode_step_cost`'s."""
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    flops1, _ = decode_step_cost(cfg, batch, param_itemsize=param_itemsize,
                                 cache_itemsize=cache_itemsize,
                                 quant_weights=quant_weights)
    cache_bytes, cache_len = _cache_bytes(cfg, batch, cache_itemsize)
    byts = _param_bytes(cfg, param_itemsize, quant_weights) + cache_bytes \
        + draft_len * cache_bytes / cache_len
    return float(flops1 * draft_len), float(byts)


def pick_draft_len(accept_rate: float, draft_lens, cfg, batch: int,
                   **cost_kwargs) -> int:
    """The acceptance-adaptive draft-length policy: over the engine's set
    of draft lengths, the C maximizing expected committed tokens per
    streamed byte at acceptance rate alpha, E[tokens] = sum_{k<C}
    alpha^k, bytes from :func:`spec_round_cost`. Ties go to the smallest
    C."""
    lens = sorted({int(c) for c in draft_lens})
    if not lens:
        raise ValueError("empty draft_lens")
    a = min(max(float(accept_rate), 0.0), 0.999)
    best, best_v = lens[0], -1.0
    for c in lens:
        _, byts = spec_round_cost(cfg, batch, c, **cost_kwargs)
        v = (1.0 - a ** c) / (1.0 - a) / byts
        if v > best_v * (1.0 + 1e-9):
            best, best_v = c, v
    return best


def _pos_bytes(cfg, itemsize: int) -> float:
    """Cache bytes of one position across every layer's K and V: int8
    slots plus one f32 scale a (Dh,) vector when ``cfg.kv_quant``."""
    dh = cfg.d_model // cfg.n_heads
    pos_elems = 2 * cfg.n_layers * cfg.kv_heads * dh
    if getattr(cfg, "kv_quant", ""):
        return pos_elems * 1.0 + (pos_elems // dh) * 4.0
    return float(pos_elems * itemsize)


def admission_cost(cfg, prompt_len: int, hit_len: int = 0,
                   chunk: Optional[int] = None,
                   param_itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one serving admission prefill of ``prompt_len``
    positions with a shared-prefix hit of ``hit_len`` (serving/prefix.py):
    only the tail [hit_len, prompt_len) is computed, and the hit's K/V
    are copied instead. ``hit_len == 0`` is a cold admission; the
    reclaimed cost of a hit is ``cost(s) - cost(s, hit_len=h)``.

    FLOPs: 2 * params per tail position plus the causal attention the
    tail computes, sum over p in [hit_len, prompt_len) of (p + 1) keys per
    head. Bytes: the parameters stream once per ``chunk`` of the tail
    (chunked admission re-reads them every chunk; default one stream),
    the tail writes its K/V, and the hit's copy reads and writes its
    K/V once each (an int8 cache at 1 byte a slot plus its scales)."""
    if not 0 <= hit_len <= prompt_len:
        raise ValueError(
            f"hit_len {hit_len} outside [0, {prompt_len}]")
    params = transformer_param_count(cfg)
    dh = cfg.d_model // cfg.n_heads
    tail = prompt_len - hit_len

    def tri(n):
        return n * (n + 1) / 2.0

    attn_macs = 2.0 * cfg.n_layers * cfg.n_heads * dh \
        * (tri(prompt_len) - tri(hit_len))
    flops = 2.0 * params * tail + 2.0 * attn_macs
    pos_bytes = _pos_bytes(cfg, param_itemsize)
    n_streams = -(-tail // chunk) if (chunk and tail) else (1 if tail else 0)
    byts = n_streams * params * float(param_itemsize) + tail * pos_bytes \
        + 2.0 * hit_len * pos_bytes
    return flops, float(byts)


# Floor of the host KV tier's restore-or-re-prefill decision when no
# measured crossover is given (run_kv_restore_crossover_sweep derives
# one): two pages, below which a restore's fixed overhead rivals the
# prefill it would replace.
KV_RESTORE_MIN_TOKENS_DEFAULT = 32


def restore_cost(cfg, hit_len: int,
                 param_itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of restoring ``hit_len`` spilled prefix positions
    from the host KV tier (serving/pages.HostKVTier): no FLOPs, and the
    host-to-device payload plus the scatter's write, ``2 * hit_len``
    positions at :func:`admission_cost`'s per-position bytes. A spilled
    hit either restores (this) or re-prefills (``admission_cost(cfg,
    hit_len)``, quadratic in the hit), so restore wins above a crossover
    length: the engine's ``restore_min_tokens``."""
    if hit_len < 0:
        raise ValueError(f"hit_len must be >= 0, got {hit_len}")
    return 0.0, float(2.0 * hit_len * _pos_bytes(cfg, param_itemsize))


def preempt_cost(cfg, row_len: int,
                 param_itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one preemption round trip of a live row of
    ``row_len`` positions: the freeze's gather to the host tier and the
    thaw's scatter back, each a :func:`restore_cost` of the row; no
    FLOPs (nothing is recomputed)."""
    _, one_way = restore_cost(cfg, row_len, param_itemsize=param_itemsize)
    return 0.0, float(2.0 * one_way)


def preempt_beneficial(cfg, row_len: int, victim_remaining_steps: int,
                       margin: float = 1.0,
                       param_itemsize: int = 4) -> bool:
    """Freeze this victim, or let it run out? Waiting costs the victim's
    remaining decode steps (:func:`decode_step_cost` at batch 1, the
    marginal row's share); freezing costs the round trip
    (:func:`preempt_cost`). Freeze when the first exceeds ``margin``
    times the second. Both sides are priced in bytes, as if the cache's
    memory and the host link ran at one speed."""
    if victim_remaining_steps <= 0:
        return False
    quant_weights = bool(getattr(cfg, "quantize", False))
    _, step_bytes = decode_step_cost(cfg, 1, param_itemsize=param_itemsize,
                                     quant_weights=quant_weights)
    _, move_bytes = preempt_cost(cfg, row_len,
                                 param_itemsize=param_itemsize)
    return victim_remaining_steps * step_bytes > margin * move_bytes


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

    def sec_per_unit(self, op: str) -> Optional[float]:
        """The current EWMA seconds per model unit (None before the op's
        first sample): what the matrix service prices a job's units by."""
        with self._lock:
            st = self._ops.get(op)
            return None if st is None else st["ewma"]

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


def ell_product_cost(m: int, k: int, n: int, r_slots: int, n_devices: int,
                     itemsize: int = 4) -> Tuple[float, float]:
    """Per-device (flops, bytes) of the ELL row-gather sparse product: each
    of the m/nd local output rows gathers its ``r_slots`` B rows and
    reduces them, so traffic goes as nnz(A) * n words, not m * k * n.
    Bytes: B read once (k * n), the gathered rows, the output stripe and
    the ELL tables; FLOPs: a multiply and an add a gathered element."""
    ms = m / n_devices
    flops = 2.0 * ms * r_slots * n
    byts = itemsize * (k * n + ms * r_slots * n + ms * n) \
        + ms * r_slots * (4 + itemsize)
    return flops, float(byts)


# -- matrix-service job pricing (serving/jobs.py) ----------------------------
#
# The service prices every job before it reaches the driver thread: total
# model units from the rooflines above, sliced into the executor's quantum
# count, times the CostCalibration ledger's measured sec/unit for the op
# class into a round-budget prediction the run log holds against the
# measured wall clock.

MATRIX_JOB_OPS = ("gemm", "lu", "cholesky", "svd", "spmm", "inverse")


def matrix_job_cost(op: str, shapes, *, itemsize: int = 4,
                    density: float = 0.05, k_singular: int = 6,
                    n_devices: int = 1) -> Tuple[float, float]:
    """(flops, bytes) one matrix-service job costs end to end. ``shapes``
    is the job's validated shape list (``[m, k, n]`` for gemm/spmm,
    ``[n]`` for the square factorizations, ``[m, n]`` for svd): gemm
    prices with :func:`gemm_cost`, spmm with :func:`ell_product_cost` at
    the job's density, the factorizations with their classic flop counts
    (2/3 n^3 LU, 1/3 n^3 Cholesky, 2 n^3 inverse, ~8 m n k for the
    truncated SVD) over a one-pass byte model. An unknown op raises
    ValueError: pricing is the admission gate."""
    if op == "gemm":
        m, k, n = shapes
        return gemm_cost(m, k, n, itemsize=itemsize)
    if op == "spmm":
        m, k, n = shapes
        r_slots = max(1, int(density * k))
        return ell_product_cost(m, k, n, r_slots, n_devices,
                                itemsize=itemsize)
    if op == "lu":
        (n,) = shapes
        return (2.0 / 3.0) * n ** 3, float(itemsize) * 2 * n * n
    if op == "cholesky":
        (n,) = shapes
        return (1.0 / 3.0) * n ** 3, float(itemsize) * 2 * n * n
    if op == "inverse":
        (n,) = shapes
        return 2.0 * n ** 3, float(itemsize) * 2 * n * n
    if op == "svd":
        m, n = shapes
        return 8.0 * m * n * k_singular, \
            float(itemsize) * (m * n + (m + n) * k_singular)
    raise ValueError(f"unknown matrix job op {op!r}; "
                     f"ops: {MATRIX_JOB_OPS}")


def matrix_round_budget(units: float, n_quanta: int,
                        sec_per_unit: Optional[float],
                        round_budget_s: float) -> dict:
    """Price a job's ``units`` (:func:`matrix_job_cost`), sliced into
    ``n_quanta`` executor quanta, into round budgets. With a calibrated
    ``sec_per_unit`` the prediction is absolute: seconds a quantum, the
    quanta one ``round_budget_s`` slice holds, and the rounds the job
    needs. Uncalibrated (None), one quantum a round and no wall-clock
    claim."""
    n_quanta = max(1, int(n_quanta))
    out = {"units": float(units), "n_quanta": n_quanta,
           "unit_per_quantum": float(units) / n_quanta,
           "predicted_s": None, "quantum_s": None,
           "quanta_per_round": 1, "predicted_rounds": n_quanta}
    if sec_per_unit is not None and sec_per_unit > 0 and units > 0:
        quantum_s = (units / n_quanta) * sec_per_unit
        per_round = max(1, int(round_budget_s / quantum_s)) \
            if quantum_s > 0 else n_quanta
        out.update(
            predicted_s=units * sec_per_unit,
            quantum_s=quantum_s,
            quanta_per_round=per_round,
            predicted_rounds=-(-n_quanta // per_round))
    return out


# -- the host KV tier's restore-or-re-prefill crossover ----------------------

# Hit lengths of the sweep: page multiples (a restore rebinds whole pages).
KV_RESTORE_LENGTHS = (64, 128, 256, 512)


def _median_wallclock(fn, reps: int, device) -> float:
    """Median host seconds of ``fn()`` over ``reps`` calls after one
    untimed warm-up, each call ended by a device sync."""
    import time

    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def run_kv_restore_crossover_sweep(cfg=None, lengths=KV_RESTORE_LENGTHS,
                                   reps: int = 3, chunk: int = 64,
                                   seed: int = 7, device="cuda"):
    """Time the host tier's restore against a paged re-prefill over a
    grid of hit lengths, on ``device``; returns ``{length, restore_s,
    reprefill_s, restore_over_reprefill}`` a point, for
    :func:`derive_kv_restore_min_tokens`.

    A length's pages are first filled by the chunked paged admission
    (``chunk`` tokens a call; that prefill is the re-prefill arm), then
    gathered to a host payload as ``HostKVTier.spill`` does, and the
    restore arm times ``restore_pages_into_pool`` including each call's
    host-to-device copy of that payload. Each arm: the median of ``reps``
    synced calls after a warm-up."""
    import numpy as np
    import torch

    from ..models import transformer as tr
    from ..obs.metrics import MetricsRegistry
    from ..serving.pages import PAGE, PagePool, gather_pages_to_host
    from ..serving.slots import (prefill_chunk_into_row_paged,
                                 restore_pages_into_pool)
    from .hw import resolve_device

    device = resolve_device(device)
    cfg = cfg or tr.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                      n_layers=2, d_ff=128,
                                      max_len=max(lengths))
    params = tr._cast_params(tr.init_params(cfg, seed=seed, device=device),
                             cfg)
    rng = np.random.default_rng(seed)
    out = []
    with torch.no_grad():
        for length in lengths:
            if length % PAGE or length % chunk or length > cfg.max_len:
                raise ValueError(
                    f"length {length} must be a multiple of PAGE={PAGE} "
                    f"and chunk={chunk}, and <= max_len={cfg.max_len}")
            n = length // PAGE
            pool = PagePool(cfg, n, registry=MetricsRegistry(),
                            device=device)
            pages = pool.alloc(n)
            table = torch.zeros(cfg.max_len // PAGE, dtype=torch.long,
                                device=device)
            table[:n] = torch.as_tensor(pages)
            prompt = torch.as_tensor(rng.integers(1, cfg.vocab, length),
                                     device=device)
            buf = torch.zeros((1, cfg.max_len), dtype=torch.long,
                              device=device)

            def reprefill(pool=pool, table=table, prompt=prompt, buf=buf,
                          length=length):
                for c0 in range(0, length, chunk):
                    prefill_chunk_into_row_paged(
                        params, pool.pages, buf, 0, table,
                        prompt[c0:c0 + chunk], c0, chunk, prompt, length,
                        cfg)

            reprefill_s = _median_wallclock(reprefill, reps, device)
            payload, _ = gather_pages_to_host(pool.pages, pages)

            def restore(pool=pool, payload=payload, pages=pages):
                restore_pages_into_pool(pool.pages, payload, pages)

            restore_s = _median_wallclock(restore, reps, device)
            out.append({"length": length, "restore_s": restore_s,
                        "reprefill_s": reprefill_s,
                        "restore_over_reprefill":
                            restore_s / max(reprefill_s, 1e-12)})
    return out


def derive_kv_restore_min_tokens(points) -> int:
    """``restore_min_tokens`` from a crossover sweep: the hit length where
    ``restore_over_reprefill`` crosses 1.0 (it falls with length: re-
    prefill FLOPs grow quadratically, restore bytes linearly), log-log
    interpolated between the last point re-prefill wins and the first
    restore wins. Restore winning at the shortest length gives half that
    length (at least one page); restore never winning gives twice the
    longest. Points need not be sorted; ratios <= 0 raise."""
    import math

    pts = sorted(points, key=lambda p: p["length"])
    if not pts:
        raise ValueError("empty crossover sweep")
    if any(p["restore_over_reprefill"] <= 0 for p in pts):
        raise ValueError("restore_over_reprefill must be positive")
    if pts[0]["restore_over_reprefill"] <= 1.0:
        return max(16, int(pts[0]["length"] // 2))
    last_lose = pts[0]
    for p in pts[1:]:
        if p["restore_over_reprefill"] > 1.0:
            last_lose = p
            continue
        l0, r0 = last_lose["length"], last_lose["restore_over_reprefill"]
        l1, r1 = p["length"], p["restore_over_reprefill"]
        t = (0.0 - math.log(r0)) / (math.log(r1) - math.log(r0))
        return int(round(math.exp(
            math.log(l0) + t * (math.log(l1) - math.log(l0)))))
    return int(2 * pts[-1]["length"])
