"""All-to-all (Ulysses-style) sequence parallelism: port of
``marlin_tpu/parallel/ulysses.py``.

The second long-context engine beside :mod:`.ring`. QKV arrive sharded on
the sequence axis (one stripe a shard of the single-process shard axis,
:mod:`.shards`); one all-to-all (each shard's stripe cut into head blocks,
the blocks for shard j concatenated in rank order along the sequence)
leaves every shard the FULL sequence for its own H/P heads; every shard
runs full-sequence attention for its heads; a second all-to-all restores
sequence sharding. On a CUDA shard the local attention is the port's
hand-written flash kernels (forward, and dQ and dK/dV under autograd), at
one shard's head count; on a CPU shard their plain versions.

All-to-all needs the head count (and the GQA KV heads) to divide the shard
count and self-attention lengths; :func:`sequence_parallel_attention`
falls back to the ring otherwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.flash_attention import flash_attention
from .shards import resolve_shards


def _attend(q, k, v, scale, causal, window=0):
    """Full-sequence attention of one head: softmax(q k^T * scale) v. q
    (sq, d); k/v (skv, d). Logits and softmax in at least f32 whatever the
    input dtype; the output casts back."""
    acc_t = torch.promote_types(q.dtype, torch.float32)
    logits = scale * torch.matmul(q.to(acc_t), k.to(acc_t).T)
    if causal:
        q_pos = torch.arange(q.shape[0], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[0], device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window:
            mask = mask & (k_pos > q_pos - window)
        logits = torch.where(mask, logits,
                             torch.full((), -1e30, dtype=acc_t,
                                        device=q.device))
    logits = logits - logits.amax(dim=1, keepdim=True)
    p = torch.exp(logits)
    pv = torch.matmul(p, v.to(acc_t))
    return (pv / p.sum(dim=1, keepdim=True)).to(q.dtype)


def _attend_heads(q, k, v, scale, causal, window):
    """:func:`_attend` for every query head of (S, H, D) q over (S, Hk,
    D) k/v: query head j reads KV head j // (H // Hk)."""
    group = q.shape[1] // k.shape[1]
    return torch.stack([_attend(q[:, j], k[:, j // group], v[:, j // group],
                                scale, causal, window)
                        for j in range(q.shape[1])], dim=1)


def _all_to_all(stripes: list, devices: tuple, split: int,
                concat: int) -> list:
    """A tiled all_to_all: shard j receives every shard's j-th block along
    ``split``, concatenated in rank order along ``concat`` (on shard j's
    device)."""
    p = len(stripes)
    blocks = [x.chunk(p, dim=split) for x in stripes]
    return [torch.cat([blocks[i][j].to(devices[j]) for i in range(p)],
                      dim=concat) for j in range(p)]


def ulysses_self_attention(q, k, v, devices=None, causal: bool = False,
                           scale: Optional[float] = None,
                           local_kernel: str = "auto",
                           window: int = 0) -> torch.Tensor:
    """Multi-head attention with sequence sharding over ``devices``
    (default: :func:`.shards.default_shards`) via two all-to-alls.

    ``window`` > 0 (requires ``causal``) bands the local full-sequence
    attention. Shapes: q (seq, n_heads, head_dim); k/v may carry FEWER
    heads (GQA/MQA: kv_heads must divide n_heads). seq, n_heads and
    kv_heads must each divide by the shard count (contiguous head chunks
    keep the q-to-kv grouping aligned per shard). Returns (seq, n_heads,
    head_dim_v) on q's device.

    ``local_kernel``: the per-shard attention after the re-shard: "flash"
    and "auto" the port's flash attention (the hand-written kernels on a
    CUDA shard, their plain versions on a CPU one), "xla" :func:`_attend`
    a head in torch ops."""
    devices = resolve_shards(devices)
    n_dev = len(devices)
    s, h, d = q.shape
    hk = k.shape[1] if k.dim() == 3 else h
    if s % n_dev != 0:
        raise ValueError(f"sequence length {s} must divide by {n_dev} devices")
    if h % n_dev != 0:
        raise ValueError(f"head count {h} must divide by {n_dev} devices")
    if h % hk or hk % n_dev:
        raise ValueError(
            f"GQA needs kv_heads ({hk}) dividing heads ({h}) and divisible "
            f"by {n_dev} devices (otherwise use the ring engine)")
    if tuple(k.shape) != (s, hk, d) or tuple(v.shape[:2]) != (s, hk):
        raise ValueError(
            f"q/k/v shape mismatch: {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)} (all-to-all attention needs equal seq "
            "lengths and matching q/k head_dim)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if local_kernel not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown local_kernel {local_kernel!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    stripe = s // n_dev

    def seq_to_head(x):  # (S/P, H, D) a shard -> (S, H/P, D) a shard
        parts = [x[r * stripe:(r + 1) * stripe].to(devices[r])
                 for r in range(n_dev)]
        return _all_to_all(parts, devices, split=1, concat=0)

    q_h, k_h, v_h = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    outs = []
    for r in range(n_dev):
        if local_kernel == "xla":
            outs.append(_attend_heads(q_h[r], k_h[r], v_h[r], scale, causal,
                                      window))
        else:
            outs.append(flash_attention(q_h[r], k_h[r], v_h[r],
                                        causal=causal, scale=scale,
                                        window=window))
    back = _all_to_all(outs, devices, split=0, concat=1)  # (S/P, H, Dv)
    return torch.cat([x.to(q.device) for x in back])


def sequence_parallel_attention(q, k, v, devices=None, causal: bool = False,
                                scale: Optional[float] = None,
                                strategy: str = "auto",
                                window: int = 0) -> torch.Tensor:
    """Dispatch between the two sequence-parallel attention engines.

    ``strategy``: ``"ring"`` | ``"all_to_all"`` | ``"auto"``. Auto picks
    all-to-all when q, k and v are (seq, heads, dim), the sequence, the
    heads and the KV heads all divide the shard count, the lengths match
    and the head dims agree; ring otherwise (cross-attention,
    non-divisible shapes, too few KV heads). ``window`` > 0 (requires
    ``causal``): all-to-all bands its local attention; ring runs the
    hop-bounded pipeline."""
    from .ring import ring_self_attention

    devices = resolve_shards(devices)
    n_dev = len(devices)
    if strategy == "auto":
        strategy = (
            "all_to_all"
            if (q.dim() == 3 and k.dim() == 3
                and q.shape[1] % n_dev == 0
                and q.shape[0] % n_dev == 0
                and q.shape[1] % k.shape[1] == 0
                and k.shape[1] % n_dev == 0
                and k.shape[0] == q.shape[0]
                and k.shape[2] == q.shape[2]
                and tuple(v.shape[:2]) == tuple(k.shape[:2]))
            else "ring")
    if strategy == "all_to_all":
        if q.dim() != 3:
            raise ValueError(
                "all_to_all strategy needs (seq, heads, dim) inputs")
        return ulysses_self_attention(q, k, v, devices=devices,
                                      causal=causal, scale=scale,
                                      window=window)
    if strategy == "ring":
        return ring_self_attention(q, k, v, devices=devices, causal=causal,
                                   scale=scale, window=window)
    raise ValueError(f"unknown sequence-parallel strategy: {strategy!r}")
