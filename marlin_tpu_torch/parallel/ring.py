"""Ring / streaming dimension parallelism, the long-context engine: port of
``marlin_tpu/parallel/ring.py``.

* :func:`ring_matmul`: C = A @ B with the contraction dimension sharded
  over the ``torch.distributed`` mesh (flattened into one ring). Each rank
  holds its row stripe of A and one k-chunk of B at a time; the chunks
  rotate around the ring by point-to-point exchange
  (:func:`.summa.ring_exchange`, as Cannon's steps do), accumulating in at
  least f32. The logical C on every rank, as :func:`.summa.matmul` gives.

* :func:`ring_self_attention`: blockwise-softmax ring attention over a
  sequence sharded on the single-process shard axis (:mod:`.shards`). Q
  stays local, K/V stripes rotate (a rotation of the list of stripes), the
  softmax is accumulated online (running max, denominator, accumulator in
  at least f32), and each hop runs under ``torch.utils.checkpoint`` so
  the backward keeps no hop's (S/P, S/P) tiles. Plain torch ops: the JAX
  package leaves this engine to XLA (no Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..config import get_config
from ..mesh import Mesh, default_mesh
from ..utils.split import pad_to_multiple
from .shards import resolve_shards, rotate
from .summa import _acc_dtype, _mm, ring_exchange

# ---------------------------------------------------------------------------
# Ring GEMM
# ---------------------------------------------------------------------------


def ring_matmul(a, b, mesh: Optional[Mesh] = None,
                precision: Optional[str] = None) -> Optional[torch.Tensor]:
    """C = A @ B streaming B's k-chunks around the ring of every rank of
    ``mesh`` (its ranks in mesh order). ``a`` and ``b`` are tensors every
    rank of the mesh holds (zero-padded to the ring's multiples here);
    returns the logical C on every rank of the mesh, None outside it.
    Collective over the mesh."""
    mesh = mesh or default_mesh()
    precision = precision or get_config().matmul_precision
    (m, k), (k2, n) = tuple(a.shape), tuple(b.shape)
    if k != k2:
        raise ValueError(f"inner dimensions mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if not mesh.holds:
        return None
    ring = mesh.ranks
    p = len(ring)
    i = ring.index(dist.get_rank())
    dev = mesh.device
    ap = pad_to_multiple(pad_to_multiple(torch.as_tensor(a).to(dev), 0, p),
                         1, p)
    bp = pad_to_multiple(torch.as_tensor(b).to(dev), 0, p)
    rows, chunk = ap.shape[0] // p, bp.shape[0] // p
    a_blk = ap[i * rows:(i + 1) * rows]  # (m/P, k): the whole contraction
    b_cur = bp[i * chunk:(i + 1) * chunk].contiguous()  # one k-chunk
    acc_t = _acc_dtype(a_blk.dtype)
    acc = None
    for t in range(p):
        src = (i + t) % p  # the k-chunk held at step t
        part = _mm(a_blk[:, src * chunk:(src + 1) * chunk].to(acc_t),
                   b_cur.to(acc_t), precision)
        acc = part if acc is None else acc + part
        if t < p - 1:  # chunks move one rank back around the ring
            b_cur = ring_exchange(b_cur, ring[(i - 1) % p],
                                  ring[(i + 1) % p])
    stripe = acc.to(a_blk.dtype).contiguous()
    parts = [torch.empty_like(stripe) for _ in range(p)]
    dist.all_gather(parts, stripe, group=mesh.group)
    order = dist.get_process_group_ranks(mesh.group or dist.group.WORLD)
    out = torch.cat([parts[order.index(r)] for r in ring])
    return out[:m, :n]


# ---------------------------------------------------------------------------
# Ring attention (sequence parallelism)
# ---------------------------------------------------------------------------


def ring_hops(n_dev: int, skv_stripe: int, window: int) -> int:
    """Hops the ring attention engine runs, the same function as the JAX
    package's (its cost model imports it). Sliding window (causal): only
    the current stripe plus the previous ceil((window - 1) / stripe)
    stripes can intersect any local query's band, so the windowed ring
    stops after that many hops. Without a window every stripe visits
    every shard."""
    if window:
        return min(n_dev, (window + skv_stripe - 2) // max(skv_stripe, 1) + 1)
    return n_dev


def _hop(q, k, v, m_run, l_run, o_run, q0: int, k0: int, causal: bool,
         scale: float, window: int):
    """One hop of one shard: merge the stripe (k, v) into the online-softmax
    state. q (Hk, G, sq, D) in the accumulator dtype, k (Hk, skv, D), v
    (Hk, skv, Dv); m_run, l_run (Hk, G, sq) and o_run (Hk, G, sq, Dv) in
    the accumulator dtype; ``q0``, ``k0`` the stripes' first positions."""
    acc_t = m_run.dtype
    hk, g, sq, d = q.shape
    # The group's queries share their KV head's stripe: (Hk, G sq, D)
    # against (Hk, D, skv), K never replicated.
    logits = scale * torch.matmul(q.reshape(hk, g * sq, d),
                                  k.to(acc_t).transpose(-1, -2))
    logits = logits.reshape(hk, g, sq, -1)
    if causal:
        skv = k.shape[-2]
        q_pos = q0 + torch.arange(sq, device=q.device)[:, None]
        k_pos = k0 + torch.arange(skv, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window:
            mask = mask & (k_pos > q_pos - window)
        logits = torch.where(mask, logits,
                             torch.full((), -1e30, dtype=acc_t,
                                        device=q.device))
    m_new = torch.maximum(m_run, logits.amax(dim=-1))
    corr = torch.exp(m_run - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l_run * corr + p.sum(dim=-1)
    pv = torch.matmul(p.reshape(hk, g * sq, -1), v.to(acc_t))
    o_new = o_run * corr[..., None] + pv.reshape(hk, g, sq, -1)
    return m_new, l_new, o_new


def ring_self_attention(q, k, v, devices=None, causal: bool = False,
                        scale: Optional[float] = None,
                        window: int = 0) -> torch.Tensor:
    """softmax(Q K^T * scale) V with the sequence dimension sharded on the
    ring of ``devices`` (default: :func:`.shards.default_shards`); K/V
    stripes stream. Shapes: q (sq, d) or (sq, h, d) multi-head; k/v match
    q's rank and may carry FEWER heads (GQA/MQA: q-head i reads kv-head
    i // group, and a K/V stripe is shared by its query group, never
    replicated), with lengths (skv, ...). skv must divide by the shard
    count; q is zero-padded to it and sliced back.

    ``window`` > 0 (requires ``causal`` and self-attention lengths) runs
    the hop-bounded ring (:func:`ring_hops`), rotating forward: shard i
    sees stripes i, i - 1, ...; the full ring rotates backward. The result
    is assembled on q's device."""
    devices = resolve_shards(devices)
    n_dev = len(devices)
    if k.shape[0] % n_dev != 0:
        raise ValueError(
            f"key/value length {k.shape[0]} must divide by {n_dev} devices")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window:
        if not causal:
            raise ValueError("window > 0 requires causal=True")
        if q.shape[0] != k.shape[0]:
            raise ValueError(
                "windowed ring attention needs self-attention lengths "
                f"(q {q.shape[0]} vs kv {k.shape[0]}): the hop bound "
                "assumes aligned q/kv stripes")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    multihead = q.dim() == 3
    if multihead:
        if k.shape[1] != v.shape[1]:
            raise ValueError(
                f"k/v head-count mismatch: {tuple(k.shape)} vs "
                f"{tuple(v.shape)}")
        if q.shape[1] % k.shape[1]:
            raise ValueError(
                f"GQA needs kv_heads ({k.shape[1]}) to divide heads "
                f"({q.shape[1]})")
    else:  # one head
        q, k, v = q[:, None], k[:, None], v[:, None]
    sq = q.shape[0]
    qp = pad_to_multiple(q, 0, n_dev)
    sq_s, skv_s = qp.shape[0] // n_dev, k.shape[0] // n_dev
    h, hk, d = q.shape[1], k.shape[1], q.shape[2]
    g = h // hk
    acc_t = torch.promote_types(q.dtype, torch.float32)
    if window:
        hops, direction = ring_hops(n_dev, skv_s, window), +1
    else:
        hops, direction = n_dev, -1

    def stripes(x, s):  # head-major stripes, one a shard, on its device
        return [x[r * s:(r + 1) * s].movedim(0, 1).to(devices[r])
                for r in range(n_dev)]

    # q (Hk, G, sq/P, D) in the accumulator dtype; k (Hk, skv/P, D).
    qs = [x.to(acc_t).reshape(hk, g, sq_s, d) for x in stripes(qp, sq_s)]
    ks, vs = stripes(k, skv_s), stripes(v, skv_s)
    state = []
    for r in range(n_dev):
        dev = devices[r]
        state.append((
            torch.full((hk, g, sq_s), -1e30, dtype=acc_t, device=dev),
            torch.zeros((hk, g, sq_s), dtype=acc_t, device=dev),
            torch.zeros((hk, g, sq_s, v.shape[-1]), dtype=acc_t,
                        device=dev)))
    for t in range(hops):
        for r in range(n_dev):
            src = (r - direction * t) % n_dev  # the stripe held at hop t
            args = (qs[r], ks[r], vs[r], *state[r], r * sq_s, src * skv_s,
                    bool(causal), float(scale), int(window))
            if torch.is_grad_enabled():
                state[r] = checkpoint(_hop, *args, use_reentrant=False)
            else:
                state[r] = _hop(*args)
        if t < hops - 1:
            ks = rotate(ks, devices, direction)
            vs = rotate(vs, devices, direction)
    outs = []
    for r in range(n_dev):
        _, l_fin, o_fin = state[r]
        o = o_fin / l_fin.clamp_min(1e-30)[..., None]  # (Hk, G, sq/P, Dv)
        o = o.reshape(h, sq_s, -1).movedim(1, 0).to(q.dtype)
        outs.append(o.to(q.device))
    out = torch.cat(outs)[:sq]
    return out if multihead else out[:, 0]
