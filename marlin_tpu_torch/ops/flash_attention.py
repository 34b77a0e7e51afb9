"""Flash attention: the hand-written Hopper kernels and their plain
PyTorch versions, forward and backward.

Port of ``marlin_tpu/ops/flash_attention.py``. The Pallas TPU kernels
become CUDA C++ kernels: ``_kernel`` (the forward) is
``csrc/flash_attention_fwd.cu``; ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (the backward) are ``csrc/flash_attention_bwd.cu``.
For bf16 all three kernels run wgmma fed by TMA through an mbarrier
ring; for f32 all three are register-tiled FMA on the CUDA cores fed by a
cp.async ring. Above head dim 256 the three wide kernels of
``csrc/flash_attention_wide.cu`` take their place, of the same two
designs. The TPU's block constants and VMEM clamps (``DEFAULT_BLOCK_Q/K``,
``effective_blocks``, ``window_block_clamp``, the backward's 512-row
clamp, the lane-replicated lse) do not carry over: each CUDA kernel uses
its own tiles (:data:`KERNEL_TILES`) and masks the ragged edges itself.

Dispatch: CPU tensors take the plain versions,
:func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`; CUDA tensors take the kernels.
There is no fallback: on the card, a kernel that cannot be built or
launched raises, forward or backward. When grad is enabled and an input
requires grad, the call goes through :class:`FlashAttentionFunction`, the
counterpart of the JAX package's ``_flash_hsd`` custom_vjp: it saves
only ``(q_hat, k, v, o, lse)`` and its backward recomputes the
probability tiles from lse, so no (Sq, Skv) tensor is kept between the
two passes.

Head dims. The kernels of ``flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` are built for D and Dv in
:data:`KERNEL_HEAD_DIMS` (64 and 128 in any pairing, and D = Dv = 256);
on the card the wrapper zero-pads q_hat and K (D) and V and dO (Dv) up to
the smallest of them that holds the head dim, both to 256 when either is
above 128 (:func:`_kernel_head_dims`), and slices O, dQ, dK and dV back,
as the JAX package pads to its 128-lane tile (zero columns add nothing to
q_hat K^T, to P V or to Delta). When D or Dv is above 256, each is padded
on its own to a multiple of :data:`WIDE_MULTIPLE` and the call goes to the
wide kernels of ``csrc/flash_attention_wide.cu``, which have launch
counters of their own; a call at D and Dv up to 256 never reaches them.
For bf16 the three wide kernels run wgmma fed by TMA through an mbarrier
ring, a CTA owning up to :data:`WIDE_BF16_COLUMNS` of the output's columns
(:func:`_wide_column_chunks`): the forward's O, dQ, and dK/dV's 64 keys
of dK or of dV (a key tile's parts, :func:`_wide_dkv_plan`, each computing
S^T again; where the CTAs would not fill two waves of the card, the group
of query heads is split too and a second launch sums the parts' f32
partials in a fixed order). The f32 kernels are register-tiled FMA on
the CUDA cores (the pieces in ``csrc/flash_f32.cuh``), every CTA holding
up to :data:`F32_COLUMNS` output columns and one part of its tile's
sweep, a second launch merging the parts' f32 partials in a fixed order.
The f32 forward and dQ, narrow and wide (``csrc/flash_fwd_dq_f32.cuh``),
own 64 query rows of one query head a CTA and cut each query tile's sweep
over its live key tiles (:func:`_f32_q_plan`); the f32 dK/dV, narrow and
wide (``csrc/flash_dkv_f32.cuh``), owns 64 keys a CTA and cuts each key
tile's sweep over its (query head, query tile) pairs
(:func:`_f32_dkv_plan`).

Public layout is the JAX package's ``(S, H, D)``, plus an optional
leading batch dimension that stands in for ``jax.vmap``.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.hw import is_sm90
from . import build

_NEG_INF = -1e30  # masked logits stay finite, as in the TPU kernel
_LOG2E = math.log2(math.e)

# Head dims the kernel is instantiated for (template arguments D and Dv),
# ascending; smaller ones are zero-padded up to the next (_padded_fwd).
# 64 and 128 pair freely; 256 only with 256 (_kernel_head_dims).
KERNEL_HEAD_DIMS = (64, 128, 256)
# Above 256, D and Dv are each padded to a multiple of this for the wide
# kernels (their box), whose bf16 CTAs own at most WIDE_BF16_COLUMNS
# output columns (two consumer warpgroups of kMaxBoxes 64-column boxes
# each): the forward's and dQ's query rows, and dK/dV's WIDE_DKV_KEYS keys
# (kDkvKeys). The bf16 dK/dV splits each KV head's group of query heads
# over CTAs where its grid would not fill WIDE_DKV_WAVES waves of one CTA
# per SM (_wide_dkv_plan).
WIDE_MULTIPLE = 64
WIDE_BF16_COLUMNS = 640
WIDE_DKV_KEYS = 64
WIDE_DKV_WAVES = 2
# The f32 kernels: the most output columns a CTA holds (kMaxBoxes x kBox
# of csrc/flash_f32.cuh). The f32 dK/dV (csrc/flash_dkv_f32.cuh, narrow
# and wide): a CTA's keys (kKeys), the query rows of a tile (kQueries)
# and the waves of one CTA an SM its plan aims at. The f32 forward and dQ,
# narrow and wide (csrc/flash_fwd_dq_f32.cuh): a CTA's query rows
# (kQueries) and the keys of a forward tile (kFwdKeys) and of a dQ tile
# (kDqKeys).
F32_COLUMNS = 512
F32_DKV_KEYS = 64
F32_DKV_QUERIES = 64
F32_DKV_WAVES = 2
F32_Q_ROWS = 64
F32_FWD_KEYS = 128
F32_DQ_KEYS = 64
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# (query rows, keys) of each bf16 kernel's tile: the forward's kBM x kBN in
# csrc/flash_attention_fwd.cu, the dQ kernel's kBM x kBN and the dK/dV
# kernel's kDkvBM x kDkvBN in csrc/flash_attention_bwd.cu. The cost model
# counts the forward's tiles with them.
KERNEL_TILES = {"fwd": (128, 128), "dq": (64, 64), "dkv": (64, 64)}

# Kernel launches since the last reset, one counter per kernel
# (chip_smoke.py zeroes and reads them to prove that a path ran through
# the kernels): the forward, the dQ backward and the dK/dV backward, and
# the same three of the wide kernels (head dims above 256).
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
wide_launches = 0
wide_dq_launches = 0
wide_dkv_launches = 0


def _prepare(q, k, v, causal: bool, scale: Optional[float], window: int):
    """Validate batched (B, S, H, D) shapes and the options, and fold
    ``scale * log2(e)`` into Q in >= f32 and round it back to Q's dtype —
    the TPU kernel's prescale (``_flash_hsd_impl``), whose rounding at
    bf16 is part of the result. Returns ``(q_hat, k, v)``."""
    if not q.dim() == k.dim() == v.dim() == 4:
        raise ValueError(
            f"expected (S, H, D) or (B, S, H, D) tensors, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or v.shape[0] != b:
        raise ValueError(f"batch mismatch: {q.shape}, {k.shape}, {v.shape}")
    if k.shape[-1] != d:
        raise ValueError(f"q/k head_dim mismatch: {q.shape} vs {k.shape}")
    if k.shape[1:3] != v.shape[1:3]:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    hk = k.shape[2]
    if h % hk:
        raise ValueError(
            f"GQA needs kv_heads ({hk}) to divide heads ({h})")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError(f"empty sequence: q {q.shape}, k {k.shape}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pdt = torch.promote_types(q.dtype, torch.float32)
    q_hat = (q.to(pdt) * (scale * _LOG2E)).to(q.dtype)
    return q_hat, k, v


def flash_attention_reference(q_hat, k, v, causal: bool = False,
                              window: int = 0):
    """The plain version, on an already-prescaled ``q_hat`` and batched
    (B, S, H, D) tensors: the same base-2 softmax, the same -1e30 masks,
    GQA by index (a reshape, K/V never replicated), returning ``(O in
    q's dtype, lse (B, H, Sq) f32)``. It materialises the logits: it
    exists for tests and as the kernel's yardstick of correctness."""
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    cdt = torch.promote_types(q_hat.dtype, torch.float32)
    qg = q_hat.to(cdt).reshape(b, sq, hk, h // hk, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(cdt))
    qp = torch.arange(sq, device=q_hat.device)[:, None]
    kp = torch.arange(skv, device=q_hat.device)[None, :]
    if causal:
        mask = kp <= qp
        if window:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(cdt))
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log2(l))[..., 0].reshape(b, h, sq)
    return o.reshape(b, sq, h, dv).to(q_hat.dtype), lse.float()


def flash_attention_bwd_reference(q_hat, k, v, o, lse, do,
                                  causal: bool = False, window: int = 0,
                                  scale: Optional[float] = None):
    """The plain backward, on the prescaled ``q_hat`` the forward saw and
    batched (B, S, H, D) tensors: the JAX package's ``_flash_bwd_pallas``
    and ``_bwd_p_ds`` written out. Delta = rowsum(dO * O) in f32;
    p = exp2(q_hat k^T - lse) under the same -1e30 masks;
    dS = p * (dO v^T - Delta); dQ = scale * dS K; dK = ln2 * dS^T q_hat;
    dV = p^T dO; GQA by a (Hk, group) reshape, summed over the group.
    Returns ``(dQ, dK, dV)`` in the dtypes of q, k and v. It materialises
    the (Sq, Skv) tiles: it exists for tests and as the kernels' yardstick
    of correctness."""
    return _bwd_reference(q_hat, k, v, do, lse, _delta(do, o), causal,
                          window, scale)


def _bwd_reference(q_hat, k, v, do, lse, delta, causal: bool, window: int,
                   scale: Optional[float]):
    """:func:`flash_attention_bwd_reference` from Delta (B, H, Sq) f32
    instead of O: the plain twin of :func:`_launch_bwd`, with its
    arguments."""
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hk
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    cdt = torch.promote_types(q_hat.dtype, torch.float32)
    qg = q_hat.to(cdt).reshape(b, sq, hk, group, d)
    dog = do.to(cdt).reshape(b, sq, hk, group, dv)
    kf, vf = k.to(cdt), v.to(cdt)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
    if causal:
        qp = torch.arange(sq, device=q_hat.device)[:, None]
        kp = torch.arange(skv, device=q_hat.device)[None, :]
        mask = kp <= qp
        if window:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp2(s - lse.to(cdt).reshape(b, hk, group, sq, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - delta.to(cdt).reshape(b, hk, group, sq, 1))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * (1.0 / _LOG2E)
    dvv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(b, sq, h, d).to(q_hat.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.marlin_flash_attention_fwd
    if fn.argtypes is None:  # c_void_p, or ctypes would cut pointers to int
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    dq, dkv = (lib.marlin_flash_attention_bwd_dq,
               lib.marlin_flash_attention_bwd_dkv)
    if dq.argtypes is None:
        dq.restype = dkv.restype = ctypes.c_int
        dq.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        dkv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    return lib


def _wide_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_wide")
    fwd, dq, dkv = (lib.marlin_flash_attention_fwd_wide,
                    lib.marlin_flash_attention_bwd_dq_wide,
                    lib.marlin_flash_attention_bwd_dkv_wide)
    if fwd.argtypes is None:
        fwd.restype = dq.restype = dkv.restype = ctypes.c_int
        fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                        + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        dq.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        dkv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    return lib


def _even_shares(width: int, most: int) -> list:
    """``[(first column, columns)]``: ``width`` (a multiple of
    :data:`WIDE_MULTIPLE`) in the fewest shares of at most ``most``
    columns, as even as 64-column boxes allow."""
    boxes = width // WIDE_MULTIPLE
    n = -(-width // most)
    edges = [z * boxes // n * WIDE_MULTIPLE for z in range(n + 1)]
    return [(a, b - a) for a, b in zip(edges, edges[1:])]


def _wide_column_chunks(width: int, dtype) -> list:
    """``[(first column, columns)]``: the wide kernels' CTAs along the
    output's columns for an output ``width`` columns wide (Dv for the
    forward, D for dQ; a multiple of :data:`WIDE_MULTIPLE`), as
    ``csrc/flash_attention_wide.cu`` cuts it: 64-column boxes, as evenly as
    whole boxes allow, at most :data:`WIDE_BF16_COLUMNS` a CTA for bf16
    (the wgmma kernels, ``out_chunks`` and ``OutSplit``: one CTA up to 640
    columns) and :data:`F32_COLUMNS` for f32 (``share_of`` of
    ``csrc/flash_fwd_dq_f32.cuh``: one up to 512); two CTAs of 512 at
    1024 either way."""
    if width < WIDE_MULTIPLE or width % WIDE_MULTIPLE:
        raise ValueError(f"width {width} is not a positive multiple of "
                         f"{WIDE_MULTIPLE}")
    return _even_shares(width, WIDE_BF16_COLUMNS if dtype == torch.bfloat16
                        else F32_COLUMNS)


class WideDkvPlan(NamedTuple):
    """How the bf16 wide dK/dV kernel cuts its work. ``parts``: each 64-key
    tile's CTAs along its columns, ``("dk" or "dv", first column,
    columns)``, dK's then dV's (``DkvPart``). ``heads``: the group parts,
    ``(first, count)`` of a KV head's query heads each, in the order the
    second pass sums them. ``workspace_bytes``: their f32 partial sums,
    (G, B, Skv, Hk, D + Dv), 0 for one group part (no second pass)."""
    parts: list
    heads: list
    workspace_bytes: int

    @property
    def group_parts(self) -> int:
        return len(self.heads)


def _wide_dkv_plan(b: int, h: int, hk: int, skv: int, d: int, dv: int,
                   sms: int) -> WideDkvPlan:
    """The bf16 wide dK/dV kernel's cut on a card of ``sms`` SMs, as
    ``csrc/flash_attention_wide.cu`` takes it (kernel head dims ``d``,
    ``dv``). One CTA an SM; when B x Hk x key tiles x parts CTAs do not
    fill :data:`WIDE_DKV_WAVES` waves, the group of H / Hk query heads goes
    to the fewest equal group parts (a divisor of the group) that do, or
    to one head each."""
    parts = ([("dk", a, n) for a, n in _wide_column_chunks(d, torch.bfloat16)]
             + [("dv", a, n)
                for a, n in _wide_column_chunks(dv, torch.bfloat16)])
    group = h // hk
    ctas = b * hk * -(-skv // WIDE_DKV_KEYS) * len(parts)
    g = next((n for n in range(1, group + 1) if group % n == 0
              and ctas * n >= WIDE_DKV_WAVES * sms), group)
    per = group // g
    heads = [(i * per, per) for i in range(g)]
    ws = g * b * skv * hk * (d + dv) * 4 if g > 1 else 0
    return WideDkvPlan(parts, heads, ws)


def _f32_query_tiles(n0: int, sq: int, causal: bool, window: int):
    """``(first, n)``: the query tiles the 64-key tile at key ``n0`` visits
    (``query_tiles`` of ``csrc/flash_dkv_f32.cuh``): causal from the tile
    holding row ``n0``, a window up to the tile holding the last row that
    still sees a key of this tile."""
    first = n0 // F32_DKV_QUERIES if causal else 0
    last = -(-sq // F32_DKV_QUERIES)
    if window:
        last = min(last, (n0 + F32_DKV_KEYS - 1 + window - 1)
                   // F32_DKV_QUERIES + 1)
    return first, max(0, last - first)


def _f32_dkv_shares(d: int, dv: int) -> list:
    """The f32 dK/dV's column shares ``[(dK's first column, columns, dV's
    first column, columns)]`` (``share_of``): all of dK and dV in one where
    D + Dv <= :data:`F32_COLUMNS`, else dK's shares then dV's, each of
    ceil(width / 512) shares as even as 64-column boxes allow."""
    if d + dv <= F32_COLUMNS:
        return [(0, d, 0, dv)]
    return ([(a, n, 0, 0) for a, n in _even_shares(d, F32_COLUMNS)]
            + [(0, 0, a, n) for a, n in _even_shares(dv, F32_COLUMNS)])


class F32DkvPlan(NamedTuple):
    """How the f32 dK/dV kernels cut their work (``csrc/flash_dkv_f32.cuh``;
    the C entries take ``parts``). ``shares``: each 64-key tile's CTAs along
    its columns (:func:`_f32_dkv_shares`). ``tiles``: each key tile's
    ``(first query tile, live query tiles)``. A key tile's sweep is its
    (query head, query tile) pairs, head-major, cut into parts of
    ``chunk`` pairs, ``tile_parts[t]`` of them (at least 1); ``parts`` (P)
    is the most, key tile 0's under causal attention. ``workspace_bytes``:
    the parts' f32 partial sums, (P, B, Skv, Hk, D + Dv), 0 for P = 1 (no
    second pass)."""
    shares: list
    group: int
    tiles: list
    parts: int
    chunk: int
    tile_parts: list
    workspace_bytes: int


def _f32_cut(pairs: list, parts: int):
    """``(chunk, parts of each tile)`` for the live units of work ``pairs``
    of each tile (the dK/dV's pairs of each key tile, the forward's and
    dQ's key tiles of each query tile) and P = ``parts`` (``launch`` and
    ``part_count``)."""
    most = max(pairs)
    chunk = -(-most // parts) if most > parts else 1
    return chunk, [-(-n // chunk) if n > chunk else 1 for n in pairs]


def _f32_best_parts(units: list, cost_of, ctas_of, sms: int,
                    waves: int) -> int:
    """P of an f32 plan: of the P whose CTAs (``ctas_of(chunk,
    tile_parts)``) fill ``waves`` waves of ``sms`` SMs (all P when none
    does), the one whose CTAs (``cost_of(chunk, tile_parts)``, each CTA's
    steps in launch order) finish soonest on ``sms`` SMs, then the least.
    Each chunk of ``units`` counts once, at its least P."""
    cands, seen = [], set()
    for p in range(1, max(units) + 1):
        chunk, tile_parts = _f32_cut(units, p)
        if chunk in seen:
            continue
        seen.add(chunk)
        ctas = ctas_of(chunk, tile_parts)
        cands.append((ctas >= waves * sms,
                      -_f32_makespan(cost_of(chunk, tile_parts), sms), -p, p))
        if ctas >= 16 * sms:
            break
    return max(cands)[-1]


def _f32_makespan(cost: list, sms: int) -> float:
    """The time of CTAs of ``cost`` steps each, launched in that order onto
    ``sms`` SMs of one CTA each, every CTA to the first SM free."""
    free = [0.0] * min(sms, len(cost))
    for c in cost:
        heapq.heapreplace(free, free[0] + c)
    return max(free)


@functools.lru_cache(maxsize=256)
def _f32_dkv_plan(b: int, h: int, hk: int, sq: int, skv: int, d: int,
                  dv: int, causal: bool, window: int,
                  sms: int) -> F32DkvPlan:
    """The f32 dK/dV kernels' cut on a card of ``sms`` SMs (kernel head dims
    ``d``, ``dv``). One CTA an SM. Of the P whose CTAs fill
    :data:`F32_DKV_WAVES` waves (all P when none does), the one whose
    CTAs, launched heaviest key tile first, finish soonest on ``sms`` SMs,
    in steps (a 64 x 64 x 64 box product for each of the CTA's two
    warpgroups): a CTA's pairs take max(D, Dv) / 64 logit steps where it
    holds dK columns (S^T beside dP^T), else ceil(D / 128) (S^T's halves
    side by side), and one per two output boxes; its ring and its stores
    one more; and a part of a key tile of several one step per 256
    columns for its partial sums, written and read back. Each chunk of
    pairs counts once, at its least P."""
    shares = _f32_dkv_shares(d, dv)
    group = h // hk
    tiles = [_f32_query_tiles(t * F32_DKV_KEYS, sq, causal, window)
             for t in range(-(-skv // F32_DKV_KEYS))]
    pairs = [group * n for _, n in tiles]
    box = WIDE_MULTIPLE
    steps = [((max(d, dv) if nk else -(-d // (2 * box)) * box) // box
              + -(-(nk + nv) // (2 * box)), (nk + nv) / 256)
             for _, nk, _, nv in shares]

    def cost_of(chunk, tile_parts):
        return [min(chunk, n - i * chunk) * st + 1 + (tp > 1) * ws
                for n, tp in zip(pairs, tile_parts) for i in range(tp)
                for _ in range(b * hk) for st, ws in steps]

    p = _f32_best_parts(
        pairs, cost_of,
        lambda chunk, tile_parts: b * hk * len(shares) * sum(tile_parts), sms,
        F32_DKV_WAVES)
    chunk, tile_parts = _f32_cut(pairs, p)
    ws = p * b * skv * hk * (d + dv) * 4 if p > 1 else 0
    return F32DkvPlan(shares, group, tiles, p, chunk, tile_parts, ws)


def _f32_key_tiles(m0: int, keys: int, skv: int, causal: bool,
                   window: int):
    """``(first, n)``: the tiles of ``keys`` keys that the query tile at
    row ``m0`` visits (``key_tiles`` of ``csrc/flash_fwd_dq_f32.cuh``):
    causal up to the tile's last row, a window from the band's first key
    tile."""
    hi = min(skv, m0 + F32_Q_ROWS) if causal else skv
    lo = max(0, m0 - window + 1) // keys * keys if window else 0
    return lo // keys, (-(-(hi - lo) // keys) if hi > lo else 0)


class F32QPlan(NamedTuple):
    """How the f32 forward or dQ kernel, narrow or wide, cuts its work
    (``csrc/flash_fwd_dq_f32.cuh``; the C entries take ``parts``).
    ``shares``: each query tile's CTAs along the output's columns (O's Dv
    for the forward, dQ's D), ``(first column, columns)``. ``keys``: the
    keys of a tile. ``tiles``: each query tile's ``(first key tile, live
    key tiles)``. A query tile's sweep is cut into parts of ``chunk`` key
    tiles, ``tile_parts[t]`` of them (at least 1); ``parts`` (P) is the
    most. ``workspace_bytes``: the parts' f32 partials, 0 for P = 1 (no
    second pass): the forward's unnormalised O (P, B, Sq, H, Dv), then m
    and l, each (P, shares, B, H, Sq); dQ's sums (P, B, Sq, H, D)."""
    shares: list
    keys: int
    tiles: list
    parts: int
    chunk: int
    tile_parts: list
    workspace_bytes: int


@functools.lru_cache(maxsize=256)
def _f32_q_plan(kind: str, b: int, h: int, hk: int, sq: int, skv: int,
                d: int, dv: int, causal: bool, window: int, sms: int,
                parts: Optional[int] = None) -> F32QPlan:
    """The f32 forward's (``kind`` "fwd") or dQ's ("dq") cut on a card of
    ``sms`` SMs, at every kernel head dim ``d``, ``dv`` (up to 256: the
    narrow kernels, one column share; above: the wide ones), one CTA an
    SM; P = ``parts`` where given, else the P whose CTAs finish soonest by
    the makespan model of :func:`_f32_dkv_plan`, with no aim of filling two
    waves (at ``d512_s2048_f32`` P = 1's 256 CTAs beat P = 2's 384 on the
    card, as the model says: PERF.md). The grid runs the last query tile
    (the heaviest) first. A CTA's steps (a 64 x 64 x 64 box product for
    each of its two warpgroups) per key tile: the forward D / 64 logit
    steps (a 64-key half each) and two per two of its output boxes (both
    halves' keys), dQ max(D, Dv) / 64 (S beside dP) and one per two output
    boxes; its ring and its stores one more, and a part of a query tile of
    several one step per 256 columns for its partials."""
    fwd = kind == "fwd"
    keys = F32_FWD_KEYS if fwd else F32_DQ_KEYS
    width = dv if fwd else d
    shares = _even_shares(width, F32_COLUMNS)
    tiles = [_f32_key_tiles(t * F32_Q_ROWS, keys, skv, causal, window)
             for t in range(-(-sq // F32_Q_ROWS))]
    units = [n for _, n in tiles]
    box = WIDE_MULTIPLE
    steps = [((d // box + 2 * -(-cols // (2 * box))) if fwd
              else max(d, dv) // box + -(-cols // (2 * box)), cols / 256)
             for _, cols in shares]

    def cost_of(chunk, tile_parts):
        return [min(chunk, n - i * chunk) * st + 1 + (tp > 1) * ws
                for n, tp in zip(units[::-1], tile_parts[::-1])
                for i in range(tp) for _ in range(b * h) for st, ws in steps]

    if parts is None:  # a query tile with no live key tile still runs a part
        parts = _f32_best_parts(
            [max(n, 1) for n in units], cost_of,
            lambda chunk, tile_parts: b * h * len(shares) * sum(tile_parts),
            sms, 0)
    chunk, tile_parts = _f32_cut(units, parts)
    ws = 0
    if parts > 1:
        per = b * sq * h * width + (2 * len(shares) * b * h * sq if fwd else 0)
        ws = parts * per * 4
    return F32QPlan(shares, keys, tiles, parts, chunk, tile_parts, ws)


def _is_wide(d: int, dv: int) -> bool:
    """Whether kernel head dims ``(d, dv)`` are the wide kernels'."""
    return max(d, dv) > KERNEL_HEAD_DIMS[-1]


def _check_launch(tensors: dict, d: int, dv: int,
                  stats: Optional[dict] = None) -> None:
    """Raise on anything the kernels do not take: ``tensors`` of a dtype
    other than bf16 or f32 or of several dtypes, ``stats`` (lse, Delta)
    not f32, head dims the kernels are not built for, a tensor that is
    not CUDA or not contiguous, a tensor whose base is not 16-byte
    aligned (TMA and cp.async read 16 bytes at a time), several devices,
    a card that is not Hopper."""
    stats = stats or {}
    first = next(iter(tensors.values()))
    if first.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the kernel takes bf16 or f32, got {first.dtype}")
    if _kernel_head_dims(d, dv) != (d, dv):
        raise ValueError(
            f"the kernels are built for head dims {KERNEL_HEAD_DIMS} (256 "
            f"only with 256) and, when either is above 256, multiples of "
            f"{WIDE_MULTIPLE}; got D={d}, Dv={dv}")
    every = {**tensors, **stats}
    for name, x in every.items():
        want = torch.float32 if name in stats else first.dtype
        if x.dtype != want:
            raise ValueError(f"{name} is {x.dtype}, the kernel takes {want}")
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(
                f"{name}'s base address is not 16-byte aligned, which the "
                f"kernels' TMA and cp.async loads need (a view at an odd "
                f"offset?)")
    for name, x in every.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != first.device:
            raise ValueError("the kernel's tensors must be on one device")
    if not is_sm90(first.device):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(first.device)} is not one")


def _check_err(err: int, what: str, b, sq, skv, h, hk, d, dv) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaError_t {err} (B={b}, Sq={sq}, "
            f"Skv={skv}, H={h}, Hk={hk}, D={d}, Dv={dv})")


def _launch(q_hat, k, v, causal: bool, window: int,
            parts: Optional[int] = None):
    """Run the forward kernel on batched (B, S, H, D) tensors (the wide
    one above head dim 256). Checks what the kernel takes and raises on
    anything else. The f32 kernel gets the sweep parts P of
    :func:`_f32_q_plan` (``parts`` where given) and for P > 1 its
    workspace; the second pass is part of the same call (one launch
    counted)."""
    global launches
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if _is_wide(d, dv):
        return _launch_wide(q_hat, k, v, causal, window, parts=parts)[:2]
    lib = _kernel_lib()
    _check_launch({"q": q_hat, "k": k, "v": v}, d, dv)
    o = torch.empty((b, sq, h, dv), dtype=q_hat.dtype, device=q_hat.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q_hat.device)
    p, ws = _q_parts("fwd", q_hat, k, v, causal, window, parts)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_attention_fwd(
            _KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, hk, sq, skv, d, dv,
            int(causal), int(window), p, stream)
    _check_err(err, "flash_attention_fwd", b, sq, skv, h, hk, d, dv)
    launches += 1
    return o, lse


def _q_parts(kind, q_hat, k, v, causal: bool, window: int,
             parts: Optional[int]):
    """``(P, workspace or None)`` of the forward (``kind`` "fwd") or dQ
    ("dq") kernel, narrow or wide, on these batched tensors: 1 and none
    for bf16; for f32 :func:`_f32_q_plan`'s P (``parts`` where given) and,
    for P > 1, its f32 workspace."""
    if q_hat.dtype != torch.float32:
        return 1, None
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    plan = _f32_q_plan(kind, b, h, hk, sq, skv, d, dv, bool(causal),
                       int(window), _sm_count(q_hat.device), parts)
    ws = None
    if plan.workspace_bytes:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=q_hat.device)
    return plan.parts, ws


def _launch_wide(q_hat, k, v, causal: bool, window: int,
                 lse_chunks: bool = False, parts: Optional[int] = None):
    """Run the wide forward kernel (B3 above head dim 256) on batched
    tensors whose head dims it takes: ``(O, lse, chunks)``, ``chunks``
    being every CTA's own lse along the output's columns
    (:func:`_wide_column_chunks` of Dv), (chunks, B, H, Sq), when
    ``lse_chunks`` asks for it (a check that they agree), else None. The
    f32 kernel gets the sweep parts P of :func:`_f32_q_plan` (``parts``
    where given) and for P > 1 its workspace; the second pass is part of
    the same call (one launch counted)."""
    global wide_launches
    lib = _wide_lib()
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    _check_launch({"q": q_hat, "k": k, "v": v}, d, dv)
    o = torch.empty((b, sq, h, dv), dtype=q_hat.dtype, device=q_hat.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q_hat.device)
    chunks = None
    if lse_chunks:
        chunks = torch.empty((len(_wide_column_chunks(dv, q_hat.dtype)), b,
                              h, sq),
                             dtype=torch.float32, device=q_hat.device)
    p, ws = _q_parts("fwd", q_hat, k, v, causal, window, parts)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_attention_fwd_wide(
            _KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if chunks is None else chunks.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, hk, sq, skv, d, dv,
            int(causal), int(window), p, stream)
    _check_err(err, "flash_attention_fwd_wide", b, sq, skv, h, hk, d, dv)
    wide_launches += 1
    return o, lse, chunks


def _bwd_setup(q_hat, k, v, do, lse, delta):
    """The backward library (the wide one above head dim 256) and the
    dims (B, Sq, H, D, Skv, Hk, Dv) of batched inputs, after checking
    every shape, dtype and device the kernels read."""
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    lib = _wide_lib() if _is_wide(d, dv) else _bwd_lib()
    shapes = {"k": (k.shape, (b, skv, hk, d)),
              "v": (v.shape, (b, skv, hk, dv)),
              "do": (do.shape, (b, sq, h, dv)),
              "lse": (lse.shape, (b, h, sq)),
              "delta": (delta.shape, (b, h, sq))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} has shape {tuple(got)}, expected "
                             f"{want} for q_hat {tuple(q_hat.shape)}")
    if h % hk:
        raise ValueError(f"GQA needs kv_heads ({hk}) to divide heads ({h})")
    _check_launch({"q_hat": q_hat, "k": k, "v": v, "do": do}, d, dv,
                  {"lse": lse, "delta": delta})
    return lib, (b, sq, h, d, skv, hk, dv)


def _launch_bwd_dq(q_hat, k, v, do, lse, delta, causal: bool, window: int,
                   scale: float, parts: Optional[int] = None):
    """Run the dQ kernel (B4; the wide one above head dim 256): dQ in
    q's dtype, (B, Sq, H, D). The f32 kernels get the sweep parts P of
    :func:`_f32_q_plan` (``parts`` where given) and for P > 1 its
    workspace; the second pass is part of the same call (one launch
    counted)."""
    global bwd_dq_launches, wide_dq_launches
    lib, (b, sq, h, d, skv, hk, dv) = _bwd_setup(q_hat, k, v, do, lse,
                                                 delta)
    wide = _is_wide(d, dv)
    dq = torch.empty_like(q_hat)
    args = (q_hat.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    dims = (b, h, hk, sq, skv, d, dv, int(causal), int(window))
    p, ws = _q_parts("dq", q_hat, k, v, causal, window, parts)
    fn = (lib.marlin_flash_attention_bwd_dq_wide if wide
          else lib.marlin_flash_attention_bwd_dq)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_KERNEL_DTYPES[q_hat.dtype], *args,
                 None if ws is None else ws.data_ptr(), *dims, p,
                 float(scale), stream)
    _check_err(err, "flash_attention_bwd_dq" + "_wide" * wide, b, sq, skv,
               h, hk, d, dv)
    if wide:
        wide_dq_launches += 1
    else:
        bwd_dq_launches += 1
    return dq


def _sm_count(device) -> int:
    """The card's SM count, which the plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_bwd_dkv(q_hat, k, v, do, lse, delta, causal: bool,
                    window: int):
    """Run the dK/dV kernel (B5; the wide one above head dim 256): (dK,
    dV) in k's dtype, summed over each KV head's group of query heads. The
    f32 kernels get the sweep parts P of :func:`_f32_dkv_plan`, the bf16
    wide kernel the group parts of :func:`_wide_dkv_plan`, and for more
    than one their f32 workspace; the second pass is part of the same
    call (one launch counted)."""
    global bwd_dkv_launches, wide_dkv_launches
    lib, (b, sq, h, d, skv, hk, dv) = _bwd_setup(q_hat, k, v, do, lse,
                                                 delta)
    wide = _is_wide(d, dv)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    parts, ws = 1, None
    if q_hat.dtype == torch.float32:
        plan = _f32_dkv_plan(b, h, hk, sq, skv, d, dv, bool(causal),
                             int(window), _sm_count(q_hat.device))
        parts, ws_bytes = plan.parts, plan.workspace_bytes
    elif wide:
        plan = _wide_dkv_plan(b, h, hk, skv, d, dv, _sm_count(q_hat.device))
        parts, ws_bytes = plan.group_parts, plan.workspace_bytes
    else:
        ws_bytes = 0
    if ws_bytes:
        ws = torch.empty(ws_bytes // 4, dtype=torch.float32,
                         device=q_hat.device)
    fn = (lib.marlin_flash_attention_bwd_dkv_wide if wide
          else lib.marlin_flash_attention_bwd_dkv)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
                 None if ws is None else ws.data_ptr(), b, h, hk, sq, skv, d,
                 dv, int(causal), int(window), parts, stream)
    _check_err(err, "flash_attention_bwd_dkv" + "_wide" * wide, b, sq, skv,
               h, hk, d, dv)
    if wide:
        wide_dkv_launches += 1
    else:
        bwd_dkv_launches += 1
    return dk, dvv


def _delta(do, o):
    """Delta = rowsum(dO * O) in f32, (B, H, Sq): one f32 copy of dO
    multiplied by O in place, then summed (the JAX package leaves this to
    XLA, outside any kernel)."""
    return (do.to(torch.float32, copy=True).mul_(o).sum(-1)
            .transpose(1, 2).contiguous())


def _launch_bwd(q_hat, k, v, do, lse, delta, causal: bool, window: int,
                scale: float):
    """Both backward kernels: ``(dQ, dK, dV)``."""
    dq = _launch_bwd_dq(q_hat, k, v, do, lse, delta, causal, window, scale)
    dk, dvv = _launch_bwd_dkv(q_hat, k, v, do, lse, delta, causal, window)
    return dq, dk, dvv


def _kernel_head_dim(width: int, name: str) -> int:
    """The smallest entry of :data:`KERNEL_HEAD_DIMS` that holds a head
    dim of ``width``; above the largest, ``width`` rounded up to a
    multiple of :data:`WIDE_MULTIPLE` (the wide kernels'). ``name`` ("D"
    or "Dv") names the dim in the error for a width below 1."""
    if width < 1:
        raise ValueError(f"{name}={width}: a head dim is at least 1")
    for kernel_width in KERNEL_HEAD_DIMS:
        if width <= kernel_width:
            return kernel_width
    return -(-width // WIDE_MULTIPLE) * WIDE_MULTIPLE


def _kernel_head_dims(d: int, dv: int) -> Tuple[int, int]:
    """The kernel head dims ``(D, Dv)`` that hold ``(d, dv)``: when
    either is above 256, each rounded up to a multiple of
    :data:`WIDE_MULTIPLE` on its own (the wide kernels); else each the
    smallest of 64 and 128 that holds it, or both 256 when either is above
    128 (the only narrow instantiation at 256 is D = Dv = 256)."""
    dp, dvp = _kernel_head_dim(d, "D"), _kernel_head_dim(dv, "Dv")
    if max(d, dv) > KERNEL_HEAD_DIMS[-1]:
        return (-(-d // WIDE_MULTIPLE) * WIDE_MULTIPLE,
                -(-dv // WIDE_MULTIPLE) * WIDE_MULTIPLE)
    if max(dp, dvp) > 128:
        return 256, 256
    return dp, dvp


def _pad_to(x, width: int):
    """``x`` with its last dimension zero-padded to ``width`` (``x``
    itself when it is that wide already)."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _padded_fwd(fwd, q_hat, k, v, causal: bool, window: int):
    """``fwd`` (the forward kernel's launch or the plain version) on
    q_hat and K zero-padded to the kernel head dim of D and V to that of
    Dv, and O sliced back to Dv. Zero columns add nothing to q_hat K^T or
    P V, so ``(O, lse)`` is the unpadded function's."""
    d, dv = q_hat.shape[-1], v.shape[-1]
    dp, dvp = _kernel_head_dims(d, dv)
    o, lse = fwd(_pad_to(q_hat, dp), _pad_to(k, dp), _pad_to(v, dvp),
                 causal, window)
    return o[..., :dv].contiguous(), lse


def _padded_bwd(bwd, q_hat, k, v, do, lse, delta, causal: bool,
                window: int, scale: float):
    """``bwd`` (:func:`_launch_bwd` or its plain twin
    :func:`_bwd_reference`) on q_hat and K zero-padded as in
    :func:`_padded_fwd`, V and dO to the kernel head dim of Dv, and dQ,
    dK, dV sliced back. ``scale`` is the unpadded D's (the caller's);
    Delta = rowsum(dO * O) is the same with or without zero columns."""
    d, dv = q_hat.shape[-1], v.shape[-1]
    dp, dvp = _kernel_head_dims(d, dv)
    dq, dk, dvv = bwd(_pad_to(q_hat, dp), _pad_to(k, dp), _pad_to(v, dvp),
                      _pad_to(do, dvp), lse, delta, causal, window, scale)
    return (dq[..., :d].contiguous(), dk[..., :d].contiguous(),
            dvv[..., :dv].contiguous())


def _forward(q_hat, k, v, causal: bool, window: int):
    """``(O, lse)`` on batched tensors: the plain version for CPU tensors,
    the kernel at its head dims (or an error) for any other."""
    if q_hat.device.type == "cpu":
        return flash_attention_reference(q_hat, k, v, causal, window)
    return _padded_fwd(_launch, q_hat.contiguous(), k.contiguous(),
                       v.contiguous(), causal, window)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on batched (B, S, H, D) tensors: the
    counterpart of the JAX package's ``_flash_hsd`` custom_vjp. The
    forward runs the forward kernel (the plain version on the CPU) and
    saves only ``(q_hat, k, v, o, lse)``, unpadded; the backward computes
    Delta with one torch op and runs the dQ and dK/dV kernels on inputs
    padded again to the kernel head dims (the plain backward on the CPU).
    Returns ``(O, lse)``; lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        q_hat, k, v = (x.contiguous() for x in
                       _prepare(q, k, v, causal, scale, window))
        o, lse = _forward(q_hat, k, v, causal, window)
        ctx.save_for_backward(q_hat, k, v, o, lse)
        ctx.causal, ctx.window = bool(causal), int(window)
        ctx.scale = (1.0 / math.sqrt(q.shape[-1]) if scale is None
                     else float(scale))
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q_hat, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # autograd may hand over a strided gradient
        if q_hat.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(
                q_hat, k, v, o, lse, do, ctx.causal, ctx.window, ctx.scale)
        else:
            dq, dk, dv = _padded_bwd(_launch_bwd, q_hat, k, v, do, lse,
                                     _delta(do, o), ctx.causal, ctx.window,
                                     ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: O = softmax(Q K^T * scale) V in q's dtype and the
    per-row log2-sum-exp (B, H, Sq) f32 (without a batch dimension: O
    (Sq, H, Dv), lse (H, Sq)). CPU tensors take the plain versions; CUDA
    tensors take the kernels or raise. Differentiable in q, k and v
    through :class:`FlashAttentionFunction` when grad is enabled and one
    of them requires grad; otherwise a direct call (one forward launch,
    nothing saved)."""
    if q.dim() == 3 and k.dim() == 3 and v.dim() == 3:
        o, lse = flash_attention_fwd(q[None], k[None], v[None], causal,
                                     scale, window)
        return o[0], lse[0]
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, window)
    q_hat, k, v = _prepare(q, k, v, causal, scale, window)
    return _forward(q_hat, k, v, causal, window)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, window: int = 0
                    ) -> torch.Tensor:
    """softmax(Q K^T * scale) V, flash-tiled: the counterpart of
    ``marlin_tpu.ops.flash_attention.flash_attention``, forward and
    backward.

    Shapes: (S, H, D) or (B, S, H, D); K/V lengths may differ from Q's
    (cross attention), K/V may carry fewer heads (GQA/MQA: Hk divides H,
    q-head h reads K/V head h // (H // Hk)), and V's head dim may differ
    from D. ``window`` > 0 (requires ``causal``) restricts each query to
    the last ``window`` key positions."""
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]
