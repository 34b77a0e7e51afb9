"""Causal transformer LM, training and inference — port of
``marlin_tpu/models/transformer.py``.

Same configuration, same params layout (a nested dict of tensors with the
JAX pytree's keys and shapes), same functions under the same names, in
PyTorch idiom: eager code with the batch dimension written out where JAX
used ``vmap``, Python loops where JAX used ``scan``/``while_loop``, and
in-place KV-cache writes where JAX donated the cache. Prompt attention
(``_attend_local``) is the flash-attention kernel of
:mod:`marlin_tpu_torch.ops.flash_attention`, differentiable through its
backward kernels; the projections, the MLP, layer norm, RoPE, the
chunked cross-entropy, the cached decode attention, the chunk paths
(:func:`decode_step`, :func:`decode_chunk`, :func:`prefill_chunk`, in
tiles of one fixed shape each), the paged reads and writes
(:func:`gather_kv_pages`, :func:`decode_chunk_paged`,
:func:`prefill_chunk_paged`), prompt-lookup speculation
(:func:`generate_speculative`), the int8 weights and KV cache
(:mod:`.quant`) and sampling stay plain torch, as the JAX package left
them to XLA. Training is autograd over the same functions:
:func:`loss_fn`, :func:`train_step` (SGD, f32 master params) and
:func:`make_train_step` (a ``torch.optim`` optimizer); ``cfg.remat``
checkpoints each block.

Tensor parallelism (``cfg.tp > 1``, :mod:`.tp`): the block bodies run
unchanged on each shard at the local extents (``cfg.tp_heads``,
``tp_kv_heads``, ``tp_ff``), and :func:`_tp_out` is their only
collective. Outside autograd every column-sharded projection runs one
GEMM a column unit (:func:`tp_units`) and the cached attention one KV
head a call, at every degree (tp 1 included): a cuBLAS GEMM does not
give a column the same bits at another column count, so this is what
makes TP = N bitwise TP = 1.

Sequence parallelism (``cfg.sequence_parallel``) routes attention through
:func:`..parallel.ulysses.sequence_parallel_attention` and the MoE MLP
(``cfg.n_experts`` = the shard count) through
:func:`..parallel.expert.expert_parallel_apply`, both over the default
shard axis (:mod:`..parallel.shards`); under either the batch runs one
sequence at a time (:func:`_map_seqs`), as the JAX package unrolls it.
The refusals that remain are the JAX package's, in its words: prefill
under SP, the chunk, paged and speculative paths and serving under MoE.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..obs.trace import tracer as _tracer
from ..ops.flash_attention import flash_attention
from ..parallel.shards import tree_leaves as _leaves
from ..parallel.shards import tree_map as _tree_map
from ..utils.hw import resolve_device
from .quant import is_quantized, kv_quantize


class TransformerConfig(NamedTuple):
    """The JAX package's ``TransformerConfig``, field for field."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 512
    sequence_parallel: bool = False
    n_experts: int = 0
    moe_capacity: float = 2.0
    n_kv_heads: int = 0  # 0 = n_heads; fewer = GQA/MQA (must divide n_heads)
    rope: bool = False  # rotary position embeddings instead of learned ones
    window: int = 0  # >0: sliding-window (causal) attention span
    remat: bool = False  # checkpoint each block under autograd (training)
    dtype: str = "float32"  # compute dtype of params, activations, KV cache
    kv_quant: str = ""
    tp: int = 1  # tensor-parallel degree (models/tp.py)
    tp_mode: str = "gather"  # "gather" (bitwise) or "psum" (allclose)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    # Per-shard extents under tensor parallelism (the global ones at tp 1).

    @property
    def tp_heads(self) -> int:
        return self.n_heads // self.tp

    @property
    def tp_kv_heads(self) -> int:
        return self.kv_heads // self.tp

    @property
    def tp_ff(self) -> int:
        return self.d_ff // self.tp

    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


def validate_tp(cfg: TransformerConfig) -> None:
    """The tensor-parallel config contract, checked at param init and at
    every TP surface (models/tp.py, the serving engine): the degree must
    divide every sharded extent (attention heads, GQA KV heads: each
    shard keeps WHOLE query groups, so grouped attention stays local; the
    MLP hidden dim), and the reassembly mode must be known."""
    if cfg.tp < 1:
        raise ValueError(f"tp must be >= 1, got {cfg.tp}")
    if cfg.tp_mode not in ("gather", "psum"):
        raise ValueError(
            f"unknown tp_mode {cfg.tp_mode!r}; supported: 'gather' "
            "(bit-exact, two all_gathers per sub-layer) or 'psum' "
            "(Megatron row-parallel, one psum, allclose-only)")
    if cfg.tp == 1:
        return
    if cfg.n_heads % cfg.tp or cfg.kv_heads % cfg.tp or cfg.d_ff % cfg.tp:
        raise ValueError(
            f"tp {cfg.tp} must divide n_heads {cfg.n_heads}, kv_heads "
            f"{cfg.kv_heads}, and d_ff {cfg.d_ff} (per-device extents "
            "must be whole heads / whole hidden columns)")
    if cfg.n_experts:
        raise ValueError(
            "tp > 1 does not compose with the MoE MLP (parallel.expert "
            "owns the device axis there); use dense blocks")
    if cfg.sequence_parallel:
        raise ValueError(
            "tp > 1 does not compose with sequence_parallel (the SP "
            "engines place their own shardings)")


def _sp_conflict(cfg: TransformerConfig) -> Optional[str]:
    """Why this config cannot route through the SP engines (None if it
    can), checked at param init and again at attention dispatch
    (``sequence_parallel`` is a runtime flag: params are shape-identical
    across it). GQA composes with both engines (the ring streams the
    reduced K/V stripes; all-to-all shards KV heads when divisible, else
    the dispatcher falls back to the ring), so nothing conflicts; the
    hook is where a future engine contract lands."""
    return None


def tp_units(cfg: TransformerConfig) -> int:
    """Column units of a column-sharded projection: the largest degree
    :func:`validate_tp` accepts for ``cfg`` (the gcd of the heads, the
    KV heads and d_ff), so a shard at any degree holds whole units. A
    degree-independent count: every degree, 1 included, runs the same
    GEMM shapes (:func:`_proj`)."""
    return math.gcd(math.gcd(cfg.n_heads, cfg.kv_heads), cfg.d_ff)


def _validate(cfg: TransformerConfig) -> None:
    validate_tp(cfg)
    if cfg.sequence_parallel and _sp_conflict(cfg):
        raise ValueError(_sp_conflict(cfg))
    if cfg.n_heads % cfg.kv_heads:
        raise ValueError(
            f"n_kv_heads {cfg.kv_heads} must divide n_heads {cfg.n_heads}")
    if cfg.window < 0:
        raise ValueError(f"window must be >= 0, got {cfg.window}")
    if cfg.rope and (cfg.d_model // cfg.n_heads) % 2:
        raise ValueError(
            f"rope needs an even per-head dim, got "
            f"{cfg.d_model // cfg.n_heads} (rotation pairs dim i with "
            f"i + Dh/2)")


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda"):
    """Params dict with the JAX pytree's layout and shapes, scaled-normal
    from a ``torch.Generator`` seeded with ``seed`` (the numbers differ
    from JAX's threefry draws; :func:`..models.convert.params_from_jax`
    carries JAX weights across). ``wqkv`` packs Q (D columns) then K and
    V (kv_heads * Dh columns each), head-major. With ``cfg.n_experts`` a
    block's MLP is a bank of experts: ``router`` (d, E), ``w1`` (E, d, f),
    ``b1`` (E, f), ``w2`` (E, f, d), ``b2`` (E, d). Master params are
    f32."""
    _validate(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, f = cfg.d_model, cfg.d_ff
    kv_d = cfg.kv_heads * (d // cfg.n_heads)

    def norm(*shape, scale=None):
        scale = float(scale) if scale is not None else 1.0 / math.sqrt(shape[0])
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    def ln():
        return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}

    params = {"embed": norm(cfg.vocab, d, scale=0.02), "ln_f": ln(),
              "blocks": []}
    if not cfg.rope:
        params["pos"] = norm(cfg.max_len, d, scale=0.02)
    for _ in range(cfg.n_layers):
        blk = {"ln1": ln(), "ln2": ln(), "wqkv": norm(d, d + 2 * kv_d),
               "wo": norm(d, d)}
        if cfg.n_experts:
            e = cfg.n_experts
            blk.update({
                "router": norm(d, e, scale=0.02),
                "w1": norm(e, d, f, scale=1.0 / math.sqrt(d)),
                "b1": torch.zeros((e, f), device=dev),
                "w2": norm(e, f, d, scale=1.0 / math.sqrt(f)),
                "b2": torch.zeros((e, d), device=dev),
            })
        else:
            blk.update({"w1": norm(d, f), "b1": torch.zeros(f, device=dev),
                        "w2": norm(f, d), "b2": torch.zeros(d, device=dev)})
        params["blocks"].append(blk)
    return params


def _cast_params(params, cfg: TransformerConfig):
    """Cast every float leaf (LN gains and biases included) to the
    compute dtype; a no-op when the params already are (the engine and
    ``generate`` cast once, so later calls cost nothing). Int8 leaves
    (:mod:`.quant`'s ``{"q8", "s8"}``) keep their int8 ``q8``; their f32
    scales are cast like any float leaf."""
    dt = cfg.compute_dtype
    emb = params["embed"]
    if (emb["s8"] if isinstance(emb, dict) else emb).dtype == dt:
        return params
    return _tree_map(
        lambda p: p.to(dt) if p.is_floating_point() else p, params)


def params_device(params) -> torch.device:
    """The device the params (float or int8) live on."""
    emb = params["embed"]
    return (emb["q8"] if isinstance(emb, dict) else emb).device


def _deq(w, dt):
    """A possibly int8 weight (:mod:`.quant`) at ``dt`` for a matmul: the
    plain version materialises ``q8 * s8`` (the JAX package fuses it into
    the dot's operand load)."""
    if isinstance(w, dict):
        return w["q8"].to(dt) * w["s8"].to(dt)
    return w


def _embed_rows(params, tokens, dt):
    """Token rows of the (possibly int8) embed table at ``dt``: the int8
    path gathers int8 rows and scales each by its row's s8."""
    emb = params["embed"]
    if isinstance(emb, dict):
        return emb["q8"][tokens].to(dt) * emb["s8"][tokens].to(dt)
    return emb[tokens].to(dt)


def _readout(params, x):
    """Tied readout: vocab logits x @ embed.T. The int8 path scales AFTER
    the matmul (s8 is a per-vocab-column scale there), so no scaled float
    table is formed."""
    emb = params["embed"]
    if isinstance(emb, dict):
        return (x @ emb["q8"].T.to(x.dtype)) * emb["s8"][:, 0].to(x.dtype)
    return x @ emb.T


def _layer_norm(p, x, eps=1e-5):
    # Stats in >= f32 (population variance, as jnp.var), after casting
    # g and b to that dtype.
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].to(xf.dtype) + p["b"].to(xf.dtype)).to(x.dtype)


def _attend_local(q, k, v, cfg: TransformerConfig):
    """(B, S, H, Dh) causal attention through the flash kernel (its plain
    version on CPU tensors)."""
    return flash_attention(q, k, v, causal=True, window=cfg.window)


def _attend_sp(q, k, v, cfg: TransformerConfig):
    """(B, S, H, Dh) causal attention through the sequence-parallel
    engines over the default shard axis, one sequence a call."""
    from ..parallel.ulysses import sequence_parallel_attention

    conflict = _sp_conflict(cfg)  # see _sp_conflict on why re-checked here
    if conflict:
        raise ValueError(conflict)
    return torch.stack([
        sequence_parallel_attention(q[i], k[i], v[i], causal=True,
                                    window=cfg.window)
        for i in range(q.shape[0])])


def _moe_expert(p, tok):
    """One expert's MLP on a (tokens, d) batch."""
    w1, b1, w2, b2 = p
    return F.gelu(tok @ w1 + b1, approximate="tanh") @ w2 + b2


def _moe_apply(bp, y, cfg: TransformerConfig):
    """Route (T, D) activations through the expert engine, padding T up to
    a multiple of the expert count. Pad tokens get one-hot round-robin
    gates, so no single expert's capacity bucket absorbs them all; their
    outputs are sliced off."""
    from ..parallel.expert import expert_parallel_apply

    t = y.shape[0]
    n = cfg.n_experts
    gates = y @ bp["router"]  # (T, E)
    pad = (-t) % n
    if pad:
        y = torch.cat([y, y.new_zeros((pad, y.shape[1]))])
        rr = F.one_hot(torch.arange(pad, device=y.device) % n, n).to(
            gates.dtype) * 1e9
        gates = torch.cat([gates, rr])
    out = expert_parallel_apply(
        _moe_expert, (bp["w1"], bp["b1"], bp["w2"], bp["b2"]), y, gates,
        capacity_factor=cfg.moe_capacity)
    return out[:t]


def _proj(x, w, cfg: TransformerConfig):
    """``x @ w`` for a column-sharded projection (``w``: this shard's
    columns, already dequantized), one GEMM a column unit of width
    (global columns) / :func:`tp_units`. A cuBLAS GEMM does not give a
    column the same bits at another column count (on the H100 a
    (64, 4096) @ (4096, 512) product differs from the 1024-column one in
    most of its columns): with one shape a unit at every degree, each
    output column is computed by the same call shape at tp 1 and tp N.
    Under autograd (training, which never runs sharded) it stays one
    GEMM."""
    width = w.shape[-1] * cfg.tp // tp_units(cfg)
    if torch.is_grad_enabled() or width >= w.shape[-1]:
        return x @ w
    return torch.cat([x @ w[:, j:j + width]
                      for j in range(0, w.shape[-1], width)], dim=-1)


def _tp_out(y, w, cfg: TransformerConfig, bias=None):
    """A sub-layer's down projection: ``y`` is this shard's slice of the
    up projection's output (its attention heads, or its MLP hidden
    columns), ``w`` the down-projection weight (possibly int8). At tp 1
    the plain product (in column units, :func:`_proj`).

    ``"gather"`` (the default): ``w`` is column-sharded; ``y`` is
    all-gathered on the feature axis, multiplied by the local column
    block and the output all-gathered. Every output column is one
    full-width dot on one shard, the same GEMM as at tp 1: bitwise.

    ``"psum"``: ``w`` is row-sharded and the partial products are summed
    in rank order. One collective, but the split contraction reassociates
    the sum: allclose only.

    ``bias`` (replicated) goes on after the collective, once, as its own
    op (an addmm epilogue would round bf16 once where this rounds
    twice)."""
    w = _deq(w, y.dtype)
    if cfg.tp == 1:
        out = _proj(y, w, cfg)
    else:
        from .tp import current_shard

        shard = current_shard()
        if cfg.tp_mode == "gather":
            out = shard.all_gather(_proj(shard.all_gather(y, -1), w, cfg),
                                   -1)
        else:
            out = shard.all_reduce(y @ w)
    if bias is not None:
        out = out + bias
    return out


def _mlp_residual(bp, x, cfg: TransformerConfig, rows: Optional[int] = None):
    """ln2 -> (dense MLP (tanh-approximate gelu, jax.nn.gelu's default) |
    MoE routing) -> residual on (B, T, D) activations. Under TP the local
    w1 columns (b1 rides with them) feed :func:`_tp_out`; b2 is replicated
    and added after the collective. The MoE routes the B x ``rows`` real
    positions (default all T) as one (tokens, D) batch, row-major, and
    leaves a tile's pad rows without an MLP update."""
    y = _layer_norm(bp["ln2"], x)
    if cfg.n_experts:
        b, t, d = y.shape
        n = t if rows is None else rows
        out = _moe_apply(bp, y[:, :n].reshape(b * n, d), cfg)
        return x + F.pad(out.reshape(b, n, d), (0, 0, 0, t - n))
    y = F.gelu(_proj(y, _deq(bp["w1"], y.dtype), cfg) + bp["b1"],
               approximate="tanh")
    return x + _tp_out(y, bp["w2"], cfg, bias=bp["b2"])


def _rope(x, positions, base: float = 10000.0):
    """Rotary embedding on (..., T, H, Dh) with ``positions`` (..., T):
    dim i pairs with i + Dh/2 (half split, not interleaved); computed in
    f32 and cast back."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _split_qkv(bp, x, cfg: TransformerConfig, positions=None):
    """ln1 -> fused projection -> q (B, T, H, Dh), k/v (B, T, Hk, Dh);
    with ``cfg.rope`` Q and K are rotated by ``positions`` (B, T), so
    cached keys are stored rotated. Under TP ``bp["wqkv"]`` is this
    shard's permuted column block ``[q_local | k_local | v_local]``
    (models/tp.py lays whole heads a shard), so the split points are the
    LOCAL head counts, the global ones at tp 1. Outside autograd Q, K and
    V each run in column units (:func:`_proj`)."""
    if cfg.tp > 1:
        from .tp import current_shard

        current_shard()  # raises outside a shard run: unsharded weights
    b, t, d = x.shape
    h, hk = cfg.tp_heads, cfg.tp_kv_heads
    dh = d // cfg.n_heads
    y = _layer_norm(bp["ln1"], x)
    w = _deq(bp["wqkv"], x.dtype)
    sizes = [h * dh, hk * dh, hk * dh]
    if torch.is_grad_enabled():
        q, k, v = torch.split(y @ w, sizes, dim=-1)
    else:
        q, k, v = (_proj(y, part, cfg)
                   for part in torch.split(w, sizes, dim=1))
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, hk, dh)
    if cfg.rope:
        if positions is None:
            raise ValueError("cfg.rope requires positions")
        q = _rope(q, positions)
        k = _rope(k, positions)
    return q, k, v.reshape(b, t, hk, dh)


def _block(bp, x, cfg: TransformerConfig, return_kv: bool = False):
    """One pre-LN block on (B, S, D) activations; ``return_kv`` also
    yields the block's K/V (B, S, Hk, Dh) for priming the decode cache."""
    b, s, _ = x.shape
    positions = (torch.arange(s, device=x.device).expand(b, s)
                 if cfg.rope else None)
    q, k, v = _split_qkv(bp, x, cfg, positions=positions)
    attend = _attend_sp if cfg.sequence_parallel else _attend_local
    att = attend(q, k, v, cfg).reshape(b, s, -1)  # local heads under TP
    x = _mlp_residual(bp, x + _tp_out(att, bp["wo"], cfg), cfg)
    return (x, k, v) if return_kv else x


def _embed_prefix(params, tokens, cfg: TransformerConfig):
    """(B, S) tokens -> (B, S, D) embeddings, plus the learned position
    table for [0, S) unless rope rotates Q/K instead."""
    x = _embed_rows(params, tokens, cfg.compute_dtype)
    if not cfg.rope:
        x = x + params["pos"][None, : tokens.shape[1]].to(x.dtype)
    return x


def _map_seqs(fn, x, cfg: TransformerConfig):
    """``fn`` over the batch: the whole (B, S, D) batch at once normally;
    one (1, S, D) sequence at a time under SP or EP, as the JAX package
    unrolls them (an SP call attends one sequence; MoE capacity is per
    sequence's token count, so batching sequences through the router
    would change which tokens drop). ``fn`` may return a tuple (prefill's
    (x, k, v)); the sequences' results are concatenated in order."""
    if not (cfg.sequence_parallel or cfg.n_experts):
        return fn(x)
    outs = [fn(x[i:i + 1]) for i in range(x.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def hidden_states(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> final-LN hidden states (B, S, D). With
    ``cfg.remat`` under autograd each block runs under
    ``torch.utils.checkpoint``: it saves only its input and the backward
    re-runs its forward (one more flash forward launch per block; the
    flash backward's recompute is tile-local either way). Under SP or EP
    the sequences run one at a time (:func:`_map_seqs`)."""
    _validate(cfg)
    params = _cast_params(params, cfg)
    x = _embed_prefix(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()

    def blocks(xs):
        for bp in params["blocks"]:
            if remat:
                xs = checkpoint(_block, bp, xs, cfg, use_reentrant=False)
            else:
                xs = _block(bp, xs, cfg)
        return xs

    return _layer_norm(params["ln_f"], _map_seqs(blocks, x, cfg))


def forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> logits (B, S, vocab)."""
    _validate(cfg)
    params = _cast_params(params, cfg)
    return _readout(params, hidden_states(params, tokens, cfg))


# ---------------------------------------------------------------------------
# Training: chunked cross-entropy, SGD and optimizer steps
# ---------------------------------------------------------------------------

# Positions per readout chunk in loss_fn (the JAX package's default; tests
# monkeypatch it).
_CE_CHUNK = 2048


def _nll(h, embed, targets):
    """Summed next-token negative log-likelihood of hidden states ``h``
    (..., D) against ``targets`` (...): readout, f32 log-softmax, gather."""
    logp = torch.log_softmax((h @ embed.T).to(torch.float32), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0]


def _chunk_nll(hx, embed, tx, valid):
    return torch.where(valid, _nll(hx, embed, tx), 0.0).sum()


def loss_fn(params, tokens, targets, cfg: TransformerConfig):
    """Mean next-token cross-entropy; tokens and targets (B, S) integers.

    The readout and cross-entropy run chunked over the FLAT B*S position
    axis, ``_CE_CHUNK`` positions at a time, each chunk under
    ``torch.utils.checkpoint`` so neither the forward nor the saved state
    ever holds the (B*S, vocab) logits; a tail chunk is zero-padded and
    masked. With B*S <= ``_CE_CHUNK`` the readout runs in one piece."""
    _validate(cfg)
    if is_quantized(params):
        raise ValueError(
            "int8-quantized params are inference-only (decode, prefill, "
            "forward); train with the float masters (models/quant.py)")
    params = _cast_params(params, cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    targets = torch.as_tensor(targets, dtype=torch.long, device=dev)
    h = hidden_states(params, tokens, cfg)
    b, s, d = h.shape
    total = b * s
    if total <= _CE_CHUNK:
        return _nll(h, params["embed"], targets).mean()
    pad = (-total) % _CE_CHUNK
    hf = F.pad(h.reshape(total, d), (0, 0, 0, pad))
    tf = F.pad(targets.reshape(total), (0, pad))
    valid = torch.arange(total + pad, device=dev) < total
    nll = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, total + pad, _CE_CHUNK):
        sl = slice(c0, c0 + _CE_CHUNK)
        nll = nll + checkpoint(_chunk_nll, hf[sl], params["embed"], tf[sl],
                               valid[sl], use_reentrant=False)
    return nll / total


def _unflatten(tree, it):
    """``tree``'s layout with its leaves taken, in order, from ``it``."""
    return _tree_map(lambda _: next(it), tree)


def train_step(params, tokens, targets, cfg: TransformerConfig,
               lr: float = 0.1):
    """One SGD step: ``(loss, new_params)``. Gradients flow back through
    the compute-dtype casts, so master params (f32 from
    :func:`init_params`) stay in their own dtype; ``params`` is not
    modified (the JAX package's functional step)."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, iter(leaves)), tokens, targets,
                       cfg)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, iter(new))


def make_train_step(cfg: TransformerConfig, optimizer, **optimizer_kwargs):
    """Bind a ``torch.optim`` optimizer class to the model, the
    counterpart of the JAX package's optax binding: returns
    ``(step_fn, init_opt_state)``. ``init_opt_state(params)`` marks every
    leaf as requiring grad and returns ``optimizer(leaves,
    **optimizer_kwargs)``; ``step_fn(params, opt_state, tokens, targets)
    -> (loss, params, opt_state)`` updates the params IN PLACE (the torch
    optimizer's way) and returns the same dict. The same params can then
    be served: the inference entry points run under ``torch.no_grad``,
    so no autograd graph reaches the KV cache."""

    def init_opt_state(params):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return optimizer(leaves, **optimizer_kwargs)

    def step(params, opt_state, tokens, targets):
        opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(params, tokens, targets, cfg)
            loss.backward()
        opt_state.step()
        return loss.detach(), params, opt_state

    return step, init_opt_state


# ---------------------------------------------------------------------------
# Inference: KV cache, prefill, decode
# ---------------------------------------------------------------------------

# The inference entry points (prefill, decode_step, decode_chunk, generate)
# run under torch.no_grad, as the JAX package's are pure functions: params
# that require grad (after make_train_step) build no autograd graph, and
# the in-place cache writes chain none from one decode step to the next.


def _cache_len(cfg: TransformerConfig) -> int:
    return min(cfg.window, cfg.max_len) if cfg.window else cfg.max_len


def init_kv_cache(cfg: TransformerConfig, batch: int,
                  dtype=torch.float32, device="cuda"):
    """Per-layer K/V buffers at the static (B, cache_len, Hk, Dh) extent;
    a sliding window makes the cache a ring of min(window, max_len)
    slots (slot = position mod cache_len). With ``cfg.kv_quant="int8"``
    the slots are int8 and each layer also carries f32 scale buffers
    ``ks``/``vs`` (B, cache_len, Hk, 1), one a stored vector
    (:func:`.quant.kv_quantize`); ``dtype`` is then unused. Under tensor
    parallelism the buffers hold one shard's heads (Hk = ``cfg.
    tp_kv_heads``): models/tp.py places one such cache a shard."""
    validate_tp(cfg)
    dev = resolve_device(device)
    shape = (batch, _cache_len(cfg), cfg.tp_kv_heads,
             cfg.d_model // cfg.n_heads)
    if cfg.kv_quant:
        if cfg.kv_quant != "int8":
            raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}; "
                             "supported: 'int8'")
        sshape = shape[:-1] + (1,)
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "ks": torch.ones(sshape, dtype=torch.float32, device=dev),
                 "vs": torch.ones(sshape, dtype=torch.float32, device=dev)}
                for _ in range(cfg.n_layers)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _attend_cached(q, ck, cv, pos, ks=None, vs=None, window=0):
    """Query positions against the cache: q (B, C, H, Dh), ck/cv (B, T,
    Hk, Dh), ``pos`` (B, C) absolute positions; ``ks``/``vs`` (B, T, Hk,
    1) are an int8 cache's scales (dequantized here, in f32). Without a
    window slot == position (slots > pos masked); with one the cache is a
    ring (slot s holds position base + s for s <= pos mod T, else base -
    T + s, with base = pos - pos mod T; unfilled slots are masked). f32
    logits divided by sqrt(Dh) after the product, -1e30 masks, f32
    softmax.

    One KV head a call, on contiguous operands: a batched GEMM over B x
    Hk heads need not give a head the same bits at another head count
    (on the H100 it does not at B = 1), so this makes a head's result
    independent of how many heads a tensor-parallel shard holds."""
    b, c, h, dh = q.shape
    t, hk = ck.shape[1], ck.shape[2]
    g = h // hk
    slots = torch.arange(t, device=q.device)
    p = pos[..., None]  # (B, C, 1)
    if window:
        base = p - p % t
        abs_pos = torch.where(slots <= p % t, base + slots, base - t + slots)
        mask = abs_pos >= 0
    else:
        mask = slots <= p
    outs = []
    for j in range(hk):
        kj = ck[:, :, j].to(torch.float32)
        vj = cv[:, :, j].to(torch.float32)
        if ks is not None:
            kj = kj * ks[:, :, j]
            vj = vj * vs[:, :, j]
        qj = q[:, :, j * g:(j + 1) * g].to(torch.float32).contiguous()
        logits = torch.einsum("bcgd,btd->bcgt", qj,
                              kj.contiguous()) / math.sqrt(dh)
        logits = logits.masked_fill(~mask[:, :, None, :], -1e30)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bcgt,btd->bcgd", probs, vj.contiguous()))
    return torch.cat(outs, dim=2).reshape(b, c, h * dh).to(q.dtype)


def _check_quant(kv, cfg: TransformerConfig, what: str):
    """An int8 cache read under a config without ``kv_quant`` (or the
    reverse) would cast K/V into the wrong buffers silently."""
    if ("ks" in kv[0]) != bool(cfg.kv_quant):
        raise ValueError(
            f"{what} {'is' if 'ks' in kv[0] else 'is not'} int8-quantized "
            f"but cfg.kv_quant={cfg.kv_quant!r}; build it from the SAME "
            "config")


def _check_cache(cache, cfg: TransformerConfig):
    if cache[0]["k"].shape[1] != _cache_len(cfg):
        raise ValueError(
            f"cache length {cache[0]['k'].shape[1]} != {_cache_len(cfg)} "
            f"expected for window={cfg.window}, max_len={cfg.max_len}; "
            "build the cache with init_kv_cache(cfg, ...)")
    _check_quant(cache, cfg, "cache")


def _put_kv(layer, k, v, put, quant: bool):
    """Write new K/V into a cache layer through ``put(buf, value)``,
    quantizing each vector first when the cache is int8: the one write
    path of the chunk paths, the prefills and the admissions."""
    if quant:
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        writes = (("k", kq), ("v", vq), ("ks", ks), ("vs", vs))
    else:
        writes = (("k", k), ("v", v))
    for name, val in writes:
        put(layer[name], val)


# Positions per prefill tile. A GEMM or a row reduction need not give a
# row the same bits at another row count: cuBLAS and MKL choose their
# algorithm by shape (on the H100 a 16-row prefill chunk and a 512-row
# one write different cache bits). So prefill runs in tiles of this many
# positions, each padded to exactly this many rows: every prefill GEMM,
# reduction and attention call sees one shape, whatever the chunk width.
PREFILL_TILE = 128

# Positions per decode tile, the same idea for decode: a one-token step,
# a verify chunk of any draft length and generate_speculative's chunks all
# run in tiles of this many rows a sequence, so a position is computed by
# calls of one shape (M = batch x DECODE_TILE) whatever the schedule, and
# speculation changes no bit. 8 is generate_speculative's default
# draft_len; a one-token step pays 8 rows a sequence for it.
DECODE_TILE = 8


def _chunk_guards(cache, cfg: TransformerConfig):
    """Contract checks of the chunk paths (:func:`decode_chunk`,
    :func:`prefill_chunk`): the dense slot == position cache only, no MoE
    routing."""
    if cfg.window:
        raise NotImplementedError(
            "decode_chunk needs the dense slot==position cache: a ring "
            "cache can't absorb a partially rejected chunk (overwritten "
            "slots held live positions)")
    if cfg.n_experts:
        raise NotImplementedError(
            "decode_chunk's (B, C, D) activations don't fit the MoE "
            "router's (T, D) batch contract; use decode_step/generate "
            "for MoE configs")
    _check_cache(cache, cfg)


def _chunk_pos(pos, b: int, c: int, device):
    """(B, C) absolute positions of a chunk starting at ``pos`` (a scalar
    or a per-row (B,) tensor)."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=device)
    return pos.expand(b).reshape(b, 1) + torch.arange(c, device=device)


def _tiles(params, kv, tokens, pos, cfg: TransformerConfig, write_read,
           width: int):
    """The chunk body shared by the contiguous and paged paths: (B, C)
    tokens at positions ``pos`` (B, C) in tiles of ``width`` positions,
    taken in order, each through every layer before the next starts. A
    short last tile is padded to ``width`` rows (token 0 at the tile's
    last position); pad rows write no K/V and are never read back. Per
    layer ``write_read(layer, k, v, tile_pos)`` stores the real rows'
    K/V (quantized on an int8 cache) and returns the layer's buffers as
    attention reads them: (B, T, Hk, Dh) ``k``/``v``, and ``ks``/``vs``
    on an int8 cache. Returns ``[(hidden states (B, width, D) before the
    final LN, real rows), ...]``, one per tile. ``params`` must already
    be cast.

    With a fixed ``width`` (:data:`PREFILL_TILE`, :data:`DECODE_TILE`)
    every position is computed by calls of one shape, so any split of a
    prompt into chunks (a copied prefix plus its tail among them) and any
    schedule of decode steps and verify chunks write the same cache bits
    and give the same logits: the property the prefix cache, paged
    sharing and speculation rest on."""
    b, c = tokens.shape
    out = []
    for t0 in range(0, c, width):
        tile = tokens[:, t0:t0 + width]
        tile_pos = pos[:, t0:t0 + width]
        n = tile.shape[1]
        if n < width:
            tile = F.pad(tile, (0, width - n))
            tile_pos = torch.cat(
                [tile_pos, tile_pos[:, -1:].expand(b, width - n)], dim=1)
        x = _embed_rows(params, tile, cfg.compute_dtype)
        if not cfg.rope:
            x = x + params["pos"][tile_pos].to(x.dtype)
        for bp, layer in zip(params["blocks"], kv):
            q, k, v = _split_qkv(bp, x, cfg,
                                 positions=tile_pos if cfg.rope else None)
            view = write_read(layer, k[:, :n], v[:, :n], tile_pos[:, :n])
            att = _attend_cached(q, view["k"], view["v"], tile_pos,
                                 view.get("ks"), view.get("vs"),
                                 window=cfg.window)
            x = _mlp_residual(bp, x + _tp_out(att, bp["wo"], cfg), cfg,
                              rows=n)
        out.append((x, n))
    return out


def _chunk_states(params, cache, tokens, pos, cfg: TransformerConfig,
                  width: int):
    """:func:`_tiles` over the contiguous cache: each layer writes its
    K/V into the cache IN PLACE (the JAX package donated the cache), at
    slot == position (``pos mod cache_len`` on a ring), then every
    position attends its own prefix."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
    quant = bool(cfg.kv_quant)

    def write_read(layer, k, v, tile_pos):
        slots = tile_pos % layer["k"].shape[1] if cfg.window else tile_pos

        def put(buf, val):
            buf[rows, slots] = val.to(buf.dtype)

        _put_kv(layer, k, v, put, quant)
        return layer

    return _tiles(params, cache, tokens, pos, cfg, write_read, width)


def _tile_logits(params, tiles):
    """Final LN and readout of every tile's real rows, (B, C, vocab)."""
    return torch.cat([_readout(params, _layer_norm(params["ln_f"], x))[:, :n]
                      for x, n in tiles], dim=1)


def _logits_at(params, tiles, last: int):
    """(B, vocab) logits at chunk index ``last``: the final LN and readout
    of ``last``'s whole tile (its padded shape, like every other call),
    not of the chunk."""
    width = tiles[0][0].shape[1]
    x, _ = tiles[last // width]
    lg = _readout(params, _layer_norm(params["ln_f"], x))
    return lg[:, last % width]


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: TransformerConfig):
    """One decode step: tokens (B,) at position ``pos`` -> (logits (B,
    vocab), cache). The cache is updated in place (slot ``pos``, or
    ``pos mod cache_len`` on a ring) and returned. Runs as a one-row
    chunk in a :data:`DECODE_TILE` tile. Under MoE the B real rows route
    as one (B, D) token batch, as the JAX package's step routes them."""
    _check_cache(cache, cfg)
    params = _cast_params(params, cfg)
    b = tokens.shape[0]
    pos_t = torch.full((b, 1), int(pos), dtype=torch.long,
                       device=tokens.device)
    tiles = _chunk_states(params, cache, tokens[:, None], pos_t, cfg,
                          width=DECODE_TILE)
    return _tile_logits(params, tiles)[:, 0], cache


@torch.no_grad()
def decode_chunk(params, cache, tokens, pos, cfg: TransformerConfig):
    """Multi-position decode, the speculative verify step: tokens (B, C)
    at positions pos..pos+C-1 (``pos`` a scalar or a per-row (B,)
    tensor) -> (logits (B, C, vocab), cache updated in place). Each
    position attends the cache up to itself, the chunk's own K/V written
    first. A partially rejected chunk needs no rollback: its stale slots
    lie past the accepted position and are rewritten before any read.
    Needs the dense slot == position cache. Runs in :data:`DECODE_TILE`
    tiles. Caller contract: pos + C <= max_len for every row."""
    _chunk_guards(cache, cfg)
    params = _cast_params(params, cfg)
    b, c = tokens.shape
    tiles = _chunk_states(params, cache, tokens,
                          _chunk_pos(pos, b, c, tokens.device), cfg,
                          width=DECODE_TILE)
    return _tile_logits(params, tiles), cache


@torch.no_grad()
def prefill_chunk(params, cache, tokens, pos, cfg: TransformerConfig,
                  last: Optional[int] = None):
    """Chunked-prefill continuation: run (B, C) prompt tokens at positions
    pos..pos+C-1 against a cache that already holds [0, pos) (earlier
    chunks, or a prefix-cache copy), writing this chunk's K/V in place.
    Returns ``(logits (B, vocab) at chunk index last, cache)``; ``last``
    defaults to C - 1, and entries past it may be padding (their K/V land
    in dead slots that decode overwrites before any live read). Only the
    readout of ``last``'s tile is computed, not the chunk's.

    Bit-exactness: positions run in :data:`PREFILL_TILE` tiles
    (:func:`_tiles`), so any split of a prompt into chunks, including a
    resume at ``pos = hit_len`` over copied prefix K/V, writes the same
    cache bits and gives the same logits as one chunk."""
    _chunk_guards(cache, cfg)
    params = _cast_params(params, cfg)
    b, c = tokens.shape
    tiles = _chunk_states(params, cache, tokens,
                          _chunk_pos(pos, b, c, tokens.device), cfg,
                          width=PREFILL_TILE)
    return _logits_at(params, tiles, c - 1 if last is None else int(last)), \
        cache


# ---------------------------------------------------------------------------
# Paged KV: gathered reads and scattered writes over a page pool
# ---------------------------------------------------------------------------
#
# serving/pages.py owns the pool (per layer, one (n_pages, PAGE, Hk, Dh)
# buffer per K and V, and (n_pages, PAGE, Hk, 1) scales beside an int8
# pool) and its allocator; these functions are the model
# half: the same _tiles as _chunk_states, with the row-major cache replaced
# by page-gathered reads and page-scattered writes through (B, max_len //
# PAGE) page tables. A gather of identical bytes hands _attend_cached an
# operand of the contiguous cache's shape and bytes, and positions past a
# row's fill get exactly zero weight in both layouts (exp(-1e30 - max)
# underflows to 0.0 and every page holds finite values), so the paged read
# is bitwise the contiguous read of the same logical cache.


def gather_kv_pages(pool, tables):
    """Contiguous per-layer cache views of a page pool: ``pool`` is a list
    of per-layer dicts of (P, page, Hk, Dh) buffers (an int8 pool's
    scales ride along), ``tables`` (B, n_chunks) page ids. Returns
    per-layer dicts of (B, n_chunks * page, Hk, Dh) tensors with slot ==
    absolute position."""
    b = tables.shape[0]
    return [{name: buf[tables].reshape((b, -1) + tuple(buf.shape[2:]))
             for name, buf in layer.items()}
            for layer in pool]


def _paged_guards(pool, tables, cfg: TransformerConfig):
    """Contract checks of the paged chunk paths: the dense slot ==
    position layout, no MoE routing, and a table extent that tiles
    max_len exactly."""
    if cfg.window:
        raise NotImplementedError(
            "paged decode needs the dense slot==position layout: a ring "
            "cache cannot be paged at fixed position-aligned chunks")
    if cfg.n_experts:
        raise NotImplementedError(
            "paged decode shares decode_chunk's (B, C, D) activation "
            "shape, which does not fit the MoE router's (T, D) contract")
    page = pool[0]["k"].shape[1]
    if tables.shape[-1] * page != cfg.max_len:
        raise ValueError(
            f"page table covers {tables.shape[-1]} x {page} slots != "
            f"max_len {cfg.max_len}; build tables at max_len // page "
            "entries (serving/pages.py)")
    _check_quant(pool, cfg, "pool")


def _chunk_states_paged(params, pool, tables, tokens, pos,
                        cfg: TransformerConfig, width: int):
    """:func:`_tiles` over a page pool: each position's K/V is written IN
    PLACE into page ``tables[row, p // page]`` at slot ``p % page``, and
    each tile attends over its rows' page-gathered caches. Rows whose
    table entries point at the write-sink page (serving/pages.py) write
    dead values there; duplicate sink writes race benignly because
    nothing attends the sink through a live mask."""
    page = pool[0]["k"].shape[1]
    rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
    quant = bool(cfg.kv_quant)

    def write_read(layer, k, v, tile_pos):
        page_ids = tables[rows, tile_pos // page]
        slots = tile_pos % page

        def put(buf, val):
            buf[page_ids, slots] = val.to(buf.dtype)

        _put_kv(layer, k, v, put, quant)
        (view,) = gather_kv_pages([layer], tables)
        return view

    return _tiles(params, pool, tokens, pos, cfg, write_read, width)


@torch.no_grad()
def decode_chunk_paged(params, pool, tables, tokens, pos,
                       cfg: TransformerConfig):
    """:func:`decode_chunk` over a page pool: tokens (B, C) at per-row
    positions ``pos`` -> (logits (B, C, vocab), pool updated in place).
    The serving engine's paged rounds run it: at C = 1, or at the draft
    length. Runs in :data:`DECODE_TILE` tiles."""
    _paged_guards(pool, tables, cfg)
    params = _cast_params(params, cfg)
    b, c = tokens.shape
    tiles = _chunk_states_paged(params, pool, tables, tokens,
                                _chunk_pos(pos, b, c, tokens.device), cfg,
                                width=DECODE_TILE)
    return _tile_logits(params, tiles), pool


@torch.no_grad()
def prefill_chunk_paged(params, pool, tables, tokens, pos,
                        cfg: TransformerConfig, last: Optional[int] = None):
    """:func:`prefill_chunk` over a page pool: prompt tokens (B, C) at
    positions pos..pos+C-1 against pages that already hold [0, pos)
    (earlier chunks, or aliased prefix pages), writing through the table.
    Returns ``(logits (B, vocab) at chunk index last, pool)``."""
    _paged_guards(pool, tables, cfg)
    params = _cast_params(params, cfg)
    b, c = tokens.shape
    tiles = _chunk_states_paged(params, pool, tables, tokens,
                                _chunk_pos(pos, b, c, tokens.device), cfg,
                                width=PREFILL_TILE)
    return _logits_at(params, tiles, c - 1 if last is None else int(last)), \
        pool


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig):
    """Run the prompt (B, S) through the model once, filling a fresh cache
    for positions [0, S): returns (last-position logits (B, vocab),
    cache). Prompt attention is the flash kernel; the cache is primed
    from the same per-block K/V, quantized after the flash on an int8
    cache (a ring keeps the last cache_len positions, each in slot
    position mod cache_len). Under MoE the sequences run one at a time
    (:func:`_map_seqs`). Refuses sequence parallelism, as the JAX package
    does."""
    _validate(cfg)
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence-parallel decode is not meaningful: decode steps are "
            "single positions; shard the batch instead")
    b, s = tokens.shape
    if s > cfg.max_len:
        raise ValueError(f"prompt length {s} > max_len {cfg.max_len}")
    params = _cast_params(params, cfg)
    x = _embed_prefix(params, tokens, cfg)
    cache = init_kv_cache(cfg, b, dtype=x.dtype, device=x.device)
    cache_len = cache[0]["k"].shape[1]
    idx = torch.arange(max(0, s - cache_len), s, device=x.device)
    for layer, bp in zip(cache, params["blocks"]):
        x, k, v = _map_seqs(
            lambda xi, bp=bp: _block(bp, xi, cfg, return_kv=True), x, cfg)

        def put(buf, arr):
            if cfg.window:
                buf[:, idx % cache_len] = arr[:, idx].to(buf.dtype)
            else:
                buf[:, :s] = arr.to(buf.dtype)

        _put_kv(layer, k, v, put, bool(cfg.kv_quant))
    x = _layer_norm(params["ln_f"], x[:, -1])
    return _readout(params, x), cache


def _truncate(lg, top_k: int = 0, top_p: float = 0.0):
    """The sampler's top-k and nucleus (top-p) truncation of f32 logits,
    as -inf masks (the first token always survives top-p)."""
    neg = torch.tensor(float("-inf"), dtype=lg.dtype, device=lg.device)
    if 0 < top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, neg, lg)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        exceeded = torch.cumsum(probs, dim=-1) - probs >= top_p
        cutoff = torch.where(exceeded, torch.inf, srt).amin(
            dim=-1, keepdim=True)
        lg = torch.where(lg < cutoff, neg, lg)
    return lg


def _gumbel(shape, generator, device):
    """Standard Gumbel noise from a torch generator (Philox on the card):
    -log(-log(U)), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample(logits, temperature: float, generator=None, top_k: int = 0,
            top_p: float = 0.0):
    """Greedy (temperature <= 0: argmax, first maximum on ties) or
    categorical sampling by the Gumbel-max trick (the form
    ``jax.random.categorical`` takes), after top-k/top-p truncation."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = _truncate(logits.to(torch.float32) / temperature, top_k, top_p)
    return torch.argmax(lg + _gumbel(lg.shape, generator, lg.device), dim=-1)


def _decode_scan(params, cache, first, pos0: int, cfg: TransformerConfig,
                 steps: int, temperature: float, generator, top_k: int,
                 top_p: float, eos_id: Optional[int]):
    """The decode loop of the JAX package's ``_decode_scan``, as a Python
    loop: emits ``first`` and then ``steps - 1`` decoded tokens per row,
    (B, steps). With ``eos_id`` a row that emits it is frozen (its later
    positions are eos padding) and the loop exits once every row is,
    at one host sync per step."""
    b = first.shape[0]
    fill = 0 if eos_id is None else int(eos_id)
    out = torch.full((b, steps), fill, dtype=torch.long, device=first.device)
    tok = first
    done = None if eos_id is None else (first == eos_id)
    for i in range(steps):
        if done is not None:
            if bool(done.all()):
                break
            done = done | (tok == eos_id)
        out[:, i] = tok
        if i == steps - 1:
            break  # the next token would be discarded
        logits, cache = decode_step(params, cache, tok, pos0 + i, cfg)
        nxt = _sample(logits, temperature, generator, top_k, top_p)
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
        tok = nxt
    return out


@torch.no_grad()
def generate(params, prompt, steps: int, cfg: TransformerConfig,
             temperature: float = 0.0, seed: int = 0, top_k: int = 0,
             top_p: float = 0.0, eos_id: Optional[int] = None):
    """Autoregressive generation: prompt (B, S) -> (B, steps) tokens, on
    the device the params live on. Prefill fills the cache in one pass;
    decoding is a Python loop over :func:`decode_step` (temperature 0 =
    greedy; else categorical sampling from a ``torch.Generator`` seeded
    with ``seed``, optionally truncated to ``top_k`` / the ``top_p``
    nucleus). With ``eos_id`` a sequence that emits it is finished: its
    later positions are eos padding."""
    _validate(cfg)
    device = params_device(params)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, s = prompt.shape
    if s + steps > cfg.max_len:
        raise ValueError(
            f"prompt {s} + steps {steps} exceeds max_len {cfg.max_len}")
    params = _cast_params(params, cfg)
    gen = None
    if temperature > 0.0:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    with _tracer.span("transformer.generate", batch=b, prompt_len=s,
                      steps=int(steps)):
        with _tracer.span("transformer.prefill"):
            logits, cache = prefill(params, prompt, cfg)
        first = _sample(logits, float(temperature), gen, int(top_k),
                        float(top_p))
        with _tracer.span("transformer.decode_scan"):
            return _decode_scan(params, cache, first, s, cfg, int(steps),
                                float(temperature), gen, int(top_k),
                                float(top_p), eos_id)


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decoding
# ---------------------------------------------------------------------------


def _prompt_lookup_draft(buf, filled, fin, draft_len: int, ngram: int,
                         mask_history: bool = False):
    """The one copy of the prompt-lookup drafting rule, shared by
    :func:`_speculative_loop` and the serving engine's speculative round:
    for each row of ``buf`` (B, total), find the freshest prior
    occurrence of its last ``ngram`` tokens inside its ``filled`` (B,)
    region and propose the ``draft_len - 1`` tokens that followed it.
    Rows without a match, and rows marked ``fin`` (frozen), draft the
    repeat-last chunk. Returns the (B, draft_len) verify chunk: the row's
    last token, then its draft. Slices clamp their start into the buffer
    as ``jax.lax.dynamic_slice`` does.

    ``mask_history=True`` also replaces draft positions at or past
    ``filled`` by the last token, so the draft is a function of the row's
    own committed tokens only: a serving row's buffer still holds a
    previous occupant's tokens past ``filled``."""
    bsz, total = buf.shape
    dev = buf.device
    rows = torch.arange(bsz, device=dev)[:, None]
    g0 = (filled - ngram).clamp(0, total - ngram)
    gram = buf[rows, g0[:, None] + torch.arange(ngram, device=dev)]
    win = buf.unfold(1, ngram, 1)  # (B, total - ngram + 1, ngram)
    match = (win == gram[:, None, :]).all(dim=2)
    jidx = torch.arange(win.shape[1], device=dev)
    valid = match & (jidx[None] < (filled - ngram)[:, None])
    j_star = torch.where(valid, jidx[None], -1).amax(dim=1)
    src = j_star.clamp_min(0) + ngram
    didx = torch.arange(draft_len - 1, device=dev)
    d0 = src.clamp(0, total - (draft_len - 1))
    draft = buf[rows, d0[:, None] + didx]
    last = buf[rows[:, 0], filled - 1][:, None]
    draft = torch.where(((j_star >= 0) & ~fin)[:, None], draft, last)
    if mask_history:
        draft = torch.where(src[:, None] + didx < filled[:, None], draft,
                            last)
    return torch.cat([last, draft], dim=1)


def _spec_emit(lp, drafts, generator):
    """Delta-draft speculative sampling on one row: ``lp`` (C, V) target
    log-probs at the chunk's positions, ``drafts`` (C - 1,) the
    deterministic draft chain. Accept draft d with probability p(d); on a
    rejection resample from p with d excluded; after C - 1 acceptances
    draw a bonus token from the last position. Returns ``(emit (C,), m)``:
    positions 0..m-1 emit accepted drafts, position m the resample or the
    bonus, m + 1 tokens in all. Each emitted token's marginal is the plain
    sampling distribution. Draws a fixed count from ``generator`` whatever
    is accepted: C - 1 uniforms, C - 1 resample rows and one bonus row."""
    c, v = lp.shape
    idx = torch.arange(c - 1, device=lp.device)
    p_draft = torch.exp(lp[idx, drafts])
    u = torch.rand(c - 1, generator=generator, device=lp.device,
                   dtype=torch.float32)
    rejected = u >= p_draft
    m = torch.where(rejected.any(), torch.argmax(rejected.to(torch.int8)),
                    c - 1)
    excl = lp[:-1].clone()
    excl[idx, drafts] = float("-inf")
    resamp = torch.argmax(excl + _gumbel((c - 1, v), generator, lp.device),
                          dim=-1)
    bonus = torch.argmax(lp[-1] + _gumbel((v,), generator, lp.device))
    emit = torch.cat([torch.where(idx == m, resamp, drafts), bonus[None]])
    return emit, m


def _greedy_accept(logits, chunk):
    """Greedy verification of (B, C) chunks: the argmax tokens (B, C) and
    the accepted draft count m (B,): the longest prefix of drafts the
    argmax agrees with."""
    emit = torch.argmax(logits, dim=-1)
    miss = emit[:, :-1] != chunk[:, 1:]
    m = torch.where(miss.any(dim=1),
                    torch.argmax(miss.to(torch.int8), dim=1),
                    chunk.shape[1] - 1)
    return emit, m


def _speculative_loop(params, buf, filled0: int, cache, generator,
                      cfg: TransformerConfig, steps: int, draft_len: int,
                      ngram: int, temperature: float):
    """The prompt-lookup speculation loop, on the host with one sync a
    chunk (the frozen flags): ``buf`` (B, S + steps + draft_len) holds the
    prompt and the first token; each iteration drafts ``draft_len - 1``
    tokens a row (:func:`_prompt_lookup_draft`), verifies every row's
    chunk in one :func:`decode_chunk`, accepts the longest agreeing
    prefix plus the model's correction (or, sampling, runs
    :func:`_spec_emit` on each live row in order) and writes the whole
    chunk's emits into ``buf`` (positions past the accepted count are
    rewritten before anything reads them). A row that reaches its target
    freezes: it drafts the repeat-last chunk, draws nothing, and its
    writes land in dead slots. Returns ``(buf, verify_chunks (B,) of live
    chunks a row, iterations)``; ``buf`` and ``cache`` are updated in
    place."""
    bsz, total = buf.shape
    dev = buf.device
    rows = torch.arange(bsz, device=dev)
    cols = torch.arange(draft_len, device=dev)
    target = filled0 + steps - 1
    filled = torch.full((bsz,), filled0, dtype=torch.long, device=dev)
    vsteps = torch.zeros(bsz, dtype=torch.long, device=dev)
    iters = 0
    while True:
        fin = filled >= target
        fin_host = fin.cpu().numpy()  # the one host sync a chunk
        if fin_host.all():
            break
        chunk = _prompt_lookup_draft(buf, filled, fin, draft_len, ngram)
        logits, cache = decode_chunk(params, cache, chunk, filled - 1, cfg)
        lf = logits.to(torch.float32)
        emit, m = _greedy_accept(lf, chunk)
        if temperature > 0.0:
            lp = torch.log_softmax(lf / temperature, dim=-1)
            for r in (~fin_host).nonzero()[0]:
                emit[r], m[r] = _spec_emit(lp[r], chunk[r, 1:], generator)
        start = filled.clamp(0, total - draft_len)
        buf[rows[:, None], start[:, None] + cols] = emit
        vsteps += (~fin).long()
        filled = torch.minimum(filled + m + 1, torch.full_like(filled,
                                                               target))
        iters += 1
    return buf, vsteps, iters


@torch.no_grad()
def generate_speculative(params, prompt, steps: int, cfg: TransformerConfig,
                         draft_len: int = 8, ngram: int = 2,
                         temperature: float = 0.0, seed: int = 0,
                         return_stats: bool = False):
    """Generation with prompt-lookup speculative decoding: drafts come
    from each sequence's own history (the freshest prior occurrence of its
    last ``ngram`` tokens proposes the ``draft_len - 1`` tokens that
    followed it), verified in one :func:`decode_chunk` an iteration.
    Greedy output equals :func:`generate`'s bit for bit: both compute
    every position in :data:`DECODE_TILE` tiles, so speculation changes
    the schedule, never a token. With ``temperature > 0`` the chain runs
    delta-draft speculative sampling (:func:`_spec_emit`) from a
    ``torch.Generator`` seeded with ``seed`` on the params' device: each
    emitted token's marginal is plain sampling's, though the draws differ
    from :func:`generate`'s.

    Batched prompts advance at their own acceptance rates (per-row
    positions); a sequence that finishes freezes. With
    ``return_stats=True`` returns ``(tokens, {"verify_chunks": (B,) live
    chunks a sequence, "iterations": loop trips})``.

    Contract: temperature only (no top-k/top-p), the dense cache
    (``cfg.window == 0``), ``prompt + steps + draft_len <= max_len``,
    ``prompt >= ngram``."""
    _validate(cfg)
    if cfg.window:
        raise NotImplementedError(
            "speculative decoding needs the dense cache (cfg.window == 0)")
    if cfg.n_experts:
        raise NotImplementedError(
            "speculative decoding uses decode_chunk, which doesn't fit "
            "the MoE router's (T, D) batch contract; use generate()")
    device = params_device(params)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, s = prompt.shape
    if s < ngram:
        raise ValueError(f"prompt length {s} < ngram {ngram}")
    if draft_len < 2:
        raise ValueError(f"draft_len must be >= 2, got {draft_len}")
    if s + steps + draft_len > cfg.max_len:
        raise ValueError(
            f"prompt {s} + steps {steps} + draft_len {draft_len} exceeds "
            f"max_len {cfg.max_len} (the last chunk writes draft_len "
            "cache slots past the final emitted position)")
    params = _cast_params(params, cfg)
    gen = None
    if temperature > 0.0:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    with _tracer.span("transformer.generate_speculative", batch=b,
                      steps=int(steps), draft_len=int(draft_len)):
        logits, cache = prefill(params, prompt, cfg)
        first = _sample(logits, float(temperature), gen)
        buf = torch.zeros((b, s + steps + draft_len), dtype=torch.long,
                          device=device)
        buf[:, :s] = prompt
        buf[:, s] = first
        buf, vsteps, iters = _speculative_loop(
            params, buf, s + 1, cache, gen, cfg, int(steps), int(draft_len),
            int(ngram), float(temperature))
        toks = buf[:, s:s + steps]
    if return_stats:
        return toks, {"verify_chunks": vsteps, "iterations": iters}
    return toks
