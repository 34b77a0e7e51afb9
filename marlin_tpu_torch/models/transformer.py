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
chunked cross-entropy, the cached decode attention and sampling stay
plain torch, as the JAX package left them to XLA. Training is autograd
over the same functions: :func:`loss_fn`, :func:`train_step` (SGD, f32
master params) and :func:`make_train_step` (a ``torch.optim``
optimizer); ``cfg.remat`` checkpoints each block.

Model options outside this slice (int8 KV, MoE, sequence parallelism,
tensor parallelism) raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..obs.trace import tracer as _tracer
from ..ops.flash_attention import flash_attention
from ..utils.hw import resolve_device


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
    tp: int = 1
    tp_mode: str = "gather"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


def check_ported(cfg: TransformerConfig) -> None:
    """Raise ``NotImplementedError`` for a model option this slice of the
    port does not carry, naming the ROADMAP item that will."""
    unported = {
        "kv_quant": (cfg.kv_quant, "the int8 KV cache (models/quant.py), "
                     "ROADMAP Queue A1"),
        "n_experts": (cfg.n_experts, "the MoE MLP (parallel/expert.py), "
                      "ROADMAP Queue A3"),
        "sequence_parallel": (cfg.sequence_parallel,
                              "sequence-parallel attention (parallel/"
                              "ulysses.py, ring.py), ROADMAP Queue A3"),
        "tp": (cfg.tp > 1, "tensor parallelism (models/tp.py), ROADMAP "
               "Queue A1"),
    }
    for name, (value, what) in unported.items():
        if value:
            raise NotImplementedError(
                f"TransformerConfig.{name}={getattr(cfg, name)!r}: {what} "
                f"is not ported to marlin_tpu_torch yet")


def _validate(cfg: TransformerConfig) -> None:
    check_ported(cfg)
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
    V (kv_heads * Dh columns each), head-major. Master params are f32."""
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
        params["blocks"].append({
            "ln1": ln(), "ln2": ln(),
            "wqkv": norm(d, d + 2 * kv_d),
            "wo": norm(d, d),
            "w1": norm(d, f),
            "b1": torch.zeros(f, device=dev),
            "w2": norm(f, d),
            "b2": torch.zeros(d, device=dev),
        })
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _cast_params(params, cfg: TransformerConfig):
    """Cast every float leaf (LN gains and biases included) to the
    compute dtype; a no-op when the params already are (the engine and
    ``generate`` cast once, so later calls cost nothing)."""
    dt = cfg.compute_dtype
    if params["embed"].dtype == dt:
        return params
    return _tree_map(
        lambda p: p.to(dt) if p.is_floating_point() else p, params)


def _embed_rows(params, tokens, dt):
    return params["embed"][tokens].to(dt)


def _readout(params, x):
    """Tied readout: vocab logits x @ embed.T."""
    return x @ params["embed"].T


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


def _mlp_residual(bp, x, cfg: TransformerConfig):
    """ln2 -> dense MLP (tanh-approximate gelu, jax.nn.gelu's default) ->
    residual."""
    y = _layer_norm(bp["ln2"], x)
    y = F.gelu(y @ bp["w1"] + bp["b1"], approximate="tanh")
    return x + (y @ bp["w2"] + bp["b2"])


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
    cached keys are stored rotated."""
    b, t, d = x.shape
    h, hk = cfg.n_heads, cfg.kv_heads
    dh = d // h
    qkv = _layer_norm(bp["ln1"], x) @ bp["wqkv"]
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
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
    att = _attend_local(q, k, v, cfg).reshape(b, s, -1)
    x = _mlp_residual(bp, x + att @ bp["wo"], cfg)
    return (x, k, v) if return_kv else x


def _embed_prefix(params, tokens, cfg: TransformerConfig):
    """(B, S) tokens -> (B, S, D) embeddings, plus the learned position
    table for [0, S) unless rope rotates Q/K instead."""
    x = _embed_rows(params, tokens, cfg.compute_dtype)
    if not cfg.rope:
        x = x + params["pos"][None, : tokens.shape[1]].to(x.dtype)
    return x


def hidden_states(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> final-LN hidden states (B, S, D). With
    ``cfg.remat`` under autograd each block runs under
    ``torch.utils.checkpoint``: it saves only its input and the backward
    re-runs its forward (one more flash forward launch per block; the
    flash backward's recompute is tile-local either way)."""
    _validate(cfg)
    params = _cast_params(params, cfg)
    x = _embed_prefix(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in params["blocks"]:
        if remat:
            x = checkpoint(_block, bp, x, cfg, use_reentrant=False)
        else:
            x = _block(bp, x, cfg)
    return _layer_norm(params["ln_f"], x)


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


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


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
    slots (slot = position mod cache_len)."""
    check_ported(cfg)
    dev = resolve_device(device)
    shape = (batch, _cache_len(cfg), cfg.kv_heads, cfg.d_model // cfg.n_heads)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _attend_cached(q, ck, cv, pos, window=0):
    """Query positions against the cache: q (B, C, H, Dh), ck/cv (B, T,
    Hk, Dh), ``pos`` (B, C) absolute positions. Without a window slot ==
    position (slots > pos masked); with one the cache is a ring (slot s
    holds position base + s for s <= pos mod T, else base - T + s, with
    base = pos - pos mod T; unfilled slots are masked). f32 logits divided
    by sqrt(Dh) after the product, -1e30 masks, f32 softmax."""
    b, c, h, dh = q.shape
    t, hk = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, c, hk, h // hk, dh).to(torch.float32)
    logits = torch.einsum("bckgd,btkd->bckgt", qg,
                          ck.to(torch.float32)) / math.sqrt(dh)
    slots = torch.arange(t, device=q.device)
    p = pos[..., None]  # (B, C, 1)
    if window:
        base = p - p % t
        abs_pos = torch.where(slots <= p % t, base + slots, base - t + slots)
        mask = abs_pos >= 0
    else:
        mask = slots <= p
    logits = logits.masked_fill(~mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bckgt,btkd->bckgd", probs, cv.to(torch.float32))
    return out.reshape(b, c, h * dh).to(q.dtype)


def _check_cache(cache, cfg: TransformerConfig):
    if cache[0]["k"].shape[1] != _cache_len(cfg):
        raise ValueError(
            f"cache length {cache[0]['k'].shape[1]} != {_cache_len(cfg)} "
            f"expected for window={cfg.window}, max_len={cfg.max_len}; "
            "build the cache with init_kv_cache(cfg, ...)")


def _chunk_states(params, cache, tokens, pos, cfg: TransformerConfig):
    """The shared body of :func:`decode_step` and :func:`decode_chunk`:
    (B, C) tokens at per-row positions ``pos`` (B, C); each layer writes
    its K/V into the cache IN PLACE (the JAX package donated the cache),
    then every position attends its own prefix. Returns the hidden states
    (B, C, D) before the final LN. ``params`` must already be cast."""
    b, c = tokens.shape
    x = _embed_rows(params, tokens, cfg.compute_dtype)
    if not cfg.rope:
        x = x + params["pos"][pos].to(x.dtype)
    slots = pos % cache[0]["k"].shape[1] if cfg.window else pos
    rows = torch.arange(b, device=tokens.device)[:, None]
    for bp, layer in zip(params["blocks"], cache):
        q, k, v = _split_qkv(bp, x, cfg, positions=pos if cfg.rope else None)
        layer["k"][rows, slots] = k.to(layer["k"].dtype)
        layer["v"][rows, slots] = v.to(layer["v"].dtype)
        att = _attend_cached(q, layer["k"], layer["v"], pos,
                             window=cfg.window)
        x = _mlp_residual(bp, x + att @ bp["wo"], cfg)
    return x


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: TransformerConfig):
    """One decode step: tokens (B,) at position ``pos`` -> (logits (B,
    vocab), cache). The cache is updated in place (slot ``pos``, or
    ``pos mod cache_len`` on a ring) and returned."""
    check_ported(cfg)
    _check_cache(cache, cfg)
    params = _cast_params(params, cfg)
    b = tokens.shape[0]
    pos_t = torch.full((b, 1), int(pos), dtype=torch.long,
                       device=tokens.device)
    x = _chunk_states(params, cache, tokens[:, None], pos_t, cfg)
    return _readout(params, _layer_norm(params["ln_f"], x[:, 0])), cache


@torch.no_grad()
def decode_chunk(params, cache, tokens, pos, cfg: TransformerConfig):
    """Multi-position decode: tokens (B, C) at positions pos..pos+C-1
    (``pos`` a scalar or a per-row (B,) tensor) -> (logits (B, C, vocab),
    cache updated in place). Needs the dense slot == position cache.
    Caller contract: pos + C <= max_len for every row."""
    check_ported(cfg)
    if cfg.window:
        raise NotImplementedError(
            "decode_chunk needs the dense slot==position cache: a ring "
            "cache can't absorb a partially rejected chunk")
    _check_cache(cache, cfg)
    params = _cast_params(params, cfg)
    b, c = tokens.shape
    pos = torch.as_tensor(pos, dtype=torch.long, device=tokens.device)
    chunk_pos = pos.expand(b).reshape(b, 1) + torch.arange(
        c, device=tokens.device)
    x = _chunk_states(params, cache, tokens, chunk_pos, cfg)
    return _readout(params, _layer_norm(params["ln_f"], x)), cache


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig):
    """Run the prompt (B, S) through the model once, filling a fresh cache
    for positions [0, S): returns (last-position logits (B, vocab),
    cache). Prompt attention is the flash kernel; the cache is primed
    from the same per-block K/V (a ring keeps the last cache_len
    positions, each in slot position mod cache_len)."""
    _validate(cfg)
    b, s = tokens.shape
    if s > cfg.max_len:
        raise ValueError(f"prompt length {s} > max_len {cfg.max_len}")
    params = _cast_params(params, cfg)
    x = _embed_prefix(params, tokens, cfg)
    cache = init_kv_cache(cfg, b, dtype=x.dtype, device=x.device)
    cache_len = cache[0]["k"].shape[1]
    idx = torch.arange(max(0, s - cache_len), s, device=x.device)
    for layer, bp in zip(cache, params["blocks"]):
        x, k, v = _block(bp, x, cfg, return_kv=True)
        for name, arr in (("k", k), ("v", v)):
            if cfg.window:
                layer[name][:, idx % cache_len] = arr[:, idx]
            else:
                layer[name][:, :s] = arr
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
    device = params["embed"].device
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
