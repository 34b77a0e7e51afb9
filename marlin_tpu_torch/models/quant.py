"""Weight-only int8 and the int8 KV cache — port of
``marlin_tpu/models/quant.py``.

Decode streams the parameters once a step, so their stored width bounds it.
Symmetric per-channel int8 stores each dense weight as ``{"q8", "s8"}``:
``w ~ q8 * s8`` with ``q8`` in [-127, 127] and ``s8 = amax / 127``, one
scale per OUTPUT channel of the matmul (per ROW of the shared embed /
readout table: the same scale serves the token gather and, after the
matmul, the readout's vocab column). The model resolves quantized leaves
in ``transformer._deq`` / ``_embed_rows`` / ``_readout``. The JAX package
fuses the dequant into the dot's operand load; this plain version
materialises ``q8.to(dt) * s8`` a call (a fused int8 GEMM is a later speed
item, ROADMAP).

The int8 KV cache (``TransformerConfig.kv_quant="int8"``) stores each K/V
vector as int8 slots plus one f32 scale (:func:`kv_quantize` over the head
dim), so every slot dequantizes on its own. Whatever moves cache rows or
pages (serving/slots.py, prefix.py, pages.py) moves the scale buffers with
them: iterate :func:`kv_layer_keys`, never just ("k", "v").

Training reads the float masters only: ``transformer.loss_fn`` refuses
quantized params.
"""

from __future__ import annotations

import torch

__all__ = ["dequantize_params", "is_quantized", "kv_layer_keys",
           "kv_quantize", "quantize_params_int8"]

_KV_KEYS = ("k", "v")
_KV_QUANT_KEYS = ("k", "v", "ks", "vs")

# Per-block 2-D weights that stream every decode step. Biases, layer norms
# and the learned ``pos`` table stay float.
_BLOCK_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def kv_layer_keys(layer_or_quant) -> tuple:
    """The buffer names one KV-cache layer carries, given a layer dict or
    the ``cfg.kv_quant`` truthiness: ("k", "v") for a float cache, ("k",
    "v", "ks", "vs") for the int8 one."""
    if isinstance(layer_or_quant, dict):
        return _KV_QUANT_KEYS if "ks" in layer_or_quant else _KV_KEYS
    return _KV_QUANT_KEYS if layer_or_quant else _KV_KEYS


def is_quantized(params) -> bool:
    return isinstance(params.get("embed"), dict)


def kv_quantize(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 along ``axis``: ``(q8, s)`` with ``s`` keepdim-shaped
    for broadcast, computed in f32 whatever ``x``'s dtype. ``round`` is
    half-to-even (``torch.round``, as ``jnp.round``), so an f32 input gives
    the JAX package's bits. One formula for weights and KV vectors."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax, torch.full_like(amax, 127.0)) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_params_int8(params, donate: bool = False) -> dict:
    """Float master params (``init_params``) -> decode params whose embed
    table and per-block dense 2-D weights are ``{"q8", "s8"}`` pairs.
    Idempotent on quantized input.

    ``donate=True`` consumes the masters: each quantized weight's storage
    is freed as soon as its int8 copy exists (the caller's dict then holds
    empty tensors at those leaves), so peak memory is the masters plus one
    weight's int8 copy rather than plus the whole int8 set. Keep the
    default for any flow that reads the masters again."""
    if is_quantized(params):
        return params

    def quant_leaf(w, axis):
        q, s = kv_quantize(w, axis=axis)
        if donate:
            # The copy is queued on w's stream before the free, and the
            # caching allocator reuses the block only behind it.
            w.data = torch.empty(0, dtype=w.dtype, device=w.device)
        return {"q8": q, "s8": s}

    out = dict(params)
    # Embed: per-ROW scale; s8[:, 0] is the readout's column scale.
    out["embed"] = quant_leaf(params["embed"], axis=1)
    blocks = []
    for bp in params["blocks"]:
        nb = dict(bp)
        for name in _BLOCK_WEIGHTS:
            w = bp.get(name)
            if w is not None and w.dim() == 2:  # MoE banks (3-D) stay float
                nb[name] = quant_leaf(w, axis=0)
        blocks.append(nb)
    out["blocks"] = blocks
    return out


def _deq_leaf(leaf):
    if isinstance(leaf, dict) and "q8" in leaf:
        return leaf["q8"].to(torch.float32) * leaf["s8"]
    return leaf


def dequantize_params(qparams) -> dict:
    """The inverse mapping, to f32: the float params that compute what the
    int8 decode computes (up to the compute-dtype rounding both share),
    the oracle of the tests and of ``chip_smoke.py``."""
    out = dict(qparams)
    out["embed"] = _deq_leaf(qparams["embed"])
    out["blocks"] = [{k: _deq_leaf(v) if k in _BLOCK_WEIGHTS else v
                      for k, v in bp.items()}
                     for bp in qparams["blocks"]]
    return out
