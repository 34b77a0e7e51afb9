"""Carry the JAX package's transformer weights into the port.

The JAX params pytree and the port's params dict share one layout (the
same keys, the same shapes), so conversion is a leaf-by-leaf copy with a
shape check against the config. Int8 params (``quantize_params_int8``)
carry ``{"q8", "s8"}`` leaves at the embed table and the blocks' dense
weights; they are checked and copied the same way, dtypes kept. Callers
hand over the pytree as numpy arrays (``jax.tree.map(np.asarray,
params)``): the port never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hw import resolve_device
from .transformer import TransformerConfig, _validate


def expected_shapes(cfg: TransformerConfig) -> dict:
    """The params layout of ``init_params(cfg)``, as shapes: a MoE block
    (``cfg.n_experts``) carries the router and the expert banks in place
    of the dense MLP."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kv_d = cfg.kv_heads * (d // cfg.n_heads)
    ln = {"g": (d,), "b": (d,)}
    if e:
        mlp = {"router": (d, e), "w1": (e, d, f), "b1": (e, f),
               "w2": (e, f, d), "b2": (e, d)}
    else:
        mlp = {"w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}
    out = {"embed": (cfg.vocab, d), "ln_f": dict(ln), "blocks": [
        {"ln1": dict(ln), "ln2": dict(ln), "wqkv": (d, d + 2 * kv_d),
         "wo": (d, d), **mlp}
        for _ in range(cfg.n_layers)]}
    if not cfg.rope:
        out["pos"] = (cfg.max_len, d)
    return out


# The leaves quantize_params_int8 replaces (models/quant.py), by path.
_INT8_LEAVES = ("['embed']", "['wqkv']", "['wo']", "['w1']", "['w2']")


def _int8_shape(shape, axis: int) -> dict:
    """The ``{"q8", "s8"}`` leaf of a weight quantized over ``axis``."""
    s8 = list(shape)
    s8[axis] = 1
    return {"q8": tuple(shape), "s8": tuple(s8)}


def params_from_jax(tree, cfg: TransformerConfig, device="cuda"):
    """The port's params from the JAX params pytree given as numpy arrays
    (float and int8 dtypes kept as they are), placed on ``device``.
    Raises on a missing or extra key or a shape that does not match
    ``cfg``."""
    _validate(cfg)
    dev = resolve_device(device)

    def conv(node, shape, path):
        if isinstance(node, dict) and path.endswith(_INT8_LEAVES):
            # An int8 leaf where the float layout has a weight: embed is
            # quantized per row (axis 1), block weights per column (the
            # 3-D expert banks stay float, and so never arrive here).
            shape = _int8_shape(shape, 1 if path == "['embed']" else 0)
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(
                    f"params{path}: expected keys {sorted(shape)}, got {got}")
            return {k: conv(node[k], shape[k], f"{path}[{k!r}]")
                    for k in shape}
        if isinstance(shape, list):
            if len(node) != len(shape):
                raise ValueError(
                    f"params{path}: expected {len(shape)} blocks, got "
                    f"{len(node)}")
            return [conv(n, s, f"{path}[{i}]")
                    for i, (n, s) in enumerate(zip(node, shape))]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(
                f"params{path}: expected shape {shape}, got {arr.shape}")
        return torch.from_numpy(np.array(arr)).to(dev)  # a writable copy

    return conv(tree, expected_shapes(cfg), "")
