"""Carry the JAX package's transformer weights into the port.

The JAX params pytree and the port's params dict share one layout (the
same keys, the same shapes), so conversion is a leaf-by-leaf copy with a
shape check against the config. Callers hand over the pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``): the port never imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hw import resolve_device
from .transformer import TransformerConfig, _validate


def expected_shapes(cfg: TransformerConfig) -> dict:
    """The params layout of ``init_params(cfg)``, as shapes."""
    d, f = cfg.d_model, cfg.d_ff
    kv_d = cfg.kv_heads * (d // cfg.n_heads)
    ln = {"g": (d,), "b": (d,)}
    out = {"embed": (cfg.vocab, d), "ln_f": dict(ln), "blocks": [
        {"ln1": dict(ln), "ln2": dict(ln), "wqkv": (d, d + 2 * kv_d),
         "wo": (d, d), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}
        for _ in range(cfg.n_layers)]}
    if not cfg.rope:
        out["pos"] = (cfg.max_len, d)
    return out


def params_from_jax(tree, cfg: TransformerConfig, device="cuda"):
    """The port's params from the JAX params pytree given as numpy arrays
    (float dtypes kept as they are), placed on ``device``. Raises on a
    missing or extra key or a shape that does not match ``cfg``."""
    _validate(cfg)
    dev = resolve_device(device)

    def conv(node, shape, path):
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
