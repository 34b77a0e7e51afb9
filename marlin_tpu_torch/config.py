"""Typed configuration for marlin_tpu_torch.

Port of ``marlin_tpu/config.py``: one typed config object, overridable
globally (:func:`set_config`) or for a scope (:func:`config_override`),
with the same fields and defaults, torch dtypes in place of jax ones.

Precision. The JAX package passes ``matmul_precision`` ("default" |
"high" | "highest") to every ``jnp.dot``. On the TPU those mean one, three
and six bfloat16 passes over f32 operands. PyTorch has no per-call
argument: float32 products on the card follow the process-wide
``torch.set_float32_matmul_precision`` (which also sets
``torch.backends.cuda.matmul.allow_tf32``), so the port's ``torch.matmul``
calls run inside :func:`matmul_precision_scope`, which sets it for the
scope and restores it after. What each JAX value becomes on the card:

=========  ==========================  ===================================
JAX value  torch float32 precision     arithmetic on the H100
=========  ==========================  ===================================
highest    ``"highest"`` (TF32 off)    full f32 products and sums
high       ``"high"``                  TF32 products (10-bit mantissa), or
                                       three bf16 passes where cuBLAS has
                                       them; f32 sums
default    ``"medium"``                bf16 products, f32 sums
=========  ==========================  ===================================

bf16 and f64 operands are not affected by any of the three, as in JAX.
The setting is global to the process, not to the thread: do not run two
scopes of different precision concurrently. The hand-written kernels do
not read it: their f32 route is always full f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class MarlinConfig:
    """Global knobs for marlin_tpu_torch, field for field those of
    ``marlin_tpu.config.MarlinConfig`` (its comments give each field's
    derivation; the TPU figures quoted there are not the port's)."""

    # Broadcast-vs-split GEMM threshold, in megabytes of the smaller operand.
    broadcast_threshold_mb: float = 300.0

    # Panel ("base") block sizes for the blocked decompositions.
    lu_base_size: int = 1000
    cholesky_base_size: int = 1000
    inverse_base_size: int = 1000

    # Default element dtype; float64 is the correctness reference
    # (enable_x64), float32 and bfloat16 the fast modes.
    default_dtype: torch.dtype = torch.float32

    # Precision of the port's torch.matmul calls ("default" | "high" |
    # "highest"); see the module docstring for what each means on the card.
    matmul_precision: str = "highest"

    # Precision for the blocked decompositions, separate from
    # matmul_precision: their error feeds back through the panel sweep.
    linalg_precision: str = "highest"

    # GEMM engine for the split path: "gspmd" | "summa".
    gemm_engine: str = "summa"

    # Precision for the sparse dense-route products.
    sparse_matmul_precision: str = "high"

    # Per-device byte budget for the sparse dense fast path. None -> the
    # module default of the distributed sparse module.
    sparse_densify_budget_bytes: Optional[int] = None

    # Density ceiling for the ELL gather engine in "auto" sparse dispatch.
    sparse_ell_density_max: float = 5e-3

    # Column-count boundary for SVD "auto" mode dispatch.
    svd_local_eigs_max: int = 15000

    # Mesh axis names (rows, cols) used throughout.
    mesh_axis_rows: str = "mr"
    mesh_axis_cols: str = "mc"

    # Preferred number of shards when a caller gives no hint. None =>
    # device count.
    default_parallelism: Optional[int] = None

    # Structured op-timing subsystem switch.
    enable_timing: bool = False


_config = MarlinConfig()

# The JAX package's x64 switch lives in jax.config; the port keeps its own.
# PyTorch computes in float64 and int64 without any switch, so this one
# only picks the default dtypes: float64 elements and int64 COO indices.
_x64 = False

_TORCH_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


def get_config() -> MarlinConfig:
    return _config


def set_config(**kwargs) -> MarlinConfig:
    """Update global config fields in place; returns the config."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise ValueError(f"unknown config field: {k!r}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def matmul_precision_scope(precision: Optional[str] = None):
    """Run the scope's float32 ``torch.matmul`` calls at ``precision``
    (default: the config's ``matmul_precision``), one of the JAX package's
    "default", "high" and "highest"; the module docstring says what each
    becomes on the card. Restores the process-wide setting on exit."""
    precision = _config.matmul_precision if precision is None else precision
    if precision not in _TORCH_PRECISION:
        raise ValueError(
            f"unknown matmul precision {precision!r}: one of "
            f"{sorted(_TORCH_PRECISION)}")
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_PRECISION[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def linalg_precision_scope():
    """Ambient-precision context for every decomposition code path: their
    internal products take no precision argument and follow the ambient
    setting, which ``matmul_precision`` may have relaxed."""
    return matmul_precision_scope(_config.linalg_precision)


@contextlib.contextmanager
def config_override(**kwargs):
    """Temporarily override config fields."""
    old = {k: getattr(_config, k) for k in kwargs}
    try:
        set_config(**kwargs)
        yield _config
    finally:
        set_config(**old)


def enable_x64() -> None:
    """Make float64 the default dtype (the reference's element type) and
    int64 the COO index type. Use for correctness testing, not for
    benchmarks: the card's f64 rate is far below its f32 rate."""
    global _x64
    _x64 = True
    _config.default_dtype = torch.float64


def x64_enabled() -> bool:
    return _x64
