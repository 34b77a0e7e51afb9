"""Seeded distributed matrix and vector generation: port of
``marlin_tpu/utils/random.py``.

Each rank draws only the rows of its own shard, on its own device, from an
explicit ``torch.Generator``: the rows come in chunks of ``CHUNK_ROWS``,
each drawn whole from a generator seeded by (seed, chunk index), so a
seed gives the same matrix whatever the device count or layout (the
reference's reproducibility contract, RandomRDD.scala:69-70). The pad
region is zero. The stream is Philox (or the CPU's Mersenne twister), not
JAX's threefry: the port's values equal the reference's in distribution
only.

Generators (RandomDataGenerator.scala): zeros, ones, uniform (low, high),
normal (mean, std), poisson (mean).
"""

from __future__ import annotations

import zlib
from typing import Optional, Union

import numpy as np
import torch

from ..config import get_config
from ..mesh import (Layout, Mesh, axis_sizes, block_sharding, default_mesh,
                    local_slices, row_sharding, vector_sharding)

DISTRIBUTIONS = ("uniform", "normal", "zeros", "ones", "poisson")
CHUNK_ROWS = 256  # rows drawn from one generator


def hash_seed(seed: Union[int, str, None]) -> int:
    """Stable seed hashing (``MTUtils.hashSeed``, MTUtils.scala:18): ints,
    strings, or None (a fresh nondeterministic seed)."""
    if seed is None:
        seed = np.random.SeedSequence().entropy
    if isinstance(seed, str):
        return zlib.crc32(seed.encode()) & 0x7FFFFFFF
    return int(seed) & 0x7FFFFFFFFFFFFFFF


def _sample(gen, shape, distribution: str, dtype, device, **params):
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    if distribution == "uniform":
        lo, hi = params.get("low", 0.0), params.get("high", 1.0)
        x = torch.rand(shape, generator=gen, dtype=draw, device=device)
        return (lo + (hi - lo) * x).to(dtype)
    if distribution == "normal":
        x = torch.randn(shape, generator=gen, dtype=draw, device=device)
        return (params.get("mean", 0.0) + params.get("std", 1.0) * x).to(dtype)
    if distribution == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if distribution == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if distribution == "poisson":
        rate = torch.full(shape, float(params.get("mean", 1.0)), dtype=draw,
                          device=device)
        return torch.poisson(rate, generator=gen).to(dtype)
    raise ValueError(f"unknown distribution {distribution!r}; use one of "
                     f"{DISTRIBUTIONS}")


def _chunk_seed(seed: int, chunk: int) -> int:
    return int(np.random.SeedSequence([seed, chunk]).generate_state(
        1, np.uint64)[0])


def _generate(logical, pad_multiples, layout: Layout, distribution: str,
              seed, dtype, **params) -> Optional[torch.Tensor]:
    """This rank's shard of a zero-padded random array of logical shape
    ``logical`` (1-D or 2-D) under ``layout``; None outside the mesh."""
    dtype = dtype or get_config().default_dtype
    if distribution not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {distribution!r}; use one "
                         f"of {DISTRIBUTIONS}")
    phys = tuple(-(-s // m) * m for s, m in zip(logical, pad_multiples))
    sl = local_slices(layout, phys)
    if sl is None:
        return None
    dev = layout.mesh.device
    rows = sl[0]
    cols = sl[1] if len(sl) > 1 else None
    width = logical[1] if len(logical) > 1 else None
    out = torch.zeros(tuple(s.stop - s.start for s in sl), dtype=dtype,
                      device=dev)
    base = hash_seed(seed)
    first = rows.start // CHUNK_ROWS
    last = min(rows.stop, logical[0])
    for chunk in range(first, -(-last // CHUNK_ROWS)):
        r0 = chunk * CHUNK_ROWS
        r1 = min(r0 + CHUNK_ROWS, logical[0])
        gen = torch.Generator(device=dev).manual_seed(_chunk_seed(base, chunk))
        shape = (r1 - r0,) if width is None else (r1 - r0, width)
        block = _sample(gen, shape, distribution, dtype, dev, **params)
        lo, hi = max(r0, rows.start), min(r1, rows.stop)
        if cols is not None:
            c1 = min(cols.stop, width)
            if c1 <= cols.start:
                continue
            out[lo - rows.start:hi - rows.start, :c1 - cols.start] = \
                block[lo - r0:hi - r0, cols.start:c1]
        else:
            out[lo - rows.start:hi - rows.start] = block[lo - r0:hi - r0]
    return out


def random_den_vec_matrix(rows: int, cols: int, distribution: str = "uniform",
                          seed=None, mesh: Optional[Mesh] = None, dtype=None,
                          **params):
    """Row-distributed random matrix (``MTUtils.randomDenVecMatrix``,
    MTUtils.scala:63), on the default mesh (the card's) unless given
    one."""
    from ..matrix.dense import DenseVecMatrix

    mesh = mesh or default_mesh()
    dtype = dtype or get_config().default_dtype
    local = _generate((rows, cols), (mesh.size, 1), row_sharding(mesh),
                      distribution, seed, dtype, **params)
    return DenseVecMatrix(local, mesh=mesh, dtype=dtype,
                          _logical_shape=(rows, cols))


def random_block_matrix(rows: int, cols: int,
                        blks_by_row: Optional[int] = None,
                        blks_by_col: Optional[int] = None,
                        distribution: str = "uniform", seed=None,
                        mesh: Optional[Mesh] = None, dtype=None, **params):
    """Block-distributed random matrix (``MTUtils.randomBlockMatrix``,
    MTUtils.scala:34)."""
    from ..matrix.block import BlockMatrix

    mesh = mesh or default_mesh()
    dtype = dtype or get_config().default_dtype
    local = _generate((rows, cols), axis_sizes(mesh), block_sharding(mesh),
                      distribution, seed, dtype, **params)
    return BlockMatrix(local, mesh=mesh, dtype=dtype, blks_by_row=blks_by_row,
                       blks_by_col=blks_by_col, _logical_shape=(rows, cols))


def random_dist_vector(length: int, distribution: str = "uniform",
                       seed=None, mesh: Optional[Mesh] = None, dtype=None,
                       **params):
    """Random distributed vector (``MTUtils.randomDistVector``,
    MTUtils.scala:87)."""
    from ..matrix.vector import DistributedVector

    mesh = mesh or default_mesh()
    dtype = dtype or get_config().default_dtype
    local = _generate((length,), (mesh.size,), vector_sharding(mesh),
                      distribution, seed, dtype, **params)
    return DistributedVector(local, mesh=mesh, dtype=dtype,
                             _logical_len=length)


def zeros_den_vec_matrix(rows: int, cols: int, mesh=None, dtype=None):
    """(MTUtils.scala:103)."""
    return random_den_vec_matrix(rows, cols, distribution="zeros", seed=0,
                                 mesh=mesh, dtype=dtype)


def ones_den_vec_matrix(rows: int, cols: int, mesh=None, dtype=None):
    """(MTUtils.scala:119)."""
    return random_den_vec_matrix(rows, cols, distribution="ones", seed=0,
                                 mesh=mesh, dtype=dtype)


def ones_dist_vector(length: int, mesh=None, dtype=None):
    """(MTUtils.scala:128)."""
    return random_dist_vector(length, distribution="ones", seed=0, mesh=mesh,
                              dtype=dtype)


def random_spa_vec_matrix(rows: int, cols: int, sparsity: float = 0.1,
                          distribution: str = "uniform", seed=None,
                          mesh: Optional[Mesh] = None, dtype=None, **params):
    """Random sparse matrix (``MTUtils.randomSpaVecMatrix``,
    MTUtils.scala:75): each element kept with probability ``sparsity``
    (a second uniform draw gates it). Collective over the mesh."""
    from ..matrix.sparse import SparseVecMatrix

    base = hash_seed(seed)
    vals = random_den_vec_matrix(rows, cols, distribution=distribution,
                                 seed=base, mesh=mesh, dtype=dtype, **params)
    gate = random_den_vec_matrix(rows, cols, distribution="uniform",
                                 seed=base + 1, mesh=mesh, dtype=dtype)
    v = vals.logical
    dense = torch.where(gate.logical < sparsity, v, torch.zeros_like(v))
    return SparseVecMatrix.from_dense_array(dense, mesh=vals.mesh)
