"""Distributed GEMM engines over the device mesh: port of
``marlin_tpu/parallel/summa.py``.

The reference's collectives become ``torch.distributed`` calls (NCCL on
the card, gloo on the CPU) on each rank's shard; each per-device product
is a ``torch.matmul`` (cuBLAS on the card), as it was a ``jnp.dot`` for
XLA. Four engines:

* ``gspmd``  -- two DTensors in the block layout, redistributed by
  DTensor to A's row stripes and B's column stripes, then one local
  product into C's block (the plan GSPMD makes, steered explicitly).
* ``summa``  -- all-gather SUMMA: gather A's row panel along "mc" and B's
  column panel along "mr", then one local product.
* ``cannon`` -- square meshes: skew, then p - 1 ring steps of point to
  point exchanges (``batch_isend_irecv``), one k-step resident at a time,
  accumulating in at least f32 and casting back once.
* :func:`matmul_3d` -- a (pm, pk, pn) grid of ranks: each rank gets only
  its (gm, gk) block of A and (gk, gn) block of B, makes one local product
  in at least f32, and ``reduce_scatter`` over the k axis ("gk") leaves C
  block sharded.

Operands are zero-padded to shard-divisible shapes (so every collective
moves equal-size buffers on every rank) and the logical result is sliced
back out. A distributed operand reaches an engine's layout shard to shard
(``mesh.redistribute``): no rank holds a whole operand.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import get_config, matmul_precision_scope
from ..mesh import (Layout, Mesh, _build, _dtensor, _layout, axis_sizes,
                    block_sharding, default_mesh, redistribute,
                    replicated_sharding, shard, unshard)
from ..obs.trace import tracer as _tracer
from ..utils.split import pad_to

ENGINES = ("gspmd", "summa", "cannon")


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """A cross-step accumulator of at least f32."""
    return torch.promote_types(dtype, torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: Optional[str]):
    with matmul_precision_scope(precision):
        return torch.matmul(a, b)


def _axis_ranks(mesh: Mesh, axis: str):
    """The ranks along mesh axis ``axis`` through this rank, in mesh
    order."""
    index = list(mesh.coordinate)
    index[mesh.dim_index(axis)] = slice(None)
    return [int(r) for r in mesh.devices[tuple(index)]]


def _all_gather_cat(x: torch.Tensor, mesh: Mesh, axis: str,
                    dim: int) -> torch.Tensor:
    """The shards of ``x`` along mesh axis ``axis``, concatenated along
    ``dim`` in mesh order."""
    if mesh.shape[axis] == 1:
        return x
    group = mesh.dim_group(axis)
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=group)
    order = dist.get_process_group_ranks(group)
    return torch.cat([parts[order.index(r)]
                      for r in _axis_ranks(mesh, axis)], dim=dim)


def ring_exchange(x: torch.Tensor, send_to: int,
                  recv_from: int) -> torch.Tensor:
    """Send ``x`` to rank ``send_to`` and return what rank ``recv_from``
    sends (one step of a ring or the skew)."""
    me = dist.get_rank()
    if send_to == me and recv_from == me:
        return x
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x.contiguous(),
                                              send_to),
                                   dist.P2POp(dist.irecv, buf, recv_from)])
    for r in reqs:
        r.wait()
    return buf


def _summa_local(a, b, mesh: Mesh, precision):
    cfg = get_config()
    a_panel = _all_gather_cat(a, mesh, cfg.mesh_axis_cols, 1)  # (m/P, k)
    b_panel = _all_gather_cat(b, mesh, cfg.mesh_axis_rows, 0)  # (k, n/Q)
    return _mm(a_panel, b_panel, precision)


def _cannon_local(a, b, mesh: Mesh, precision):
    cfg = get_config()
    ri, ci = mesh.dim_index(cfg.mesh_axis_rows), mesh.dim_index(
        cfg.mesh_axis_cols)
    p = mesh.devices.shape[ri]
    coord = mesh.coordinate
    i, j = coord[ri], coord[ci]

    def rank(r, c):
        index = list(coord)
        index[ri], index[ci] = r % p, c % p
        return int(mesh.devices[tuple(index)])

    # Skew: (i, j) ends up with A(i, i + j) and B(i + j, j).
    a = ring_exchange(a, rank(i, j - i), rank(i, j + i))
    b = ring_exchange(b, rank(i - j, j), rank(i + j, j))
    if p == 1:
        return _mm(a, b, precision)
    acc_t = _acc_dtype(a.dtype)
    acc = _mm(a.to(acc_t), b.to(acc_t), precision)
    for _ in range(p - 1):
        a = ring_exchange(a, rank(i, j - 1), rank(i, j + 1))  # A left by one
        b = ring_exchange(b, rank(i - 1, j), rank(i + 1, j))  # B up by one
        acc += _mm(a.to(acc_t), b.to(acc_t), precision)
    return acc.to(a.dtype)


def _gspmd_local(a, b, mesh: Mesh, precision):
    """GSPMD's plan for two block-sharded operands, steered rather than
    left to DTensor's propagation: DTensor moves A to its row stripe (rows
    over "mr", columns whole) and B to its column stripe (rows whole,
    columns over "mc"), and each rank multiplies its two stripes into its
    block of C, which stays block-sharded (the reference's
    ``out_shardings``). No rank holds a whole A, B or C."""
    cfg = get_config()
    lay = block_sharding(mesh)
    pr, pc = axis_sizes(mesh)
    rows = _layout(mesh, {cfg.mesh_axis_rows: 0}).placements
    cols = _layout(mesh, {cfg.mesh_axis_cols: 1}).placements
    da = _dtensor(a, lay, (a.shape[0] * pr, a.shape[1] * pc))
    db = _dtensor(b, lay, (b.shape[0] * pr, b.shape[1] * pc))
    a_stripe = da.redistribute(mesh.device_mesh, list(rows)).to_local()
    b_stripe = db.redistribute(mesh.device_mesh, list(cols)).to_local()
    return _mm(a_stripe, b_stripe, precision)


def _operand(x, layout: Layout, mults) -> Optional[torch.Tensor]:
    """This rank's shard of ``x`` zero-padded to ``mults`` under
    ``layout``: a distributed matrix moves shard to shard; a tensor is
    held whole by every rank that calls (None on ranks outside its
    mesh)."""
    if hasattr(x, "_local_in"):
        return x._local_in(layout, mults)
    if x is None:
        return None
    return shard(pad_to(x, mults), layout)


def matmul_blocks(a, b, mesh: Optional[Mesh] = None,
                  engine: Optional[str] = None,
                  precision: Optional[str] = None):
    """C = A @ B by ``engine`` on the 2-D mesh, left sharded: returns
    (this rank's block shard of C zero-padded to (pr, pc) multiples, or
    None outside the mesh; C's logical shape). ``a`` and ``b`` are
    distributed matrices or tensors that every rank of the mesh holds.
    Collective over the mesh."""
    cfg = get_config()
    mesh = mesh or default_mesh()
    engine = engine or cfg.gemm_engine
    precision = precision or cfg.matmul_precision
    (m, k), (k2, n) = tuple(a.shape), tuple(b.shape)
    if k != k2:
        raise ValueError(f"inner dimensions mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if engine not in ENGINES:
        raise ValueError(f"unknown gemm engine: {engine!r}")
    pr, pc = axis_sizes(mesh)
    if engine == "cannon" and pr != pc:
        engine = "summa"
    # k padded to a common multiple, so A's column shards and B's row
    # shards agree.
    lcm = math.lcm(pr, pc)
    ap = _operand(a, block_sharding(mesh), (pr, lcm))
    bp = _operand(b, block_sharding(mesh), (lcm, pc))
    if not mesh.holds:
        return None, (m, n)
    fn = {"gspmd": _gspmd_local, "summa": _summa_local,
          "cannon": _cannon_local}[engine]
    with _tracer.span("summa.matmul", engine=engine, m=m, k=k, n=n):
        return fn(ap, bp, mesh, precision), (m, n)


def matmul(a, b, mesh: Optional[Mesh] = None, engine: Optional[str] = None,
           precision: Optional[str] = None) -> Optional[torch.Tensor]:
    """Distributed C = A @ B on the 2-D mesh: the logical C on every rank
    of the mesh (None outside it). ``a`` and ``b`` as for
    :func:`matmul_blocks`. Collective over the mesh."""
    mesh = mesh or default_mesh()
    c, (m, n) = matmul_blocks(a, b, mesh, engine, precision)
    if c is None:
        return None
    pr, pc = axis_sizes(mesh)
    return unshard(c, block_sharding(mesh),
                   (c.shape[0] * pr, c.shape[1] * pc))[:m, :n]


_mesh3_cache: dict = {}


def _mesh3d(device_type: str, ranks: Tuple[int, ...],
            grid: Tuple[int, int, int]) -> Mesh:
    key = (device_type, ranks, grid)
    if key not in _mesh3_cache:
        _mesh3_cache[key] = _build(device_type, ranks, grid,
                                   ("gm", "gk", "gn"))
    return _mesh3_cache[key]


def matmul_3d_blocks(a, b, grid: Tuple[int, int, int],
                     precision: Optional[str] = None,
                     devices: Optional[Sequence[int]] = None,
                     mesh: Optional[Mesh] = None):
    """C = A @ B over an explicit (pm, pk, pn) grid of the first
    pm * pk * pn ranks of ``devices`` (default: ``mesh``'s, the default
    mesh's when None): the counterpart of ``multiply(that, (m, k, n))``
    (DenseVecMatrix.scala:109). Rank (gm, gk, gn) receives A's block
    (gm, gk) and B's block (gk, gn) and multiplies them in at least f32;
    ``reduce_scatter`` over "gk" sums the k axis and leaves rank (gm, gk,
    gn) the gk-th row piece of C's block (gm, gn). Returns (this rank's
    piece or None, its layout on the grid, C's padded shape, C's logical
    shape). ``a`` and ``b`` as for :func:`matmul_blocks`. Collective over
    the default group (the grid's groups are built on first use)."""
    cfg = get_config()
    precision = precision or cfg.matmul_precision
    mesh = mesh or default_mesh()
    ranks = tuple(int(r) for r in devices) if devices is not None \
        else mesh.ranks
    pm, pk, pn = (int(g) for g in grid)
    if pm * pk * pn > len(ranks):
        raise ValueError(f"grid {tuple(grid)} needs {pm * pk * pn} "
                         f"devices, have {len(ranks)}")
    (m, k), (k2, n) = tuple(a.shape), tuple(b.shape)
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    mesh3 = _mesh3d(mesh.device_mesh.device_type, ranks[:pm * pk * pn],
                    (pm, pk, pn))
    # A's rows pad to pm * pk so that each block's rows split over "gk".
    ap = _operand(a, _layout(mesh3, {"gm": 0, "gk": 1}), (pm * pk, pk))
    bp = _operand(b, _layout(mesh3, {"gk": 0, "gn": 1}), (pk, pn))
    c_layout = _layout(mesh3, {"gm": 0, "gk": 0, "gn": 1})
    phys = (-(-m // (pm * pk)) * pm * pk, -(-n // pn) * pn)
    if ap is None:
        return None, c_layout, phys, (m, n)
    dtype = ap.dtype
    # Partials ride >= f32 through the sum over "gk"; with no k split the
    # one product rounds once, in A's dtype.
    acc_t = _acc_dtype(dtype) if pk > 1 else dtype
    part = _mm(ap.to(acc_t), bp.to(acc_t), precision)
    if pk > 1:
        group = mesh3.dim_group("gk")
        line = _axis_ranks(mesh3, "gk")
        chunks = part.chunk(pk)
        part = torch.cat([chunks[line.index(r)]
                          for r in dist.get_process_group_ranks(group)])
        piece = torch.empty_like(chunks[0])
        dist.reduce_scatter_tensor(piece, part, group=group)
        part = piece
    return part.to(dtype), c_layout, phys, (m, n)


def matmul_3d(a, b, grid: Tuple[int, int, int],
              precision: Optional[str] = None,
              devices: Optional[Sequence[int]] = None,
              mesh: Optional[Mesh] = None) -> Optional[torch.Tensor]:
    """:func:`matmul_3d_blocks`, then the logical C on every rank of
    ``mesh`` (None outside it). Collective over the default group."""
    mesh = mesh or default_mesh()
    c, layout, phys, (m, n) = matmul_3d_blocks(a, b, grid, precision,
                                               devices, mesh)
    dtype = a.dtype
    full = redistribute(c, layout, phys, replicated_sharding(mesh), phys,
                        (m, n), dtype)
    return None if full is None else full[:m, :n]
