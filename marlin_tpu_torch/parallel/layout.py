"""Block and shard placement helpers: port of
``marlin_tpu/parallel/layout.py``.

The reference's partitioners routed data to executors; on a mesh,
placement is declared by the layout, and these helpers answer the inverse
questions: which device (here: which rank) owns a logical block, row or
vector chunk, and which (m, k, n)-grid cell a replicated GEMM block lands
on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..mesh import Mesh, axis_sizes, default_mesh


@dataclass(frozen=True)
class BlockID:
    """Logical block coordinate (Block.scala:37-48); ``seq`` tags
    replicated copies in the GEMM grid."""

    row: int
    column: int
    seq: int = 0


def grid_seq(block: BlockID, m_split: int, k_split: int, n_split: int,
             k: int) -> int:
    """The destination cell of a replicated block in an (m, k, n) grid
    (MatrixMultPartitioner numPartitions = m*k*n)."""
    return block.row * k_split * n_split + k * n_split + block.column


def elem_op_partition(block: BlockID, blks_by_col: int) -> int:
    """``row * numBlksByCol + column`` (MatrixElemOpPartitioner.scala:13-19)."""
    return block.row * blks_by_col + block.column


def device_for_block(bi: int, bj: int, blks_by_row: int, blks_by_col: int,
                     mesh: Optional[Mesh] = None) -> int:
    """The rank owning logical block (bi, bj) under the 2-D block layout
    (blocks map proportionally onto the mesh grid)."""
    mesh = mesh or default_mesh()
    pr, pc = axis_sizes(mesh)
    di = min(bi * pr // max(blks_by_row, 1), pr - 1)
    dj = min(bj * pc // max(blks_by_col, 1), pc - 1)
    return int(mesh.devices[di][dj])


def stripe_for_row(row: int, num_rows: int,
                   mesh: Optional[Mesh] = None) -> int:
    """Stripe (flat device) index of a logical row under the row-striped
    layout."""
    mesh = mesh or default_mesh()
    n_dev = mesh.size
    stripe = -(-num_rows // n_dev)
    return min(row // stripe, n_dev - 1)


def device_for_row(row: int, num_rows: int,
                   mesh: Optional[Mesh] = None) -> int:
    """The rank owning a logical row under the row-striped layout."""
    mesh = mesh or default_mesh()
    return mesh.ranks[stripe_for_row(row, num_rows, mesh)]


def colocated(row: int, chunk: int, num_rows: int, num_chunks: int,
              mesh: Optional[Mesh] = None) -> bool:
    """Whether data row ``row`` and vector chunk ``chunk`` live on the
    same rank (NeuralNetwork.scala:272-280)."""
    mesh = mesh or default_mesh()
    ranks = mesh.ranks
    chunk_rank = ranks[min(chunk * len(ranks) // max(num_chunks, 1),
                           len(ranks) - 1)]
    return device_for_row(row, num_rows, mesh) == chunk_rank
