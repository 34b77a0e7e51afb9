"""BlockMatrix: the 2-D block-partitioned matrix. Port of
``marlin_tpu/matrix/block.py``.

Rows are sharded over the mesh's "mr" axis and columns over "mc"
(``block_sharding``); the logical block grid (``blks_by_row`` x
``blks_by_col``) is metadata, so re-gridding moves no data. File I/O is
ROADMAP Queue A6.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import get_config, matmul_precision_scope
from ..mesh import Layout, axis_sizes, block_sharding, row_sharding, submesh
from ..parallel import summa
from .base import DistributedMatrix, _deferred, as_tensor


class BlockMatrix(DistributedMatrix):
    """2-D block-distributed dense matrix on the mesh."""

    def __init__(self, data, mesh=None, dtype=None,
                 blks_by_row: Optional[int] = None,
                 blks_by_col: Optional[int] = None,
                 _logical_shape: Optional[Tuple[int, int]] = None):
        super().__init__(data, mesh=mesh, dtype=dtype,
                         _logical_shape=_logical_shape)
        pr, pc = axis_sizes(self.mesh)
        # The logical block grid (BlockMatrix.scala:36-65).
        self.blks_by_row = blks_by_row or pr
        self.blks_by_col = blks_by_col or pc

    def _sharding(self) -> Layout:
        return block_sharding(self.mesh)

    def _pad_multiples(self) -> Tuple[int, int]:
        return axis_sizes(self.mesh)

    def _like(self, local) -> "BlockMatrix":
        return BlockMatrix(local, mesh=self.mesh,
                           dtype=self._dtype if local is None else None,
                           blks_by_row=self.blks_by_row,
                           blks_by_col=self.blks_by_col,
                           _logical_shape=self._shape)

    def _from_logical(self, arr) -> "BlockMatrix":
        return BlockMatrix(arr, mesh=self.mesh, blks_by_row=self.blks_by_row,
                           blks_by_col=self.blks_by_col)

    # ------------------------------------------------------------------
    # Block metadata
    # ------------------------------------------------------------------
    def block_size(self) -> Tuple[int, int]:
        """Nominal (rows, cols) of a grid block; edge blocks may be
        smaller."""
        return (-(-self.num_rows // self.blks_by_row),
                -(-self.num_cols // self.blks_by_col))

    def block_extent(self, bi: int, bj: int) -> Tuple[int, int, int, int]:
        """(row0, row1, col0, col1), half-open, of logical block
        (bi, bj)."""
        br, bc = self.block_size()
        r0, c0 = bi * br, bj * bc
        return r0, min(r0 + br, self.num_rows), c0, min(c0 + bc,
                                                        self.num_cols)

    def get_block(self, bi: int, bj: int) -> torch.Tensor:
        """One logical block's value. Collective over the mesh."""
        r0, r1, c0, c1 = self.block_extent(bi, bj)
        return self.logical[r0:r1, c0:c1]

    # ------------------------------------------------------------------
    # GEMM (BlockMatrix.scala:87-343)
    # ------------------------------------------------------------------
    def multiply(self, other, parallelism: Optional[int] = None,
                 broadcast_threshold_mb: Optional[float] = None,
                 mode: Optional[Union[str, Tuple[int, int, int]]] = None):
        """Auto-strategy GEMM (``multiply(dm, cores, threshold)``,
        BlockMatrix.scala:87-122): scalar, vector, local tensor and
        distributed operands; broadcast under the threshold, else a 2-D
        engine; an (m, k, n) tuple runs the 3-D engine. Collective over
        the mesh."""
        from .dense import _grid_product, _on, _right_times, size_mb
        from .vector import DistributedVector

        cfg = get_config()
        if isinstance(other, (int, float)):
            return self._like(self._local * other)
        if isinstance(other, DistributedVector):
            return self._times_vector(other.to_tensor())
        if not isinstance(other, DistributedMatrix):
            if not isinstance(other, (np.ndarray, torch.Tensor)):
                raise TypeError(f"cannot multiply by {type(other).__name__}")
            arr = as_tensor(other, self._dtype).to(self.mesh.device)
            if arr.dim() == 1:
                return self._times_vector(arr)
            return self._times_local(arr)
        if self.num_cols != other.num_rows:
            raise ValueError(
                f"dimension mismatch: {self.shape} x {other.shape}")

        n_dev = self.mesh.size
        par = min(parallelism, n_dev) if parallelism else n_dev
        if par < n_dev:
            sub = submesh(self.mesh, par)
            return self._as(BlockMatrix, mesh=sub).multiply(
                other._as(BlockMatrix, mesh=sub),
                broadcast_threshold_mb=broadcast_threshold_mb, mode=mode)

        if isinstance(mode, tuple):
            return _grid_product(self, other, mode)
        threshold = (broadcast_threshold_mb
                     if broadcast_threshold_mb is not None
                     else cfg.broadcast_threshold_mb)
        if mode is None and size_mb(other) < threshold:
            if not self.holds:
                return _on(self.mesh, BlockMatrix, None, self,
                           shape=(self.num_rows, other.num_cols))
            return _right_times(self, other.logical, BlockMatrix)
        engine = mode or ("summa" if cfg.gemm_engine == "gspmd"
                          else cfg.gemm_engine)
        c, shape = summa.matmul_blocks(self, other, mesh=self.mesh,
                                       engine=engine)
        return BlockMatrix(c, mesh=self.mesh, dtype=self._dtype,
                           _logical_shape=shape)

    def _times_vector(self, x: torch.Tensor):
        from .vector import DistributedVector

        if x.shape[0] != self.num_cols:
            raise ValueError(
                f"dimension mismatch: {self.shape} x {tuple(x.shape)}")
        # The row stripes of A give y's chunks (both cut over every rank).
        size = self.mesh.size
        rows = self._local_in(row_sharding(self.mesh), (size, 1))
        y = None
        if rows is not None:
            with matmul_precision_scope():
                y = torch.matmul(rows, x.to(self.mesh.device, self._dtype))
        return DistributedVector(y, mesh=self.mesh, column_major=True,
                                 dtype=self._dtype,
                                 _logical_len=self.num_rows)

    def _times_local(self, b: torch.Tensor) -> "BlockMatrix":
        from .dense import _right_times

        if b.shape[0] != self.num_cols:
            raise ValueError(
                f"dimension mismatch: {self.shape} x {tuple(b.shape)}")
        return _right_times(self, b, BlockMatrix)

    def multiply_by(self, a) -> "BlockMatrix":
        """A @ self for a local matrix A every rank holds
        (``multiplyBy``, BlockMatrix.scala:309)."""
        from .dense import _left_times

        a = as_tensor(a, self._dtype).to(self.mesh.device)
        if a.shape[1] != self.num_rows:
            raise ValueError(
                f"dimension mismatch: {tuple(a.shape)} x {self.shape}")
        return _left_times(a, self, BlockMatrix)

    def transpose(self) -> "BlockMatrix":
        """Transpose with the block grid swapped (BlockMatrix.scala:514),
        shard to shard."""
        out = super().transpose()
        out.blks_by_row, out.blks_by_col = self.blks_by_col, self.blks_by_row
        return out

    def c_bind(self, other) -> "BlockMatrix":
        """[A | B] keeping A's row grid; the column grid resets to the mesh
        default (BlockMatrix.scala:687)."""
        if self.num_rows != other.num_rows:
            raise ValueError(f"cBind requires equal row counts: "
                             f"{self.num_rows} vs {other.num_rows}")
        return BlockMatrix(
            torch.cat([self.logical, other.logical.to(self._dtype)], dim=1),
            mesh=self.mesh, blks_by_row=self.blks_by_row)

    # ------------------------------------------------------------------
    # Conversions
    # ------------------------------------------------------------------
    def to_dense_vec_matrix(self):
        """Back to the row distribution (BlockMatrix.scala:575)."""
        from .dense import DenseVecMatrix

        return self._as(DenseVecMatrix)

    def to_dense_blocks(self) -> "BlockMatrix":
        """``toDenseBlocks`` (BlockMatrix.scala:596): blocks are always
        dense here, so the identity."""
        return self

    def to_block_matrix(self, blks_by_row: int,
                        blks_by_col: int) -> "BlockMatrix":
        """Re-grid (BlockMatrix.scala:610): metadata only."""
        return BlockMatrix(self._local, mesh=self.mesh, dtype=self._dtype,
                           blks_by_row=blks_by_row, blks_by_col=blks_by_col,
                           _logical_shape=self._shape)

    def save_to_file_system(self, path: str, fmt: Optional[str] = None):
        raise _deferred("block text I/O (save_to_file_system)", "A6")
