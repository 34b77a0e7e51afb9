"""DenseVecMatrix: the row-distributed dense matrix. Port of
``marlin_tpu/matrix/dense.py``.

Rows are striped over every device of the mesh (``row_sharding``). GEMM
dispatch follows the reference's ``multiply(that, cores, threshold)``
(DenseVecMatrix.scala:196-231) arm for arm; the per-device products are
``torch.matmul`` (cuBLAS on the card) and the communication is
``torch.distributed`` (NCCL on the card, gloo on the CPU). Operands move
between layouts and meshes shard to shard (``mesh.redistribute``): only
the broadcast arms put a whole operand, the one under the threshold, on
every rank. The blocked decompositions, the SVD and least squares are
:mod:`..linalg`; file I/O is ROADMAP Queue A6.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import (get_config, linalg_precision_scope,
                      matmul_precision_scope)
from ..mesh import (Layout, Mesh, all_reduce_sum, col_sharding, default_mesh,
                    local_slices, row_sharding, submesh)
from ..parallel import summa
from ..utils.split import grid_for_devices, is_near_square
from ..utils.timing import metrics
from .base import DistributedMatrix, _deferred, as_tensor, to_host


class DenseVecMatrix(DistributedMatrix):
    """Row-distributed dense matrix on the mesh."""

    def _sharding(self) -> Layout:
        return row_sharding(self.mesh)

    def _pad_multiples(self) -> Tuple[int, int]:
        return (self.mesh.size, 1)  # rows over every device, cols whole

    # ------------------------------------------------------------------
    # GEMM dispatch (DenseVecMatrix.scala:196-231)
    # ------------------------------------------------------------------
    def multiply(self, other, parallelism: Optional[int] = None,
                 broadcast_threshold_mb: Optional[float] = None,
                 mode: Optional[Union[str, Tuple[int, int, int]]] = None):
        """Auto-strategy GEMM, arm for arm the reference's dispatch:

        * scalar                 -> elementwise scale (:149)
        * SparseVecMatrix        -> dense x sparse, a torch sparse product
        * distributed vector     -> mat-vec (:162)
        * local tensor / ndarray -> broadcast-B (:1660-1680): B on every
                                    device, one local product per row stripe
        * ``other`` under threshold -> the same broadcast path
        * ``self`` under threshold  -> the mirrored broadcast (:206-207)
        * near-square shapes     -> 2-D SUMMA on the whole mesh (:208-213)
        * otherwise              -> the CARMA grid (:215-217): the 3-D
                                    engine, or the 2-D one without a k split

        ``mode`` forces a path: "broadcast", "summa", "cannon", "gspmd" or
        an (m, k, n) split tuple (DenseVecMatrix.scala:109).
        ``parallelism`` below the device count runs the whole dispatch on
        the submesh of the first ``parallelism`` devices. Collective over
        the mesh (and, where it builds a submesh or a 3-D grid, over the
        default group)."""
        from .sparse import SparseVecMatrix
        from .vector import DistributedVector

        cfg = get_config()
        if isinstance(other, (int, float)):
            return self._like(self._local * other)
        if isinstance(other, SparseVecMatrix):
            if self.num_cols != other.num_rows:
                raise ValueError(
                    f"dimension mismatch: {self.shape} x {other.shape}")
            return self._times_sparse(other)
        if isinstance(other, DistributedVector):
            return self._times_vector(other)
        if not isinstance(other, DistributedMatrix):
            if not isinstance(other, (np.ndarray, torch.Tensor)):
                raise TypeError(f"cannot multiply by {type(other).__name__}")
            arr = as_tensor(other, self._dtype).to(self.mesh.device)
            if arr.dim() == 1:
                return self._times_vector(DistributedVector(arr,
                                                            mesh=self.mesh))
            return self._multiply_broadcast(arr)
        if self.num_cols != other.num_rows:
            raise ValueError(
                f"dimension mismatch: {self.shape} x {other.shape}")

        n_dev = self.mesh.size
        par = min(parallelism, n_dev) if parallelism else n_dev
        if par < n_dev:
            # The reference's `cores` shrinks the partition count on every
            # arm; here both operands move to a submesh (shard to shard)
            # and the whole dispatch runs there.
            sub = submesh(self.mesh, par)
            return self._as(DenseVecMatrix, mesh=sub).multiply(
                other._as(DenseVecMatrix, mesh=sub),
                broadcast_threshold_mb=broadcast_threshold_mb, mode=mode)

        if isinstance(mode, tuple):
            return self._multiply_grid(other, mode, forced=True)
        if mode == "broadcast":
            return self._broadcast_of(other)
        if mode in summa.ENGINES:
            return _block_product(self, other, self.mesh, mode)
        if mode is not None:
            raise ValueError(f"unknown multiply mode {mode!r}")

        threshold = (broadcast_threshold_mb
                     if broadcast_threshold_mb is not None
                     else cfg.broadcast_threshold_mb)
        m, k, n = self.num_rows, self.num_cols, other.num_cols
        if size_mb(other) < threshold:
            return self._broadcast_of(other)  # Branch A
        if size_mb(self) < threshold:
            return _left_broadcast(self, other)  # Branch B
        if is_near_square(m, k, n):  # Branch C
            engine = cfg.gemm_engine if cfg.gemm_engine != "gspmd" \
                else "summa"
            return _block_product(self, other, self.mesh, engine)
        # Branch D: the CARMA grid over the matrix's devices.
        return self._multiply_grid(other, grid_for_devices(m, k, n, n_dev))

    def _multiply_grid(self, other: DistributedMatrix,
                       grid: Tuple[int, int, int], forced: bool = False):
        pm, pk, pn = grid
        n_dev = self.mesh.size
        if pk == 1:
            # No k split: the 2-D engine is that decomposition.
            return _block_product(self, other, self.mesh, None)
        if pm * pk * pn > n_dev:
            # An over-subscribed grid runs the 2-D engine, loudly: the
            # metrics registry counts it, and a forced grid warns.
            metrics.incr("gemm.grid_fallback")
            if forced:
                warnings.warn(
                    f"requested GEMM grid {grid} needs {pm * pk * pn} "
                    f"devices but the mesh has {n_dev}; running the 2-D "
                    "engine instead (same result, no k-split parallelism)",
                    stacklevel=3)
            return _block_product(self, other, self.mesh, None)
        return _grid_product(self, other, grid)

    def _broadcast_of(self, other: DistributedMatrix) -> "DenseVecMatrix":
        """The broadcast-B path for a distributed B (its logical value on
        every device, whole by design); a rank outside the mesh gets an
        empty result."""
        if not self.holds:
            return _on(self.mesh, DenseVecMatrix, None, self,
                       shape=(self.num_rows, other.num_cols))
        return self._multiply_broadcast(other.logical)

    def _multiply_broadcast(self, b: torch.Tensor,
                            precision: Optional[str] = None
                            ) -> "DenseVecMatrix":
        """Broadcast-B GEMM (DenseVecMatrix.scala:1660-1680): B on every
        device, one local product per row stripe, no communication. Runs
        on the physical stripe (pad rows are zero and stay zero)."""
        if b.dim() != 2 or b.shape[0] != self.num_cols:
            raise ValueError(
                f"dimension mismatch: {self.shape} x {tuple(b.shape)}")
        b = b.to(device=self.mesh.device, dtype=self._dtype)
        with matmul_precision_scope(precision):
            out = torch.matmul(self._local, b)
        return DenseVecMatrix(out, mesh=self.mesh,
                              _logical_shape=(self.num_rows, int(b.shape[1])))

    def _times_sparse(self, other) -> "DenseVecMatrix":
        """Dense x sparse without densifying B (LibMatrixMult.scala:15-41):
        each rank's row stripe times B, which every rank holds, as (B^T
        A_s^T)^T, the sparse operand first; the stripes of the product are
        the result's (pad rows stay zero)."""
        if not self.holds:
            return DenseVecMatrix(None, mesh=self.mesh, dtype=self._dtype,
                                  _logical_shape=(self.num_rows,
                                                  other.num_cols))
        coo = other.coo.to(self.mesh.device, self._dtype)
        out = torch.sparse.mm(coo.t().coalesce(), self._local.t()).t()
        return DenseVecMatrix(out.contiguous(), mesh=self.mesh,
                              _logical_shape=(self.num_rows, other.num_cols))

    def _times_vector(self, v) -> "DistributedVector":
        """Distributed mat-vec y = A x (DenseVecMatrix.scala:162): x on
        every device (whole by design, as the broadcast arms' operand),
        each row stripe gives its chunk of y."""
        from .vector import DistributedVector

        x = v.to_tensor().to(device=self.mesh.device, dtype=self._dtype)
        if x.shape[0] != self.num_cols:
            raise ValueError(
                f"dimension mismatch: {self.shape} x {tuple(x.shape)}")
        with matmul_precision_scope():
            y = torch.matmul(self._local, x)
        return DistributedVector(y, mesh=self.mesh, column_major=True,
                                 _logical_len=self.num_rows)

    def multiply_by(self, a) -> "DenseVecMatrix":
        """A @ self for a local matrix A every rank holds
        (BlockMatrix.scala:309)."""
        a = as_tensor(a, self._dtype).to(self.mesh.device)
        if a.dim() != 2 or a.shape[1] != self.num_rows:
            raise ValueError(
                f"dimension mismatch: {tuple(a.shape)} x {self.shape}")
        return _left_times(a, self, DenseVecMatrix)

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------
    def row_exchange(self, i: int, j: int) -> "DenseVecMatrix":
        """Swap rows i and j (``rowExchange``, DenseVecMatrix.scala:261):
        every other row stays in place, and the two rows pass between
        their owning ranks (a local swap when one rank owns both).
        Collective over the mesh."""
        if not (0 <= i < self.num_rows and 0 <= j < self.num_rows):
            raise ValueError(f"row indices [{i}, {j}] out of range for "
                             f"{self.num_rows} rows")
        lo, hi = sorted((i, j))
        cols = slice(0, self.num_cols)
        moves = [((slice(a, b), cols), (0, 0)) for a, b in
                 ((0, lo), (lo + 1, hi), (hi + 1, self.num_rows)) if a < b]
        if lo < hi:
            moves += [((slice(hi, hi + 1), cols), (lo - hi, 0)),
                      ((slice(lo, lo + 1), cols), (hi - lo, 0))]
        else:
            moves.append(((slice(lo, lo + 1), cols), (0, 0)))
        return self._assembled([(self, moves)], self._shape, self._dtype,
                               self.mesh)

    def slice_by_row(self, start: int, end: int) -> "DenseVecMatrix":
        """Rows [start, end], both ends inclusive
        (DenseVecMatrix.scala:928), shard to shard. Collective over the
        mesh."""
        self._check_range(start, end, self.num_rows, "row")
        return self._window(slice(start, end + 1), slice(0, self.num_cols))

    def slice_by_column(self, start: int, end: int) -> "DenseVecMatrix":
        """Columns [start, end] inclusive (DenseVecMatrix.scala:941),
        shard to shard. Collective over the mesh."""
        self._check_range(start, end, self.num_cols, "column")
        return self._window(slice(0, self.num_rows), slice(start, end + 1))

    def get_sub_matrix(self, start_row: int, end_row: int, start_col: int,
                       end_col: int) -> "DenseVecMatrix":
        """Inclusive-range sub-matrix (DenseVecMatrix.scala:956), shard
        to shard. Collective over the mesh."""
        self._check_range(start_row, end_row, self.num_rows, "row")
        self._check_range(start_col, end_col, self.num_cols, "column")
        return self._window(slice(start_row, end_row + 1),
                            slice(start_col, end_col + 1))

    @staticmethod
    def _check_range(start: int, end: int, limit: int, what: str) -> None:
        if not (0 <= start <= end and end < limit):
            raise ValueError(
                f"start {what} or end {what} mismatch the matrix num of "
                f"{what}s: [{start}, {end}] vs {limit}")

    # ------------------------------------------------------------------
    # Conversions
    # ------------------------------------------------------------------
    def to_block_matrix(self, blks_by_row: Optional[int] = None,
                        blks_by_col: Optional[int] = None):
        """Re-layout to the 2-D block distribution (``toBlockMatrix``,
        DenseVecMatrix.scala:1226); the logical block grid is metadata."""
        from .block import BlockMatrix

        return self._as(BlockMatrix, blks_by_row=blks_by_row,
                        blks_by_col=blks_by_col)

    def to_sparse_vec_matrix(self):
        """The sparse row type (DenseVecMatrix.scala:1333)."""
        from .sparse import SparseVecMatrix

        return SparseVecMatrix.from_dense(self)

    def to_dataframe(self):
        raise _deferred("the DataFrame export (to_dataframe)", "A6")

    # ------------------------------------------------------------------
    # Gramian (DenseVecMatrix.scala:1444-1484)
    # ------------------------------------------------------------------
    def multiply_gramian_matrix_by(self, v) -> np.ndarray:
        """(A^T A) v without forming the Gramian
        (``multiplyGramianMatrixBy``, DenseVecMatrix.scala:1444-1459), as a
        host array. Collective over the mesh."""
        return to_host(_GramianOperator(self)(v))

    def gramian_matvec_operator(self) -> "_GramianOperator":
        """``v -> (A^T A) v`` on the mesh device's tensors, for an
        iterative eigensolver, with the Lanczos operator protocol
        (``apply(operand, v)``, ``operand``: this rank's stripe). Each
        call is collective over the mesh."""
        return _GramianOperator(self)

    def compute_gramian_matrix(self) -> np.ndarray:
        """G = A^T A as a host array (``computeGramianMatrix``,
        DenseVecMatrix.scala:1464-1484): one local product per stripe,
        summed over the mesh, so G (n x n by contract) is whole on every
        rank. Collective over the mesh."""
        with linalg_precision_scope():
            g = torch.matmul(self._local.T, self._local)
        return to_host(all_reduce_sum(g, self.mesh))

    def compute_svd(self, k: int, compute_u: bool = True,
                    r_cond: float = 1e-9, max_iter: int = 300,
                    tol: float = 1e-10, mode: str = "auto"):
        """Top-k singular value decomposition via the Gramian
        (``computeSVD``, DenseVecMatrix.scala:1531-1648). See
        :mod:`..linalg.svd`. Collective over the mesh."""
        from ..linalg.svd import compute_svd as _svd

        return _svd(self, k, compute_u=compute_u, r_cond=r_cond,
                    max_iter=max_iter, tol=tol, mode=mode)

    # ------------------------------------------------------------------
    # Decompositions (wired to linalg)
    # ------------------------------------------------------------------
    def lu_decompose(self, mode: str = "auto"):
        """Blocked LU with partial pivoting (``luDecompose``,
        DenseVecMatrix.scala:283-461): (BlockMatrix of packed L and U,
        pivot array). Collective over the mesh."""
        from ..linalg.lu import lu_decompose as _lu

        return _lu(self, mode=mode)

    def cholesky_decompose(self, mode: str = "auto"):
        """Blocked Cholesky (``choleskyDecompose``,
        DenseVecMatrix.scala:475): lower-triangular BlockMatrix L with
        A = L L^T. Collective over the mesh."""
        from ..linalg.cholesky import cholesky_decompose as _chol

        return _chol(self, mode=mode)

    # ------------------------------------------------------------------
    # ML: full-batch logistic-regression gradient descent
    # ------------------------------------------------------------------
    def lr(self, step_size: float, iters: int) -> np.ndarray:
        """Logistic-regression gradient descent (``lr``,
        DenseVecMatrix.scala:1005-1035). Row format is (label, features);
        the label column is replaced by an intercept 1. The reference's
        mapPartitions + reduce per iteration is each rank's gradient over
        its own rows, summed by one all-reduce; the weights live on every
        rank's device and the loop never waits on the host. Returns the
        weights as a host array. Collective over the mesh."""
        self._require_local()
        m, n = self.num_rows, self.num_cols
        rs = local_slices(self._sharding(), self._physical_shape)[0]
        real = (torch.arange(rs.start, rs.stop, device=self._local.device)
                < m)
        labels = self._local[:, 0]
        feats = self._local.clone()
        feats[:, 0] = real.to(feats.dtype)  # intercept; pad rows stay 0
        w = torch.zeros(n, dtype=feats.dtype, device=feats.device)
        with matmul_precision_scope():
            for i in range(1, iters + 1):
                margin = -torch.matmul(feats, w)
                mul = 1.0 / (1.0 + torch.exp(margin)) - labels
                grad = all_reduce_sum(torch.matmul(feats.T, mul), self.mesh)
                w = w - grad * (step_size / m / math.sqrt(i))
        return to_host(w)

    def save_with_description(self, path: str, name: str = "N/A") -> None:
        raise _deferred("text I/O (save_with_description)", "A6")

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_rows(cls, rows, num_cols: Optional[int] = None, mesh=None):
        """From (row_index, vector) pairs (DenseVecMatrix.scala:41);
        missing rows are zero."""
        rows = list(rows)
        if not rows:
            raise ValueError(
                "cannot construct a distributed matrix from empty data")
        max_idx = max(int(i) for i, _ in rows)
        width = num_cols or max(len(np.atleast_1d(v)) for _, v in rows)
        return cls.from_row_stream(iter(rows), (max_idx + 1, width),
                                   mesh=mesh,
                                   dtype=np.asarray(rows[0][1]).dtype)

    @classmethod
    def from_row_stream(cls, rows, shape: Tuple[int, int], mesh=None,
                        dtype=None):
        """From a stream of (row_index, vector) pairs."""
        asm = _StripeAssembler(shape, mesh, dtype)
        for idx, v in rows:
            vec = np.atleast_1d(np.asarray(v))
            asm.add(np.asarray([int(idx)]), vec[None, :])
        return asm.finish(cls)

    @classmethod
    def from_row_chunks(cls, chunks, shape: Tuple[int, int], mesh=None,
                        dtype=None):
        """From (row_indices, values) array chunks."""
        asm = _StripeAssembler(shape, mesh, dtype)
        for idx, vals in chunks:
            asm.add(np.asarray(idx), np.asarray(vals))
        return asm.finish(cls)


class _GramianOperator:
    """``v -> (A^T A) v`` of a DenseVecMatrix on its mesh device's
    tensors, with the Lanczos operator protocol: ``apply(operand, v)`` runs
    on the stripe it is handed (``operand``: this rank's stripe, the one
    ``__call__`` hands over), each stripe's A_s^T (A_s v) summed over the
    mesh (pad rows are zero). Collective over the mesh."""

    def __init__(self, mat: DenseVecMatrix):
        mat._require_local()
        self.mesh = mat.mesh
        self.operand = mat.local

    def apply(self, operand: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        v = torch.as_tensor(v).to(device=operand.device, dtype=operand.dtype)
        with linalg_precision_scope():
            part = torch.matmul(operand.T, torch.matmul(operand, v))
        return all_reduce_sum(part, self.mesh)

    def __call__(self, v) -> torch.Tensor:
        return self.apply(self.operand, v)


class _StripeAssembler:
    """Collects row batches into the host matrix, stripe by stripe as the
    reference's streaming constructors route them: a stripe (a device's
    rows) is done when its last row arrives, and a row for a stripe that
    is done raises (a duplicate row). Values narrower than the matrix
    zero-pad on the right; within a batch the last duplicate wins."""

    def __init__(self, shape: Tuple[int, int], mesh, dtype):
        self.mesh = mesh or default_mesh()
        self.n_rows, self.width = (int(s) for s in shape)
        if self.n_rows <= 0 or self.width <= 0:
            raise ValueError(f"bad stream shape {shape}")
        np_dtype = np.dtype(dtype) if dtype is not None else np.dtype(
            str(get_config().default_dtype).replace("torch.", ""))
        self.buf = np.zeros((self.n_rows, self.width), np_dtype)
        self.nd = self.mesh.size
        self.stripe_h = -(-self.n_rows // self.nd)
        self.seen = np.zeros(self.n_rows, bool)
        self.remaining = {d: max(0, min(self.stripe_h,
                                        self.n_rows - d * self.stripe_h))
                          for d in range(self.nd)}
        self.done = set()

    def add(self, idx: np.ndarray, vals: np.ndarray) -> None:
        if idx.size == 0:
            return
        if idx.min() < 0 or idx.max() >= self.n_rows:
            bad = idx[(idx < 0) | (idx >= self.n_rows)][0]
            raise ValueError(f"row index {bad} outside shape "
                             f"({self.n_rows}, {self.width})")
        d_of = np.minimum(idx // self.stripe_h, self.nd - 1)
        for d in np.unique(d_of):
            if int(d) in self.done:
                raise ValueError(f"rows for stripe {int(d)} arrived after "
                                 f"it shipped (duplicate row?)")
        self.buf[idx, :vals.shape[1]] = vals
        for d in np.unique(d_of):
            d = int(d)
            uniq = np.unique(idx[d_of == d])
            self.remaining[d] -= int(np.count_nonzero(~self.seen[uniq]))
            self.seen[uniq] = True
            if self.remaining[d] == 0:
                self.done.add(d)

    def finish(self, cls):
        return cls(torch.from_numpy(self.buf), mesh=self.mesh)


def size_mb(mat: DistributedMatrix) -> float:
    """Logical operand footprint in MB, which drives the broadcast
    threshold (DenseVecMatrix.scala:203)."""
    itemsize = torch.empty((), dtype=mat.dtype).element_size()
    return mat.elements_count() * itemsize / 1e6


def _on(mesh: Mesh, cls, full, like, shape=None):
    """A ``cls`` matrix on ``mesh`` from ``full`` (the logical value, held
    by every rank of ``mesh``; None on ranks outside it, which get an
    empty matrix of ``like``'s dtype and ``shape`` (default ``like``'s))."""
    if mesh.holds:
        return cls(full, mesh=mesh)
    return cls(None, mesh=mesh, dtype=like.dtype,
               _logical_shape=shape or like.shape)


def _block_product(a: DistributedMatrix, b: DistributedMatrix, mesh: Mesh,
                   engine: Optional[str]):
    """A @ B by a 2-D engine (None: the config's) as a BlockMatrix on
    ``mesh``."""
    from .block import BlockMatrix

    c, shape = summa.matmul_blocks(a, b, mesh=mesh, engine=engine)
    return BlockMatrix(c, mesh=mesh, dtype=a.dtype, _logical_shape=shape)


def _grid_product(a: DistributedMatrix, b: DistributedMatrix,
                  grid: Tuple[int, int, int]):
    """A @ B by the 3-D engine over ``grid`` on A's mesh, as a
    BlockMatrix there (C's pieces move shard to shard)."""
    from .block import BlockMatrix

    c, layout, phys, shape = summa.matmul_3d_blocks(a, b, grid, mesh=a.mesh)
    return BlockMatrix._from_shard(c, layout, phys, shape, a.dtype,
                                   mesh=a.mesh)


def _left_times(a: torch.Tensor, big: DistributedMatrix, cls):
    """``a`` (held whole by every rank of ``big``'s mesh) @ ``big`` as a
    ``cls`` matrix: each rank multiplies ``a`` by its column stripe of
    ``big``, and the product's column stripes move shard to shard into
    ``cls``'s layout. No rank holds ``big`` or the product whole."""
    mesh = big.mesh
    layout = col_sharding(mesh)
    cols = big._local_in(layout, (1, mesh.size))
    c = None
    if cols is not None:
        with matmul_precision_scope():
            c = torch.matmul(a, cols.to(a.dtype))
    m, n = int(a.shape[0]), big.num_cols
    return cls._from_shard(c, layout, (m, -(-n // mesh.size) * mesh.size),
                           (m, n), a.dtype, mesh=mesh)


def _right_times(mat: DistributedMatrix, b: torch.Tensor, cls):
    """``mat`` @ ``b`` (``b`` held whole by every rank of the mesh) as a
    ``cls`` matrix: each row stripe of ``mat`` times ``b`` is a row stripe
    of the product, moved shard to shard into ``cls``'s layout."""
    mesh = mat.mesh
    layout = row_sharding(mesh)
    rows = mat._local_in(layout, (mesh.size, 1))
    c = None
    if rows is not None:
        with matmul_precision_scope():
            c = torch.matmul(rows, b.to(mesh.device, mat.dtype))
    m, n = mat.num_rows, int(b.shape[1])
    return cls._from_shard(c, layout, (-(-m // mesh.size) * mesh.size, n),
                           (m, n), mat.dtype, mesh=mesh)


def _left_broadcast(small: DenseVecMatrix, big: DistributedMatrix):
    """Branch B: ``small`` on every device (it is under the broadcast
    threshold), times ``big``'s column stripes."""
    a = small.logical if small.holds else None
    if a is None:
        return _on(small.mesh, DenseVecMatrix, None, small,
                   shape=(small.num_rows, big.num_cols))
    return _left_times(a, big, DenseVecMatrix)
