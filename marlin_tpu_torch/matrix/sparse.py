"""Sparse matrix types, on one device.

Port of ``marlin_tpu/matrix/sparse.py``: :class:`CoordinateMatrix` (COO
index/value triples with a :class:`MatrixEntry` view) and
:class:`SparseVecMatrix`, whose storage is a torch sparse COO tensor where
the JAX package keeps a BCOO. The path this module carries is COO triples
or a dense array -> :class:`SparseVecMatrix` ->
:meth:`SparseVecMatrix.to_block_sparse` -> the block-sparse GEMM kernels
(``ops.block_sparse``).

The sparse data lives whole on one device: every constructor takes
``device`` (default the GPU, raising without one), or a ``mesh``, whose
device it then uses and which a ``DenseVecMatrix`` result lands on
(``to_dense_vec_matrix``, ``from_dense``, sparse x dense). What needs the
distributed sparse ring raises ``NotImplementedError`` naming the ROADMAP
item that ports it: ``distribute``, ``multiply_sparse``,
``to_dist_sparse`` and ``als`` (A4b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import x64_enabled
from ..utils.hw import resolve_device


def _deferred(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A, item {item}")


def _device(mesh, device) -> torch.device:
    """The mesh's device where there is a mesh, else ``device``."""
    return mesh.device if mesh is not None else resolve_device(device)


def _coo(idx, values, shape) -> torch.Tensor:
    """A sparse COO tensor (not coalesced) whose indices are checked
    against ``shape`` at construction: an index out of range raises here
    and not as a device fault when the matrix is densified."""
    with torch.sparse.check_sparse_tensor_invariants(True):
        return torch.sparse_coo_tensor(idx.long(), values, tuple(shape))


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16, which numpy lacks, as
    float32 (exact)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


class MatrixEntry:
    """(i, j, value) view of one COO entry."""

    __slots__ = ("i", "j", "value")

    def __init__(self, i: int, j: int, value: float):
        self.i, self.j, self.value = int(i), int(j), float(value)

    def __iter__(self):
        return iter((self.i, self.j, self.value))

    def __repr__(self):
        return f"MatrixEntry({self.i}, {self.j}, {self.value})"


class CoordinateMatrix:
    """COO-format matrix: three equal-length tensors on one device.

    With ``padded=True`` the tensors carry fixed-size padding — pad
    entries have value 0 at index (0, 0) — and logical views (``nnz``,
    ``entries``) exclude them.

    Instances are immutable: do not rebind ``row_idx``/``col_idx``/
    ``values`` after construction — derived metadata (the ``_nnz`` cache,
    ``_shape`` from ``_compute_size``) is computed once and would go
    stale."""

    def __init__(self, rows, cols, values,
                 shape: Optional[Tuple[int, int]] = None, mesh=None,
                 padded: bool = False, device="cuda"):
        self.mesh = mesh
        dev = _device(mesh, device)
        idx_dtype = torch.int64 if x64_enabled() else torch.int32
        self.row_idx = torch.as_tensor(rows).to(device=dev, dtype=idx_dtype)
        self.col_idx = torch.as_tensor(cols).to(device=dev, dtype=idx_dtype)
        self.values = torch.as_tensor(values).to(dev)
        self.padded = bool(padded)
        if (self.row_idx.shape != self.col_idx.shape
                or self.row_idx.shape != self.values.shape):
            raise ValueError("rows/cols/values must have equal lengths")
        self._shape = shape
        self._nnz: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return self.values.device

    # -- metadata -----------------------------------------------------------
    def _compute_size(self) -> Tuple[int, int]:
        """Size by max-index reduce."""
        return (int(self.row_idx.max()) + 1, int(self.col_idx.max()) + 1)

    @property
    def shape(self) -> Tuple[int, int]:
        if self._shape is None:
            self._shape = self._compute_size()
        return self._shape

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        if self._nnz is None:
            self._nnz = (int((self.values != 0).sum()) if self.padded
                         else int(self.values.shape[0]))
        return self._nnz

    def compact_triples(self):
        """Host ``(rows, cols, values)`` with pad slots removed.

        This is THE pad-filtering point — every consumer of possibly-padded
        triples routes through it. Pads are value-0 slots, so an explicitly
        stored 0 entry of a padded matrix is not preserved."""
        r = _to_host(self.row_idx)
        c = _to_host(self.col_idx)
        v = _to_host(self.values)
        if self.padded:
            keep = v != 0
            r, c, v = r[keep], c[keep], v[keep]
        return r, c, v

    def entries(self):
        return [MatrixEntry(*t) for t in zip(*self.compact_triples())]

    # -- conversions --------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Densified host value; duplicate indices add."""
        v = _to_host(self.values)
        arr = np.zeros(self.shape, dtype=v.dtype)
        np.add.at(arr, (_to_host(self.row_idx), _to_host(self.col_idx)), v)
        return arr

    to_breeze = to_numpy

    def to_dense_vec_matrix(self, mesh=None):
        """Densify to the row-distributed type (``toDenseVecMatrix``,
        CoordinateMatrix.scala:51) in the config's default dtype;
        duplicate indices add. On ``mesh``, else this matrix's, else the
        default mesh."""
        from ..config import get_config
        from .dense import DenseVecMatrix

        dtype = get_config().default_dtype
        out = torch.zeros(self.shape, dtype=dtype, device=self.device)
        out.index_put_((self.row_idx.long(), self.col_idx.long()),
                       self.values.to(dtype), accumulate=True)
        return DenseVecMatrix(out, mesh=mesh or self.mesh)

    def to_sparse_coo(self) -> torch.Tensor:
        """The triples as a torch sparse COO tensor (not coalesced), the
        counterpart of the JAX package's ``to_bcoo``; pad slots of a
        padded matrix are dropped first."""
        if self.padded:
            # Pads leaking through would inflate nnz and duplicate index
            # (0, 0) in every downstream op.
            r, c, v = self.compact_triples()
            idx = torch.from_numpy(np.stack([r, c])).to(self.device)
            vals = torch.from_numpy(v).to(device=self.device,
                                          dtype=self.values.dtype)
        else:
            idx = torch.stack([self.row_idx, self.col_idx])
            vals = self.values
        return _coo(idx, vals, self.shape)

    def to_dist_sparse(self, mesh=None):
        raise _deferred("the distributed sparse form (to_dist_sparse)",
                        "A4b")

    def to_sparse_vec_matrix(self, mesh=None):
        return SparseVecMatrix(self.to_sparse_coo(), mesh=mesh or self.mesh)

    def als(self, rank: int, iterations: int = 10, lambda_: float = 0.01,
            implicit_prefs: bool = False, alpha: float = 1.0, seed=None):
        raise _deferred("alternating least squares (als)", "A4b")

    def __repr__(self):
        return f"CoordinateMatrix(shape={self.shape}, nnz={self.nnz})"


class SparseVecMatrix:
    """Sparse matrix backed by a torch sparse COO tensor on one device."""

    def __init__(self, coo: torch.Tensor, mesh=None):
        self.mesh = mesh
        if coo.layout != torch.sparse_coo:
            raise ValueError(
                f"expected a sparse COO tensor, got layout {coo.layout}")
        if coo.dim() != 2:
            raise ValueError("expected a 2-D sparse matrix")
        self._coo = coo

    # -- metadata -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self._coo.shape)

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        """Stored entries, as given (duplicates counted)."""
        return int(self._coo._nnz())

    @property
    def dtype(self) -> torch.dtype:
        return self._coo.dtype

    @property
    def device(self) -> torch.device:
        return self._coo.device

    @property
    def coo(self) -> torch.Tensor:
        return self._coo

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_dense(cls, mat, mesh=None):
        """From a distributed dense matrix (its logical value, gathered:
        this sparse type is whole on every rank by design until ROADMAP
        A4b distributes it; collective over its mesh)."""
        return cls.from_dense_array(mat.logical, mesh=mesh or mat.mesh)

    @classmethod
    def from_dense_array(cls, arr, mesh=None, device="cuda"):
        """From a dense array or tensor: one stored entry per nonzero
        element. A tensor stays on its own device; anything else is
        placed on ``device`` (the mesh's, with a mesh)."""
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(np.asarray(arr)).to(_device(mesh, device))
        idx = arr.nonzero().T
        return cls(_coo(idx, arr[idx[0], idx[1]], arr.shape), mesh=mesh)

    @classmethod
    def from_coo(cls, rows, cols, values, shape, mesh=None, device="cuda"):
        dev = _device(mesh, device)
        idx = torch.stack([torch.as_tensor(rows).to(dev),
                           torch.as_tensor(cols).to(dev)])
        return cls(_coo(idx, torch.as_tensor(values).to(dev), shape),
                   mesh=mesh)

    # -- ops ----------------------------------------------------------------
    def multiply_sparse(self, other: "SparseVecMatrix"):
        raise _deferred("sparse x sparse (multiply_sparse, the distributed "
                        "ring)", "A4b")

    def distribute(self, mesh=None):
        raise _deferred("the distributed sparse form (distribute)", "A4b")

    def multiply(self, other):
        """Sparse x (sparse | dense): a DenseVecMatrix operand goes
        through torch sparse products, sparse first
        (SparseMultiply.scala:31-82), on a ring of the operand's ranks
        (:meth:`_times_dense`); the result lands on this matrix's mesh,
        else the operand's. Collective over the operand's mesh."""
        from .dense import DenseVecMatrix

        if isinstance(other, SparseVecMatrix):
            return self.multiply_sparse(other)
        if isinstance(other, DenseVecMatrix):
            if self.num_cols != other.num_rows:
                raise ValueError(
                    f"dimension mismatch: {self.shape} x {other.shape}")
            out = self._times_dense(other)
            if self.mesh is not None and self.mesh is not other.mesh:
                out = out._as(DenseVecMatrix, mesh=self.mesh)
            return out
        raise TypeError(
            f"cannot multiply SparseVecMatrix by {type(other).__name__}")

    def _times_dense(self, b):
        """S @ B for a row-striped B on B's mesh, row-striped, with no
        whole dense operand: B's row stripes pass round a ring of the
        mesh's ranks, and at each step a rank adds the product of its rows
        of S, restricted to the columns of the stripe in hand, times that
        stripe. S (held by every rank) is never densified. Collective over
        B's mesh."""
        from ..parallel.summa import ring_exchange
        from .dense import DenseVecMatrix

        mesh = b.mesh
        m, n = self.num_rows, b.num_cols
        p = mesh.size
        hm, hk = -(-m // p), b._physical_shape[0] // p
        out = DenseVecMatrix(None, mesh=mesh, dtype=b.dtype,
                             _logical_shape=(m, n))
        if not b.holds:
            return out
        at = mesh.ranks.index(dist.get_rank())
        coo = self._coo.to(b.local.device, b.dtype).coalesce()
        idx, vals = coo.indices(), coo.values()
        mine = (idx[0] >= at * hm) & (idx[0] < (at + 1) * hm)
        idx, vals = idx[:, mine], vals[mine]
        acc = torch.zeros((hm, n), dtype=b.dtype, device=b.local.device)
        stripe = b.local
        for step in range(p):
            s = (at + step) % p
            cols = (idx[1] >= s * hk) & (idx[1] < (s + 1) * hk)
            part = torch.sparse_coo_tensor(
                idx[:, cols] - torch.tensor([[at * hm], [s * hk]],
                                            device=idx.device),
                vals[cols], (hm, hk))
            acc += torch.sparse.mm(part, stripe)
            if step + 1 < p:
                stripe = ring_exchange(stripe, mesh.ranks[(at - 1) % p],
                                       mesh.ranks[(at + 1) % p])
        out._local = acc
        return out

    def to_dense_vec_matrix(self):
        """Densify (``toDenseVecMatrix``, SparseVecMatrix.scala:56) onto
        this matrix's mesh (the default mesh without one)."""
        from .dense import DenseVecMatrix

        return DenseVecMatrix(self._densify(), mesh=self.mesh)

    def _densify(self) -> torch.Tensor:
        """The dense tensor on this matrix's device; duplicates add."""
        idx = self._coo._indices()
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((idx[0], idx[1]), self._coo._values(),
                              accumulate=True)

    def to_block_sparse(self, block_size: int = 128):
        """Block-compressed form for the SpMM kernels (ops.block_sparse):
        dense blocks + block mask, zero blocks skipped."""
        from ..ops.block_sparse import BlockSparse

        return BlockSparse.from_dense(self._densify(), block_size=block_size)

    def to_numpy(self) -> np.ndarray:
        return _to_host(self._densify())

    to_breeze = to_numpy

    def __repr__(self):
        return f"SparseVecMatrix(shape={self.shape}, nnz={self.nnz})"
