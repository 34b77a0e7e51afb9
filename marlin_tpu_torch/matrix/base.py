"""DistributedMatrix: the common interface of the dense distributed
types. Port of ``marlin_tpu/matrix/base.py``.

The JAX package wraps one logical ``jax.Array`` with a ``NamedSharding``;
the port keeps, on each rank, that rank's shard of the same array (a local
tensor, ``local``) plus the mesh and the logical shape. Every rank runs
the same program: a method that communicates is called on every rank of
the matrix's mesh. A rank outside the mesh holds nothing (``local`` is
None, ``holds`` False) and skips the communication.

Padding, as in the reference: the physical array is the logical one
zero-padded to the layout's shard multiples, so every shard (and every
buffer a collective moves) has the same size on every rank. Ops that
would write the pad region re-mask it; reductions and exports read the
logical view.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import get_config
from torch.distributed.tensor import Shard

from ..mesh import (Layout, Mesh, all_reduce_sum, default_mesh, local_slices,
                    redistribute, shard, unshard)
from ..utils.split import pad_to

Scalar = Union[int, float]


def _deferred(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A, item {item}")


def as_tensor(data, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``data`` (a tensor, an ndarray or nested lists) as a tensor of
    ``dtype``; with no dtype, that of ``data`` where it has one, else the
    config's default."""
    if isinstance(data, torch.Tensor):
        t = data
    elif isinstance(data, np.ndarray) or hasattr(data, "dtype"):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(data)))
    else:
        t = torch.as_tensor(data, dtype=dtype or get_config().default_dtype)
    return t if dtype is None else t.to(dtype)


def to_host(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16, which numpy lacks, as
    float32 (exact)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


class DistributedMatrix:
    """Base of DenseVecMatrix and BlockMatrix: this rank's shard of a
    zero-padded physical matrix on a mesh."""

    _local: Optional[torch.Tensor]
    _shape: Tuple[int, int]  # logical
    mesh: Mesh

    def __init__(self, data, mesh: Optional[Mesh] = None, dtype=None,
                 _logical_shape: Optional[Tuple[int, int]] = None):
        self.mesh = mesh or default_mesh()
        if _logical_shape is not None:
            # ``data`` is already this rank's physical shard (None outside
            # the mesh) -- the internal path.
            self._shape = tuple(int(s) for s in _logical_shape)
            self._local = data
            self._dtype = dtype or data.dtype
            return
        arr = as_tensor(data, dtype)
        if arr.dim() != 2:
            raise ValueError(
                f"expected a 2-D matrix, got shape {tuple(arr.shape)}")
        if arr.numel() == 0:
            # Empty-input error contract (DenseVecMatrix.scala:58-66).
            raise ValueError(
                "cannot construct a distributed matrix from empty data")
        self._shape = (int(arr.shape[0]), int(arr.shape[1]))
        self._dtype = arr.dtype
        self._local = self._place(arr)

    # -- layout hooks -------------------------------------------------------
    def _sharding(self) -> Layout:
        raise NotImplementedError

    def _pad_multiples(self) -> Tuple[int, int]:
        """(row, col) multiples the physical array rounds up to."""
        raise NotImplementedError

    def _place(self, arr: torch.Tensor) -> Optional[torch.Tensor]:
        """This rank's shard of ``arr`` (logical, held by every rank),
        padded to shard multiples."""
        return shard(pad_to(arr, self._pad_multiples()), self._sharding())

    @property
    def _physical_shape(self) -> Tuple[int, int]:
        mr, mc = self._pad_multiples()
        m, n = self._shape
        return (-(-m // mr) * mr, -(-n // mc) * mc)

    def _like(self, local) -> "DistributedMatrix":
        """Same-type matrix around a shard of the same physical shape."""
        return type(self)(local, mesh=self.mesh, dtype=self._dtype
                          if local is None else None,
                          _logical_shape=self._shape)

    def _from_logical(self, arr) -> "DistributedMatrix":
        """Same-type matrix from a logical array every rank holds."""
        return type(self)(arr, mesh=self.mesh)

    def _local_in(self, layout: Layout, mults) -> Optional[torch.Tensor]:
        """This rank's shard of the logical matrix zero-padded to
        ``mults`` under ``layout`` (on this mesh or another), moved shard
        to shard (:func:`redistribute`); None outside ``layout``'s mesh.
        Collective over the ranks of both meshes."""
        phys = tuple(-(-s // m) * m for s, m in zip(self._shape, mults))
        return redistribute(self._local, self._sharding(),
                            self._physical_shape, layout, phys, self._shape,
                            self._dtype)

    @classmethod
    def _from_shard(cls, local: Optional[torch.Tensor], layout: Layout,
                    phys: Tuple[int, int], shape: Tuple[int, int],
                    dtype: torch.dtype, mesh: Optional[Mesh] = None, **kw):
        """A ``cls`` matrix of logical ``shape`` on ``mesh`` (default:
        ``layout``'s) from this rank's shard ``local`` of a tensor padded to
        ``phys`` under ``layout``, moved shard to shard into ``cls``'s own
        layout. Collective over the ranks of both meshes."""
        out = cls(None, mesh=mesh or layout.mesh, dtype=dtype,
                  _logical_shape=shape, **kw)
        out._local = redistribute(local, layout, phys, out._sharding(),
                                  out._physical_shape, shape, dtype)
        return out

    def _as(self, cls, mesh: Optional[Mesh] = None, **kw):
        """This matrix as a ``cls`` matrix on ``mesh`` (default: its own),
        moved shard to shard. Collective over the ranks of both meshes."""
        return cls._from_shard(self._local, self._sharding(),
                               self._physical_shape, self._shape,
                               self._dtype, mesh=mesh or self.mesh, **kw)

    def _coerce(self, other: "DistributedMatrix") -> torch.Tensor:
        """``other``'s shard laid out like ours, in our dtype (for
        elementwise ops between layouts)."""
        return other._local_in(self._sharding(),
                               self._pad_multiples()).to(self._dtype)

    def _remask(self, local: torch.Tensor) -> torch.Tensor:
        """Zero the pad region of this rank's shard (after an op that
        wrote it)."""
        m, n = self._shape
        if self._physical_shape == (m, n):
            return local
        rs, cs = local_slices(self._sharding(), self._physical_shape)
        rows = torch.arange(rs.start, rs.stop, device=local.device) < m
        cols = torch.arange(cs.start, cs.stop, device=local.device) < n
        return torch.where(rows[:, None] & cols[None, :], local,
                           torch.zeros((), dtype=local.dtype,
                                       device=local.device))

    # -- metadata (DistributedMatrix.scala:14-21) ---------------------------
    @property
    def num_rows(self) -> int:
        return self._shape[0]

    @property
    def num_cols(self) -> int:
        return self._shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def holds(self) -> bool:
        """Whether this rank holds a shard (is part of the mesh)."""
        return self._local is not None

    @property
    def local(self) -> Optional[torch.Tensor]:
        """This rank's shard of the physical (padded) matrix."""
        return self._local

    @property
    def data(self):
        """The physical (padded, sharded) matrix as a DTensor."""
        from ..mesh import _dtensor

        return _dtensor(self._local, self._sharding(), self._physical_shape)

    @property
    def logical(self) -> torch.Tensor:
        """The logical matrix, whole, on every rank of the mesh (gathered
        from the shards). Collective over the mesh."""
        self._require_local()
        m, n = self._shape
        return unshard(self._local, self._sharding(),
                       self._physical_shape)[:m, :n]

    def elements_count(self) -> int:
        return self.num_rows * self.num_cols

    def _require_local(self) -> None:
        if self._local is None:
            import torch.distributed as dist

            raise RuntimeError(
                f"rank {dist.get_rank()} is outside this matrix's mesh "
                f"{self.mesh} and holds no part of it")

    # -- materialization ----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """The logical matrix on the host (``toBreeze``). Collective over
        the mesh."""
        return to_host(self.logical)

    to_breeze = to_numpy

    def evaluate(self) -> "DistributedMatrix":
        """Wait for the device work behind this matrix
        (``MTUtils.evaluate``)."""
        if self._local is not None and self._local.is_cuda:
            torch.cuda.synchronize(self._local.device)
        return self

    # -- elementwise algebra (DistributedMatrix.scala:23-54) ----------------
    def add(self, other) -> "DistributedMatrix":
        if isinstance(other, DistributedMatrix):
            self._check_same_shape(other, "add")
            return self._like(self._local + self._coerce(other))
        return self._like(self._remask(self._local + other))

    def subtract(self, other) -> "DistributedMatrix":
        if isinstance(other, DistributedMatrix):
            self._check_same_shape(other, "subtract")
            return self._like(self._local - self._coerce(other))
        return self._like(self._remask(self._local - other))

    def subtract_by(self, scalar: Scalar) -> "DistributedMatrix":
        """scalar - M (DistributedMatrix.scala:44)."""
        return self._like(self._remask(scalar - self._local))

    def divide(self, scalar: Scalar) -> "DistributedMatrix":
        return self._like(self._local / scalar)

    def divide_by(self, scalar: Scalar) -> "DistributedMatrix":
        """scalar / M (DistributedMatrix.scala:48)."""
        return self._like(self._remask(scalar / self._local))

    def element_multiply(self, other: "DistributedMatrix"
                         ) -> "DistributedMatrix":
        """Hadamard product (BlockMatrix.scala:673)."""
        self._check_same_shape(other, "element_multiply")
        return self._like(self._local * self._coerce(other))

    # -- reductions ---------------------------------------------------------
    def _acc_dtype(self) -> torch.dtype:
        """Reductions accumulate in >= f32 whatever the element type."""
        return torch.promote_types(self._dtype, torch.float32)

    def _sum_over_mesh(self, local_value: torch.Tensor) -> float:
        return float(all_reduce_sum(local_value.reshape(1), self.mesh))

    def sum(self) -> float:
        """Sum of all elements (DenseVecMatrix.scala:889): a local sum per
        shard (pad zeros add nothing), then an all-reduce."""
        self._require_local()
        return self._sum_over_mesh(self._local.sum(dtype=self._acc_dtype()))

    def dot_product(self, other: "DistributedMatrix") -> float:
        """Sum of the elementwise product (DenseVecMatrix.scala:905)."""
        self._check_same_shape(other, "dot_product")
        acc = self._acc_dtype()
        return self._sum_over_mesh(
            (self._local.to(acc) * self._coerce(other).to(acc)).sum())

    def norm(self, kind: str = "1") -> float:
        """Matrix norm: "1" (max abs column sum) or "inf" (max abs row
        sum) (DenseVecMatrix.scala:975)."""
        if kind not in ("1", "inf", "Inf"):
            raise ValueError(
                f"unsupported norm kind {kind!r} (use '1' or 'inf')")
        a = self.logical.abs().to(self._acc_dtype())
        return float(a.sum(dim=0 if kind == "1" else 1).max())

    # -- structure ----------------------------------------------------------
    def transpose(self) -> "DistributedMatrix":
        """A^T, shard to shard: each rank gathers the shard of A whose
        transpose is its shard of A^T (A's layout with the two dims
        swapped) and transposes it locally."""
        lay = self._sharding()
        swapped = Layout(lay.mesh, tuple(
            Shard(1 - p.dim) if isinstance(p, Shard) else p
            for p in lay.placements))
        mr, mc = self._pad_multiples()
        local = self._local_in(swapped, (mc, mr))
        return type(self)(None if local is None else local.T.contiguous(),
                          mesh=self.mesh, dtype=self._dtype,
                          _logical_shape=(self.num_cols, self.num_rows))

    @property
    def T(self) -> "DistributedMatrix":
        return self.transpose()

    def c_bind(self, other: "DistributedMatrix") -> "DistributedMatrix":
        """Column concatenation [A | B] (DenseVecMatrix.scala:238)."""
        if self.num_rows != other.num_rows:
            raise ValueError(f"cBind requires equal row counts: "
                             f"{self.num_rows} vs {other.num_rows}")
        return self._from_logical(torch.cat(
            [self.logical, other.logical.to(self._dtype)], dim=1))

    def inverse(self, mode: str = "auto"):
        raise _deferred("the blocked inverse (inverse)", "A2b")

    def multiply(self, other, *args, **kwargs):
        raise NotImplementedError

    def save_to_file_system(self, path: str, fmt: Optional[str] = None):
        raise _deferred("text I/O (save_to_file_system)", "A6")

    def print_matrix(self, max_rows: int = 20) -> None:
        """First rows preview (DistributedMatrix.scala:70)."""
        arr = self.to_numpy()
        print(f"{type(self).__name__} {self.num_rows}x{self.num_cols} "
              f"dtype={self.dtype}")
        print(arr[:max_rows])

    def print_all(self) -> None:
        print(self.to_numpy())

    def _check_same_shape(self, other: "DistributedMatrix", op: str) -> None:
        if self.shape != other.shape:
            raise ValueError(
                f"{op} requires equal shapes: {self.shape} vs {other.shape}")

    __add__ = add
    __sub__ = subtract

    def __mul__(self, other):
        return self.multiply(other)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, mesh={tuple(self.mesh.shape.items())})")
