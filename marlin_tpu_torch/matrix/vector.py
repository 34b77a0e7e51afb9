"""Distributed vectors: port of ``marlin_tpu/matrix/vector.py``.

``DistributedVector`` and ``DistributedIntVector``: on each rank, its
chunk of one 1-D tensor zero-padded to a multiple of the mesh's device
count and chunked over every device (``vector_sharding``), plus the row or
column orientation flag. ``transpose`` flips the flag; ``multiply_vector``
is the outer product (a BlockMatrix) or the inner product (a scalar) by
orientation.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config import get_config, matmul_precision_scope
from ..mesh import (Layout, Mesh, _layout, all_reduce_sum, default_mesh,
                    redistribute, replicated_sharding, shard,
                    vector_sharding)
from ..utils.split import pad_to
from .base import as_tensor, to_host


class DistributedVector:
    """Chunk-distributed vector with row/column orientation."""

    def __init__(self, data, mesh: Optional[Mesh] = None,
                 column_major: bool = True, dtype=None,
                 _logical_len: Optional[int] = None):
        self.mesh = mesh or default_mesh()
        # Column-major == column vector (DistributedVector.scala:24-29).
        self.column_major = column_major
        if _logical_len is not None:
            # ``data`` is this rank's chunk already (None outside the mesh).
            self._len = int(_logical_len)
            self._local = data
            self._dtype = dtype or data.dtype
            return
        arr = as_tensor(data, dtype)
        if arr.dim() != 1:
            raise ValueError(
                f"expected a 1-D vector, got shape {tuple(arr.shape)}")
        if arr.numel() == 0:
            raise ValueError(
                "cannot construct a distributed vector from empty data")
        self._len = int(arr.shape[0])
        self._dtype = arr.dtype
        self._local = shard(pad_to(arr, (self.mesh.size,)),
                            vector_sharding(self.mesh))

    # -- metadata (DistributedVector.scala:31-43) ---------------------------
    @property
    def length(self) -> int:
        return self._len

    @property
    def split_num(self) -> int:
        """Number of physical chunks: one per device."""
        return self.mesh.size

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def local(self) -> Optional[torch.Tensor]:
        """This rank's chunk of the padded vector."""
        return self._local

    @property
    def holds(self) -> bool:
        return self._local is not None

    @property
    def _physical_len(self) -> int:
        return -(-self._len // self.mesh.size) * self.mesh.size

    def _local_in(self, layout: Layout, multiple: int
                  ) -> Optional[torch.Tensor]:
        """This rank's chunk of the vector zero-padded to ``multiple``
        under ``layout`` (on this mesh or another), moved shard to shard;
        None outside ``layout``'s mesh. Collective over the ranks of both
        meshes."""
        return redistribute(self._local, vector_sharding(self.mesh),
                            (self._physical_len,), layout,
                            (-(-self._len // multiple) * multiple,),
                            (self._len,), self._dtype)

    def to_tensor(self) -> torch.Tensor:
        """The logical vector on every rank of the mesh, whole by contract
        (the host export's and the mat-vec's operand): each chunk passes
        point to point from its rank. Collective over the mesh."""
        return self._local_in(replicated_sharding(self.mesh), 1)

    def to_numpy(self) -> np.ndarray:
        """``toBreeze`` (DistributedVector.scala:65): whole on every rank
        by contract. Collective over the mesh."""
        return to_host(self.to_tensor())

    to_breeze = to_numpy

    def _like(self, local, column_major=None) -> "DistributedVector":
        return type(self)(
            local, mesh=self.mesh,
            column_major=(self.column_major if column_major is None
                          else column_major),
            dtype=self._dtype if local is None else None,
            _logical_len=self._len)

    # -- ops ----------------------------------------------------------------
    def substract(self, other: "DistributedVector") -> "DistributedVector":
        """Elementwise difference; the reference's name, typo and all
        (DistributedVector.scala:45)."""
        return self.subtract(other)

    def _other_local(self, other: "DistributedVector") -> torch.Tensor:
        self._check_len(other)
        if other.mesh is self.mesh:
            return other._local.to(self._dtype)
        return other._local_in(vector_sharding(self.mesh),
                               self.mesh.size).to(self._dtype)

    def subtract(self, other: "DistributedVector") -> "DistributedVector":
        return self._like(self._local - self._other_local(other))

    def add(self, other: "DistributedVector") -> "DistributedVector":
        return self._like(self._local + self._other_local(other))

    def multiply(self, scalar: Union[int, float]) -> "DistributedVector":
        return self._like(self._local * scalar)

    def transpose(self) -> "DistributedVector":
        """Orientation flip (DistributedVector.scala:56): no data moves."""
        return self._like(self._local, column_major=not self.column_major)

    def to_dis_vector(self, new_chunk: int) -> "DistributedVector":
        """Re-chunk (``toDisVector``, DistributedVector.scala:83): the
        mesh fixes the chunks, so the value is unchanged; the chunk plan is
        ``utils.split.reblock_plan``."""
        return self._like(self._local)

    def multiply_vector(self, other: "DistributedVector",
                        mode: str = "dist"):
        """Orientation-dispatched product (DistributedVector.scala:147-181):
        column x row -> outer product, a BlockMatrix ("dist") or a local
        ndarray ("local", whole by contract); row x column -> inner
        product. Collective over the mesh."""
        if self.column_major and not other.column_major:
            if mode == "local":
                return to_host(torch.outer(self.to_tensor(),
                                           other.to_tensor().to(self._dtype)))
            return self._outer_blocks(other)
        if not self.column_major and other.column_major:
            return self.dot(other)
        raise ValueError(
            "vector multiply needs opposite orientations "
            f"(self.column_major={self.column_major}, "
            f"other={other.column_major})")

    def _outer_blocks(self, other: "DistributedVector"):
        """The outer product as a BlockMatrix on this mesh, shard to
        shard: each rank takes the window of this vector its block's rows
        need (a chunk over the "mr" axis) and the window of ``other`` its
        columns need (over "mc"), and multiplies the two; no rank holds a
        whole vector or the product."""
        from .block import BlockMatrix

        cfg = get_config()
        mesh = self.mesh
        pr, pc = mesh.shape[cfg.mesh_axis_rows], mesh.shape[cfg.mesh_axis_cols]
        rows = self._local_in(_layout(mesh, {cfg.mesh_axis_rows: 0}), pr)
        cols = other._local_in(_layout(mesh, {cfg.mesh_axis_cols: 0}), pc)
        local = None if rows is None else torch.outer(
            rows, cols.to(self._dtype))
        return BlockMatrix(local, mesh=mesh, dtype=self._dtype,
                           _logical_shape=(self._len, other._len))

    def dot(self, other: "DistributedVector") -> float:
        """Inner product: a local dot per chunk in >= f32 (pads are zero on
        both sides), then an all-reduce. Collective over the mesh."""
        acc = torch.promote_types(self._dtype, torch.float32)
        with matmul_precision_scope():
            part = torch.dot(self._local.to(acc),
                             self._other_local(other).to(acc))
        return float(all_reduce_sum(part.reshape(1), self.mesh))

    def _check_len(self, other: "DistributedVector") -> None:
        if self.length != other.length:
            raise ValueError(
                f"length mismatch: {self.length} vs {other.length}")

    @classmethod
    def from_vector(cls, vec, num_splits: Optional[int] = None, mesh=None):
        """``fromVector`` (DistributedVector.scala:186); ``num_splits`` is
        accepted for API parity, the mesh fixes the chunks."""
        return cls(np.asarray(vec), mesh=mesh)

    def __repr__(self) -> str:
        orient = "col" if self.column_major else "row"
        return (f"{type(self).__name__}(length={self.length}, {orient}, "
                f"dtype={self.dtype})")


class DistributedIntVector(DistributedVector):
    """Integer-element distributed vector (DistributedIntVector.scala:17),
    int32 unless told otherwise."""

    def __init__(self, data, mesh=None, column_major: bool = True,
                 dtype=None, _logical_len=None):
        super().__init__(data, mesh=mesh, column_major=column_major,
                         dtype=dtype or (torch.int32 if _logical_len is None
                                         else None),
                         _logical_len=_logical_len)
