"""The port's matrix types: the dense distributed types (row-striped
``DenseVecMatrix``, 2-D ``BlockMatrix``, chunked vectors) on a mesh, and
the sparse types, whose data lives on one device (``matrix.sparse``).
The host-side local types of ``marlin_tpu/matrix/local.py`` are ROADMAP
Queue A4b."""

from .base import DistributedMatrix
from .block import BlockMatrix
from .dense import DenseVecMatrix
from .sparse import CoordinateMatrix, MatrixEntry, SparseVecMatrix
from .vector import DistributedIntVector, DistributedVector

__all__ = ["DistributedMatrix", "BlockMatrix", "DenseVecMatrix",
           "CoordinateMatrix", "MatrixEntry", "SparseVecMatrix",
           "DistributedVector", "DistributedIntVector"]
