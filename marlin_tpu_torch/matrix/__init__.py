"""The port's matrix types: the sparse types on one device
(``matrix.sparse``); the dense and distributed types are still to be
ported (ROADMAP.md, Queue A)."""

from .sparse import CoordinateMatrix, MatrixEntry, SparseVecMatrix

__all__ = ["CoordinateMatrix", "MatrixEntry", "SparseVecMatrix"]
