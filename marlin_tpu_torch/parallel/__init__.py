"""Distributed GEMM engines and placement helpers (port of
``marlin_tpu/parallel``: ``summa`` and ``layout``; the ring, Ulysses,
pipeline and expert modules are ROADMAP Queue A3)."""

from . import layout, summa
from .summa import matmul, matmul_3d

__all__ = ["layout", "summa", "matmul", "matmul_3d"]
