"""The port's kernels: hand-written Hopper kernels with their plain
PyTorch versions beside them, one module per kernel family
(``ops.flash_attention``, ``ops.block_sparse``), built and loaded by
``ops.build``.

``ops.flash_attention`` stays the module here (the JAX package's
``ops/__init__`` rebinds that name to the function): the port's callers
import the module and read its launch counters."""

from .block_sparse import BlockSparse, block_sparse_matmul

__all__ = ["BlockSparse", "block_sparse_matmul"]
