"""marlin_tpu_torch — the PyTorch and CUDA port of marlin_tpu for an NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``marlin_tpu`` stays beside this one as the reference;
this package imports neither it nor JAX. Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.

Ported so far: the flagship transformer, trained and served
(:mod:`.models`, the continuous-batching engine of :mod:`.serving` in its
default discipline), with the flash-attention forward and backward as
CUDA kernels; the block-sparse GEMM path on one device
(:mod:`.matrix.sparse`, :mod:`.ops.block_sparse`, :mod:`.config`) with the
two SpMM kernels (:mod:`.ops`); and the paper's dense path: the mesh
(:mod:`.mesh`, on ``torch.distributed``), the distributed matrix and
vector types (:mod:`.matrix`) and the four GEMM engines
(:mod:`.parallel.summa`). ROADMAP.md lists what remains.
"""

from .config import (MarlinConfig, config_override, enable_x64, get_config,
                     set_config)
from .matrix.base import DistributedMatrix
from .matrix.block import BlockMatrix
from .matrix.dense import DenseVecMatrix
from .matrix.sparse import CoordinateMatrix, MatrixEntry, SparseVecMatrix
from .matrix.vector import DistributedIntVector, DistributedVector
from .mesh import create_mesh, default_mesh, init_distributed, set_default_mesh

__all__ = [
    "MarlinConfig", "config_override", "enable_x64", "get_config",
    "set_config", "create_mesh", "default_mesh", "init_distributed",
    "set_default_mesh", "DistributedMatrix", "BlockMatrix", "DenseVecMatrix",
    "SparseVecMatrix", "CoordinateMatrix", "MatrixEntry",
    "DistributedVector", "DistributedIntVector",
]

