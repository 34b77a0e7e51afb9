"""marlin_tpu_torch — the PyTorch and CUDA port of marlin_tpu for an NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``marlin_tpu`` stays beside this one as the reference;
this package imports neither it nor JAX. Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.

Ported so far: the flagship transformer, trained and served
(:mod:`.models`, the continuous-batching engine of :mod:`.serving` in its
default discipline), with the flash-attention forward and backward as
CUDA kernels; and the block-sparse GEMM path on one device
(:mod:`.matrix.sparse`, :mod:`.ops.block_sparse`, :mod:`.config`) with the
two SpMM kernels (:mod:`.ops`). ROADMAP.md lists what remains.
"""
