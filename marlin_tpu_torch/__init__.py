"""marlin_tpu_torch — the PyTorch and CUDA port of marlin_tpu for an NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``marlin_tpu`` stays beside this one as the reference;
this package imports neither it nor JAX. Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.

Ported so far: the flagship transformer's inference path
(:mod:`.models`) served by the continuous-batching engine in its default
discipline (:mod:`.serving`), with the flash-attention forward as a CUDA
kernel (:mod:`.ops`). ROADMAP.md lists what remains.
"""
