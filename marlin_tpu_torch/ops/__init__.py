"""The port's kernels: hand-written Hopper kernels with their plain
PyTorch versions beside them, one module per kernel
(``ops.flash_attention``), built and loaded by ``ops.build``."""
