"""Distributed engines and placement helpers: port of
``marlin_tpu/parallel``. The GEMM engines (``summa``, ``ring_matmul``) run
on the ``torch.distributed`` mesh; the sequence-, expert- and
pipeline-parallel engines (``ring``, ``ulysses``, ``expert``,
``pipeline``) on the single-process shard axis of :mod:`.shards`."""

from . import expert, layout, pipeline, ring, shards, summa, ulysses
from .ring import ring_matmul, ring_self_attention
from .shards import default_shards, set_default_shards
from .summa import matmul, matmul_3d
from .ulysses import sequence_parallel_attention, ulysses_self_attention

__all__ = ["default_shards", "expert", "layout", "matmul", "matmul_3d",
           "pipeline", "ring", "ring_matmul", "ring_self_attention",
           "sequence_parallel_attention", "set_default_shards", "shards",
           "summa", "ulysses", "ulysses_self_attention"]
