"""RMMcompare: replication-based multiply strategies compared, the port's
counterpart of ``marlin_tpu/examples/rmm_compare.py``.

``examples/RMMcompare.scala`` benchmarks the live RMM-opt ``multiply``
arm (:39-58). Here the comparison is between the strategies that replaced
RMM: the 3-D replication grid (``summa.matmul_3d``, a reduce-scatter over
the k axis: the direct RMM analogue), the all-gather SUMMA and, on a
square mesh, the Cannon ring (``summa.matmul``), on a mesh over every rank
of the process group (one rank, on a HashStore group, when the script runs
alone) on the card, or on the CPU with ``--device cpu``. The operands
reach each engine shard to shard.

Usage: python -m marlin_tpu_torch.examples.rmm_compare 2048 2048 2048
           [--grid 2 2 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from ..mesh import axis_sizes, create_mesh
from ..parallel import summa
from ..utils import random as mrand
from ..utils.split import grid_for_devices
from ..utils.timing import fence


def _time(fn, iters=3):
    out = fn()
    fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
        fence(out)
    return (time.perf_counter() - t0) / iters


def arms(a, b, mesh, grid):
    """The compared strategies: {name: a function computing A @ B (the
    logical C on every rank of the mesh)}; Cannon's ring only where the
    mesh is square."""
    out = {"rmm_3d_grid": lambda: summa.matmul_3d(a, b, grid, mesh=mesh),
           "summa_allgather": lambda: summa.matmul(a, b, mesh=mesh,
                                                   engine="summa")}
    pr, pc = axis_sizes(mesh)
    if pr == pc:
        out["cannon_ring"] = lambda: summa.matmul(a, b, mesh=mesh,
                                                  engine="cannon")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("n", type=int)
    p.add_argument("--grid", nargs=3, type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    mesh = create_mesh(device=args.device)
    a = mrand.random_den_vec_matrix(args.m, args.k, seed=1, mesh=mesh)
    b = mrand.random_den_vec_matrix(args.k, args.n, seed=2, mesh=mesh)
    grid = tuple(args.grid) if args.grid else grid_for_devices(
        args.m, args.k, args.n, mesh.size)

    timings = {name: _time(fn)
               for name, fn in arms(a, b, mesh, grid).items()}
    print(json.dumps({"example": "RMMcompare",
                      "shape": [args.m, args.k, args.n], "grid": list(grid),
                      "seconds": {k: round(v, 6)
                                  for k, v in timings.items()}}))
    return timings


if __name__ == "__main__":
    main()
