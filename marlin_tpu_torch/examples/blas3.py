"""BLAS3: GEMM three ways, the port's counterpart of
``marlin_tpu/examples/blas3.py``: the same product computed (1) locally
(BLAS3.scala:30-35), (2) with the small operand broadcast (:36-45), (3)
with an explicit (m, k, n) split grid or SUMMA (:46-56), each timed, on
the card or, with ``--device cpu``, the CPU.

Usage: python -m marlin_tpu_torch.examples.blas3 2048 2048 2048
           [--grid 2 2 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from ..mesh import create_mesh
from ..utils import random as mrand
from ..utils.timing import fence


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("n", type=int)
    p.add_argument("--grid", nargs=3, type=int, default=None,
                   help="(m,k,n) split")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    mesh = create_mesh(device=args.device)
    a = mrand.random_den_vec_matrix(args.m, args.k, seed=1, mesh=mesh)
    b = mrand.random_den_vec_matrix(args.k, args.n, seed=2, mesh=mesh)
    fence(a, b)
    timings = {}

    # Mode 1: local (the reference multiplies with Breeze on one host).
    an, bn = a.logical, b.logical
    t0 = time.perf_counter()
    fence((an @ bn))
    timings["local"] = time.perf_counter() - t0

    # Mode 2: broadcast the right operand.
    c = a.multiply(b, mode="broadcast")
    fence(c)
    t0 = time.perf_counter()
    c = a.multiply(b, mode="broadcast")
    fence(c)
    timings["broadcast"] = time.perf_counter() - t0

    # Mode 3: explicit (m, k, n) split.
    mode = tuple(args.grid) if args.grid else "summa"
    c = a.multiply(b, mode=mode)
    fence(c)
    t0 = time.perf_counter()
    c = a.multiply(b, mode=mode)
    fence(c)
    timings["split"] = time.perf_counter() - t0

    print(json.dumps({"example": "BLAS3", "shape": [args.m, args.k, args.n],
                      "seconds": {k: round(v, 6)
                                  for k, v in timings.items()}}))
    return timings


if __name__ == "__main__":
    main()
