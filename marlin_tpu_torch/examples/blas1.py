"""BLAS1: the distributed dot product, the port's counterpart of
``marlin_tpu/examples/blas1.py``: two random distributed vectors, inner
product in "dist" vs "local" mode (BLAS1.scala:33), on the card or, with
``--device cpu``, the CPU.

Usage: python -m marlin_tpu_torch.examples.blas1 1000000
           [--mode dist|local] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..mesh import create_mesh
from ..utils import random as mrand
from ..utils.timing import fence


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("length", type=int)
    p.add_argument("--mode", default="dist", choices=["dist", "local"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    mesh = create_mesh(device=args.device)
    x = mrand.random_dist_vector(args.length, seed=1, mesh=mesh)
    y = mrand.random_dist_vector(args.length, seed=2, mesh=mesh)
    fence(x, y)

    t0 = time.perf_counter()
    if args.mode == "dist":
        # Row vector x column vector -> the on-device inner product.
        value = x.transpose().multiply_vector(y)
    else:
        value = float(np.dot(x.to_numpy(), y.to_numpy()))
    dt = time.perf_counter() - t0
    print(json.dumps({"example": "BLAS1", "mode": args.mode, "dot": value,
                      "seconds": round(dt, 6)}))
    return value


if __name__ == "__main__":
    main()
