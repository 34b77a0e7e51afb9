"""MatrixMultiply: the north-star GEMM workload, the port's counterpart of
``marlin_tpu/examples/matrix_multiply.py``.

Random A x B through the auto-strategy ``multiply(other, parallelism,
mode)`` call site (MatrixMultiply.scala:46), timed around a fence, on a
mesh over every rank of the process group (one rank, on a HashStore
group, when the script runs alone) on the card, or on the CPU with
``--device cpu``. Loading the operands from files (``--file-a``,
``--file-b``) and ``--output`` wait for the text I/O (ROADMAP Queue A6).

Usage:
  python -m marlin_tpu_torch.examples.matrix_multiply 4096 4096 4096 \\
      [--mode auto|broadcast|summa|cannon|gspmd] [--dtype float32] \\
      [--device cuda|cpu] [--check]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..mesh import create_mesh
from ..utils import random as mrand
from ..utils.timing import fence


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dims", nargs="*", type=int,
                   help="m k n for random operands")
    p.add_argument("--file-a", help="load A from row:csv text")
    p.add_argument("--file-b", help="load B from row:csv text")
    p.add_argument("--mode", default="auto",
                   help="auto|broadcast|summa|cannon|gspmd")
    p.add_argument("--parallelism", type=int, default=None,
                   help="cores analogue")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda")
    p.add_argument("--check", action="store_true",
                   help="verify against NumPy")
    p.add_argument("--output", help="save the product in row:csv format")
    args = p.parse_args(argv)

    if args.file_a or args.file_b or args.output:
        raise NotImplementedError(
            "text I/O (--file-a, --file-b, --output) is not ported yet: "
            "ROADMAP.md Queue A, item A6")
    if len(args.dims) != 3:
        p.error("give `m k n`")
    m, k, n = args.dims
    mesh = create_mesh(device=args.device)
    dtype = getattr(torch, args.dtype)
    a = mrand.random_den_vec_matrix(m, k, seed=1, mesh=mesh, dtype=dtype)
    b = mrand.random_den_vec_matrix(k, n, seed=2, mesh=mesh, dtype=dtype)
    mode = None if args.mode == "auto" else args.mode

    c = a.multiply(b, parallelism=args.parallelism, mode=mode)  # warm-up
    fence(c)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        c = a.multiply(b, parallelism=args.parallelism, mode=mode)
        fence(c)
    dt = (time.perf_counter() - t0) / args.iters

    flops = 2.0 * m * k * n
    result = {"example": "MatrixMultiply", "shape": [m, k, n],
              "mode": args.mode, "device": str(mesh.device),
              "seconds": round(dt, 6), "tflops": round(flops / dt / 1e12, 3)}
    if args.check:
        an = a.to_numpy().astype(np.float64)
        bn = b.to_numpy().astype(np.float64)
        tol = 1e-4 if dtype in (torch.float32, torch.float64) else 5e-2
        result["matches_oracle"] = bool(np.allclose(
            c.to_numpy(), an @ bn, rtol=tol, atol=tol * max(1, k) ** 0.5))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
