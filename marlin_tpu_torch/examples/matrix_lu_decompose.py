"""MatrixLUDecompose: factor a matrix, the port's counterpart of
``marlin_tpu/examples/matrix_lu_decompose.py``.

The reference loads a text matrix, runs ``luDecompose()`` and saves the
packed result with its pivots (examples/MatrixLUDecompose.scala:40-49).
Loading and saving text wait for the text I/O (ROADMAP Queue A6); with
``--random N`` the example factors a seeded N x N normal matrix instead,
on a mesh over every rank of the process group (one rank, on a HashStore
group, when the script runs alone) on the card, or on the CPU with
``--device cpu``.

Usage: python -m marlin_tpu_torch.examples.matrix_lu_decompose \\
         [in.txt out_dir | --random N] [--mode auto|breeze|dist] \\
         [--dtype float32] [--device cuda|cpu] [--check]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..linalg import unpack_lu
from ..mesh import create_mesh
from ..utils import random as mrand
from ..utils.timing import fence


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", nargs="?")
    p.add_argument("output", nargs="?")
    p.add_argument("--random", type=int, metavar="N",
                   help="factor a seeded N x N normal matrix")
    p.add_argument("--mode", default="auto")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda")
    p.add_argument("--check", action="store_true",
                   help="reconstruct A[perm] = L U on the host")
    args = p.parse_args(argv)

    if args.input or args.output:
        raise NotImplementedError(
            "text I/O (the input matrix and the output directory) is not "
            "ported yet: ROADMAP.md Queue A, item A6")
    if not args.random:
        p.error("give `in.txt out_dir` or --random N")
    n = args.random
    mesh = create_mesh(device=args.device)
    mat = mrand.random_den_vec_matrix(n, n, "normal", seed=1, mesh=mesh,
                                      dtype=getattr(torch, args.dtype))
    fence(mat)
    t0 = time.perf_counter()
    lu, perm = mat.lu_decompose(mode=args.mode)
    fence(lu)
    dt = time.perf_counter() - t0

    out = {"example": "MatrixLUDecompose", "shape": [n, n],
           "mode": args.mode, "seconds": round(dt, 6), "output": None,
           "device": str(mesh.device)}
    if args.check:
        l, u = unpack_lu(lu.to_numpy().astype(np.float64))
        a = mat.to_numpy().astype(np.float64)
        out["reconstruction_max_err"] = float(
            np.max(np.abs(a[perm] - l @ u)) / np.max(np.abs(a)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
