"""Least squares: distributed thin QR and the seminormal solve, the port's
counterpart of ``marlin_tpu/examples/least_squares.py``.

No reference counterpart as a solver: the reference's LogisticRegression
example fits a regression by full-batch gradient descent
(examples/LogisticRegression.scala; DenseVecMatrix.scala:1005) because its
L4 set has no factorization-based solver. This CLI closes that loop: a
random tall row-striped system, solved in one shot through
``linalg.lstsq`` (CholeskyQR seminormal equations and one refinement
step, linalg/qr.py), with the fit quality and the QR orthogonality
reported; on the card, or on the CPU with ``--device cpu``.

Usage: python -m marlin_tpu_torch.examples.least_squares 100000 64 \\
         [--rhs 1] [--mode auto|tsqr|local] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..linalg import lstsq, qr_factor_array
from ..mesh import create_mesh
from ..utils import random as mrand
from ..utils.timing import fence


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("--rhs", type=int, default=1)
    p.add_argument("--mode", default="auto",
                   choices=["auto", "tsqr", "local"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    mesh = create_mesh(device=args.device)
    a = mrand.random_den_vec_matrix(args.rows, args.cols, seed=1, mesh=mesh)
    rng = np.random.default_rng(2)
    x_true = rng.standard_normal((args.cols, args.rhs))
    b = (a.multiply(x_true.astype(np.float32)).to_numpy()
         + 0.01 * rng.standard_normal((args.rows, args.rhs)))

    t0 = time.perf_counter()
    x = lstsq(a, b, mode=args.mode)
    fence(x)
    dt = time.perf_counter() - t0
    x = x.cpu().numpy()

    q, _ = qr_factor_array(a, mode=args.mode)
    qn = q.to_numpy().astype(np.float64)
    orth = float(np.max(np.abs(qn.T @ qn - np.eye(args.cols))))
    coef_err = float(np.max(np.abs(x.reshape(x_true.shape) - x_true)))
    out = {"example": "LeastSquares", "mode": args.mode,
           "rows": args.rows, "cols": args.cols,
           "seconds": round(dt, 6), "coef_max_err": round(coef_err, 6),
           "qr_orth_err": orth, "device": str(mesh.device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
