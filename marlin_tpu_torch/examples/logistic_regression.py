"""LogisticRegression: full-batch logistic regression by gradient descent,
the port's counterpart of ``marlin_tpu/examples/logistic_regression.py``.

As ``examples/LogisticRegression.scala`` (:21-28): the forward pass is a
distributed mat-vec plus the sigmoid and the gradient a transposed one,
data and parameters co-located; here the whole optimization runs through
``DenseVecMatrix.lr``, each rank's gradient over its own rows summed by
one all-reduce a step, on the card or, with ``--device cpu``, the CPU.

Input rows are ``(label, features)``; with --synthetic a separable dataset
is generated. Loading a file waits for the text I/O (ROADMAP Queue A6).

Usage:
  python -m marlin_tpu_torch.examples.logistic_regression \\
      --synthetic 10000 50 [--iters 100] [--step-size 1.0] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..matrix.dense import DenseVecMatrix
from ..mesh import create_mesh


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", nargs="?",
                   help="row:csv file of (label, features)")
    p.add_argument("--synthetic", nargs=2, type=int,
                   metavar=("ROWS", "FEATS"))
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--step-size", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.input:
        raise NotImplementedError(
            "text I/O (the input file) is not ported yet: ROADMAP.md "
            "Queue A, item A6")
    if not args.synthetic:
        p.error("give an input file or --synthetic ROWS FEATS")
    m, d = args.synthetic
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, d))
    w_true = rng.standard_normal(d)
    labels = (x @ w_true > 0).astype(float)
    mesh = create_mesh(device=args.device)
    data = DenseVecMatrix(np.hstack([labels[:, None], x]), mesh=mesh)

    t0 = time.perf_counter()
    weights = data.lr(step_size=args.step_size, iters=args.iters)
    dt = time.perf_counter() - t0

    z = weights[0] + x @ weights[1:]
    print(json.dumps({
        "example": "LogisticRegression",
        "shape": [data.num_rows, data.num_cols],
        "iters": args.iters,
        "seconds": round(dt, 6),
        "weights_head": [round(float(w), 6) for w in weights[:5]],
        "train_accuracy": float(((z > 0).astype(float) == labels).mean()),
        "device": str(mesh.device),
    }))
    return weights


if __name__ == "__main__":
    main()
