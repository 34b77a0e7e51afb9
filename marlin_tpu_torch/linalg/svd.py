"""Top-k singular value decomposition via the Gramian: port of
``marlin_tpu/linalg/svd.py``.

Counterpart of ``DenseVecMatrix.computeSVD`` (DenseVecMatrix.scala:
1531-1648): returns (U DenseVecMatrix | None, s vector, V local matrix).
Modes mirror the reference (:1569-1605):

* ``local-svd``  : form G = A^T A (one local product per row stripe,
                   summed over the mesh, in place of the per-row dspr tree
                   aggregation, :1480-1484), full dense eig of G on the
                   host.
* ``local-eigs`` : Lanczos on the host-resident G's matvec.
* ``dist-eigs``  : Lanczos where each step's matvec is the distributed
                   Gramian product ``multiplyGramianMatrixBy`` (:1444-1459),
                   the recurrence on the device (the operator of
                   ``gramian_matvec_operator``).
* ``auto``       : n < 100 or k > n/2 -> local-svd; else local-eigs up to
                   ``svd_local_eigs_max`` columns, dist-eigs above
                   (:1569-1588).

Sigma cutoff: singular values below ``rCond * sigma(0)`` are dropped
(:1607-1630). U (if requested) is A (V Sigma^-1) through the broadcast GEMM
path (:1633-1648).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import get_config
from .lanczos import symmetric_eigs


class SVDResult(NamedTuple):
    """SingularValueDecomposition(U, s, V): U = None if compute_u=False."""

    u: Optional[object]  # DenseVecMatrix
    s: np.ndarray
    v: np.ndarray


def compute_svd(
    mat,
    k: int,
    compute_u: bool = True,
    r_cond: float = 1e-9,
    max_iter: int = 300,
    tol: float = 1e-10,
    mode: str = "auto",
) -> SVDResult:
    """Top-k SVD of ``mat`` (a DenseVecMatrix, or anything with its
    Gramian interface). Collective over the matrix's mesh."""
    n = mat.num_cols
    if not (0 < k <= n):
        raise ValueError(
            f"Request up to n singular values, got k={k}, n={n}.")

    if mode == "auto":
        # The local/dist boundary is the config's policy constant
        # (svd_local_eigs_max, the reference's 15000 by default).
        if n < 100 or k > n / 2:
            mode = "local-svd"
        elif n <= get_config().svd_local_eigs_max:
            mode = "local-eigs"
        else:
            mode = "dist-eigs"

    if mode == "local-svd":
        g = mat.compute_gramian_matrix()
        evals, evecs = np.linalg.eigh(np.asarray(g, np.float64))
        order = np.argsort(evals)[::-1][:k]
        lam, v = evals[order], evecs[:, order]
    elif mode == "local-eigs":
        g = np.asarray(mat.compute_gramian_matrix(), np.float64)
        lam, v = symmetric_eigs(lambda x: g @ x, n, k, tol=tol,
                                max_iter=max_iter)
    elif mode == "dist-eigs":
        # The device sweep when the matrix exposes an operator on its
        # device tensors (chunks of steps, not one host round trip a step).
        op = (mat.gramian_matvec_operator()
              if hasattr(mat, "gramian_matvec_operator") else None)
        lam, v = symmetric_eigs(mat.multiply_gramian_matrix_by, n, k,
                                tol=tol, max_iter=max_iter,
                                matvec_device=op)
    else:
        raise ValueError(f"Do not support mode {mode}.")

    # sigma = sqrt(eig); rCond rank cutoff (DenseVecMatrix.scala:1607-1630).
    lam = np.maximum(lam, 0.0)
    sigmas = np.sqrt(lam)
    if sigmas.size == 0 or sigmas[0] == 0.0:
        raise RuntimeError("Singular values are all zero.")
    threshold = r_cond * sigmas[0]
    rank = int(np.sum(sigmas > threshold))
    if rank == 0:
        raise RuntimeError(
            f"No singular values above rCond*sigma0={threshold}.")
    s = sigmas[:rank]
    v = v[:, :rank]

    u = None
    if compute_u:
        # N = V Sigma^-1 ; U = A N: the broadcast GEMM arm (:1633-1648) at
        # linalg_precision: a relaxed global matmul_precision must not hand
        # back reduced-precision left singular vectors next to
        # full-precision sigmas.
        nmat = torch.from_numpy(np.ascontiguousarray(v / s[None, :]))
        u = mat._multiply_broadcast(
            nmat, precision=get_config().linalg_precision)
    return SVDResult(u, s, v)
