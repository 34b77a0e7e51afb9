"""QR decomposition and least squares: port of ``marlin_tpu/linalg/qr.py``.

Beyond the reference's L4 inventory (Marlin stops at LU/Cholesky/inverse/
SVD, DenseVecMatrix.scala:283-1648) but the natural completion of it: the
reference's tall row-distributed matrices (the ``DenseVecMatrix`` shape,
:41-44) are the regime where users want Q-less QR and least squares, and
its own ``lr`` example solves a regression by gradient descent for lack of
one (:1005).

CholeskyQR2 instead of Householder panels, on A's row stripes:

* ``G = A^T A`` is each rank's local A_s^T A_s summed by one
  ``all_reduce_sum`` (the SVD's ``computeGramianMatrix`` pattern,
  :1464-1484: no row leaves its rank);
* ``R = chol(G)^T`` is a local n x n Cholesky (n is the skinny dimension);
* ``Q = A R^-1`` is a triangular solve on each rank's own rows:
  row-striped in, row-striped out.

One pass loses orthogonality as cond(A)^2 * eps; repeating it on Q
(CholeskyQR2) brings ||Q^T Q - I|| back to machine precision for any
cond(A) <= 1/sqrt(eps). Square or fat inputs take ``torch.linalg.qr``
under the same precision scope, and a Cholesky that fails (cond(A) beyond
~1/sqrt(eps) makes the Gramian numerically indefinite) takes the same
route at run time: one host sync, on the failure path only.

``lstsq`` solves min ||A x - b|| through the same factorization without
forming Q: R^T R x = A^T b (the seminormal equations), refined once by
iterative refinement to recover the accuracy QR-based solvers have over
plain normal equations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import linalg_precision_scope
from ..mesh import Mesh, all_reduce_sum
from .lu import _resolve_mode


def _gram(a: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A^T A of row-striped A (``a``: this rank's rows; ``mesh`` None: all
    of them), summed over the mesh's ranks."""
    g = torch.matmul(a.mT, a)
    return g if mesh is None else all_reduce_sum(g, mesh)


def _chol_r(g: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(upper-triangular R with R^T R = G, whether the Cholesky
    succeeded)."""
    l, info = torch.linalg.cholesky_ex(g)
    return l.mT, bool(info == 0) and bool(torch.isfinite(l).all())


def _solve_r(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A R^-1 row by row (right triangular solve against upper R)."""
    return torch.linalg.solve_triangular(r, a, upper=True, left=False)


def _use_cqr(mode: str, m: int, n: int) -> bool:
    """Route to CholeskyQR2? Validates the mode set and the tall-shape
    precondition in one place for qr_factor_array and lstsq."""
    if mode not in ("auto", "tsqr", "local"):
        raise ValueError(f"Do not support mode {mode}.")
    use = mode == "tsqr" or (
        mode == "auto" and m > n and _resolve_mode("auto", m) == "dist")
    if use and m < n:
        raise ValueError(f"tsqr needs m >= n, got ({m}, {n})")
    return use


def _stripes(a):
    """(this rank's rows, mesh or None, wrap) of a tensor or a
    DistributedMatrix: ``wrap`` turns this rank's rows of a result with
    A's row layout back into the caller's type."""
    if isinstance(a, torch.Tensor):
        return a, None, lambda local, cols: local
    from ..matrix.dense import DenseVecMatrix

    rows = a if isinstance(a, DenseVecMatrix) else a._as(DenseVecMatrix)
    rows._require_local()

    def wrap(local, cols):
        out = DenseVecMatrix(local, mesh=rows.mesh,
                             _logical_shape=(rows.num_rows, cols))
        return out if isinstance(a, DenseVecMatrix) else out._as(type(a))

    return rows.local, rows.mesh, wrap


def qr_factor_array(a, mode: str = "auto"):
    """QR-factor an (m, n) matrix: (Q (m, n), R (n, n) upper) with A = Q R
    and Q^T Q = I (thin form). Q comes back as ``a``'s type (a tensor, or
    a distributed matrix on the same mesh, collective over it), R as a
    tensor every rank holds.

    ``mode``: "auto" takes CholeskyQR2 for tall matrices (m > n, in the
    distributed regime) and ``torch.linalg.qr`` for the rest; "tsqr" forces
    CholeskyQR2 (m >= n and numerically full column rank); "local" forces
    ``torch.linalg.qr``.
    """
    m, n = a.shape
    use_cqr = _use_cqr(mode, m, n)
    with linalg_precision_scope():
        if use_cqr:
            local, mesh, wrap = _stripes(a)
            # Pass 1: Q1 = A R1^-1.
            r1, ok = _chol_r(_gram(local, mesh))
            if ok:
                q1 = _solve_r(local, r1)
                # Pass 2 (CholeskyQR2): re-orthogonalize; R composes.
                r2, _ = _chol_r(_gram(q1, mesh))
                return wrap(_solve_r(q1, r2), n), torch.matmul(r2, r1)
        # The Gramian numerically indefinite (cond(A) ~> 1/sqrt(eps) at
        # this dtype) takes Householder QR as well.
        whole = a if isinstance(a, torch.Tensor) else a.logical
        q, r = torch.linalg.qr(whole, mode="reduced")
    if isinstance(a, torch.Tensor):
        return q, r
    return a._from_logical(q), r


def qr_decompose(mat, mode: str = "auto"):
    """(Q as the caller's distributed type, R as a tensor every rank
    holds): row-sharded in, row-sharded out. Collective over the mesh."""
    return qr_factor_array(mat, mode=mode)


def lstsq(a, b, mode: str = "auto") -> torch.Tensor:
    """min ||A x - b||_2 for tall full-column-rank A (a tensor or a
    distributed matrix, then collective over its mesh); ``b`` (m,) or
    (m, k), held by every rank; x comes back on every rank.

    Seminormal equations through the CholeskyQR R (R^T R x = A^T b) plus
    one step of iterative refinement: GEMMs and solves only (no Q), the
    refinement recovering the forward accuracy plain normal equations lose
    at cond(A)^2. Non-tall inputs take ``torch.linalg.lstsq``.
    """
    m, n = a.shape
    b = torch.as_tensor(b)
    vec = b.dim() == 1
    bm = b[:, None] if vec else b
    if bm.shape[0] != m:
        raise ValueError(f"rhs rows {bm.shape[0]} != lhs rows {m}")
    use_cqr = _use_cqr(mode, m, n)
    with linalg_precision_scope():
        if use_cqr:
            local, mesh, _ = _stripes(a)
            r, ok = _chol_r(_gram(local, mesh))
            if ok:
                x = _seminormal(local, mesh, bm, r)
                return x[:, 0] if vec else x
        # The same run-time route as qr_factor_array's.
        whole = a if isinstance(a, torch.Tensor) else a.logical
        x = torch.linalg.lstsq(whole, bm.to(whole)).solution
    return x[:, 0] if vec else x


def _seminormal(local, mesh, bm, r):
    """R^T R x = A^T b and one refinement step, on A's row stripes
    (``local``; b's rows of this rank are cut from ``bm``)."""
    if mesh is None:
        rows = bm.to(local)
    else:
        from ..mesh import local_slices, row_sharding

        h = local.shape[0]
        start = local_slices(row_sharding(mesh), (h * mesh.size, 1))[0].start
        rows = torch.zeros((h, bm.shape[1]), dtype=local.dtype,
                           device=local.device)
        part = bm[start:start + h]
        rows[:part.shape[0]] = part.to(rows)

    def solve_semi(rhs):  # R^T R x = rhs
        y = torch.linalg.solve_triangular(r.mT, rhs, upper=False)
        return torch.linalg.solve_triangular(r, y, upper=True)

    def at(v):  # A^T v, summed over the ranks
        out = torch.matmul(local.mT, v)
        return out if mesh is None else all_reduce_sum(out, mesh)

    x = solve_semi(at(rows))
    # One refinement step: x += (R^T R)^-1 A^T (b - A x).
    return x + solve_semi(at(rows - torch.matmul(local, x)))
