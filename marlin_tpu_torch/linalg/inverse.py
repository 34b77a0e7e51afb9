"""Blocked matrix inverse: port of ``marlin_tpu/linalg/inverse.py``.

Counterpart of ``DenseVecMatrix.inverse`` / ``BlockMatrix.inverse``
(DenseVecMatrix.scala:568-764; BlockMatrix.scala:529): the reference runs
its LU panel loop and then a second backward block sweep to assemble
A^-1's blocks (:677-760). Here: the blocked LU of :mod:`.lu` on the row
stripes, then the two blocked triangular sweeps (:func:`.lu._tri_solve`)
against the row-permuted identity, each rank holding its rows of it: the
same two sweeps, no rank holding A, its factors or A^-1 whole.
"""

from __future__ import annotations

import torch

from ..config import get_config, linalg_precision_scope
from .lu import (_check_square, _lu_factor_dist, _resolve_mode,
                 _to_block_matrix, _tri_solve)


def inverse(a, mesh=None, mode: str = "auto"):
    """A^-1 of a square matrix: a tensor for a tensor, a BlockMatrix on its
    mesh for a DistributedMatrix ("dist" mode: collective over the mesh).
    ``mesh`` is accepted for the JAX package's signature; a distributed
    matrix's own mesh is the one used."""
    n = _check_square(a, "Inversion")
    if _resolve_mode(mode, n) == "local":
        whole = a if isinstance(a, torch.Tensor) else a.logical
        with linalg_precision_scope():
            inv = torch.linalg.inv(whole)
        if isinstance(a, torch.Tensor):
            return inv
        from ..matrix.block import BlockMatrix

        return BlockMatrix(inv, mesh=a.mesh)
    base = get_config().lu_base_size
    st, perm = _lu_factor_dist(a, base)
    # A[perm] = P A = L U  =>  A^-1 = U^-1 (L^-1 P), P = I[perm, :]: this
    # rank's rows of P are one-hot rows.
    rows = torch.zeros((st.h, st.n), dtype=st.local.dtype,
                       device=st.local.device)
    lo, hi = st.own(0, st.n)
    idx = torch.arange(lo, hi, device=rows.device)
    cols = torch.as_tensor(perm[st.r0 + lo:st.r0 + hi], device=rows.device)
    rows[idx, cols] = 1
    rhs = st._replace(local=rows)
    with linalg_precision_scope():
        # Forward sweep: Y = unit_lower(L)^-1 P; backward sweep: X = U^-1 Y
        # (the reference's second block sweep, DenseVecMatrix.scala:677-760).
        _tri_solve(st, rhs, base, lower=True, unit=True)
        _tri_solve(st, rhs, base, lower=False)
    if rhs.mesh is None:
        return rhs.local[:n, :n].contiguous()
    return _to_block_matrix(rhs, (n, n))
