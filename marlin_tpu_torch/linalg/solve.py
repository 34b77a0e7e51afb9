"""Linear system solve via the blocked factorizations: port of
``marlin_tpu/linalg/solve.py``.

The reference stops at the factorizations (LU/Cholesky/inverse,
DenseVecMatrix.scala:283-764); users compose solves from them. ``solve``
ships the composition: square systems through the blocked LU (or the
blocked Cholesky for SPD operators) plus two blocked triangular sweeps
(:func:`.lu._tri_solve`) on the factor's row stripes: the natural
endpoint of the ``inverse`` machinery without forming A^-1, and in "dist"
mode without any rank holding A or its factor whole.
"""

from __future__ import annotations

import torch

from ..config import get_config, linalg_precision_scope
from .cholesky import _cholesky_factor_dist, cholesky_factor_array
from .lu import (_assemble, _lu_factor_dist, _resolve_mode, _rows_like,
                 _tri_solve)


def solve(a, b, mode: str = "auto", assume_spd: bool = False):
    """Solve A X = B. ``a`` is a square tensor or DistributedMatrix (then
    collective over its mesh); ``b`` a vector or a matrix of right-hand
    sides (a tensor or an ndarray every rank holds), and X comes back as a
    tensor of its shape on every rank.

    ``assume_spd``: route through the blocked Cholesky (half the FLOPs, no
    pivoting); the caller guarantees symmetry and positive definiteness.
    """
    if len(a.shape) != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"solve needs a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    b = torch.as_tensor(b)
    if b.shape[0] != n:
        raise ValueError(f"rhs rows {b.shape[0]} != system size {n}")
    vec = b.dim() == 1
    bm = b[:, None] if vec else b
    dist_mode = _resolve_mode(mode, n) == "dist"

    if assume_spd:
        base = get_config().cholesky_base_size
        if dist_mode and base < n:
            st = _cholesky_factor_dist(a, base)
            rhs = _rows_like(st, bm)
            with linalg_precision_scope():
                _tri_solve(st, rhs, base, lower=True)
                _tri_solve(st, rhs, base, lower=True, transpose=True)
            x = _assemble(rhs, 0, n, slice(None))
        else:
            l = cholesky_factor_array(a, mode=mode)
            l = l if isinstance(l, torch.Tensor) else l.logical
            with linalg_precision_scope():
                y = torch.linalg.solve_triangular(l, bm.to(l), upper=False)
                x = torch.linalg.solve_triangular(l.mT, y, upper=True)
        return x[:, 0] if vec else x

    if not dist_mode:
        whole = a if isinstance(a, torch.Tensor) else a.logical
        with linalg_precision_scope():
            x = torch.linalg.solve(whole, bm.to(whole))
        return x[:, 0] if vec else x

    base = get_config().lu_base_size
    st, perm = _lu_factor_dist(a, base)
    # A[perm] = L U  =>  X = U^-1 L^-1 B[perm]; pad rows of B are zero.
    bp = torch.zeros((st.n, bm.shape[1]), dtype=st.local.dtype,
                     device=st.local.device)
    bp[:n] = bm.to(bp)
    rhs = _rows_like(st, bp[torch.as_tensor(perm, device=bp.device)])
    with linalg_precision_scope():
        _tri_solve(st, rhs, base, lower=True, unit=True)
        _tri_solve(st, rhs, base, lower=False)
    x = _assemble(rhs, 0, n, slice(None))
    return x[:, 0] if vec else x
