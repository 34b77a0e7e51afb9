"""Blocked Cholesky decomposition: port of ``marlin_tpu/linalg/cholesky.py``.

Counterpart of ``DenseVecMatrix.choleskyDecompose`` (DenseVecMatrix.scala:
475-561): returns the lower-triangular L (A = L L^T) as a BlockMatrix. No
pivoting (SPD input assumed, as in the reference).

The "dist" mode runs sharded over the matrix's mesh on the row stripes of
:mod:`.lu`, right-looking per panel of ``base`` columns:

* the base x base diagonal block is gathered to one rank, factored there
  (``torch.linalg.cholesky_ex``, cuSOLVER's potrf on the card) and
  broadcast;
* L21 = A21 L11^-T by each rank's triangular solve on its own rows;
* the n x base L21 panel is all-gathered (the only whole-height piece any
  rank holds);
* each rank updates its own rows of the Schur complement A22 -= L21 L21^T,
  one GEMM per panel-high block of its rows, up to that block's diagonal:
  the lower triangle only, near the minimal n^3 / 3.

The JAX package's recursive halving with flat leaves (a TPU compile trade)
does not carry over: the results are the same, the structure is not.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import get_config, linalg_precision_scope
from .lu import (_Stripes, _assemble, _check_square, _from_root,
                 _pad_identity, _resolve_mode, _stripes_of, _to_block_matrix)


def _chol(a: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of the SPD ``a`` (its lower triangle is
    read)."""
    return torch.linalg.cholesky_ex(a)[0]


def _cholesky_stripes(st: _Stripes, base: int) -> None:
    """Blocked right-looking Cholesky of the striped SPD ``st`` in place:
    its lower triangle becomes L, its upper triangle 0. Collective over the
    mesh."""
    n = st.n
    for j0 in range(0, n, base):
        j1 = min(j0 + base, n)
        b = j1 - j0
        a11 = _assemble(st, j0, j1, slice(j0, j1), to_root=True)
        l11 = _chol(a11) if st.is_root else None
        l11 = _from_root(st, l11, (b, b), st.local.dtype)
        a, e = st.own(j0, j1)
        if e > a:
            st.local[a:e, j0:j1] = l11[st.r0 + a - j0:st.r0 + e - j0]
        if j1 == n:
            break
        # --- L21 = A21 L11^-T on this rank's trailing rows.
        a, e = st.own(j1, n)
        if e > a:
            st.local[a:e, j0:j1] = torch.linalg.solve_triangular(
                l11.mT, st.local[a:e, j0:j1], upper=True, left=False)
        l21 = _assemble(st, j1, n, slice(j0, j1))
        # --- A22 -= L21 L21^T on this rank's rows, block row by block row,
        # each up to its diagonal block's last column.
        for c in range(j1, n, base):
            ca, ce = st.own(c, min(c + base, n))
            if ce <= ca:
                continue
            last = min(c + base, n)
            st.local[ca:ce, j1:last] -= torch.matmul(
                st.local[ca:ce, j0:j1], l21[:last - j1].mT)
    st.local.tril_(diagonal=st.r0)


def cholesky_factor_array(a, mode: str = "auto",
                          base_size: Optional[int] = None):
    """The lower Cholesky factor L (A = L L^T) of a square SPD matrix: a
    tensor for a tensor, a BlockMatrix on its mesh for a DistributedMatrix
    (in "dist" mode no rank holds the whole matrix, and the call is
    collective over the mesh). "local" factors the whole matrix in one
    ``torch.linalg.cholesky_ex`` call."""
    n = _check_square(a, "Cholesky decompose")
    base = base_size or get_config().cholesky_base_size
    if _resolve_mode(mode, n) == "local" or base >= n:
        whole = a if isinstance(a, torch.Tensor) else a.logical
        with linalg_precision_scope():
            l = _chol(whole)
        if isinstance(a, torch.Tensor):
            return l
        from ..matrix.block import BlockMatrix

        return BlockMatrix(l, mesh=a.mesh)
    st = _cholesky_factor_dist(a, base)
    if st.mesh is None:
        return st.local[:n, :n].contiguous()
    return _to_block_matrix(st, (n, n))


def _cholesky_factor_dist(a, base: int) -> _Stripes:
    """Stripes of the padded L of a tensor or a DistributedMatrix, in
    "dist" mode."""
    n = a.shape[0]
    npad = -(-n // base) * base
    if isinstance(a, torch.Tensor):
        st = _Stripes(_pad_identity(a, npad), npad, 0, None)
    else:
        st = _stripes_of(a, npad)
    with linalg_precision_scope():
        _cholesky_stripes(st, base)
    return st


def cholesky_decompose(mat, mode: str = "auto"):
    """Lower-triangular BlockMatrix with A = L L^T
    (DenseVecMatrix.scala:475). Collective over the mesh."""
    return cholesky_factor_array(mat, mode=mode)
