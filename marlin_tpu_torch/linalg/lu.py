"""Blocked LU decomposition with partial pivoting: port of
``marlin_tpu/linalg/lu.py``.

Counterpart of ``DenseVecMatrix.luDecompose`` (DenseVecMatrix.scala:
283-461): returns (BlockMatrix with L and U packed in one matrix, pivot
array) with ``A[perm] = L U`` (row ``i`` of the factorization came from
original row ``perm[i]``). As in the JAX package, the pivot search of each
panel spans every row below the diagonal (LAPACK getrf grade, not the
reference's pivoting local to the diagonal block), and a column that is
exactly zero below the diagonal is skipped as LAPACK's ``dgetf2`` skips
it: U[c, c] = 0 and an L column of 0, no NaN.

The "dist" mode runs sharded over the matrix's mesh, right-looking per
panel of ``base`` columns, on row stripes (each rank its rows of the
padded matrix, :class:`_Stripes`):

* the (n - j0) x base panel is gathered to one rank (a reduce of the
  ranks' disjoint rows), factored there by ``torch.linalg.lu_factor_ex``
  (cuSOLVER's getrf on the card) and broadcast with its pivots;
* the panel's row swaps are applied to every rank's rows, point to point
  (:func:`_permute_rows`: only the rows that move travel);
* U12 is solved on the base-row stripe (gathered to one rank the same way)
  and broadcast;
* each rank updates its own rows of the Schur complement, one GEMM at the
  exact trailing size.

No rank holds more than its stripe, a panel and a base-row stripe. The
JAX build's masked full-shape Schur GEMM (one compiled program for every
panel) was a TPU compile trade; here it would only triple the FLOPs.

The matrix is padded to a multiple of ``base`` with an identity tail: the
padded factorization is block diagonal, each pad column's pivot is its own
1.0, so pad rows never move into the real part and the real panels are
unaffected.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import get_config, linalg_precision_scope
from ..mesh import Mesh, local_slices, redistribute, row_sharding

# Panels whose getrf met an exact zero pivot and left a non-finite value
# (the zero-pivot skip not kept), factored again by :func:`_dgetf2`.
zero_pivot_panels = 0


def _resolve_mode(mode: str, n: int, dist_threshold: int = 6000) -> str:
    """"auto" -> dist for >6000 rows, else local (DenseVecMatrix.scala:
    289-298). "breeze" is accepted as an alias of "local" for
    reference-API parity."""
    if mode == "auto":
        return "dist" if n > dist_threshold else "local"
    if mode in ("breeze", "local"):
        return "local"
    if mode == "dist":
        return "dist"
    raise ValueError(f"Do not support mode {mode}.")


# ---------------------------------------------------------------------------
# Row stripes: the distributed operand of the blocked factorizations
# ---------------------------------------------------------------------------


class _Stripes(NamedTuple):
    """An ``n``-row operand striped by rows over ``mesh``: ``local`` is
    this rank's rows [r0, r0 + h) (rows at or past ``n`` are padding and
    stay zero). With ``mesh`` None one process holds every row (r0 = 0):
    the same algorithms, with no communication."""

    local: torch.Tensor
    n: int
    r0: int
    mesh: Optional[Mesh]

    @property
    def h(self) -> int:
        return int(self.local.shape[0])

    def own(self, lo: int, hi: int) -> Tuple[int, int]:
        """This rank's part of global rows [lo, hi), as local indices
        [a, b) (a == b when it holds none of them)."""
        top = min(self.h, self.n - self.r0)
        a = min(max(lo - self.r0, 0), max(top, 0))
        b = min(max(hi - self.r0, 0), max(top, 0))
        return a, max(a, b)

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    @property
    def root(self) -> int:
        """The global rank of stripe 0's holder: it factors the panels."""
        return int(self.mesh.devices.flat[0]) if self.mesh is not None else 0

    @property
    def is_root(self) -> bool:
        return not self.distributed or dist.get_rank() == self.root

    def holders(self) -> np.ndarray:
        """The global rank holding each stripe, by stripe index."""
        if self.mesh is None:
            return np.zeros(1, dtype=np.int64)
        return np.asarray(self.mesh.devices).ravel()


def _assemble(st: _Stripes, lo: int, hi: int, cols: slice,
              to_root: bool = False) -> torch.Tensor:
    """Rows [lo, hi) of columns ``cols`` of ``st``: each rank writes its
    own rows into a zero buffer of that size and one all-reduce (one reduce
    with ``to_root``, after which only the root's buffer is the rows) sums
    the disjoint parts. Equal-size buffers on every rank; collective over
    the mesh."""
    width = len(range(*cols.indices(st.local.shape[1])))
    buf = torch.zeros((hi - lo, width), dtype=st.local.dtype,
                      device=st.local.device)
    a, b = st.own(lo, hi)
    if b > a:
        buf[st.r0 + a - lo:st.r0 + b - lo] = st.local[a:b, cols]
    if st.distributed:
        if to_root:
            dist.reduce(buf, dst=st.root, group=st.mesh.group)
        else:
            dist.all_reduce(buf, group=st.mesh.group)
    return buf


def _from_root(st: _Stripes, x: Optional[torch.Tensor], shape,
               dtype) -> torch.Tensor:
    """``x`` (computed on the root; None elsewhere) on every rank of the
    mesh: one broadcast of a tensor of ``shape``."""
    if not st.distributed:
        return x
    if x is None:
        x = torch.empty(tuple(shape), dtype=dtype, device=st.local.device)
    x = x.contiguous()
    dist.broadcast(x, src=st.root, group=st.mesh.group)
    return x


def _permute_rows(st: _Stripes, lo: int, seg: np.ndarray) -> None:
    """Rows [lo, lo + len(seg)) of ``st`` in place: new row lo + i is old
    row lo + seg[i]. Only the rows that move travel: a rank sends the
    moving rows it holds to the ranks that hold their new places, one
    message per pair of ranks, point to point, and moves those that stay
    on it with one gather and one scatter."""
    moving = np.nonzero(seg != np.arange(len(seg)))[0]
    if moving.size == 0:
        return
    me = dist.get_rank() if st.mesh is not None else 0
    dst = lo + moving
    src = lo + seg[moving]
    holders = st.holders()
    src_rank, dst_rank = holders[src // st.h], holders[dst // st.h]

    def rows(g):  # local row indices of global rows g, on the device
        return torch.as_tensor(g - st.r0, device=st.local.device)

    # Every row this rank sends or keeps is read before any is written.
    stay = (src_rank == me) & (dst_rank == me)
    kept = st.local[rows(src[stay])] if stay.any() else None
    ops, landed = [], []
    out = (src_rank == me) & (dst_rank != me)
    for rank in np.unique(dst_rank[out]):
        sel = out & (dst_rank == rank)
        ops.append(dist.P2POp(dist.isend, st.local[rows(src[sel])],
                              int(rank), group=st.mesh.group))
    into = (dst_rank == me) & (src_rank != me)
    for rank in np.unique(src_rank[into]):
        sel = into & (src_rank == rank)
        buf = torch.empty((int(sel.sum()), st.local.shape[1]),
                          dtype=st.local.dtype, device=st.local.device)
        ops.append(dist.P2POp(dist.irecv, buf, int(rank),
                              group=st.mesh.group))
        landed.append((dst[sel], buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if kept is not None:
        st.local[rows(dst[stay])] = kept
    for where, buf in landed:
        st.local[rows(where)] = buf


def _stripes_of(mat, npad: int) -> _Stripes:
    """A DistributedMatrix's logical n x n value zero-padded to npad x npad
    with an identity tail, as row stripes of ``npad / ranks`` rows (rounded
    up) over its mesh, moved shard to shard (a copy: the matrix is not
    touched). Collective over the mesh."""
    mat._require_local()
    mesh = mat.mesh
    n = mat.num_rows
    h = -(-npad // mesh.size)
    layout = row_sharding(mesh)
    local = redistribute(mat.local, mat._sharding(), mat._physical_shape,
                         layout, (mesh.size * h, npad), mat.shape, mat.dtype)
    if local is mat.local:
        local = local.clone()
    r0 = local_slices(layout, (mesh.size * h, npad))[0].start
    for r in range(max(n, r0), min(npad, r0 + h)):
        local[r - r0, r] = 1
    return _Stripes(local, npad, r0, mesh)


def _to_block_matrix(st: _Stripes, shape):
    """The leading ``shape`` of the striped ``st`` as a BlockMatrix on its
    mesh, moved shard to shard. Collective over the mesh."""
    from ..matrix.block import BlockMatrix

    rows = st.mesh.size * st.h
    return BlockMatrix._from_shard(st.local, row_sharding(st.mesh),
                                   (rows, st.local.shape[1]), shape,
                                   st.local.dtype, mesh=st.mesh)


def _pad_identity(a: torch.Tensor, npad: int) -> torch.Tensor:
    """Embed a in the top-left of an npad x npad matrix with an identity
    tail: the padded factorization is block-diagonal, so real panels are
    unaffected and the pad block factors trivially (each pad column's
    pivot is its own 1.0 diagonal, so pad pivots stay in place). A copy
    even when no padding is needed: the factorizations work in place."""
    n = a.shape[0]
    out = torch.zeros((npad, npad), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[idx, idx] = 1
    return out


# ---------------------------------------------------------------------------
# LU
# ---------------------------------------------------------------------------


def _swaps_to_perm(piv: np.ndarray, m: int) -> np.ndarray:
    """The row permutation of LAPACK's swap sequence ``piv`` (0-based:
    row i swapped with row piv[i], in order) on m rows: new row i is old
    row perm[i]."""
    perm = np.arange(m)
    for i, p in enumerate(piv):
        if p != i:
            perm[[i, p]] = perm[[p, i]]
    return perm


def _dgetf2(panel: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """Unblocked LU with partial pivoting of an m x b panel, column by
    column, with LAPACK dgetf2's zero-pivot skip (a column that is exactly
    zero on and below the diagonal is not scaled: U[c, c] = 0, L column 0).
    Returns (packed LU, 0-based swap sequence). The route for a panel on
    which the library's getrf left a non-finite value at a zero pivot."""
    p = panel.clone()
    m, b = p.shape
    piv = np.zeros(b, dtype=np.int64)
    for c in range(min(m, b)):
        i = c + int(torch.argmax(p[c:, c].abs()))  # first of equal maxima
        piv[c] = i
        if i != c:
            p[[c, i]] = p[[i, c]]
        pivot = p[c, c]
        if bool(pivot != 0):
            p[c + 1:, c] /= pivot
        p[c + 1:, c + 1:] -= torch.outer(p[c + 1:, c], p[c, c + 1:])
    return p, piv


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """On a CUDA device, run the scope's ``torch.linalg`` factorizations
    on cuSOLVER: by default torch sends a matrix that is not square (a
    panel) to MAGMA's batched getrf, which is slow for one matrix and does
    not keep dgetf2's pivots on a zero column. Restores the process-wide
    choice on exit."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(old)


def _getrf(a: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """LU with partial pivoting of an m x b matrix (m >= b): (packed LU,
    0-based swap sequence), by ``torch.linalg.lu_factor_ex`` (cuSOLVER's
    getrf on the card); where it met an exact zero pivot and left a
    non-finite value, by :func:`_dgetf2` instead, so the result always has
    dgetf2's zero-pivot semantics."""
    global zero_pivot_panels
    with _cusolver(a.device):
        lu, piv, info = torch.linalg.lu_factor_ex(a)
    if int(info) > 0 and not bool(torch.isfinite(lu).all()):
        zero_pivot_panels += 1
        return _dgetf2(a)
    return lu, piv.cpu().numpy().astype(np.int64) - 1


def _lu_stripes(st: _Stripes, base: int) -> np.ndarray:
    """Blocked right-looking LU of the striped square ``st`` in place (see
    the module docstring); returns perm with A[perm] = L U. Collective over
    the mesh."""
    n = st.n
    perm = np.arange(n)
    for j0 in range(0, n, base):
        j1 = min(j0 + base, n)
        b = j1 - j0
        # --- The (n - j0) x b panel, factored on the root.
        panel = _assemble(st, j0, n, slice(j0, j1), to_root=True)
        lu, piv = _getrf(panel) if st.is_root else (None, None)
        lu = _from_root(st, lu, (n - j0, b), st.local.dtype)
        if st.distributed:
            pv = torch.as_tensor(piv if st.is_root else np.zeros(b, np.int64),
                                 device=st.local.device)
            piv = _from_root(st, pv, (b,), torch.int64).cpu().numpy()
        # --- Its row swaps on every rank's rows (LAPACK's dlaswp), then the
        # factored panel in place of the panel's columns.
        seg = _swaps_to_perm(piv, n - j0)
        _permute_rows(st, j0, seg)
        perm[j0:] = perm[j0:][seg]
        a, e = st.own(j0, n)
        if e > a:
            st.local[a:e, j0:j1] = lu[st.r0 + a - j0:st.r0 + e - j0]
        if j1 == n:
            break
        # --- U12 = unit_lower(L11)^-1 A12 on the base-row stripe.
        a12 = _assemble(st, j0, j1, slice(j1, n), to_root=True)
        u12 = None
        if st.is_root:
            u12 = torch.linalg.solve_triangular(
                lu[:b], a12, upper=False, unitriangular=True)
        u12 = _from_root(st, u12, (b, n - j1), st.local.dtype)
        a, e = st.own(j0, j1)
        if e > a:
            st.local[a:e, j1:] = u12[st.r0 + a - j0:st.r0 + e - j0]
        # --- Schur complement on this rank's trailing rows: A22 -= L21 U12.
        a, e = st.own(j1, n)
        if e > a:
            st.local[a:e, j1:] -= torch.matmul(st.local[a:e, j0:j1], u12)
    return perm


def _lu_factor_dist(a, base: int):
    """(stripes of the packed padded LU, perm of the padded matrix) of a
    tensor or a DistributedMatrix, in "dist" mode."""
    n = a.shape[0]
    npad = -(-n // base) * base
    if isinstance(a, torch.Tensor):
        st = _Stripes(_pad_identity(a, npad), npad, 0, None)
    else:
        st = _stripes_of(a, npad)
    with linalg_precision_scope():
        perm = _lu_stripes(st, base)
    return st, perm


def _tri_solve(f: _Stripes, rhs: _Stripes, base: int, lower: bool,
               unit: bool = False, transpose: bool = False) -> None:
    """Solve op(T) X = B in place of ``rhs`` (B, striped like ``f``), T
    being the lower (``lower``) or upper triangle of the striped square
    ``f``, with a unit diagonal when ``unit``, and op(T) = T^T when
    ``transpose``. Blocked by ``base`` rows; each diagonal block's solve
    runs on the root and is broadcast. Without ``transpose``, right-looking:
    each rank updates its own rows past the block with its own rows of T.
    With it, left-looking: each rank's rows of the solved part give a
    partial sum that one reduce adds up. No rank holds T or B whole.
    Collective over the mesh."""
    n = f.n
    starts = list(range(0, n, base))
    top_down = lower != transpose
    for j0 in (starts if top_down else starts[::-1]):
        j1 = min(j0 + base, n)
        b = j1 - j0
        tjj = _assemble(f, j0, j1, slice(j0, j1), to_root=True)
        bj = _assemble(rhs, j0, j1, slice(None), to_root=True)
        if transpose:
            a, e = f.own(*((j1, n) if lower else (0, j0)))
            part = torch.matmul(f.local[a:e, j0:j1].mT, rhs.local[a:e])
            if f.distributed:
                dist.reduce(part, dst=f.root, group=f.mesh.group)
            bj = bj - part
            tjj = tjj.mT
        xj = None
        if f.is_root:
            xj = torch.linalg.solve_triangular(
                tjj, bj, upper=(not lower) != transpose, unitriangular=unit)
        xj = _from_root(f, xj, (b, rhs.local.shape[1]), rhs.local.dtype)
        a, e = rhs.own(j0, j1)
        if e > a:
            rhs.local[a:e] = xj[rhs.r0 + a - j0:rhs.r0 + e - j0]
        if transpose:
            continue
        a, e = rhs.own(*((j1, n) if lower else (0, j0)))
        if e > a:
            rhs.local[a:e] -= torch.matmul(f.local[a:e, j0:j1], xj)


def _rows_like(st: _Stripes, full: torch.Tensor) -> _Stripes:
    """Stripes like ``st``'s of ``full`` (st.n rows, held by every rank):
    this rank's rows of it, padding rows zero."""
    local = torch.zeros((st.h, full.shape[1]), dtype=st.local.dtype,
                        device=st.local.device)
    a, e = st.own(0, st.n)
    local[a:e] = full[st.r0 + a:st.r0 + e].to(local)
    return _Stripes(local, st.n, st.r0, st.mesh)


def _check_square(a, what: str) -> int:
    m, n = a.shape
    if m != n:
        raise ValueError(f"{what} only support square matrix: {m} v.s {n}")
    return n


def lu_factor_array(a, mode: str = "auto", base_size: Optional[int] = None):
    """LU-factor a square matrix: (packed L\\U, perm) with A[perm] = L U and
    perm a host int64 array. ``a`` is a tensor (the packed LU comes back as
    a tensor) or a DistributedMatrix (as a BlockMatrix on its mesh; in
    "dist" mode no rank holds the whole matrix, and the call is collective
    over the mesh). "local" factors the whole matrix in one
    ``torch.linalg.lu_factor_ex`` call."""
    n = _check_square(a, "LU decompose")
    base = base_size or get_config().lu_base_size
    if _resolve_mode(mode, n) == "local" or base >= n:
        whole = a if isinstance(a, torch.Tensor) else a.logical
        with linalg_precision_scope():
            packed, piv = _getrf(whole)
        perm = _swaps_to_perm(piv, n)
        if isinstance(a, torch.Tensor):
            return packed, perm
        from ..matrix.block import BlockMatrix

        return BlockMatrix(packed, mesh=a.mesh), perm
    st, perm = _lu_factor_dist(a, base)
    if st.mesh is None:
        return st.local[:n, :n].contiguous(), perm[:n]
    return _to_block_matrix(st, (n, n)), perm[:n]


def lu_decompose(mat, mode: str = "auto"):
    """(BlockMatrix with L and U packed, pivot array): the reference's
    return shape (DenseVecMatrix.scala:283). Collective over the mesh."""
    return lu_factor_array(mat, mode=mode)


def unpack_lu(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a packed LU into (unit-lower L, upper U): convenience for
    verification and solves."""
    packed = np.asarray(packed)
    l = np.tril(packed, -1) + np.eye(packed.shape[0], dtype=packed.dtype)
    u = np.triu(packed)
    return l, u
