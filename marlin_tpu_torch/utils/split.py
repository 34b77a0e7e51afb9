"""GEMM split policy and shape helpers: port of ``marlin_tpu/utils/split.py``.

The CARMA-style (m, k, n) grid chooser (``split_method``,
``grid_for_devices``), the near-square heuristic, the re-blocking planner
and ``pad_to_multiple``, with the reference's policy and API unchanged;
only ``pad_to_multiple`` touches tensors (torch in place of jnp).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def split_method(m: int, k: int, n: int,
                 parallelism: int) -> Tuple[int, int, int]:
    """Choose an (m_split, k_split, n_split) grid with product <=
    parallelism: repeatedly halve the currently largest dimension (ties: m,
    then n, then k) while budget remains (MTUtils.scala:150-175). Splits
    never exceed the dimension itself."""
    if parallelism < 1:
        raise ValueError("parallelism must be >= 1")
    ms, ks, ns = 1, 1, 1
    budget = parallelism
    dm, dk, dn = m, k, n
    while budget >= 2:
        candidates = [(dm, "m"), (dn, "n"), (dk, "k")]
        candidates.sort(key=lambda t: -t[0])
        ext, which = candidates[0]
        if ext < 2:
            break
        if which == "m":
            ms *= 2
            dm = max(1, dm // 2)
        elif which == "n":
            ns *= 2
            dn = max(1, dn // 2)
        else:
            ks *= 2
            dk = max(1, dk // 2)
        budget //= 2
    return ms, ks, ns


def near_square_split(parallelism: int) -> int:
    """Marlin's near-square heuristic: split every dimension by
    ``floor((3*parallelism)^(1/3))`` (DenseVecMatrix.scala:208-213)."""
    return max(1, int(round((3.0 * parallelism) ** (1.0 / 3.0) - 1e-9)))


def is_near_square(m: int, k: int, n: int, tol: float = 4.0) -> bool:
    """True when the three dimensions are within ``tol``x of each other."""
    lo, hi = min(m, k, n), max(m, k, n)
    return hi <= tol * lo


def grid_for_devices(m: int, k: int, n: int,
                     n_devices: int) -> Tuple[int, int, int]:
    """Factor ``n_devices`` into a (pm, pk, pn) grid for C[m,n] = A[m,k]
    B[k,n] whose product is exactly ``n_devices``: each prime factor goes
    to the dimension with the largest per-shard extent, k discounted by
    half (a k-split costs a reduction collective)."""
    pm, pk, pn = 1, 1, 1
    for f in sorted(_prime_factors(n_devices), reverse=True):
        em, ek, en = m / pm, (k / pk) * 0.5, n / pn
        best = max(em, ek, en)
        if best == em:
            pm *= f
        elif best == en:
            pn *= f
        else:
            pk *= f
    return pm, pk, pn


def _prime_factors(x: int):
    out = []
    d = 2
    while d * d <= x:
        while x % d == 0:
            out.append(d)
            x //= d
        d += 1
    if x > 1:
        out.append(x)
    return out


def dim_to_split(row_ratio: float, col_ratio: float) -> str:
    """Which dimension a re-blocking should split first (MTUtils.scala:204)."""
    return "row" if row_ratio >= col_ratio else "column"


def reblock_plan(old_starts, new_block: int):
    """Plan a re-chunking of a 1-D extent from old chunk boundaries to
    uniform ``new_block`` chunks (MTUtils.scala:182-202): a list of
    (old_chunk_idx, old_offset, new_chunk_idx, new_offset, length) copy
    descriptors."""
    plan = []
    total = old_starts[-1]
    starts = list(old_starts[:-1])
    for oi, ostart in enumerate(starts):
        oend = old_starts[oi + 1]
        pos = ostart
        while pos < oend:
            ni = pos // new_block
            nstart = ni * new_block
            nend = min(nstart + new_block, total)
            length = min(oend, nend) - pos
            plan.append((oi, pos - ostart, ni, pos - nstart, length))
            pos += length
    return plan


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to the next multiple of ``mult``."""
    extra = (-x.shape[axis]) % mult
    if not extra:
        return x
    axis %= x.dim()
    # F.pad lists (before, after) pairs from the LAST axis backwards.
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, extra]
    return F.pad(x, pads)


def pad_to(x: torch.Tensor, mults) -> torch.Tensor:
    """Zero-pad each dim of ``x`` up to a multiple of the matching entry
    of ``mults`` (``parallel/summa.py``'s ``_pad_to``)."""
    for axis, mult in enumerate(mults):
        x = pad_to_multiple(x, axis, mult)
    return x
