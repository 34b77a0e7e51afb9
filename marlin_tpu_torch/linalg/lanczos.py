"""Lanczos eigensolver for symmetric PSD operators: port of
``marlin_tpu/linalg/lanczos.py``.

Replacement for the reference's ARPACK reverse-communication loop
(``EigenValueDecomposition.symmetricEigs``, DenseVecMatrix.scala:1743-1834):
top-k eigenpairs of a symmetric operator given only its matvec, by a
host-driven loop. Lanczos with full reorthogonalization, tridiagonal
eigendecomposition, the Ritz-residual convergence test
|beta_m * s_{m,i}| <= tol * |theta_i|, and basis growth until ``max_iter``
steps or convergence. When the Krylov space hits an exact invariant
subspace before k pairs exist (identity-like or low-rank operators, the
case ARPACK handles with deflation), every Ritz pair of that subspace is
locked as exact and Lanczos restarts in the orthogonal complement until
k pairs accumulate.

Two sweep engines share that control structure:

* host sweep: each step calls ``matvec`` and does the recurrence in NumPy
  (the reference's host-side ARPACK workspace, one cluster job per ido
  step, DenseVecMatrix.scala:1779-1797);
* device sweep: with ``matvec_device``, an operator on the device's
  tensors, the whole recurrence (matvec, reorthogonalization, basis
  update) runs on the device in chunks of ``_DEVICE_CHUNK`` steps, and
  the host fetches only the alpha/beta scalars between chunks for the
  convergence test, and the basis once at the end. A step's breakdown is
  recorded on the device, so a chunk runs without a host sync.

The operator protocol: an operator with ``.apply(operand, v)`` and
``.operand`` (``DenseVecMatrix.gramian_matvec_operator`` has them) gets its
operand handed to every step by the sweep; a plain callable ``v -> A v``
is called as is.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import get_config, linalg_precision_scope
from ..utils.hw import DeviceLike, resolve_device

_BREAKDOWN = 1e-14
# Lanczos steps per chunk of the device sweep: the convergence test runs
# between chunks, so a sweep overruns its convergence point by up to a
# chunk. The JAX package's 32 paid for a round trip to a remote TPU per
# chunk; here a chunk boundary is one host sync.
_DEVICE_CHUNK = 16


def symmetric_eigs(
    matvec: Callable[[np.ndarray], np.ndarray],
    n: int,
    k: int,
    tol: float = 1e-10,
    max_iter: int = 300,
    seed: int = 0,
    matvec_device: Optional[Callable] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (eigenvalues descending, eigenvectors n x k) of a symmetric
    operator, as host arrays.

    Mirrors symmetricEigs' contract checks (DenseVecMatrix.scala:1743-1758):
    requires k < n. ``matvec_device``: an operator on device tensors (the
    operator protocol, or a plain callable) enabling the device sweep;
    ``device`` is where a plain callable's vectors live (default: the card;
    an operator's operand says it for itself).
    """
    if not (0 < k < n):
        raise ValueError(
            f"Requested k singular values but got k={k} and n={n}.")
    rng = np.random.default_rng(seed)

    def run(need, L):
        return _lanczos_run(matvec, n, need, L, tol, max_iter, rng,
                            matvec_device=matvec_device, device=device)

    locked_vals: list = []
    locked_vecs: list = []  # orthonormal columns of exact invariant subspaces
    had_exact = False
    for _restart in range(k + 2):
        need = k - len(locked_vals)
        if need <= 0:
            break
        L = (np.stack(locked_vecs, axis=1) if locked_vecs
             else np.zeros((n, 0)))
        if n - L.shape[1] <= 0:
            break
        vals, vecs, exact = run(min(need, n - L.shape[1]), L)
        if exact:
            # Breakdown: the Krylov space is an exact invariant subspace, so
            # every Ritz pair is an eigenpair. Lock them all and restart in
            # the orthogonal complement (deflation).
            had_exact = True
            locked_vals.extend(vals)
            locked_vecs.extend(vecs.T)
            continue
        locked_vals.extend(vals[:need])
        locked_vecs.extend(vecs[:, :need].T)
        break

    if had_exact:
        # An exact breakdown sees each distinct eigenvalue of the swept
        # subspace once, so a repeated top eigenvalue (multiplicity > 1) is
        # under-counted: its other copies live in the orthogonal complement.
        # Keep sweeping the complement while it still holds a Ritz value that
        # belongs in the top k; each productive sweep locks at least one more
        # vector, so this terminates (capped defensively).
        for _verify in range(3 * k + 8):
            if len(locked_vals) < k:
                break  # quota unmet: nothing to verify against
            L = np.stack(locked_vecs, axis=1)
            comp = n - L.shape[1]
            if comp <= 0:
                break
            kth = np.sort(np.asarray(locked_vals))[::-1][k - 1]
            vals, vecs, exact = run(min(k, comp), L)
            gate = kth + tol * max(abs(kth), 1.0)
            keep = [i for i, v in enumerate(vals) if v > gate]
            if not keep:
                break
            locked_vals.extend(vals[i] for i in keep)
            locked_vecs.extend(vecs[:, i] for i in keep)

    order = np.argsort(locked_vals)[::-1][:k]
    evals = np.asarray(locked_vals)[order]
    evecs = np.stack(locked_vecs, axis=1)[:, order]
    return evals, evecs


def _lanczos_run(matvec, n: int, k: int, L: np.ndarray, tol: float,
                 max_iter: int, rng: np.random.Generator,
                 matvec_device=None, device: DeviceLike = None
                 ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """One Lanczos sweep in the orthogonal complement of the locked basis L.

    Returns (eigenvalues desc, Ritz vectors, exact): ``exact`` means the
    sweep hit an invariant subspace, so ALL returned pairs are exact
    eigenpairs; otherwise the top-k converged (or best-effort at max_iter)
    pairs come back."""
    m_max = int(min(n - L.shape[1], max(max_iter, 3 * k + 10)))

    q = rng.standard_normal(n)
    q -= L @ (L.T @ q)
    nrm = np.linalg.norm(q)
    while nrm < 1e-8:  # pathological draw inside span(L); redraw
        q = rng.standard_normal(n)
        q -= L @ (L.T @ q)
        nrm = np.linalg.norm(q)
    q /= nrm

    if matvec_device is not None:
        return _lanczos_sweep_device(matvec_device, q, k, L, tol, m_max,
                                     device)
    Q = np.zeros((n, m_max + 1))
    Q[:, 0] = q
    alphas: list = []
    betas: list = []

    m = 0
    exact = False
    for j in range(m_max):
        w = np.array(matvec(Q[:, j]), dtype=np.float64)
        a_j = float(Q[:, j] @ w)
        w -= a_j * Q[:, j]
        if j > 0:
            w -= betas[-1] * Q[:, j - 1]
        # Full reorthogonalization against the locked basis (deflation) and
        # the current Krylov basis (twice is enough).
        for _ in range(2):
            if L.shape[1]:
                w -= L @ (L.T @ w)
            w -= Q[:, : j + 1] @ (Q[:, : j + 1].T @ w)
        b_j = float(np.linalg.norm(w))
        alphas.append(a_j)
        m = j + 1
        if b_j < _BREAKDOWN:
            # Invariant subspace found: the Krylov space is exact.
            betas.append(0.0)
            exact = True
            break
        betas.append(b_j)
        Q[:, j + 1] = w / b_j

        # Convergence check once the space can hold k Ritz pairs.
        if m >= max(2 * k, k + 2) or m == m_max:
            theta, s = _tridiag_eigh(alphas, betas[:-1])
            resid = abs(betas[-1]) * np.abs(s[-1, -k:])
            if np.all(resid <= tol * np.maximum(np.abs(theta[-k:]), 1e-30)):
                break

    theta, s = _tridiag_eigh(alphas, betas[: m - 1])
    order = np.argsort(theta)[::-1]
    if not exact:
        order = order[:k]
    evals = theta[order]
    evecs = Q[:, :m] @ s[:, order]
    # Normalize (full reorth keeps these near-orthonormal already).
    evecs /= np.linalg.norm(evecs, axis=0, keepdims=True)
    return evals, evecs, exact


def _operator_protocol(matvec_device):
    """(apply, operand) when ``matvec_device`` implements the operator
    protocol, (None, ()) for a plain callable. Half an implementation is a
    loud error: ``.apply`` without ``.operand`` would fail deep inside a
    chunk, and ``.operand`` without ``.apply`` would silently be called as
    a plain callable."""
    apply = getattr(matvec_device, "apply", None)
    has_operand = hasattr(matvec_device, "operand")
    if (apply is not None) != has_operand:
        raise TypeError(
            "operator protocol requires BOTH .apply and .operand "
            f"(got apply={apply is not None}, operand={has_operand})")
    return (apply, matvec_device.operand) if apply is not None else (None, ())


def _sweep_dtype_device(matvec_device, device: DeviceLike):
    """The device sweep's (dtype, device): the operand's (at least f32)
    for a protocol operator, else the config's default dtype (at least
    f32) on ``device`` (default: the card)."""
    apply, operand = _operator_protocol(matvec_device)
    if apply is not None and isinstance(operand, torch.Tensor):
        return (torch.promote_types(operand.dtype, torch.float32),
                operand.device)
    return (torch.promote_types(get_config().default_dtype, torch.float32),
            resolve_device("cuda" if device is None else device))


def _device_chunk_fn(matvec_device, m_cap: int, l_cols: int, n: int,
                     dtype: torch.dtype):
    """The chunk: ``chunk(operand, carry) -> carry`` runs _DEVICE_CHUNK
    Lanczos steps on the device (fewer once step ``m_cap`` is reached).

    Carry: (Q (m_cap + 1, n) basis rows, alphas (m_cap,), betas (m_cap,),
    L (n, l_cols) locked basis, j (the next step, a host int), broke (a
    device scalar: the first step that broke down, or -1)). Rows of Q past
    j are zero, so full reorthogonalization is a fixed-shape Q^T (Q w).
    The operand is the chunk's argument, not captured: a protocol operator
    applies ``operand``, the one its caller hands over."""
    apply, _ = _operator_protocol(matvec_device)
    eps = 1e-13 if dtype == torch.float64 else 1e-6
    tiny = torch.finfo(dtype).tiny

    def step(operand, Q, alphas, betas, L, j, broke):
        qj = Q[j]
        w = (apply(operand, qj) if apply is not None
             else matvec_device(qj)).to(dtype)
        a_j = qj @ w
        w = w - a_j * qj
        if j > 0:
            w = w - betas[j - 1] * Q[j - 1]
        for _ in range(2):  # full reorth: locked basis, then Krylov rows
            if l_cols:
                w = w - L @ (L.mT @ w)
            w = w - Q.mT @ (Q @ w)
        b_j = torch.linalg.vector_norm(w)
        alphas[j] = a_j
        betas[j] = b_j
        # Scale-aware breakdown: the host sweep's absolute 1e-14 is an f64
        # idiom; in f32 the invariant-subspace signal lands near
        # eps * scale.
        scale = torch.maximum(alphas[:j + 1].abs().max(),
                              betas[:j + 1].max())
        breakdown = b_j <= eps * scale.clamp_min(1e-30)
        Q[j + 1] = torch.where(breakdown, torch.zeros_like(w),
                               w / b_j.clamp_min(tiny))
        return torch.where((broke < 0) & breakdown,
                           torch.full_like(broke, j), broke)

    def chunk(operand, carry):
        Q, alphas, betas, L, j, broke = carry
        for _ in range(_DEVICE_CHUNK):
            if j >= m_cap:
                break
            broke = step(operand, Q, alphas, betas, L, j, broke)
            j += 1
        return Q, alphas, betas, L, j, broke

    return chunk


def _lanczos_sweep_device(matvec_device, q0: np.ndarray, k: int,
                          L: np.ndarray, tol: float, m_max: int,
                          device: DeviceLike
                          ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Device sweep: the host loop's contract (:func:`_lanczos_run`), the
    recurrence in chunks on the device."""
    n = q0.shape[0]
    dtype, dev = _sweep_dtype_device(matvec_device, device)
    l_cols = L.shape[1]
    chunk = _device_chunk_fn(matvec_device, m_max, l_cols, n, dtype)
    _, operand = _operator_protocol(matvec_device)

    Q = torch.zeros((m_max + 1, n), dtype=dtype, device=dev)
    Q[0] = torch.as_tensor(q0, dtype=dtype, device=dev)
    carry = (Q, torch.zeros(m_max, dtype=dtype, device=dev),
             torch.zeros(m_max, dtype=dtype, device=dev),
             torch.as_tensor(L, dtype=dtype, device=dev), 0,
             torch.full((), -1, dtype=torch.int64, device=dev))
    check_from = max(2 * k, k + 2)
    m, exact = 0, False
    while True:
        # The reorthogonalization products must not run as reduced-
        # precision passes when the global matmul precision is relaxed:
        # orthogonality loss in the Krylov basis makes spurious Ritz values.
        with linalg_precision_scope():
            carry = chunk(operand, carry)
        j = carry[4]
        # One fetch per chunk: alphas, betas and the breakdown step.
        got = torch.cat([carry[1][:j], carry[2][:j],
                         carry[5].to(dtype)[None]]).cpu().double().numpy()
        broke = int(got[-1])
        m = broke + 1 if broke >= 0 else j
        alphas, betas = got[:m], got[j:j + m]
        if broke >= 0:
            exact = True
            break
        if m >= m_max:
            break
        if m >= check_from:
            theta, s = _tridiag_eigh(list(alphas), list(betas[:-1]))
            resid = abs(betas[-1]) * np.abs(s[-1, -k:])
            if np.all(resid <= tol * np.maximum(np.abs(theta[-k:]), 1e-30)):
                break

    Qh = carry[0][:m].double().cpu().numpy().T  # (n, m), fetched once
    theta, s = _tridiag_eigh(list(alphas[:m]), list(betas[: m - 1]))
    order = np.argsort(theta)[::-1]
    if not exact:
        order = order[:k]
    evals = theta[order]
    evecs = Qh @ s[:, order]
    evecs /= np.linalg.norm(evecs, axis=0, keepdims=True)
    return evals, evecs, exact


def _tridiag_eigh(alphas, betas) -> Tuple[np.ndarray, np.ndarray]:
    m = len(alphas)
    T = np.diag(np.asarray(alphas, dtype=np.float64))
    if m > 1:
        off = np.asarray(betas[: m - 1], dtype=np.float64)
        T += np.diag(off, 1) + np.diag(off, -1)
    return np.linalg.eigh(T)
