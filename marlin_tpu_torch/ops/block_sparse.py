"""Block-sparse GEMM: the hand-written Hopper kernels and their plain
PyTorch versions.

Port of ``marlin_tpu/ops/block_sparse.py``. The sparse format is dense
blocks with a block mask (zero blocks skipped), which keeps every
surviving FLOP on the tensor cores. This module provides:

* :class:`BlockSparse` — block-compressed container: a (K/bs, N/bs) int32
  block mask and the dense backing tensor (only masked blocks meaningful,
  the rest zeroed at construction).
* :func:`block_sparse_matmul` — C = A @ B with B block-sparse. The two
  Pallas TPU kernels become the two CUDA C++ kernels of
  ``csrc/block_sparse.cu``: ``_spmm_gather_kernel`` (the k sweep walks
  per-column lists of nonzero blocks, built on the host from the mask) is
  ``marlin_block_sparse_spmm_gather``, taken whenever the mask has a host
  value; ``_spmm_kernel`` (the full K grid, gated on the device mask) is
  ``marlin_block_sparse_spmm_masked``, taken when it has none. In the JAX
  package a mask has no host value under an outer ``jit`` (it is a
  tracer); here it has none when it is a CUDA tensor and the current
  stream is capturing a CUDA graph, where a copy to the host is illegal.
  At bf16 both routes run one kernel body (wgmma fed by TMA through an
  mbarrier ring) and differ only in how a CTA finds its column's live
  blocks: its list, or a scan of its mask column; so their results are
  bitwise equal. At f32 both run one register-tiled FMA kernel fed by
  cp.async, whose columns' sweeps may be cut into P parts
  (:func:`_spmm_f32_plan`, from the shape alone, so the two routes cut
  alike) added in part order by a second pass: bitwise equal too.

Dispatch: CPU tensors take the plain versions
(:func:`spmm_gather_reference`, :func:`spmm_masked_reference`); CUDA
tensors take the kernels. There is no fallback: on the card a kernel that
cannot be built or launched, a block size that is not a multiple of 64 or
a dtype other than bf16 and f32 raises. The TPU wrapper pads M to a
multiple of the block size; the CUDA kernels mask the ragged M edge
themselves and nothing is copied.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import get_config, matmul_precision_scope
from ..utils.hw import is_sm90, resolve_device
from . import build
from .flash_attention import _sm_count

# Block sizes the kernels take: every multiple of this (their CTA tile is
# 128 x 128, or 128 x 64 for a block size that 128 does not divide).
KERNEL_BLOCK_MULTIPLE = 64
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# The f32 kernel's cut (csrc/block_sparse.cu, spmm_f32): a CTA's output
# tile and the depth of one step (a 64 x 64 x 64 box product for each of
# its two warpgroups).
SPMM_F32_ROWS = 128
SPMM_F32_COLS = 64
SPMM_F32_STEP = 64
# CTAs of its persistent grid an SM (kFCtasPerSm).
SPMM_F32_CTAS_PER_SM = 2
# Bytes the card moves (3.35 TB/s) in the time of one step on one SM (two
# 64 x 64 x 64 box products at 2/3 of an SM's 128 FMA a clock, ~3.1 us):
# what the plan charges its second pass, which reads P planes of C and
# writes one.
SPMM_F32_STEP_BYTES = 10e6

# Kernel launches since the last reset, one counter per kernel
# (chip_smoke.py zeroes and reads them to prove that a path ran through
# the kernels): the gather kernel and the masked-grid kernel.
gather_launches = 0
masked_launches = 0


def _host_value(mask: torch.Tensor) -> Optional[np.ndarray]:
    """The mask as a host array, or None where it has no host value: a
    CUDA tensor while the current stream is capturing a CUDA graph (a copy
    to the host is illegal there, as ``np.asarray`` of a tracer is under
    ``jax.jit``)."""
    if mask.is_cuda and torch.cuda.is_current_stream_capturing():
        return None
    return mask.cpu().numpy()


def _expand(mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """The (K/bs, N/bs) block mask as a (K, N) bool tensor (a broadcast
    and one copy: nothing that reads the mask on the host, so it can be
    captured into a CUDA graph)."""
    r, c = mask.shape
    return (mask != 0)[:, None, :, None].expand(
        r, block_size, c, block_size).reshape(r * block_size, c * block_size)


class BlockSparse:
    """Block-compressed matrix: dense backing + (rows/bs, cols/bs) block
    mask, both on one device.

    Unmasked blocks are zeroed at construction, so every execution path
    (gather kernel, masked-grid kernel, plain versions, the dense
    gradient products) computes the same result. Instances are immutable:
    do not reassign ``data``/``mask`` after construction — the gather
    block lists are cached per instance.
    """

    def __init__(self, data: torch.Tensor, mask, block_size: int):
        if data.dim() != 2:
            raise ValueError(f"expected a 2-D tensor, got {tuple(data.shape)}")
        if data.shape[0] % block_size or data.shape[1] % block_size:
            raise ValueError(
                f"shape {tuple(data.shape)} not divisible by block_size "
                f"{block_size}")
        expect = (data.shape[0] // block_size, data.shape[1] // block_size)
        mask = torch.as_tensor(mask)
        if tuple(mask.shape) != expect:
            raise ValueError(
                f"mask shape {tuple(mask.shape)} != block grid {expect}")
        mask = mask.to(device=data.device, dtype=torch.int32)
        self.data = torch.where(_expand(mask, block_size), data,
                                torch.zeros((), dtype=data.dtype,
                                            device=data.device))
        self.mask = mask
        self.block_size = block_size
        # Probe ONCE at construction (a per-multiply probe would add a
        # blocking device sync to every call): eagerly it yields the host
        # mask the gather lists need anyway.
        self._host_mask = _host_value(mask)
        self._gather_lists_cache = None

    def _gather_lists(self):
        """(kidx, kcnt, max_nnz) for the gather kernel, kidx and kcnt as
        int32 tensors on the data's device, computed once per instance
        (the column scan and the copy would otherwise run on every
        multiply of a reused operand)."""
        if self._gather_lists_cache is None:
            kidx, kcnt, max_nnz = _column_block_lists(self._host_mask)
            dev = self.data.device
            self._gather_lists_cache = (
                torch.from_numpy(kidx).to(dev), torch.from_numpy(kcnt).to(dev),
                max_nnz)
        return self._gather_lists_cache

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def block_density(self) -> float:
        if self._host_mask is not None:
            return float(self._host_mask.mean())
        return float(self.mask.float().mean())

    @classmethod
    def from_dense(cls, arr, block_size: int = 128,
                   device="cuda") -> "BlockSparse":
        """From a dense array or tensor, padded up to the block size; a
        block is kept when any of its elements is nonzero. A tensor stays
        on its own device; anything else is placed on ``device``."""
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(np.asarray(arr)).to(resolve_device(device))
        pad = [(-s) % block_size for s in arr.shape]
        if any(pad):
            arr = torch.nn.functional.pad(arr, (0, pad[1], 0, pad[0]))
        r, c = arr.shape
        blocks = arr.reshape(r // block_size, block_size, c // block_size,
                             block_size)
        mask = (blocks != 0).any(dim=3).any(dim=1)
        return cls(arr, mask, block_size)  # ctor zeroes unmasked blocks

    @classmethod
    def from_numpy(cls, data, mask, block_size: int, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> "BlockSparse":
        """From the JAX container's ``data`` and ``mask`` given as numpy
        arrays (``np.asarray(b.data)``, ``np.asarray(b.mask)``), placed on
        ``device``, so both packages multiply the same operand. numpy has
        no bfloat16: hand a bfloat16 backing over as float32 and name
        ``dtype=torch.bfloat16`` (the cast back is exact)."""
        dev = resolve_device(device)
        data = torch.from_numpy(np.array(data)).to(dev)
        if dtype is not None:
            data = data.to(dtype)
        return cls(data, torch.from_numpy(np.array(mask)).to(dev),
                   block_size)

    def to_dense(self) -> torch.Tensor:
        return self.data


def _column_block_lists(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """(kidx, kcnt, max_nnz) for the gather kernel; kidx padded by
    repeating the last nonzero index (the kernel never reads the pad: its
    loop ends at ``kcnt[j]``)."""
    mask = mask.astype(bool)
    kcnt = mask.sum(axis=0).astype(np.int32)
    max_nnz = max(int(kcnt.max(initial=0)), 1)
    kidx = np.zeros((mask.shape[1], max_nnz), np.int32)
    for j in range(mask.shape[1]):
        nz = np.flatnonzero(mask[:, j])
        if nz.size:
            kidx[j, : nz.size] = nz
            kidx[j, nz.size :] = nz[-1]
    return kidx, kcnt, max_nnz


def _accumulate(out, a, data, k: int, j: int, bs: int) -> None:
    """out[:, block column j] += A[:, block k] @ B[block k, block j], the
    product and the sum in out's (>= f32) dtype."""
    out[:, j * bs:(j + 1) * bs] += (
        a[:, k * bs:(k + 1) * bs].to(out.dtype)
        @ data[k * bs:(k + 1) * bs, j * bs:(j + 1) * bs].to(out.dtype))


def spmm_gather_reference(a, data, kidx, kcnt, block_size: int):
    """The gather kernel's plain version: for each block column ``j``,
    walk its list ``kidx[j, :kcnt[j]]`` (host arrays or CPU tensors;
    entries at or past ``kcnt[j]`` are never read), accumulate the block products in f32
    (f64 for f64 operands) and cast once at the end. An empty column comes
    out exactly 0. It exists for CPU tensors, for tests and as the
    kernel's yardstick of correctness."""
    acc = torch.promote_types(data.dtype, torch.float32)
    out = torch.zeros((a.shape[0], data.shape[1]), dtype=acc,
                      device=data.device)
    for j in range(data.shape[1] // block_size):
        for kk in range(int(kcnt[j])):
            _accumulate(out, a, data, int(kidx[j, kk]), j, block_size)
    return out.to(data.dtype)


def spmm_masked_reference(a, data, mask, block_size: int):
    """The masked-grid kernel's plain version: walk the full
    (N/bs, K/bs) grid and accumulate only where ``mask[k, j]`` is nonzero
    (the mask is read on the host: this version never runs under graph
    capture). The same products in the same order as
    :func:`spmm_gather_reference`, so the two are bitwise equal."""
    acc = torch.promote_types(data.dtype, torch.float32)
    out = torch.zeros((a.shape[0], data.shape[1]), dtype=acc,
                      device=data.device)
    live = torch.as_tensor(mask).cpu().numpy() != 0
    for j in range(data.shape[1] // block_size):
        for k in range(data.shape[0] // block_size):
            if live[k, j]:
                _accumulate(out, a, data, k, j, block_size)
    return out.to(data.dtype)


def _spmm_f32_part_run(n: int, parts: int, p: int) -> Tuple[int, int]:
    """``(lo, hi)``: the run of a column's ``n`` live blocks (their
    indices in ascending k) that part ``p`` of ``parts`` takes
    (``part_run`` of ``csrc/block_sparse.cu``): P runs whose lengths
    differ by at most one, some empty where n < P."""
    return p * n // parts, (p + 1) * n // parts


class SpmmF32Plan(NamedTuple):
    """How the f32 SpMM kernel cuts its work (``csrc/block_sparse.cu``; the
    C entries take ``parts``). ``parts``: P, the sweep parts of each 128 x
    64 output tile, each a run of its column's live blocks
    (:func:`_spmm_f32_part_run`). ``units``: row tiles x P x column tiles,
    which a persistent grid of ``ctas`` CTAs takes in turn (CTA x: units
    x, x + ctas, ...). ``workspace_bytes``: the parts' f32 sums, (P, M,
    N), 0 for P = 1 (no second pass)."""
    parts: int
    units: int
    ctas: int
    workspace_bytes: int


def _spmm_f32_makespan(cost: list, sms: int) -> float:
    """The time of units of ``cost`` steps each on the kernel's persistent
    grid over ``sms`` SMs: min(units, :data:`SPMM_F32_CTAS_PER_SM` x sms)
    CTAs, CTA x taking units x, x + G, ...; CTAs x, x + sms, ... share SM
    x and its rate, so an SM takes the sum of its CTAs' units."""
    ctas = min(len(cost), SPMM_F32_CTAS_PER_SM * sms)
    per_sm = [0.0] * min(sms, ctas)
    for u, c in enumerate(cost):
        per_sm[u % ctas % sms] += c
    return max(per_sm)


@functools.lru_cache(maxsize=256)
def _spmm_f32_plan(m: int, k: int, n: int, bs: int, sms: int,
                   parts: Optional[int] = None) -> SpmmF32Plan:
    """The f32 SpMM kernel's cut of C (M, N) = A (M, K) @ B (K, N) in blocks
    of ``bs`` on a card of ``sms`` SMs: P = ``parts`` where given, else the
    P whose units finish soonest on the persistent grid
    (:func:`_spmm_f32_makespan`), then the least. The model assumes every
    block live, since the masked route runs where the mask has no host
    value (graph capture), and both routes must cut alike (their results
    are bitwise equal): P comes from the shape alone, never from the column
    counts. A unit's steps: its run of the K / bs blocks, bs / 64 each, and
    one for its stores; above P = 1 the second pass costs (P + 1) M N 4
    bytes at :data:`SPMM_F32_STEP_BYTES` a step. Units that fill every SM
    16 times over take P = 1."""
    tiles = -(-m // SPMM_F32_ROWS) * (n // SPMM_F32_COLS)
    blocks, per_block = k // bs, bs // SPMM_F32_STEP

    def makespan(p):
        runs = [hi - lo for lo, hi in
                (_spmm_f32_part_run(blocks, p, q) for q in range(p))]
        # units in grid order: the parts of a row of tiles, then the next
        cost = [r * per_block + 1 for r in runs
                for _ in range(n // SPMM_F32_COLS)] * -(-m // SPMM_F32_ROWS)
        return (_spmm_f32_makespan(cost, sms)
                + (p > 1) * (p + 1) * m * n * 4 / SPMM_F32_STEP_BYTES)

    if parts is None:
        parts = 1
        if tiles < 16 * sms:
            parts = min(range(1, blocks + 1), key=lambda p: (makespan(p), p))
    units = tiles * parts
    return SpmmF32Plan(parts, units,
                       min(units, SPMM_F32_CTAS_PER_SM * sms),
                       parts * m * n * 4 if parts > 1 else 0)


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("block_sparse")
    gather, masked = (lib.marlin_block_sparse_spmm_gather,
                      lib.marlin_block_sparse_spmm_masked)
    if gather.argtypes is None:  # c_void_p, or ctypes would cut pointers
        gather.restype = masked.restype = ctypes.c_int
        gather.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        masked.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def _check_launch(a, data, block_size: int, **ints) -> None:
    """Raise on anything the kernels do not take: a dtype other than bf16
    or f32, two dtypes, a block size that is not a multiple of 64, an
    empty A, shapes that do not form a product in whole blocks, a tensor
    that is not CUDA, not contiguous or not 16-byte aligned, an ``ints``
    tensor (``mask``, ``kidx``, ``kcnt``) that is not int32 or not of its
    block grid's shape, several devices, a card that is not Hopper."""
    if data.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"the kernels take bf16 or f32, got {data.dtype} (float64 runs "
            f"through the plain versions, on CPU tensors only)")
    if a.dtype != data.dtype:
        raise ValueError(f"a is {a.dtype}, b is {data.dtype}")
    if block_size < 1 or block_size % KERNEL_BLOCK_MULTIPLE:
        raise ValueError(
            f"the kernels take block sizes that are multiples of "
            f"{KERNEL_BLOCK_MULTIPLE}, got {block_size} (any block size "
            f"runs through the plain versions, on CPU tensors only)")
    if a.shape[0] < 1:
        raise ValueError(f"the kernels need at least one row of A, got "
                         f"{tuple(a.shape)}")
    (k, n), grid = data.shape, (data.shape[0] // block_size,
                                data.shape[1] // block_size)
    if a.shape[1] != k or k % block_size or n % block_size:
        raise ValueError(
            f"a {tuple(a.shape)} and b {tuple(data.shape)} do not form a "
            f"product in blocks of {block_size}")
    want = {"mask": grid, "kcnt": grid[1:],
            "kidx": (grid[1], ints["kidx"].shape[-1] if "kidx" in ints
                     else 0)}
    for name, x in ints.items():
        if tuple(x.shape) != want[name] or x.numel() < 1:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{want[name]} for block grid {grid}")
    for name, x in ints.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{name} is {x.dtype}, the kernels take int32")
    every = {"a": a, "b": data, **ints}
    # The bf16 kernel's TMA loads and the f32 kernel's cp.async (both
    # routes) need 16-byte-aligned bases (a view at an odd offset is not);
    # their row strides, K and N elements, are multiples of 64 and so
    # already whole 16-byte units.
    for name, x in every.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, x in every.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != data.device:
            raise ValueError("the kernels' tensors must be on one device")
    if not is_sm90(data.device):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(data.device)} is not one")


def _check_err(err: int, what: str, a, data, block_size: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaError_t {err} (A {tuple(a.shape)}, "
            f"B {tuple(data.shape)}, block_size {block_size}, "
            f"{data.dtype})")


def _parts(a, data, block_size: int, parts: Optional[int]):
    """``(P, workspace or None)`` of the kernels on these operands: 1 and
    none for bf16; for f32 :func:`_spmm_f32_plan`'s P (``parts`` where
    given) and, for P > 1, its f32 workspace."""
    if data.dtype != torch.float32:
        return 1, None
    (m, k), n = a.shape, data.shape[1]
    plan = _spmm_f32_plan(m, k, n, block_size, _sm_count(data.device),
                          parts)
    ws = None
    if plan.workspace_bytes:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=data.device)
    return plan.parts, ws


def _launch_gather(a, data, kidx, kcnt, max_nnz: int, block_size: int,
                   parts: Optional[int] = None):
    """Run the gather route's kernel (B1): C (M, N) in B's dtype.
    ``kidx`` (N/bs, max_nnz) and ``kcnt`` (N/bs) are int32 tensors on the
    card. The f32 kernel gets the sweep parts P of :func:`_spmm_f32_plan`
    (``parts`` where given) and for P > 1 its workspace; the second pass
    is part of the same call (one launch counted). Allocates with
    ``torch.empty`` only and launches on the current stream."""
    global gather_launches
    lib = _kernel_lib()
    _check_launch(a, data, block_size, kidx=kidx, kcnt=kcnt)
    (m, k), n = a.shape, data.shape[1]
    out = torch.empty((m, n), dtype=data.dtype, device=data.device)
    p, ws = _parts(a, data, block_size, parts)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_block_sparse_spmm_gather(
            _KERNEL_DTYPES[data.dtype], a.data_ptr(), data.data_ptr(),
            out.data_ptr(), kidx.data_ptr(), kcnt.data_ptr(),
            None if ws is None else ws.data_ptr(), m, k, n, block_size,
            max_nnz, p, stream)
    _check_err(err, "block_sparse_spmm_gather", a, data, block_size)
    gather_launches += 1
    return out


def _launch_masked(a, data, mask, block_size: int,
                   parts: Optional[int] = None):
    """Run the masked-grid route's kernel (B2): C (M, N) in B's dtype,
    the (K/bs, N/bs) int32 ``mask`` read on the card (each CTA counts its
    column's live blocks there before its first load). The f32 kernel gets
    the same P as the gather route (from the shape alone) and its
    workspace. Touches nothing on the host, allocates with ``torch.empty``
    only and launches on the current stream, so it can be captured into a
    CUDA graph."""
    global masked_launches
    lib = _kernel_lib()
    _check_launch(a, data, block_size, mask=mask)
    (m, k), n = a.shape, data.shape[1]
    out = torch.empty((m, n), dtype=data.dtype, device=data.device)
    p, ws = _parts(a, data, block_size, parts)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_block_sparse_spmm_masked(
            _KERNEL_DTYPES[data.dtype], a.data_ptr(), data.data_ptr(),
            out.data_ptr(), mask.data_ptr(),
            None if ws is None else ws.data_ptr(), m, k, n, block_size, p,
            stream)
    _check_err(err, "block_sparse_spmm_masked", a, data, block_size)
    masked_launches += 1
    return out


def _forward(a, data, b: BlockSparse):
    """C = A @ B on ``b``'s route: the plain versions for CPU tensors, the
    kernels (or an error) for any other; the gather route when the mask
    has a host value, the masked-grid route when not. ``data`` is
    ``b.data`` (passed apart so that autograd sees it)."""
    bs = b.block_size
    if a.device != data.device:
        raise ValueError(f"a is on {a.device}, b on {data.device}")
    if data.device.type == "cpu":
        if b._host_mask is None:
            return spmm_masked_reference(a, data, b.mask, bs)
        kidx, kcnt, _ = b._gather_lists()
        return spmm_gather_reference(a, data, kidx, kcnt, bs)
    if b._host_mask is None:
        return _launch_masked(a.contiguous(), data.contiguous(), b.mask, bs)
    kidx, kcnt, max_nnz = b._gather_lists()
    return _launch_gather(a.contiguous(), data.contiguous(), kidx, kcnt,
                          max_nnz, bs)


class BlockSparseMatmulFunction(torch.autograd.Function):
    """Differentiable SpMM: the counterpart of the JAX package's
    ``_diff_spmm`` custom_vjp. The forward is the kernel (the plain
    version on the CPU); the backward is the closed-form dense recompute
    in f32 — dA = g B^T rides the zero-masked backing (exact), dB = A^T g
    projected onto the block mask (a gradient exists only where blocks
    do, matching the container's zeroing invariant) — both cast back.
    Those two products are plain ``jnp.dot`` calls outside any kernel in
    the JAX package, so they are ``torch.matmul`` here, at the config's
    ``matmul_precision``."""

    @staticmethod
    def forward(ctx, a, data, b):
        ctx.save_for_backward(a, data)
        ctx.mask, ctx.block_size = b.mask, b.block_size
        return _forward(a, data, b)

    @staticmethod
    def backward(ctx, g):
        a, data = ctx.saved_tensors
        gf, af, df = g.float(), a.float(), data.float()
        with matmul_precision_scope(get_config().matmul_precision):
            da = gf @ df.T
            db = af.T @ gf
        db = torch.where(_expand(ctx.mask, ctx.block_size), db,
                         torch.zeros((), dtype=db.dtype, device=db.device))
        return da.to(a.dtype), db.to(data.dtype), None


def block_sparse_matmul(a: torch.Tensor, b: BlockSparse) -> torch.Tensor:
    """C = A @ B with B block-sparse; empty B blocks issue no work. A is
    cast to B's dtype; the result has B's dtype, accumulated in f32.

    CPU tensors take the plain versions; CUDA tensors take the kernels or
    raise. Differentiable in A and in B's backing tensor through
    :class:`BlockSparseMatmulFunction` when grad is enabled and one of
    them requires grad; otherwise a direct call (one launch, nothing
    saved)."""
    if a.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"dimension mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    a = a.to(b.data.dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.data.requires_grad):
        return BlockSparseMatmulFunction.apply(a, b.data, b)
    return _forward(a, b.data, b)
