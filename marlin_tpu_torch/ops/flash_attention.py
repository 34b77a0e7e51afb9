"""Flash attention: the hand-written Hopper kernels and their plain
PyTorch versions, forward and backward.

Port of ``marlin_tpu/ops/flash_attention.py``. The Pallas TPU kernels
become CUDA C++ kernels: ``_kernel`` (the forward) is
``csrc/flash_attention_fwd.cu``; ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (the backward) are ``csrc/flash_attention_bwd.cu``.
For bf16 all three kernels run wgmma fed by TMA through an mbarrier
ring; for f32 all three are FMA kernels. The TPU's block constants and
VMEM clamps (``DEFAULT_BLOCK_Q/K``, ``effective_blocks``,
``window_block_clamp``, the backward's 512-row clamp, the lane-replicated
lse) do not carry over: each CUDA kernel uses its own tiles (:data:`KERNEL_TILES`) and masks the ragged edges itself.

Dispatch: CPU tensors take the plain versions,
:func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`; CUDA tensors take the kernels.
There is no fallback: on the card, a kernel that cannot be built or
launched raises, forward or backward. When grad is enabled and an input
requires grad, the call goes through :class:`FlashAttentionFunction`, the
counterpart of the JAX package's ``_flash_hsd`` custom_vjp: it saves
only ``(q_hat, k, v, o, lse)`` and its backward recomputes the
probability tiles from lse, so no (Sq, Skv) tensor is kept between the
two passes.

Head dims. The kernels are built for D and Dv in :data:`KERNEL_HEAD_DIMS`
(64 and 128 in any pairing, and D = Dv = 256); on the card the wrapper
zero-pads q_hat and K (D) and V and dO (Dv) up to the smallest of them
that holds the head dim, both to 256 when either is above 128
(:func:`_kernel_head_dims`), and slices O, dQ, dK and dV back, as the JAX
package pads to its 128-lane tile (zero columns add nothing to q_hat K^T,
to P V or to Delta). A head dim above 256 raises: the reference pads it
to the next multiple of 128, for which no kernel is built (ROADMAP Queue
C, C4).

Public layout is the JAX package's ``(S, H, D)``, plus an optional
leading batch dimension that stands in for ``jax.vmap``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils.hw import is_sm90
from . import build

_NEG_INF = -1e30  # masked logits stay finite, as in the TPU kernel
_LOG2E = math.log2(math.e)

# Head dims the kernel is instantiated for (template arguments D and Dv),
# ascending; smaller ones are zero-padded up to the next (_padded_fwd).
# 64 and 128 pair freely; 256 only with 256 (_kernel_head_dims).
KERNEL_HEAD_DIMS = (64, 128, 256)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# (query rows, keys) of each bf16 kernel's tile: the forward's kBM x kBN in
# csrc/flash_attention_fwd.cu, the dQ kernel's kBM x kBN and the dK/dV
# kernel's kDkvBM x kDkvBN in csrc/flash_attention_bwd.cu. The cost model
# counts the forward's tiles with them.
KERNEL_TILES = {"fwd": (128, 128), "dq": (64, 64), "dkv": (64, 64)}

# Kernel launches since the last reset, one counter per kernel
# (chip_smoke.py zeroes and reads them to prove that a path ran through
# the kernels): the forward, the dQ backward and the dK/dV backward.
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


def _prepare(q, k, v, causal: bool, scale: Optional[float], window: int):
    """Validate batched (B, S, H, D) shapes and the options, and fold
    ``scale * log2(e)`` into Q in >= f32 and round it back to Q's dtype —
    the TPU kernel's prescale (``_flash_hsd_impl``), whose rounding at
    bf16 is part of the result. Returns ``(q_hat, k, v)``."""
    if not q.dim() == k.dim() == v.dim() == 4:
        raise ValueError(
            f"expected (S, H, D) or (B, S, H, D) tensors, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or v.shape[0] != b:
        raise ValueError(f"batch mismatch: {q.shape}, {k.shape}, {v.shape}")
    if k.shape[-1] != d:
        raise ValueError(f"q/k head_dim mismatch: {q.shape} vs {k.shape}")
    if k.shape[1:3] != v.shape[1:3]:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    hk = k.shape[2]
    if h % hk:
        raise ValueError(
            f"GQA needs kv_heads ({hk}) to divide heads ({h})")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError(f"empty sequence: q {q.shape}, k {k.shape}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pdt = torch.promote_types(q.dtype, torch.float32)
    q_hat = (q.to(pdt) * (scale * _LOG2E)).to(q.dtype)
    return q_hat, k, v


def flash_attention_reference(q_hat, k, v, causal: bool = False,
                              window: int = 0):
    """The plain version, on an already-prescaled ``q_hat`` and batched
    (B, S, H, D) tensors: the same base-2 softmax, the same -1e30 masks,
    GQA by index (a reshape, K/V never replicated), returning ``(O in
    q's dtype, lse (B, H, Sq) f32)``. It materialises the logits: it
    exists for tests and as the kernel's yardstick of correctness."""
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    cdt = torch.promote_types(q_hat.dtype, torch.float32)
    qg = q_hat.to(cdt).reshape(b, sq, hk, h // hk, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(cdt))
    qp = torch.arange(sq, device=q_hat.device)[:, None]
    kp = torch.arange(skv, device=q_hat.device)[None, :]
    if causal:
        mask = kp <= qp
        if window:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(cdt))
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log2(l))[..., 0].reshape(b, h, sq)
    return o.reshape(b, sq, h, dv).to(q_hat.dtype), lse.float()


def flash_attention_bwd_reference(q_hat, k, v, o, lse, do,
                                  causal: bool = False, window: int = 0,
                                  scale: Optional[float] = None):
    """The plain backward, on the prescaled ``q_hat`` the forward saw and
    batched (B, S, H, D) tensors: the JAX package's ``_flash_bwd_pallas``
    and ``_bwd_p_ds`` written out. Delta = rowsum(dO * O) in f32;
    p = exp2(q_hat k^T - lse) under the same -1e30 masks;
    dS = p * (dO v^T - Delta); dQ = scale * dS K; dK = ln2 * dS^T q_hat;
    dV = p^T dO; GQA by a (Hk, group) reshape, summed over the group.
    Returns ``(dQ, dK, dV)`` in the dtypes of q, k and v. It materialises
    the (Sq, Skv) tiles: it exists for tests and as the kernels' yardstick
    of correctness."""
    return _bwd_reference(q_hat, k, v, do, lse, _delta(do, o), causal,
                          window, scale)


def _bwd_reference(q_hat, k, v, do, lse, delta, causal: bool, window: int,
                   scale: Optional[float]):
    """:func:`flash_attention_bwd_reference` from Delta (B, H, Sq) f32
    instead of O: the plain twin of :func:`_launch_bwd`, with its
    arguments."""
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hk
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    cdt = torch.promote_types(q_hat.dtype, torch.float32)
    qg = q_hat.to(cdt).reshape(b, sq, hk, group, d)
    dog = do.to(cdt).reshape(b, sq, hk, group, dv)
    kf, vf = k.to(cdt), v.to(cdt)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
    if causal:
        qp = torch.arange(sq, device=q_hat.device)[:, None]
        kp = torch.arange(skv, device=q_hat.device)[None, :]
        mask = kp <= qp
        if window:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp2(s - lse.to(cdt).reshape(b, hk, group, sq, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - delta.to(cdt).reshape(b, hk, group, sq, 1))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * (1.0 / _LOG2E)
    dvv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(b, sq, h, d).to(q_hat.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.marlin_flash_attention_fwd
    if fn.argtypes is None:  # c_void_p, or ctypes would cut pointers to int
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    dq, dkv = (lib.marlin_flash_attention_bwd_dq,
               lib.marlin_flash_attention_bwd_dkv)
    if dq.argtypes is None:
        dq.restype = dkv.restype = ctypes.c_int
        dq.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        dkv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _check_launch(tensors: dict, d: int, dv: int,
                  stats: Optional[dict] = None) -> None:
    """Raise on anything the kernels do not take: ``tensors`` of a dtype
    other than bf16 or f32 or of several dtypes, ``stats`` (lse, Delta)
    not f32, head dims the kernels are not built for, a tensor that is
    not CUDA or not contiguous, a bf16 tensor whose base is not 16-byte
    aligned (TMA reads it), several devices, a card that is not Hopper."""
    stats = stats or {}
    first = next(iter(tensors.values()))
    if first.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the kernel takes bf16 or f32, got {first.dtype}")
    if _kernel_head_dims(d, dv) != (d, dv):
        raise ValueError(
            f"the kernel is built for head dims {KERNEL_HEAD_DIMS} (256 only "
            f"with 256), got D={d}, Dv={dv}")
    every = {**tensors, **stats}
    for name, x in every.items():
        want = torch.float32 if name in stats else first.dtype
        if x.dtype != want:
            raise ValueError(f"{name} is {x.dtype}, the kernel takes {want}")
    for name, x in tensors.items():
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(
                f"{name}'s base address is not 16-byte aligned, which the "
                f"kernels' TMA loads need (a view at an odd offset?)")
    for name, x in every.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != first.device:
            raise ValueError("the kernel's tensors must be on one device")
    if not is_sm90(first.device):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(first.device)} is not one")


def _check_err(err: int, what: str, b, sq, skv, h, hk, d, dv) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaError_t {err} (B={b}, Sq={sq}, "
            f"Skv={skv}, H={h}, Hk={hk}, D={d}, Dv={dv})")


def _launch(q_hat, k, v, causal: bool, window: int):
    """Run the forward kernel on batched (B, S, H, D) tensors. Checks what
    the kernel takes and raises on anything else."""
    global launches
    lib = _kernel_lib()
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    _check_launch({"q": q_hat, "k": k, "v": v}, d, dv)
    o = torch.empty((b, sq, h, dv), dtype=q_hat.dtype, device=q_hat.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q_hat.device)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_attention_fwd(
            _KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, hk, sq, skv,
            d, dv, int(causal), int(window), stream)
    _check_err(err, "flash_attention_fwd", b, sq, skv, h, hk, d, dv)
    launches += 1
    return o, lse


def _bwd_setup(q_hat, k, v, do, lse, delta):
    """The backward library and the dims (B, Sq, H, D, Skv, Hk, Dv) of
    batched inputs, after checking every shape, dtype and device the
    kernels read."""
    lib = _bwd_lib()
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    shapes = {"k": (k.shape, (b, skv, hk, d)),
              "v": (v.shape, (b, skv, hk, dv)),
              "do": (do.shape, (b, sq, h, dv)),
              "lse": (lse.shape, (b, h, sq)),
              "delta": (delta.shape, (b, h, sq))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} has shape {tuple(got)}, expected "
                             f"{want} for q_hat {tuple(q_hat.shape)}")
    if h % hk:
        raise ValueError(f"GQA needs kv_heads ({hk}) to divide heads ({h})")
    _check_launch({"q_hat": q_hat, "k": k, "v": v, "do": do}, d, dv,
                  {"lse": lse, "delta": delta})
    return lib, (b, sq, h, d, skv, hk, dv)


def _launch_bwd_dq(q_hat, k, v, do, lse, delta, causal: bool, window: int,
                   scale: float):
    """Run the dQ kernel (B4): dQ in q's dtype, (B, Sq, H, D)."""
    global bwd_dq_launches
    lib, (b, sq, h, d, skv, hk, dv) = _bwd_setup(q_hat, k, v, do, lse,
                                                 delta)
    dq = torch.empty_like(q_hat)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_attention_bwd_dq(
            _KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, hk, sq, skv, d, dv, int(causal),
            int(window), float(scale), stream)
    _check_err(err, "flash_attention_bwd_dq", b, sq, skv, h, hk, d, dv)
    bwd_dq_launches += 1
    return dq


def _launch_bwd_dkv(q_hat, k, v, do, lse, delta, causal: bool,
                    window: int):
    """Run the dK/dV kernel (B5): (dK, dV) in k's dtype, summed over each
    KV head's group of query heads."""
    global bwd_dkv_launches
    lib, (b, sq, h, d, skv, hk, dv) = _bwd_setup(q_hat, k, v, do, lse,
                                                 delta)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_attention_bwd_dkv(
            _KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), b, h, hk, sq, skv, d, dv,
            int(causal), int(window), stream)
    _check_err(err, "flash_attention_bwd_dkv", b, sq, skv, h, hk, d, dv)
    bwd_dkv_launches += 1
    return dk, dvv


def _delta(do, o):
    """Delta = rowsum(dO * O) in f32, (B, H, Sq): one f32 copy of dO
    multiplied by O in place, then summed (the JAX package leaves this to
    XLA, outside any kernel)."""
    return (do.to(torch.float32, copy=True).mul_(o).sum(-1)
            .transpose(1, 2).contiguous())


def _launch_bwd(q_hat, k, v, do, lse, delta, causal: bool, window: int,
                scale: float):
    """Both backward kernels: ``(dQ, dK, dV)``."""
    dq = _launch_bwd_dq(q_hat, k, v, do, lse, delta, causal, window, scale)
    dk, dvv = _launch_bwd_dkv(q_hat, k, v, do, lse, delta, causal, window)
    return dq, dk, dvv


def _kernel_head_dim(width: int, name: str) -> int:
    """The smallest entry of :data:`KERNEL_HEAD_DIMS` that holds a head
    dim of ``width``; raises above the largest."""
    for kernel_width in KERNEL_HEAD_DIMS:
        if width <= kernel_width:
            return kernel_width
    raise ValueError(
        f"{name}={width}: the kernels are built for head dims up to "
        f"{KERNEL_HEAD_DIMS[-1]}; the reference pads {name} above 256 to "
        f"the next multiple of 128, which has no kernel (ROADMAP Queue C, "
        f"C4)")


def _kernel_head_dims(d: int, dv: int) -> Tuple[int, int]:
    """The kernel head dims ``(D, Dv)`` that hold ``(d, dv)``: each the
    smallest of 64 and 128 that holds it, or both 256 when either is above
    128 (the only instantiation at 256 is D = Dv = 256). Raises above
    256."""
    dp, dvp = _kernel_head_dim(d, "D"), _kernel_head_dim(dv, "Dv")
    if max(dp, dvp) > 128:
        return 256, 256
    return dp, dvp


def _pad_to(x, width: int):
    """``x`` with its last dimension zero-padded to ``width`` (``x``
    itself when it is that wide already)."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _padded_fwd(fwd, q_hat, k, v, causal: bool, window: int):
    """``fwd`` (the forward kernel's launch or the plain version) on
    q_hat and K zero-padded to the kernel head dim of D and V to that of
    Dv, and O sliced back to Dv. Zero columns add nothing to q_hat K^T or
    P V, so ``(O, lse)`` is the unpadded function's."""
    d, dv = q_hat.shape[-1], v.shape[-1]
    dp, dvp = _kernel_head_dims(d, dv)
    o, lse = fwd(_pad_to(q_hat, dp), _pad_to(k, dp), _pad_to(v, dvp),
                 causal, window)
    return o[..., :dv].contiguous(), lse


def _padded_bwd(bwd, q_hat, k, v, do, lse, delta, causal: bool,
                window: int, scale: float):
    """``bwd`` (:func:`_launch_bwd` or its plain twin
    :func:`_bwd_reference`) on q_hat and K zero-padded as in
    :func:`_padded_fwd`, V and dO to the kernel head dim of Dv, and dQ,
    dK, dV sliced back. ``scale`` is the unpadded D's (the caller's);
    Delta = rowsum(dO * O) is the same with or without zero columns."""
    d, dv = q_hat.shape[-1], v.shape[-1]
    dp, dvp = _kernel_head_dims(d, dv)
    dq, dk, dvv = bwd(_pad_to(q_hat, dp), _pad_to(k, dp), _pad_to(v, dvp),
                      _pad_to(do, dvp), lse, delta, causal, window, scale)
    return (dq[..., :d].contiguous(), dk[..., :d].contiguous(),
            dvv[..., :dv].contiguous())


def _forward(q_hat, k, v, causal: bool, window: int):
    """``(O, lse)`` on batched tensors: the plain version for CPU tensors,
    the kernel at its head dims (or an error) for any other."""
    if q_hat.device.type == "cpu":
        return flash_attention_reference(q_hat, k, v, causal, window)
    return _padded_fwd(_launch, q_hat.contiguous(), k.contiguous(),
                       v.contiguous(), causal, window)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on batched (B, S, H, D) tensors: the
    counterpart of the JAX package's ``_flash_hsd`` custom_vjp. The
    forward runs the forward kernel (the plain version on the CPU) and
    saves only ``(q_hat, k, v, o, lse)``, unpadded; the backward computes
    Delta with one torch op and runs the dQ and dK/dV kernels on inputs
    padded again to the kernel head dims (the plain backward on the CPU).
    Returns ``(O, lse)``; lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        q_hat, k, v = (x.contiguous() for x in
                       _prepare(q, k, v, causal, scale, window))
        o, lse = _forward(q_hat, k, v, causal, window)
        ctx.save_for_backward(q_hat, k, v, o, lse)
        ctx.causal, ctx.window = bool(causal), int(window)
        ctx.scale = (1.0 / math.sqrt(q.shape[-1]) if scale is None
                     else float(scale))
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q_hat, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # autograd may hand over a strided gradient
        if q_hat.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(
                q_hat, k, v, o, lse, do, ctx.causal, ctx.window, ctx.scale)
        else:
            dq, dk, dv = _padded_bwd(_launch_bwd, q_hat, k, v, do, lse,
                                     _delta(do, o), ctx.causal, ctx.window,
                                     ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: O = softmax(Q K^T * scale) V in q's dtype and the
    per-row log2-sum-exp (B, H, Sq) f32 (without a batch dimension: O
    (Sq, H, Dv), lse (H, Sq)). CPU tensors take the plain versions; CUDA
    tensors take the kernels or raise. Differentiable in q, k and v
    through :class:`FlashAttentionFunction` when grad is enabled and one
    of them requires grad; otherwise a direct call (one forward launch,
    nothing saved)."""
    if q.dim() == 3 and k.dim() == 3 and v.dim() == 3:
        o, lse = flash_attention_fwd(q[None], k[None], v[None], causal,
                                     scale, window)
        return o[0], lse[0]
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, window)
    q_hat, k, v = _prepare(q, k, v, causal, scale, window)
    return _forward(q_hat, k, v, causal, window)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, window: int = 0
                    ) -> torch.Tensor:
    """softmax(Q K^T * scale) V, flash-tiled: the counterpart of
    ``marlin_tpu.ops.flash_attention.flash_attention``, forward and
    backward.

    Shapes: (S, H, D) or (B, S, H, D); K/V lengths may differ from Q's
    (cross attention), K/V may carry fewer heads (GQA/MQA: Hk divides H,
    q-head h reads K/V head h // (H // Hk)), and V's head dim may differ
    from D. ``window`` > 0 (requires ``causal``) restricts each query to
    the last ``window`` key positions."""
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]
