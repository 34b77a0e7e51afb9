"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Port of ``marlin_tpu/ops/flash_attention.py`` (forward only). The Pallas
TPU kernel ``_kernel`` becomes the CUDA C++ kernel in
``csrc/flash_attention_fwd.cu`` (mma.sync bf16 tensor-core tiles for
bf16, an FMA kernel for f32); the TPU's block constants and VMEM clamps
(``DEFAULT_BLOCK_Q/K``, ``effective_blocks``, ``window_block_clamp``) do
not carry over, since the CUDA kernel picks its own tiles and masks the
ragged edges itself.

Dispatch: :func:`flash_attention_fwd` runs the plain version,
:func:`flash_attention_reference`, for CPU tensors and the kernel for CUDA
tensors. There is no fallback: on the card, a kernel that cannot be
built or launched raises.

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

# Head dims the kernel is instantiated for (template arguments D and Dv).
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches since the last reset (chip_smoke.py zeroes and reads it
# to prove the serving path ran through the kernel).
launches = 0


def _prepare(q, k, v, causal: bool, scale: Optional[float], window: int):
    """Validate shapes and options, add the batch dimension, and fold
    ``scale * log2(e)`` into Q in >= f32 and round it back to Q's dtype —
    the TPU kernel's prescale (``_flash_hsd_impl``), whose rounding at
    bf16 is part of the result."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(
            f"expected (S, H, D) or (B, S, H, D) tensors, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    batched = q.dim() == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
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
    return q_hat, k, v, batched


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


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.marlin_flash_attention_fwd
    if fn.argtypes is None:  # c_void_p, or ctypes would cut pointers to int
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _launch(q_hat, k, v, causal: bool, window: int):
    """Run the CUDA kernel on batched (B, S, H, D) tensors. Checks what
    the kernel takes and raises on anything else."""
    global launches
    lib = _kernel_lib()
    if q_hat.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"the kernel takes bf16 or f32, got {q_hat.dtype}")
    b, sq, h, d = q_hat.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if d not in KERNEL_HEAD_DIMS or dv not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the kernel is built for head dims {KERNEL_HEAD_DIMS}, got "
            f"D={d}, Dv={dv}")
    for name, x in (("q", q_hat), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q_hat.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not is_sm90(q_hat.device):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(q_hat.device)} is not one")
    o = torch.empty((b, sq, h, dv), dtype=q_hat.dtype, device=q_hat.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q_hat.device)
    with torch.cuda.device(q_hat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.marlin_flash_attention_fwd(
            _KERNEL_DTYPES[q_hat.dtype], q_hat.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, hk, sq, skv,
            d, dv, int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: cudaError_t {err} "
            f"(B={b}, Sq={sq}, Skv={skv}, H={h}, Hk={hk}, D={d}, Dv={dv})")
    launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: O = softmax(Q K^T * scale) V in q's dtype and the
    per-row log2-sum-exp (B, H, Sq) f32 (without a batch dimension: O
    (Sq, H, Dv), lse (H, Sq)). CPU tensors take the plain version; CUDA
    tensors take the kernel or raise."""
    q_hat, k, v, batched = _prepare(q, k, v, causal, scale, window)
    if q_hat.device.type == "cpu":
        o, lse = flash_attention_reference(q_hat, k, v, causal, window)
    else:
        o, lse = _launch(q_hat.contiguous(), k.contiguous(),
                         v.contiguous(), causal, window)
    return (o, lse) if batched else (o[0], lse[0])


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, window: int = 0
                    ) -> torch.Tensor:
    """softmax(Q K^T * scale) V, flash-tiled: the counterpart of
    ``marlin_tpu.ops.flash_attention.flash_attention`` (forward).

    Shapes: (S, H, D) or (B, S, H, D); K/V lengths may differ from Q's
    (cross attention), K/V may carry fewer heads (GQA/MQA: Hk divides H,
    q-head h reads K/V head h // (H // Hk)), and V's head dim may differ
    from D. ``window`` > 0 (requires ``causal``) restricts each query to
    the last ``window`` key positions."""
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]
