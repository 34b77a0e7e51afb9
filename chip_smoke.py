#!/usr/bin/env python3
"""Drive the PyTorch port (marlin_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # every phase below
    python3 chip_smoke.py --planted-faults   # the kernel checks' teeth
    python3 chip_smoke.py --compare-with DIR # dQ and SpMM against DIR's

Phases, each of which exits non-zero on failure:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile every CUDA kernel of the port from csrc/ (one nvcc per
   source, started together) and print the build time and ptxas report.
3. Forward kernel vs plain: hold the flash-attention forward kernel
   against its plain PyTorch version on the card at every shape the main
   path gives it (the served prefill, the training step's B=8 S=2048,
   the remat step's S=8192 MHA) and the edge cases (ragged, MHA, MQA,
   cross lengths with Dv != D, window, D=64, and head dims the wrapper
   zero-pads to the kernel's: D=32 with Dv=16 and D=96, bf16 and f32;
   f32), by max |err| of O and lse and by O's worst 64-row tile
   (tile_rel_err); time the kernel warm and with a cold L2, the plain
   version, torch's scaled_dot_product_attention (a yardstick the port
   never calls; median of 5 repeats) and the roofline bound.
4. Backward kernels vs plain: the dQ and dK/dV kernels against the plain
   backward at the training step's and the remat step's shapes and the
   same edge cases, per 64-position tile (tile_rel_err), after holding
   the forward's O and lse that they read against the plain forward;
   times, bounds and the backward of scaled_dot_product_attention as the
   yardstick (median of 5 repeats of 10 calls, spread printed), dQ and
   dK/dV also with a cold L2; dQ and dK/dV each bitwise equal over two
   runs; and one
   backward at S=8192 that allocates no more than its inputs, outputs,
   lse/Delta and a stated slack (no (S, S) buffer).
5. Serve: the flagship transformer (vocab 32768, d_model 1024, 8 heads, 2
   KV heads, 8 layers, d_ff 4096, max_len 2048, RoPE, bf16; random
   weights from a seed) with ServingEngine(batch=8, round_steps=8): 16
   requests with prompts of 64-1536 tokens and 32 steps each, in two
   waves. Check every request against the port's own B=1 generate, and
   that the flash kernel ran exactly once per layer per admission (its
   launch counter is zeroed just before the run and read just after).
6. Train: the same flagship, bf16 compute on f32 master params, B=8,
   S=2048, SGD at lr 0.1: one warm-up train_step, then 5 timed steps on
   one fixed batch. Every loss finite, the last below the first, and the
   forward, dQ and dK/dV kernels each launched exactly layers x steps
   (counters zeroed just before, read just after). Then one remat step
   at the long-context shape (S=8192, B=1, vocab 16384), whose forward
   runs twice per layer, and a profiled flagship step. Then the models
   of small head dim, 5 steps each at f32 and bf16: the CPU tests'
   training model (d_model 64, 4 heads: D=16) and the example's default
   model at the reference's head count (d_model 64, 2 heads: D=32), each
   loss finite and falling and each flash kernel launched layers x steps.
7. Card against CPU: full width, 2 layers, B=1, S=512, f32: loss_fn and
   every gradient leaf on the card (the f32 kernels) against the same
   call on the CPU (the plain versions), TF32 off.
8. SpMM kernels vs plain (run after phase 4): the gather and the
   masked-grid routes' block-sparse GEMM kernels against the plain
   version, per 64 x 64 output tile (tile_rel_err_2d), at the main path's
   two shapes (n = 8192 at block sizes 512 and 128, 12% of the blocks
   live), the sparse bench's oracle shape and the edge cases (ragged M,
   K != N, block size 64, an all-zero mask, an empty block column held
   bitwise 0, a full mask, one full column among empty ones, f32, and
   grids past 65535 tiles in M and in N, bf16 and f32, with their peak
   memory), on a backing array that is not zeroed under dead blocks; the
   two routes bitwise equal to each other; times warm and with a cold L2,
   the bound and one dense torch.matmul as the yardstick.
9. Block-sparse GEMM path at the sparse bench configuration's size
   (n = 8192, bf16, nothing cut): BlockSparse(data, mask, 512), and COO
   triples -> SparseVecMatrix.from_coo -> to_block_sparse() at block size
   128 with the drawn mask recovered; 8 products each through
   block_sparse_matmul, the result held against the plain version, the
   gather kernel launched exactly once per product (counters zeroed just
   before, read just after). Then the masked-grid path: one CUDA graph of
   the product with the mask on the card, replayed, and replayed after
   the mask and data were overwritten. Then gradients in A and B against
   the plain version's autograd (dB exactly 0 outside the mask) and a
   small f32 card-against-CPU check.
10. Dense GEMM (the paper's main path; BASELINE.md's MatrixMultiply, the
   JAX package's headline bench config): random_den_vec_matrix operands
   at N = 32768, bf16, on a one-rank NCCL mesh made by create_mesh() with
   no process group beforehand; DenseVecMatrix.multiply by auto-dispatch,
   then forced broadcast, summa, cannon, gspmd and the (1, 1, 1) grid; for
   each, a band of 256 rows of C against an f64 product of the same rows
   on the card (GEMM_REL_TOLERANCE); then ms, TFLOP/s and the share of
   the bf16 peak over 3 timed products a run, in two rounds of opposite
   order, the SM clock and power after each; peak memory; no
   hand-written kernel launched.

Phases 3 and 4 also take head dims in (128, 256] (D = 160, the transformer
bench at BENCH_TF_D=320, and D = 256; bf16 and f32), which the wrapper
pads to the kernels' D = Dv = 256 instantiations, with dK/dV bitwise
repeatable there too; phase 6's small models include a D = 160 and a
D = 256 model, trained through those instantiations.

The last three lines of output are the card line from nvidia-smi, one
{"kernels": [...]} JSON object, and {"ok": true, "device": {...}}.

With ``--planted-faults`` it runs phase 1, then builds the forward source
with each fault of FWD_PLANTED_FAULTS, the backward source with each fault
of PLANTED_FAULTS and the SpMM source with each fault of
SPMM_PLANTED_FAULTS into a temporary directory and prints, at every bf16
shape of the forward, backward and SpMM checks, the sound kernels' and
each fault's reading of the check; it fails unless the check's limit
separates them.

With ``--compare-with DIR`` it runs phase 1, then builds DIR's backward and
SpMM sources (another checkout, e.g. the parent commit unpacked by ``git
archive``) and this tree's KERNEL_VARIANTS, holds each against the plain
version and times dQ at the train and remat shapes and both SpMM routes
at bench512 and coo128, warm and cold, in two rounds in opposite orders.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES = 3.35e12

# Flagship serving configuration: README Quick start, benchlib decode bench.
FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
                n_layers=8, d_ff=4096, max_len=2048, rope=True,
                dtype="bfloat16")

# Kernel-vs-plain shapes: (name, B, Sq, Skv, H, Hk, D, Dv, dtype, causal,
# window). The main path's shapes: "flagship" is the served model's
# full-length prefill, "train" the flagship training step's attention
# (B=8, S=2048) and "remat" the long-context remat step's (B=1, S=8192,
# MHA); the rest are edge cases ("d32_dv16" and "d96" take the wrapper's
# zero-padding to the kernel head dims, 64 and 128).
SHAPES = [
    ("flagship", 1, 2048, 2048, 8, 2, 128, 128, "bfloat16", True, 0),
    ("train", 8, 2048, 2048, 8, 2, 128, 128, "bfloat16", True, 0),
    ("remat", 1, 8192, 8192, 8, 8, 128, 128, "bfloat16", True, 0),
    ("ragged", 1, 1000, 1000, 8, 2, 128, 128, "bfloat16", True, 0),
    ("mha", 1, 1024, 1024, 8, 8, 128, 128, "bfloat16", True, 0),
    ("mqa", 1, 1024, 1024, 8, 1, 128, 128, "bfloat16", True, 0),
    ("cross_dv64", 1, 384, 1000, 8, 2, 128, 64, "bfloat16", False, 0),
    ("window256", 1, 2048, 2048, 8, 2, 128, 128, "bfloat16", True, 256),
    ("d64", 2, 1024, 1024, 8, 2, 64, 64, "bfloat16", True, 0),
    ("d32_dv16", 2, 1024, 1024, 8, 2, 32, 16, "bfloat16", True, 0),
    ("d96", 2, 1024, 1024, 8, 2, 96, 96, "bfloat16", True, 0),
    ("f32", 1, 1000, 1000, 8, 2, 128, 128, "float32", True, 0),
    ("d32_dv16_f32", 1, 1000, 1000, 8, 2, 32, 16, "float32", True, 0),
    ("d96_f32", 1, 1000, 1000, 8, 2, 96, 96, "float32", True, 0),
    # Head dims in (128, 256], which the wrapper zero-pads to the kernels'
    # D = Dv = 256: the transformer bench at BENCH_TF_D=320 (2 heads of
    # D=160, B=8, S=2048) and D=256 itself, bf16 and f32.
    ("d160", 8, 2048, 2048, 2, 2, 160, 160, "bfloat16", True, 0),
    ("d256", 2, 2048, 2048, 4, 2, 256, 256, "bfloat16", True, 0),
    ("d160_f32", 1, 1000, 1000, 2, 1, 160, 160, "float32", True, 0),
    ("d256_f32", 1, 1000, 1000, 4, 2, 256, 256, "float32", True, 0),
]

# The shapes whose kernels are the D = Dv = 256 instantiations.
WIDE_SHAPES = ("d160", "d256", "d160_f32", "d256_f32")

# Backward shapes: the training paths' two and the same edge cases.
BWD_SHAPES = [s for s in SHAPES if s[0] != "flagship"]

# Backward tolerance by dtype, on the worst 64-position tile's relative
# Frobenius error ||kernel - plain||_F / ||plain||_F (tile_rel_err), for
# each of dQ, dK and dV. A global max |kernel - plain| / max |plain| is
# blind to the small gradients: under causal attention dK and dV of the
# last keys are ~1e-3 of those of the first, so a dropped tile there moves
# the global ratio by less than bf16 noise. Per tile, a dropped key or
# query tile costs its tiles a whole share of their norm. bf16: the
# kernels round P and dS to bf16 before their products (the plain
# backward keeps them f32; 2^-9 relative per term) and both sides round
# the gradients to bf16 (2^-9 relative per value). The limit sits between
# the sound kernels' reading and the readings of planted faults
# (``--planted-faults``; both in PERF.md). f32: FMA in full f32 (no TF32)
# against the plain version's f32 einsums, so only summation order
# differs.
BWD_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}
TILE = 64  # positions per tile of tile_rel_err (the backward kernels' tile)

# The forward's O held per 64-row tile by the same measure and limits
# (besides TOLERANCE's max |err|): under causal attention a wrong key tile
# moves O of a few rows only, and a dropped one leaves the first query
# tile with no key at all. bf16: P rounded to bf16 before P V and O
# rounded to bf16, as for the max |err| limit; f32: summation order only.
FWD_TILE_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}

# Planted faults of the forward: edits of csrc/flash_attention_fwd.cu (the
# first occurrence of the text, in the bf16 kernel), built like
# PLANTED_FAULTS below. The forward check must pass the sound kernel and
# fail every fault at every bf16 forward shape.
FWD_PLANTED_FAULTS = {
    # Every query tile's key sweep stops one key tile short.
    "fwd_drops_last_key_tile": (
        "  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;\n",
        "  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN - 1 : 0;\n"),
    # O is not rescaled when a row's running max grows.
    "fwd_skips_o_rescale": (
        "    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];\n",
        "    for (int i = 0; i < 0; ++i) acc[i] *= corr[(i >> 1) & 1];\n"),
    # D = 256 only: O's columns 128..255 take P times V's first 128
    # columns (the second n128 product reads the first half's boxes).
    "fwd256_second_half_reads_first_v_half": (
        "                           v_base + 2 * L::kKvBox + kc * 16 * 128,\n",
        "                           v_base + kc * 16 * 128,\n"),
}

# Planted faults of the backward (``python3 chip_smoke.py
# --planted-faults``): each is one edit of csrc/flash_attention_bwd.cu
# (the first occurrence of the text, in the bf16 kernels), built into a
# temporary directory outside the checkout. The backward check must pass
# the sound kernels and fail every fault at every bf16 backward shape.
PLANTED_FAULTS = {
    # Every query tile's key sweep in the dQ kernel stops one key tile
    # short (the producer and the consumers agree on the shorter sweep, so
    # no load is left in flight).
    "dq_drops_last_key_tile": (
        "  const int n_tiles = hi > lo ? (hi - lo + kDqBN - 1) / kDqBN : 0;\n",
        "  const int n_tiles = hi > lo ? (hi - lo + kDqBN - 1) / kDqBN - 1 : 0;"
        "\n"),
    # dQ += dS K reads the K stage as the K-major B (transpose flag 0)
    # instead of the MN-major one: the new design's own risk, a wrong
    # descriptor that still reads inside the stage.
    "dq_reads_k_as_k_major": (
        "      sm90::wgmma_rs_mn<1>(dqa, da[kc], k_base + kc * 16 * 128,\n",
        "      sm90::wgmma_rs_mn<0>(dqa, da[kc], k_base + kc * 16 * 128,\n"),
    # D = 256 only: dQ's columns 128..255 take dS times K's first 128
    # columns.
    "dq256_second_half_reads_first_k_half": (
        "                           k_base + 2 * kDqBox + kc * 16 * 128, "
        "kDqBox);\n",
        "                           k_base + kc * 16 * 128, kDqBox);\n"),
    # The dK/dV kernel's sweep of each query head stops one query tile
    # short.
    "dkv_drops_last_query_tile": (
        "  const int n_qt = hi > lo ? (hi - lo) / kDkvBM : 0;  "
        "// per query head\n",
        "  const int n_qt = hi > lo ? (hi - lo) / kDkvBM - 1 : 0;  "
        "// per query head\n"),
    # The dK/dV kernel's last key tile accumulates nothing.
    "dkv_drops_last_key_tile": (
        "  const int n_stages = group * n_qt;\n",
        "  const int n_stages = n0 + kDkvBN >= Skv ? 0 : group * n_qt;\n"),
    # D = 256 only: the CTA of the second column share accumulates the
    # first share's columns of q_hat and dO (into its own columns of dK
    # and dV), as if the split had dropped the second half.
    "dkv256_second_share_reads_first_columns": (
        "  const uint32_t q_share = share * (DO / 64) * kDkvBox;\n"
        "  const uint32_t o_share = share * (DVO / 64) * kDkvBox;\n",
        "  const uint32_t q_share = 0;\n"
        "  const uint32_t o_share = 0;\n"),
}

# The planted faults of the flash kernels that only the D = Dv = 256
# instantiation runs: a shape of another width must read them as sound.
WIDE_FAULTS = ("fwd256_second_half_reads_first_v_half",
               "dq256_second_half_reads_first_k_half",
               "dkv256_second_share_reads_first_columns")


def flash_fault_shows(fault: str, shape: str) -> bool:
    """Whether planted flash fault ``fault`` can show at ``shape``: a
    fault of the D = 256 instantiation at the WIDE_SHAPES only, every
    other one at every shape."""
    return fault not in WIDE_FAULTS or shape in WIDE_SHAPES

# Card against CPU, the model's gradients at f32: the worst leaf's
# max |card - cpu| / max |cpu|. Both sides run f32 arithmetic (TF32 off)
# in different orders (cuBLAS and the FMA kernels against CPU GEMMs and
# the plain einsums) through 2 layers and a 32768-wide readout; 1e-4 is
# ~1000 f32 ulps of the largest gradient of each leaf.
GRAD_TOLERANCE = 1e-4

# Training configuration: the flagship at the train bench's precision
# (benchlib/configs_ml.py config_transformer) and the long-context bench's
# remat step (config_longseq: S=8192, B=1, vocab 16384, RoPE, MHA).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 5
LONG = dict(vocab=16384, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
            max_len=8192, rope=True, remat=True, dtype="bfloat16")

# Tolerances of kernel vs plain version, by dtype: (O abs, lse abs).
# bf16: the kernel rounds P to bf16 before the P.V product (the plain
# version keeps P in f32), a relative error of 2^-9 per weight, and both
# round O to bf16 (one ulp of |O| ~ 1 is 7.8e-3); lse differs only by
# the f32 summation order of exact bf16 products. f32: the kernel runs
# FMA in full f32 (no TF32) against cuBLAS f32, so only summation order
# differs (~1e-6 observed scale).
TOLERANCE = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-4)}


def cuda_ms_spread(fn, repeats: int = 5, iters: int = 10):
    """(median, min, max) over ``repeats`` of cuda_ms(fn, iters), after
    one warm-up: for a yardstick whose single reading wanders."""
    times = sorted(cuda_ms(fn, warmup=3 if i == 0 else 0, iters=iters)
                   for i in range(repeats))
    return times[len(times) // 2], times[0], times[-1]


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_FLUSH_BYTES = 256 << 20  # written between cold launches (L2: 50 MB)


def cuda_ms_cold(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms with a cold L2: before each launch,
    outside its timed window, a buffer of L2_FLUSH_BYTES is written, so
    the launch finds none of its inputs in the 50 MB L2. A pair of CUDA
    events around each launch; the host enqueues ahead of the device,
    since each write takes longer on the card than one iteration takes on
    the host."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    flush.fill_(1.0)  # a head start for the host
    pairs = []
    for i in range(iters):
        flush.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def live_pairs(sq, skv, causal, window) -> int:
    """The (q, k) pairs these inputs need: the causal triangle and the
    window band only."""
    pairs = 0
    for qp in range(sq):
        hi = min(qp + 1, skv) if causal else skv
        lo = max(0, qp - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return pairs


def attention_flops(b, sq, skv, h, d, dv, causal, window) -> float:
    """FLOPs of Q K^T and P V over the live (q, k) pairs."""
    return 2.0 * b * h * live_pairs(sq, skv, causal, window) * (d + dv)


def bound(flops, nbytes, dtype):
    """(bound ms, "operations" or "bytes"): the larger of FLOPs over the
    dtype's peak and bytes over the HBM rate."""
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def tile_rel_err(got, ref) -> float:
    """The worst tile's ||got - ref||_F / ||ref||_F over (B, S, H, D)
    tensors, a tile being TILE consecutive positions of one head of one
    batch row (the last tile of a ragged S is shorter)."""
    import torch.nn.functional as F

    b, s, h, d = ref.shape
    pad = (-s) % TILE

    def tiles(x):  # (B, T, H): squared norm of each tile
        x = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(b, -1, TILE, h, d)
        return x.square().sum(dim=(2, 4))

    num = tiles(got.float() - ref.float())
    den = tiles(ref.float())
    if bool((den == 0).any()):
        raise ValueError("tile_rel_err: a tile of the reference is all zero")
    return (num / den).max().sqrt().item()


def check_forward(label, o_k, lse_k, o_r, lse_r, dt):
    """Hold the forward kernel's (O, lse) against the plain version's at
    TOLERANCE[dt] and O's worst 64-row tile at FWD_TILE_TOLERANCE[dt];
    returns (max |O err|, max |lse err|, O's tile_rel_err)."""
    err_o = (o_k.float() - o_r.float()).abs().max().item()
    err_lse = (lse_k - lse_r).abs().max().item()
    tile_o = tile_rel_err(o_k, o_r)
    if not all(math.isfinite(x) for x in (err_o, err_lse, tile_o)):
        fail(f"{label}: non-finite output")
    tol_o, tol_lse = TOLERANCE[dt]
    if (err_o > tol_o or err_lse > tol_lse
            or tile_o > FWD_TILE_TOLERANCE[dt]):
        fail(f"{label}: |O - plain| = {err_o:.3e} (tol {tol_o}), "
             f"|lse - plain| = {err_lse:.3e} (tol {tol_lse}), O's worst "
             f"tile {tile_o:.3e} (tol {FWD_TILE_TOLERANCE[dt]})")
    return err_o, err_lse, tile_o


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"capability {torch.cuda.get_device_capability(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return card


def _kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name: the last of its nested
    length-prefixed names (the kernel, after its namespace) and its
    integer template arguments; the mangled name where it has no such
    form."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = None
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += len(name)
    if not name:
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'(\d+)', args.group(1)))}>"


def phase_build():
    from marlin_tpu_torch.ops import build

    t0 = time.perf_counter()
    res = build.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for name, info in res.items():
        print(f"build: {name} nvcc {info['seconds']:.1f} s -> "
              f"{info['path']}", flush=True)
        kernel, spill = "?", ""
        for line in info["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = _kernel_label(m.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"  ptxas: {kernel}: {line.split(':', 1)[-1].strip()}"
                      f"; {spill}")
            elif "error" in line or "arning" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: total {secs:.1f} s", flush=True)
    return secs


def phase_kernels():
    """Kernel vs plain at every shape; returns the rows by shape name."""
    import torch
    import torch.nn.functional as F

    from marlin_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for (name, b, sq, skv, h, hk, d, dv, dt, causal, window) in SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        k = torch.randn((b, skv, hk, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        v = torch.randn((b, skv, hk, dv), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)

        # Checked through the public wrapper; timed, like the plain
        # version, on the prescaled q_hat (the wrapper's prescale is an
        # elementwise pass over Q, not the kernel), with the zero-padding
        # of a head dim the kernel is not built for.
        q_hat, kk, vv = fa._prepare(q, k, v, causal, None, window)

        def kernel():
            return fa._forward(q_hat, kk, vv, causal, window)

        def plain():
            return fa.flash_attention_reference(q_hat, kk, vv, causal,
                                                window)

        o_k, lse_k = fa.flash_attention_fwd(q, k, v, causal, None, window)
        torch.cuda.synchronize()
        err_o, err_lse, tile_o = check_forward(f"kernel {name}", o_k, lse_k,
                                               *plain(), dt)
        ms = cuda_ms(kernel, iters=20)
        cold_ms = cuda_ms_cold(kernel, iters=10)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        lib_ms, lib_lo, lib_hi = library_ms(F, q, k, v, causal, window)
        # Bound: max(FLOPs / peak, bytes / HBM rate), reading Q, K, V once
        # and writing O and lse once.
        flops = attention_flops(b, sq, skv, h, d, dv, causal, window)
        bound_ms, bound_by = bound(flops, nbytes(q, k, v, o_k, lse_k), dtype)
        row = dict(shape=name, B=b, Sq=sq, Skv=skv, H=h, Hk=hk, D=d, Dv=dv,
                   dtype=dt, causal=causal, window=window,
                   max_abs_err=err_o, lse_max_abs_err=err_lse,
                   o_tile_rel_err=tile_o, ms=ms, cold_ms=cold_ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, library_ms_spread=[lib_lo, lib_hi],
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms,
                   tflops=flops / (ms * 1e-3) / 1e12)
        rows[name] = row
        print("kernel: " + json.dumps(row), flush=True)
    return rows


def library_ms(F, q, k, v, causal, window):
    """torch's scaled_dot_product_attention on the same inputs (the
    yardstick): (median, min, max) ms over 5 repeats of 20 calls; Nones
    where it does not take the case."""
    args = _sdpa_args(q, k, v, causal, window)
    if args is None:
        return None, None, None
    qt, kt, vt, kw = args
    try:
        return cuda_ms_spread(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw), iters=20)
    except (RuntimeError, TypeError) as e:  # the yardstick only
        print(f"  library: scaled_dot_product_attention unavailable for "
              f"this case: {e}")
        return None, None, None


def _sdpa_args(q, k, v, causal, window):
    """torch's scaled_dot_product_attention arguments for the same
    function (heads-first layout, GQA through enable_gqa, the window as a
    mask); None where it does not take the case (causal cross lengths)."""
    import torch

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = {"enable_gqa": q.shape[2] != k.shape[2]}
    sq, skv = q.shape[1], k.shape[1]
    if window:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        kw["attn_mask"] = (kp <= qp) & (kp > qp - window)
    elif causal:
        if sq != skv:
            return None
        kw["is_causal"] = True
    return qt, kt, vt, kw


def library_bwd_ms(F, q, k, v, do, causal, window):
    """The backward of torch's scaled_dot_product_attention on the same
    inputs (dQ, dK and dV in one call; the yardstick, never called by the
    port): (median, min, max) ms over 5 repeats of 10 calls after a
    warm-up, since a single reading of it wanders between runs; Nones
    where it does not take the case."""
    import torch

    args = _sdpa_args(q, k, v, causal, window)
    if args is None:
        return None, None, None
    qt, kt, vt, kw = args
    leaves = [x.detach().contiguous().requires_grad_(True)
              for x in (qt, kt, vt)]
    try:
        out = F.scaled_dot_product_attention(*leaves, **kw)
        dot = do.transpose(1, 2).contiguous()
        return cuda_ms_spread(lambda: torch.autograd.grad(
            out, leaves, dot, retain_graph=True), iters=10)
    except (RuntimeError, TypeError) as e:  # the yardstick only
        print(f"  library: scaled_dot_product_attention backward "
              f"unavailable for this case: {e}")
        return None, None, None


class BwdCase:
    """One backward shape's inputs on the card: random q, k, v and dO
    from ``gen``, the prescaled q_hat, the forward kernel's O and lse
    (held against the plain forward first, so a forward fault at this
    shape shows as one and not as a backward disagreement) and Delta;
    with the backward's call through the wrapper's padding (``kernels``),
    each kernel's call on inputs padded once ahead (``dq``, ``dkv``: the
    kernel's time alone) and the plain backward's call."""

    def __init__(self, gen, shape):
        import torch

        from marlin_tpu_torch.ops import flash_attention as fa

        (self.name, b, sq, skv, h, hk, d, dv, self.dt, self.causal,
         self.window) = shape
        self.fa = fa
        dtype = getattr(torch, self.dt)

        def randn(*dims):
            return torch.randn(dims, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        self.q, k, v = randn(b, sq, h, d), randn(b, skv, hk, d), randn(
            b, skv, hk, dv)
        self.do = randn(b, sq, h, dv)
        self.scale = 1.0 / math.sqrt(d)
        self.q_hat, self.k, self.v = fa._prepare(self.q, k, v, self.causal,
                                                 self.scale, self.window)
        self.o, self.lse = fa._forward(self.q_hat, self.k, self.v,
                                       self.causal, self.window)
        torch.cuda.synchronize()
        check_forward(f"backward {self.name}: forward", self.o, self.lse,
                      *fa.flash_attention_reference(
                          self.q_hat, self.k, self.v, self.causal,
                          self.window), self.dt)
        self.delta = fa._delta(self.do, self.o)
        self.d, self.dv = d, dv
        dp, dvp = fa._kernel_head_dims(d, dv)
        self.padded = (fa._pad_to(self.q_hat, dp), fa._pad_to(self.k, dp),
                       fa._pad_to(self.v, dvp), fa._pad_to(self.do, dvp))

    def kernels(self):
        return self.fa._padded_bwd(self.fa._launch_bwd, self.q_hat, self.k,
                                   self.v, self.do, self.lse, self.delta,
                                   self.causal, self.window, self.scale)

    def dq(self):
        return self.fa._launch_bwd_dq(*self.padded, self.lse, self.delta,
                                      self.causal, self.window,
                                      self.scale)[..., :self.d]

    def dkv(self):
        dk, dv = self.fa._launch_bwd_dkv(*self.padded, self.lse, self.delta,
                                         self.causal, self.window)
        return dk[..., :self.d], dv[..., :self.dv]

    def plain(self):
        return self.fa.flash_attention_bwd_reference(
            self.q_hat, self.k, self.v, self.o, self.lse, self.do,
            self.causal, self.window, self.scale)


def bwd_errors(got, ref):
    """For each of dQ, dK, dV: max |kernel - plain| ("max_abs"), that over
    max |plain| ("global_rel") and tile_rel_err ("tile_rel", the one the
    check holds to BWD_TOLERANCE)."""
    out = {}
    for label, a, r in zip(("dq", "dk", "dv"), got, ref):
        diff = (a.float() - r.float()).abs().max().item()
        out[label] = dict(max_abs=diff,
                          global_rel=diff / r.float().abs().max().item(),
                          tile_rel=tile_rel_err(a, r))
    return out


def phase_backward():
    """The dQ and dK/dV kernels against the plain backward at every
    backward shape; returns the rows by shape name."""
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for shape in BWD_SHAPES:
        c = BwdCase(gen, shape)
        name, dt = c.name, c.dt
        b, sq, h, d = c.q_hat.shape
        skv, hk, dv = c.k.shape[1], c.k.shape[2], c.v.shape[3]
        got = c.kernels()
        torch.cuda.synchronize()
        errs = bwd_errors(got, c.plain())
        for label, e in errs.items():
            rel = e["tile_rel"]
            if not math.isfinite(rel) or rel > BWD_TOLERANCE[dt]:
                fail(f"backward {name}: {label}'s worst tile "
                     f"||kernel - plain|| / ||plain|| = {rel:.3e} "
                     f"(tol {BWD_TOLERANCE[dt]})")
        if name in ("train", "d160", "d256"):
            # No atomics: two runs agree bit for bit.
            dq2, (dk2, dv2) = c.dq(), c.dkv()
            if not torch.equal(got[0], dq2):
                fail(f"backward {name}: dQ differs between two runs")
            if not (torch.equal(got[1], dk2) and torch.equal(got[2], dv2)):
                fail(f"backward {name}: dK/dV differ between two runs")
        ms_dq = cuda_ms(c.dq, iters=10)
        ms_dq_cold = cuda_ms_cold(c.dq, iters=10)
        ms_dkv = cuda_ms(c.dkv, iters=10)
        ms_dkv_cold = cuda_ms_cold(c.dkv, iters=10)
        plain_ms = cuda_ms(c.plain, warmup=1, iters=2)
        lib_ms, lib_lo, lib_hi = library_bwd_ms(F, c.q, c.k, c.v, c.do,
                                                c.causal, c.window)
        pairs = b * h * live_pairs(sq, skv, c.causal, c.window)
        # dQ: S, dP, dQ per live pair; dK/dV: S, dP, dV, dK. Bytes: every
        # input read once (q_hat, k, v, dO, lse, Delta), every output
        # written once.
        inputs = nbytes(c.q_hat, c.k, c.v, c.do, c.lse, c.delta)
        b_dq = bound(2.0 * pairs * (2 * d + dv), inputs + nbytes(got[0]),
                     c.q_hat.dtype)
        b_dkv = bound(2.0 * pairs * (2 * d + 2 * dv),
                      inputs + nbytes(got[1], got[2]), c.q_hat.dtype)
        row = dict(shape=name, B=b, Sq=sq, Skv=skv, H=h, Hk=hk, D=d, Dv=dv,
                   dtype=dt, causal=c.causal, window=c.window,
                   **{f"{k}_{m}_err": e[m] for k, e in errs.items()
                      for m in ("max_abs", "global_rel", "tile_rel")},
                   dq_ms=ms_dq, dq_cold_ms=ms_dq_cold, dkv_ms=ms_dkv,
                   dkv_cold_ms=ms_dkv_cold,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_ms_spread=[lib_lo, lib_hi],
                   dq_bound_ms=b_dq[0], dq_bound_by=b_dq[1],
                   dkv_bound_ms=b_dkv[0], dkv_bound_by=b_dkv[1],
                   dq_tflops=2.0 * pairs * (2 * d + dv) / ms_dq / 1e9,
                   dkv_tflops=2.0 * pairs * (2 * d + 2 * dv) / ms_dkv / 1e9)
        rows[name] = row
        print("backward: " + json.dumps(row), flush=True)
        del c, got
    return rows


# Planted faults of the SpMM kernels: each is one edit of
# csrc/block_sparse.cu. The SpMM check must pass the sound kernels and
# fail each fault at every bf16 SpMM shape where the fault can show
# (SPMM_FAULT_SHOWS).
SPMM_PLANTED_FAULTS = {
    # The gather route's walk stops one short of its column's list.
    "gather_drops_last_listed_block": (
        "      count = kcnt[j];\n",
        "      count = kcnt[j] - 1;\n"),
    # The ring kernel (both routes) multiplies only the first 48 of each
    # stage's 64 depth rows.
    "ring_skips_last_k16_of_a_stage": (
        "    for (int kc = 0; kc < kGBK / 16; ++kc)\n",
        "    for (int kc = 0; kc < kGBK / 16 - 1; ++kc)\n"),
    # The masked route takes every block for live, in its count and its
    # walk alike: it multiplies every block, live or dead.
    "masked_ignores_the_mask": (
        "    return list[(size_t)k * stride] != 0;\n",
        "    return true;\n"),
    # The masked route's count of its column's live blocks comes out one
    # short; the producer and the consumers agree on it, so the last live
    # block goes unmultiplied and no load is left in flight.
    "masked_count_stops_one_block_short": (
        "    return live;\n",
        "    return live - 1;\n"),
}

# The kernels each SpMM fault breaks and whether a case can show it: the
# faults of the list walk, the ring and the count wherever some block is
# live, the mask test wherever some block is dead (the check's backing
# array is not zeroed under dead blocks).
SPMM_FAULT_SHOWS = {
    "gather_drops_last_listed_block": (("gather",), lambda c: c.nnz > 0),
    "ring_skips_last_k16_of_a_stage": (("gather", "masked"),
                                       lambda c: c.nnz > 0),
    "masked_ignores_the_mask": (("masked",),
                                lambda c: c.nnz < c.mask.numel()),
    "masked_count_stops_one_block_short": (("masked",),
                                           lambda c: c.nnz > 0),
}


def _build_planted(sets, tmp, parent=None):
    """Build every fault of ``sets`` ({source name: {fault: edit}}, an
    edit being (old text, new text) or a list of them, each applied to its
    first occurrence) into ``tmp``, one nvcc per fault, all started
    together; with ``parent`` (another checkout's csrc directory), that
    checkout's source of each name too, as "parent". Returns {source name:
    {"sound": lib, fault: lib, ..., "parent": lib}}."""
    import ctypes
    from pathlib import Path

    from marlin_tpu_torch.ops import build

    build.build()
    procs = {}
    for name, faults in sets.items():
        source = build.SOURCES[name].read_text()
        for fault, edits in faults.items():
            text = source
            for old, new in [edits] if isinstance(edits, tuple) else edits:
                if old not in text:
                    fail(f"planted fault {fault}: its text is not in the "
                         f"source")
                text = text.replace(old, new, 1)
            src = Path(tmp) / f"{fault}.cu"
            src.write_text(text)
            lib = Path(tmp) / f"lib{fault}.so"
            procs[name, fault] = (lib, subprocess.Popen(
                build.nvcc_command(src, lib), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        if parent is not None:
            lib = Path(tmp) / f"lib{name}-parent.so"
            procs[name, "parent"] = (lib, subprocess.Popen(
                build.nvcc_command(Path(parent) / f"{name}.cu", lib,
                                   include=parent),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {name: {"sound": build.load(name)} for name in sets}
    for (name, fault), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"planted fault {fault}: nvcc failed:\n{log}")
        libs[name][fault] = ctypes.CDLL(str(lib))
    return libs


def _planted_forward(libs):
    """The forward check's reading of the sound kernel and of each fault
    at every bf16 forward shape (O's worst 64-row tile, with max |O err|
    beside it): (worst sound reading, whether the limit separated them at
    every shape)."""
    import torch

    from marlin_tpu_torch.ops import build
    from marlin_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = FWD_TILE_TOLERANCE["bfloat16"]
    worst_sound, caught = 0.0, True
    try:
        for (name, b, sq, skv, h, hk, d, dv, dt, causal,
             window) in SHAPES:
            if dt != "bfloat16":
                continue

            def randn(*dims):
                return torch.randn(dims, generator=gen, device="cuda",
                                   dtype=torch.float32).to(torch.bfloat16)

            q_hat, k, v = fa._prepare(randn(b, sq, h, d), randn(b, skv, hk, d),
                                      randn(b, skv, hk, dv), causal, None,
                                      window)
            o_r, _ = fa.flash_attention_reference(q_hat, k, v, causal,
                                                  window)
            readings = {}
            for variant, lib in libs.items():
                build._loaded["flash_attention_fwd"] = lib
                o, _ = fa._forward(q_hat, k, v, causal, window)
                readings[variant] = dict(
                    tile_rel=tile_rel_err(o, o_r),
                    max_abs=(o.float() - o_r.float()).abs().max().item())
            sound = max(r["tile_rel"] for f, r in readings.items()
                        if not flash_fault_shows(f, name) or f == "sound")
            fault_min = min(r["tile_rel"] for f, r in readings.items()
                            if f != "sound" and flash_fault_shows(f, name))
            worst_sound = max(worst_sound, sound)
            caught = caught and sound <= tol < fault_min
            print("planted_faults: " + json.dumps(dict(
                kernel="forward", shape=name, tolerance=tol,
                sound_max=sound, least_fault_max=fault_min,
                readings=readings)), flush=True)
    finally:
        build._loaded["flash_attention_fwd"] = libs["sound"]
    return worst_sound, caught


def _planted_backward(libs):
    """The backward check's reading of the sound kernels and of each
    fault at every bf16 backward shape: (worst sound reading, whether the
    limit separated them at every shape)."""
    import torch

    from marlin_tpu_torch.ops import build

    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = BWD_TOLERANCE["bfloat16"]
    worst_sound, caught = 0.0, True
    try:
        for shape in BWD_SHAPES:
            if shape[8] != "bfloat16":
                continue
            c = BwdCase(gen, shape)
            ref = c.plain()
            readings = {}
            for variant, lib in libs.items():
                build._loaded["flash_attention_bwd"] = lib
                readings[variant] = bwd_errors(c.kernels(), ref)
            sound_max = max(r["tile_rel"] for f, v in readings.items()
                            if f == "sound" or not flash_fault_shows(
                                f, c.name) for r in v.values())
            fault_min = min(max(r["tile_rel"] for r in v.values())
                            for f, v in readings.items()
                            if f != "sound" and flash_fault_shows(f, c.name))
            worst_sound = max(worst_sound, sound_max)
            caught = caught and sound_max <= tol < fault_min
            print("planted_faults: " + json.dumps(dict(
                shape=c.name, tolerance=tol, sound_max=sound_max,
                least_fault_max=fault_min, readings=readings)), flush=True)
            del c, ref
    finally:
        build._loaded["flash_attention_bwd"] = libs["sound"]
    return worst_sound, caught


def _planted_spmm(libs):
    """The SpMM check's reading of the sound kernels and of each fault
    at every bf16 SpMM shape: (worst sound reading, whether the limit
    separated them wherever the fault can show and the kernels a fault
    does not touch stayed sound)."""
    import torch

    from marlin_tpu_torch.ops import build

    gen = torch.Generator(device="cuda").manual_seed(3)
    tol = SPMM_TOLERANCE["bfloat16"]
    worst_sound, caught = 0.0, True
    try:
        for shape in SPMM_SHAPES:
            if shape[6] != "bfloat16":
                continue
            c = SpmmCase(gen, shape)
            ref = c.plain()
            readings = {}
            for variant, lib in libs.items():
                build._loaded["block_sparse"] = lib
                readings[variant] = dict(
                    gather=tile_rel_err_2d(c.gather(), ref),
                    masked=tile_rel_err_2d(c.masked(), ref))
            # What each variant must read: within the limit, except the
            # kernels a fault breaks, wherever that fault can show.
            for variant, r in readings.items():
                kernels, can_show = SPMM_FAULT_SHOWS.get(
                    variant, ((), lambda _: False))
                shows = can_show(c)
                for k, v in r.items():
                    if k in kernels and shows:
                        caught = caught and v > tol
                    else:
                        caught = caught and v <= tol
            worst_sound = max(worst_sound, *readings["sound"].values())
            print("planted_faults: " + json.dumps(dict(
                shape=c.name, tolerance=tol, live_blocks=c.nnz,
                blocks=int(c.mask.numel()), readings=readings)), flush=True)
            del c, ref
    finally:
        build._loaded["block_sparse"] = libs["sound"]
    return worst_sound, caught


def phase_planted_faults(card: str):
    """The kernel checks against planted faults: build each fault of
    FWD_PLANTED_FAULTS, PLANTED_FAULTS and SPMM_PLANTED_FAULTS into a
    temporary directory, and at every bf16 shape of the check print the
    sound kernels' and each fault's reading (tile_rel_err of O for the
    forward and of dQ, dK, dV for the backward, with max |err| beside it;
    tile_rel_err_2d for SpMM). Fails unless every sound reading is within
    the check's limit and every fault's reading exceeds it wherever the
    fault can show."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_planted({"flash_attention_fwd": FWD_PLANTED_FAULTS,
                               "flash_attention_bwd": PLANTED_FAULTS,
                               "block_sparse": SPMM_PLANTED_FAULTS}, tmp)
        fwd_sound, fwd_caught = _planted_forward(
            libs["flash_attention_fwd"])
        bwd_sound, bwd_caught = _planted_backward(
            libs["flash_attention_bwd"])
        spmm_sound, spmm_caught = _planted_spmm(libs["block_sparse"])
    print(card)
    print(json.dumps(dict(
        planted_faults=(list(FWD_PLANTED_FAULTS) + list(PLANTED_FAULTS)
                        + list(SPMM_PLANTED_FAULTS)),
        forward=dict(tolerance=FWD_TILE_TOLERANCE["bfloat16"],
                     worst_sound=fwd_sound, separates=fwd_caught),
        backward=dict(tolerance=BWD_TOLERANCE["bfloat16"],
                      worst_sound=bwd_sound, separates=bwd_caught),
        spmm=dict(tolerance=SPMM_TOLERANCE["bfloat16"],
                  worst_sound=spmm_sound, separates=spmm_caught),
        separates=fwd_caught and bwd_caught and spmm_caught)), flush=True)
    if not fwd_caught:
        fail("the forward check does not separate the sound kernel from "
             "every planted fault")
    if not bwd_caught:
        fail("the backward check does not separate the sound kernels "
             "from every planted fault")
    if not spmm_caught:
        fail("the SpMM check does not separate the sound kernels from "
             "every planted fault")


# Alternatives to dQ and the SpMM ring kernel, timed beside them and beside
# the parent tree's kernels by ``--compare-with``: each a list of edits of
# this tree's source, applied as the planted faults are; a variant of the
# ring kernel changes both SpMM routes.
KERNEL_VARIANTS = {
    "flash_attention_bwd": {
        # Three K/V stages (128 KB of shared memory: one CTA an SM).
        "dq_3_stages": [("constexpr int kDqStages = 2;",
                         "constexpr int kDqStages = 3;")],
    },
    "block_sparse": {
        # Row tiles fastest on the grid, as the first gather kernel ran:
        # the CTAs in flight share a block column instead of rows of A.
        "ring_rows_fastest": [
            ("  const int n0 = (int)(blockIdx.x % n_cols) * BN;\n"
             "  const int m0 = (int)(blockIdx.x / n_cols) * kGBM;\n",
             "  const unsigned n_rows = (M - 1) / kGBM + 1;\n"
             "  const int n0 = (int)(blockIdx.x / n_rows) * BN;\n"
             "  const int m0 = (int)(blockIdx.x % n_rows) * kGBM;\n")],
        # The mask walk's first design: thread 0 reads the mask column one
        # entry at a time, a load's latency for every dead block.
        "masked_serial_walk": [("constexpr int kGAhead = 32;",
                                "constexpr int kGAhead = 1;")],
        # Four stages (128 KB at BN = 128: one CTA an SM).
        "ring_4_stages": [("constexpr int kGStages = 3;",
                           "constexpr int kGStages = 4;")],
        # 256-row tiles, four consumer warpgroups (one CTA an SM): a stage
        # brings 48 KB for 4.2 MFLOP, 87 FLOP per byte from L2 against 64.
        "ring_256_rows": [
            ("constexpr int kGBM = 128;", "constexpr int kGBM = 256;"),
            ("constexpr int kGThreads = 256;",
             "constexpr int kGThreads = 512;"),
            ("__launch_bounds__(kGThreads, 2)\nspmm_ring_bf16(",
             "__launch_bounds__(kGThreads, 1)\nspmm_ring_bf16(")],
    },
}

# The shapes --compare-with times: the main path's, by kernel.
COMPARE_SHAPES = {"dq": ("train", "remat"), "gather": ("bench512", "coo128"),
                  "masked": ("bench512", "coo128")}


def phase_compare(card: str, parent: str):
    """This tree's dQ and SpMM kernels (both routes) against the parent
    tree's (the checkout at ``parent``, built from its own csrc/) and
    against KERNEL_VARIANTS, on one card: at each COMPARE_SHAPES shape every
    version is first held to the plain version (worst tile, the phase
    checks' limit), then timed warm (cuda_ms) and cold (cuda_ms_cold), in
    two rounds, parent, this tree, the variants, then the reverse. Prints
    one "compare:" line per kernel, shape and version, and fails if any
    version disagrees with the plain one."""
    import tempfile
    from pathlib import Path

    import torch

    from marlin_tpu_torch.ops import build

    csrc = Path(parent).resolve() / "marlin_tpu_torch" / "csrc"
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in BWD_SHAPES:
        if shape[0] in COMPARE_SHAPES["dq"]:
            c = BwdCase(gen, shape)
            ref = c.plain()[0]
            cases["dq", shape[0]] = ("flash_attention_bwd", c.dq,
                                     lambda out, ref=ref: tile_rel_err(
                                         out, ref), BWD_TOLERANCE[shape[8]])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in SPMM_SHAPES:
        if shape[0] in COMPARE_SHAPES["gather"] + COMPARE_SHAPES["masked"]:
            c = SpmmCase(gen, shape)
            ref = c.plain()
            for route, fn in (("gather", c.gather), ("masked", c.masked)):
                if shape[0] in COMPARE_SHAPES[route]:
                    cases[route, shape[0]] = (
                        "block_sparse", fn,
                        lambda out, ref=ref: tile_rel_err_2d(out, ref),
                        SPMM_TOLERANCE[shape[6]])
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_planted(KERNEL_VARIANTS, tmp, parent=csrc)
        try:
            for turn in range(2):
                for (kernel, shape), (name, fn, err_of, tol) in \
                        cases.items():
                    order = ["parent", "sound", *KERNEL_VARIANTS[name]]
                    for version in order if turn == 0 else order[::-1]:
                        build._loaded[name] = libs[name][version]
                        out = fn()
                        torch.cuda.synchronize()
                        r = readings.setdefault(
                            (kernel, shape, version),
                            dict(tile_rel_err=err_of(out), warm_ms=[],
                                 cold_ms=[]))
                        del out
                        r["warm_ms"].append(cuda_ms(fn, iters=10))
                        r["cold_ms"].append(cuda_ms_cold(fn, iters=10))
        finally:
            for name in KERNEL_VARIANTS:
                build._loaded[name] = libs[name]["sound"]
    bad = []
    for (kernel, shape, version), r in readings.items():
        tol = cases[kernel, shape][3]
        print("compare: " + json.dumps(dict(
            card=card, kernel=kernel, shape=shape,
            version="this tree" if version == "sound" else version,
            tolerance=tol, **r,
            warm_ms_mean=sum(r["warm_ms"]) / len(r["warm_ms"]),
            cold_ms_mean=sum(r["cold_ms"]) / len(r["cold_ms"]))),
            flush=True)
        if not r["tile_rel_err"] <= tol:
            bad.append(f"{kernel} {shape} {version}: {r['tile_rel_err']:.3e}")
    print(card)
    if bad:
        fail(f"versions that disagree with the plain version: {bad}")


def phase_backward_memory():
    """One backward through the autograd Function at S=8192, B=1, H=8,
    D=128 (bf16, causal): the peak allocation may not exceed its inputs
    (q, k, v, dO), what the forward saves (q_hat, O, lse), Delta and the
    gradients, plus a slack of one f32 copy of dO (Delta's product) and
    16 MiB. One (H, S, S) bf16 buffer would be 1.07 GB."""
    import torch

    from marlin_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 1, 8192, 8, 128
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    for x in (q, k, v):
        x.requires_grad_(True)
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    n = b * s * h * d * 2  # one (B, S, H, D) bf16 tensor
    rows = b * h * s * 4  # one (B, H, S) f32 tensor
    expected = 4 * n + 3 * n + 2 * rows + 3 * n  # in, saved, lse+Delta, grads
    slack = 2 * n + (16 << 20)
    out_line = dict(S=s, B=b, H=h, D=d, peak_bytes=peak,
                    expected_bytes=expected, slack_bytes=slack,
                    s_squared_bytes=h * s * s * 2)
    print("backward_memory: " + json.dumps(out_line), flush=True)
    if peak > expected + slack:
        fail(f"backward at S={s} allocated {peak / 1e6:.1f} MB, more than "
             f"inputs + outputs + lse/Delta ({expected / 1e6:.1f} MB) + "
             f"slack ({slack / 1e6:.1f} MB)")


def _zero_counters(fa):
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def _counters(fa):
    return dict(fwd=fa.launches, dq=fa.bwd_dq_launches,
                dkv=fa.bwd_dkv_launches)


def phase_train(card: str, seed: int = 0):
    """The slice: train the flagship, then one remat step at S=8192.
    Returns the launch counts of the two runs, {"train": ..., "remat":
    ...}."""
    import torch

    from marlin_tpu_torch.models import TransformerConfig, train_step
    from marlin_tpu_torch.models import transformer as tr
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.utils import cost_model as cm

    cfg = TransformerConfig(**FLAGSHIP)
    params = tr.init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    loss, params = train_step(params, tokens, targets, cfg)  # warm-up
    torch.cuda.synchronize()
    warm_loss = loss.item()

    _zero_counters(fa)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, params = train_step(params, tokens, targets, cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _counters(fa)
    peak = torch.cuda.max_memory_allocated()

    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: {losses}")
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        fail(f"train: launches {launches}, expected {want} of each "
             f"(layers x steps)")
    if any(p.dtype != torch.float32 for p in tr._leaves(params)):
        fail("train: master params left f32")
    step = sorted(step_s)[len(step_s) // 2]
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = cm.transformer_step_flops(
        cm.transformer_param_count(cfg), TRAIN_BATCH, TRAIN_SEQ,
        cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads,
        window=cfg.window)
    summary = dict(card=card, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   steps=TRAIN_STEPS, warmup_loss=warm_loss, losses=losses,
                   step_ms=[x * 1e3 for x in step_s],
                   step_ms_median=step * 1e3,
                   tokens_per_s=tokens_per_step / step,
                   model_tflops_per_step=flops / 1e12,
                   model_tflops_per_s=flops / step / 1e12,
                   peak_mem_gb=peak / 1e9, launches=launches)
    print("train: " + json.dumps(summary), flush=True)
    phase_train_profile(params, tokens, targets, cfg)
    del params

    lcfg = TransformerConfig(**LONG)
    lparams = tr.init_params(lcfg, seed=seed, device="cuda")
    ltok = torch.randint(0, lcfg.vocab, (1, lcfg.max_len), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    _zero_counters(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, lparams = train_step(lparams, ltok, torch.roll(ltok, -1, dims=1),
                               lcfg)
    lloss = loss.item()
    long_s = time.perf_counter() - t0
    long_launches = _counters(fa)
    long_peak = torch.cuda.max_memory_allocated()
    print("train_remat: " + json.dumps(dict(
        seq=lcfg.max_len, batch=1, vocab=lcfg.vocab, loss=lloss,
        first_step_ms=long_s * 1e3, peak_mem_gb=long_peak / 1e9,
        launches=long_launches)), flush=True)
    if not math.isfinite(lloss):
        fail(f"train_remat: non-finite loss {lloss}")
    if long_launches != dict(fwd=2 * lcfg.n_layers, dq=lcfg.n_layers,
                             dkv=lcfg.n_layers):
        fail(f"train_remat: launches {long_launches}, expected the forward "
             f"twice per layer and each backward kernel once")
    return {"train": launches, "remat": long_launches}


# Models of small head dim, trained on the card through the wrapper's
# zero-padding: the CPU tests' training model (tests/test_torch_train.py:
# d_model 64, 4 heads, D=16) and the example's default model at the
# reference's head count (d_model 64, 2 heads, D=32), with (B, S) of
# their own runs.
SMALL_STEPS = 5

# The small model run whose launches stand beside each WIDE_SHAPES row of
# the kernels line.
WIDE_RUNS = {"d160": "bench_d160_bfloat16", "d256": "wide_d256_bfloat16",
             "d160_f32": "bench_d160_float32",
             "d256_f32": "wide_d256_float32"}


def small_models():
    """{name: (config, batch, seq)} of the small-head-dim models."""
    from marlin_tpu_torch.examples import transformer_lm
    from marlin_tpu_torch.models import TransformerConfig

    return {
        "test_train_d16": (TransformerConfig(vocab=64, d_model=64, n_heads=4,
                                             n_layers=2, d_ff=128,
                                             max_len=32), 2, 32),
        "example_d32": (transformer_lm.model_config(64, 64, "float32"), 8,
                        64),
        # Head dims the wrapper pads to the kernels' 256: the transformer
        # bench's width at BENCH_TF_D=320 (2 heads of D=160, d_ff 4 x
        # d_model), cut to 2 layers, vocab 1024 and (B, S) = (2, 512) so
        # that the CPU's f32 run stays short; and D=256 itself.
        "bench_d160": (TransformerConfig(vocab=1024, d_model=320,
                                         n_heads=2, n_layers=2, d_ff=1280,
                                         max_len=512), 2, 512),
        "wide_d256": (TransformerConfig(vocab=1024, d_model=512, n_heads=2,
                                        n_layers=2, d_ff=2048, max_len=512),
                      2, 512),
    }


def phase_small_models(card: str, seed: int = 0):
    """Each small model at f32 and bf16: SMALL_STEPS train steps on one
    fixed batch from weights drawn on the CPU, every loss finite, the last
    below the first, and the forward, dQ and dK/dV kernels each launched
    layers x steps (counters zeroed just before, read just after); at f32
    each loss also held to the same steps on the CPU (the plain versions,
    unpadded) within GRAD_TOLERANCE. Returns {run: launches}."""
    import numpy as np
    import torch

    from marlin_tpu_torch.models import train_step
    from marlin_tpu_torch.models import transformer as tr
    from marlin_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, (base, batch, seq) in small_models().items():
        for dtype in ("float32", "bfloat16"):
            cfg = base._replace(dtype=dtype)
            cpu = tr.init_params(cfg, seed=seed, device="cpu")
            toks = torch.as_tensor(np.random.default_rng(seed).integers(
                0, cfg.vocab, (batch, seq)))
            tgts = torch.roll(toks, -1, dims=1)
            params = tr._tree_map(lambda p: p.to("cuda"), cpu)
            toks_d, tgts_d = toks.cuda(), tgts.cuda()
            torch.cuda.synchronize()
            _zero_counters(fa)
            losses = []
            for _ in range(SMALL_STEPS):
                loss, params = train_step(params, toks_d, tgts_d, cfg)
                losses.append(loss.item())
            launches = _counters(fa)
            cpu_losses = []
            if dtype == "float32":
                for _ in range(SMALL_STEPS):
                    loss, cpu = train_step(cpu, toks, tgts, cfg)
                    cpu_losses.append(loss.item())
            run = f"{name}_{dtype}"
            out[run] = launches
            print("small_model: " + json.dumps(dict(
                card=card, run=run, d_model=cfg.d_model,
                n_heads=cfg.n_heads, head_dim=cfg.d_model // cfg.n_heads,
                n_layers=cfg.n_layers, batch=batch, seq=seq, dtype=dtype,
                losses=losses, cpu_losses=cpu_losses,
                launches=launches)), flush=True)
            if not all(math.isfinite(x) for x in losses):
                fail(f"small_model {run}: non-finite loss {losses}")
            if any(abs(a - b) > GRAD_TOLERANCE * abs(b)
                   for a, b in zip(losses, cpu_losses)):
                fail(f"small_model {run}: card losses {losses} against "
                     f"the CPU's {cpu_losses} (tol {GRAD_TOLERANCE})")
            if not losses[-1] < losses[0]:
                fail(f"small_model {run}: the loss did not fall: {losses}")
            want = cfg.n_layers * SMALL_STEPS
            if any(n != want for n in launches.values()):
                fail(f"small_model {run}: launches {launches}, expected "
                     f"{want} of each (layers x steps)")
    return out


def phase_train_profile(params, tokens, targets, cfg):
    """Where a flagship train step's time goes: one step under
    torch.profiler, device-busy time against host wall-clock, the top
    kernels by device time and the three flash kernels' share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marlin_tpu_torch.models import train_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(params, tokens, targets, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = {name: sum(e.self_device_time_total for e in kernels
                          if name in e.key)
                for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print("train_profile: " + json.dumps(dict(
        wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        kernel_launches=sum(e.count for e in kernels),
        flash_ms={k: v / 1e3 for k, v in flash_us.items()},
        top_kernels=[dict(name=e.key[:60],
                          ms=e.self_device_time_total / 1e3,
                          calls=e.count) for e in top])), flush=True)


def phase_grad_check(seed: int = 0):
    """The model's loss and gradients on the card (kernels) against the
    CPU (plain versions) at f32, full width, 2 layers, B=1, S=512."""
    import numpy as np
    import torch

    from marlin_tpu_torch.models import TransformerConfig, loss_fn
    from marlin_tpu_torch.models import transformer as tr
    from marlin_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(**{**FLAGSHIP, "n_layers": 2,
                               "dtype": "float32"})
    cpu = tr.init_params(cfg, seed=seed, device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (1, 512))
    tgts = np.roll(toks, -1, axis=1)

    def value_and_grad(params):
        leaves = [p.detach().requires_grad_(True)
                  for p in tr._leaves(params)]
        loss = loss_fn(tr._unflatten(params, iter(leaves)), toks, tgts, cfg)
        return loss, torch.autograd.grad(loss, leaves)

    _zero_counters(fa)
    card = tr._tree_map(lambda p: p.to("cuda"), cpu)
    loss_g, grads_g = value_and_grad(card)
    torch.cuda.synchronize()
    launches = _counters(fa)
    loss_c, grads_c = value_and_grad(cpu)
    if launches != dict(fwd=2, dq=2, dkv=2):
        fail(f"grad_check: the card's launches {launches}, expected one "
             f"per layer of each kernel")
    worst = {}
    paths = _leaf_paths(cpu)
    for path, g, c in zip(paths, grads_g, grads_c):
        top = c.abs().max().item()
        diff = (g.cpu() - c).abs().max().item()
        worst[path] = diff / top if top > 0 else diff
    loss_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    name, err = max(worst.items(), key=lambda kv: kv[1])
    print("grad_check: " + json.dumps(dict(
        loss_card=loss_g.item(), loss_cpu=loss_c.item(),
        loss_rel_err=loss_err, worst_leaf=name, worst_rel_err=err,
        tolerance=GRAD_TOLERANCE, per_leaf=worst)), flush=True)
    if not (err <= GRAD_TOLERANCE and loss_err <= GRAD_TOLERANCE):
        fail(f"grad_check: worst leaf {name} at {err:.3e}, loss at "
             f"{loss_err:.3e} (tol {GRAD_TOLERANCE})")


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def _workload(cfg, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1537, 16)
    lens[0], lens[1] = 64, 1536  # span the whole range
    return [(rng.integers(0, cfg.vocab, int(s)), 32) for s in lens]


def phase_slice(card: str, seed: int = 0):
    import numpy as np
    import torch

    from marlin_tpu_torch.models import TransformerConfig, generate
    from marlin_tpu_torch.models import transformer as tr
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.serving import ServingEngine
    from marlin_tpu_torch.serving.slots import (pad_prompt_len,
                                                prefill_into_row)
    from marlin_tpu_torch.utils import cost_model as cm

    cfg = TransformerConfig(**FLAGSHIP)
    params = tr.init_params(cfg, seed=seed, device="cuda")
    print(f"slice: flagship {FLAGSHIP}, "
          f"{cm.transformer_param_count(cfg) / 1e6:.1f} M params",
          flush=True)
    workload = _workload(cfg, seed)

    # Warm-up (cuBLAS handles, allocator) on a throwaway engine.
    warm = ServingEngine(params, cfg, batch=8, round_steps=8,
                         device="cuda")
    warm.submit(workload[0][0], 4)
    warm.run()
    torch.cuda.synchronize()

    eng = ServingEngine(params, cfg, batch=8, round_steps=8,
                         device="cuda")
    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = {}
    done = []
    # Wave one fills 5 of the 8 rows; wave two arrives a round later, so
    # 3 of its requests are admitted beside rows that are mid-decode, and
    # the rest as rows free up.
    for prompt, steps in workload[:5]:
        ids[eng.submit(prompt, steps)] = (prompt, steps)
    done += eng.step()
    for prompt, steps in workload[5:]:
        ids[eng.submit(prompt, steps)] = (prompt, steps)
    done += eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()

    done = {r.request_id: r for r in done}
    if len(done) != 16 or any(r.status != "done" for r in done.values()):
        fail(f"engine answered {len(done)} of 16 requests: "
             f"{[(r.request_id, r.status) for r in done.values()]}")
    admissions = eng.stats.n_admitted
    if launches != admissions * cfg.n_layers:
        fail(f"flash kernel launches {launches} != admissions {admissions} "
             f"x layers {cfg.n_layers}")
    tokens = sum(r.emitted for r in done.values())
    rounds = [e for e in eng.runlog.events("round")]
    steady = [e["round_s"] / e["iters"] for e in rounds
              if e["admitted"] == 0 and e["iters"]]
    iter_ms = 1e3 * float(np.median(steady)) if steady else None

    # Prefill alone, per padded prompt, timed on the card.
    cache = tr.init_kv_cache(cfg, 1, dtype=cfg.compute_dtype,
                             device="cuda")
    buf = torch.zeros((1, cfg.max_len), dtype=torch.long, device="cuda")
    run_params = tr._cast_params(params, cfg)
    prefill_ms = []
    for prompt, _ in workload:
        pt = torch.as_tensor(prompt, device="cuda")
        prefill_ms.append(cuda_ms(lambda: prefill_into_row(
            run_params, cache, buf, 0, pt, cfg), warmup=1, iters=3))

    # Every request against the port's own B=1 generate.
    agree = 0
    total = 0
    divergences = []
    for rid, (prompt, steps) in ids.items():
        ref = generate(params, torch.as_tensor(prompt[None]), steps,
                       cfg).cpu().numpy()[0]
        got = done[rid].tokens
        same = ref == got
        total += steps
        if same.all():
            agree += steps
            continue
        j = int(np.argmin(same))
        agree += j
        seq = np.concatenate([prompt, ref[:j]])[None]
        logits, _ = tr.prefill(params, torch.as_tensor(seq, device="cuda"),
                               cfg)
        lg = logits[0].float()
        top2 = torch.topk(lg, 2).values
        margin = (top2[0] - top2[1]).item()
        gap = (lg[int(ref[j])] - lg[int(got[j])]).item()
        ulp = 2.0 ** (math.floor(math.log2(abs(top2[0].item()))) - 7)
        divergences.append(dict(request=rid, prompt_len=len(prompt),
                                index=j, top2_margin=margin,
                                chosen_gap=gap, bf16_ulps=gap / ulp))
        # Four bf16 ulps: two runs whose matmuls accumulate in different
        # orders (batch 8 vs 1) differ by a few ulps after 8 layers of
        # bf16 rounding; a real fault moves logits by whole units.
        if abs(gap) > 4 * ulp:
            fail(f"request {rid} diverges from B=1 generate at token {j} "
                 f"with a logit gap of {gap:.4f} ({gap / ulp:.1f} bf16 "
                 f"ulps) — beyond bf16 noise")
    for d in divergences:
        print("slice: divergence " + json.dumps(d))
    summary = dict(
        card=card, requests=len(done), admissions=admissions,
        flash_launches=launches, tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_iter_ms=iter_ms,
        prefill_ms_mean=float(np.mean(prefill_ms)),
        prefill_ms_max=float(np.max(prefill_ms)),
        prefill_padded_lens=[pad_prompt_len(len(p)) for p, _ in workload],
        peak_mem_gb=peak / 1e9,
        token_agreement=agree / total,
        requests_equal=sum(1 for rid, (p, s) in ids.items()
                           if not any(d["request"] == rid
                                      for d in divergences)),
        engine=eng.stats.summary())
    print("slice: " + json.dumps(summary, default=str), flush=True)
    phase_profile(params, cfg, workload)
    return launches


def phase_profile(params, cfg, workload):
    """Where a steady decode round's time goes: one round of 8 live rows
    (no admission) under torch.profiler, device-busy time against host
    wall-clock, and the round trip of the loop's one host sync per
    iteration (a (B,) bool copy to the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marlin_tpu_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, batch=8, round_steps=8, device="cuda")
    for prompt, _ in workload[:8]:
        eng.submit(prompt[:64], 24)
    eng.step()  # admissions and the first round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = eng.runlog.events("round")[-1]["iters"]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    done = torch.zeros(8, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(200):
        done.cpu()
    sync_us = (time.perf_counter() - t1) / 200 * 1e6
    out = dict(
        round_iters=iters, wall_ms_per_iter=wall * 1e3 / iters,
        device_busy_ms_per_iter=busy_us / 1e3 / iters,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        kernel_launches_per_iter=sum(e.count for e in kernels) / iters,
        host_sync_us=sync_us,
        top_kernels=[dict(name=e.key[:60],
                          ms_per_iter=e.self_device_time_total / 1e3 / iters,
                          calls_per_iter=e.count / iters) for e in top])
    print("profile: " + json.dumps(out), flush=True)


# SpMM kernel-vs-plain shapes: (name, M, K, N, block size, mask, dtype). The
# main path's two shapes come first: "bench512" is the sparse bench
# configuration (n = 8192, bs = 512, 12% of the blocks live), "coo128" the
# same matrix size at the default block size that to_block_sparse gives;
# "oracle" is that bench's own oracle shape; the rest are edge cases,
# "tall_m" and "wide_n" past the 65535 tiles a grid dimension other than x
# holds (M > 8,388,480 rows of 128; N > 4,194,240 columns of 64). mask: a
# density in (0, 1) draws it at random; "zero" is all zero, "full" all
# one, "empty_column" half dense with block column 2 emptied,
# "one_full_column" block column 3 full among empty ones, "diagonal" the
# blocks k == j live.
SPMM_SHAPES = [
    ("bench512", 8192, 8192, 8192, 512, 0.12, "bfloat16"),
    ("coo128", 8192, 8192, 8192, 128, 0.12, "bfloat16"),
    ("oracle", 1024, 1024, 1024, 256, 0.3, "bfloat16"),
    ("ragged_m", 1000, 1024, 1024, 128, 0.3, "bfloat16"),
    ("k_ne_n", 1024, 4096, 2048, 128, 0.2, "bfloat16"),
    ("bs64", 512, 512, 512, 64, 0.3, "bfloat16"),
    ("all_zero", 512, 512, 512, 128, "zero", "bfloat16"),
    ("empty_column", 1024, 1024, 1024, 128, "empty_column", "bfloat16"),
    ("full", 1024, 1024, 1024, 128, "full", "bfloat16"),
    ("one_full_column", 1024, 1024, 1024, 128, "one_full_column",
     "bfloat16"),
    ("f32", 1000, 1024, 1024, 128, 0.3, "float32"),
    ("tall_m", 8388608, 128, 128, 64, "diagonal", "bfloat16"),
    ("wide_n", 128, 64, 4194304, 64, 0.01, "bfloat16"),
    ("tall_m_f32", 8388608, 128, 128, 64, "diagonal", "float32"),
    ("wide_n_f32", 128, 64, 4194304, 64, 0.01, "float32"),
]

# SpMM tolerance by dtype, on the worst 64 x 64 output tile's relative
# Frobenius error ||kernel - plain||_F / ||plain||_F (tile_rel_err_2d); a
# tile whose plain value is all zero (under an empty block column) must be
# all zero in the kernel's output too. bf16: both sides multiply the same
# bf16 values exactly and sum them in f32 in different orders, then round
# once to bf16 (2^-9 relative per value where the two f32 sums straddle a
# rounding boundary); the limit sits ~10x above that and ~10x below what
# one dropped or one extra block costs a tile (--planted-faults). f32: FMA
# in full f32 against f32 matmuls, only the order of sums differs. The
# gradients (phase_spmm_grad) are held to the same limits: dA and dB of the
# kernel path are f32 products rounded once, the plain version's autograd
# rounds each block's contribution to the working type before it sums them.
SPMM_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}
SPMM_PRODUCTS = 8  # products per main-path run


def tile_rel_err_2d(got, ref) -> float:
    """The worst 64 x 64 tile's ||got - ref||_F / ||ref||_F over (M, N)
    matrices (tiles at a ragged edge are smaller). A tile whose reference
    is all zero must be all zero in ``got``: if it is not, it reads as
    1e6, past any limit."""
    import torch
    import torch.nn.functional as F

    m, n = ref.shape
    pad = (0, (-n) % TILE, 0, (-m) % TILE)

    def tiles(x):  # squared norm of each tile
        x = F.pad(x, pad)
        return x.reshape(x.shape[0] // TILE, TILE, x.shape[1] // TILE,
                         TILE).square().sum(dim=(1, 3))

    num = tiles(got.float() - ref.float())
    den = tiles(ref.float())
    zero = den == 0
    if bool((zero & (num != 0)).any()):
        return 1e6
    ratio = torch.where(zero, torch.zeros_like(num), num / den)
    return ratio.max().sqrt().item()


def draw_block_mask(kind, rows, cols, gen):
    """A (rows, cols) int32 block mask on the card: of a density drawn
    from ``gen``, or one of SPMM_SHAPES' named patterns."""
    import torch

    if kind == "zero":
        return torch.zeros((rows, cols), dtype=torch.int32, device="cuda")
    if kind == "full":
        return torch.ones((rows, cols), dtype=torch.int32, device="cuda")
    if kind == "one_full_column":
        mask = torch.zeros((rows, cols), dtype=torch.int32, device="cuda")
        mask[:, 3] = 1
        return mask
    if kind == "diagonal":
        return torch.eye(rows, cols, dtype=torch.int32, device="cuda")
    density = 0.5 if kind == "empty_column" else kind
    mask = (torch.rand((rows, cols), generator=gen, device="cuda")
            < density).to(torch.int32)
    if kind == "empty_column":
        mask[:, 2] = 0
    return mask


class SpmmCase:
    """One SpMM shape's inputs on the card: random A, a random backing
    array that is NOT zeroed outside the mask (so a kernel that multiplied
    a dead block instead of skipping it would disagree), the mask and its
    gather lists; with the two kernels' and the plain version's calls."""

    def __init__(self, gen, shape):
        import torch

        from marlin_tpu_torch.ops import block_sparse as bsp

        self.name, m, k, n, self.bs, kind, self.dt = shape
        self.bsp = bsp
        dtype = getattr(torch, self.dt)
        self.a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        self.data = torch.randn((k, n), generator=gen,
                                device="cuda").to(dtype)
        self.mask = draw_block_mask(kind, k // self.bs, n // self.bs, gen)
        self.kidx, self.kcnt, self.max_nnz = bsp._column_block_lists(
            self.mask.cpu().numpy())
        self.kidx_d = torch.from_numpy(self.kidx).cuda()
        self.kcnt_d = torch.from_numpy(self.kcnt).cuda()
        self.nnz = int(self.kcnt.sum())

    def gather(self):
        return self.bsp._launch_gather(self.a, self.data, self.kidx_d,
                                       self.kcnt_d, self.max_nnz, self.bs)

    def masked(self):
        return self.bsp._launch_masked(self.a, self.data, self.mask, self.bs)

    def plain(self):
        return self.bsp.spmm_gather_reference(self.a, self.data, self.kidx,
                                              self.kcnt, self.bs)

    def empty_columns_zero(self, out) -> bool:
        """Every element of ``out`` under a block column with no live
        block is bitwise +0."""
        import torch

        cols = torch.from_numpy(self.kcnt == 0).cuda().repeat_interleave(
            self.bs)
        return not bool(out[:, cols].view(torch.int16 if self.dt ==
                                          "bfloat16" else torch.int32).any())

    def bound(self, out):
        """The least time for this case's work: 2 M bs^2 operations per
        live block; A read once, B's live blocks read once, C written
        once."""
        es = self.a.element_size()
        flops = 2.0 * self.a.shape[0] * self.bs * self.bs * self.nnz
        moved = nbytes(self.a, out) + self.nnz * self.bs * self.bs * es
        return flops, bound(flops, moved, self.a.dtype)


def phase_spmm(card: str):
    """The gather and the masked-grid routes' SpMM kernels against the
    plain version at every SpMM shape; returns the rows by shape name."""
    import torch

    from marlin_tpu_torch.ops.block_sparse import BlockSparse

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for shape in SPMM_SHAPES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c = SpmmCase(gen, shape)
        got_g, got_m = c.gather(), c.masked()
        torch.cuda.synchronize()
        ref = c.plain()
        err_g, err_m = tile_rel_err_2d(got_g, ref), tile_rel_err_2d(got_m,
                                                                    ref)
        tol = SPMM_TOLERANCE[c.dt]
        for label, err in (("gather", err_g), ("masked", err_m)):
            if not math.isfinite(err) or err > tol:
                fail(f"spmm {c.name}: the {label} kernel's worst tile "
                     f"||kernel - plain|| / ||plain|| = {err:.3e} "
                     f"(tol {tol})")
        # The two routes run one loop per dtype over the same blocks in
        # the same order: they agree bit for bit.
        if not torch.equal(got_g, got_m):
            fail(f"spmm {c.name}: the gather and the masked route differ "
                 f"bitwise")
        if not (c.empty_columns_zero(got_g) and c.empty_columns_zero(got_m)):
            fail(f"spmm {c.name}: an empty block column is not exactly 0")
        # The library yardstick: one dense product on the zero-filled
        # backing, which does 1 / density times the work. The port's
        # forward never calls it.
        zeroed = BlockSparse(c.data, c.mask, c.bs).data
        flops, (bound_ms, bound_by) = c.bound(got_g)
        ms_g = cuda_ms(c.gather, iters=20)
        ms_g_cold = cuda_ms_cold(c.gather, iters=10)
        ms_m = cuda_ms(c.masked, iters=20)
        ms_m_cold = cuda_ms_cold(c.masked, iters=10)
        row = dict(shape=c.name, card=card, M=c.a.shape[0], K=c.a.shape[1],
                   N=c.data.shape[1], block_size=c.bs, dtype=c.dt,
                   live_blocks=c.nnz, blocks=int(c.mask.numel()),
                   column_blocks_min=int(c.kcnt.min()),
                   column_blocks_mean=float(c.kcnt.mean()),
                   column_blocks_max=int(c.kcnt.max()),
                   gather_tile_rel_err=err_g, masked_tile_rel_err=err_m,
                   gather_equals_masked=True,
                   max_abs_err=(got_g.float() - ref.float()).abs().max()
                   .item(),
                   gather_ms=ms_g, gather_cold_ms=ms_g_cold, masked_ms=ms_m,
                   masked_cold_ms=ms_m_cold,
                   plain_ms=cuda_ms(c.plain, warmup=1, iters=2),
                   library_ms=cuda_ms(lambda: torch.matmul(c.a, zeroed),
                                      iters=20),
                   bound_ms=bound_ms, bound_by=bound_by,
                   gather_tflops=flops / ms_g / 1e9,
                   masked_tflops=flops / ms_m / 1e9,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows[c.name] = row
        print("spmm: " + json.dumps(row), flush=True)
        del c, got_g, got_m, ref, zeroed
    return rows


def _spmm_products(a, b, plain_lists, label, card, extra):
    """SPMM_PRODUCTS products through the public entry point with the
    launch counters zeroed just before and read just after; the last
    result held against the plain version. Returns the counts."""
    import torch

    from marlin_tpu_torch.ops import block_sparse as bsp

    n = a.shape[0]
    out = bsp.block_sparse_matmul(a, b)  # warm-up: lists built, lib loaded
    torch.cuda.synchronize()
    bsp.gather_launches = bsp.masked_launches = 0
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(SPMM_PRODUCTS):
        out = bsp.block_sparse_matmul(a, b)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(gather=bsp.gather_launches, masked=bsp.masked_launches)
    peak = torch.cuda.max_memory_allocated()
    ms = start.elapsed_time(end) / SPMM_PRODUCTS
    if counts != dict(gather=SPMM_PRODUCTS, masked=0):
        fail(f"{label}: launches {counts}, expected {SPMM_PRODUCTS} of the "
             f"gather kernel and none of the masked one")
    if out.shape != (n, b.shape[1]) or out.dtype != b.data.dtype:
        fail(f"{label}: result {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: non-finite result")
    kidx, kcnt = plain_lists
    ref = bsp.spmm_gather_reference(a, b.data, kidx, kcnt, b.block_size)
    err = tile_rel_err_2d(out, ref)
    tol = SPMM_TOLERANCE["bfloat16"]
    if not err <= tol:
        fail(f"{label}: worst tile ||result - plain|| / ||plain|| = "
             f"{err:.3e} (tol {tol})")
    print(f"{label}: " + json.dumps(dict(
        card=card, n=n, block_size=b.block_size, dtype=str(out.dtype),
        block_density=b.block_density, products=SPMM_PRODUCTS,
        launches=counts, product_ms=ms, wall_ms_per_product=wall * 1e3
        / SPMM_PRODUCTS,
        effective_tflops=2.0 * n ** 3 * b.block_density / ms / 1e9,
        tile_rel_err=err, peak_mem_gb=peak / 1e9,
        column_blocks_min=int(kcnt.min()),
        column_blocks_mean=float(kcnt.mean()),
        column_blocks_max=int(kcnt.max()), **extra)), flush=True)
    return counts


def phase_spmm_path(card: str, seed: int = 0):
    """The block-sparse GEMM path at the sparse bench configuration's
    size (n = 8192, bf16, 12% of the blocks live, nothing cut), through
    the entry points a user calls: (a) BlockSparse(data, mask, 512) as the
    bench builds it; (b) the same size as COO triples ->
    SparseVecMatrix.from_coo -> to_block_sparse() at the default block
    size of 128. Returns {path: {"gather": n, "masked": n}}."""
    import numpy as np
    import torch

    from marlin_tpu_torch.matrix import SparseVecMatrix
    from marlin_tpu_torch.ops import BlockSparse
    from marlin_tpu_torch.ops import block_sparse as bsp

    n, density = 8192, 0.12
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((n, n), generator=gen, device="cuda").to(torch.bfloat16)
    launches = {}

    mask = rng.random((n // 512, n // 512)) < density
    data = torch.randn((n, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = BlockSparse(data, torch.from_numpy(mask).cuda(), 512)
    launches["bench512"] = _spmm_products(
        a, b, bsp._column_block_lists(mask)[:2], "spmm_path bench512", card,
        {})
    del b, data

    mask = rng.random((n // 128, n // 128)) < density
    mask_d = torch.from_numpy(mask).cuda()
    dense = torch.where(bsp._expand(mask_d, 128),
                        torch.randn((n, n), generator=gen, device="cuda"),
                        torch.zeros((), device="cuda")).to(torch.bfloat16)
    t0 = time.perf_counter()
    idx = dense.nonzero()
    sp = SparseVecMatrix.from_coo(idx[:, 0], idx[:, 1],
                                  dense[idx[:, 0], idx[:, 1]], (n, n))
    b = sp.to_block_sparse()
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    if b.block_size != 128 or not torch.equal(b.mask != 0, mask_d):
        fail("spmm_path coo128: to_block_sparse did not recover the block "
             "mask that was drawn")
    if not torch.equal(b.data, dense):
        fail("spmm_path coo128: to_block_sparse did not recover the matrix")
    launches["coo128"] = _spmm_products(
        a, b, bsp._column_block_lists(mask)[:2], "spmm_path coo128", card,
        dict(coo_entries=sp.nnz, coo_to_block_sparse_s=convert_s))
    return launches


def phase_spmm_graph(seed: int = 0):
    """The masked-grid path: one CUDA graph of
    block_sparse_matmul(a, BlockSparse(data, mask, 512)) at the bench
    shape, captured with the mask on the card (so it has no host value),
    replayed, then replayed again after the static mask and data tensors
    were overwritten with a second draw. Returns the launch counts of the
    capture."""
    import torch

    from marlin_tpu_torch.ops import BlockSparse, block_sparse_matmul
    from marlin_tpu_torch.ops import block_sparse as bsp

    n, bs, density = 8192, 512, 0.12
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def draw():
        return (torch.randn((n, n), generator=gen, device="cuda").to(
            torch.bfloat16), draw_block_mask(density, n // bs, n // bs, gen))

    a = torch.randn((n, n), generator=gen, device="cuda").to(torch.bfloat16)
    draws = [draw(), draw()]
    if torch.equal(draws[0][1], draws[1][1]):
        fail("spmm_graph: the two draws gave the same mask")
    data, mask = (x.clone() for x in draws[0])
    bsp._kernel_lib()  # built and loaded before the capture
    torch.cuda.synchronize()
    bsp.gather_launches = bsp.masked_launches = 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = block_sparse_matmul(a, BlockSparse(data, mask, bs))
    counts = dict(gather=bsp.gather_launches, masked=bsp.masked_launches)
    errs = []
    for d, m in draws:
        data.copy_(d)
        mask.copy_(m)
        graph.replay()
        torch.cuda.synchronize()
        ref = bsp.spmm_masked_reference(a, BlockSparse(d, m, bs).data, m, bs)
        errs.append(tile_rel_err_2d(out, ref))
    replay_ms = cuda_ms(graph.replay, iters=10)
    print("spmm_graph: " + json.dumps(dict(
        n=n, block_size=bs, captures=1, replays=len(draws), launches=counts,
        tile_rel_err=errs, live_blocks=[int(m.sum()) for _, m in draws],
        replay_ms=replay_ms,
        replay_covers="the zeroing of dead blocks and the product")),
        flush=True)
    if counts != dict(gather=0, masked=1):
        fail(f"spmm_graph: launches {counts}, expected the masked kernel "
             f"once (the capture) and the gather kernel never")
    tol = SPMM_TOLERANCE["bfloat16"]
    if not all(e <= tol for e in errs):
        fail(f"spmm_graph: replays read {errs} against the plain version "
             f"of their own mask (tol {tol})")
    return counts


def phase_spmm_grad(seed: int = 0):
    """Gradients of loss = sum(block_sparse_matmul(a, b)^2) in A and in
    B's backing tensor: at the bench shape (bf16) on the card against the
    plain version's autograd, dB exactly 0 outside the mask; and at a
    small f32 shape, the card (kernel forward) against the CPU (plain
    version)."""
    import torch

    from marlin_tpu_torch.ops import BlockSparse, block_sparse_matmul
    from marlin_tpu_torch.ops import block_sparse as bsp

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def grads(a, data, mask, bs, forward):
        a = a.detach().clone().requires_grad_(True)
        data = data.detach().clone().requires_grad_(True)
        b = BlockSparse(data, mask, bs)
        loss = forward(a, b).square().sum()
        loss.backward()
        return loss.detach(), a.grad, data.grad

    def plain_forward(a, b):
        kidx, kcnt, _ = bsp._column_block_lists(b._host_mask)
        return bsp.spmm_gather_reference(a, b.data, kidx, kcnt,
                                         b.block_size)

    n, bs = 8192, 512
    a = torch.randn((n, n), generator=gen, device="cuda").to(torch.bfloat16)
    data = torch.randn((n, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    mask = draw_block_mask(0.12, n // bs, n // bs, gen)
    bsp.gather_launches = bsp.masked_launches = 0
    loss_k, da_k, db_k = grads(a, data, mask, bs, block_sparse_matmul)
    torch.cuda.synchronize()
    counts = dict(gather=bsp.gather_launches, masked=bsp.masked_launches)
    loss_p, da_p, db_p = grads(a, data, mask, bs, plain_forward)
    outside = ~bsp._expand(mask, bs)
    big = dict(n=n, block_size=bs, launches=counts,
               loss_rel_err=abs(loss_k.item() - loss_p.item())
               / abs(loss_p.item()),
               da_tile_rel_err=tile_rel_err_2d(da_k, da_p),
               db_tile_rel_err=tile_rel_err_2d(db_k, db_p),
               db_outside_mask_max=db_k[outside].float().abs().max().item())
    del a, data, da_k, db_k, da_p, db_p, outside

    # Card against CPU at f32: the FMA kernel's forward and the f32
    # gradient products on the card against the plain version on the CPU.
    n, bs = 512, 64
    a = torch.randn((n, n), generator=gen, device="cuda")
    data = torch.randn((n, n), generator=gen, device="cuda")
    mask = draw_block_mask(0.4, n // bs, n // bs, gen)
    on_card = grads(a, data, mask, bs, block_sparse_matmul)
    on_cpu = grads(a.cpu(), data.cpu(), mask.cpu(), bs, block_sparse_matmul)
    small = {}
    for label, g, c in zip(("loss", "da", "db"), on_card, on_cpu):
        small[f"{label}_rel_err"] = ((g.cpu() - c).abs().max()
                                     / c.abs().max()).item()
    print("spmm_grad: " + json.dumps(dict(
        bf16=big, f32_card_vs_cpu=dict(n=n, block_size=bs, **small),
        tolerance=dict(tile=SPMM_TOLERANCE["bfloat16"],
                       card_vs_cpu=GRAD_TOLERANCE))), flush=True)
    tol = SPMM_TOLERANCE["bfloat16"]
    if counts != dict(gather=1, masked=0):
        fail(f"spmm_grad: launches {counts}, expected one gather launch")
    if not (big["da_tile_rel_err"] <= tol and big["db_tile_rel_err"] <= tol
            and big["loss_rel_err"] <= tol):
        fail(f"spmm_grad: bf16 gradients off the plain version's: {big}")
    if big["db_outside_mask_max"] != 0:
        fail("spmm_grad: dB is not exactly 0 outside the block mask")
    if not all(v <= GRAD_TOLERANCE for v in small.values()):
        fail(f"spmm_grad: card against CPU at f32: {small} "
             f"(tol {GRAD_TOLERANCE})")


# The dense GEMM: the port's counterpart of BASELINE.md's MatrixMultiply
# and the JAX package's `headline` bench config (benchlib/configs_gemm.py:
# 21): random_den_vec_matrix operands at N = 32768, bf16, multiplied
# through DenseVecMatrix.multiply on a one-rank NCCL mesh (one card), by
# auto-dispatch and by each forced engine.
GEMM_N = 32768
GEMM_BAND = (12288, 256)  # (first row, rows) of the result held to f64
# The band against an f64 product of the same bf16 rows on the card, per
# element |C - ref| / |ref| (every entry of the product of two U(0, 1)
# matrices is ~N / 4 > 0). cuBLAS's bf16 GEMM accumulates in f32: over N
# positive terms that is at most N * 2^-24 = 2.0e-3 relative; rounding C
# to bf16 (8 significant bits) adds at most 2^-8 = 3.9e-3.
GEMM_REL_TOLERANCE = 6e-3
GEMM_ITERS = 3
GEMM_RUNS = (("auto", {}), ("broadcast", {"mode": "broadcast"}),
             ("summa", {"mode": "summa"}), ("cannon", {"mode": "cannon"}),
             ("gspmd", {"mode": "gspmd"}), ("grid_1x1x1", {"mode": (1, 1, 1)}))


def smi_clock_power():
    """The card's SM clock (MHz) and power draw (W) now, from
    nvidia-smi."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].split(",")
    return float(res[0]), float(res[1])


def phase_gemm(card: str):
    """The dense GEMM at the headline size on a one-rank NCCL mesh: each
    run of GEMM_RUNS multiplies once to warm up, its result's GEMM_BAND
    rows are held to the f64 product of the same rows at
    GEMM_REL_TOLERANCE; then GEMM_ITERS products of each run are timed
    between CUDA events, in two rounds of opposite order (``ms`` is
    their mean). No hand-written kernel launches (the flash and SpMM counters
    stay 0). Prints one "gemm:" line per run and a summary line; returns
    the summary."""
    import torch
    import torch.distributed as dist

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.ops import block_sparse as bs
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.utils import random as mrand

    n = GEMM_N
    mesh = pm.create_mesh()
    if dist.get_backend() != "nccl" or mesh.size != 1:
        fail(f"gemm: expected a one-rank NCCL mesh, got "
             f"{dist.get_backend()} over {mesh.size} ranks")
    _zero_counters(fa)
    spmm_before = (bs.gather_launches, bs.masked_launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = mrand.random_den_vec_matrix(n, n, seed=1, mesh=mesh,
                                    dtype=torch.bfloat16)
    b = mrand.random_den_vec_matrix(n, n, seed=2, mesh=mesh,
                                    dtype=torch.bfloat16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    r0, rows = GEMM_BAND
    ref = (a.logical[r0:r0 + rows].double()
           @ b.logical.double())
    flops = 2.0 * n ** 3
    bound_ms, bound_by = bound(flops, 3 * n * n * 2, torch.bfloat16)
    out = {}
    for label, kw in GEMM_RUNS:
        c = a.multiply(b, **kw)
        torch.cuda.synchronize()
        band = c.logical[r0:r0 + rows].double()
        if tuple(c.shape) != (n, n) or not bool(torch.isfinite(band).all()):
            fail(f"gemm {label}: shape {c.shape} or non-finite values")
        rel = ((band - ref).abs() / ref.abs()).max().item()
        if not rel <= GEMM_REL_TOLERANCE:
            fail(f"gemm {label}: band |C - f64| / |f64| = {rel:.3e} (tol "
                 f"{GEMM_REL_TOLERANCE})")
        out[label] = dict(run=label, result=type(c).__name__, n=n,
                          dtype="bfloat16", band_max_rel_err=rel,
                          bound_ms=bound_ms, bound_by=bound_by, card=card,
                          ms_rounds=[], sm_clock_mhz=[], power_w=[])
        del c, band
    # Timed in two rounds, the runs in opposite orders, so a run's place
    # in the sequence (the card's clocks under its power limit) is not
    # read as its cost; the SM clock and power after each window beside.
    for order in (GEMM_RUNS, GEMM_RUNS[::-1]):
        for label, kw in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(GEMM_ITERS):
                c = a.multiply(b, **kw)
                del c
            end.record()
            torch.cuda.synchronize()
            row = out[label]
            row["ms_rounds"].append(start.elapsed_time(end) / GEMM_ITERS)
            clock, power = smi_clock_power()
            row["sm_clock_mhz"].append(clock)
            row["power_w"].append(power)
    for label, row in out.items():
        ms = sum(row["ms_rounds"]) / len(row["ms_rounds"])
        row.update(ms=ms, tflops=flops / ms / 1e9,
                   peak_share=flops / ms / 1e-3
                   / PEAK_FLOPS["torch.bfloat16"])
        print("gemm: " + json.dumps(row), flush=True)
    peak = torch.cuda.max_memory_allocated()
    launched = dict(**_counters(fa), gather=bs.gather_launches
                    - spmm_before[0], masked=bs.masked_launches
                    - spmm_before[1])
    if any(launched.values()):
        fail(f"gemm: hand-written kernels launched: {launched}")
    summary = dict(card=card, n=n, dtype="bfloat16", operands_gb=3 * n * n
                   * 2 / 1e9, peak_mem_gb=peak / 1e9, generate_s=gen_s,
                   band=list(GEMM_BAND), tolerance=GEMM_REL_TOLERANCE,
                   auto_ms=out["auto"]["ms"],
                   auto_tflops=out["auto"]["tflops"],
                   auto_peak_share=out["auto"]["peak_share"],
                   kernel_launches=launched)
    print("gemm_summary: " + json.dumps(summary), flush=True)
    del a, b, ref
    dist.destroy_process_group()
    pm.set_default_mesh(None)
    return summary


def spmm_kernel_entries(spmm, launches):
    """The two SpMM kernels' entries of the {"kernels": [...]} object.
    ``spmm`` is phase_spmm's rows; ``launches`` is {path: {"gather": n,
    "masked": n}} for the paths "bench512", "coo128" (the gather kernel's)
    and "graph512" (the masked kernel's, at the bench512 shape: launches
    there are graph captures)."""
    covers = ("one torch.matmul on the zero-filled backing array: the "
              "dense product, 1 / density times the work")

    def entry(kernel, path, shape):
        r = spmm[shape]
        return dict(shape=shape, M=r["M"], K=r["K"], N=r["N"],
                    block_size=r["block_size"], dtype=r["dtype"],
                    live_blocks=r["live_blocks"], blocks=r["blocks"],
                    column_blocks_min=r["column_blocks_min"],
                    column_blocks_mean=r["column_blocks_mean"],
                    column_blocks_max=r["column_blocks_max"],
                    launches=launches[path][kernel],
                    max_abs_err=r["max_abs_err"],
                    max_tile_rel_err=r[f"{kernel}_tile_rel_err"],
                    ms=r[f"{kernel}_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    cold_ms=r[f"{kernel}_cold_ms"])

    def kernel_entry(kernel, replaces, paths):
        per_path = {p: entry(kernel, p, shape) for p, shape in paths}
        return {"name": f"block_sparse_spmm_{kernel}", "route": "cuda",
                "source": "marlin_tpu_torch/csrc/block_sparse.cu",
                "replaces": replaces, **next(iter(per_path.values())),
                "launches": sum(e["launches"] for e in per_path.values()),
                "library_ms_covers": covers, "paths": per_path}

    return [
        kernel_entry("gather", "marlin_tpu/ops/block_sparse.py:136",
                     (("bench512", "bench512"), ("coo128", "coo128"))),
        kernel_entry("masked", "marlin_tpu/ops/block_sparse.py:114",
                     (("graph512", "bench512"),)),
    ]


def kernels_line(rows, bwd, launches, small, spmm, spmm_launches):
    """The {"kernels": [...]} object. Each kernel's top-level numbers are
    those of its first path's shape ("serve" for the forward, "train" for
    the backward, "bench512" for SpMM); ``paths`` gives each path the
    kernel runs on its own launches and its shape's error, times and
    bound, and each small model's run (``small``, phase_small_models'
    {run: {"fwd": n, "dq": n, "dkv": n}}) its launches. ``launches`` is
    {path: {"fwd": n, "dq": n, "dkv": n}}; ``spmm`` and ``spmm_launches``
    are spmm_kernel_entries' arguments."""
    bwd_src = "marlin_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd_paths = {p: (launches[p]["fwd"], rows[s]) for p, s in
                 (("serve", "flagship"), ("train", "train"),
                  ("remat", "remat"))}

    def fwd_entry(n, r):
        return dict(shape=r["shape"], launches=n,
                    max_abs_err=r["max_abs_err"],
                    max_tile_rel_err=r["o_tile_rel_err"], ms=r["ms"],
                    cold_ms=r["cold_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    tflops=r["tflops"], bound_share=r["bound_share"])

    def small_paths(kernel):
        return {run: dict(shape=run, launches=n[kernel])
                for run, n in small.items()}

    def wide(kernel, make, table):
        """The D = Dv = 256 instantiation's entries: each WIDE_SHAPES
        row, with the launches of the small model run of that head dim
        and dtype (counted once, under that run's path)."""
        return {shape: {**make(small[run][kernel], table[shape]),
                        "launches_of_run": run}
                for shape, run in WIDE_RUNS.items()}

    def bwd_kernel(kernel, replaces, labels):
        paths = {p: (launches[p][kernel], bwd[p]) for p in ("train", "remat")}

        def entry(n, r):
            return dict(
                shape=r["shape"], launches=n,
                max_abs_err=max(r[f"{x}_max_abs_err"] for x in labels),
                max_global_rel_err=max(r[f"{x}_global_rel_err"]
                                       for x in labels),
                max_tile_rel_err=max(r[f"{x}_tile_rel_err"] for x in labels),
                ms=r[f"{kernel}_ms"], plain_ms=r["plain_ms"],
                bound_ms=r[f"{kernel}_bound_ms"],
                bound_by=r[f"{kernel}_bound_by"],
                library_ms=r["library_ms"], tflops=r[f"{kernel}_tflops"],
                bound_share=r[f"{kernel}_bound_ms"] / r[f"{kernel}_ms"],
                cold_ms=r[f"{kernel}_cold_ms"])

        top = entry(*paths["train"])
        all_paths = {**{p: entry(*v) for p, v in paths.items()},
                     **small_paths(kernel)}
        return {"name": f"flash_attention_bwd_{kernel}", "route": "cuda",
                "source": bwd_src, "replaces": replaces,
                **top, "launches": sum(e["launches"]
                                       for e in all_paths.values()),
                "plain_ms_covers": "the whole plain backward: dQ, dK, dV",
                "library_ms_covers": "scaled_dot_product_attention's "
                                     "backward: dQ, dK and dV in one call",
                "paths": all_paths, "head_dim_256": wide(kernel, entry, bwd)}

    fwd_top = fwd_entry(*fwd_paths["serve"])
    fwd_all = {**{p: fwd_entry(*v) for p, v in fwd_paths.items()},
               **small_paths("fwd")}
    return {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:134",
         **fwd_top, "launches": sum(e["launches"] for e in fwd_all.values()),
         "library_ms_covers": "scaled_dot_product_attention's forward",
         "paths": fwd_all, "head_dim_256": wide("fwd", fwd_entry, rows)},
        bwd_kernel("dq", "marlin_tpu/ops/flash_attention.py:335", ("dq",)),
        bwd_kernel("dkv", "marlin_tpu/ops/flash_attention.py:373",
                   ("dk", "dv")),
        *spmm_kernel_entries(spmm, spmm_launches),
    ]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import marlin_tpu_torch  # noqa: F401
    except ImportError:
        fail("marlin_tpu_torch is not importable: run from the repo root")
    card = phase_device()
    if argv == ["--planted-faults"]:
        phase_planted_faults(card)
        return 0
    if len(argv) == 2 and argv[0] == "--compare-with":
        phase_compare(card, argv[1])
        return 0
    if argv:
        fail(f"unknown arguments {argv}: none, --planted-faults or "
             f"--compare-with DIR")
    phase_build()
    rows = phase_kernels()
    bwd = phase_backward()
    phase_backward_memory()
    spmm = phase_spmm(card)
    serve_launches = phase_slice(card)
    launches = phase_train(card)
    launches["serve"] = dict(fwd=serve_launches)
    phase_grad_check()
    small = phase_small_models(card)
    spmm_launches = phase_spmm_path(card)
    spmm_launches["graph512"] = phase_spmm_graph()
    phase_spmm_grad()
    phase_gemm(card)
    kernels = kernels_line(rows, bwd, launches, small, spmm, spmm_launches)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
