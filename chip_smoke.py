#!/usr/bin/env python3
"""Drive the PyTorch port (marlin_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # every phase below
    python3 chip_smoke.py --planted-faults   # the kernel checks' teeth
    python3 chip_smoke.py --compare-with DIR # the kernels against DIR's

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
11. Linalg (the dense path's second half, benchlib/configs_linalg.py's
   sizes, f32 without TF32, on a one-rank NCCL mesh): DenseVecMatrix.
   lu_decompose at n = 16384 and cholesky_decompose at 16384 in "dist"
   mode (panels of 1024), inverse at 8192, and the dist-eigs compute_svd
   of a 200,000 x 2048 matrix (k = 10, tol 1e-6), each 3 times: median ms
   and spread, TFLOP/s (LU 2n^3/3, Cholesky n^3/3, inverse 2n^3), the
   share of the f32 bound (the SVD: of its matvecs' HBM bound), peak
   memory, and the one-call cuSOLVER yardstick beside it (never called by
   the port). Held: LU and Cholesky reconstructions in f64 on a 256-row
   band and whole at n = 2048, max |inv A - I|, the singular values
   non-increasing and against an f64 eigh of the Gramian (bounds and
   their derivations at LINALG_REL_TOLERANCE); then the blocked LU's
   dgetf2 semantics on the card (an all-zero matrix, an exactly zero
   column, a rank-deficient column). Pivot agreement with the one-call
   getrf is printed, not held. Then one torch.profiler pass over the
   n = 16384 LU (recorded, not held): its device time by the op that
   launched each kernel (panel getrf, pivot row swaps and syncs,
   triangular solves, Schur GEMMs and their subtraction, copies) and the
   host idle. No hand-written kernel launched.
12. Dense examples (the dense path's last two, on a one-rank NCCL mesh):
   rmm_compare's three arms (the 3-D grid, all-gather SUMMA and the
   Cannon ring; grid 1 x 1 x 1) at m = k = n = 16384, f32, each through
   the example's own timing (a warm-up, then 3 products between fences),
   seconds and TFLOP/s, a 256-row band of each product against the f64
   product of the same rows (GEMM_REL_TOLERANCE); then neural_network's
   training at MNIST's size (synthetic 60,000 x 784, 10 classes, hidden
   256, batch 512, 50 steps, the example's CLI defaults): the final loss
   finite and below the first, and every step's loss within
   NN_REL_TOLERANCE of a CPU run of the port from the same seed on the
   same index table. No hand-written kernel launched.

Phases 3 and 4 also take head dims in (128, 256] (D = 160, the transformer
bench at BENCH_TF_D=320, and D = 256; bf16 and f32), which the wrapper
pads to the kernels' D = Dv = 256 instantiations, with dK/dV bitwise
repeatable there too; phase 6's small models include a D = 160 and a
D = 256 model, trained through those instantiations. Head dims above 256
(D = 320, 384 under a window, 512, 1024, the pairs (384, 128) and
(64, 320), and two shapes large enough to read a share of the bound:
D = 512 at S = 4096 and DeepSeek-V3's absorbed-MLA widths (576, 512) at
S = 4096 over one KV head; bf16, and the first six in f32) go to the wide
kernels of csrc/flash_attention_wide.cu (bf16 forward, dQ and dK/dV on
wgmma and a TMA ring, dK/dV with the group plan it took, G group parts
summed by a second pass where G > 1; f32 register-tiled FMA fed by a
cp.async ring, each tile's sweep cut into parts by its live work): phases
3 and 4 hold them to the plain versions by the same limits, their dQ and
dK/dV bitwise over two runs and every forward output chunk's lse equal to
the others, and phase 6
trains a D = 320 model through them (its launches are the wide kernels'
counts; no D <= 256 run launches a wide kernel). At every f32 shape
phases 3 and 4 name the backend scaled_dot_product_attention took (the
kernels one call launched, by torch.profiler) and whether its output is
within the f32 limits the port's kernels are held to. The f32 dK/dV,
narrow and wide, is one design (csrc/flash_dkv_f32.cuh): phase 4 holds it
bitwise over two runs at every f32 shape (with P = 1 and P > 1 sweep
parts) and prints its plan (P, chunk, column shares, workspace bytes);
the f32 forward and dQ, narrow and wide, are one design too
(csrc/flash_fwd_dq_f32.cuh): phases 3 and 4 print their plans and hold
them at every f32 shape with their plan's P and with the other of 1 and
2 (other_parts): O and lse to the plain version's limits, the wide
forward's lse copies equal, dQ bitwise over two runs at each P.
LARGE_F32_SHAPES (the flagship step's attention in f32, and D = Dv = 512
at S = 2048 under GQA) read its share of the bound.

The last three lines of output are the card line from nvidia-smi, one
{"kernels": [...]} JSON object, and {"ok": true, "device": {...}}.

With ``--planted-faults`` it runs phase 1, then builds the forward source
with each fault of FWD_PLANTED_FAULTS, the backward source with each fault
of PLANTED_FAULTS, the wide source with each fault of WIDE_KERNEL_FAULTS
and the SpMM source with each fault of SPMM_PLANTED_FAULTS into a
temporary directory and prints, at every shape of the forward and
backward checks but the LARGE_F32_SHAPES and at every bf16 SpMM shape,
the sound kernels' and each fault's reading of the check; it fails unless
the check's limit (the shape's dtype's) separates them wherever the fault
can show.

With ``--compare-with DIR`` it runs phase 1, then builds DIR's forward,
backward, wide and SpMM sources (another checkout, e.g. the parent commit
unpacked by ``git archive``) and this tree's KERNEL_VARIANTS, holds each
against the plain version and times dQ at the train and remat shapes, both SpMM
routes at bench512 and coo128, the wide bf16 forward, dQ and dK/dV at
the LARGE_WIDE_SHAPES, the f32 dK/dV (narrow and wide) at PERF.md's f32
table shapes and the LARGE_F32_SHAPES and the f32 forward and dQ
(narrow and wide) at the same shapes, warm and cold, in two rounds in
opposite orders; beside them the wide kernels' ablations (wide_ablations:
no TMA loads, no logit products, loads only, the ring's sync only), the
f32 dK/dV's (F32_DKV_ABLATIONS) and the f32 forward's and dQ's
(F32_Q_ABLATIONS), timed, not held, and at the f32 shapes SDPA's forward
or whole backward with its backend.
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
    # Head dims above 256, which go to the wide kernels of
    # csrc/flash_attention_wide.cu (D and Dv each zero-padded to a multiple
    # of 64): D = 320 at the attention shape of phase 6's wide_d320 model
    # (the main path of the wide kernels), 384 under a window, 512, 1024,
    # and unequal pairs (384, 128) and a cross-length (64, 320); causal,
    # GQA, bf16 and f32.
    ("d320", 2, 512, 512, 2, 2, 320, 320, "bfloat16", True, 0),
    ("d384_window", 1, 1024, 1024, 4, 2, 384, 384, "bfloat16", True, 200),
    ("d512", 1, 1024, 1024, 4, 4, 512, 512, "bfloat16", True, 0),
    ("d1024", 1, 512, 512, 4, 1, 1024, 1024, "bfloat16", True, 0),
    ("d384_dv128", 1, 1000, 1000, 4, 2, 384, 128, "bfloat16", True, 0),
    ("d64_dv320", 1, 384, 1000, 4, 2, 64, 320, "bfloat16", False, 0),
    # The wide kernels at sizes whose bounds exceed a launch's overhead
    # (LARGE_WIDE_SHAPES): D = Dv = 512 at S = 4096 (MHA), and the
    # attention widths of DeepSeek-V3's absorbed multi-head latent
    # attention (its config.json: kv_lora_rank 512 + qk_rope_head_dim 64 =
    # 576 for q and k, kv_lora_rank 512 for v, over one latent KV head; its
    # 128 heads cut to 16, one of eight tensor-parallel shards). Kernel
    # measurement shapes, not model configurations.
    ("d512_s4096", 2, 4096, 4096, 8, 8, 512, 512, "bfloat16", True, 0),
    ("mla_d576_dv512", 1, 4096, 4096, 16, 1, 576, 512, "bfloat16", True, 0),
    ("d320_f32", 2, 512, 512, 2, 2, 320, 320, "float32", True, 0),
    ("d384_window_f32", 1, 1000, 1000, 2, 1, 384, 384, "float32", True,
     200),
    ("d512_f32", 1, 512, 512, 2, 2, 512, 512, "float32", True, 0),
    ("d1024_f32", 1, 512, 512, 2, 1, 1024, 1024, "float32", True, 0),
    ("d384_dv128_f32", 1, 1000, 1000, 4, 2, 384, 128, "float32", True, 0),
    ("d64_dv320_f32", 1, 384, 1000, 4, 2, 64, 320, "float32", False, 0),
    # The f32 kernels at sizes whose bounds exceed a launch's overhead
    # (LARGE_F32_SHAPES): the flagship training step's attention in f32
    # (B = 8, S = 2048, 8 heads over 2 KV heads, D = 128; the f32 dK/dV's
    # bound 2.05 ms) and D = Dv = 512 at S = 2048 under GQA (1.03 ms, the
    # wide kernels). Kernel measurement shapes, not model configurations.
    ("train_f32", 8, 2048, 2048, 8, 2, 128, 128, "float32", True, 0),
    ("d512_s2048_f32", 1, 2048, 2048, 8, 2, 512, 512, "float32", True, 0),
]

# The shapes whose kernels are the D = Dv = 256 instantiations.
WIDE_SHAPES = ("d160", "d256", "d160_f32", "d256_f32")

# The shapes whose kernels are the wide ones (a head dim above 256).
WIDE_KERNEL_SHAPES = tuple(s[0] for s in SHAPES if max(s[6], s[7]) > 256)

# The wide shapes large enough to read a share of the bound, which
# --compare-with times.
LARGE_WIDE_SHAPES = ("d512_s4096", "mla_d576_dv512")

# The f32 shapes large enough to read a share of the bound; timed and
# checked like LARGE_WIDE_SHAPES, and left out of --planted-faults.
LARGE_F32_SHAPES = ("train_f32", "d512_s2048_f32")

SHAPE_BY_NAME = {s[0]: s for s in SHAPES}

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
# first occurrence of the text, in the bf16 kernel or in the f32 kernel's
# own cut of its work and its second pass), built like PLANTED_FAULTS
# below. The forward check must pass the sound kernels and fail every bf16
# fault at every bf16 forward shape, every f32 one at the f32 shapes of
# the narrow kernels (F32_FAULT_SHOWS).
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
    # Every sweep part of the f32 forward (flash_fwd_f32) leaves out its
    # last key tile.
    "fwd_f32_part_drops_last_key_tile": (
        "  const int kt1 = min(kt0 + a.chunk, first + n);\n",
        "  const int kt1 = min(kt0 + a.chunk, first + n) - 1;\n"),
    # The f32 forward's second pass leaves out a query tile's last part.
    "fwd_f32_merge_drops_last_part": (
        "    if (parts > 1) fwd_dq_f32::merge_parts(a, e, parts);\n",
        "    if (parts > 1) fwd_dq_f32::merge_parts(a, e, parts - 1);\n"),
}

# Planted faults of the backward (``python3 chip_smoke.py
# --planted-faults``): each is one edit of csrc/flash_attention_bwd.cu
# (the first occurrence of the text: in the bf16 kernels, or in the f32
# dK/dV's own cut of its work), built into a temporary directory outside
# the checkout. The backward check must pass the sound kernels and fail
# every bf16 fault at every bf16 backward shape, every f32 one at the f32
# shapes of the narrow kernels (F32_FAULT_SHOWS).
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
    # The f32 dK/dV (flash_bwd_dkv_f32) sweeps each query head one query
    # tile short.
    "dkv_f32_drops_last_query_tile": (
        "  dkv_f32::query_tiles(c.t * dkv_f32::kKeys, a.Sq, a.causal, "
        "a.window,\n                       &tile0, &n_qt);\n",
        "  dkv_f32::query_tiles(c.t * dkv_f32::kKeys, a.Sq, a.causal, "
        "a.window,\n                       &tile0, &n_qt);\n"
        "  n_qt -= n_qt > 0;\n"),
    # Every sweep part of the f32 dK/dV leaves out its last (query head,
    # query tile) pair.
    "dkv_f32_part_drops_last_pair": (
        "  const int last = min(first + a.chunk, pairs);\n",
        "  const int last = min(first + a.chunk, pairs) - 1;\n"),
    # The f32 dK/dV's second pass leaves out a key tile's last part (it
    # runs only where the plan has P > 1).
    "dkv_f32_sum_drops_last_part": (
        "    if (parts > 1) dkv_f32::sum_parts(a, e, parts);\n",
        "    if (parts > 1) dkv_f32::sum_parts(a, e, parts - 1);\n"),
    # Every sweep part of the f32 dQ (flash_bwd_dq_f32) leaves out its last
    # key tile.
    "dq_f32_part_drops_last_key_tile": (
        "  const int kt1 = min(kt0 + a.chunk, first + n);\n",
        "  const int kt1 = min(kt0 + a.chunk, first + n) - 1;\n"),
    # The f32 dQ's second pass leaves out a query tile's last part.
    "dq_f32_sum_drops_last_part": (
        "    if (parts > 1) fwd_dq_f32::sum_parts(a, e, parts);\n",
        "    if (parts > 1) fwd_dq_f32::sum_parts(a, e, parts - 1);\n"),
}

# The planted faults of the narrow f32 kernels, each shown at the f32
# shapes of the narrow kernels only, by its own kernel's check ("forward"
# or "backward"), where it can (None: at every such shape). The forward
# check reads the plan's P and the other of 1 and 2 (other_parts), so a
# fault of its second pass shows wherever a query tile has two key tiles
# or more (at P = 2 the most loaded one has two parts); the backward check
# reads the plans' P, so a fault of the dK/dV's or dQ's second pass shows
# where that plan has P > 1.
F32_FAULT_SHOWS = {
    "dkv_f32_drops_last_query_tile": ("backward", None),
    "dkv_f32_part_drops_last_pair": ("backward", None),
    "dkv_f32_sum_drops_last_part": (
        "backward", lambda s: f32_dkv_plan(s).parts > 1),
    "fwd_f32_part_drops_last_key_tile": ("forward", None),
    "fwd_f32_merge_drops_last_part": (
        "forward",
        lambda s: max(n for _, n in f32_q_plan(s, "fwd").tiles) > 1),
    "dq_f32_part_drops_last_key_tile": ("backward", None),
    "dq_f32_sum_drops_last_part": (
        "backward", lambda s: f32_q_plan(s, "dq").parts > 1),
}

# The planted faults of the flash kernels that only the D = Dv = 256
# instantiation runs: a shape of another width must read them as sound.
WIDE_FAULTS = ("fwd256_second_half_reads_first_v_half",
               "dq256_second_half_reads_first_k_half",
               "dkv256_second_share_reads_first_columns")

# Planted faults of the wide kernels (csrc/flash_attention_wide.cu, or a
# header it includes): two for each bf16 kernel (one of them a fault of the
# split of the output's columns between its two consumer warpgroups) and
# one of the bf16 dK/dV's second pass, three of the f32 forward (its
# rescale, its second pass, its column shares), two of the f32 dQ (its
# dP, its second pass) and two of the f32 dK/dV (its sweep, its column
# shares). Each is shown only at the WIDE_KERNEL_SHAPES of its dtype, by
# the check of its own kernel (WIDE_KERNEL_FAULT_CHECK).
WIDE_KERNEL_FAULTS = {
    # The bf16 forward does not rescale O when a row's running max grows.
    "wide_fwd_skips_o_rescale": (
        "    for (int e = 0; e < kMaxBoxes * 32; ++e) "
        "acc[e] *= corr[(e >> 1) & 1];\n",
        "    for (int e = 0; e < 0; ++e) acc[e] *= corr[(e >> 1) & 1];\n"),
    # The bf16 forward's second consumer adds P times the first consumer's
    # V columns into its own columns of O (the producer loads the first
    # consumer's V boxes in place of the second's).
    "wide_fwd_second_consumer_reads_first_v_columns": (
        "&tv, &full[p.s],\n                            sp.col(w, x0 + x),",
        "&tv, &full[p.s],\n                            sp.col(0, x0 + x),"),
    # The bf16 dQ's dP = dO V^T leaves out Dv's last 64-column box (the
    # producer and the consumers agree on the shorter sweep).
    "wide_dq_drops_last_dv_chunk": (
        "  const int ndv = DV / 64;\n",
        "  const int ndv = DV / 64 - 1;\n"),
    # The bf16 dQ's second consumer adds dS times the first consumer's K
    # columns into its own columns of dQ.
    "wide_dq_second_consumer_reads_first_k_columns": (
        "&tk, &full[p.s],\n                            sp.col(w, x0 + x),",
        "&tk, &full[p.s],\n                            sp.col(0, x0 + x),"),
    # The f32 forward (flash_fwd_dq_f32.cuh) does not rescale O when a
    # row's running max grows.
    "wide_f32_fwd_skips_o_rescale": (
        "        acc[q][i] = scale4(acc[q][i], corr);\n",
        "        acc[q][i] = scale4(acc[q][i], 1.f);\n"),
    # The f32 forward's second pass leaves out a query tile's last part.
    "wide_f32_fwd_merge_drops_last_part": (
        "    if (parts > 1) fwd_dq_f32::merge_parts(a, e, parts);\n",
        "    if (parts > 1) fwd_dq_f32::merge_parts(a, e, parts - 1);\n"),
    # The f32 forward's shares past the first add P times the first
    # share's V columns into their own columns of O.
    "wide_f32_fwd_second_share_reads_first_v_columns": (
        "      a, c, kt0, kt1, s, a.v + flash_f32::kBox * s.b0, parts,\n",
        "      a, c, kt0, kt1, s, a.v, parts,\n"),
    # The f32 dQ's dP = dO V^T leaves out Dv's last 64-column box (its
    # loads and its products agree on the shorter sweep).
    "wide_f32_dq_drops_last_dv_box": (
        "  const int n_v = a.DV / kBox;\n",
        "  const int n_v = a.DV / kBox - 1;\n"),
    # The f32 dQ's second pass leaves out a query tile's last part.
    "wide_f32_dq_sum_drops_last_part": (
        "    if (parts > 1) fwd_dq_f32::sum_parts(a, e, parts);\n",
        "    if (parts > 1) fwd_dq_f32::sum_parts(a, e, parts - 1);\n"),
    # The f32 dK/dV kernel's (flash_bwd_dkv_wide_f32) sweep of each query
    # head stops one query tile short.
    "wide_dkv_drops_last_query_tile": (
        "  dkv_f32::query_tiles(c.t * dkv_f32::kKeys, a.Sq, a.causal, "
        "a.window,\n                       &tile0, &n_qt);\n",
        "  dkv_f32::query_tiles(c.t * dkv_f32::kKeys, a.Sq, a.causal, "
        "a.window,\n                       &tile0, &n_qt);\n"
        "  n_qt -= n_qt > 0;\n"),
    # The f32 dK/dV's column shares past the first of their role add dS^T
    # q_hat (P^T dO) over the first share's columns into their own.
    "wide_f32_dkv_second_share_reads_first_columns": (
        "a.q + dkv_f32::kBox * s.dk0,\n"
        "      a.dout + dkv_f32::kBox * s.dv0,",
        "a.q,\n      a.dout,"),
    # The bf16 dK/dV's dK parts: the second consumer adds dS^T times the
    # first consumer's q_hat columns into its own columns of dK (the
    # producer loads the first consumer's boxes in place of the second's).
    "wide_dkv_dk_second_consumer_reads_first_q_columns": (
        "sp.col(w, x0 + x), h, m0, b);",
        "sp.col(dkp ? 0 : w, x0 + x), h, m0, b);"),
    # The bf16 dK/dV's dV parts stop each query head's sweep one query
    # tile short (the producer and the consumers agree on it).
    "wide_dkv_dv_drops_last_query_tile": (
        "  const int n_qt = hi > lo ? (hi - lo) / kDkvBM : 0;",
        "  const int n_qt = hi > lo ? (hi - lo) / kDkvBM - !dkp : 0;"),
    # The bf16 dK/dV's second pass leaves out the last group part.
    "wide_dkv_sum_drops_last_group_part": (
        "    for (int g = 0; g < G; ++g) {\n",
        "    for (int g = 0; g < G - 1; ++g) {\n"),
}


def _boxes(width: int) -> int:
    """64-column boxes of a head dim padded for the wide kernels."""
    return -(-width // 64)


# Each wide fault's check ("forward" or "backward"), the dtype of the
# shapes whose kernels it breaks (None: both) and, where not every such
# shape can show it, which can: a fault of the column split shows where the
# CTA has two output boxes or more (Dv for the forward, D for dQ), or
# where there are two column shares; a fault of a second pass where the
# plan has P > 1. The f32 forward's check reads the plan's P and P = 1
# (every wide f32 shape has a query tile of several key tiles, whose
# rescale only P = 1 keeps in one CTA).
WIDE_KERNEL_FAULT_CHECK = {
    "wide_fwd_skips_o_rescale": ("forward", "bfloat16", None),
    "wide_fwd_second_consumer_reads_first_v_columns": (
        "forward", "bfloat16", lambda s: _boxes(s[7]) >= 2),
    "wide_dq_drops_last_dv_chunk": ("backward", "bfloat16", None),
    "wide_dq_second_consumer_reads_first_k_columns": (
        "backward", "bfloat16", lambda s: _boxes(s[6]) >= 2),
    "wide_f32_fwd_skips_o_rescale": ("forward", "float32", None),
    "wide_f32_fwd_merge_drops_last_part": (
        "forward", "float32", lambda s: f32_q_plan(s, "fwd").parts > 1),
    "wide_f32_fwd_second_share_reads_first_v_columns": (
        "forward", "float32", lambda s: len(f32_q_plan(s, "fwd").shares) > 1),
    "wide_f32_dq_drops_last_dv_box": ("backward", "float32", None),
    "wide_f32_dq_sum_drops_last_part": (
        "backward", "float32", lambda s: f32_q_plan(s, "dq").parts > 1),
    "wide_dkv_drops_last_query_tile": ("backward", "float32", None),
    "wide_f32_dkv_second_share_reads_first_columns": (
        "backward", "float32", lambda s: any(
            sh[0] or sh[2] for sh in f32_dkv_plan(s).shares)),
    "wide_dkv_dk_second_consumer_reads_first_q_columns": (
        "backward", "bfloat16", lambda s: _boxes(s[6]) >= 2),
    "wide_dkv_dv_drops_last_query_tile": ("backward", "bfloat16", None),
    "wide_dkv_sum_drops_last_group_part": (
        "backward", "bfloat16", lambda s: dkv_plan(s).group_parts > 1),
}


def dkv_plan(shape):
    """The bf16 wide dK/dV kernel's plan (_wide_dkv_plan) at ``shape`` on
    this card: its parts and its group parts G."""
    import torch

    from marlin_tpu_torch.ops import flash_attention as fa

    _, b, _, skv, h, hk, d, dv = shape[:8]
    return fa._wide_dkv_plan(b, h, hk, skv, *fa._kernel_head_dims(d, dv),
                             fa._sm_count(torch.device("cuda")))


def f32_dkv_plan(shape):
    """The f32 dK/dV kernels' plan (_f32_dkv_plan) at ``shape`` on this
    card: its column shares, its sweep parts P and its workspace."""
    import torch

    from marlin_tpu_torch.ops import flash_attention as fa

    _, b, sq, skv, h, hk, d, dv, _, causal, window = shape
    return fa._f32_dkv_plan(b, h, hk, sq, skv, *fa._kernel_head_dims(d, dv),
                            causal, window,
                            fa._sm_count(torch.device("cuda")))


def f32_q_plan(shape, kind, parts=None):
    """The f32 forward's (``kind`` "fwd") or dQ's ("dq") plan
    (_f32_q_plan) at ``shape`` on this card: its column shares, its sweep
    parts P (``parts`` where given) and its workspace."""
    import torch

    from marlin_tpu_torch.ops import flash_attention as fa

    _, b, sq, skv, h, hk, d, dv, _, causal, window = shape
    return fa._f32_q_plan(kind, b, h, hk, sq, skv,
                          *fa._kernel_head_dims(d, dv), causal, window,
                          fa._sm_count(torch.device("cuda")), parts)


def other_parts(plan) -> int:
    """The P a check runs beside an f32 plan's own: 1 where the plan cuts
    its tiles into parts, else 2, so that both the sweep's own stores and
    the second pass are held at every shape."""
    return 1 if plan.parts > 1 else 2


def plan_summary(plan) -> dict:
    """An f32 plan's shares, P, chunk and workspace bytes, for a row."""
    return dict(shares=len(plan.shares), parts=plan.parts, chunk=plan.chunk,
                workspace_bytes=plan.workspace_bytes)


def planted_shape(name: str, check: str) -> bool:
    """Whether ``--planted-faults`` reads ``check`` ("forward" or
    "backward") at shape ``name``: every shape, bf16 and f32, narrow and
    wide, but the LARGE_F32_SHAPES."""
    return name not in LARGE_F32_SHAPES


def flash_fault_shows(fault: str, shape: str, check: str) -> bool:
    """Whether planted flash fault ``fault`` can show at ``shape`` in the
    ``check`` ("forward" or "backward") of its source's kernels: a fault of
    the wide kernels at the WIDE_KERNEL_SHAPES of its dtype only, where it
    can, in its own kernel's check; one of the D = 256 instantiation at the
    WIDE_SHAPES only; every other one (the narrow bf16 kernels') at every
    bf16 shape but the WIDE_KERNEL_SHAPES (whose calls never reach the
    narrow kernels); one of the narrow f32 kernels at the f32 shapes of the
    narrow kernels, in its own kernel's check, where it can
    (F32_FAULT_SHOWS)."""
    s = SHAPE_BY_NAME[shape]
    if fault in F32_FAULT_SHOWS:
        kernel_check, can = F32_FAULT_SHOWS[fault]
        return (check == kernel_check and s[8] == "float32"
                and shape not in WIDE_KERNEL_SHAPES
                and (can is None or can(s)))
    if fault in WIDE_KERNEL_FAULTS:
        kernel_check, dtype, can = WIDE_KERNEL_FAULT_CHECK[fault]
        return (shape in WIDE_KERNEL_SHAPES and kernel_check == check
                and dtype in (None, s[8]) and (can is None or can(s)))
    if shape in WIDE_KERNEL_SHAPES or s[8] != "bfloat16":
        return False
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


def wide_fwd(fa, q_hat, k, v, causal, window, parts=None,
             lse_chunks=False):
    """The wide forward kernel on inputs padded to its head dims, O sliced
    back: (O, lse, every output chunk's lse or None); ``parts`` sets an
    f32 kernel's P (the plan's where None)."""
    dp, dvp = fa._kernel_head_dims(q_hat.shape[-1], v.shape[-1])
    o, lse, chunks = fa._launch_wide(
        fa._pad_to(q_hat, dp), fa._pad_to(k, dp), fa._pad_to(v, dvp),
        causal, window, lse_chunks=lse_chunks, parts=parts)
    return o[..., :v.shape[-1]], lse, chunks


def fwd_with_parts(fa, q_hat, k, v, causal, window, parts):
    """The forward kernel, narrow or wide, with an f32 kernel's sweep parts
    P = ``parts``, through the wrapper's padding: (O, lse)."""
    return fa._padded_fwd(lambda *args: fa._launch(*args, parts=parts),
                          q_hat, k, v, causal, window)


def check_lse_chunks(fa, name, q_hat, k, v, causal, window, lse):
    """The wide forward's output-column chunks each compute lse: every
    chunk's copy must equal ``lse`` (the wrapper's) bit for bit, and for
    f32 so must those of a run with the other P (other_parts: the sweep
    writes them where a tile has one part, the second pass where it has
    several) equal each other."""
    import torch

    runs = [None]
    if q_hat.dtype == torch.float32:
        runs.append(other_parts(f32_q_plan(SHAPE_BY_NAME[name], "fwd")))
    for parts in runs:
        _, own, chunks = wide_fwd(fa, q_hat, k, v, causal, window, parts,
                                  lse_chunks=True)
        torch.cuda.synchronize()
        want = lse if parts is None else own
        if not all(torch.equal(c, want) for c in chunks):
            fail(f"kernel {name}: the wide forward's {chunks.shape[0]} "
                 f"output chunks disagree on lse (P = {parts or 'plan'})")


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
        ref = plain()
        err_o, err_lse, tile_o = check_forward(f"kernel {name}", o_k, lse_k,
                                               *ref, dt)
        if name in WIDE_KERNEL_SHAPES:
            check_lse_chunks(fa, name, q_hat, kk, vv, causal, window, lse_k)
        if dt == "float32":
            # The f32 forward with the other P too (other_parts): its own
            # stores where the plan cuts tiles into parts, else the second
            # pass, held to the same limits.
            p = other_parts(f32_q_plan(SHAPE_BY_NAME[name], "fwd"))
            o_p, lse_p = fwd_with_parts(fa, q_hat, kk, vv, causal, window, p)
            torch.cuda.synchronize()
            check_forward(f"kernel {name} (P = {p})", o_p, lse_p, *ref, dt)
            del o_p, lse_p
        ms = cuda_ms(kernel, iters=20)
        cold_ms = cuda_ms_cold(kernel, iters=10)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        lib_ms, lib_lo, lib_hi = library_ms(F, q, k, v, causal, window)
        extra = {}
        if dt == "float32":
            extra = dict(sdpa_f32_fwd(F, q, k, v, causal, window, ref[0]),
                         fwd_plan=plan_summary(
                             f32_q_plan(SHAPE_BY_NAME[name], "fwd")))
        del ref
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
                   tflops=flops / (ms * 1e-3) / 1e12, **extra)
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


def _sdpa_bwd_call(F, q, k, v, do, causal, window):
    """A call of the backward of torch's scaled_dot_product_attention on
    these inputs (the yardstick, never called by the port: dQ, dK and dV
    in one call, heads-first), or None where it does not take the case."""
    import torch

    args = _sdpa_args(q, k, v, causal, window)
    if args is None:
        return None
    qt, kt, vt, kw = args
    leaves = [x.detach().contiguous().requires_grad_(True)
              for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, **kw)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


def library_bwd_ms(F, q, k, v, do, causal, window):
    """The backward of torch's scaled_dot_product_attention on the same
    inputs (_sdpa_bwd_call): (median, min, max) ms over 5 repeats of 10
    calls after a warm-up, since a single reading of it wanders between
    runs; Nones where it does not take the case."""
    try:
        call = _sdpa_bwd_call(F, q, k, v, do, causal, window)
        if call is None:
            return None, None, None
        return cuda_ms_spread(call, iters=10)
    except (RuntimeError, TypeError) as e:  # the yardstick only
        print(f"  library: scaled_dot_product_attention backward "
              f"unavailable for this case: {e}")
        return None, None, None


def sdpa_backend(fn):
    """(backend, kernel names): the CUDA kernels one call of ``fn`` (a call
    of scaled_dot_product_attention or of its backward) launched, by
    torch.profiler, and the backend their names show ("flash",
    "efficient", "cudnn", else "math")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    text = " ".join(names).lower()
    for backend, marks in (("flash", ("flash",)),
                           ("efficient", ("fmha", "efficient", "mem_eff")),
                           ("cudnn", ("cudnn",))):
        if any(m in text for m in marks):
            return backend, names
    return "math", names


def sdpa_f32_fwd(F, q, k, v, causal, window, o_ref):
    """At an f32 shape: the backend scaled_dot_product_attention took and
    its O against the plain version's, held (not failed) to the limit of
    the port's f32 forward, TOLERANCE's 1e-4: a library time outside it
    is no yardstick."""
    args = _sdpa_args(q, k, v, causal, window)
    if args is None:
        return dict(library_backend=None)
    qt, kt, vt, kw = args

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    try:
        backend, names = sdpa_backend(call)
        err = (call().transpose(1, 2).float() - o_ref.float()).abs().max()
    except (RuntimeError, TypeError):  # the yardstick only
        return dict(library_backend=None)
    return dict(library_backend=backend, library_kernels=names[:6],
                library_max_abs_err=err.item(),
                library_within_limits=err.item() <= TOLERANCE["float32"][0])


def sdpa_f32_bwd(F, c, ref):
    """The same for the backward at an f32 BwdCase ``c``: SDPA's dQ, dK and
    dV against the plain backward's (``ref``) by the worst tile, held (not
    failed) to BWD_TOLERANCE's 1e-5, the port's f32 backward limit."""
    try:
        call = _sdpa_bwd_call(F, c.q, c.k, c.v, c.do, c.causal, c.window)
        if call is None:
            return dict(library_backend=None)
        backend, names = sdpa_backend(call)
        errs = bwd_errors([g.transpose(1, 2) for g in call()], ref)
    except (RuntimeError, TypeError):  # the yardstick only
        return dict(library_backend=None)
    worst = max(e["tile_rel"] for e in errs.values())
    return dict(library_backend=backend, library_kernels=names[:6],
                library_tile_rel_err=worst,
                library_global_rel_err=max(e["global_rel"]
                                           for e in errs.values()),
                library_within_limits=worst <= BWD_TOLERANCE["float32"])


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

    def dq(self, parts=None):
        return self.fa._launch_bwd_dq(*self.padded, self.lse, self.delta,
                                      self.causal, self.window, self.scale,
                                      parts)[..., :self.d]

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
        ref = c.plain()
        errs = bwd_errors(got, ref)
        for label, e in errs.items():
            rel = e["tile_rel"]
            if not math.isfinite(rel) or rel > BWD_TOLERANCE[dt]:
                fail(f"backward {name}: {label}'s worst tile "
                     f"||kernel - plain|| / ||plain|| = {rel:.3e} "
                     f"(tol {BWD_TOLERANCE[dt]})")
        if (name in ("train", "d160", "d256") + WIDE_KERNEL_SHAPES
                or dt == "float32"):
            # No atomics: two runs agree bit for bit.
            dq2, (dk2, dv2) = c.dq(), c.dkv()
            if not torch.equal(got[0], dq2):
                fail(f"backward {name}: dQ differs between two runs")
            if not (torch.equal(got[1], dk2) and torch.equal(got[2], dv2)):
                fail(f"backward {name}: dK/dV differ between two runs")
        if dt == "float32":
            # The f32 dQ with the other P too (other_parts): within the
            # limit, bitwise over two runs.
            p = other_parts(f32_q_plan(shape, "dq"))
            one, one2 = c.dq(parts=p), c.dq(parts=p)
            rel = tile_rel_err(one, ref[0])
            if not torch.equal(one, one2):
                fail(f"backward {name}: dQ (P = {p}) differs between two "
                     f"runs")
            if not rel <= BWD_TOLERANCE[dt]:
                fail(f"backward {name}: dQ (P = {p})'s worst tile "
                     f"{rel:.3e} (tol {BWD_TOLERANCE[dt]})")
        ms_dq = cuda_ms(c.dq, iters=10)
        ms_dq_cold = cuda_ms_cold(c.dq, iters=10)
        ms_dkv = cuda_ms(c.dkv, iters=10)
        ms_dkv_cold = cuda_ms_cold(c.dkv, iters=10)
        plain_ms = cuda_ms(c.plain, warmup=1, iters=2)
        lib_ms, lib_lo, lib_hi = library_bwd_ms(F, c.q, c.k, c.v, c.do,
                                                c.causal, c.window)
        extra = {}
        if dt == "float32":
            plan = f32_dkv_plan(shape)
            extra = dict(sdpa_f32_bwd(F, c, ref), dkv_parts=plan.parts,
                         dkv_chunk=plan.chunk, dkv_shares=len(plan.shares),
                         dkv_workspace_bytes=plan.workspace_bytes)
            extra["dq_plan"] = plan_summary(f32_q_plan(shape, "dq"))
        elif name in WIDE_KERNEL_SHAPES:
            plan = dkv_plan(shape)
            extra = dict(dkv_group_parts=plan.group_parts,
                         dkv_parts=len(plan.parts),
                         dkv_workspace_bytes=plan.workspace_bytes)
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
                   dq_bound_share=b_dq[0] / ms_dq,
                   dkv_bound_ms=b_dkv[0], dkv_bound_by=b_dkv[1],
                   dkv_bound_share=b_dkv[0] / ms_dkv,
                   dq_tflops=2.0 * pairs * (2 * d + dv) / ms_dq / 1e9,
                   dkv_tflops=2.0 * pairs * (2 * d + 2 * dv) / ms_dkv / 1e9,
                   **extra)
        rows[name] = row
        print("backward: " + json.dumps(row), flush=True)
        del c, got, ref
    return rows


# Planted faults of the SpMM kernels: each is one edit of
# csrc/block_sparse.cu (or of the header it includes that has the text).
# The SpMM check must pass the sound kernels and fail each fault at every
# SpMM shape where the fault can show (SPMM_FAULT_SHOWS); at the f32
# shapes both routes run at the plan's P and at the other of 1 and 2, as
# phase_spmm runs them.
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
    # The f32 kernel (both routes): each sweep part stops one block short
    # of its run of the column's live blocks.
    "f32_part_drops_last_live_block": (
        "  return (hi - lo) * (g.bs / kFStep);\n",
        "  return (hi - lo - (hi > lo)) * (g.bs / kFStep);\n"),
    # The f32 second pass adds every part but the last.
    "f32_sum_drops_last_part": (
        "    for (int q = 1; q < parts; ++q) {\n",
        "    for (int q = 1; q < parts - 1; ++q) {\n"),
    # The f32 box product (flash_f32.cuh's tile_out, copied for this
    # build) skips the last 4 of each box's 64 depth columns.
    "f32_box_product_skips_last_4_depth_columns": (
        "  for (int m = 0; m < 64; m += 4) {\n",
        "  for (int m = 0; m < 60; m += 4) {\n"),
}

# The kernels each SpMM fault breaks, the dtypes it reaches and whether a
# case can show it: the faults of the list walk, the count, the part runs
# and the box product wherever some block is live, the bf16 ring's only
# at bf16 and the f32 kernel's only at f32 (the list walk, the mask test
# and the count are shared by both dtypes), the mask test wherever some
# block is dead (the check's backing array is not zeroed under dead
# blocks); the f32 second pass's at every f32 shape with a live block,
# since the check runs P = 2 where the plan's P is 1 (the last of two
# parts holds the column's last live block).
SPMM_FAULT_SHOWS = {
    "gather_drops_last_listed_block": (("gather",), ("bfloat16", "float32"),
                                       lambda c: c.nnz > 0),
    "ring_skips_last_k16_of_a_stage": (("gather", "masked"), ("bfloat16",),
                                       lambda c: c.nnz > 0),
    "masked_ignores_the_mask": (("masked",), ("bfloat16", "float32"),
                                lambda c: c.nnz < c.mask.numel()),
    "masked_count_stops_one_block_short": (("masked",),
                                           ("bfloat16", "float32"),
                                           lambda c: c.nnz > 0),
    "f32_part_drops_last_live_block": (("gather", "masked"), ("float32",),
                                       lambda c: c.nnz > 0),
    "f32_sum_drops_last_part": (("gather", "masked"), ("float32",),
                                lambda c: c.nnz > 0),
    "f32_box_product_skips_last_4_depth_columns": (
        ("gather", "masked"), ("float32",), lambda c: c.nnz > 0),
}


def _build_planted(sets, tmp, parent=None):
    """Build every fault of ``sets`` ({source name: {fault: edit}}, an
    edit being (old text, new text) or a list of them, each applied to its
    first occurrence in the source or, where the source lacks it, in the
    first shared header (csrc/*.cuh) that has it, built from a copy of the
    headers) into ``tmp``, one nvcc per fault, all started together; with
    ``parent`` (another checkout's csrc directory), that checkout's source
    of each name too, as "parent". Returns {source name: {"sound": lib,
    fault: lib, ..., "parent": lib}}."""
    import ctypes
    from pathlib import Path

    from marlin_tpu_torch.ops import build

    build.build()
    headers = {h.name: h.read_text()
               for h in sorted(build.CSRC_DIR.glob("*.cuh"))}
    procs = {}
    for name, faults in sets.items():
        source = build.SOURCES[name].read_text()
        for fault, edits in faults.items():
            text, heads = source, dict(headers)
            for old, new in [edits] if isinstance(edits, tuple) else edits:
                where = next((h for h, t in heads.items() if old in t), None)
                if old in text:
                    text = text.replace(old, new, 1)
                elif where is not None:
                    heads[where] = heads[where].replace(old, new, 1)
                else:
                    fail(f"planted fault {fault}: its text is not in the "
                         f"source")
            inc = None
            if heads != headers:
                inc = Path(tmp) / f"{name}-{fault}-include"
                inc.mkdir()
                for h, t in heads.items():
                    (inc / h).write_text(t)
            src = Path(tmp) / f"{name}-{fault}.cu"
            src.write_text(text)
            lib = Path(tmp) / f"lib{name}-{fault}.so"
            procs[name, fault] = (lib, subprocess.Popen(
                build.nvcc_command(src, lib, include=inc),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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


def _flash_variants(libs):
    """[(variant, source, lib)] of ``libs`` ({source name: {"sound": lib,
    fault: lib, ...}}): "sound" (source None: nothing swapped) and every
    planted fault of every source."""
    out = [("sound", None, None)]
    for source, by_fault in libs.items():
        out += [(f, source, lib) for f, lib in by_fault.items()
                if f != "sound"]
    return out


def _with_variant(libs, source, lib, fn):
    """``fn()`` with ``lib`` loaded as ``source``'s library (nothing
    swapped when ``source`` is None), the sound one restored after."""
    from marlin_tpu_torch.ops import build

    if source is None:
        return fn()
    build._loaded[source] = lib
    try:
        return fn()
    finally:
        build._loaded[source] = libs[source]["sound"]


def _planted_forward(libs):
    """The forward check's reading of the sound kernels and of each fault
    (``libs``: {source: {variant: lib}} of the forward and wide sources) at
    every forward shape of planted_shape (O's worst 64-row tile, with max
    |O err| beside it): (worst sound reading by dtype, whether the limit of
    the shape's dtype separated them at every shape)."""
    import torch

    from marlin_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_sound, caught = {}, True
    for (name, b, sq, skv, h, hk, d, dv, dt, causal,
         window) in SHAPES:
        if not planted_shape(name, "forward"):
            continue
        tol = FWD_TILE_TOLERANCE[dt]

        def randn(*dims):
            return torch.randn(dims, generator=gen, device="cuda",
                               dtype=torch.float32).to(getattr(torch, dt))

        q_hat, k, v = fa._prepare(randn(b, sq, h, d), randn(b, skv, hk, d),
                                  randn(b, skv, hk, dv), causal, None,
                                  window)
        o_r, _ = fa.flash_attention_reference(q_hat, k, v, causal,
                                              window)
        # The f32 forward with its plan's P and with the other one
        # (other_parts), the worse reading of the two.
        runs = [lambda: fa._forward(q_hat, k, v, causal, window)[0]]
        if dt == "float32":
            p = other_parts(f32_q_plan(SHAPE_BY_NAME[name], "fwd"))
            runs.append(lambda: fwd_with_parts(fa, q_hat, k, v, causal,
                                               window, p)[0])
        readings = {}
        for variant, source, lib in _flash_variants(libs):
            outs = [_with_variant(libs, source, lib, run) for run in runs]
            readings[variant] = dict(
                tile_rel=max(tile_rel_err(o, o_r) for o in outs),
                max_abs=max((o.float() - o_r.float()).abs().max().item()
                            for o in outs))
        sound = max(r["tile_rel"] for f, r in readings.items()
                    if f == "sound"
                    or not flash_fault_shows(f, name, "forward"))
        fault_min = min(r["tile_rel"] for f, r in readings.items()
                        if f != "sound"
                        and flash_fault_shows(f, name, "forward"))
        worst_sound[dt] = max(worst_sound.get(dt, 0.0), sound)
        caught = caught and sound <= tol < fault_min
        print("planted_faults: " + json.dumps(dict(
            kernel="forward", shape=name, tolerance=tol,
            sound_max=sound, least_fault_max=fault_min,
            readings=readings)), flush=True)
    return worst_sound, caught


def _planted_backward(libs):
    """The backward check's reading of the sound kernels and of each
    fault (``libs``: {source: {variant: lib}} of the backward and wide
    sources) at every backward shape of planted_shape: (worst sound
    reading by dtype, whether the limit of the shape's dtype separated them
    at every shape)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_sound, caught = {}, True
    for shape in BWD_SHAPES:
        if not planted_shape(shape[0], "backward"):
            continue
        tol = BWD_TOLERANCE[shape[8]]
        c = BwdCase(gen, shape)
        ref = c.plain()
        readings = {}
        for variant, source, lib in _flash_variants(libs):
            readings[variant] = bwd_errors(
                _with_variant(libs, source, lib, c.kernels), ref)
        sound_max = max(r["tile_rel"] for f, v in readings.items()
                        if f == "sound" or not flash_fault_shows(
                            f, c.name, "backward") for r in v.values())
        fault_min = min(max(r["tile_rel"] for r in v.values())
                        for f, v in readings.items()
                        if f != "sound"
                        and flash_fault_shows(f, c.name, "backward"))
        worst_sound[c.dt] = max(worst_sound.get(c.dt, 0.0), sound_max)
        caught = caught and sound_max <= tol < fault_min
        print("planted_faults: " + json.dumps(dict(
            shape=c.name, tolerance=tol, sound_max=sound_max,
            least_fault_max=fault_min, readings=readings)), flush=True)
        del c, ref
    return worst_sound, caught


def _planted_spmm(libs):
    """The SpMM check's reading of the sound kernels and of each fault
    at every SpMM shape (f32: the worse of the plan's P and the other of
    1 and 2, each route): (worst sound reading by dtype,
    whether the limit of the shape's dtype separated them wherever the
    fault can show and the kernels a fault does not touch stayed sound)."""
    import torch

    from marlin_tpu_torch.ops import build

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst_sound, caught = {}, True
    try:
        for shape in SPMM_SHAPES:
            c = SpmmCase(gen, shape)
            tol = SPMM_TOLERANCE[c.dt]
            ref = c.plain()
            ps = [None]
            if c.dt == "float32":
                ps = [c.plan().parts, other_parts(c.plan())]
            readings = {}
            for variant, lib in libs.items():
                build._loaded["block_sparse"] = lib
                readings[variant] = {
                    route: max(tile_rel_err_2d(fn(p), ref) for p in ps)
                    for route, fn in (("gather", c.gather),
                                      ("masked", c.masked))}
            # What each variant must read: within the limit, except the
            # kernels a fault breaks, wherever that fault can show.
            for variant, r in readings.items():
                kernels, dtypes, can_show = SPMM_FAULT_SHOWS.get(
                    variant, ((), (), lambda _: False))
                shows = c.dt in dtypes and can_show(c)
                for k, v in r.items():
                    if k in kernels and shows:
                        caught = caught and v > tol
                    else:
                        caught = caught and v <= tol
            worst_sound[c.dt] = max(worst_sound.get(c.dt, 0.0),
                                    *readings["sound"].values())
            print("planted_faults: " + json.dumps(dict(
                shape=c.name, tolerance=tol, live_blocks=c.nnz,
                blocks=int(c.mask.numel()), parts=ps, readings=readings)),
                flush=True)
            del c, ref
    finally:
        build._loaded["block_sparse"] = libs["sound"]
    return worst_sound, caught


def phase_planted_faults(card: str):
    """The kernel checks against planted faults: build each fault of
    FWD_PLANTED_FAULTS, PLANTED_FAULTS and SPMM_PLANTED_FAULTS into a
    temporary directory, and at every shape of each check (planted_shape;
    every SpMM shape) print the sound kernels' and each
    fault's reading (tile_rel_err of O for the forward and of dQ, dK, dV
    for the backward, with max |err| beside it; tile_rel_err_2d for
    SpMM). Fails unless every sound reading is within
    the check's limit and every fault's reading exceeds it wherever the
    fault can show."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_planted({"flash_attention_fwd": FWD_PLANTED_FAULTS,
                               "flash_attention_bwd": PLANTED_FAULTS,
                               "flash_attention_wide": WIDE_KERNEL_FAULTS,
                               "block_sparse": SPMM_PLANTED_FAULTS}, tmp)
        wide = libs["flash_attention_wide"]
        fwd_sound, fwd_caught = _planted_forward(
            {"flash_attention_fwd": libs["flash_attention_fwd"],
             "flash_attention_wide": wide})
        bwd_sound, bwd_caught = _planted_backward(
            {"flash_attention_bwd": libs["flash_attention_bwd"],
             "flash_attention_wide": wide})
        spmm_sound, spmm_caught = _planted_spmm(libs["block_sparse"])
    print(card)
    print(json.dumps(dict(
        planted_faults=(list(FWD_PLANTED_FAULTS) + list(PLANTED_FAULTS)
                        + list(WIDE_KERNEL_FAULTS)
                        + list(SPMM_PLANTED_FAULTS)),
        forward=dict(tolerance=FWD_TILE_TOLERANCE,
                     worst_sound=fwd_sound, separates=fwd_caught),
        backward=dict(tolerance=BWD_TOLERANCE,
                      worst_sound=bwd_sound, separates=bwd_caught),
        spmm=dict(tolerance=SPMM_TOLERANCE,
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


# Alternatives to dQ, the SpMM ring kernel, the wide bf16 kernels and the
# f32 dK/dV, timed beside them and beside the parent tree's kernels by
# ``--compare-with``: each a list of edits of this tree's source or of a
# header it includes, applied as the planted faults are; a variant of the
# ring kernel changes both SpMM routes, one of the f32 dK/dV (f32_dkv_...)
# is timed at that kernel's shapes only.
_F32_UNROLL_1 = [("#pragma unroll 2\n  for (int w = 0;",
                  "#pragma unroll 1\n  for (int w = 0;"),
                 ("#pragma unroll 2\n  for (int m = 0;",
                  "#pragma unroll 1\n  for (int m = 0;")]
_F32_HEAD_MAJOR = [(
    "  const int bhk = i % (a.B * a.Hk);\n  i /= a.B * a.Hk;\n"
    "  c.b = bhk / a.Hk;\n  c.hk = bhk % a.Hk;\n  c.p = i % a.parts;\n"
    "  c.t = i / a.parts;\n",
    "  c.p = i % a.parts;\n  i /= a.parts;\n"
    "  c.t = i % cdiv(a.Skv, kKeys);\n"
    "  const int bhk = i / cdiv(a.Skv, kKeys);\n"
    "  c.b = bhk / a.Hk;\n  c.hk = bhk % a.Hk;\n")]
_F32_DKV_VARIANTS = {
    # The box products' loops not unrolled (this tree: by 2).
    "f32_dkv_unroll_1": _F32_UNROLL_1,
    # The grid (batch, KV head)-major, key tiles heaviest first within
    # each (this tree: key-tile-major across every batch and KV head).
    "f32_dkv_head_major": _F32_HEAD_MAJOR,
}

KERNEL_VARIANTS = {
    "flash_attention_bwd": {
        # Three K/V stages (128 KB of shared memory: one CTA an SM).
        "dq_3_stages": [("constexpr int kDqStages = 2;",
                         "constexpr int kDqStages = 3;")],
        **_F32_DKV_VARIANTS,
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
        # The f32 kernel's persistent grid at one CTA an SM (this tree:
        # two, 104 KB of ring each).
        "spmm_f32_one_cta_an_sm": [("constexpr int kFCtasPerSm = 2;",
                                    "constexpr int kFCtasPerSm = 1;")],
        # The f32 kernel with one unit a CTA (a grid of every unit, as the
        # first design ran): no ring across units.
        "spmm_f32_one_unit_a_cta": [
            ("  const unsigned ctas = min(grid, (unsigned)(kFCtasPerSm * "
             "sms));", "  const unsigned ctas = grid;")],
    },
    "flash_attention_wide": {
        # Ring slots of 2 boxes in dQ (4 in this tree). (The forward's
        # 48 KB slots cannot double: three 96 KB slots do not fit.)
        "wide_dq_group_2": [("constexpr int kDqGroup = 4;",
                             "constexpr int kDqGroup = 2;")],
        # At most 4 ring slots (16 in this tree).
        "wide_4_stages": [("constexpr int kMaxStages = 16;",
                           "constexpr int kMaxStages = 4;")],
        # dK/dV's ring slots of 2 boxes in both roles (this tree: 4 where
        # at least four slots fit beside the resident K and V, else 2).
        "wide_dkv_group_2": [
            ("    for (int gs = kDkvMaxGroup; gs >= 2; gs /= 2) {",
             "    for (int gs = 2; gs >= 2; gs /= 2) {")],
        # dK/dV's slots of 4 boxes first: where 4 do not fit beside the
        # resident K and V (a dK part at D = Dv = 512 and at MLA), K and V
        # stream beside q_hat and dO in slots of 4 (this tree: resident,
        # slots of 2).
        "wide_dkv_group_4_streamed": [
            ("  for (int res = 1; res >= 0; --res) {\n"
             "    for (int gs = kDkvMaxGroup; gs >= 2; gs /= 2) {",
             "  for (int gs = kDkvMaxGroup; gs >= 2; gs /= 2) {\n"
             "    for (int res = 1; res >= 0; --res) {")],
        **_F32_DKV_VARIANTS,
    },
}

# Ablations of the wide bf16 kernels, timed beside them by --compare-with
# and never held to the plain version (they compute something else): what
# a kernel's time is made of. Each edit takes the first occurrence, so an
# edit that must reach several places (the forward's, dQ's and dK/dV's
# logits; each kernel's n128 and n64 output products) is listed once for
# each; a replacement never contains its own text.
_WIDE_S_MMA = ("sm90::wgmma_ss<0>(sc, sm90::desc_sw128(a + kk * 32, 16, "
               "1024),")
_WIDE_NO_LOGIT_MMA = [(_WIDE_S_MMA, "if (0) " + _WIDE_S_MMA.replace(
    "16, 1024", "16,  1024"))] * 3 + [
    ("sm90::wgmma_ss<0>(dp,", "if (0) sm90::wgmma_ss<0>( dp,"),
    ("sm90::wgmma_ss<0>(sh,", "if (0) sm90::wgmma_ss<0>( sh,")]
_WIDE_NO_OUT_MMA = [
    ("sm90::wgmma_ss<1>(\n", "if (0) sm90::wgmma_ss<1>( \n")] * 2 + [
    ("sm90::wgmma_ss<1>(d,\n", "if (0) sm90::wgmma_ss<1>(d, \n")] * 4


def _wide_no_tma(source: str):
    """Edits of the wide source that keep every ring barrier but load
    nothing through the ring: the producer arrives on a slot's full
    barrier with no bytes, and each TMA load into a slot is skipped (q_hat
    and dO resident still come in)."""
    edits = [("    sm90::mbar_arrive_expect_tx(&full[p.s], bytes);\n",
              "    sm90::mbar_arrive(&full[p.s]);\n")]
    for m in re.finditer(r"sm90::tma_load_4d\((dst|ring\.at)", source):
        edits.append((m.group(0),
                      "if (0) sm90::tma_load_4d( " + m.group(1)))
    return edits


# Ablations of the bf16 dK/dV alone: its lse and Delta loads, its two
# named barriers a query tile, its exp2.
_WIDE_DKV_ABLATIONS = {
    "wide_dkv_no_stat_loads": [(
        "      lcol[j] = qp < Sq ? lse[row + qp] : 0.f;\n"
        "      dcol[j] = dkp && qp < Sq ? delta[row + qp] : 0.f;",
        "      lcol[j] = 0.f;\n      dcol[j] = 0.f;")],
    "wide_dkv_no_barriers": [
        ("    sm90::named_barrier(1, kConsumerThreads);\n"
         "    if (dkp && w == 0) {", "    if (dkp && w == 0) {"),
        ("    sm90::named_barrier(2, kConsumerThreads);  // the whole tile "
         "written\n", "\n")],
    "wide_dkv_no_exp2": [(
        "        float pr = exp2f(sc[nt * 4 + e] - lcol[j]);",
        "        float pr = sc[nt * 4 + e] - lcol[j];")],
}


# Ablations of the f32 dK/dV (edits of csrc/flash_dkv_f32.cuh and
# csrc/flash_f32.cuh, timed at its --compare-with shapes, never held):
# without its logit products (S^T, dP^T), without its output products,
# without its loads (the ring's barriers and waits stay), and with none of
# the three.
_F32_NO_LOGITS = [("      if (x < mine) tile_dot(",
                   "      if (0) tile_dot(")]
_F32_NO_OUT = [("        if (j < n_o) tile_out(", "        if (0) tile_out(")]
_F32_NO_LOADS = [("    cp_async16(dst + r * kLd + col,",
                  "    if (0) cp_async16(dst + r * kLd + col,")]
F32_DKV_ABLATIONS = {
    "f32_dkv_no_logit_products": _F32_NO_LOGITS,
    "f32_dkv_no_out_products": _F32_NO_OUT,
    "f32_dkv_no_loads": _F32_NO_LOADS,
    "f32_dkv_sync_only": _F32_NO_LOGITS + _F32_NO_OUT + _F32_NO_LOADS,
}

# The same four of the f32 forward and dQ, narrow and wide (edits of
# csrc/flash_fwd_dq_f32.cuh and csrc/flash_f32.cuh, timed at their
# --compare-with shapes): the forward's S and dQ's S and dP, the forward's
# P V and dQ's dS K, every box load, and none of the three (the softmax's
# row exchange, the ring's barriers and the stores stay).
_F32_Q_NO_LOGITS = [
    ("      tile_dot(cc, sl, sl + (1 + wg) * kBoxFloats, tn, tm);",
     "      if (0) tile_dot(cc, sl, sl + (1 + wg) * kBoxFloats, tn, tm);"),
    ("if (x < mine) tile_dot(cc, box,", "if (0) tile_dot(cc, box,")]
_F32_Q_NO_OUT = [
    ("        if (2 * q + wg < n_o) {\n          tile_out(",
     "        if (0) {\n          tile_out("),
    ("if (2 * q + wg < n_o) tile_out(acc[q], sdS,",
     "if (0) tile_out(acc[q], sdS,")]
F32_Q_ABLATIONS = {
    "f32_q_no_logit_products": _F32_Q_NO_LOGITS,
    "f32_q_no_out_products": _F32_Q_NO_OUT,
    "f32_q_no_loads": _F32_NO_LOADS,
    "f32_q_sync_only": _F32_Q_NO_LOGITS + _F32_Q_NO_OUT + _F32_NO_LOADS,
}


# Ablations of the f32 SpMM kernel (edits of csrc/block_sparse.cu and
# csrc/flash_f32.cuh, timed at its --compare-with shapes, never held):
# without its box products, without its loads, with its loads alone (no
# products, no stores), and with neither products nor loads (the column
# count, the ring's barriers and the stores stay).
_SPMM_F32_NO_PRODUCTS = [
    ("      tile_out(acc, sl + wg * kBoxFloats,",
     "      if (0) tile_out(acc, sl + wg * kBoxFloats,")]
_SPMM_F32_NO_STORES = [
    ("      if (row < g.M)\n        *reinterpret_cast<float4*>(out",
     "      if (0)\n        *reinterpret_cast<float4*>(out")]
SPMM_F32_ABLATIONS = {
    "spmm_f32_no_products": _SPMM_F32_NO_PRODUCTS,
    "spmm_f32_no_loads": _F32_NO_LOADS,
    "spmm_f32_loads_only": _SPMM_F32_NO_PRODUCTS + _SPMM_F32_NO_STORES,
    "spmm_f32_sync_only": _SPMM_F32_NO_PRODUCTS + _F32_NO_LOADS,
}


def wide_ablations(source: str):
    """{ablation: edits} of the wide source (``source``, its text)."""
    no_tma = _wide_no_tma(source)
    return {"wide_no_tma": no_tma,
            "wide_no_logit_mma": _WIDE_NO_LOGIT_MMA,
            "wide_loads_only": _WIDE_NO_LOGIT_MMA + _WIDE_NO_OUT_MMA,
            "wide_sync_only": _WIDE_NO_LOGIT_MMA + _WIDE_NO_OUT_MMA + no_tma,
            **_WIDE_DKV_ABLATIONS}


# The shapes --compare-with times: the main path's, by kernel, the wide
# bf16 kernels' at LARGE_WIDE_SHAPES (3 launches a turn there: a parent
# tree's FMA kernels take hundreds of ms a launch), the f32 dK/dV's
# (narrow: "dkv_f32", wide: "dkv_wide_f32") at PERF.md's f32 table shapes
# and the LARGE_F32_SHAPES (3 launches a turn there too), and the f32
# forward's and dQ's (narrow: "fwd_f32", "dq_f32"; wide: "fwd_wide_f32",
# "dq_wide_f32") at the same shapes, with SDPA's f32 forward or whole f32
# backward timed in the same turns.
_WIDE_F32_TABLE = ("d320_f32", "d1024_f32", "d512_s2048_f32")
_F32_TABLE = ("f32", "d256_f32", "train_f32")
# The f32 SpMM shapes of SPMM_SHAPES, PERF.md's f32 table: the small
# shape, the two edge shapes, and the sparse bench configuration at the
# parity dtype (`bench512_f32`).
SPMM_F32_SHAPES = ("f32", "tall_m_f32", "wide_n_f32", "bench512_f32")
COMPARE_SHAPES = {"dq": ("train", "remat"), "gather": ("bench512", "coo128"),
                  "masked": ("bench512", "coo128"),
                  "fwd_wide": LARGE_WIDE_SHAPES, "dq_wide": LARGE_WIDE_SHAPES,
                  "dkv_wide": LARGE_WIDE_SHAPES,
                  "dkv_f32": _F32_TABLE, "fwd_f32": _F32_TABLE,
                  "dq_f32": _F32_TABLE, "dkv_wide_f32": _WIDE_F32_TABLE,
                  "fwd_wide_f32": _WIDE_F32_TABLE,
                  "dq_wide_f32": _WIDE_F32_TABLE,
                  "spmm_f32": SPMM_F32_SHAPES,
                  "spmm_f32_masked": SPMM_F32_SHAPES}

# Each --compare-with kernel's own variants and ablations, by name prefix
# (the others' are those with no such prefix).
_OWN_VARIANTS = {"dkv_f32": "f32_dkv_", "dkv_wide_f32": "f32_dkv_",
                 "fwd_f32": "f32_q_", "dq_f32": "f32_q_",
                 "fwd_wide_f32": "f32_q_", "dq_wide_f32": "f32_q_",
                 "spmm_f32": "spmm_f32_", "spmm_f32_masked": "spmm_f32_"}

# The library calls --compare-with times beside a kernel, by the name its
# version takes: SDPA beside the f32 flash kernels, one dense torch.matmul
# on the zero-filled backing beside the f32 SpMM.
_LIBRARY_VERSIONS = ("sdpa", "matmul")


def _spmm_call(route, c, libs):
    """c.gather() (``route`` "gather") or c.masked(); but where the
    library loaded as "block_sparse" is ``libs``'s "parent" and its entries
    take no sweep parts (``libs["parent_spmm_parts"]``), that route's entry
    called with its own arguments, through a function object of its own
    (the wrapper's _kernel_lib sets the library's cached ones once)."""
    import ctypes

    import torch

    from marlin_tpu_torch.ops import build

    lib = build._loaded["block_sparse"]
    if (lib is not libs["block_sparse"].get("parent")
            or libs["parent_spmm_parts"]):
        return c.gather() if route == "gather" else c.masked()
    gather = route == "gather"
    fn = lib["marlin_block_sparse_spmm_" + route]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (4 + gather)
                   + [ctypes.c_int] * (4 + gather) + [ctypes.c_void_p])
    (m, k), n = c.a.shape, c.data.shape[1]
    out = torch.empty((m, n), dtype=c.data.dtype, device=c.data.device)
    lists = ([c.kidx_d.data_ptr(), c.kcnt_d.data_ptr()] if gather
             else [c.mask.data_ptr()])
    err = fn(int(c.data.dtype == torch.float32), c.a.data_ptr(),
             c.data.data_ptr(), out.data_ptr(), *lists, m, k, n, c.bs,
             *[c.max_nnz] * gather, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the parent tree's SpMM {route}: cudaError_t {err}")
    return out


def _dkv_call(c, libs, source):
    """c.dkv(); but where the library loaded as ``source`` is ``libs``'s
    "parent" and that tree's dK/dV entry does not take this tree's plan
    for c (its csrc has no flash_dkv_f32.cuh, and c is f32 or the entry
    is the narrow one or a wide one without ``parts_g``), that entry
    called with its own arguments on c's padded inputs: the narrow one
    with no workspace and no parts, the wide one with one group part (its
    f32 kernel takes no other) or, without ``parts_g``, with neither."""
    import ctypes

    import torch

    from marlin_tpu_torch.ops import build

    lib = build._loaded[source]
    wide = source == "flash_attention_wide"
    if (lib is not libs[source].get("parent") or libs["parent_has_f32_parts"]
            or (wide and libs["parent_has_parts"]
                and c.q_hat.dtype == torch.bfloat16)):
        return c.dkv()
    fn = lib["marlin_flash_attention_bwd_dkv_wide" if wide
             else "marlin_flash_attention_bwd_dkv"]
    with_parts = wide and libs["parent_has_parts"]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (8 + with_parts)
                   + [ctypes.c_int] * (9 + with_parts) + [ctypes.c_void_p])
    q, k, v, do = c.padded
    b, sq, h, d = q.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    dk, dvv = torch.empty_like(k), torch.empty_like(v)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            c.lse.data_ptr(), c.delta.data_ptr(), dk.data_ptr(),
            dvv.data_ptr()] + [None] * with_parts
    err = fn(int(q.dtype == torch.float32), *ptrs, b, h, hk, sq, skv, d, dv,
             int(c.causal), int(c.window), *[1] * with_parts,
             torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the parent tree's {source} dK/dV: cudaError_t {err}")
    return dk[..., :c.d], dvv[..., :c.dv]


def _q_call(kind, c, libs, source):
    """The forward's O (``kind`` "fwd") or dQ ("dq") of c's padded inputs
    through this tree's wrapper, by the library loaded as ``source``
    ("flash_attention_fwd" or "flash_attention_bwd": the narrow kernels;
    "flash_attention_wide"); but where that library is ``libs``'s "parent"
    and its entry takes no sweep parts (``libs["parent_q_parts"]``), that
    entry called with its own arguments, through a function object of its
    own (the wrapper's _kernel_lib, _bwd_lib and _wide_lib set the
    library's cached ones once)."""
    import ctypes

    import torch

    from marlin_tpu_torch.ops import build
    from marlin_tpu_torch.ops import flash_attention as fa

    lib = build._loaded[source]
    q, k, v, do = c.padded
    if (lib is not libs[source].get("parent")
            or libs["parent_q_parts"][source]):
        if kind == "dq":
            return c.dq()
        return fa._launch(q, k, v, c.causal, c.window)[0][..., :c.dv]
    wide = source == "flash_attention_wide"
    b, sq, h, d = q.shape
    skv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    dims = (b, h, hk, sq, skv, d, dv, int(c.causal), int(c.window))
    stream = torch.cuda.current_stream().cuda_stream
    dtype = int(q.dtype == torch.float32)
    if kind == "fwd":
        fn = lib["marlin_flash_attention_fwd" + "_wide" * wide]
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (5 + wide)
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = fn(dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), *[None] * wide, *dims,
                 stream)
        out = out[..., :c.dv]
    else:
        fn = lib["marlin_flash_attention_bwd_dq" + "_wide" * wide]
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        out = torch.empty_like(q)
        err = fn(dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), c.lse.data_ptr(), c.delta.data_ptr(),
                 out.data_ptr(), *dims, float(c.scale), stream)
        out = out[..., :c.d]
    if err:
        fail(f"the parent tree's {source} {kind}: cudaError_t {err}")
    return out


def _parent_q_parts(csrc) -> dict:
    """Whether each source's forward or dQ entry of the checkout whose csrc
    directory is ``csrc`` takes sweep parts: the wide ones where it has
    csrc/flash_fwd_dq_f32.cuh, the narrow ones where their entry takes a
    workspace."""
    def entry_takes_parts(source, entry):
        text = (csrc / f"{source}.cu").read_text()
        at = text.find(f"int {entry}(")
        return at >= 0 and "workspace" in text[at:text.find("{", at)]

    return {"flash_attention_wide": (csrc / "flash_fwd_dq_f32.cuh").exists(),
            "flash_attention_fwd": entry_takes_parts(
                "flash_attention_fwd", "marlin_flash_attention_fwd"),
            "flash_attention_bwd": entry_takes_parts(
                "flash_attention_bwd", "marlin_flash_attention_bwd_dq")}


def phase_compare(card: str, parent: str):
    """This tree's dQ, SpMM (both routes), wide bf16 forward, dQ and dK/dV,
    and f32 forward, dQ and dK/dV (narrow and wide) kernels against the
    parent tree's (the
    checkout at ``parent``, built from its own csrc/) and against
    KERNEL_VARIANTS, on one card: at each COMPARE_SHAPES shape every
    version is first held to the plain version (worst tile, the phase
    checks' limit), then timed warm (cuda_ms) and cold (cuda_ms_cold), in
    two rounds, parent, this tree, the variants, then the reverse; the wide
    kernels' ablations (wide_ablations) are timed in the same turns, their
    error printed and not held, and so is SDPA's forward or whole backward
    at the f32 kernels' shapes (its backend and its reading of the f32
    limits beside it), and one dense torch.matmul at the f32 SpMM's.
    Prints one "compare:" line per kernel, shape and version, and fails if
    any version but an ablation or a library call disagrees with the plain
    one."""
    import tempfile
    from pathlib import Path

    import torch
    import torch.nn.functional as F

    from marlin_tpu_torch.ops import build
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.ops.block_sparse import BlockSparse

    csrc = Path(parent).resolve() / "marlin_tpu_torch" / "csrc"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = {}
    # (kernel, shape): (version, call, its first reading): SDPA (with its
    # readings of the f32 limits) or torch.matmul (its worst tile)
    library = {}
    libs = {}  # every source's versions, once built
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in BWD_SHAPES:
        if shape[0] in COMPARE_SHAPES["dq"]:
            c = BwdCase(gen, shape)
            ref = c.plain()[0]
            cases["dq", shape[0]] = (
                "flash_attention_bwd",
                lambda c=c: _q_call("dq", c, libs, "flash_attention_bwd"),
                lambda out, ref=ref: tile_rel_err(out, ref),
                BWD_TOLERANCE[shape[8]])
        wide = [k for k in ("fwd_wide", "dq_wide", "dkv_wide")
                if shape[0] in COMPARE_SHAPES[k]]
        if wide:
            c = BwdCase(gen, shape)
            dq_ref, *dkv_ref = c.plain()
            o_ref = fa.flash_attention_reference(c.q_hat, c.k, c.v, c.causal,
                                                 c.window)[0]
            by_kernel = {
                "fwd_wide": (
                    lambda c=c: _q_call("fwd", c, libs,
                                        "flash_attention_wide"),
                    lambda out, ref=o_ref: tile_rel_err(out, ref),
                    FWD_TILE_TOLERANCE[shape[8]]),
                "dq_wide": (lambda c=c: _q_call("dq", c, libs,
                                                "flash_attention_wide"),
                            lambda out, ref=dq_ref: tile_rel_err(out, ref),
                            BWD_TOLERANCE[shape[8]]),
                "dkv_wide": (
                    lambda c=c: _dkv_call(c, libs, "flash_attention_wide"),
                    lambda out, ref=dkv_ref: max(
                        tile_rel_err(o, r) for o, r in zip(out, ref)),
                    BWD_TOLERANCE[shape[8]])}
            for k in wide:
                cases[k, shape[0]] = ("flash_attention_wide", *by_kernel[k])
        for kernel, source in (("dkv_f32", "flash_attention_bwd"),
                               ("dkv_wide_f32", "flash_attention_wide")):
            if shape[0] in COMPARE_SHAPES[kernel]:
                c = BwdCase(gen, shape)
                ref = c.plain()
                cases[kernel, shape[0]] = (
                    source,
                    lambda c=c, source=source: _dkv_call(c, libs, source),
                    lambda out, ref=ref[1:]: max(
                        tile_rel_err(o, r) for o, r in zip(out, ref)),
                    BWD_TOLERANCE[shape[8]])
                library[kernel, shape[0]] = (
                    "sdpa", _sdpa_bwd_call(F, c.q, c.k, c.v, c.do, c.causal,
                                           c.window), sdpa_f32_bwd(F, c, ref))
                if shape[0] in COMPARE_SHAPES["fwd" + kernel[3:]]:
                    # The f32 forward and dQ, narrow or wide, on the same
                    # inputs.
                    q_kernels = (kernel.replace("dkv", "fwd"),
                                 kernel.replace("dkv", "dq"))
                    o_ref = fa.flash_attention_reference(
                        c.q_hat, c.k, c.v, c.causal, c.window)[0]
                    fwd_source = ("flash_attention_fwd"
                                  if source == "flash_attention_bwd"
                                  else source)
                    cases[q_kernels[0], shape[0]] = (
                        fwd_source,
                        lambda c=c, s=fwd_source: _q_call("fwd", c, libs, s),
                        lambda out, ref=o_ref: tile_rel_err(out, ref),
                        FWD_TILE_TOLERANCE[shape[8]])
                    qt, kt, vt, kw = _sdpa_args(c.q, c.k, c.v, c.causal,
                                                c.window)
                    library[q_kernels[0], shape[0]] = (
                        "sdpa", lambda qt=qt, kt=kt, vt=vt, kw=kw:
                        F.scaled_dot_product_attention(qt, kt, vt, **kw),
                        sdpa_f32_fwd(F, c.q, c.k, c.v, c.causal, c.window,
                                     o_ref))
                    cases[q_kernels[1], shape[0]] = (
                        source,
                        lambda c=c, s=source: _q_call("dq", c, libs, s),
                        lambda out, ref=ref[0]: tile_rel_err(out, ref),
                        BWD_TOLERANCE[shape[8]])
                    library[q_kernels[1], shape[0]] = library[kernel,
                                                              shape[0]]
                del ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    spmm_kernels = {"gather": ("gather", "spmm_f32"),
                    "masked": ("masked", "spmm_f32_masked")}
    for shape in SPMM_SHAPES:
        kernels = {route: k for route, ks in spmm_kernels.items()
                   for k in ks if shape[0] in COMPARE_SHAPES[k]}
        if not kernels:
            continue
        c = SpmmCase(gen, shape)
        ref = c.plain()
        for route, kernel in kernels.items():
            cases[kernel, shape[0]] = (
                "block_sparse",
                lambda c=c, route=route: _spmm_call(route, c, libs),
                lambda out, ref=ref: tile_rel_err_2d(out, ref),
                SPMM_TOLERANCE[shape[6]])
        if shape[6] == "float32":
            zeroed = BlockSparse(c.data, c.mask, c.bs).data
            dense = torch.matmul(c.a, zeroed)
            library["spmm_f32", shape[0]] = (
                "matmul", lambda a=c.a, z=zeroed: torch.matmul(a, z),
                dict(tile_rel_err=tile_rel_err_2d(dense, ref)))
            library["spmm_f32_masked", shape[0]] = library["spmm_f32",
                                                           shape[0]]
            del dense
        del ref
    ablations = wide_ablations(
        build.SOURCES["flash_attention_wide"].read_text())
    variants = {name: dict(v) for name, v in KERNEL_VARIANTS.items()}
    variants["flash_attention_wide"].update(ablations)
    for name in ("flash_attention_bwd", "flash_attention_wide"):
        variants[name].update(F32_DKV_ABLATIONS)
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_wide"):
        variants.setdefault(name, {}).update(F32_Q_ABLATIONS)
    variants["block_sparse"].update(SPMM_F32_ABLATIONS)
    ablations.update(F32_DKV_ABLATIONS)
    ablations.update(F32_Q_ABLATIONS)
    ablations.update(SPMM_F32_ABLATIONS)

    def versions(kernel, shape, name):
        # The f32 kernels' own variants (_OWN_VARIANTS) at their cases,
        # every other variant of the source at the others.
        prefix = _OWN_VARIANTS.get(kernel)
        own = [v for v in variants[name]
               if (v.startswith(prefix) if prefix else
                   not v.startswith(tuple(_OWN_VARIANTS.values())))]
        return ["parent", "sound", *own] + (
            [library[kernel, shape][0]] if (kernel, shape) in library
            else [])

    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs.update(_build_planted(variants, tmp, parent=csrc))
        libs["parent_has_parts"] = "parts_g" in (
            csrc / "flash_attention_wide.cu").read_text()
        libs["parent_has_f32_parts"] = (csrc / "flash_dkv_f32.cuh").exists()
        libs["parent_q_parts"] = _parent_q_parts(csrc)
        libs["parent_spmm_parts"] = "workspace" in (
            csrc / "block_sparse.cu").read_text()
        try:
            for turn in range(2):
                for (kernel, shape), (name, fn, err_of, tol) in \
                        cases.items():
                    order = versions(kernel, shape, name)
                    n = 3 if shape in LARGE_WIDE_SHAPES + LARGE_F32_SHAPES \
                        else 10
                    for version in order if turn == 0 else order[::-1]:
                        call = fn
                        if version in _LIBRARY_VERSIONS:
                            _, call, first = library[kernel, shape]
                        else:
                            build._loaded[name] = libs[name][version]
                        out = call()
                        torch.cuda.synchronize()
                        if version not in _LIBRARY_VERSIONS:
                            first = dict(tile_rel_err=err_of(out))
                        r = readings.setdefault(
                            (kernel, shape, version),
                            dict(first, warm_ms=[], cold_ms=[]))
                        del out
                        r["warm_ms"].append(cuda_ms(
                            call, warmup=1 if n == 3 else 3, iters=n))
                        r["cold_ms"].append(cuda_ms_cold(call, iters=n))
        finally:
            for name in variants:
                build._loaded[name] = libs[name]["sound"]
    bad = []
    for (kernel, shape, version), r in readings.items():
        tol = cases[kernel, shape][3]
        print("compare: " + json.dumps(dict(
            card=card, kernel=kernel, shape=shape,
            version="this tree" if version == "sound" else version,
            ablation=version in ablations, tolerance=tol, **r,
            warm_ms_mean=sum(r["warm_ms"]) / len(r["warm_ms"]),
            cold_ms_mean=sum(r["cold_ms"]) / len(r["cold_ms"]))),
            flush=True)
        if (version not in ablations and version not in _LIBRARY_VERSIONS
                and not r["tile_rel_err"] <= tol):
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
    fa.wide_launches = fa.wide_dq_launches = fa.wide_dkv_launches = 0


def _counters(fa):
    """Every flash kernel's launches: the narrow kernels' (fwd, dq, dkv)
    and the wide ones' (wide_fwd, wide_dq, wide_dkv)."""
    return dict(fwd=fa.launches, dq=fa.bwd_dq_launches,
                dkv=fa.bwd_dkv_launches, wide_fwd=fa.wide_launches,
                wide_dq=fa.wide_dq_launches, wide_dkv=fa.wide_dkv_launches)


def _want(fwd, dq, dkv, wide=False):
    """The launches _counters must read when the narrow kernels (or, with
    ``wide``, the wide ones) ran fwd, dq and dkv times and the others
    never."""
    ran, idle = dict(fwd=fwd, dq=dq, dkv=dkv), dict(fwd=0, dq=0, dkv=0)
    narrow, wide_ = (idle, ran) if wide else (ran, idle)
    return {**narrow, **{f"wide_{k}": n for k, n in wide_.items()}}


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
    if launches != _want(want, want, want):
        fail(f"train: launches {launches}, expected {want} of each narrow "
             f"kernel (layers x steps) and no wide one")
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
    if long_launches != _want(2 * lcfg.n_layers, lcfg.n_layers,
                              lcfg.n_layers):
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
        # Above 256 (the wide kernels): 2 heads of D=320 at d_model 640,
        # cut as bench_d160 is. No configuration of the repo has a head
        # this wide; the model drives the wide kernels through training.
        "wide_d320": (TransformerConfig(vocab=1024, d_model=640, n_heads=2,
                                        n_layers=2, d_ff=2560, max_len=512),
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
            head_dim = cfg.d_model // cfg.n_heads
            if launches != _want(want, want, want, wide=head_dim > 256):
                fail(f"small_model {run}: launches {launches}, expected "
                     f"{want} of each (layers x steps) of the "
                     f"{'wide' if head_dim > 256 else 'narrow'} kernels")
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
    if launches != _want(2, 2, 2):
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
    _zero_counters(fa)
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
    every = _counters(fa)
    peak = torch.cuda.max_memory_allocated()

    done = {r.request_id: r for r in done}
    if len(done) != 16 or any(r.status != "done" for r in done.values()):
        fail(f"engine answered {len(done)} of 16 requests: "
             f"{[(r.request_id, r.status) for r in done.values()]}")
    admissions = eng.stats.n_admitted
    if launches != admissions * cfg.n_layers:
        fail(f"flash kernel launches {launches} != admissions {admissions} "
             f"x layers {cfg.n_layers}")
    if every != _want(launches, 0, 0):
        fail(f"serve: launches {every}, expected the forward only and no "
             f"wide kernel")
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
# "bench512_f32" is "bench512" in f32, the library's default and parity
# dtype; "oracle" is that bench's own oracle shape; the rest are edge cases,
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
    ("bench512_f32", 8192, 8192, 8192, 512, 0.12, "float32"),
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

    def plan(self, parts=None):
        """The f32 kernel's plan (_spmm_f32_plan) on this card, with P =
        ``parts`` where given."""
        import torch

        (m, k), n = self.a.shape, self.data.shape[1]
        return self.bsp._spmm_f32_plan(
            m, k, n, self.bs, self.bsp._sm_count(torch.device("cuda")),
            parts)

    def gather(self, parts=None):
        return self.bsp._launch_gather(self.a, self.data, self.kidx_d,
                                       self.kcnt_d, self.max_nnz, self.bs,
                                       parts=parts)

    def masked(self, parts=None):
        return self.bsp._launch_masked(self.a, self.data, self.mask, self.bs,
                                       parts=parts)

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


def check_spmm_parts(c, ref, tol):
    """The f32 kernel at its plan's P and at the other of 1 and 2
    (other_parts), both routes, each run twice: every output within
    ``tol`` of the plain version ``ref`` (worst 64 x 64 tile), bitwise
    equal over the two runs and across the routes, empty columns exactly
    0. Returns {P: {"gather": worst tile, "masked": worst tile}} and the
    other P's gather time, warm and cold."""
    import torch

    plan = c.plan()
    errs = {}
    for p in (plan.parts, other_parts(plan)):
        outs = {route: (fn(p), fn(p)) for route, fn in
                (("gather", c.gather), ("masked", c.masked))}
        torch.cuda.synchronize()
        errs[p] = {}
        for route, (x, y) in outs.items():
            errs[p][route] = tile_rel_err_2d(x, ref)
            if not errs[p][route] <= tol:
                fail(f"spmm {c.name}: the {route} kernel at P = {p}: worst "
                     f"tile {errs[p][route]:.3e} (tol {tol})")
            if not torch.equal(x, y):
                fail(f"spmm {c.name}: the {route} kernel at P = {p} differs "
                     f"bitwise between two runs")
            if not c.empty_columns_zero(x):
                fail(f"spmm {c.name}: an empty block column is not exactly "
                     f"0 at P = {p}")
        if not torch.equal(outs["gather"][0], outs["masked"][0]):
            fail(f"spmm {c.name}: the gather and the masked route differ "
                 f"bitwise at P = {p}")
        del outs
    other = other_parts(plan)
    return errs, (cuda_ms(lambda: c.gather(other), iters=20),
                  cuda_ms_cold(lambda: c.gather(other), iters=10))


def phase_spmm(card: str):
    """The gather and the masked-grid routes' SpMM kernels against the
    plain version at every SpMM shape (the f32 kernel at its plan's P and
    at the other of 1 and 2: check_spmm_parts); returns the rows by shape
    name."""
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
        del got_m
        f32 = {}
        if c.dt == "float32":
            plan = c.plan()
            errs, other_ms = check_spmm_parts(c, ref, tol)
            f32 = dict(spmm_plan=plan._asdict(),
                       tile_rel_err_by_parts=errs,
                       other_parts=other_parts(plan),
                       other_parts_gather_ms=other_ms[0],
                       other_parts_gather_cold_ms=other_ms[1])
            print(f"spmm_plan: {c.name} " + json.dumps(f32["spmm_plan"]),
                  flush=True)
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
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   **f32)
        rows[c.name] = row
        print("spmm: " + json.dumps(row), flush=True)
        del c, got_g, ref, zeroed
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
    tol = SPMM_TOLERANCE[str(out.dtype).removeprefix("torch.")]
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
    size of 128; (c) (a) at f32, the library's default and parity dtype
    (the f32 kernel, held at its limit of 1e-5). Returns {path:
    {"gather": n, "masked": n}}."""
    import numpy as np
    import torch

    from marlin_tpu_torch.matrix import SparseVecMatrix
    from marlin_tpu_torch.ops import BlockSparse
    from marlin_tpu_torch.ops import block_sparse as bsp

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain version
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

    mask = rng.random((n // 512, n // 512)) < density
    a32 = torch.randn((n, n), generator=gen, device="cuda")
    b = BlockSparse(torch.randn((n, n), generator=gen, device="cuda"),
                    torch.from_numpy(mask).cuda(), 512)
    plan = bsp._spmm_f32_plan(n, n, n, 512, bsp._sm_count(a32.device))
    launches["bench512_f32"] = _spmm_products(
        a32, b, bsp._column_block_lists(mask)[:2], "spmm_path bench512_f32",
        card, dict(spmm_plan=plan._asdict()))
    del a32, b

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
    version). Returns the f32 run's launches, {"gather": n, "masked":
    n}: the f32 kernel's (spmm_f32), beside phase_spmm_path's bench512_f32
    run."""
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
    bsp.gather_launches = bsp.masked_launches = 0
    on_card = grads(a, data, mask, bs, block_sparse_matmul)
    torch.cuda.synchronize()
    f32_counts = dict(gather=bsp.gather_launches, masked=bsp.masked_launches)
    on_cpu = grads(a.cpu(), data.cpu(), mask.cpu(), bs, block_sparse_matmul)
    small = {}
    for label, g, c in zip(("loss", "da", "db"), on_card, on_cpu):
        small[f"{label}_rel_err"] = ((g.cpu() - c).abs().max()
                                     / c.abs().max()).item()
    print("spmm_grad: " + json.dumps(dict(
        bf16=big, f32_card_vs_cpu=dict(n=n, block_size=bs,
                                       launches=f32_counts, **small),
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
    if f32_counts != dict(gather=1, masked=0):
        fail(f"spmm_grad: f32 launches {f32_counts}, expected one gather "
             f"launch (the f32 kernel's)")
    return f32_counts


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


# The dense path's linear algebra at benchlib/configs_linalg.py's sizes on
# a one-rank NCCL mesh, f32 without TF32 (linalg_precision "highest"):
# the blocked LU and Cholesky at n = 16384 in panels of 1024 ("dist"
# mode), the inverse at n = 8192, the dist-eigs SVD of a 200,000 x 2048
# matrix (k = 10, tol 1e-6).
LINALG_N = dict(lu=16384, cholesky=16384, inverse=8192)
LINALG_BASE = 1024
LINALG_RUNS = 3  # timed runs of each op and of its one-call yardstick
LINALG_BAND = (8192, 256)  # (first row, rows) reconstructed in f64
LINALG_SMALL = (2048, 512)  # (n, base) of the whole f64 reconstructions
SVD_SHAPE, SVD_K, SVD_TOL = (200_000, 2048), 10, 1e-6
# ||A[perm] - L U||max / ||A||max (and ||A - L L^T||max / ||A||max), in
# f64 on the band of the 16k factors and on the whole n = 2048 ones: the
# JAX package's bench oracle bar (config_lu, config_cholesky). The typical
# backward error of f32 partial-pivoting LU, sqrt(n) u g with growth g ~
# 10 on random matrices (u = 6e-8), is 7.7e-5 at n = 16384, 13x below it.
LINALG_REL_TOLERANCE = 1e-3
# max |inv(A) A - I| for A = randn + n I (config_inverse's bar): its
# worst case without growth, n u = 4.9e-4 at n = 8192, is 20x below.
INVERSE_TOLERANCE = 1e-2
# Each singular value against an f64 eigh of the Gramian, relative: the
# f32 Gramian matvecs perturb each eigenvalue by ~ sqrt(m) u = 2.7e-5
# relative (m = 200,000 rows), a singular value by half of that; 1e-4 is
# 7x above it, and the Lanczos tolerance (1e-6) adds less.
SVD_REL_TOLERANCE = 1e-4


def _events_ms(fn, runs):
    """(ms of each of ``runs`` calls of ``fn`` between CUDA events, the
    last call's result); the calls' own host syncs are inside."""
    import torch

    times, out = [], None
    for _ in range(runs):
        del out
        out = None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def _spread(times):
    t = sorted(times)
    return dict(ms=t[len(t) // 2], ms_min=t[0], ms_max=t[-1], ms_runs=times)


def _lu_band_err(a, packed, perm, band):
    """||A[perm] - L U||max / ||A||max over rows ``band`` = (first,
    count), in f64 on the card (L's band rows times U)."""
    import torch

    r0, rows = band
    p = packed.double()
    lb = torch.tril(p[r0:r0 + rows], diagonal=r0 - 1)
    idx = torch.arange(rows, device=p.device)
    lb[idx, idx + r0] = 1.0
    lu = lb @ torch.triu(p)
    ap = a[torch.as_tensor(perm[r0:r0 + rows], device=a.device)].double()
    return ((ap - lu).abs().max() / a.abs().max().double()).item()


def _chol_band_err(a, l, band):
    import torch

    r0, rows = band
    ld = l.double()
    rec = ld[r0:r0 + rows] @ ld.T
    return ((a[r0:r0 + rows].double() - rec).abs().max()
            / a.abs().max().double()).item()


def _linalg_line(card, op, n, times, lib_times, flops, nbytes_, peak,
                 **extra):
    """One "linalg:" line: median ms and spread, TFLOP/s, share of the f32
    (non-tensor) bound, peak memory, the one-call yardstick's ms."""
    t = _spread(times)
    bound_ms, bound_by = bound(flops, nbytes_, "torch.float32")
    lib = _spread(lib_times) if lib_times else None
    row = dict(card=card, op=op, n=n, dtype="float32", base=LINALG_BASE,
               **t, tflops=flops / t["ms"] / 1e9,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / t["ms"], peak_mem_gb=peak / 1e9,
               library_ms=None if lib is None else lib["ms"],
               library_ms_spread=None if lib is None
               else [lib["ms_min"], lib["ms_max"]], **extra)
    print("linalg: " + json.dumps(row), flush=True)
    return row


# Where the LU's device time goes: each kernel goes to the first of these
# ops met walking up from the op that launched it (the LU's own calls,
# linalg/lu.py's _lu_stripes); a device-to-host copy is a sync wherever it
# came from.
LU_TRACE_OPS = (
    ("panel_getrf", ("aten::linalg_lu_factor_ex",)),
    ("triangular_solve", ("aten::linalg_solve_triangular",)),
    ("schur_gemm", ("aten::mm", "aten::matmul", "aten::addmm")),
    ("schur_subtract", ("aten::sub_",)),
    ("row_swaps", ("aten::index", "aten::index_put_",
                   "aten::_index_put_impl_", "aten::index_select")),
    ("syncs", ("aten::_local_scalar_dense", "aten::item")),
)


def _lu_trace(card, a, times):
    """One torch.profiler pass over ``a.lu_decompose(mode="dist")``
    (recorded, not held): the device time of each LU_TRACE_OPS class
    (the rest: "copies", the panels' assembly and write-back; kernels no
    op claims: "unattributed"), the wall time, the union of the device's
    busy intervals and the host idle (wall minus busy). Prints one
    "linalg_trace:" line and returns it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from marlin_tpu_torch.config import config_override

    def kind(ev):
        while ev is not None:
            for name, ops in LU_TRACE_OPS:
                if ev.name in ops:
                    return name
            ev = getattr(ev, "cpu_parent", None)
        return "copies"

    torch.cuda.synchronize()
    with config_override(lu_base_size=LINALG_BASE):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = a.lu_decompose(mode="dist")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    events = prof.events()
    split = {name: 0.0 for name, _ in LU_TRACE_OPS}
    split.update(copies=0.0, unattributed=0.0)
    counts = {name: 0 for name in split}
    attributed = 0.0
    for ev in events:
        if getattr(ev, "device_type", None) != DeviceType.CPU:
            continue
        for k in getattr(ev, "kernels", []):
            label = "syncs" if "DtoH" in k.name else kind(ev)
            split[label] += k.duration / 1e3
            counts[label] += 1
            attributed += k.duration / 1e3
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if getattr(ev, "device_type", None) == DeviceType.CUDA)
    device_ms, busy_ms, end = 0.0, 0.0, None
    for start, stop in spans:
        device_ms += (stop - start) / 1e3
        if end is None or start >= end:
            busy_ms += (stop - start) / 1e3
            end = stop
        elif stop > end:
            busy_ms += (stop - end) / 1e3
            end = stop
    split["unattributed"] = max(0.0, device_ms - attributed)
    row = dict(card=card, op="lu", n=a.num_rows, base=LINALG_BASE,
               timed_ms=_spread(times)["ms"], traced_wall_ms=wall_ms,
               device_ms=device_ms, device_busy_ms=busy_ms,
               host_idle_ms=wall_ms - busy_ms,
               device_ms_by_op=split, kernels_by_op=counts)
    print("linalg_trace: " + json.dumps(row), flush=True)
    return row


def phase_linalg_dgetf2():
    """On the card, cuSOLVER's getrf in the blocked LU (n = 2048, panels
    of 512) on an all-zero matrix, a matrix with an exactly zero column and
    one with a rank-deficient column: each must give dgetf2's result (no
    NaN; a zero pivot leaves U[c, c] = 0 and an L column of 0, pivots
    stay in place on the zero matrix), whichever route the panel took
    (zero_pivot_panels counts the panels refactored by the port's own
    dgetf2 after getrf left a non-finite value)."""
    import numpy as np
    import torch

    from marlin_tpu_torch.config import config_override
    from marlin_tpu_torch.linalg import lu as plu

    n, base = LINALG_SMALL
    gen = torch.Generator(device="cuda").manual_seed(7)
    plu.zero_pivot_panels = 0
    out = {}
    with config_override(lu_base_size=base):
        zero = torch.zeros((n, n), device="cuda")
        packed, perm = plu.lu_factor_array(zero, mode="dist")
        ok = bool((packed == 0).all()) and np.array_equal(perm,
                                                          np.arange(n))
        out["all_zero"] = dict(
            ok=ok, zero_pivot_panels=plu.zero_pivot_panels,
            nonzero=int((packed != 0).sum()),
            finite=bool(torch.isfinite(packed).all()),
            pivots_moved=int((perm != np.arange(n)).sum()))
        if not ok:
            fail(f"linalg dgetf2: the all-zero matrix's LU is not all zero "
                 f"with pivots in place: {out['all_zero']}")
        for name, col in (("zero_column", n // 3), ("rank_deficient", 5)):
            a = torch.randn((n, n), generator=gen, device="cuda")
            if name == "zero_column":
                a[:, col] = 0
            else:
                a[:, col] = 2 * a[:, 3] - a[:, 1]
            before = plu.zero_pivot_panels
            packed, perm = plu.lu_factor_array(a, mode="dist")
            finite = bool(torch.isfinite(packed).all())
            err = _lu_band_err(a, packed, perm, (0, n))
            l_max = torch.tril(packed, -1).abs().max().item()
            row = dict(finite=finite, rel_err=err, l_max=l_max,
                       zero_pivot_panels=plu.zero_pivot_panels - before)
            if name == "zero_column":
                row["u_cc"] = packed[col, col].item()
                row["l_col_max"] = packed[col + 1:, col].abs().max().item()
            out[name] = row
            if (not finite or not err <= LINALG_REL_TOLERANCE
                    or l_max > 1.0 + 1e-6
                    or row.get("u_cc", 0.0) != 0.0
                    or row.get("l_col_max", 0.0) != 0.0):
                fail(f"linalg dgetf2 {name}: {row}")
    print("linalg_dgetf2: " + json.dumps(out), flush=True)
    return out


def phase_linalg(card: str):
    """The dense path's linear algebra (see LINALG_N): each op LINALG_RUNS
    times through the entry point a user calls on a DenseVecMatrix of a
    one-rank NCCL mesh, beside its one-call cuSOLVER yardstick
    (torch.linalg.lu_factor_ex, cholesky_ex, inv on the whole matrix; the
    port never calls them so), each held to its oracle (the bounds
    above). No hand-written kernel launches. Returns the lines."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.config import config_override
    from marlin_tpu_torch.linalg import (cholesky_factor_array, inverse,
                                         lu_factor_array)
    from marlin_tpu_torch.matrix import dense as pdense
    from marlin_tpu_torch.ops import block_sparse as bs
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.utils import random as mrand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pm.create_mesh()
    if dist.get_backend() != "nccl" or mesh.size != 1:
        fail(f"linalg: expected a one-rank NCCL mesh, got "
             f"{dist.get_backend()} over {mesh.size} ranks")
    _zero_counters(fa)
    spmm_before = (bs.gather_launches, bs.masked_launches)
    rows = {}
    f32 = 4

    # --- The whole-matrix f64 reconstructions at n = 2048 (config_lu's
    # and config_cholesky's oracles).
    n_s, base_s = LINALG_SMALL
    gen = torch.Generator(device="cuda").manual_seed(0)
    a_s = torch.randn((n_s, n_s), generator=gen, device="cuda")
    with config_override(lu_base_size=base_s, cholesky_base_size=base_s):
        packed, perm = lu_factor_array(a_s, mode="dist")
        lu_small = _lu_band_err(a_s, packed, perm, (0, n_s))
        spd_s = a_s @ a_s.T + n_s * torch.eye(n_s, device="cuda")
        l_s = cholesky_factor_array(spd_s, mode="dist")
        chol_small = _chol_band_err(spd_s, l_s, (0, n_s))
    del packed, l_s, spd_s, a_s
    if not (lu_small <= LINALG_REL_TOLERANCE
            and chol_small <= LINALG_REL_TOLERANCE):
        fail(f"linalg: n = {n_s} reconstructions LU {lu_small:.3e}, "
             f"Cholesky {chol_small:.3e} (tol {LINALG_REL_TOLERANCE})")

    # --- LU, n = 16384.
    n = LINALG_N["lu"]
    a = mrand.random_den_vec_matrix(n, n, "normal", seed=3, mesh=mesh,
                                    dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with config_override(lu_base_size=LINALG_BASE):
        times, (packed, perm) = _events_ms(
            lambda: a.lu_decompose(mode="dist"), LINALG_RUNS)
    peak = torch.cuda.max_memory_allocated()
    whole = a.local  # one rank: its stripe is the whole matrix
    err = _lu_band_err(whole, packed.local, perm, LINALG_BAND)
    lib_times, (lib_lu, lib_piv, _) = _events_ms(
        lambda: torch.linalg.lu_factor_ex(whole), LINALG_RUNS)
    from marlin_tpu_torch.linalg.lu import _swaps_to_perm

    lib_perm = _swaps_to_perm(lib_piv.cpu().numpy().astype(np.int64) - 1, n)
    del lib_lu, lib_piv
    rows["lu"] = _linalg_line(
        card, "lu", n, times, lib_times, 2.0 / 3.0 * n ** 3,
        2 * n * n * f32, peak, band=list(LINALG_BAND), band_rel_err=err,
        small_n=n_s, small_rel_err=lu_small,
        tolerance=LINALG_REL_TOLERANCE,
        pivots_equal_to_library=float(np.mean(perm == lib_perm)))
    del packed, whole
    rows["lu_trace"] = _lu_trace(card, a, times)
    del a
    if not err <= LINALG_REL_TOLERANCE:
        fail(f"linalg lu: band error {err:.3e} (tol {LINALG_REL_TOLERANCE})")

    # --- Cholesky, n = 16384: A = G G^T + 2 I, G ~ N(0, 1 / n).
    n = LINALG_N["cholesky"]
    g = mrand.random_den_vec_matrix(n, n, "normal", seed=5, mesh=mesh,
                                    dtype=torch.float32,
                                    std=1.0 / math.sqrt(n))
    spd = g.local @ g.local.T
    spd.diagonal().add_(2.0)
    del g
    a = pdense.DenseVecMatrix(spd, mesh=mesh, _logical_shape=(n, n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with config_override(cholesky_base_size=LINALG_BASE):
        times, l = _events_ms(lambda: a.cholesky_decompose(mode="dist"),
                              LINALG_RUNS)
    peak = torch.cuda.max_memory_allocated()
    err = _chol_band_err(spd, l.local, LINALG_BAND)
    del l
    lib_times, _ = _events_ms(lambda: torch.linalg.cholesky_ex(spd),
                              LINALG_RUNS)
    rows["cholesky"] = _linalg_line(
        card, "cholesky", n, times, lib_times, n ** 3 / 3.0,
        2 * n * n * f32, peak, band=list(LINALG_BAND), band_rel_err=err,
        small_n=n_s, small_rel_err=chol_small,
        tolerance=LINALG_REL_TOLERANCE)
    del a, spd
    if not err <= LINALG_REL_TOLERANCE:
        fail(f"linalg cholesky: band error {err:.3e} (tol "
             f"{LINALG_REL_TOLERANCE})")

    # --- Inverse, n = 8192: A + n I.
    n = LINALG_N["inverse"]
    a = mrand.random_den_vec_matrix(n, n, "normal", seed=9, mesh=mesh,
                                    dtype=torch.float32)
    a.local.diagonal().add_(float(n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with config_override(lu_base_size=LINALG_BASE):
        times, inv = _events_ms(lambda: a.inverse(mode="dist"), LINALG_RUNS)
    peak = torch.cuda.max_memory_allocated()
    eye = torch.eye(n, device="cuda")
    resid = (inv.local @ a.local - eye).abs().max().item()
    del inv
    lib_times, _ = _events_ms(lambda: torch.linalg.inv(a.local),
                              LINALG_RUNS)
    rows["inverse"] = _linalg_line(
        card, "inverse", n, times, lib_times, 2.0 * n ** 3,
        2 * n * n * f32, peak, max_abs_inv_a_minus_i=resid,
        tolerance=INVERSE_TOLERANCE)
    del a, eye
    if not resid <= INVERSE_TOLERANCE:
        fail(f"linalg inverse: max |inv A - I| = {resid:.3e} (tol "
             f"{INVERSE_TOLERANCE})")

    # --- SVD, dist-eigs, 200,000 x 2048.
    m, n = SVD_SHAPE
    a = mrand.random_den_vec_matrix(m, n, "normal", seed=11, mesh=mesh,
                                    dtype=torch.float32)
    matvecs = [0]
    real_apply = pdense._GramianOperator.apply

    def counting(self, operand, v):
        matvecs[0] += 1
        return real_apply(self, operand, v)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pdense._GramianOperator.apply = counting
    try:
        times, res = _events_ms(lambda: a.compute_svd(
            SVD_K, compute_u=False, mode="dist-eigs", tol=SVD_TOL),
            LINALG_RUNS)
    finally:
        pdense._GramianOperator.apply = real_apply
    peak = torch.cuda.max_memory_allocated()
    s = np.asarray(res.s)
    # The oracle: an f64 eigh of the Gramian (formed in f64 on the card in
    # row blocks of A).
    gram = torch.zeros((n, n), dtype=torch.float64, device="cuda")
    for r0 in range(0, m, 16384):
        blk = a.local[r0:r0 + 16384].double()
        gram += blk.T @ blk
    lam = torch.linalg.eigvalsh(gram).flip(0)[:SVD_K].clamp_min(0)
    want = lam.sqrt().cpu().numpy()
    del gram
    rel = float(np.max(np.abs(s - want) / want))
    steps = matvecs[0] / LINALG_RUNS
    bytes_per_run = steps * 2 * m * n * f32
    t = _spread(times)
    hbm_ms = bytes_per_run / PEAK_BYTES * 1e3
    row = dict(card=card, op="svd_dist_eigs", m=m, n=n, k=SVD_K,
               tol=SVD_TOL, dtype="float32", **t,
               matvecs_per_run=steps, hbm_bound_ms=hbm_ms,
               bound_share=hbm_ms / t["ms"], peak_mem_gb=peak / 1e9,
               s=s.tolist(), s_f64_eigh=want.tolist(), max_rel_err=rel,
               tolerance=SVD_REL_TOLERANCE,
               non_increasing=bool(np.all(np.diff(s) <= 0)))
    print("linalg: " + json.dumps(row), flush=True)
    rows["svd"] = row
    del a
    if s.shape != (SVD_K,) or not row["non_increasing"]:
        fail(f"linalg svd: singular values {s.tolist()} not {SVD_K} "
             f"non-increasing values")
    if not rel <= SVD_REL_TOLERANCE:
        fail(f"linalg svd: max relative error {rel:.3e} against the f64 "
             f"Gramian's eigh (tol {SVD_REL_TOLERANCE})")

    rows["dgetf2"] = phase_linalg_dgetf2()
    launched = dict(**_counters(fa), gather=bs.gather_launches
                    - spmm_before[0], masked=bs.masked_launches
                    - spmm_before[1])
    if any(launched.values()):
        fail(f"linalg: hand-written kernels launched: {launched}")
    dist.destroy_process_group()
    pm.set_default_mesh(None)
    return rows


# The dense path's two examples on one card (ROADMAP A2c):
# examples/rmm_compare.py at m = k = n = RMM_N, f32 (on one rank the grid
# is 1 x 1 x 1 and the mesh square, so all three arms run), a band of each
# arm's product held to the f64 product of the same rows at
# GEMM_REL_TOLERANCE (f32 without TF32 sums 16384 products of two U(0, 1)
# with at most ~16384 * 2^-24 = 1e-3 relative error, far inside it);
# examples/neural_network.py at MNIST's size with the example CLI's
# defaults.
RMM_N = 16384
RMM_BAND = (8192, 256)  # (first row, rows) of each product held to f64
NN_RUN = dict(samples=60000, d_in=784, d_out=10, hidden=256,
              batch_size=512, iterations=50, learning_rate=0.5, seed=0)
# Every step's loss on the card against the CPU run's, relative: the two
# differ in summation order only (f32, no TF32: the port's "highest"
# matmul precision), a few ulps (6e-8) a step, carried over 50 SGD steps.
NN_REL_TOLERANCE = 1e-4


def phase_dense_examples(card: str):
    """rmm_compare and neural_network (see RMM_N, NN_RUN) through the
    examples' own functions on a one-rank NCCL mesh, then the network's
    CPU run on a one-rank gloo mesh. Prints one "dense_examples:" line per
    run; fails on a band, loss or launch check. Returns the lines."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.examples import neural_network as nn
    from marlin_tpu_torch.examples import rmm_compare
    from marlin_tpu_torch.ops import block_sparse as bs
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.utils import random as mrand
    from marlin_tpu_torch.utils.split import grid_for_devices

    mesh = pm.create_mesh()
    if dist.get_backend() != "nccl" or mesh.size != 1:
        fail(f"dense examples: expected a one-rank NCCL mesh, got "
             f"{dist.get_backend()} over {mesh.size} ranks")
    _zero_counters(fa)
    spmm_before = (bs.gather_launches, bs.masked_launches)
    out = {}

    # --- rmm_compare.
    n = RMM_N
    a = mrand.random_den_vec_matrix(n, n, seed=1, mesh=mesh,
                                    dtype=torch.float32)
    b = mrand.random_den_vec_matrix(n, n, seed=2, mesh=mesh,
                                    dtype=torch.float32)
    grid = grid_for_devices(n, n, n, mesh.size)
    arms = rmm_compare.arms(a, b, mesh, grid)
    if set(arms) != {"rmm_3d_grid", "summa_allgather", "cannon_ring"}:
        fail(f"rmm_compare: arms {sorted(arms)} on grid {grid}")
    r0, rows = RMM_BAND
    ref = a.local[r0:r0 + rows].double() @ b.local.double()
    flops = 2.0 * n ** 3
    bound_ms, bound_by = bound(flops, 3 * n * n * 4, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    for label, fn in arms.items():
        c = fn()
        torch.cuda.synchronize()
        band = c[r0:r0 + rows].double()
        if tuple(c.shape) != (n, n) or not bool(torch.isfinite(band).all()):
            fail(f"rmm_compare {label}: shape {tuple(c.shape)} or "
                 f"non-finite values")
        rel = ((band - ref).abs() / ref.abs()).max().item()
        del c, band
        if not rel <= GEMM_REL_TOLERANCE:
            fail(f"rmm_compare {label}: band |C - f64| / |f64| = {rel:.3e} "
                 f"(tol {GEMM_REL_TOLERANCE})")
        seconds = rmm_compare._time(fn)
        clock, power = smi_clock_power()
        row = dict(card=card, example="rmm_compare", arm=label, n=n,
                   grid=list(grid), dtype="float32", seconds=seconds,
                   tflops=flops / seconds / 1e12, bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / 1e3 / seconds,
                   band=list(RMM_BAND), band_max_rel_err=rel,
                   tolerance=GEMM_REL_TOLERANCE, sm_clock_mhz=clock,
                   power_w=power)
        print("dense_examples: " + json.dumps(row), flush=True)
        out[label] = row
    peak = torch.cuda.max_memory_allocated()
    del a, b, ref, arms

    # --- neural_network at MNIST's size: the data as the CLI's synthetic
    # set (the reference's), on the card, then on the CPU.
    rng = np.random.default_rng(0)
    images = rng.random((NN_RUN["samples"], NN_RUN["d_in"]))
    classes = rng.integers(0, NN_RUN["d_out"], NN_RUN["samples"])
    labels = np.eye(NN_RUN["d_out"])[classes]
    kw = dict(hidden=NN_RUN["hidden"], batch_size=NN_RUN["batch_size"],
              iterations=NN_RUN["iterations"],
              learning_rate=NN_RUN["learning_rate"], seed=NN_RUN["seed"])
    def run(iterations):
        """(wall s, the loss tensor) of one training call on the card:
        the data's placement on the card, then ``iterations`` steps."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = nn.train_with_losses(
            images, labels, mesh=mesh, **dict(kw, iterations=iterations))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, losses

    run(2)  # warm-up
    short_s, _ = run(2)
    card_s, losses = run(NN_RUN["iterations"])
    # The steps beyond the short run's two, whose set-up is the same.
    step_ms = (card_s - short_s) / (NN_RUN["iterations"] - 2) * 1e3
    card_losses = losses.double().cpu().numpy()
    del losses
    dist.destroy_process_group()
    pm.set_default_mesh(None)
    cpu_mesh = pm.create_mesh(device="cpu")
    t0 = time.perf_counter()
    _, cpu_losses = nn.train_with_losses(images, labels, mesh=cpu_mesh, **kw)
    cpu_s = time.perf_counter() - t0
    cpu_losses = cpu_losses.double().numpy()
    dist.destroy_process_group()
    pm.set_default_mesh(None)
    rel = float(np.max(np.abs(card_losses - cpu_losses)
                       / np.abs(cpu_losses)))
    row = dict(card=card, example="neural_network", **NN_RUN,
               dtype="float32", seconds=card_s, step_ms=step_ms,
               setup_s=short_s - 2 * step_ms / 1e3,
               first_loss=float(card_losses[0]),
               final_loss=float(card_losses[-1]),
               cpu_seconds=cpu_s, cpu_final_loss=float(cpu_losses[-1]),
               max_rel_loss_diff_vs_cpu=rel, tolerance=NN_REL_TOLERANCE,
               rmm_peak_mem_gb=peak / 1e9)
    print("dense_examples: " + json.dumps(row), flush=True)
    out["neural_network"] = row
    if not (np.isfinite(card_losses).all()
            and card_losses[-1] < card_losses[0]):
        fail(f"neural_network: losses not finite or not falling "
             f"({card_losses[0]:.6f} -> {card_losses[-1]:.6f})")
    if not rel <= NN_REL_TOLERANCE:
        fail(f"neural_network: card losses differ from the CPU run's by "
             f"{rel:.3e} relative (tol {NN_REL_TOLERANCE})")
    launched = dict(**_counters(fa), gather=bs.gather_launches
                    - spmm_before[0], masked=bs.masked_launches
                    - spmm_before[1])
    if any(launched.values()):
        fail(f"dense examples: hand-written kernels launched: {launched}")
    return out


def spmm_kernel_entries(spmm, launches, f32_launches):
    """The SpMM kernels' entries of the {"kernels": [...]} object: the two
    bf16 routes and their f32 kernel. ``spmm`` is phase_spmm's rows;
    ``launches`` is {path: {"gather": n, "masked": n}} for the paths
    "bench512", "coo128" (the gather kernel's), "bench512_f32" (the f32
    kernel's) and "graph512" (the masked kernel's, at the bench512 shape:
    launches there are graph captures); ``f32_launches`` phase_spmm_grad's
    f32 run's (the f32 kernel's, spmm_f32, which both routes take for f32
    operands). The f32 entry's numbers are the gather route's at
    `bench512_f32` (its main path), with every SPMM_F32_SHAPES row and its
    plan's P under "shapes"."""
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
                    launches=launches[path][kernel] if path else 0,
                    max_abs_err=r["max_abs_err"],
                    max_tile_rel_err=r[f"{kernel}_tile_rel_err"],
                    ms=r[f"{kernel}_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    cold_ms=r[f"{kernel}_cold_ms"],
                    **{k: r[k] for k in ("spmm_plan", "masked_ms",
                                         "masked_cold_ms") if k in r})

    def kernel_entry(kernel, replaces, paths):
        per_path = {p: entry(kernel, p, shape) for p, shape in paths}
        return {"name": f"block_sparse_spmm_{kernel}", "route": "cuda",
                "source": "marlin_tpu_torch/csrc/block_sparse.cu",
                "replaces": replaces, **next(iter(per_path.values())),
                "launches": sum(e["launches"] for e in per_path.values()),
                "library_ms_covers": covers, "paths": per_path}

    launches = {**launches, "f32_grad": f32_launches}
    f32 = {shape: entry("gather", None, shape) for shape in SPMM_F32_SHAPES}
    f32_paths = {"bench512_f32": entry("gather", "bench512_f32",
                                       "bench512_f32"),
                 "f32_grad": dict(shape="n = 512, bs = 64, 40% live",
                                  launches=sum(f32_launches.values()))}
    return [
        kernel_entry("gather", "marlin_tpu/ops/block_sparse.py:136",
                     (("bench512", "bench512"), ("coo128", "coo128"))),
        kernel_entry("masked", "marlin_tpu/ops/block_sparse.py:114",
                     (("graph512", "bench512"),)),
        {"name": "block_sparse_spmm_f32", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/block_sparse.cu",
         "replaces": "marlin_tpu/ops/block_sparse.py:136 and :114 (f32)",
         **f32_paths["bench512_f32"],
         "launches": sum(e["launches"] for e in f32_paths.values()),
         "library_ms_covers": covers, "paths": f32_paths, "shapes": f32},
    ]


# The f32 rows' readings of the library call (sdpa_f32_fwd, sdpa_f32_bwd).
_LIBRARY_F32 = ("library_backend", "library_within_limits",
                "library_max_abs_err", "library_tile_rel_err")


def _fwd_entry(n, r):
    """A forward kernel's numbers at phase_kernels' row ``r``, launched
    ``n`` times on the path."""
    return dict(shape=r["shape"], launches=n,
                max_abs_err=r["max_abs_err"],
                max_tile_rel_err=r["o_tile_rel_err"], ms=r["ms"],
                cold_ms=r["cold_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"],
                tflops=r["tflops"], bound_share=r["bound_share"],
                **{k: r[k] for k in _LIBRARY_F32 + ("fwd_plan",) if k in r})


def _bwd_entry(kernel, labels, n, r):
    """Backward kernel ``kernel``'s ("dq" or "dkv") numbers at
    phase_backward's row ``r`` (its errors over ``labels``), launched
    ``n`` times on the path."""
    return dict(
        shape=r["shape"], launches=n,
        max_abs_err=max(r[f"{x}_max_abs_err"] for x in labels),
        max_global_rel_err=max(r[f"{x}_global_rel_err"] for x in labels),
        max_tile_rel_err=max(r[f"{x}_tile_rel_err"] for x in labels),
        ms=r[f"{kernel}_ms"], plain_ms=r["plain_ms"],
        bound_ms=r[f"{kernel}_bound_ms"], bound_by=r[f"{kernel}_bound_by"],
        library_ms=r["library_ms"], tflops=r[f"{kernel}_tflops"],
        bound_share=r[f"{kernel}_bound_ms"] / r[f"{kernel}_ms"],
        cold_ms=r[f"{kernel}_cold_ms"],
        **{k: r[k] for k in _LIBRARY_F32 if k in r},
        **{k: r[k] for k in ("dkv_group_parts", "dkv_parts", "dkv_chunk",
                             "dkv_shares", "dkv_workspace_bytes")
           if kernel == "dkv" and k in r},
        **{k: r[k] for k in ("dq_plan",) if kernel == "dq" and k in r})


def wide_kernel_entries(rows, bwd, small):
    """The wide kernels' entries of the {"kernels": [...]} object: their
    numbers at the "d320" shape (the attention of phase 6's wide_d320
    model, their main path: its bf16 and f32 runs' launches), and every
    WIDE_KERNEL_SHAPES row under "shapes"."""
    src = "marlin_tpu_torch/csrc/flash_attention_wide.cu"
    runs = [r for r in small if r.startswith("wide_d320")]

    def entry(name, kernel, replaces, make, table, covers):
        paths = {run: dict(shape=run, launches=small[run][f"wide_{kernel}"])
                 for run in runs}
        top = make(sum(p["launches"] for p in paths.values()), table["d320"])
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, **top, "paths": paths,
                "library_ms_covers": covers,
                "shapes": {s: make(0, table[s]) for s in WIDE_KERNEL_SHAPES}}

    bwd_covers = ("scaled_dot_product_attention's backward: dQ, dK and dV "
                  "in one call")
    return [
        entry("flash_attention_fwd_wide", "fwd",
              "marlin_tpu/ops/flash_attention.py:134", _fwd_entry, rows,
              "scaled_dot_product_attention's forward"),
        entry("flash_attention_bwd_dq_wide", "dq",
              "marlin_tpu/ops/flash_attention.py:335",
              lambda n, r: _bwd_entry("dq", ("dq",), n, r), bwd, bwd_covers),
        entry("flash_attention_bwd_dkv_wide", "dkv",
              "marlin_tpu/ops/flash_attention.py:373",
              lambda n, r: _bwd_entry("dkv", ("dk", "dv"), n, r), bwd,
              bwd_covers),
    ]


def kernels_line(rows, bwd, launches, small, spmm, spmm_launches,
                 spmm_f32_launches):
    """The {"kernels": [...]} object. Each kernel's top-level numbers are
    those of its first path's shape ("serve" for the forward, "train" for
    the backward, "bench512" for SpMM); ``paths`` gives each path the
    kernel runs on its own launches and its shape's error, times and
    bound, and each small model's run (``small``, phase_small_models'
    {run: {"fwd": n, "dq": n, "dkv": n}}) its launches. ``launches`` is
    {path: {"fwd": n, "dq": n, "dkv": n}}; ``spmm`` and ``spmm_launches``
    and ``spmm_f32_launches`` are spmm_kernel_entries' arguments."""
    bwd_src = "marlin_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd_paths = {p: (launches[p]["fwd"], rows[s]) for p, s in
                 (("serve", "flagship"), ("train", "train"),
                  ("remat", "remat"))}

    fwd_entry = _fwd_entry

    def small_paths(kernel):
        return {run: dict(shape=run, launches=n[kernel])
                for run, n in small.items()}

    def f32(kernel, make, table):
        """The f32 kernel at the "f32" shape (D = 128), with the launches
        of the small models' f32 runs at D <= 128, and at the
        LARGE_F32_SHAPES of the narrow kernels (no launches there)."""
        runs = [r for r in small if r.endswith("_float32")
                and r.startswith(("test_train_d16", "example_d32"))]
        return {"f32": {**make(sum(small[r][kernel] for r in runs),
                               table["f32"]), "launches_of_runs": runs},
                **{s: make(0, table[s]) for s in LARGE_F32_SHAPES
                   if s not in WIDE_KERNEL_SHAPES}}

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
            return _bwd_entry(kernel, labels, n, r)

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
                "paths": all_paths, "head_dim_256": wide(kernel, entry, bwd),
                "f32_shapes": f32(kernel, entry, bwd)}

    fwd_top = fwd_entry(*fwd_paths["serve"])
    fwd_all = {**{p: fwd_entry(*v) for p, v in fwd_paths.items()},
               **small_paths("fwd")}
    return {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "marlin_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "marlin_tpu/ops/flash_attention.py:134",
         **fwd_top, "launches": sum(e["launches"] for e in fwd_all.values()),
         "library_ms_covers": "scaled_dot_product_attention's forward",
         "paths": fwd_all, "head_dim_256": wide("fwd", fwd_entry, rows),
         "f32_shapes": f32("fwd", fwd_entry, rows)},
        bwd_kernel("dq", "marlin_tpu/ops/flash_attention.py:335", ("dq",)),
        bwd_kernel("dkv", "marlin_tpu/ops/flash_attention.py:373",
                   ("dk", "dv")),
        *wide_kernel_entries(rows, bwd, small),
        *spmm_kernel_entries(spmm, spmm_launches, spmm_f32_launches),
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
    spmm_f32_launches = phase_spmm_grad()
    phase_gemm(card)
    phase_linalg(card)
    phase_dense_examples(card)
    kernels = kernels_line(rows, bwd, launches, small, spmm, spmm_launches,
                           spmm_f32_launches)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
