// Block-sparse GEMM (SpMM) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of marlin_tpu/ops/block_sparse.py:
//
//   * _spmm_gather_kernel (built by _spmm_gather_fn): C = A @ B with B
//     block-sparse, the k sweep remapped through per-column lists of
//     nonzero blocks (kidx, kcnt; scalar-prefetched on the TPU). Here:
//     marlin_block_sparse_spmm_gather.
//   * _spmm_kernel (built by _spmm_fn): the same product over the full
//     K grid, each step gated on a block mask that lives on the device.
//     Here: marlin_block_sparse_spmm_masked.
//
// A is (M, K), B's backing array (K, N) and C (M, N), all row-major and
// contiguous; B's blocks are bs x bs with bs a multiple of 64, K and N
// multiples of bs, M arbitrary. mask is (K/bs, N/bs) int32; kidx is
// (N/bs, max_nnz) int32, ascending in each row, and kcnt (N/bs) int32.
//
// Semantics kept from the TPU kernels: one f32 accumulator per output
// element across all of a column's blocks, cast to the output type once at
// the end (a bf16 running sum would round per block); a block that is not
// listed, or whose mask entry is 0, is neither loaded nor multiplied, so
// what its storage holds never reaches C; a block column with no live
// block comes out exactly 0.
//
// What the TPU's cut of the work becomes here. The TPU grid is
// (M/bs, N/bs, max_nnz), sequential in its last dimension with the sum in
// a VMEM scratch; every column is padded to the densest column's count
// and the padded steps repeat the last index. Here a CTA owns one
// 128 x BN output tile (BN = 128 when bs is a multiple of 128, else 64:
// the tile is the kernel's choice, not bs, and lies inside one block
// column), finds its own column's live blocks (its list, or its column of
// the mask) and loops over exactly those. Nothing carries between CTAs
// and there is no padding: a CTA's work is its column's own count, so
// columns of different density finish at different times and the card's
// scheduler fills in behind them. The ragged M edge is masked here (rows
// past M are zero-filled on load and not stored); the caller pads and
// copies nothing. The grid is one-dimensional (2^31 - 1 CTAs), so every M
// and N the TPU grid takes fits it; each kernel decodes its tile from
// blockIdx.x.
//
// Both routes run one bf16 kernel body, spmm_ring_bf16<BN, GATHER>, which
// differs only in how it finds a column's live blocks (LiveBlocks below):
// the same blocks in the same ascending-k order through the same
// instructions, so the two routes' bf16 results are bitwise equal.
//
// Bound on the H100. At the main shape (M = K = N = 8192, bf16, 12% of the
// blocks live) the work is 2 M bs^2 nnz_blocks = 132 GFLOP against ~285 MB
// of traffic (A once, B's live blocks, C once): ~460 FLOP per byte, above
// the card's ~295 FLOP/byte ridge, so the bound is the tensor-core rate
// (989 TFLOP/s bf16 dense), which only wgmma reaches.
//
// The bf16 kernel is built for it (shared pieces in sm90.cuh): a 128 x BN
// output tile, two consumer warpgroups of m64nBNk16 SS wgmma, A and B's
// blocks by 2-D TMA (128-byte swizzle; A K-major, B read as the MN-major
// operand, so nothing is transposed or gathered by hand) into a 3-stage
// mbarrier ring 64 deep a stage, which one producer thread keeps full
// across block boundaries; block columns fastest on the grid, so the CTAs
// in flight read the same rows of A and B's live blocks stay in L2. A
// 128 x 128 tile still moves 1 byte from L2 for every 64 FLOP, and it
// uses no clusters, multicast or persistent tile scheduler. The masked
// route's one step of its own: the CTA's 256 threads count the live
// entries of the mask column together before the first load, since every
// thread needs the ring's step count up front and no per-column list
// exists (it runs under CUDA-graph capture, where the host cannot build
// one).
//
// The f32 kernel, spmm_f32<GATHER> (both routes, one body, so bitwise
// equal), keeps full f32 products and sums, no TF32, so it matches an f32
// reference to summation order; its bound is the card's 67 TFLOP/s f32
// rate or its 3.35 TB/s, whichever is larger (tall or wide outputs with
// few live blocks are bytes: A read, C written). It is built on the f32
// flash kernels' pieces (flash_f32.cuh): a 128 x 64 output tile on two
// warpgroups of 8 x 4 register tiles (the shared-memory fills cap the FMA
// rate at 67%, where 4 x 4 tiles cap it at 50%), A's and B's 64 x 64 boxes
// by cp.async through a two-slot ring of its own (three boxes a step, 104
// KB, so two CTAs share an SM). The grid is persistent: each CTA takes its
// units of work (a tile and one sweep part of it) in turn with one ring
// across them, so the next unit's boxes load while a unit's last products
// run and its sums are stored; at one depth step a tile (a tall output
// over few blocks) nothing else would hide them. Where the output has few
// tiles and K many blocks, a column's live blocks are cut into P sweep
// parts (P from the shape alone: the wrapper's _spmm_f32_plan) whose f32
// partial sums a second pass, spmm_part_sum_f32, adds in part order: no
// atomics, bitwise repeatable.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------
// Finding the live blocks of block column j, in ascending k
// ---------------------------------------------------------------------

// GATHER: walk the column's list kidx[j, 0 .. kcnt[j]). Otherwise: walk
// k = 0 .. K/bs and skip every block whose mask[k, j] is 0, reading the
// mask column AHEAD entries at a time (1 to 32) into a bitmask: AHEAD
// independent loads, so a run of dead blocks costs one load's latency
// and not one a block, for AHEAD registers more. init() sets the column;
// a thread that walks it then calls skip_dead() once, to stand on the
// first live block.
template <bool GATHER, int AHEAD>
struct LiveBlocks {
  static_assert(AHEAD >= 1 && AHEAD <= 32, "the window is 32 bits");
  const int* list;  // GATHER: kidx + j * max_nnz; else mask + j
  int count;        // GATHER: kcnt[j]; else K / bs
  size_t stride;    // mask row stride (N / bs); unused for GATHER
  int pos;          // GATHER: index into the list; else the k block itself
  int win0;         // mask walk: the first block of the window
  uint32_t window;  // mask walk: bit i set when block win0 + i is live,
                    // for i < AHEAD

  // The mask walk's one test: block k of the column is live.
  __device__ __forceinline__ bool is_live(int k) const {
    return list[(size_t)k * stride] != 0;
  }
  __device__ __forceinline__ void fill_window(int k0) {
    win0 = k0;
    window = 0;
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (k0 + i < count && is_live(k0 + i)) window |= 1u << i;
  }
  __device__ __forceinline__ void skip_dead() {
    if (!GATHER) {
      while (pos < count) {
        if (pos >= win0 + AHEAD) fill_window(pos);
        const uint32_t ahead = window >> (pos - win0);
        if (ahead != 0) {
          pos += __ffs(ahead) - 1;
          return;
        }
        pos = win0 + AHEAD;
      }
    }
  }
  __device__ __forceinline__ void init(const int* kidx, const int* kcnt,
                                       const int* mask, int j, int max_nnz,
                                       int nkb, int nbn) {
    if (GATHER) {
      list = kidx + (size_t)j * max_nnz;
      count = kcnt[j];
    } else {
      list = mask + j;
      count = nkb;
    }
    stride = (size_t)nbn;
    pos = 0;
    win0 = -AHEAD;  // no window yet
  }
  __device__ __forceinline__ bool live() const { return pos < count; }
  __device__ __forceinline__ int block() const {
    return GATHER ? list[pos] : pos;
  }
  __device__ __forceinline__ void next() {
    ++pos;
    skip_dead();
  }
  // How many blocks the walk visits, the same in every thread: the list's
  // length, or the live entries of the mask column, which the CTA's
  // `threads` threads count together (strided reads, one
  // __syncthreads_count a round), so every thread of the CTA calls it.
  __device__ __forceinline__ int n_live(int threads) const {
    if (GATHER) return count;
    int live = 0;
    for (int k0 = 0; k0 < count; k0 += threads) {
      const int k = k0 + (int)threadIdx.x;
      live += __syncthreads_count(k < count && is_live(k));
    }
    return live;
  }
};

// The k offsets of a column's depth steps: every live block, `step`
// elements of depth at a time.
template <bool GATHER, int AHEAD>
struct DepthSteps {
  LiveBlocks<GATHER, AHEAD> blocks;
  int sub;        // step inside the current block
  int per_block;  // bs / step
  int bs, step;

  __device__ __forceinline__ bool live() const { return blocks.live(); }
  __device__ __forceinline__ size_t k() const {
    return (size_t)blocks.block() * bs + (size_t)sub * step;
  }
  __device__ __forceinline__ void advance() {
    if (++sub == per_block) {
      sub = 0;
      blocks.next();
    }
  }
};

// ---------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring (both routes)
// ---------------------------------------------------------------------

constexpr int kGBM = 128;        // output rows per CTA (2 warpgroups x 64)
constexpr int kGBK = 64;         // depth per stage: one TMA box, one block
constexpr int kGStages = 3;      // stages in the ring
constexpr int kGThreads = 256;   // two consumer warpgroups
constexpr int kGBox = 64 * 128;  // bytes of one B box: 64 rows x 64 bf16
constexpr int kGAhead = 32;      // mask entries thread 0 reads at once

// Byte offsets into the (1024-aligned) dynamic shared memory.
template <int BN>
struct RingSmem {
  static constexpr int kA = kGBM * 128;                  // 128 rows x 64 bf16
  static constexpr int kStage = kA + (BN / 64) * kGBox;  // A, then 64 x BN of B
  static constexpr int kBars = kGStages * kStage;        // full, empty
  static constexpr int kBytes = kBars + 8 * 2 * kGStages + 1024;
};

// One CTA per 128 x BN output tile inside one block column, the block
// columns fastest on the grid, so that the CTAs in flight share rows of A
// (each column reads its live blocks' slices of the same A rows) and B's
// live blocks stay in L2 across the rows. The column's live blocks are
// walked by DepthSteps<GATHER, kGAhead> (its list, or its mask column
// read 32 entries ahead), 64 deep a stage; thread 0 keeps the ring full:
// a stage is A[m0 .. m0 + 128, k .. k + 64) (one K-major box, rows past M
// read as zeros) and B[k .. k + 64, n0 .. n0 + BN) (BN / 64 boxes, read
// as the MN-major B), both by TMA onto the stage's full barrier. Each
// warpgroup runs m64nBNk16 SS wgmma on its 64 rows of the stage and keeps
// one step's products in flight: the stage before is handed back (its
// empty barrier) once they retire. Nothing drains between two live
// blocks; an empty column runs no step and writes exact zeros. Every
// thread takes the step count from n_live, so the producer starts
// exactly the loads the consumers wait for and none is in flight at exit.
template <int BN, bool GATHER>
__global__ void __launch_bounds__(kGThreads, 2)
spmm_ring_bf16(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               __nv_bfloat16* __restrict__ c, const int* __restrict__ kidx,
               const int* __restrict__ kcnt, const int* __restrict__ mask,
               int M, int K, int N, int bs, int max_nnz) {
  using L = RingSmem<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kGStages;

  const unsigned n_cols = N / BN;
  const int n0 = (int)(blockIdx.x % n_cols) * BN;
  const int m0 = (int)(blockIdx.x / n_cols) * kGBM;
  const int j = n0 / bs;  // this tile's block column
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator row in the warp's 16 (and + 8)
  const int t = lane % 4;  // accumulator column pair

  // Every thread counts the column's steps; thread 0 walks them, after
  // the count has brought the mask column into L1.
  DepthSteps<GATHER, kGAhead> steps;
  steps.blocks.init(kidx, kcnt, mask, j, max_nnz, K / bs, N / bs);
  steps.sub = 0;
  steps.per_block = bs / kGBK;
  steps.bs = bs;
  steps.step = kGBK;
  const int n_steps = steps.blocks.n_live(kGThreads) * steps.per_block;
  if (tid == 0) steps.blocks.skip_dead();

  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kGThreads);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // The walk's next step into stage i % kGStages (thread 0 only).
  auto load_step = [&](int i) {
    const int s = i % kGStages;
    unsigned char* dst = smem + s * L::kStage;
    const int k = (int)steps.k();
    sm90::mbar_arrive_expect_tx(&full[s], L::kStage);
    sm90::tma_load_2d(dst, &ta, &full[s], k, m0);
    for (int cc = 0; cc < BN / 64; ++cc)
      sm90::tma_load_2d(dst + L::kA + cc * kGBox, &tb, &full[s],
                        n0 + cc * 64, k);
    steps.advance();
  };
  if (tid == 0)
    for (int i = 0; i < kGStages && i < n_steps; ++i) load_step(i);
  __syncwarp();

  float acc[BN / 2];  // the warpgroup's 64 x BN f32 accumulator
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  sm90::fence_regs(acc);
  const uint32_t base = sm90::smem_u32(smem);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kGStages;
    sm90::mbar_wait(&full[s], (i / kGStages) & 1);
    __syncwarp();
    const uint32_t a_base = base + s * L::kStage + wg * 64 * 128;
    const uint32_t b_base = base + s * L::kStage + L::kA;
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kGBK / 16; ++kc)
      sm90::wgmma_ss<1>(acc, sm90::desc_sw128(a_base + kc * 32, 16, 1024),
                        sm90::desc_sw128(b_base + kc * 16 * 128, kGBox, 1024),
                        1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // step i - 1's products have retired
    if (i > 0) {
      const int done = i - 1;
      sm90::mbar_arrive(&empty[done % kGStages]);
      if (tid == 0 && done + kGStages < n_steps) {
        sm90::mbar_wait(&empty[done % kGStages], (done / kGStages) & 1);
        load_step(done + kGStages);
      }
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // One write, cast once; rows past M are not stored.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row >= M) continue;
    __nv_bfloat16* crow = c + (size_t)row * N + n0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(crow + nt * 8) =
          __floats2bfloat162_rn(acc[nt * 4 + 2 * r], acc[nt * 4 + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------
// f32: register-tiled FMA fed by cp.async (both routes)
// ---------------------------------------------------------------------

constexpr int kFRows = 128;  // output rows per tile (2 warpgroups x 64)
constexpr int kFCols = 64;   // output columns per tile
constexpr int kFStep = 64;   // depth per step: one box
constexpr int kFStages = 2;  // ring slots
constexpr int kFCtasPerSm = 2;  // CTAs of the persistent grid an SM
// A ring slot: A's two 64-row boxes of the step, then B's box.
constexpr int kFSlotFloats = 3 * flash_f32::kBoxFloats;
constexpr int kFSmemBytes = kFStages * kFSlotFloats * 4;  // 104,448: 2 CTAs

// The f32 kernel's arguments. A unit of work is one 128 x 64 output tile
// inside one block column and one sweep part of it; `units` is row tiles
// x P x column tiles.
struct F32Args {
  const float* a;
  const float* b;
  float* c;
  float* ws;  // (parts, M, N) for parts > 1
  const int* kidx;
  const int* kcnt;
  const int* mask;
  int M, K, N, bs, max_nnz, parts;
  unsigned units;
};

// Unit u: column tiles fastest, then the parts, then the row tiles, so the
// units in flight share rows of A.
struct F32Unit {
  int m0, n0, p;
};

__device__ __forceinline__ F32Unit unit_of(const F32Args& g, unsigned u) {
  const unsigned n_cols = g.N / kFCols;
  const unsigned rest = u / n_cols;
  return F32Unit{(int)(rest / g.parts) * kFRows, (int)(u % n_cols) * kFCols,
                 (int)(rest % g.parts)};
}

// The run of live blocks [lo, hi) that part p of P takes of a column of n:
// P runs in ascending k whose lengths differ by at most one; a run may be
// empty. A function of (n, P, p) alone, so both routes cut alike.
__device__ __forceinline__ void part_run(int n, int parts, int p, int* lo,
                                         int* hi) {
  *lo = (int)((long long)p * n / parts);
  *hi = (int)((long long)(p + 1) * n / parts);
}

// Unit t's column walk, set on its column (init) and its run cut from the
// column's count (n_live, which every thread of the CTA calls together):
// the run's depth steps, with the walk stood on the run's first block.
template <bool GATHER>
__device__ __forceinline__ int unit_steps(const F32Args& g, const F32Unit& t,
                                          LiveBlocks<GATHER, 1>& blocks) {
  blocks.init(g.kidx, g.kcnt, g.mask, t.n0 / g.bs, g.max_nnz, g.K / g.bs,
              g.N / g.bs);
  int lo, hi;
  part_run(blocks.n_live(flash_f32::kThreads), g.parts, t.p, &lo, &hi);
  if (hi > lo) {
    blocks.skip_dead();  // on the column's first live block
    for (int x = 0; x < lo; ++x) blocks.next();
  }
  return (hi - lo) * (g.bs / kFStep);
}

// A persistent grid: CTA x takes units x, x + G, x + 2G, ... (G CTAs,
// kFCtasPerSm an SM), in that order, and one ring of two slots runs on
// across them. Its producer (every thread together) walks the CTA's units
// ahead of the products: it counts one unit at a time (unit_steps: its
// list's length, or its mask column's live entries) and walks the live
// blocks of each unit's run (the list, or the mask column one entry at a
// time), loading each step into its slot as the step after the last one
// the products took, never further ahead. It runs at each step's barrier
// and, between units, while the consumer catches it up to its next unit,
// so a run of empty units costs one count and one store each, in turn,
// and the first boxes of the next unit with a step load while this
// unit's last products run and its sums are stored. A step is A's two
// 64 x 64 boxes (rows m0 .. m0 + 128 at depth k; rows past M zero-filled)
// and B's box (depth k, columns n0 .. n0 + 64), by cp.async (flash_f32's
// load_box). The consumer takes the units in the same order, reading
// each one's step count off the producer (a unit it has passed has none);
// each warpgroup multiplies its A box by the B box on 8 x 4 register
// tiles (flash_f32's tile_out) in ascending k, and the sums go once,
// uncast, to C at P = 1, or to the part's plane of the workspace (P, M,
// N); an empty column or part runs no step and writes exact zeros. No
// atomics: spmm_part_sum_f32 adds the parts' planes in part order. Rows
// past M are not stored.
template <bool GATHER>
__global__ void __launch_bounds__(flash_f32::kThreads, kFCtasPerSm)
spmm_f32(const F32Args g) {
  using namespace flash_f32;
  extern __shared__ __align__(16) float smem_f[];
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tn = lane & 7, tm = (warp & 3) * 4 + (lane >> 3);
  const int per_block = g.bs / kFStep;

  // The producer: the unit it stands on, whether it has counted it, the
  // unit's steps, its walk of the unit's run, the steps of the run still
  // to load, the step inside the current block, and the steps loaded.
  unsigned p_unit = blockIdx.x;
  bool p_counted = false;
  LiveBlocks<GATHER, 1> p_blocks;
  int p_steps = 0, p_left = 0, p_sub = 0, loaded = 0;
  // With no step of its unit left, count the next unit; then, if it
  // stands on a step and `may` is the next step to load, load it into its
  // slot. Commits one group either way.
  auto produce = [&](int may) {
    if (p_left <= 0 && p_unit < g.units) {
      if (p_counted) p_unit += gridDim.x;
      p_counted = p_unit < g.units;
      if (p_counted) {
        p_steps = p_left = unit_steps(g, unit_of(g, p_unit), p_blocks);
        p_sub = 0;
      }
    }
    if (p_left > 0 && loaded == may) {
      const F32Unit t = unit_of(g, p_unit);
      float* slot = smem_f + (may % kFStages) * kFSlotFloats;
      const size_t k = (size_t)p_blocks.block() * g.bs + p_sub * kFStep;
      const int valid0 = min(kBox, g.M - t.m0);
      const int valid1 = min(kBox, g.M - t.m0 - kBox);
      const float* a0 = g.a + (size_t)t.m0 * g.K + k;
      load_box(slot, a0, g.K, valid0);
      load_box(slot + kBoxFloats, valid1 > 0 ? a0 + (size_t)kBox * g.K : a0,
               g.K, valid1);
      load_box(slot + 2 * kBoxFloats, g.b + k * g.N + t.n0, g.N, kBox);
      ++loaded;
      if (--p_left > 0 && ++p_sub == per_block) {
        p_sub = 0;
        p_blocks.next();
      }
    }
    cp_async_commit();
  };

  int step = 0;  // steps the products took
  for (unsigned u = blockIdx.x; u < g.units; u += gridDim.x) {
    // The producer catches up to this unit: it loads the unit's first step
    // (the next one) where it has one.
    while (p_unit < u || (p_unit == u && !p_counted)) produce(step);
    const F32Unit t = unit_of(g, u);
    const int n_steps = u == p_unit ? p_steps : 0;
    float4 acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n_steps; ++i, ++step) {
      // The step's boxes are in; every thread is past the step before,
      // whose slot takes the step after this one.
      cp_async_wait<0>();
      __syncthreads();
      produce(step + 1);
      const float* sl = smem_f + (step % kFStages) * kFSlotFloats;
      tile_out(acc, sl + wg * kBoxFloats, sl + 2 * kBoxFloats, tn, tm);
    }
    float* out = g.parts == 1 ? g.c : g.ws + (size_t)t.p * g.M * g.N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = t.m0 + wg * kBox + tn + 8 * i;
      if (row < g.M)
        *reinterpret_cast<float4*>(out + (size_t)row * g.N + t.n0 + 4 * tm) =
            acc[i];
    }
  }
  cp_async_wait<0>();
}

// The second pass where P > 1: C = the parts' planes of the workspace
// added in part order, a float4 a step (a grid-stride loop).
__global__ void __launch_bounds__(flash_f32::kSumThreads)
spmm_part_sum_f32(const float4* __restrict__ ws, float4* __restrict__ c,
                  long long n4, int parts) {
  for (long long e = blockIdx.x * (long long)flash_f32::kSumThreads +
                     threadIdx.x;
       e < n4; e += (long long)gridDim.x * flash_f32::kSumThreads) {
    float4 s = ws[e];
    for (int q = 1; q < parts; ++q) {
      const float4 x = ws[q * n4 + e];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    c[e] = s;
  }
}

// ---------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------

// A 1-D grid of row_tiles x col_tiles CTAs, or 0 where that passes
// gridDim.x's 2^31 - 1.
inline unsigned grid_1d(long long row_tiles, long long col_tiles) {
  const long long n = row_tiles * col_tiles;
  return n > 0x7fffffffLL ? 0u : (unsigned)n;
}

template <int BN, bool GATHER>
cudaError_t run_ring_bf16(const void* a, const void* b, void* c,
                          const int* kidx, const int* kcnt, const int* mask,
                          int M, int K, int N, int bs, int max_nnz,
                          cudaStream_t stream) {
  const unsigned grid = grid_1d((M - 1) / kGBM + 1, N / BN);
  if (grid == 0) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err;
  if ((err = sm90::tmap_2d(&ta, a, M, K, kGBM)) != cudaSuccess ||
      (err = sm90::tmap_2d(&tb, b, K, N, kGBK)) != cudaSuccess)
    return err;
  auto kernel = spmm_ring_bf16<BN, GATHER>;
  const int smem = RingSmem<BN>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGThreads, smem, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), kidx, kcnt, mask, M, K, N, bs,
      max_nnz);
  return cudaGetLastError();
}

// The f32 kernel's persistent grid over its row tiles x column tiles x
// `parts` units and, for parts > 1, its second pass on the same stream.
template <bool GATHER>
cudaError_t run_f32(const void* a, const void* b, void* c, void* ws,
                    const int* kidx, const int* kcnt, const int* mask, int M,
                    int K, int N, int bs, int max_nnz, int parts,
                    cudaStream_t stream) {
  if (parts < 1 || (parts > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  const long long cols = (long long)(N / kFCols) * parts;  // x P parts
  const unsigned grid = grid_1d((M - 1) / kFRows + 1, cols);  // the units
  if (grid == 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const unsigned ctas = min(grid, (unsigned)(kFCtasPerSm * sms));
  auto kernel = spmm_f32<GATHER>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmemBytes);
  if (err != cudaSuccess) return err;
  const F32Args g{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<float*>(c), static_cast<float*>(ws), kidx,
                  kcnt, mask, M, K, N, bs, max_nnz, parts, grid};
  kernel<<<ctas, flash_f32::kThreads, kFSmemBytes, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess || parts == 1) return err;
  const long long n4 = (long long)M * N / 4;
  long long blocks = (n4 + flash_f32::kSumThreads - 1) / flash_f32::kSumThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // a grid-stride loop past it
  const unsigned sum_grid = (unsigned)blocks;
  spmm_part_sum_f32<<<sum_grid, flash_f32::kSumThreads, 0, stream>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(c), n4, parts);
  return cudaGetLastError();
}

template <bool GATHER>
cudaError_t run(int dtype, const void* a, const void* b, void* c, void* ws,
                const int* kidx, const int* kcnt, const int* mask, int M,
                int K, int N, int bs, int max_nnz, int parts,
                cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || bs < 64 || bs % 64 || K % bs || N % bs)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (parts != 1) return cudaErrorInvalidValue;
    if (bs % 128 == 0)
      return run_ring_bf16<128, GATHER>(a, b, c, kidx, kcnt, mask, M, K, N,
                                        bs, max_nnz, stream);
    return run_ring_bf16<64, GATHER>(a, b, c, kidx, kcnt, mask, M, K, N, bs,
                                     max_nnz, stream);
  }
  if (dtype == 1)
    return run_f32<GATHER>(a, b, c, ws, kidx, kcnt, mask, M, K, N, bs,
                           max_nnz, parts, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes (marlin_tpu_torch/ops/block_sparse.py).
// dtype: 0 = bf16, 1 = f32. Each returns the cudaError_t of its launch
// (0 = ok); a shape or dtype the kernels do not take returns
// cudaErrorInvalidValue. `parts` is the f32 kernel's sweep parts P per
// output tile (bf16: 1 only), `workspace` its f32 (P, M, N) partial sums
// for P > 1 (the caller allocates it; unused at P = 1 and for bf16).
// Launched on `stream`; nothing is allocated and nothing synchronises.

// The gather route: kidx (N / bs, max_nnz) and kcnt (N / bs), on the
// device.
extern "C" int marlin_block_sparse_spmm_gather(int dtype, const void* a,
                                               const void* b, void* c,
                                               const void* kidx,
                                               const void* kcnt,
                                               void* workspace, int M, int K,
                                               int N, int bs, int max_nnz,
                                               int parts, void* stream) {
  if (max_nnz < 1) return (int)cudaErrorInvalidValue;
  return (int)run<true>(dtype, a, b, c, workspace,
                        static_cast<const int*>(kidx),
                        static_cast<const int*>(kcnt), nullptr, M, K, N, bs,
                        max_nnz, parts, static_cast<cudaStream_t>(stream));
}

// The masked-grid route: mask (K / bs, N / bs) int32, on the device.
extern "C" int marlin_block_sparse_spmm_masked(int dtype, const void* a,
                                               const void* b, void* c,
                                               const void* mask,
                                               void* workspace, int M, int K,
                                               int N, int bs, int parts,
                                               void* stream) {
  return (int)run<false>(dtype, a, b, c, workspace, nullptr, nullptr,
                         static_cast<const int*>(mask), M, K, N, bs, 0,
                         parts, static_cast<cudaStream_t>(stream));
}
