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
// column), reads its own column's count and list (or scans its column of
// the mask) and loops over exactly the live blocks (64 deep a step in the
// gather kernel, 32 in the masked one).
// Nothing carries between CTAs and there is no padding: a CTA's work is
// its column's own count, so columns of different density finish at
// different times and the card's scheduler fills in behind them. The
// ragged M edge is masked here (rows past M are zero-filled on load and
// not stored); the caller pads and copies nothing.
//
// The two bf16 kernels run different main loops over the same walk, in
// the same ascending-k order (below); their results agree per tile within
// bf16 rounding of the f32 sums, not bitwise, until the masked kernel moves
// onto the gather kernel's loop. The f32 kernels share one loop and are
// bitwise equal.
//
// Bound on the H100. At the main shape (M = K = N = 8192, bf16, 12% of the
// blocks live) the work is 2 M bs^2 nnz_blocks = 132 GFLOP against ~285 MB
// of traffic (A once, B's live blocks, C once): ~460 FLOP per byte, above
// the card's ~295 FLOP/byte ridge, so the bound is the tensor-core rate
// (989 TFLOP/s bf16 dense), which only wgmma reaches.
//
// The gather kernel is built for it (shared pieces in sm90.cuh): a 128 x BN
// output tile, two consumer warpgroups of m64nBNk16 SS wgmma, A and B's
// blocks by 2-D TMA (128-byte swizzle; A K-major, B read as the MN-major
// operand, so nothing is transposed or gathered by hand) into a 3-stage
// mbarrier ring 64 deep a stage, which one producer thread keeps full
// across block boundaries; block columns fastest on the grid, so the CTAs
// in flight read the same rows of A and B's live blocks stay in L2. A
// 128 x 128 tile still moves 1 byte from L2 for every 64 FLOP, and it
// uses no clusters, multicast or persistent tile scheduler.
//
// The masked-grid kernel keeps the first design: mma.sync m16n8k16 (bf16
// in, f32 accumulate) fed by ldmatrix from padded, bank-conflict-free
// shared-memory tiles, which a four-stage cp.async ring keeps filled
// across block boundaries.
//
// The f32 path is a plain FMA kernel (64 x 64 tile, 4 x 4 per thread):
// full f32 products and sums, no TF32, so it matches an f32 reference to
// summation order. It is bounded by the card's 67 TFLOP/s f32 rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------
// Finding the live blocks of block column j, in ascending k
// ---------------------------------------------------------------------

// GATHER: walk the column's list kidx[j, 0 .. kcnt[j]). Otherwise: walk
// k = 0 .. K/bs and skip every block whose mask[k, j] is 0.
template <bool GATHER>
struct LiveBlocks {
  const int* list;  // GATHER: kidx + j * max_nnz; else mask + j
  int count;        // GATHER: kcnt[j]; else K / bs
  size_t stride;    // mask row stride (N / bs); unused for GATHER
  int pos;          // GATHER: index into the list; else the k block itself

  __device__ __forceinline__ void skip_dead() {
    if (!GATHER) {
      while (pos < count && list[(size_t)pos * stride] == 0) ++pos;
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
    skip_dead();
  }
  __device__ __forceinline__ bool live() const { return pos < count; }
  __device__ __forceinline__ int block() const {
    return GATHER ? list[pos] : pos;
  }
  __device__ __forceinline__ void next() {
    ++pos;
    skip_dead();
  }
};

// The k offsets of a column's depth steps: every live block, `step`
// elements of depth at a time.
template <bool GATHER>
struct DepthSteps {
  LiveBlocks<GATHER> blocks;
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
// bf16 masked-grid kernel: mma.sync fed by cp.async
// ---------------------------------------------------------------------

constexpr int kBM = 128;      // output rows per CTA
constexpr int kBK = 32;       // depth per pipeline stage
constexpr int kStages = 4;    // cp.async ring
constexpr int kThreads = 256; // 8 warps: 4 along M x 2 along N
constexpr int kPad = 8;       // bf16 elements of row padding (16 bytes)
constexpr int kLDA = kBK + kPad;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the destination is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
struct Bf16Tiles {
  static constexpr int kLDB = BN + kPad;
  static constexpr int kAElems = kBM * kLDA;
  static constexpr int kBElems = kBK * kLDB;
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * (size_t)kStages * (kAElems + kBElems);
};

// One stage's loads: A[m0 .. m0 + 128, k .. k + 32) and
// B[k .. k + 32, n0 .. n0 + BN), 16 bytes per cp.async; A rows at or past
// M are zero-filled.
template <int BN>
__device__ __forceinline__ void load_stage(__nv_bfloat16* sA,
                                           __nv_bfloat16* sB,
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int M,
                                           size_t K, size_t N, int m0,
                                           size_t n0, size_t k) {
  constexpr int kAChunks = kBM * (kBK / 8);
  for (int c = threadIdx.x; c < kAChunks; c += kThreads) {
    int r = c / (kBK / 8);
    int col = (c % (kBK / 8)) * 8;
    bool ok = m0 + r < M;
    const __nv_bfloat16* src = ok ? a + (size_t)(m0 + r) * K + k + col : a;
    cp_async16(sA + r * kLDA + col, src, ok);
  }
  constexpr int kBChunks = kBK * (BN / 8);
  for (int c = threadIdx.x; c < kBChunks; c += kThreads) {
    int r = c / (BN / 8);
    int col = (c % (BN / 8)) * 8;
    cp_async16(sB + r * Bf16Tiles<BN>::kLDB + col,
               b + (k + r) * N + n0 + col, true);
  }
}

template <int BN, bool GATHER>
__global__ void __launch_bounds__(kThreads, 2)
spmm_bf16(const __nv_bfloat16* __restrict__ a,
          const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ c,
          const int* __restrict__ kidx, const int* __restrict__ kcnt,
          const int* __restrict__ mask, int M, int K, int N, int bs,
          int max_nnz) {
  using T = Bf16Tiles<BN>;
  constexpr int kWN = BN / 2;  // a warp's columns
  constexpr int kNT = kWN / 8; // its n-tiles of the m16n8 C layout
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + kStages * T::kAElems;

  const int m0 = blockIdx.x * kBM;
  const size_t n0 = (size_t)blockIdx.y * BN;
  const int j = (int)(n0 / bs);  // this tile's block column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 4;
  const int wn = warp / 4;

  DepthSteps<GATHER> ld;
  ld.blocks.init(kidx, kcnt, mask, j, max_nnz, K / bs, N / bs);
  ld.sub = 0;
  ld.per_block = bs / kBK;
  ld.bs = bs;
  ld.step = kBK;

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // Fill the ring: one commit group per stage, empty once the column's
  // steps run out, so that group d always holds step d.
  int issued = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld.live()) {
      load_stage<BN>(sA + s * T::kAElems, sB + s * T::kBElems, a, b, M, K, N,
                     m0, n0, ld.k());
      ld.advance();
      ++issued;
    }
    cp_async_commit();
  }

  for (int done = 0; done < issued; ++done) {
    cp_async_wait<kStages - 2>();  // step `done` has landed
    __syncthreads();               // ... for every thread, and the stage
                                   // consumed last iteration is free
    if (ld.live()) {
      int s = (done + kStages - 1) % kStages;
      load_stage<BN>(sA + s * T::kAElems, sB + s * T::kBElems, a, b, M, K, N,
                     m0, n0, ld.k());
      ld.advance();
      ++issued;
    }
    cp_async_commit();

    const __nv_bfloat16* tA = sA + (done % kStages) * T::kAElems;
    const __nv_bfloat16* tB = sB + (done % kStages) * T::kBElems;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      // A fragments: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
      // (rows 0-7, k 8-15), (rows 8-15, k 8-15) of each 16 x 16 piece.
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], tA + (wm * 32 + mt * 16 + lane % 16) * kLDA +
                                kc * 16 + (lane / 16) * 8);
      // B fragments, transposed on load from the (k, n) tile: matrices
      // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15),
      // that is (b0, b1) of two neighbouring n-tiles.
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, tB + (kc * 16 + lane % 16) * T::kLDB +
                                  wn * kWN + np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // One write, cast once: rows g and g + 8 of each m-tile, column pairs.
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int row = m0 + wm * 32 + mt * 16 + g + half * 8;
      if (row >= M) continue;
      __nv_bfloat16* crow = c + (size_t)row * N + n0 + wn * kWN + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt][2 * half],
                                                 acc[mt][nt][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(crow + nt * 8) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------
// bf16 gather kernel: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------

constexpr int kGBM = 128;        // output rows per CTA (2 warpgroups x 64)
constexpr int kGBK = 64;         // depth per stage: one TMA box, one block
constexpr int kGStages = 3;      // stages in the ring
constexpr int kGThreads = 256;   // two consumer warpgroups
constexpr int kGBox = 64 * 128;  // bytes of one B box: 64 rows x 64 bf16

// Byte offsets into the (1024-aligned) dynamic shared memory.
template <int BN>
struct GatherSmem {
  static constexpr int kA = kGBM * 128;                  // 128 rows x 64 bf16
  static constexpr int kStage = kA + (BN / 64) * kGBox;  // A, then 64 x BN of B
  static constexpr int kBars = kGStages * kStage;        // full, empty
  static constexpr int kBytes = kBars + 8 * 2 * kGStages + 1024;
};

// One CTA per 128 x BN output tile inside one block column, the block
// columns fastest on the grid, so that the CTAs in flight share rows of A
// (each column reads its live blocks' slices of the same A rows) and B's
// live blocks stay in L2 across the rows. The column's list is walked as
// before (DepthSteps<true>), 64 deep a stage; thread 0 keeps the ring full:
// a stage is A[m0 .. m0 + 128, k .. k + 64) (one K-major box, rows past M
// read as zeros) and B[k .. k + 64, n0 .. n0 + BN) (BN / 64 boxes, read as
// the MN-major B), both by TMA onto the stage's full barrier. Each
// warpgroup runs m64nBNk16 SS wgmma on its 64 rows of the stage and keeps
// one step's products in flight: the stage before is handed back (its
// empty barrier) once they retire. Nothing drains between two listed
// blocks; an empty column runs no step and writes exact zeros.
template <int BN>
__global__ void __launch_bounds__(kGThreads, 2)
spmm_gather_bf16(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 __nv_bfloat16* __restrict__ c, const int* __restrict__ kidx,
                 const int* __restrict__ kcnt, int M, int K, int N, int bs,
                 int max_nnz) {
  using L = GatherSmem<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kGStages;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kGBM;
  const int j = n0 / bs;  // this tile's block column
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator row in the warp's 16 (and + 8)
  const int t = lane % 4;  // accumulator column pair

  // Every thread counts the column's steps; thread 0 walks them.
  DepthSteps<true> steps;
  steps.blocks.init(kidx, kcnt, nullptr, j, max_nnz, K / bs, N / bs);
  steps.sub = 0;
  steps.per_block = bs / kGBK;
  steps.bs = bs;
  steps.step = kGBK;
  const int n_steps = steps.blocks.count * steps.per_block;

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
// f32: FMA path
// ---------------------------------------------------------------------

constexpr int kFM = 64;  // output rows per CTA
constexpr int kFN = 64;  // output columns per CTA
constexpr int kFK = 16;  // depth per step

template <bool GATHER>
__global__ void __launch_bounds__(kThreads)
spmm_f32(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, const int* __restrict__ kidx,
         const int* __restrict__ kcnt, const int* __restrict__ mask, int M,
         int K, int N, int bs, int max_nnz) {
  __shared__ __align__(16) float sA[kFK][kFM + 4];  // transposed: [k][m]
  __shared__ __align__(16) float sB[kFK][kFN];

  const int m0 = blockIdx.x * kFM;
  const size_t n0 = (size_t)blockIdx.y * kFN;
  const int j = (int)(n0 / bs);
  const int tx = threadIdx.x % 16;  // 4 columns each
  const int ty = threadIdx.x / 16;  // 4 rows each

  DepthSteps<GATHER> st;
  st.blocks.init(kidx, kcnt, mask, j, max_nnz, K / bs, N / bs);
  st.sub = 0;
  st.per_block = bs / kFK;
  st.bs = bs;
  st.step = kFK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  // Each thread brings one float4 of A (row ar, depth ak .. ak + 3) and
  // one of B (depth br, columns bc .. bc + 3) per step.
  const int ar = threadIdx.x / 4;
  const int ak = (threadIdx.x % 4) * 4;
  const int br = threadIdx.x / 16;
  const int bc = (threadIdx.x % 16) * 4;

  for (; st.live(); st.advance()) {
    const size_t k = st.k();
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + ar < M)
      av = *reinterpret_cast<const float4*>(a + (size_t)(m0 + ar) * K + k +
                                            ak);
    float4 bv =
        *reinterpret_cast<const float4*>(b + (k + br) * (size_t)N + n0 + bc);
    __syncthreads();  // the previous step is fully consumed
    sA[ak + 0][ar] = av.x;
    sA[ak + 1][ar] = av.y;
    sA[ak + 2][ar] = av.z;
    sA[ak + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&sB[br][bc]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float4 x = *reinterpret_cast<const float4*>(&sA[kk][ty * 4]);
      float4 y = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(xs[i], ys[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = m0 + ty * 4 + i;
    if (row >= M) continue;
    *reinterpret_cast<float4*>(c + (size_t)row * N + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------

template <int BN, bool GATHER>
cudaError_t run_bf16(const void* a, const void* b, void* c, const int* kidx,
                     const int* kcnt, const int* mask, int M, int K, int N,
                     int bs, int max_nnz, cudaStream_t stream) {
  auto kernel = spmm_bf16<BN, GATHER>;
  size_t smem = Bf16Tiles<BN>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kBM - 1) / kBM, N / BN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
      kidx, kcnt, mask, M, K, N, bs, max_nnz);
  return cudaGetLastError();
}

template <int BN>
cudaError_t run_gather_bf16(const void* a, const void* b, void* c,
                            const int* kidx, const int* kcnt, int M, int K,
                            int N, int bs, int max_nnz, cudaStream_t stream) {
  if ((M + kGBM - 1) / kGBM > 65535) return cudaErrorInvalidValue;  // gridDim.y
  CUtensorMap ta, tb;
  cudaError_t err;
  if ((err = sm90::tmap_2d(&ta, a, M, K, kGBM)) != cudaSuccess ||
      (err = sm90::tmap_2d(&tb, b, K, N, kGBK)) != cudaSuccess)
    return err;
  auto kernel = spmm_gather_bf16<BN>;
  const int smem = GatherSmem<BN>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + kGBM - 1) / kGBM);
  kernel<<<grid, kGThreads, smem, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), kidx, kcnt, M, K, N, bs,
      max_nnz);
  return cudaGetLastError();
}

template <bool GATHER>
cudaError_t run_f32(const void* a, const void* b, void* c, const int* kidx,
                    const int* kcnt, const int* mask, int M, int K, int N,
                    int bs, int max_nnz, cudaStream_t stream) {
  dim3 grid((M + kFM - 1) / kFM, N / kFN);
  spmm_f32<GATHER><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), kidx, kcnt, mask, M, K, N, bs, max_nnz);
  return cudaGetLastError();
}

template <bool GATHER>
cudaError_t run(int dtype, const void* a, const void* b, void* c,
                const int* kidx, const int* kcnt, const int* mask, int M,
                int K, int N, int bs, int max_nnz, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || bs < 64 || bs % 64 || K % bs || N % bs)
    return cudaErrorInvalidValue;
  if (N / 64 > 65535) return cudaErrorInvalidValue;  // gridDim.y
  if (dtype == 0) {
    if constexpr (GATHER) {
      if (bs % 128 == 0)
        return run_gather_bf16<128>(a, b, c, kidx, kcnt, M, K, N, bs, max_nnz,
                                    stream);
      return run_gather_bf16<64>(a, b, c, kidx, kcnt, M, K, N, bs, max_nnz,
                                 stream);
    } else {
      if (bs % 128 == 0)
        return run_bf16<128, false>(a, b, c, kidx, kcnt, mask, M, K, N, bs,
                                    max_nnz, stream);
      return run_bf16<64, false>(a, b, c, kidx, kcnt, mask, M, K, N, bs,
                                 max_nnz, stream);
    }
  }
  if (dtype == 1)
    return run_f32<GATHER>(a, b, c, kidx, kcnt, mask, M, K, N, bs, max_nnz,
                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes (marlin_tpu_torch/ops/block_sparse.py).
// dtype: 0 = bf16, 1 = f32. Each returns the cudaError_t of its launch
// (0 = ok); a shape or dtype the kernels do not take returns
// cudaErrorInvalidValue. Launched on `stream`; nothing is allocated and
// nothing synchronises.

// The gather kernel: kidx (N / bs, max_nnz) and kcnt (N / bs), on the
// device.
extern "C" int marlin_block_sparse_spmm_gather(int dtype, const void* a,
                                               const void* b, void* c,
                                               const void* kidx,
                                               const void* kcnt, int M, int K,
                                               int N, int bs, int max_nnz,
                                               void* stream) {
  if (max_nnz < 1) return (int)cudaErrorInvalidValue;
  return (int)run<true>(dtype, a, b, c, static_cast<const int*>(kidx),
                        static_cast<const int*>(kcnt), nullptr, M, K, N, bs,
                        max_nnz, static_cast<cudaStream_t>(stream));
}

// The masked-grid kernel: mask (K / bs, N / bs) int32, on the device.
extern "C" int marlin_block_sparse_spmm_masked(int dtype, const void* a,
                                               const void* b, void* c,
                                               const void* mask, int M, int K,
                                               int N, int bs, void* stream) {
  return (int)run<false>(dtype, a, b, c, nullptr, nullptr,
                         static_cast<const int*>(mask), M, K, N, bs, 0,
                         static_cast<cudaStream_t>(stream));
}
