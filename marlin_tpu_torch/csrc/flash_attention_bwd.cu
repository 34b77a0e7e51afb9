// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces two Pallas TPU kernels launched by _flash_bwd_pallas through
// pl.pallas_call:
//
//   marlin_tpu/ops/flash_attention.py::_bwd_dq_kernel   (dQ)
//   marlin_tpu/ops/flash_attention.py::_bwd_dkv_kernel  (dK, dV)
//
// Both recompute the probability tiles from the forward's saved lse
// (_bwd_p_ds) instead of reading an (Sq, Skv) matrix, which exists in
// neither direction:
//
//   s  = q_hat k^T                    (q_hat: Q prescaled by scale*log2(e)
//                                      and rounded to Q's dtype, exactly the
//                                      tensor the forward kernel saw)
//   p  = exp2(s - lse)                (0 where masked)
//   dS = p * (dO v^T - Delta)         (Delta = rowsum(dO * O), computed by
//                                      the caller, as XLA did for the TPU)
//   dQ = scale * dS K
//   dK = ln2 * dS^T q_hat             (the base-2 softmax Jacobian)
//   dV = p^T dO
//
// GQA/MQA by index: query head h reads K/V head h / (H / Hk); the dK/dV
// kernel sums each KV head's gradient over the query heads of its group
// inside one CTA, so no atomics are used and the result is deterministic.
//
// Masks and ragged edges, as in the forward (csrc/flash_attention_fwd.cu):
// keys at or past Skv, causal k <= q, a window k > q - window; query rows
// at or past Sq contribute nothing. Out-of-range rows of every tile are
// zero-filled on load (TMA's out-of-bounds fill), so 0 * NaN never enters
// a product, and p is set to exactly 0 for a dead (q, k) pair. Tiles
// wholly outside the causal or window band are never visited: the dQ
// kernel's key sweep is the forward's; the dK/dV kernel's query sweep
// starts at the key tile's first causal row and ends at
// min(band end, number of query tiles) (the TPU kernel's i < q_blocks
// kill: a clamped duplicate of the last query tile would re-accumulate).
//
// Layout: Q_hat and dQ (B, Sq, H, D), dO (B, Sq, H, DV), K and dK
// (B, Skv, Hk, D), V and dV (B, Skv, Hk, DV), all contiguous; lse and Delta
// (B, H, Sq) f32.
//
// Bound on the H100. At the flagship training shape (B = 8, S = 2048,
// H = 8, Hk = 2, D = 128, bf16, causal) the dQ kernel runs 3 products per
// live (q, k) pair (S, dP, dQ) and the dK/dV kernel 4 (S, dP, dV, dK):
// ~103 and ~138 GFLOP against ~119 and ~102 MB of traffic, 870 and 1350
// FLOP per byte, far above the card's ~295 FLOP/byte ridge, so both are
// bound by the tensor-core rate (0.104 and 0.139 ms at 989 TFLOP/s).
//
// Both bf16 kernels are built for wgmma fed by TMA through an mbarrier
// ring (shared pieces in sm90.cuh), with per-element masks only on tiles
// that straddle the diagonal, the window's edge, Skv or Sq.
//
// The dQ kernel mirrors dK/dV with the roles of queries and keys swapped:
// q_hat and dO of its 64 query rows stay in shared memory, the K and V
// tiles of its key sweep come through a 2-stage TMA ring, S and dP are SS
// wgmma, and dS, rounded to bf16 from its accumulator, is the register A
// operand of the RS wgmma that adds dS K into dQ, the K stage that S read
// as the K-major B read again as the MN-major B. One consumer warpgroup a
// CTA: 64 f32 accumulator registers for dQ (D = 128) beside 32 + 32 for S
// and dP, so two CTAs share an SM. It stays a kernel of its own, with no
// atomic accumulation of dQ inside the dK/dV kernel (FA2/FA3's way), so the
// backward stays bitwise repeatable.
//
// The dK/dV kernel: K and V of its 64 keys stay in shared memory, the
// q_hat and dO tiles of its sweep come through a 2-stage TMA ring with
// full/empty mbarriers, S^T and dP^T are SS wgmma, and P^T and dS^T,
// rounded to bf16 from their
// accumulators, are the register A operands of the RS wgmma that add
// P^T dO and dS^T q_hat into dV and dK (dO and q_hat as MN-major B: no
// gather of B fragments). One consumer warpgroup a CTA: 64 + 64 f32
// accumulator registers for dK and dV beside 32 + 32 for S^T and dP^T, so
// two CTAs share an SM and overlap each other's loads and softmax.
//
// At D = Dv = 256 (head dims in (128, 256], which the wrapper zero-pads to
// 256 as the reference pads to its 128-lane tile) both kernels keep their
// 64 x 64 tiles and 2-stage rings (192 KB of shared memory: one CTA an
// SM). dQ's 64 x 256 accumulator takes 128 registers a thread and its
// dS K product is two n128 wgmma. dK and dV together would take 256, so
// two CTAs share each key tile (grid z), each owning 128 of dK's and dV's
// columns and recomputing the whole S^T and dP^T: twice those two
// products, the same fixed order of sums, still no atomics.
//
// The f32 path is a plain FMA kernel per direction (4 threads per row,
// f32 products in f32, no TF32), so it matches a full-f32 reference to
// summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kLn2 = 0.693147180559945309f;  // 1 / log2(e)

__device__ __forceinline__ bool key_live(int q_pos, int k_pos, int skv,
                                         int causal, int window) {
  if (k_pos >= skv) return false;
  if (causal && k_pos > q_pos) return false;
  if (window && k_pos <= q_pos - window) return false;
  return true;
}

// Key rows [lo, hi) a query tile [m0, m0 + bm) has to visit (the forward's
// sweep): causal stops after the tile's last row, a window starts at the
// band's first key tile.
__device__ __forceinline__ void key_range(int m0, int bm, int bn, int skv,
                                          int causal, int window, int* lo,
                                          int* hi) {
  int h = skv;
  if (causal && m0 + bm < h) h = m0 + bm;
  int l = 0;
  if (window) {
    l = m0 - window + 1;
    l = l < 0 ? 0 : (l / bn) * bn;
  }
  *lo = l;
  *hi = h;
}

// Query rows [lo, hi) a key tile [n0, n0 + bn) has to visit: causal starts
// at the query tile holding row n0; a window ends at the tile holding the
// last row that still sees a key of this tile, never past the last query
// tile.
__device__ __forceinline__ void query_range(int n0, int bn, int bm, int sq,
                                            int causal, int window, int* lo,
                                            int* hi) {
  int n_q = (sq + bm - 1) / bm;
  int first = causal ? n0 / bm : 0;
  int last = n_q;  // exclusive, in tiles
  if (window) {
    int band_end = (n0 + bn - 1 + window - 1) / bm + 1;
    if (band_end < last) last = band_end;
  }
  *lo = first * bm;
  *hi = last * bm;
}

// ---------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------

// B4, bf16.
constexpr int kDqBM = 64;       // query rows per CTA (one consumer warpgroup)
constexpr int kDqBN = 64;       // keys per K/V stage
constexpr int kDqStages = 2;    // K/V tiles in the ring
constexpr int kDqThreads = 128;
constexpr int kDqBox = 64 * 128;  // bytes of one TMA box: 64 rows x 64 bf16

// Byte offsets into the (1024-aligned) dynamic shared memory.
template <int D, int DV>
struct DqSmem {
  static constexpr int kQ = (D / 64) * kDqBox;   // the CTA's q_hat tile
  static constexpr int kO = (DV / 64) * kDqBox;  // and its dO tile
  static constexpr int kK = (D / 64) * kDqBox;   // one stage's K
  static constexpr int kStage = kK + (DV / 64) * kDqBox;  // K then V
  static constexpr int kBars = kQ + kO + kDqStages * kStage;  // full, empty, q
  static constexpr int kBytes = kBars + 8 * (2 * kDqStages + 1) + 1024;
};

// dS = P (dP - Delta), P = exp2(S - lse), in place of dP, for the thread's
// query rows qp0, qp0 + 8 and the keys of the tile starting at n0. MASK: a
// dead pair (query past Sq, key past Skv, causal or window) gets P = dS = 0
// exactly; a tile with no dead pair takes MASK = false and no mask
// arithmetic.
template <bool MASK>
__device__ __forceinline__ void dq_ds(const float (&s)[32], float (&dp)[32],
                                      const float (&lrow)[2],
                                      const float (&drow)[2], int n0,
                                      int qp0, int t, int Sq, int Skv,
                                      int causal, int window) {
#pragma unroll
  for (int nt = 0; nt < kDqBN / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = nt * 4 + i;
      const int r = i >> 1;
      float p = exp2f(s[e] - lrow[r]);
      if (MASK) {
        const int qp = qp0 + 8 * r;
        const int kp = n0 + nt * 8 + 2 * t + (i & 1);
        if (!(qp < Sq && key_live(qp, kp, Skv, causal, window))) p = 0.f;
      }
      dp[e] = p * (dp[e] - drow[r]);
    }
  }
}

// One CTA per (b, h, 64 query rows), the query tiles on grid y, causal
// tiles launched heaviest first. q_hat and dO come in once by TMA and
// stay; the tile's live 64-key tiles of K and V come through a 2-stage TMA
// ring (full/empty mbarriers; thread 0 refills a stage before the current
// tile's math); lse and Delta of the thread's two rows sit in registers.
// Per key tile:
//   S = q_hat K^T, dP = dO V^T     SS wgmma, K-major B
//   dS in registers                under the same masks as the forward
//   dQ += dS K                     RS wgmma, the same K stage read as the
//                                  MN-major B
// dQ is the CTA's own (no atomics), so two runs agree bit for bit.
template <int D, int DV>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int Hk, int Sq,
                  int Skv, int causal, int window, float scale) {
  using L = DqSmem<D, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;

  // Causal: the last query tiles see the most keys; launch them first.
  const int mt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int m0 = mt * kDqBM;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator row in the warp's 16 (and + 8)
  const int t = lane % 4;  // accumulator column pair

  int lo, hi;
  key_range(m0, kDqBM, kDqBN, Skv, causal, window, &lo, &hi);
  const int n_tiles = hi > lo ? (hi - lo + kDqBN - 1) / kDqBN : 0;

  if (tid == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kDqThreads);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // K/V tile j into stage j % kDqStages (thread 0 only).
  auto load_kv = [&](int j) {
    const int s = j % kDqStages;
    unsigned char* dst = smem + L::kQ + L::kO + s * L::kStage;
    sm90::mbar_arrive_expect_tx(&full[s], L::kStage);
    for (int c = 0; c < D / 64; ++c)
      sm90::tma_load_4d(dst + c * kDqBox, &tk, &full[s], c * 64, hk,
                        lo + j * kDqBN, b);
    for (int c = 0; c < DV / 64; ++c)
      sm90::tma_load_4d(dst + L::kK + c * kDqBox, &tv, &full[s], c * 64, hk,
                        lo + j * kDqBN, b);
  };
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(qbar, L::kQ + L::kO);
    for (int c = 0; c < D / 64; ++c)
      sm90::tma_load_4d(smem + c * kDqBox, &tq, qbar, c * 64, h, m0, b);
    for (int c = 0; c < DV / 64; ++c)
      sm90::tma_load_4d(smem + L::kQ + c * kDqBox, &tdo, qbar, c * 64, h, m0,
                        b);
    for (int j = 0; j < kDqStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  // lse and Delta of the thread's rows qp0 and qp0 + 8: plain loads (a row
  // of a ragged Sq starts at any 4-byte offset), 0 past Sq.
  const int qp0 = m0 + warp * 16 + g;
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    lrow[r] = qp < Sq ? lse[(long long)bh * Sq + qp] : 0.f;
    drow[r] = qp < Sq ? delta[(long long)bh * Sq + qp] : 0.f;
  }

  const uint32_t q_base = sm90::smem_u32(smem);
  const uint32_t o_base = q_base + L::kQ;
  float dqa[D / 2];  // dQ, the 64 x D accumulator
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  sm90::mbar_wait(qbar, 0);  // even with no key tile: no TMA left in flight
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kDqStages;
    const int next = j + kDqStages - 1;  // the tile that refills a stage now
    if (tid == 0 && next >= kDqStages && next < n_tiles) {
      sm90::mbar_wait(&empty[next % kDqStages], (next / kDqStages - 1) & 1);
      load_kv(next);
    }
    sm90::mbar_wait(&full[s], (j / kDqStages) & 1);
    __syncwarp();
    const uint32_t k_base =
        sm90::smem_u32(smem + L::kQ + L::kO + s * L::kStage);
    const uint32_t v_base = k_base + L::kK;

    // S = q_hat K^T and dP = dO V^T: 64 queries x 64 keys each.
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t off = (kc / 4) * kDqBox + (kc % 4) * 32;
      sm90::wgmma_ss<0>(sc, sm90::desc_sw128(q_base + off, 16, 1024),
                        sm90::desc_sw128(k_base + off, 16, 1024), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < DV / 16; ++kc) {
      const uint32_t off = (kc / 4) * kDqBox + (kc % 4) * 32;
      sm90::wgmma_ss<0>(dp, sm90::desc_sw128(o_base + off, 16, 1024),
                        sm90::desc_sw128(v_base + off, 16, 1024), kc > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // Per-element masks only where the tile straddles an edge.
    const int n0 = lo + j * kDqBN;
    const bool edge = m0 + kDqBM > Sq || n0 + kDqBN > Skv ||
                      (causal && n0 + kDqBN - 1 > m0) ||
                      (window && n0 <= m0 + kDqBM - 1 - window);
    if (edge)
      dq_ds<true>(sc, dp, lrow, drow, n0, qp0, t, Sq, Skv, causal, window);
    else
      dq_ds<false>(sc, dp, lrow, drow, n0, qp0, t, Sq, Skv, causal, window);

    // dQ += dS K: dS from registers, K the MN-major B (k16 step = 16 keys
    // = 2048 bytes in; LBO = the box stride, the next 64 columns of D); at
    // D = 256 two n128 products, the second on K's boxes 2 and 3.
    uint32_t da[kDqBN / 16][4];
#pragma unroll
    for (int kc = 0; kc < kDqBN / 16; ++kc) sm90::acc_to_a(dp, kc, da[kc]);
    sm90::fence_regs(dqa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kDqBN / 16; ++kc)
      sm90::wgmma_rs_mn<1>(dqa, da[kc], k_base + kc * 16 * 128,
                           k_base + 2 * kDqBox + kc * 16 * 128, kDqBox);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dqa);
    sm90::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dqg = dq + (long long)b * Sq * H * D + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* row = dqg + (long long)qp * H * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(row + nd * 8) =
          __floats2bfloat162_rn(dqa[nd * 4 + 2 * r] * scale,
                                dqa[nd * 4 + 2 * r + 1] * scale);
  }
}

// B5, bf16: wgmma fed by TMA through an mbarrier ring.
constexpr int kDkvBN = 64;      // keys per CTA (one consumer warpgroup)
constexpr int kDkvBM = 64;      // query rows per stage
constexpr int kDkvStages = 2;   // q_hat / dO tiles in the ring
constexpr int kDkvThreads = 128;
constexpr int kDkvBox = 64 * 128;  // bytes of one TMA box: 64 rows x 64 bf16

// CTAs that share a key tile, each owning D / n of dK's and Dv / n of dV's
// columns: 1 up to D, Dv = 128; 2 at 256, where two 64 x 256 f32
// accumulators (256 registers a thread) cannot fit one warpgroup. Each of
// the two recomputes the whole S^T and dP^T (over all of D and Dv) and
// adds P^T dO and dS^T q_hat into its 128 columns only.
template <int D, int DV>
__host__ __device__ constexpr int dkv_split() {
  return D > 128 || DV > 128 ? 2 : 1;
}

// Byte offsets into the (1024-aligned) dynamic shared memory.
template <int D, int DV>
struct DkvSmem {
  static constexpr int kK = (D / 64) * kDkvBox;  // the CTA's K tile
  static constexpr int kV = (DV / 64) * kDkvBox;  // and its V tile
  static constexpr int kQ = (D / 64) * kDkvBox;  // one stage's q_hat
  static constexpr int kStage = kQ + (DV / 64) * kDkvBox;  // q_hat then dO
  static constexpr int kStats = kK + kV + kDkvStages * kStage;  // lse, Delta
  static constexpr int kBars = kStats + kDkvStages * 2 * kDkvBM * 4;
  static constexpr int kBytes = kBars + 8 * (2 * kDkvStages + 1) + 1024;
};

// P^T = exp2(S^T - lse) and dS^T = P^T (dP^T - Delta) in place of S^T and
// dP^T, for the thread's key rows kp0, kp0 + 8 and query columns of the
// tile starting at m0. MASK: a dead pair (query past Sq, key past Skv,
// causal or window) gets P^T = dS^T = 0 exactly; a tile with no dead pair
// takes MASK = false and no mask arithmetic.
template <bool MASK>
__device__ __forceinline__ void dkv_p_ds(float (&st)[32], float (&dpt)[32],
                                         const float* sL, const float* sD,
                                         int m0, int kp0, int t, int Sq,
                                         int Skv, int causal, int window) {
#pragma unroll
  for (int nt = 0; nt < kDkvBM / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qc = nt * 8 + 2 * t + (i & 1);
      const int e = nt * 4 + i;
      float p = exp2f(st[e] - sL[qc]);
      if (MASK) {
        const int qp = m0 + qc;
        const int kp = kp0 + 8 * (i >> 1);
        if (!(qp < Sq && key_live(qp, kp, Skv, causal, window))) p = 0.f;
      }
      dpt[e] = p * (dpt[e] - sD[qc]);
      st[e] = p;
    }
  }
}

// One CTA per (b, kv head, 64-key tile, column share of dkv_split), the
// key tiles on grid y so that key tile 0 of every head (the most query
// tiles under causal) launches first. K and V come in once by TMA and stay; the CTA sweeps its group's
// query heads and each head's live 64-row query tiles as one flat sequence
// of stages, each a q_hat and a dO tile by TMA plus the tile's lse and
// Delta (plain loads into shared memory, one ahead). Per stage:
//   S^T = K q_hat^T, dP^T = V dO^T     SS wgmma, K-major B
//   P^T, dS^T in registers             under the same masks as the forward
//   dV += P^T dO, dK += dS^T q_hat     RS wgmma, MN-major B
// The group's sum stays in the CTA's registers: no atomics, and two runs
// agree bit for bit.
template <int D, int DV>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Hk, int Sq,
                   int Skv, int causal, int window) {
  using L = DkvSmem<D, DV>;
  constexpr int DO = D / dkv_split<D, DV>();   // dK columns this CTA owns
  constexpr int DVO = DV / dkv_split<D, DV>();  // and dV columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kDkvStages;
  uint64_t* kvbar = empty + kDkvStages;

  const int n0 = blockIdx.y * kDkvBN;
  const int share = blockIdx.z;  // columns [share * DO, share * DO + DO)
  const int bhk = blockIdx.x;
  const int b = bhk / Hk;
  const int hk = bhk % Hk;
  const int group = H / Hk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  int lo, hi;
  query_range(n0, kDkvBN, kDkvBM, Sq, causal, window, &lo, &hi);
  const int n_qt = hi > lo ? (hi - lo) / kDkvBM : 0;  // per query head
  const int n_stages = group * n_qt;

  if (tid == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kDkvThreads);
    }
    sm90::mbar_init(kvbar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // Stage i: query head hk * group + i / n_qt, rows lo + (i % n_qt) * 64.
  auto stage_head = [&](int i) { return hk * group + i / n_qt; };
  auto stage_m0 = [&](int i) { return lo + (i % n_qt) * kDkvBM; };
  auto load_stage = [&](int i) {  // thread 0 only
    const int s = i % kDkvStages;
    unsigned char* dst = smem + L::kK + L::kV + s * L::kStage;
    sm90::mbar_arrive_expect_tx(&full[s], L::kStage);
    for (int c = 0; c < D / 64; ++c)
      sm90::tma_load_4d(dst + c * kDkvBox, &tq, &full[s], c * 64,
                        stage_head(i), stage_m0(i), b);
    for (int c = 0; c < DV / 64; ++c)
      sm90::tma_load_4d(dst + L::kQ + c * kDkvBox, &tdo, &full[s], c * 64,
                        stage_head(i), stage_m0(i), b);
  };
  // Thread tid's value of stage i's stats: lse for tid < 64, else Delta.
  auto load_stat = [&](int i) {
    const int qp = stage_m0(i) + tid % kDkvBM;
    const float* src = tid < kDkvBM ? lse : delta;
    return qp < Sq ? src[((long long)b * H + stage_head(i)) * Sq + qp] : 0.f;
  };
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(kvbar, L::kK + L::kV);
    for (int c = 0; c < D / 64; ++c)
      sm90::tma_load_4d(smem + c * kDkvBox, &tk, kvbar, c * 64, hk, n0, b);
    for (int c = 0; c < DV / 64; ++c)
      sm90::tma_load_4d(smem + L::kK + c * kDkvBox, &tv, kvbar, c * 64, hk,
                        n0, b);
    for (int i = 0; i < kDkvStages && i < n_stages; ++i) load_stage(i);
  }
  __syncwarp();
  if (n_stages > 0) stats[tid] = load_stat(0);
  __syncthreads();

  const int kp0 = n0 + warp * 16 + g;  // the thread's key rows kp0, kp0 + 8
  const int kp1 = kp0 + 8;
  const uint32_t k_base = sm90::smem_u32(smem);
  const uint32_t v_base = k_base + L::kK;
  // Offsets of this CTA's columns within a stage's q_hat and dO tiles.
  const uint32_t q_share = share * (DO / 64) * kDkvBox;
  const uint32_t o_share = share * (DVO / 64) * kDkvBox;
  float dka[DO / 2], dva[DVO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVO / 2; ++i) dva[i] = 0.f;

  sm90::mbar_wait(kvbar, 0);
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % kDkvStages;
    const int next = i + kDkvStages - 1;  // the stage loaded now
    if (tid == 0 && next >= kDkvStages && next < n_stages) {
      sm90::mbar_wait(&empty[next % kDkvStages],
                      (next / kDkvStages - 1) & 1);
      load_stage(next);
    }
    const bool more = i + 1 < n_stages;
    const float stat_next = more ? load_stat(i + 1) : 0.f;
    const int m0 = stage_m0(i);
    sm90::mbar_wait(&full[s], (i / kDkvStages) & 1);
    __syncwarp();
    const uint32_t q_base =
        sm90::smem_u32(smem + L::kK + L::kV + s * L::kStage);
    const uint32_t o_base = q_base + L::kQ;

    // S^T = K q_hat^T and dP^T = V dO^T: 64 keys x 64 queries each.
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t off = (kc / 4) * kDkvBox + (kc % 4) * 32;
      sm90::wgmma_ss<0>(st, sm90::desc_sw128(k_base + off, 16, 1024),
                        sm90::desc_sw128(q_base + off, 16, 1024), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < DV / 16; ++kc) {
      const uint32_t off = (kc / 4) * kDkvBox + (kc % 4) * 32;
      sm90::wgmma_ss<0>(dpt, sm90::desc_sw128(v_base + off, 16, 1024),
                        sm90::desc_sw128(o_base + off, 16, 1024), kc > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    const float* sL = stats + s * 2 * kDkvBM;
    const float* sD = sL + kDkvBM;
    const bool edge = m0 + kDkvBM > Sq || n0 + kDkvBN > Skv ||
                      (causal && n0 + kDkvBN - 1 > m0) ||
                      (window && n0 <= m0 + kDkvBM - 1 - window);
    if (edge)
      dkv_p_ds<true>(st, dpt, sL, sD, m0, kp0, t, Sq, Skv, causal, window);
    else
      dkv_p_ds<false>(st, dpt, sL, sD, m0, kp0, t, Sq, Skv, causal, window);

    // dV += P^T dO and dK += dS^T q_hat over this CTA's columns: 64 / 16
    // k16 steps over the queries.
    uint32_t pa[kDkvBM / 16][4], da[kDkvBM / 16][4];
#pragma unroll
    for (int kc = 0; kc < kDkvBM / 16; ++kc) {
      sm90::acc_to_a(st, kc, pa[kc]);
      sm90::acc_to_a(dpt, kc, da[kc]);
    }
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kDkvBM / 16; ++kc)
      sm90::wgmma_rs<1>(dva, pa[kc],
                        sm90::desc_sw128(o_base + o_share + kc * 16 * 128,
                                         kDkvBox, 1024),
                        1);
#pragma unroll
    for (int kc = 0; kc < kDkvBM / 16; ++kc)
      sm90::wgmma_rs<1>(dka, da[kc],
                        sm90::desc_sw128(q_base + q_share + kc * 16 * 128,
                                         kDkvBox, 1024),
                        1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::mbar_arrive(&empty[s]);
    if (more) stats[((i + 1) % kDkvStages) * 2 * kDkvBM + tid] = stat_next;
    __syncthreads();  // the next stage's stats are in; this stage's read
  }

  __nv_bfloat16* dkg =
      dk + (long long)b * Skv * Hk * D + hk * D + share * DO;
  __nv_bfloat16* dvg =
      dv + (long long)b * Skv * Hk * DV + hk * DV + share * DVO;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = r ? kp1 : kp0;
    if (kp >= Skv) continue;
    __nv_bfloat16* krow = dkg + (long long)kp * Hk * D + 2 * t;
    __nv_bfloat16* vrow = dvg + (long long)kp * Hk * DV + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DO / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(krow + nd * 8) =
          __floats2bfloat162_rn(dka[nd * 4 + 2 * r] * kLn2,
                                dka[nd * 4 + 2 * r + 1] * kLn2);
#pragma unroll
    for (int nv = 0; nv < DVO / 8; ++nv)
      *reinterpret_cast<__nv_bfloat162*>(vrow + nv * 8) =
          __floats2bfloat162_rn(dva[nv * 4 + 2 * r], dva[nv * 4 + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------
// f32: FMA path
// ---------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kFM = 32;  // query rows per tile
constexpr int kFN = 32;  // key rows per tile

// Rows [r0, r0 + rows) of a (.., stride) f32 matrix into a shared tile with
// row stride WIDTH + 1; rows at or past `valid` are zero-filled.
template <int WIDTH>
__device__ __forceinline__ void load_tile_f32(float* smem, const float* g,
                                              long long gstride, int rows,
                                              int valid) {
  for (int i = threadIdx.x; i < rows * WIDTH; i += kThreads) {
    int r = i / WIDTH, c = i % WIDTH;
    smem[r * (WIDTH + 1) + c] = r < valid ? g[r * gstride + c] : 0.f;
  }
}

// B4, f32: 4 threads per query row; each computes dS for a quarter of the
// tile's keys, then accumulates a quarter of dQ's columns.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int H, int Hk, int Sq, int Skv, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kFM][D + 1]
  float* sdO = sQ + kFM * (D + 1);                 // [kFM][DV + 1]
  float* sK = sdO + kFM * (DV + 1);                // [kFN][D + 1]
  float* sV = sK + kFN * (D + 1);                  // [kFN][DV + 1]
  float* sS = sV + kFN * (DV + 1);                 // [kFM][kFN + 1]

  const int m0 = blockIdx.x * kFM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int r = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const int qp = m0 + r;

  const long long q_row = (long long)H * D;
  const long long o_row = (long long)H * DV;
  const long long k_row = (long long)Hk * D;
  const long long v_row = (long long)Hk * DV;
  const float* kg = k + (long long)b * Skv * k_row + hk * D;
  const float* vg = v + (long long)b * Skv * v_row + hk * DV;

  load_tile_f32<D>(sQ, q + ((long long)b * Sq + m0) * q_row + h * D, q_row,
                   kFM, Sq - m0);
  load_tile_f32<DV>(sdO, dout + ((long long)b * Sq + m0) * o_row + h * DV,
                    o_row, kFM, Sq - m0);
  const float lrow = qp < Sq ? lse[(long long)bh * Sq + qp] : 0.f;
  const float drow = qp < Sq ? delta[(long long)bh * Sq + qp] : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  int lo, hi;
  key_range(m0, kFM, kFN, Skv, causal, window, &lo, &hi);
  for (int n0 = lo; n0 < hi; n0 += kFN) {
    __syncthreads();
    load_tile_f32<D>(sK, kg + (long long)n0 * k_row, k_row, kFN, Skv - n0);
    load_tile_f32<DV>(sV, vg + (long long)n0 * v_row, v_row, kFN, Skv - n0);
    __syncthreads();

    const float* qr = sQ + r * (D + 1);
    const float* dr = sdO + r * (DV + 1);
#pragma unroll
    for (int jj = 0; jj < kFN / 4; ++jj) {
      int j = t + 4 * jj;
      const float* kr = sK + j * (D + 1);
      const float* vr = sV + j * (DV + 1);
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
#pragma unroll 8
      for (int d = 0; d < DV; ++d) dp = fmaf(dr[d], vr[d], dp);
      bool live = qp < Sq && key_live(qp, n0 + j, Skv, causal, window);
      float p = live ? exp2f(s - lrow) : 0.f;
      sS[r * (kFN + 1) + j] = p * (dp - drow);
    }
    __syncwarp();  // a row's four threads share one warp
    for (int j = 0; j < kFN; ++j) {
      float ds = sS[r * (kFN + 1) + j];
      const float* kr = sK + j * (D + 1) + t;
#pragma unroll
      for (int cc = 0; cc < D / 4; ++cc)
        acc[cc] = fmaf(ds, kr[4 * cc], acc[cc]);
    }
  }

  if (qp < Sq) {
    float* row = dq + ((long long)b * Sq + qp) * q_row + h * D + t;
#pragma unroll
    for (int cc = 0; cc < D / 4; ++cc) row[4 * cc] = acc[cc] * scale;
  }
}

// B5, f32: 4 threads per key row; each computes P^T and dS^T for a quarter
// of the query tile's rows, then accumulates a quarter of dK's and dV's
// columns.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int Hk, int Sq, int Skv,
                  int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [kFN][D + 1]
  float* sV = sK + kFN * (D + 1);                  // [kFN][DV + 1]
  float* sQ = sV + kFN * (DV + 1);                 // [kFM][D + 1]
  float* sdO = sQ + kFM * (D + 1);                 // [kFM][DV + 1]
  float* sP = sdO + kFM * (DV + 1);                // [kFN][kFM + 1]
  float* sS = sP + kFN * (kFM + 1);                // [kFN][kFM + 1]
  float* sL = sS + kFN * (kFM + 1);                // [kFM]
  float* sD = sL + kFM;                            // [kFM]

  const int n0 = blockIdx.x * kFN;
  const int bhk = blockIdx.y;
  const int b = bhk / Hk;
  const int hk = bhk % Hk;
  const int group = H / Hk;
  const int r = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const int kp = n0 + r;

  const long long q_row = (long long)H * D;
  const long long o_row = (long long)H * DV;
  const long long k_row = (long long)Hk * D;
  const long long v_row = (long long)Hk * DV;

  load_tile_f32<D>(sK, k + ((long long)b * Skv + n0) * k_row + hk * D, k_row,
                   kFN, Skv - n0);
  load_tile_f32<DV>(sV, v + ((long long)b * Skv + n0) * v_row + hk * DV,
                    v_row, kFN, Skv - n0);

  float dka[D / 4], dva[DV / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) dva[i] = 0.f;

  int lo, hi;
  query_range(n0, kFN, kFM, Sq, causal, window, &lo, &hi);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const float* qg = q + (long long)b * Sq * q_row + h * D;
    const float* dog = dout + (long long)b * Sq * o_row + h * DV;
    const float* lg = lse + ((long long)b * H + h) * Sq;
    const float* dg = delta + ((long long)b * H + h) * Sq;
    for (int m0 = lo; m0 < hi; m0 += kFM) {
      __syncthreads();
      load_tile_f32<D>(sQ, qg + (long long)m0 * q_row, q_row, kFM, Sq - m0);
      load_tile_f32<DV>(sdO, dog + (long long)m0 * o_row, o_row, kFM,
                        Sq - m0);
      for (int i = threadIdx.x; i < kFM; i += kThreads) {
        bool ok = m0 + i < Sq;
        sL[i] = ok ? lg[m0 + i] : 0.f;
        sD[i] = ok ? dg[m0 + i] : 0.f;
      }
      __syncthreads();

      const float* kr = sK + r * (D + 1);
      const float* vr = sV + r * (DV + 1);
#pragma unroll
      for (int ii = 0; ii < kFM / 4; ++ii) {
        int i = t + 4 * ii;
        int qp = m0 + i;
        const float* qr = sQ + i * (D + 1);
        const float* dr = sdO + i * (DV + 1);
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(kr[d], qr[d], s);
#pragma unroll 8
        for (int d = 0; d < DV; ++d) dp = fmaf(vr[d], dr[d], dp);
        bool live = qp < Sq && key_live(qp, kp, Skv, causal, window);
        float p = live ? exp2f(s - sL[i]) : 0.f;
        sP[r * (kFM + 1) + i] = p;
        sS[r * (kFM + 1) + i] = p * (dp - sD[i]);
      }
      __syncwarp();
      for (int i = 0; i < kFM; ++i) {
        float p = sP[r * (kFM + 1) + i];
        float ds = sS[r * (kFM + 1) + i];
        const float* dr = sdO + i * (DV + 1) + t;
        const float* qr = sQ + i * (D + 1) + t;
#pragma unroll
        for (int cc = 0; cc < DV / 4; ++cc)
          dva[cc] = fmaf(p, dr[4 * cc], dva[cc]);
#pragma unroll
        for (int cc = 0; cc < D / 4; ++cc)
          dka[cc] = fmaf(ds, qr[4 * cc], dka[cc]);
      }
    }
  }

  if (kp < Skv) {
    float* krow = dk + ((long long)b * Skv + kp) * k_row + hk * D + t;
    float* vrow = dv + ((long long)b * Skv + kp) * v_row + hk * DV + t;
#pragma unroll
    for (int cc = 0; cc < D / 4; ++cc) krow[4 * cc] = dka[cc] * kLn2;
#pragma unroll
    for (int cc = 0; cc < DV / 4; ++cc) vrow[4 * cc] = dva[cc];
  }
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, int DV>
cudaError_t run_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Hk, int Sq, int Skv,
                   int causal, int window, float scale, cudaStream_t st) {
  cudaError_t err;
  if (dtype == 0) {
    CUtensorMap tq, tk, tv, tdo;
    if ((err = sm90::tmap_bshd(&tq, q, B, Sq, H, D, kDqBM)) != cudaSuccess ||
        (err = sm90::tmap_bshd(&tk, k, B, Skv, Hk, D, kDqBN)) !=
            cudaSuccess ||
        (err = sm90::tmap_bshd(&tv, v, B, Skv, Hk, DV, kDqBN)) !=
            cudaSuccess ||
        (err = sm90::tmap_bshd(&tdo, dout, B, Sq, H, DV, kDqBM)) !=
            cudaSuccess)
      return err;
    const size_t smem = DqSmem<D, DV>::kBytes;
    auto kernel = flash_bwd_dq_bf16<D, DV>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(B * H, (Sq + kDqBM - 1) / kDqBM);
    kernel<<<grid, kDqThreads, smem, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), H, Hk,
        Sq, Skv, causal, window, scale);
  } else {
    size_t smem = sizeof(float) *
                  ((size_t)(kFM + kFN) * (D + 1) +
                   (size_t)(kFM + kFN) * (DV + 1) + (size_t)kFM * (kFN + 1));
    auto kernel = flash_bwd_dq_f32<D, DV>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((Sq + kFM - 1) / kFM, B * H);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), H, Hk, Sq, Skv, causal, window,
        scale);
  }
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t run_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int H, int Hk, int Sq,
                    int Skv, int causal, int window, cudaStream_t st) {
  cudaError_t err;
  if (dtype == 0) {
    CUtensorMap tq, tk, tv, tdo;
    if ((err = sm90::tmap_bshd(&tq, q, B, Sq, H, D, kDkvBM)) != cudaSuccess ||
        (err = sm90::tmap_bshd(&tk, k, B, Skv, Hk, D, kDkvBN)) !=
            cudaSuccess ||
        (err = sm90::tmap_bshd(&tv, v, B, Skv, Hk, DV, kDkvBN)) !=
            cudaSuccess ||
        (err = sm90::tmap_bshd(&tdo, dout, B, Sq, H, DV, kDkvBM)) !=
            cudaSuccess)
      return err;
    const size_t smem = DkvSmem<D, DV>::kBytes;
    auto kernel = flash_bwd_dkv_bf16<D, DV>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(B * Hk, (Skv + kDkvBN - 1) / kDkvBN, dkv_split<D, DV>());
    kernel<<<grid, kDkvThreads, smem, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), H, Hk, Sq, Skv, causal, window);
  } else {
    size_t smem = sizeof(float) *
                  ((size_t)(kFM + kFN) * (D + 1) +
                   (size_t)(kFM + kFN) * (DV + 1) +
                   2 * (size_t)kFN * (kFM + 1) + 2 * (size_t)kFM);
    auto kernel = flash_bwd_dkv_f32<D, DV>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((Skv + kFN - 1) / kFN, B * Hk);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Hk, Sq,
        Skv, causal, window);
  }
  return cudaGetLastError();
}

bool valid_shape(int dtype, int B, int H, int Hk, int Sq, int Skv) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Hk >= 1 &&
         H % Hk == 0 && Sq >= 1 && Skv >= 1;
}

}  // namespace

#define MARLIN_DISPATCH_DIMS(RUN, ...)                     \
  if (D == 64 && DV == 64) return (int)RUN<64, 64>(__VA_ARGS__);    \
  if (D == 64 && DV == 128) return (int)RUN<64, 128>(__VA_ARGS__);  \
  if (D == 128 && DV == 64) return (int)RUN<128, 64>(__VA_ARGS__);  \
  if (D == 128 && DV == 128) return (int)RUN<128, 128>(__VA_ARGS__);  \
  if (D == 256 && DV == 256) return (int)RUN<256, 256>(__VA_ARGS__);

// C entry points, bound with ctypes (marlin_tpu_torch/ops/flash_attention.py).
// dtype: 0 = bf16, 1 = f32. Each returns the cudaError_t of its launch
// (0 = ok); an unsupported (dtype, D, DV) returns cudaErrorInvalidValue.
// `q` is the prescaled q_hat the forward saw; `scale` is the softmax scale
// (dQ = scale * dS K).
extern "C" int marlin_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hk,
    int Sq, int Skv, int D, int DV, int causal, int window, float scale,
    void* stream) {
  if (!valid_shape(dtype, B, H, Hk, Sq, Skv))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MARLIN_DISPATCH_DIMS(run_dq, dtype, q, k, v, dout, l, dl, dq, B, H, Hk, Sq,
                       Skv, causal, window, scale, st)
  return (int)cudaErrorInvalidValue;
}

extern "C" int marlin_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Hk, int Sq, int Skv, int D, int DV, int causal, int window,
    void* stream) {
  if (!valid_shape(dtype, B, H, Hk, Sq, Skv))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MARLIN_DISPATCH_DIMS(run_dkv, dtype, q, k, v, dout, l, dl, dk, dv, B, H, Hk,
                       Sq, Skv, causal, window, st)
  return (int)cudaErrorInvalidValue;
}

#undef MARLIN_DISPATCH_DIMS
