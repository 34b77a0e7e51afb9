// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces marlin_tpu/ops/flash_attention.py::_kernel (the Pallas TPU
// kernel launched by _flash_hsd_impl through pl.pallas_call). Computes,
// for every (batch, head, query row):
//
//   O   = softmax(Q K^T * scale) V
//   lse = m + log2(l)              (log2-sum-exp, same domain as the TPU's)
//
// without writing any (Sq, Skv) tensor to device memory. The caller folds
// scale * log2(e) into Q (in >= f32, rounded back to Q's dtype) exactly as
// _flash_hsd_impl does, so the online softmax here runs in base 2 and the
// running max is a log2-domain quantity.
//
// Semantics kept from the TPU kernel:
//   * logits are masked to -1e30, never -inf (a row whose keys have not
//     arrived yet carries finite "p = 1" garbage that the first real key
//     cancels exactly: exp2(-1e30 - m_real) == 0);
//   * keys at or past Skv are masked; causal keeps k <= q; a window keeps
//     k > q - window as well; key tiles wholly outside the causal or window
//     band are never visited (the TPU's _block_live / shrunk window sweep);
//   * GQA/MQA by index: query head h reads K/V head h / (H / Hk); K/V are
//     never replicated;
//   * l is clamped at 1e-30 before the division and the log.
//
// Layout: Q (B, Sq, H, D), K (B, Skv, Hk, D), V (B, Skv, Hk, DV), O
// (B, Sq, H, DV), all contiguous; lse (B, H, Sq) f32.
//
// Bound on the H100. At the flagship prefill (S = 2048, H = 8, D = 128,
// bf16, causal) the work is ~8.6 GFLOP against ~10.5 MB of traffic, about
// 800 FLOP per byte, above the card's ~295 FLOP/byte ridge: the bound is
// the tensor-core rate (989 TFLOP/s bf16 dense), which only wgmma reaches.
// The bf16 kernel is built for it (shared pieces in sm90.cuh):
//   * one CTA per (b, h, 128 query rows): two consumer warpgroups of 64
//     rows each, causal query tiles launched heaviest first;
//   * Q comes in once by TMA; K and V in 128-key tiles through a 2-stage
//     ring of TMA loads, a "full" mbarrier per stage (transaction bytes) and
//     an "empty" one that every consumer thread arrives on once its
//     warpgroup's wgmma reads of the stage have retired; thread 0 refills
//     a stage with the tile after next before the current tile's math;
//   * S = q_hat K^T is an SS wgmma (K-major B: a row of K holds D); the
//     S accumulator is the base-2 online softmax's input in registers, and
//     P, rounded to bf16, is already the register A operand of the RS
//     wgmma O += P V (V as the MN-major B: no transpose pass);
//   * masks are applied per element only in tiles that straddle the
//     diagonal, the window's edge or Skv; fully live tiles take none. TMA
//     zero-fills rows past S, so a masked key never brings a NaN into P V.
// At D = Dv = 256 (head dims in (128, 256], zero-padded by the wrapper as
// the reference pads to its 128-lane tile) O's 64 x 256 f32 accumulator
// takes 128 registers a thread: the K/V tile shrinks to 64 keys (S: 32
// registers), Q (64 KB) and two 64 KB stages fill 192 KB of shared memory,
// and P V is two n128 wgmma, the second on V's columns 128..255.
// It does not use a producer warp, setmaxnreg or two tiles in flight per
// warpgroup (FA3's ping-pong); those are the next steps toward the bound.
//
// The f32 path (not on the serving path) is a plain FMA kernel: 4 threads
// per query row, f32 products in f32, so it matches a full-f32 reference
// to ~1e-6.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF

__device__ __forceinline__ bool key_live(int q_pos, int k_pos, int skv,
                                         int causal, int window) {
  if (k_pos >= skv) return false;
  if (causal && k_pos > q_pos) return false;
  if (window && k_pos <= q_pos - window) return false;
  return true;
}

// The k-tile range [lo, hi) a q-tile [m0, m0 + bm) has to visit: causal
// stops after the tile's last row, a window starts at the band's first
// tile (the TPU's _win_lo_k); everything else is masked per element.
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

// ---------------------------------------------------------------------
// bf16: wgmma path
// ---------------------------------------------------------------------

constexpr int kBM = 128;       // query rows per CTA (2 warpgroups x 64)
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kBN256 = 64;     // keys per K/V tile at D = Dv = 256
constexpr int kStages = 2;     // K/V tiles in the ring
constexpr int kConsumers = 2;  // warpgroups
constexpr int kWgThreads = 128 * kConsumers;
constexpr int kBox = 128 * 128;  // bytes of one TMA box: 128 rows x 64 bf16

// Keys per K/V tile: kBN up to D, Dv = 128; at 256 a 64 x 256 f32 O
// accumulator takes 128 registers a thread, so S shrinks to 64 keys (32
// registers) and the ring's stages to 64 keys (64 KB each, 192 KB with Q).
template <int D, int DV>
__host__ __device__ constexpr int fwd_bn() {
  return D > 128 || DV > 128 ? kBN256 : kBN;
}

// Byte offsets into the (1024-aligned) dynamic shared memory.
template <int D, int DV>
struct FwdSmem {
  static constexpr int kKvBox = fwd_bn<D, DV>() * 128;  // one K or V box
  static constexpr int kQ = (D / 64) * kBox;      // the CTA's Q tile
  static constexpr int kK = (D / 64) * kKvBox;    // one K tile
  static constexpr int kStage = kK + (DV / 64) * kKvBox;  // K then V
  static constexpr int kBars = kQ + kStages * kStage;   // full, empty, q
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int H, int Hk, int Sq, int Skv, int causal, int window) {
  using L = FwdSmem<D, DV>;
  constexpr int BN = fwd_bn<D, DV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // Causal: the last query tiles see the most keys; launch them first.
  const int mt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int m0 = mt * kBM;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;  // within the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row in the warp's 16 (and + 8)
  const int t = lane % 4;  // accumulator column pair

  int lo, hi;
  key_range(m0, kBM, BN, Skv, causal, window, &lo, &hi);
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWgThreads);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // K/V tile j into stage j % kStages (thread 0 only).
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    unsigned char* dst = smem + L::kQ + s * L::kStage;
    sm90::mbar_arrive_expect_tx(&full[s], L::kStage);
    for (int c = 0; c < D / 64; ++c)
      sm90::tma_load_4d(dst + c * L::kKvBox, &tk, &full[s], c * 64, hk,
                        lo + j * BN, b);
    for (int c = 0; c < DV / 64; ++c)
      sm90::tma_load_4d(dst + L::kK + c * L::kKvBox, &tv, &full[s], c * 64,
                        hk, lo + j * BN, b);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(qbar, L::kQ);
    for (int c = 0; c < D / 64; ++c)
      sm90::tma_load_4d(smem + c * kBox, &tq, qbar, c * 64, h, m0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  const int row0 = m0 + wg * 64;  // this warpgroup's first query row
  const int qp0 = row0 + warp * 16 + g;
  const int qp1 = qp0 + 8;
  // This warpgroup's 64 rows of each Q box.
  const uint32_t q_base = sm90::smem_u32(smem) + wg * 64 * 128;

  float mrow[2] = {kNegInf, kNegInf};
  float lrow[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[DV / 2];           // O, the 64 x DV accumulator
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;

  sm90::mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int next = j + kStages - 1;  // the tile that refills a stage now
    if (threadIdx.x == 0 && next >= kStages && next < n_tiles) {
      // Both warpgroups are done with tile next - kStages of that stage.
      sm90::mbar_wait(&empty[next % kStages], (next / kStages - 1) & 1);
      load_kv(next);
    }
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    __syncwarp();
    const uint32_t k_base = sm90::smem_u32(smem + L::kQ + s * L::kStage);
    const uint32_t v_base = k_base + L::kK;

    // S = q_hat K^T: 64 rows x BN keys, D / 16 k16 steps.
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;
      sm90::wgmma_ss<0>(
          sc, sm90::desc_sw128(q_base + (kc / 4) * kBox + off, 16, 1024),
          sm90::desc_sw128(k_base + (kc / 4) * L::kKvBox + off, 16, 1024),
          kc > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // Per-element masks only where the tile straddles an edge.
    const int n0 = lo + j * BN;
    const bool edge = n0 + BN > Skv || (causal && n0 + BN - 1 > row0) ||
                      (window && n0 <= row0 + 63 - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = n0 + nt * 8 + 2 * t + (i & 1);
          if (!key_live(i < 2 ? qp0 : qp1, kp, Skv, causal, window))
            sc[nt * 4 + i] = kNegInf;
        }
      }
    }

    // Online softmax in base 2 for the thread's rows g and g + 8.
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = exp2f(mrow[r] - mx[r]);
      mrow[r] = mx[r];
      lrow[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = exp2f(sc[i] - mrow[(i >> 1) & 1]);
      lrow[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P from registers, V the MN-major B, BN / 16 k16 steps; at
    // Dv = 256 two n128 products, the second on V's boxes 2 and 3.
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) sm90::acc_to_a(sc, kc, pa[kc]);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
      sm90::wgmma_rs_mn<1>(acc, pa[kc], v_base + kc * 16 * 128,
                           v_base + 2 * L::kKvBox + kc * 16 * 128,
                           L::kKvBox);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffff, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffff, lrow[r], 2);
    lrow[r] = fmaxf(lrow[r], 1e-30f);
  }
  const long long o_row = (long long)H * DV;
  __nv_bfloat16* og = o + (long long)b * Sq * o_row + h * DV;
  float* lg = lse + (long long)bh * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    if (qp >= Sq) continue;
    const float inv = 1.f / lrow[r];
    __nv_bfloat16* orow = og + qp * o_row + 2 * t;
#pragma unroll
    for (int nv = 0; nv < DV / 8; ++nv)
      *reinterpret_cast<__nv_bfloat162*>(orow + nv * 8) =
          __floats2bfloat162_rn(acc[nv * 4 + 2 * r] * inv,
                                acc[nv * 4 + 2 * r + 1] * inv);
    if (t == 0) lg[qp] = mrow[r] + log2f(lrow[r]);
  }
}

// ---------------------------------------------------------------------
// f32: FMA path
// ---------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kFM = 32;  // query rows per CTA, 4 threads each
constexpr int kFN = 32;  // keys per shared-memory tile

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int Hk, int Sq, int Skv,
              int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kFM][D + 1]
  float* sK = sQ + kFM * (D + 1);                  // [kFN][D + 1]
  float* sV = sK + kFN * (D + 1);                  // [kFN][DV]
  float* sP = sV + kFN * DV;                       // [kFM][kFN + 1]

  const int m0 = blockIdx.x * kFM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int r = threadIdx.x / 4;  // this thread's query row in the tile
  const int t = threadIdx.x % 4;  // its quarter of the keys and columns
  const int qp = m0 + r;

  const long long q_row = (long long)H * D;
  const long long k_row = (long long)Hk * D;
  const long long v_row = (long long)Hk * DV;
  const float* qg = q + (long long)b * Sq * q_row + h * D;
  const float* kg = k + (long long)b * Skv * k_row + hk * D;
  const float* vg = v + (long long)b * Skv * v_row + hk * DV;

  for (int i = threadIdx.x; i < kFM * D; i += kThreads) {
    int rr = i / D, c = i % D;
    sQ[rr * (D + 1) + c] = m0 + rr < Sq ? qg[(m0 + rr) * q_row + c] : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[DV / 4];
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc[i] = 0.f;

  int lo, hi;
  key_range(m0, kFM, kFN, Skv, causal, window, &lo, &hi);
  for (int n0 = lo; n0 < hi; n0 += kFN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFN * D; i += kThreads) {
      int rr = i / D, c = i % D;
      sK[rr * (D + 1) + c] =
          n0 + rr < Skv ? kg[(long long)(n0 + rr) * k_row + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kFN * DV; i += kThreads) {
      int rr = i / DV, c = i % DV;
      sV[rr * DV + c] =
          n0 + rr < Skv ? vg[(long long)(n0 + rr) * v_row + c] : 0.f;
    }
    __syncthreads();

    float s[kFN / 4];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kFN / 4; ++jj) {
      int j = t + 4 * jj;
      const float* qr = sQ + r * (D + 1);
      const float* kr = sK + j * (D + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      if (!key_live(qp, n0 + j, Skv, causal, window)) dot = kNegInf;
      s[jj] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    float corr = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kFN / 4; ++jj) {
      float p = exp2f(s[jj] - m);
      sP[r * (kFN + 1) + t + 4 * jj] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffff, sum, 1);
    sum += __shfl_xor_sync(0xffffffff, sum, 2);
    l = l * corr + sum;
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int cc = 0; cc < DV / 4; ++cc) acc[cc] *= corr;
    for (int j = 0; j < kFN; ++j) {
      float p = sP[r * (kFN + 1) + j];
      const float* vr = sV + j * DV + t;
#pragma unroll
      for (int cc = 0; cc < DV / 4; ++cc) acc[cc] = fmaf(p, vr[4 * cc], acc[cc]);
    }
  }

  if (qp < Sq) {
    l = fmaxf(l, 1e-30f);
    float inv = 1.f / l;
    float* orow = o + ((long long)b * Sq + qp) * H * DV + h * DV + t;
#pragma unroll
    for (int cc = 0; cc < DV / 4; ++cc) orow[4 * cc] = acc[cc] * inv;
    if (t == 0) lse[(long long)bh * Sq + qp] = m + log2f(l);
  }
}

template <int D, int DV>
cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int Hk, int Sq, int Skv,
                     int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  constexpr int BN = fwd_bn<D, DV>();
  if ((err = sm90::tmap_bshd(&tq, q, B, Sq, H, D, kBM)) != cudaSuccess ||
      (err = sm90::tmap_bshd(&tk, k, B, Skv, Hk, D, BN)) != cudaSuccess ||
      (err = sm90::tmap_bshd(&tv, v, B, Skv, Hk, DV, BN)) != cudaSuccess)
    return err;
  const int smem = FwdSmem<D, DV>::kBytes;
  auto kernel = flash_fwd_bf16<D, DV>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, Hk, Sq, Skv,
      causal, window);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int Hk, int Sq, int Skv,
                    int causal, int window, cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)kFM * (D + 1) + (size_t)kFN * (D + 1) +
                                 (size_t)kFN * DV + (size_t)kFM * (kFN + 1));
  auto kernel = flash_fwd_f32<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kFM - 1) / kFM, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hk, Sq,
      Skv, causal, window);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (marlin_tpu_torch/ops/flash_attention.py).
// dtype: 0 = bf16, 1 = f32. Returns the cudaError_t of the launch (0 = ok);
// an unsupported (dtype, D, DV) returns cudaErrorInvalidValue.
extern "C" int marlin_flash_attention_fwd(int dtype, const void* q,
                                          const void* k, const void* v,
                                          void* o, void* lse, int B, int H,
                                          int Hk, int Sq, int Skv, int D,
                                          int DV, int causal, int window,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
#define MARLIN_DISPATCH(RUN)                                                  \
  if (D == 64 && DV == 64)                                                    \
    return (int)RUN<64, 64>(q, k, v, o, l, B, H, Hk, Sq, Skv, causal, window, \
                            st);                                              \
  if (D == 64 && DV == 128)                                                   \
    return (int)RUN<64, 128>(q, k, v, o, l, B, H, Hk, Sq, Skv, causal,        \
                             window, st);                                     \
  if (D == 128 && DV == 64)                                                   \
    return (int)RUN<128, 64>(q, k, v, o, l, B, H, Hk, Sq, Skv, causal,        \
                             window, st);                                     \
  if (D == 128 && DV == 128)                                                  \
    return (int)RUN<128, 128>(q, k, v, o, l, B, H, Hk, Sq, Skv, causal,       \
                              window, st);                                    \
  if (D == 256 && DV == 256)                                                  \
    return (int)RUN<256, 256>(q, k, v, o, l, B, H, Hk, Sq, Skv, causal,       \
                              window, st);
  if (dtype == 0) {
    MARLIN_DISPATCH(run_bf16)
  } else if (dtype == 1) {
    MARLIN_DISPATCH(run_f32)
  }
#undef MARLIN_DISPATCH
  return (int)cudaErrorInvalidValue;
}
