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
// the tensor-core rate (989 TFLOP/s bf16 dense). This first version takes
// the simple route to it: mma.sync m16n8k16 (bf16 in, f32 accumulate) for
// both Q K^T and P V, with the S tile, the online-softmax state and the
// output accumulator all in registers (no logits in shared or device
// memory), and K/V tiles brought into padded (bank-conflict-free) shared
// memory with cp.async. It does not use wgmma, TMA or warp specialisation,
// and it does not double-buffer the K/V tiles; those are what close the
// gap to the bound and are left to a later change.
//
// The f32 path (not on the serving path) is a plain FMA kernel: 4 threads
// per query row, f32 products in f32, so it matches a full-f32 reference
// to ~1e-6.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
// bf16: tensor-core path
// ---------------------------------------------------------------------

constexpr int kBM = 64;       // query rows per CTA (4 warps x 16)
constexpr int kBN = 64;       // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of row padding (16 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of `width` bf16 (global row stride `gstride`) into a
// shared tile with row stride width + kPad; rows at or past `valid` are
// zero-filled (finite: a masked key must never bring a NaN into P V).
template <int WIDTH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* g,
                                          long long gstride, int rows,
                                          int valid) {
  constexpr int kChunks = WIDTH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    int r = c / kChunks;
    int col = (c % kChunks) * 8;
    bool ok = r < valid;
    const __nv_bfloat16* src = ok ? g + r * gstride + col : g;
    cp_async16(smem + r * (WIDTH + kPad) + col, src, ok);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int H, int Hk, int Sq, int Skv, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * (D + kPad);
  __nv_bfloat16* sV = sK + kBN * (D + kPad);

  const int m0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // mma groupID: the fragment row
  const int t = lane % 4;  // thread in group: the fragment column pair

  const long long q_row = (long long)H * D;
  const long long k_row = (long long)Hk * D;
  const long long v_row = (long long)Hk * DV;
  const __nv_bfloat16* qg = q + ((long long)b * Sq + m0) * q_row + h * D;
  const __nv_bfloat16* kg = k + (long long)b * Skv * k_row + hk * D;
  const __nv_bfloat16* vg = v + (long long)b * Skv * v_row + hk * DV;

  load_tile<D>(sQ, qg, q_row, kBM, Sq - m0);
  cp_async_wait_all();
  __syncthreads();

  // This warp's 16 query rows as mma A fragments, one per 16-wide d chunk.
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * (D + kPad);
    const __nv_bfloat16* r1 = r0 + 8 * (D + kPad);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      qf[kc][0] = ld32(r0 + kc * 16 + 2 * t);
      qf[kc][1] = ld32(r1 + kc * 16 + 2 * t);
      qf[kc][2] = ld32(r0 + kc * 16 + 2 * t + 8);
      qf[kc][3] = ld32(r1 + kc * 16 + 2 * t + 8);
    }
  }

  // Online-softmax state for the thread's two rows (g and g + 8).
  const int qp0 = m0 + warp * 16 + g;
  const int qp1 = qp0 + 8;
  float mrow[2] = {kNegInf, kNegInf};
  float lrow[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int lo, hi;
  key_range(m0, kBM, kBN, Skv, causal, window, &lo, &hi);
  for (int n0 = lo; n0 < hi; n0 += kBN) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<D>(sK, kg + (long long)n0 * k_row, k_row, kBN, Skv - n0);
    load_tile<DV>(sV, vg + (long long)n0 * v_row, v_row, kBN, Skv - n0);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of the m16n8 C layout.
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * (D + kPad) + 2 * t;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_bf16(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int kp = n0 + nt * 8 + 2 * t + (i & 1);
        int qp = i < 2 ? qp0 : qp1;
        if (!key_live(qp, kp, Skv, causal, window)) s[nt][i] = kNegInf;
        mx[i / 2] = fmaxf(mx[i / 2], s[nt][i]);
      }
    }
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
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - mrow[i / 2]);
        lrow[i / 2] += s[nt][i];
      }
    }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: the S accumulator of n-tiles (2kc, 2kc + 1) is exactly the
    // m16n8k16 A fragment of P's 16-key chunk kc.
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                        pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                        pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                        pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const __nv_bfloat16* v0 = sV + (kc * 16 + 2 * t) * (DV + kPad) + g;
      const __nv_bfloat16* v8 = v0 + 8 * (DV + kPad);
#pragma unroll
      for (int nv = 0; nv < DV / 8; ++nv) {
        uint32_t b0 = pack_bf16(v0[nv * 8], v0[nv * 8 + DV + kPad]);
        uint32_t b1 = pack_bf16(v8[nv * 8], v8[nv * 8 + DV + kPad]);
        mma_bf16(acc[nv], pa, b0, b1);
      }
    }
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
    int qp = r ? qp1 : qp0;
    if (qp >= Sq) continue;
    float inv = 1.f / lrow[r];
    __nv_bfloat16* orow = og + qp * o_row + 2 * t;
#pragma unroll
    for (int nv = 0; nv < DV / 8; ++nv) {
      __nv_bfloat162 val = __floats2bfloat162_rn(acc[nv][2 * r] * inv,
                                                 acc[nv][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + nv * 8) = val;
    }
    if (t == 0) lg[qp] = mrow[r] + log2f(lrow[r]);
  }
}

// ---------------------------------------------------------------------
// f32: FMA path
// ---------------------------------------------------------------------

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
  size_t smem = sizeof(__nv_bfloat16) *
                ((size_t)(kBM + kBN) * (D + kPad) + (size_t)kBN * (DV + kPad));
  auto kernel = flash_fwd_bf16<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, Hk, Sq, Skv, causal, window);
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
                              window, st);
  if (dtype == 0) {
    MARLIN_DISPATCH(run_bf16)
  } else if (dtype == 1) {
    MARLIN_DISPATCH(run_f32)
  }
#undef MARLIN_DISPATCH
  return (int)cudaErrorInvalidValue;
}
