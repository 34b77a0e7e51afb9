// Flash attention at head dims above 256, forward and backward, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// The wide counterparts of flash_attention_fwd.cu (B3) and
// flash_attention_bwd.cu (B4, B5), which are built for D and Dv up to 256:
// the reference (marlin_tpu/ops/flash_attention.py) zero-pads D and Dv to
// its 128-lane tile and takes any width, and so does the port through
// these kernels. The wrapper zero-pads D and Dv each to a multiple of 64
// (kWC) and calls them when either is above 256; zero columns change
// neither q_hat K^T, P V nor Delta. Same contract as the narrow kernels:
// base-2 softmax on the prescaled q_hat, -1e30 masks (never -inf), keys at
// or past Skv masked, causal k <= q, a window k > q - window, GQA by index,
// l clamped at 1e-30, lse = m + log2(l) in (B, H, Sq) f32, dQ = scale *
// dS K, dK = ln2 * dS^T q_hat, dV = P^T dO summed over the KV head's group.
//
// Design: shared memory does not grow with the head dim. Every CTA owns
// 64 output rows (query rows for O and dQ, keys for dK and dV) and 128 of
// the output's columns, a chunk picked by blockIdx.z; the 64 x 64 logit
// tiles S = q_hat K^T (and dP = dO V^T) accumulate over D (Dv) in
// 64-column chunks streamed through shared memory, and each CTA recomputes
// S, P and dS for its own column chunk. No CTA reduces into another's
// output: no atomics, so dQ, dK and dV come out bitwise the same run after
// run, and every forward CTA of a query tile computes the same lse
// (chunk 0 writes it; with `lse_chunks` every chunk writes its own copy,
// for a check that they agree).
//
// Arithmetic: FMA in f32 for both input types (bf16 is widened on load,
// results rounded once on store); two threads per output row, each holding
// 32 of the tile's logits and 64 of the row's output columns. This is the
// simple kernel that is right, not a fast one: no tensor cores, no TMA, no
// pipelining (its times are in PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;   // output rows per CTA (queries or keys)
constexpr int kCols = 64;   // partners per tile (keys or queries)
constexpr int kWC = 64;     // width of a reduction chunk over D or Dv
constexpr int kOut = 128;   // output columns per CTA
constexpr int kLd = kWC + 1;  // padded row stride of the shared tiles
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr float kLn2 = 0.693147180559945309f;

// Shared memory: the two reduction-chunk tiles (each kRows x kLd f32),
// which the output step reuses for its 64 x 128 operand, then P (or dS).
constexpr int kTileFloats = kRows * kLd;
constexpr size_t kSmemBytes = sizeof(float) * 3 * kTileFloats;
static_assert(2 * kTileFloats >= kCols * kOut, "the operand tile fits");

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool key_live(int q_pos, int k_pos, int skv,
                                         int causal, int window) {
  if (k_pos >= skv) return false;
  if (causal && k_pos > q_pos) return false;
  if (window && k_pos <= q_pos - window) return false;
  return true;
}

// Key rows [lo, hi) a query tile [m0, m0 + bm) visits: causal stops after
// the tile's last row, a window starts at the band's first key tile.
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

// Query rows [lo, hi) a key tile [n0, n0 + bn) visits: causal starts at
// the query tile holding row n0, a window ends at the tile holding the
// last row that still sees a key of this tile.
__device__ __forceinline__ void query_range(int n0, int bn, int bm, int sq,
                                            int causal, int window, int* lo,
                                            int* hi) {
  int n_q = (sq + bm - 1) / bm;
  int first = causal ? n0 / bm : 0;
  int last = n_q;
  if (window) {
    int band_end = (n0 + bn - 1 + window - 1) / bm + 1;
    if (band_end < last) last = band_end;
  }
  *lo = first * bm;
  *hi = last * bm;
}

// acc[j] += sum_w X[r][w] * Y[c0 + 2 j][w] over w in [0, width): X is this
// CTA's 64 rows (row r = threadIdx.x / 2 is this thread's), Y the tile's 64
// partners (c0 = threadIdx.x % 2), both rows of global matrices with row
// stride `xs`/`ys`; rows at or past `xv`/`yv` read as zero. `width` is a
// multiple of kWC.
template <typename T>
__device__ __forceinline__ void tile_dot(float (&acc)[kCols / 2], float* sX,
                                         float* sY, const T* x, long long xs,
                                         int xv, const T* y, long long ys,
                                         int yv, int width) {
  const int r = threadIdx.x >> 1, c0 = threadIdx.x & 1;
  for (int w0 = 0; w0 < width; w0 += kWC) {
    __syncthreads();  // every thread is done with the previous tiles
    for (int i = threadIdx.x; i < kRows * kWC; i += kThreads) {
      const int rr = i / kWC, cc = i % kWC;
      sX[rr * kLd + cc] = rr < xv ? load(x + rr * xs + w0 + cc) : 0.f;
      sY[rr * kLd + cc] = rr < yv ? load(y + rr * ys + w0 + cc) : 0.f;
    }
    __syncthreads();
    const float* xr = sX + r * kLd;
#pragma unroll 4
    for (int w = 0; w < kWC; ++w) {
      const float xw = xr[w];
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j)
        acc[j] = fmaf(xw, sY[(c0 + 2 * j) * kLd + w], acc[j]);
    }
  }
}

// out[j] += sum_k sP[r][k] * Z[k][col0 + c0 + 2 j] over the tile's 64
// partners k: Z's rows are global rows of stride `zs` (rows at or past
// `zv` read as zero), its columns [col0, col0 + kOut) those below `zw`
// (the rest read as zero). sP must be written before the call; sZ
// aliases the reduction tiles.
template <typename T>
__device__ __forceinline__ void tile_out(float (&out)[kOut / 2],
                                         const float* sP, float* sZ,
                                         const T* z, long long zs, int zv,
                                         int col0, int zw) {
  const int r = threadIdx.x >> 1, c0 = threadIdx.x & 1;
  __syncthreads();  // sP written; tile_dot's reads of sZ's space retired
  for (int i = threadIdx.x; i < kCols * kOut; i += kThreads) {
    const int rr = i / kOut, cc = i % kOut;
    sZ[i] = rr < zv && col0 + cc < zw ? load(z + rr * zs + col0 + cc) : 0.f;
  }
  __syncthreads();
  const float* pr = sP + r * kLd;
  for (int k = 0; k < kCols; ++k) {
    const float p = pr[k];
    const float* zr = sZ + k * kOut + c0;
#pragma unroll
    for (int j = 0; j < kOut / 2; ++j) out[j] = fmaf(p, zr[2 * j], out[j]);
  }
}

// B3, wide: O's columns [z * kOut, z * kOut + kOut) of 64 query rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, float* __restrict__ lse_chunks,
               int H, int Hk, int Sq, int Skv, int D, int DV, int causal,
               int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sX = reinterpret_cast<float*>(smem_raw);
  float* sY = sX + kTileFloats;
  float* sP = sY + kTileFloats;

  const int m0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int col0 = blockIdx.z * kOut;
  const int r = threadIdx.x >> 1, c0 = threadIdx.x & 1;
  const int qp = m0 + r;

  const long long q_row = (long long)H * D, k_row = (long long)Hk * D;
  const long long v_row = (long long)Hk * DV;
  const T* qg = q + ((long long)b * Sq + m0) * q_row + (long long)h * D;
  const T* kg = k + (long long)b * Skv * k_row + (long long)hk * D;
  const T* vg = v + (long long)b * Skv * v_row + (long long)hk * DV;

  float m = kNegInf, l = 0.f;
  float acc[kOut / 2];
#pragma unroll
  for (int j = 0; j < kOut / 2; ++j) acc[j] = 0.f;

  int lo, hi;
  key_range(m0, kRows, kCols, Skv, causal, window, &lo, &hi);
  for (int n0 = lo; n0 < hi; n0 += kCols) {
    float s[kCols / 2];
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) s[j] = 0.f;
    tile_dot(s, sX, sY, qg, q_row, Sq - m0, kg + (long long)n0 * k_row,
             k_row, Skv - n0, D);
    float mx = m;
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      if (!key_live(qp, n0 + c0 + 2 * j, Skv, causal, window)) s[j] = kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    const float corr = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      const float p = exp2f(s[j] - m);
      sP[r * kLd + c0 + 2 * j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffff, sum, 1);
    l = l * corr + sum;
#pragma unroll
    for (int j = 0; j < kOut / 2; ++j) acc[j] *= corr;
    tile_out(acc, sP, sX, vg + (long long)n0 * v_row, v_row, Skv - n0, col0,
             DV);
  }

  if (qp < Sq) {
    l = fmaxf(l, 1e-30f);
    const float inv = 1.f / l;
    T* orow = o + ((long long)b * Sq + qp) * H * DV + (long long)h * DV;
#pragma unroll
    for (int j = 0; j < kOut / 2; ++j) {
      const int c = col0 + c0 + 2 * j;
      if (c < DV) store(orow + c, acc[j] * inv);
    }
    if (c0 == 0) {
      const float ls = m + log2f(l);
      if (blockIdx.z == 0) lse[(long long)bh * Sq + qp] = ls;
      if (lse_chunks)
        lse_chunks[((long long)blockIdx.z * gridDim.y + bh) * Sq + qp] = ls;
    }
  }
}

// B4, wide: dQ's columns [z * kOut, z * kOut + kOut) of 64 query rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H,
                  int Hk, int Sq, int Skv, int D, int DV, int causal,
                  int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sX = reinterpret_cast<float*>(smem_raw);
  float* sY = sX + kTileFloats;
  float* sP = sY + kTileFloats;

  const int m0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int col0 = blockIdx.z * kOut;
  const int r = threadIdx.x >> 1, c0 = threadIdx.x & 1;
  const int qp = m0 + r;

  const long long q_row = (long long)H * D, o_row = (long long)H * DV;
  const long long k_row = (long long)Hk * D, v_row = (long long)Hk * DV;
  const T* qg = q + ((long long)b * Sq + m0) * q_row + (long long)h * D;
  const T* dog = dout + ((long long)b * Sq + m0) * o_row + (long long)h * DV;
  const T* kg = k + (long long)b * Skv * k_row + (long long)hk * D;
  const T* vg = v + (long long)b * Skv * v_row + (long long)hk * DV;
  const float lrow = qp < Sq ? lse[(long long)bh * Sq + qp] : 0.f;
  const float drow = qp < Sq ? delta[(long long)bh * Sq + qp] : 0.f;

  float acc[kOut / 2];
#pragma unroll
  for (int j = 0; j < kOut / 2; ++j) acc[j] = 0.f;

  int lo, hi;
  key_range(m0, kRows, kCols, Skv, causal, window, &lo, &hi);
  for (int n0 = lo; n0 < hi; n0 += kCols) {
    float s[kCols / 2], dp[kCols / 2];
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) s[j] = dp[j] = 0.f;
    tile_dot(s, sX, sY, qg, q_row, Sq - m0, kg + (long long)n0 * k_row,
             k_row, Skv - n0, D);
    tile_dot(dp, sX, sY, dog, o_row, Sq - m0, vg + (long long)n0 * v_row,
             v_row, Skv - n0, DV);
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      const float sc = key_live(qp, n0 + c0 + 2 * j, Skv, causal, window)
                           ? s[j] : kNegInf;
      const float p = exp2f(sc - lrow);
      sP[r * kLd + c0 + 2 * j] = p * (dp[j] - drow);
    }
    tile_out(acc, sP, sX, kg + (long long)n0 * k_row, k_row, Skv - n0, col0,
             D);
  }

  if (qp < Sq) {
    T* row = dq + ((long long)b * Sq + qp) * q_row + (long long)h * D;
#pragma unroll
    for (int j = 0; j < kOut / 2; ++j) {
      const int c = col0 + c0 + 2 * j;
      if (c < D) store(row + c, acc[j] * scale);
    }
  }
}

// B5, wide: 64 keys' columns [c, c + kOut) of dK (blockIdx.z below the
// dK chunk count) or of dV (the rest), summed over the KV head's group of
// query heads. The thread's row is a key; its 32 partners are queries.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int Hk, int Sq, int Skv, int D,
                   int DV, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sX = reinterpret_cast<float*>(smem_raw);
  float* sY = sX + kTileFloats;
  float* sP = sY + kTileFloats;

  const int n0 = blockIdx.x * kRows;
  const int bhk = blockIdx.y;
  const int b = bhk / Hk, hk = bhk % Hk, group = H / Hk;
  const int dk_chunks = (D + kOut - 1) / kOut;
  const bool is_dk = (int)blockIdx.z < dk_chunks;
  const int col0 = (is_dk ? blockIdx.z : blockIdx.z - dk_chunks) * kOut;
  const int r = threadIdx.x >> 1, c0 = threadIdx.x & 1;
  const int kp = n0 + r;

  const long long q_row = (long long)H * D, o_row = (long long)H * DV;
  const long long k_row = (long long)Hk * D, v_row = (long long)Hk * DV;
  const T* kg = k + ((long long)b * Skv + n0) * k_row + (long long)hk * D;
  const T* vg = v + ((long long)b * Skv + n0) * v_row + (long long)hk * DV;

  float acc[kOut / 2];
#pragma unroll
  for (int j = 0; j < kOut / 2; ++j) acc[j] = 0.f;

  int lo, hi;
  query_range(n0, kRows, kCols, Sq, causal, window, &lo, &hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = (long long)b * H + h;
    const T* qg = q + (long long)b * Sq * q_row + (long long)h * D;
    const T* dog = dout + (long long)b * Sq * o_row + (long long)h * DV;
    for (int m0 = lo; m0 < hi; m0 += kCols) {
      float st[kCols / 2];
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) st[j] = 0.f;
      tile_dot(st, sX, sY, kg, k_row, Skv - n0, qg + (long long)m0 * q_row,
               q_row, Sq - m0, D);
      float dpt[kCols / 2];
      if (is_dk) {
#pragma unroll
        for (int j = 0; j < kCols / 2; ++j) dpt[j] = 0.f;
        tile_dot(dpt, sX, sY, vg, v_row, Skv - n0,
                 dog + (long long)m0 * o_row, o_row, Sq - m0, DV);
      }
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) {
        const int qp = m0 + c0 + 2 * j;
        float val = 0.f;
        if (qp < Sq) {
          const float sc = key_live(qp, kp, Skv, causal, window) ? st[j]
                                                                 : kNegInf;
          const float p = exp2f(sc - lse[bh * Sq + qp]);
          val = is_dk ? p * (dpt[j] - delta[bh * Sq + qp]) : p;
        }
        sP[r * kLd + c0 + 2 * j] = val;
      }
      if (is_dk)
        tile_out(acc, sP, sX, qg + (long long)m0 * q_row, q_row, Sq - m0,
                 col0, D);
      else
        tile_out(acc, sP, sX, dog + (long long)m0 * o_row, o_row, Sq - m0,
                 col0, DV);
    }
  }

  if (kp < Skv) {
    const int width = is_dk ? D : DV;
    T* row = is_dk ? dk + ((long long)b * Skv + kp) * k_row + (long long)hk * D
                   : dv + ((long long)b * Skv + kp) * v_row +
                         (long long)hk * DV;
    const float f = is_dk ? kLn2 : 1.f;
#pragma unroll
    for (int j = 0; j < kOut / 2; ++j) {
      const int c = col0 + c0 + 2 * j;
      if (c < width) store(row + c, acc[j] * f);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
}

int chunks(int width) { return (width + kOut - 1) / kOut; }

bool valid(int dtype, int B, int H, int Hk, int Sq, int Skv, int D, int DV) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Hk >= 1 &&
         H % Hk == 0 && Sq >= 1 && Skv >= 1 && D >= kWC && DV >= kWC &&
         D % kWC == 0 && DV % kWC == 0 && B * H <= 65535;
}

template <typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, float* lse_chunks, int B, int H, int Hk,
                    int Sq, int Skv, int D, int DV, int causal, int window,
                    cudaStream_t st) {
  auto kernel = flash_fwd_wide<T>;
  cudaError_t err = set_smem(kernel);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kRows - 1) / kRows, B * H, chunks(DV));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lse_chunks, H, Hk,
      Sq, Skv, D, DV, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Hk, int Sq, int Skv, int D,
                   int DV, int causal, int window, float scale,
                   cudaStream_t st) {
  auto kernel = flash_bwd_dq_wide<T>;
  cudaError_t err = set_smem(kernel);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kRows - 1) / kRows, B * H, chunks(D));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Hk, Sq, Skv, D, DV, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int H, int Hk, int Sq,
                    int Skv, int D, int DV, int causal, int window,
                    cudaStream_t st) {
  auto kernel = flash_bwd_dkv_wide<T>;
  cudaError_t err = set_smem(kernel);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + kRows - 1) / kRows, B * Hk, chunks(D) + chunks(DV));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hk, Sq, Skv, D, DV,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes (marlin_tpu_torch/ops/flash_attention.py).
// dtype: 0 = bf16, 1 = f32. Each returns the cudaError_t of its launch
// (0 = ok); D or DV not a multiple of 64, or a shape out of range, returns
// cudaErrorInvalidValue. Layouts as in flash_attention_fwd.cu and
// flash_attention_bwd.cu; `lse_chunks` (may be null) is (chunks of DV,
// B, H, Sq) f32, every output chunk's copy of lse.
extern "C" int marlin_flash_attention_fwd_wide(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, void* lse_chunks, int B, int H, int Hk, int Sq, int Skv,
    int D, int DV, int causal, int window, void* stream) {
  if (!valid(dtype, B, H, Hk, Sq, Skv, D, DV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* lc = static_cast<float*>(lse_chunks);
  if (dtype == 0)
    return (int)run_fwd<__nv_bfloat16>(q, k, v, o, l, lc, B, H, Hk, Sq, Skv,
                                       D, DV, causal, window, st);
  return (int)run_fwd<float>(q, k, v, o, l, lc, B, H, Hk, Sq, Skv, D, DV,
                             causal, window, st);
}

extern "C" int marlin_flash_attention_bwd_dq_wide(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hk,
    int Sq, int Skv, int D, int DV, int causal, int window, float scale,
    void* stream) {
  if (!valid(dtype, B, H, Hk, Sq, Skv, D, DV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)run_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, H, Hk, Sq,
                                      Skv, D, DV, causal, window, scale, st);
  return (int)run_dq<float>(q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Skv, D,
                            DV, causal, window, scale, st);
}

extern "C" int marlin_flash_attention_bwd_dkv_wide(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Hk, int Sq, int Skv, int D, int DV, int causal, int window,
    void* stream) {
  if (!valid(dtype, B, H, Hk, Sq, Skv, D, DV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)run_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, B, H,
                                       Hk, Sq, Skv, D, DV, causal, window,
                                       st);
  return (int)run_dkv<float>(q, k, v, dout, l, dl, dk, dv, B, H, Hk, Sq, Skv,
                             D, DV, causal, window, st);
}
