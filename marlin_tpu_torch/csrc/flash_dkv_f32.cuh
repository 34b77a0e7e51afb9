// The f32 flash-attention dK/dV kernels' shared parts, for the H100's
// CUDA cores (sm_90a), hand-written CUDA C++.
//
// Replaces, in f32, the Pallas TPU kernel
// marlin_tpu/ops/flash_attention.py::_bwd_dkv_kernel (:373, pallas_call
// :543): dK = ln2 * sum dS^T q_hat and dV = sum P^T dO over each KV head's
// group of query heads, P = exp2(q_hat K^T - lse) under the masks (keys at
// or past Skv, causal k <= q, a window k > q - window; exactly 0 where
// dead) and dS = P (dO V^T - Delta), recomputed from lse: no (Sq, Skv)
// tensor exists. flash_attention_bwd.cu (D and DV up to 256:
// flash_bwd_dkv_f32) and flash_attention_wide.cu (above 256:
// flash_bwd_dkv_wide_f32) each define their kernel and second pass from
// these pieces and spell out the cut of a CTA's work in their own body.
// The box products, the loads and the ring are flash_f32.cuh's.
//
// Bound on the H100: 4 (D + DV) FLOP a live (q, k) pair against (D + DV) *
// 4 bytes a row of the inputs: at D = DV = 128, S = 1000, 8 heads, 4.1
// GFLOP against 5 MB, so the FMA rate bounds it (0.061 ms), not HBM.
//
// Design.
//  * Two warpgroups, 8 x 4 register tiles. A step gives each warpgroup
//    one 64 x 64 x 64 box product. In a logit step warpgroup 0 adds a box
//    of S^T = K q_hat^T and warpgroup 1 one of dP^T = V dO^T where the CTA
//    holds dK columns, else one of the second half of S^T's boxes
//    (warpgroup 0 adds that half's sum to its own). In an output step each
//    warpgroup adds one of a pair of output boxes: P^T dO into dV, dS^T
//    q_hat into dK. P^T (warpgroup 0) and dS^T (warpgroup 1, from P^T)
//    pass through shared memory once a pair, one barrier apart.
//  * A split sweep. A CTA owns 64 keys of one KV head, one column share
//    and one part of the key tile's sweep over its (query head, live query
//    tile) pairs, head-major: part p holds pairs [p * chunk, (p + 1) *
//    chunk). The host sets chunk from the P parts of the most loaded key
//    tile, so every key tile is cut by its live work: key tile 0 of a
//    causal sweep gets P parts, the last one the fewest. A key tile of
//    one part writes dK (times ln2) and dV itself; one of several writes
//    f32 partial sums to a workspace (P, B, Skv, Hk, D + DV), and a second
//    pass adds them in part order and applies ln2. No atomics: bitwise the
//    same run after run. The grid runs the key tiles heaviest first.
//  * Column shares. A CTA holds at most kMaxBoxes = 8 output boxes (512
//    columns, 128 accumulator registers): all of dK and dV where D + DV <=
//    512, else dK's shares (which need dP^T) then dV's (which do not), each
//    as even as whole boxes allow; every share computes S^T again. FLOP a
//    live pair: 4 (D + DV) where D + DV <= 512, the counted work; else
//    nk (2 D + 2 DV) + 2 D + nv 2 D + 2 DV, nk = ceil(D / 512) and nv =
//    ceil(DV / 512): 1.25x the counted at D = DV = 320 or 512, 2x at 1024.
//  * Overlapped loads. K and V stream like q_hat and dO: at D = 1024 a
//    64-key K tile alone is 256 KB. lse and Delta of a pair are read into
//    registers at its first step.
//
// ptxas (sm_90a, 256 threads, one CTA an SM): 255 registers, spilling 48
// to 84 bytes at NB = 8 and the wide kernel, 64 at NB = 3 and 4, none at
// NB = 2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"

namespace dkv_f32 {

using namespace flash_f32;

constexpr int kKeys = 64;          // keys a CTA: its rows of dK and dV
constexpr int kQueries = 64;       // query rows a tile
constexpr float kLn2 = 0.693147180559945309f;
// The ring, then P^T and dS^T: 174,080 bytes, one CTA an SM.
constexpr size_t kSmemBytes = sizeof(float) * (4 * kStages + 2) * kBoxFloats;

// A launch's arguments. q is the prescaled q_hat; layouts as in
// flash_attention_bwd.cu. ws: (parts, B, Skv, Hk, D + DV) f32, may be null
// for parts = 1. chunk: (query head, query tile) pairs a sweep part, set by
// launch() from parts.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  float* ws;
  int B, H, Hk, Sq, Skv, D, DV, causal, window;
  int parts, chunk;
};

// Query tiles [*first, *first + *n) that 64-key tile n0 visits: causal
// starts at the tile holding row n0, a window ends at the tile holding the
// last row that still sees a key of this tile, never past the last one.
__host__ __device__ inline void query_tiles(int n0, int Sq, int causal,
                                            int window, int* first, int* n) {
  const int f = causal ? n0 / kQueries : 0;
  int last = cdiv(Sq, kQueries);
  if (window) {
    const int band_end = (n0 + kKeys - 1 + window - 1) / kQueries + 1;
    if (band_end < last) last = band_end;
  }
  *first = f;
  *n = last > f ? last - f : 0;
}

// A CTA's output columns, in 64-column boxes: dK's [dk0, dk0 + ndk), dV's
// [dv0, dv0 + ndv). Its output boxes run dV's first, then dK's.
struct Share {
  int dk0, ndk, dv0, ndv;
};

__host__ __device__ inline int share_count(int D, int DV) {
  const int most = kMaxBoxes * kBox;
  return D + DV <= most ? 1 : cdiv(D, most) + cdiv(DV, most);
}

__host__ __device__ inline Share share_of(int D, int DV, int z) {
  const int bk = D / kBox, bv = DV / kBox;
  if (bk + bv <= kMaxBoxes) return Share{0, bk, 0, bv};
  const int nk = cdiv(bk, kMaxBoxes);
  if (z < nk) return Share{z * bk / nk, (z + 1) * bk / nk - z * bk / nk, 0, 0};
  z -= nk;
  const int nv = cdiv(bv, kMaxBoxes);
  return Share{0, 0, z * bv / nv, (z + 1) * bv / nv - z * bv / nv};
}

// A CTA's place in the 1-D grid: key tile t (slowest: heaviest first),
// sweep part p, batch b, KV head hk, column share z (fastest).
struct Cta {
  int t, p, b, hk, z;
};

__device__ __forceinline__ Cta cta_of(const Args& a, int n_shares) {
  int i = (int)blockIdx.x;
  Cta c;
  c.z = i % n_shares;
  i /= n_shares;
  const int bhk = i % (a.B * a.Hk);
  i /= a.B * a.Hk;
  c.b = bhk / a.Hk;
  c.hk = bhk % a.Hk;
  c.p = i % a.parts;
  c.t = i / a.parts;
  return c;
}

// Where a CTA's results go: dK (times ln2) and dV themselves for a key
// tile of one part; else its part's plane of the workspace, unscaled.
struct Dest {
  float* k;
  float* v;
  long long ks, vs;  // row strides
  float fk;          // dK's factor
};

__device__ __forceinline__ Dest dest_of(const Args& a, const Cta& c,
                                        int parts) {
  const long long row = ((long long)c.b * a.Skv + c.t * kKeys) * a.Hk + c.hk;
  if (parts == 1)
    return Dest{a.dk + row * a.D, a.dv + row * a.DV, (long long)a.Hk * a.D,
                (long long)a.Hk * a.DV, kLn2};
  const long long width = a.D + a.DV;
  float* base = a.ws + ((long long)c.p * a.B * a.Skv * a.Hk + row) * width;
  return Dest{base, base + a.D, a.Hk * width, a.Hk * width, 1.f};
}

// Whether query qp sees key kp: both in range, causal k <= q, a window
// k > q - window.
__device__ __forceinline__ bool live(const Args& a, int qp, int kp) {
  return qp < a.Sq && kp < a.Skv && (!a.causal || kp <= qp) &&
         (!a.window || kp > qp - a.window);
}

// One CTA's sweep: pairs [first, last) of key tile c.t's (query head,
// query tile) pairs, head-major (n_qt live query tiles a head from tile
// tile0), for the columns of share `s`, whose output products read q_hat
// from `q_out` and dO from `do_out` (the tensors offset to the share's
// first column); results to `out`. NB: the most output boxes a share has.
//
// Two warpgroups share each step. A logit step gives warpgroup 0 a box of
// S^T (K and q_hat) and warpgroup 1 one of dP^T (V and dO) where the share
// holds dK columns, else one of the second half of S^T's boxes, whose sum
// warpgroup 0 adds to its own. An output step gives each warpgroup one of
// a pair of output boxes. A slot holds the step's four boxes.
template <int NB>
__device__ __forceinline__ void sweep(const Args& a, const Cta& c,
                                      int tile0, int n_qt, int first,
                                      int last, const Share& s,
                                      const float* q_out,
                                      const float* do_out, const Dest& out,
                                      float* smem) {
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int tn = lane & 7;
  const int tm = warp * 4 + (lane >> 3);
  const int group = a.H / a.Hk;
  const int n0 = c.t * kKeys;
  const long long q_row = (long long)a.H * a.D, o_row = (long long)a.H * a.DV;
  const long long k_row = (long long)a.Hk * a.D;
  const long long v_row = (long long)a.Hk * a.DV;
  const float* kg =
      a.k + ((long long)c.b * a.Skv + n0) * k_row + (long long)c.hk * a.D;
  const float* vg =
      a.v + ((long long)c.b * a.Skv + n0) * v_row + (long long)c.hk * a.DV;
  const bool has_dk = s.ndk > 0;
  const int n_d = a.D / kBox, half = (n_d + 1) / 2;
  const int n_l0 = has_dk ? n_d : half;              // warpgroup 0's boxes
  const int n_l1 = has_dk ? a.DV / kBox : n_d - half;  // warpgroup 1's
  const int n_l = n_l0 > n_l1 ? n_l0 : n_l1;         // logit steps a pair
  const int n_o = s.ndv + s.ndk;                     // output boxes
  const int per_pair = n_l + (n_o + 1) / 2;
  float* sP = smem + 4 * kStages * kBoxFloats;
  float* sdS = sP + kBoxFloats;

  // The next step to load: its slot, its place in its pair, the pair's
  // query head (in the group) and query tile, counted, not divided.
  int p_step = 0, p_r = 0, p_pair = first;
  int p_g = n_qt ? first / n_qt : 0, p_q = n_qt ? first % n_qt : 0;
  auto out_box = [&](int j, float* dst, long long qo, long long oo,
                     int q_valid) {
    if (j < s.ndv)
      load_box(dst, do_out + oo + j * kBox, o_row, q_valid);
    else
      load_box(dst, q_out + qo + (j - s.ndv) * kBox, q_row, q_valid);
  };
  // The next step's boxes into its slot, then one commit group (empty
  // past the last step, so the wait below counts the same every step).
  auto load_next = [&]() {
    if (p_pair < last) {
      const int h = c.hk * group + p_g;
      const int m0 = (tile0 + p_q) * kQueries;
      float* slot = slot_of(smem, p_step);
      const long long qo =
          ((long long)c.b * a.Sq + m0) * q_row + (long long)h * a.D;
      const long long oo =
          ((long long)c.b * a.Sq + m0) * o_row + (long long)h * a.DV;
      const int q_valid = a.Sq - m0, k_valid = a.Skv - n0;
      if (p_r < n_l) {
        const int r = p_r;
        if (r < n_l0) {
          load_box(slot, kg + r * kBox, k_row, k_valid);
          load_box(slot + kBoxFloats, a.q + qo + r * kBox, q_row, q_valid);
        }
        if (r < n_l1 && has_dk) {
          load_box(slot + 2 * kBoxFloats, vg + r * kBox, v_row, k_valid);
          load_box(slot + 3 * kBoxFloats, a.dout + oo + r * kBox, o_row,
                   q_valid);
        } else if (r < n_l1) {
          load_box(slot + 2 * kBoxFloats, kg + (half + r) * kBox, k_row,
                   k_valid);
          load_box(slot + 3 * kBoxFloats, a.q + qo + (half + r) * kBox,
                   q_row, q_valid);
        }
      } else {
        const int j = 2 * (p_r - n_l);
        out_box(j, slot + kBoxFloats, qo, oo, q_valid);
        if (j + 1 < n_o) out_box(j + 1, slot + 3 * kBoxFloats, qo, oo, q_valid);
      }
      if (++p_r == per_pair) {
        p_r = 0;
        ++p_pair;
        if (++p_q == n_qt) {
          p_q = 0;
          ++p_g;
        }
      }
    }
    cp_async_commit();
    ++p_step;
  };
  auto advance = [&](int i) { return flash_f32::advance(smem, i, load_next); };

  float4 acc[(NB + 1) / 2][8];
#pragma unroll
  for (int q = 0; q < (NB + 1) / 2; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[q][i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < kStages - 1; ++i) load_next();
  int step = 0;
  int g = n_qt ? first / n_qt : 0, qt = n_qt ? first % n_qt : 0;
  for (int pair = first; pair < last; ++pair) {
    const int h = c.hk * group + g;
    const int m0 = (tile0 + qt) * kQueries;
    if (++qt == n_qt) {
      qt = 0;
      ++g;
    }
    const long long stat = ((long long)c.b * a.H + h) * a.Sq;
    float lq[4], dl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = m0 + tm + 16 * j;
      lq[j] = wg == 0 && qp < a.Sq ? a.lse[stat + qp] : 0.f;
      dl[j] = wg == 1 && has_dk && qp < a.Sq ? a.delta[stat + qp] : 0.f;
    }
    float cc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cc[i][j] = 0.f;
    const int mine = wg ? n_l1 : n_l0;
    for (int x = 0; x < n_l; ++x) {
      const float* sl = advance(step++) + 2 * wg * kBoxFloats;
      if (x < mine) tile_dot(cc, sl, sl + kBoxFloats, tn, tm);
    }
    // P^T (warpgroup 0), then dS^T from it (warpgroup 1); without dK
    // columns, warpgroup 1's half of S^T first, through sdS, then P^T. Every
    // thread finished the last pair's output steps before this pair's
    // first barrier.
    if (wg == (has_dk ? 0 : 1)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kp = n0 + tn + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qp = m0 + tm + 16 * j;
          const int at = (tn + 8 * i) * kLd + tm + 16 * j;
          if (has_dk)
            sP[at] = live(a, qp, kp) ? exp2f(cc[i][j] - lq[j]) : 0.f;
          else
            sdS[at] = cc[i][j];
        }
      }
    }
    __syncthreads();
    if (wg == (has_dk ? 1 : 0)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kp = n0 + tn + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qp = m0 + tm + 16 * j;
          const int at = (tn + 8 * i) * kLd + tm + 16 * j;
          if (has_dk)
            sdS[at] = sP[at] * (cc[i][j] - dl[j]);
          else
            sP[at] = live(a, qp, kp) ? exp2f(cc[i][j] + sdS[at] - lq[j])
                                     : 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < (NB + 1) / 2; ++q) {
      if (2 * q < n_o) {
        const float* sl = advance(step++) + (2 * wg + 1) * kBoxFloats;
        const int j = 2 * q + wg;
        if (j < n_o) tile_out(acc[q], j < s.ndv ? sP : sdS, sl, tn, tm);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int q = 0; q < (NB + 1) / 2; ++q) {
    const int j = 2 * q + wg;
    if (j >= n_o) continue;
    const bool is_v = j < s.ndv;
    float* base = is_v ? out.v + kBox * (s.dv0 + j)
                       : out.k + kBox * (s.dk0 + j - s.ndv);
    const long long stride = is_v ? out.vs : out.ks;
    const float f = is_v ? 1.f : out.fk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tn + 8 * i;
      if (n0 + r < a.Skv) {
        const float4 x = acc[q][i];
        *reinterpret_cast<float4*>(base + r * stride + 4 * tm) =
            make_float4(x.x * f, x.y * f, x.z * f, x.w * f);
      }
    }
  }
}

// Parts of the key tile that holds workspace element e (a float4 of row
// (b, key, hk)), as the kernel cut it.
__device__ __forceinline__ int row_parts(const Args& a, long long e) {
  const long long row = e / ((a.D + a.DV) / 4);
  const int kp = (int)(row / a.Hk % a.Skv);
  int first, n;
  query_tiles(kp / kKeys * kKeys, a.Sq, a.causal, a.window, &first, &n);
  return part_count(a.H / a.Hk * n, a.chunk);
}

// Workspace element e summed over planes [0, parts) in that order, to dK
// (times ln2) or dV.
__device__ __forceinline__ void sum_parts(const Args& a, long long e,
                                          int parts) {
  const int width = a.D + a.DV;
  const long long row = e / (width / 4);
  const int col = (int)(e % (width / 4)) * 4;
  const long long plane = (long long)a.B * a.Skv * a.Hk * width;
  const float* src = a.ws + row * width + col;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * plane);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  if (col < a.D)
    *reinterpret_cast<float4*>(a.dk + row * a.D + col) =
        make_float4(s.x * kLn2, s.y * kLn2, s.z * kLn2, s.w * kLn2);
  else
    *reinterpret_cast<float4*>(a.dv + row * a.DV + col - a.D) = s;
}

// Launch `kernel` (grid: key tiles x parts x B * Hk x shares CTAs) and,
// for parts > 1, the second pass `sum` on the same stream. Sets a.chunk
// from a.parts: the most loaded key tile's pairs over parts, rounded up.
template <typename Kernel, typename Sum>
inline cudaError_t launch(Kernel kernel, Sum sum, Args a, int n_shares,
                          cudaStream_t st) {
  if (a.parts < 1 || (a.parts > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  const int key_tiles = cdiv(a.Skv, kKeys);
  int most = 0;
  for (int t = 0; t < key_tiles; ++t) {
    int first, n;
    query_tiles(t * kKeys, a.Sq, a.causal, a.window, &first, &n);
    if (n > most) most = n;
  }
  const int pairs = a.H / a.Hk * most;
  a.chunk = pairs > a.parts ? cdiv(pairs, a.parts) : 1;
  const long long ctas =
      (long long)key_tiles * a.parts * a.B * a.Hk * n_shares;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)ctas, kThreads, kSmemBytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || a.parts == 1) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long n4 = (long long)a.B * a.Skv * a.Hk * ((a.D + a.DV) / 4);
  long long blocks = (n4 + kSumThreads - 1) / kSumThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // a grid-stride loop past it
  sum<<<(unsigned)blocks, kSumThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace dkv_f32
