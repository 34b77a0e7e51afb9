// The f32 flash-attention forward and dQ sweeps, for the H100's CUDA cores
// (sm_90a), hand-written CUDA C++.
//
// Replace, in f32, the Pallas TPU kernels
// marlin_tpu/ops/flash_attention.py::_kernel (:134, pallas_call :272) and
// ::_bwd_dq_kernel (:335, pallas_call :518): O = softmax(q_hat K^T) V in
// base 2 on the prescaled q_hat, with lse = m + log2(l) (B, H, Sq) f32, and
// dQ = scale * sum dS K, dS = P (dO V^T - Delta), P = exp2(q_hat K^T - lse)
// recomputed from lse; masks -1e30 (never -inf): keys at or past Skv,
// causal k <= q, a window k > q - window; l clamped at 1e-30; GQA by index,
// K and V never replicated. flash_attention_fwd.cu and
// flash_attention_bwd.cu (head dims up to 256: flash_fwd_f32<NB>,
// flash_bwd_dq_f32<NB>, one share) and flash_attention_wide.cu (above 256:
// flash_fwd_wide_f32, flash_bwd_dq_wide_f32) define the kernels and their
// second passes from these pieces and spell out the cut of a CTA's work in
// their own bodies; the box products, the loads and the ring are
// flash_f32.cuh's.
//
// Design.
//  * A CTA owns 64 query rows of one query head, one share of the output's
//    columns (Dv for O, D for dQ: at most kMaxBoxes = 8 boxes, 512
//    columns, as even as whole boxes allow; two of 512 at 1024) and one
//    part of the query tile's sweep over its live key tiles. Every share
//    computes the logits again: FLOP a live pair 2 (D + Dv) for O and
//    2 (2 D + Dv) for dQ where the output is one share, 1.5x and 1.67x at
//    D = Dv = 1024.
//  * Forward: a key tile of kFwdKeys = 128 keys. A logit step brings a
//    q_hat box and the two 64-key halves' K boxes of the same columns, and
//    each warpgroup adds that box's product into S of its own half. The
//    online softmax's row max crosses the 4 lanes of a warp and the 8 warps
//    that hold a row through shared memory, once a tile; each thread keeps
//    its own part of the row sum l, rescaled by the same factor, summed
//    across the CTA once at the end. O is rescaled per row before P V;
//    P goes to shared memory once (two boxes, a half each). An output step
//    brings both halves' V boxes of two output boxes, one a warpgroup, and
//    each warpgroup adds P V over the 128 keys into its own box.
//  * dQ: a key tile of kDqKeys = 64 keys. A logit step gives warpgroup 0 a
//    box of S (q_hat, K) and warpgroup 1 one of dP (dO, V); P (warpgroup 0)
//    and then dS = P (dP - Delta) (warpgroup 1) go to shared memory one
//    barrier apart. An output step adds dS K into two of dQ's boxes, one a
//    warpgroup. lse (warpgroup 0) or Delta (warpgroup 1) of the thread's 8
//    rows is read once.
//  * A split sweep. Part p of a query tile holds its live key tiles
//    [first + p * chunk, first + (p + 1) * chunk); the host sets chunk from
//    the P parts of the most loaded query tile, so every query tile is cut
//    by its live work: the last query tile of a causal sweep gets P parts,
//    the first the fewest. The grid runs the query tiles last (heaviest)
//    first. A query tile of one part writes O and lse (dQ times scale)
//    itself; one of several writes f32 partials to a workspace: the
//    forward its unnormalised O (P, B, Sq, H, Dv) and each share's m and l
//    (P, shares, B, H, Sq), dQ its unscaled sums (P, B, Sq, H, D). A second
//    pass merges them in part order: m = max m_p, l = sum 2^(m_p - m) l_p,
//    O = sum 2^(m_p - m) O_p / max(l, 1e-30) and lse = m + log2(l); dQ =
//    scale * sum dQ_p. No atomics: bitwise the same run after run. Every
//    share writes its own copy of lse where `lse_chunks` asks for it (all
//    equal: each share computes the same logits in the same order).
//
// Template argument NB: the most output boxes a share has (kMaxBoxes for
// the wide kernels; Dv / 64 or D / 64, so 1, 2 or 4, for the narrow ones),
// so the accumulators stay in registers. An odd count leaves one
// warpgroup idle in the last output step of a key tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"

namespace fwd_dq_f32 {

using namespace flash_f32;

constexpr int kQueries = 64;   // query rows a CTA
constexpr int kFwdKeys = 128;  // keys a forward tile: 64 a warpgroup
constexpr int kDqKeys = 64;    // keys a dQ tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
// The ring, then two boxes (P's halves; dQ: P and dS), then the forward's
// row exchange (8 warps x 64 rows): 176,128 bytes, one CTA an SM.
constexpr size_t kSmemBytes =
    sizeof(float) * ((4 * kStages + 2) * kBoxFloats + 8 * kQueries);

// A launch's arguments; layouts (B, S, heads, width) row-major, lse and
// Delta (B, H, Sq). q is the prescaled q_hat. Forward: out is O, lse is
// written and lse_chunks (shares, B, H, Sq) may be null; dQ: out is dQ,
// lse and delta are read. ws: the parts' partials, may be null for parts
// = 1. chunk: key tiles a sweep part, set by launch() from parts.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* delta;
  float* out;
  float* lse;
  float* lse_chunks;
  float* ws;
  int B, H, Hk, Sq, Skv, D, DV, causal, window;
  float scale;
  int parts, chunk;
};

// A CTA's output columns, in 64-column boxes: [b0, b0 + nb).
struct Share {
  int b0, nb;
};

// A CTA's place in the 1-D grid: query tile t (slowest, the last first),
// sweep part p, batch b, query head h, column share z (fastest).
struct Cta {
  int t, p, b, h, z;
};

// Key tiles [*first, *first + *n) of `bn` keys that the query tile at row
// m0 visits: causal stops after the tile's last row, a window starts at
// the band's first key tile.
__host__ __device__ inline void key_tiles(int m0, int bn, int Skv,
                                          int causal, int window, int* first,
                                          int* n) {
  int hi = Skv;
  if (causal && m0 + kQueries < hi) hi = m0 + kQueries;
  int lo = 0;
  if (window) {
    lo = m0 - window + 1;
    lo = lo < 0 ? 0 : lo / bn * bn;
  }
  *first = lo / bn;
  *n = hi > lo ? cdiv(hi - lo, bn) : 0;
}

__host__ __device__ inline int share_count(int width) {
  return cdiv(width / kBox, kMaxBoxes);
}

__host__ __device__ inline Share share_of(int width, int z) {
  const int boxes = width / kBox, n = share_count(width);
  return Share{z * boxes / n, (z + 1) * boxes / n - z * boxes / n};
}

__device__ __forceinline__ Cta cta_of(const Args& a, int n_shares) {
  int i = (int)blockIdx.x;
  Cta c;
  c.z = i % n_shares;
  i /= n_shares;
  const int bh = i % (a.B * a.H);
  i /= a.B * a.H;
  c.b = bh / a.H;
  c.h = bh % a.H;
  c.p = i % a.parts;
  c.t = cdiv(a.Sq, kQueries) - 1 - i / a.parts;
  return c;
}

// Whether query qp sees key kp: both in range, causal k <= q, a window
// k > q - window.
__device__ __forceinline__ bool live(const Args& a, int qp, int kp) {
  return qp < a.Sq && kp < a.Skv && (!a.causal || kp <= qp) &&
         (!a.window || kp > qp - a.window);
}

// A box of rows [n0, n0 + 64) of a key-indexed tensor (K or V, row stride
// `stride`, `base` at key 0 and the box's first column); rows at or past
// Skv zero-filled.
__device__ __forceinline__ void key_box(float* dst, const float* base,
                                        long long stride, int n0, int Skv) {
  const int valid = Skv - n0;
  load_box(dst, base + (valid > 0 ? n0 * stride : 0), stride, valid);
}

__device__ __forceinline__ float4 scale4(float4 x, float f) {
  return make_float4(x.x * f, x.y * f, x.z * f, x.w * f);
}

// The forward sweep of CTA c over key tiles [kt0, kt1) for share s, whose
// output products read V from `v_out` (V offset to the share's first
// column); a query tile of `parts` parts writes O and lse itself (1) or
// its part's partials (more).
template <int NB>
__device__ __forceinline__ void fwd_sweep(const Args& a, const Cta& c,
                                          int kt0, int kt1, const Share& s,
                                          const float* v_out, int parts,
                                          float* smem) {
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tn = lane & 7, tm = (warp & 3) * 4 + (lane >> 3);
  const int hk = c.h / (a.H / a.Hk);
  const int m0 = c.t * kQueries;
  const long long q_row = (long long)a.H * a.D;
  const long long k_row = (long long)a.Hk * a.D;
  const long long v_row = (long long)a.Hk * a.DV;
  const float* qg =
      a.q + ((long long)c.b * a.Sq + m0) * q_row + (long long)c.h * a.D;
  const float* kg =
      a.k + (long long)c.b * a.Skv * k_row + (long long)hk * a.D;
  const float* vg =
      v_out + (long long)c.b * a.Skv * v_row + (long long)hk * a.DV;
  const int n_d = a.D / kBox, n_o = s.nb;
  const int per_tile = n_d + (n_o + 1) / 2;
  const int q_valid = a.Sq - m0;
  float* sP = smem + 4 * kStages * kBoxFloats;  // keys [0, 64), [64, 128)
  float* sRed = sP + 2 * kBoxFloats;            // 8 warps x 64 rows

  // The next step to load: its place in its key tile, and the tile.
  int p_step = 0, p_r = 0, p_t = kt0;
  auto load_next = [&]() {
    if (p_t < kt1) {
      float* slot = slot_of(smem, p_step);
      const int n0 = p_t * kFwdKeys;
      if (p_r < n_d) {  // q_hat's box, both halves' K boxes
        load_box(slot, qg + p_r * kBox, q_row, q_valid);
        key_box(slot + kBoxFloats, kg + p_r * kBox, k_row, n0, a.Skv);
        key_box(slot + 2 * kBoxFloats, kg + p_r * kBox, k_row, n0 + 64,
                a.Skv);
      } else {  // both halves' V boxes of two output boxes
        const int j = 2 * (p_r - n_d);
        for (int x = 0; x < 2 && j + x < n_o; ++x) {
          key_box(slot + 2 * x * kBoxFloats, vg + (j + x) * kBox, v_row, n0,
                  a.Skv);
          key_box(slot + (2 * x + 1) * kBoxFloats, vg + (j + x) * kBox,
                  v_row, n0 + 64, a.Skv);
        }
      }
      if (++p_r == per_tile) {
        p_r = 0;
        ++p_t;
      }
    }
    cp_async_commit();
    ++p_step;
  };

  float m[8], l[8];
  float4 acc[(NB + 1) / 2][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int q = 0; q < (NB + 1) / 2; ++q)
      acc[q][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int i = 0; i < kStages - 1; ++i) load_next();
  int step = 0;
  for (int t = kt0; t < kt1; ++t) {
    const int n0 = t * kFwdKeys + 64 * wg;  // this warpgroup's keys
    float cc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cc[i][j] = 0.f;
    for (int x = 0; x < n_d; ++x) {
      const float* sl = advance(smem, step++, load_next);
      tile_dot(cc, sl, sl + (1 + wg) * kBoxFloats, tn, tm);
    }
    // The tile's row max: this thread's 4 keys, the 4 lanes of its warp
    // that hold its rows, then the 8 warps through shared memory. Every
    // thread reads the 8 in the same order, so all agree bit for bit.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = m0 + tn + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live(a, qp, n0 + tm + 16 * j)) cc[i][j] = kNegInf;
        mx = fmaxf(mx, cc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      if (lane < 8) sRed[warp * kQueries + tn + 8 * i] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = m[i];
#pragma unroll
      for (int w = 0; w < 8; ++w)
        mx = fmaxf(mx, sRed[w * kQueries + tn + 8 * i]);
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(cc[i][j] - mx);
        sP[wg * kBoxFloats + (tn + 8 * i) * kLd + tm + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int q = 0; q < (NB + 1) / 2; ++q)
        acc[q][i] = scale4(acc[q][i], corr);
    }
    // P is read after the next step's barrier.
#pragma unroll
    for (int q = 0; q < (NB + 1) / 2; ++q) {
      if (2 * q < n_o) {
        const float* sl =
            advance(smem, step++, load_next) + 2 * wg * kBoxFloats;
        if (2 * q + wg < n_o) {
          tile_out(acc[q], sP, sl, tn, tm);
          tile_out(acc[q], sP + kBoxFloats, sl + kBoxFloats, tn, tm);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The row sums: the 4 lanes, then the 8 warps, in a fixed order.
  __syncthreads();  // every read of sRed is done
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 8);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 16);
    if (lane < 8) sRed[warp * kQueries + tn + 8 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += sRed[w * kQueries + tn + 8 * i];
    l[i] = sum;
  }

  const int n_shares = share_count(a.DV);
  const long long stat = ((long long)c.b * a.H + c.h) * a.Sq;
  const long long stats = (long long)a.B * a.H * a.Sq;
  const long long o_row = (long long)a.H * a.DV;
  const long long o_at = ((long long)c.b * a.Sq + m0) * o_row +
                         (long long)c.h * a.DV + kBox * s.b0 + 4 * tm;
  float* o = parts == 1 ? a.out + o_at
                        : a.ws + c.p * (long long)a.B * a.Sq * o_row + o_at;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tn + 8 * i;
    if (m0 + r >= a.Sq) continue;
    const float inv = parts == 1 ? 1.f / fmaxf(l[i], 1e-30f) : 1.f;
#pragma unroll
    for (int q = 0; q < (NB + 1) / 2; ++q) {
      const int j = 2 * q + wg;
      if (j < n_o)
        *reinterpret_cast<float4*>(o + r * o_row + j * kBox) =
            scale4(acc[q][i], inv);
    }
    if (threadIdx.x >= 8) continue;  // one thread a row: warp 0, tm = 0
    const int qp = m0 + r;
    if (parts == 1) {
      const float ls = m[i] + log2f(fmaxf(l[i], 1e-30f));
      if (c.z == 0) a.lse[stat + qp] = ls;
      if (a.lse_chunks) a.lse_chunks[c.z * stats + stat + qp] = ls;
    } else {
      float* ms = a.ws + a.parts * (long long)a.B * a.Sq * o_row +
                  ((long long)c.p * n_shares + c.z) * stats;
      ms[stat + qp] = m[i];
      ms[(long long)a.parts * n_shares * stats + stat + qp] = l[i];
    }
  }
}

// The dQ sweep of CTA c over key tiles [kt0, kt1) for share s, whose
// output products read K from `k_out` (K offset to the share's first
// column); a query tile of `parts` parts writes dQ (times scale) itself
// (1) or its part's unscaled partials (more).
template <int NB>
__device__ __forceinline__ void dq_sweep(const Args& a, const Cta& c,
                                         int kt0, int kt1, const Share& s,
                                         const float* k_out, int parts,
                                         float* smem) {
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tn = lane & 7, tm = (warp & 3) * 4 + (lane >> 3);
  const int hk = c.h / (a.H / a.Hk);
  const int m0 = c.t * kQueries;
  const long long q_row = (long long)a.H * a.D;
  const long long o_row = (long long)a.H * a.DV;
  const long long k_row = (long long)a.Hk * a.D;
  const long long v_row = (long long)a.Hk * a.DV;
  const float* qg =
      a.q + ((long long)c.b * a.Sq + m0) * q_row + (long long)c.h * a.D;
  const float* dog =
      a.dout + ((long long)c.b * a.Sq + m0) * o_row + (long long)c.h * a.DV;
  const long long kv = (long long)c.b * a.Skv;
  const float* kg = a.k + kv * k_row + (long long)hk * a.D;
  const float* vg = a.v + kv * v_row + (long long)hk * a.DV;
  const float* ko = k_out + kv * k_row + (long long)hk * a.D;
  const int n_d = a.D / kBox;
  const int n_v = a.DV / kBox;
  const int n_l = n_d > n_v ? n_d : n_v;  // logit steps a key tile
  const int mine = wg ? n_v : n_d;
  const int n_o = s.nb;
  const int per_tile = n_l + (n_o + 1) / 2;
  const int q_valid = a.Sq - m0;
  float* sP = smem + 4 * kStages * kBoxFloats;
  float* sdS = sP + kBoxFloats;

  int p_step = 0, p_r = 0, p_t = kt0;
  auto load_next = [&]() {
    if (p_t < kt1) {
      float* slot = slot_of(smem, p_step);
      const int n0 = p_t * kDqKeys;
      if (p_r < n_l) {  // q_hat's and K's boxes, dO's and V's
        const int r = p_r;
        if (r < n_d) {
          load_box(slot, qg + r * kBox, q_row, q_valid);
          key_box(slot + kBoxFloats, kg + r * kBox, k_row, n0, a.Skv);
        }
        if (r < n_v) {
          load_box(slot + 2 * kBoxFloats, dog + r * kBox, o_row, q_valid);
          key_box(slot + 3 * kBoxFloats, vg + r * kBox, v_row, n0, a.Skv);
        }
      } else {  // K's boxes of two of dQ's boxes
        const int j = 2 * (p_r - n_l);
        key_box(slot + kBoxFloats, ko + j * kBox, k_row, n0, a.Skv);
        if (j + 1 < n_o)
          key_box(slot + 3 * kBoxFloats, ko + (j + 1) * kBox, k_row, n0,
                  a.Skv);
      }
      if (++p_r == per_tile) {
        p_r = 0;
        ++p_t;
      }
    }
    cp_async_commit();
    ++p_step;
  };

  // lse (warpgroup 0) or Delta (warpgroup 1) of this thread's rows.
  float stat[8];
  const long long st = ((long long)c.b * a.H + c.h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = m0 + tn + 8 * i;
    stat[i] = qp < a.Sq ? (wg ? a.delta : a.lse)[st + qp] : 0.f;
  }
  float4 acc[(NB + 1) / 2][8];
#pragma unroll
  for (int q = 0; q < (NB + 1) / 2; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[q][i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < kStages - 1; ++i) load_next();
  int step = 0;
  for (int t = kt0; t < kt1; ++t) {
    const int n0 = t * kDqKeys;
    float cc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cc[i][j] = 0.f;
    for (int x = 0; x < n_l; ++x) {
      const float* box =
          advance(smem, step++, load_next) + 2 * wg * kBoxFloats;
      if (x < mine) tile_dot(cc, box, box + kBoxFloats, tn, tm);
    }
    // P (warpgroup 0), then dS from it (warpgroup 1). Every thread
    // finished the last tile's output steps before this tile's first
    // barrier.
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sP[(tn + 8 * i) * kLd + tm + 16 * j] =
              live(a, m0 + tn + 8 * i, n0 + tm + 16 * j)
                  ? exp2f(cc[i][j] - stat[i])
                  : 0.f;
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (tn + 8 * i) * kLd + tm + 16 * j;
          sdS[at] = sP[at] * (cc[i][j] - stat[i]);
        }
    }
    // dS is read after the next step's barrier.
#pragma unroll
    for (int q = 0; q < (NB + 1) / 2; ++q) {
      if (2 * q < n_o) {
        const float* sl =
            advance(smem, step++, load_next) + (2 * wg + 1) * kBoxFloats;
        if (2 * q + wg < n_o) tile_out(acc[q], sdS, sl, tn, tm);
      }
    }
  }
  cp_async_wait<0>();

  const long long dq_at = ((long long)c.b * a.Sq + m0) * q_row +
                          (long long)c.h * a.D + kBox * s.b0 + 4 * tm;
  float* dq = parts == 1 ? a.out + dq_at
                         : a.ws + c.p * (long long)a.B * a.Sq * q_row + dq_at;
  const float f = parts == 1 ? a.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tn + 8 * i;
    if (m0 + r >= a.Sq) continue;
#pragma unroll
    for (int q = 0; q < (NB + 1) / 2; ++q) {
      const int j = 2 * q + wg;
      if (j < n_o)
        *reinterpret_cast<float4*>(dq + r * q_row + j * kBox) =
            scale4(acc[q][i], f);
    }
  }
}

// Parts of the query tile that holds element e (a float4 of row (b, qp,
// h) of an output `width` wide, tiles of `bn` keys), as the kernel cut it.
__device__ __forceinline__ int row_parts(const Args& a, long long e,
                                         int width, int bn) {
  const long long row = e / (width / 4);
  const int qp = (int)(row / a.H % a.Sq);
  int first, n;
  key_tiles(qp / kQueries * kQueries, bn, a.Skv, a.causal, a.window, &first,
            &n);
  return part_count(n, a.chunk);
}

// The forward's element e merged over parts [0, parts) in that order into
// O, and, at its share's first column, lse (share 0) and the share's copy.
__device__ __forceinline__ void merge_parts(const Args& a, long long e,
                                            int parts) {
  const long long row = e / (a.DV / 4);  // (b * Sq + qp) * H + h
  const int col = (int)(e % (a.DV / 4)) * 4;
  const int h = (int)(row % a.H);
  const int qp = (int)(row / a.H % a.Sq), b = (int)(row / a.H / a.Sq);
  const int n_shares = share_count(a.DV);
  int z = 0;
  Share s = share_of(a.DV, 0);
  while (col >= kBox * (s.b0 + s.nb)) s = share_of(a.DV, ++z);
  const long long plane = (long long)a.B * a.Sq * a.H * a.DV;
  const long long stats = (long long)a.B * a.H * a.Sq;
  const long long st = ((long long)b * a.H + h) * a.Sq + qp;
  const float* ms = a.ws + a.parts * plane + (long long)z * stats + st;
  const float* ls = ms + (long long)a.parts * n_shares * stats;
  const long long step = (long long)n_shares * stats;
  float mx = kNegInf;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ms[p * step]);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = a.ws + row * a.DV + col;
  for (int p = 0; p < parts; ++p) {
    const float w = exp2f(ms[p * step] - mx);
    const float4 x = *reinterpret_cast<const float4*>(src + p * plane);
    l += w * ls[p * step];
    o.x += w * x.x;
    o.y += w * x.y;
    o.z += w * x.z;
    o.w += w * x.w;
  }
  l = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(a.out + row * a.DV + col) = scale4(o, 1.f / l);
  if (col == kBox * s.b0) {
    const float lse = mx + log2f(l);
    if (z == 0) a.lse[st] = lse;
    if (a.lse_chunks) a.lse_chunks[z * stats + st] = lse;
  }
}

// dQ's element e summed over parts [0, parts) in that order, times scale.
__device__ __forceinline__ void sum_parts(const Args& a, long long e,
                                          int parts) {
  const long long plane = (long long)a.B * a.Sq * a.H * a.D;
  const float* src = a.ws + 4 * e;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * plane);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  *reinterpret_cast<float4*>(a.out + 4 * e) = scale4(s, a.scale);
}

// Launch `kernel` (grid: query tiles x parts x B * H x shares CTAs, the
// output `width` columns wide, key tiles of `bn` keys) and, for parts > 1,
// the second pass `pass` on the same stream. Sets a.chunk from a.parts:
// the most loaded query tile's key tiles over parts, rounded up.
template <typename Kernel, typename Pass>
inline cudaError_t launch(Kernel kernel, Pass pass, Args a, int bn,
                          int width, cudaStream_t st) {
  if (a.parts < 1 || (a.parts > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  const int q_tiles = cdiv(a.Sq, kQueries);
  int most = 0;
  for (int t = 0; t < q_tiles; ++t) {
    int first, n;
    key_tiles(t * kQueries, bn, a.Skv, a.causal, a.window, &first, &n);
    if (n > most) most = n;
  }
  a.chunk = most > a.parts ? cdiv(most, a.parts) : 1;
  const long long ctas =
      (long long)q_tiles * a.parts * a.B * a.H * share_count(width);
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
  const long long n4 = (long long)a.B * a.Sq * a.H * (width / 4);
  long long blocks = (n4 + kSumThreads - 1) / kSumThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // a grid-stride loop past it
  pass<<<(unsigned)blocks, kSumThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace fwd_dq_f32
