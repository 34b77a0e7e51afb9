// The f32 flash-attention kernels' shared pieces, for the H100's CUDA cores
// (sm_90a), hand-written CUDA C++: the 64 x 64 box products on 8 x 4
// register tiles, the cp.async loads of a box and the ring that feeds them,
// and the cut helpers. flash_dkv_f32.cuh (dK, dV) and flash_fwd_dq_f32.cuh
// (O, dQ) build their sweeps from them.
//
// Bound on the H100. Exact f32 (TF32 misses the 1e-5 tile limit) runs on
// the CUDA cores: 67 TFLOP/s, 128 FMA a clock an SM. What keeps a kernel
// from that rate is shared memory: an SM's shared memory fills one warp
// register a clock against four FFMA a clock, so a register tile of m x n,
// which needs (m + n) / mn fills a FMA, caps the FMA rate at
// 1 / (4 (m + n) / mn): 50% at 4 x 4, 67% at 8 x 4.
//
// Two warpgroups, 8 x 4 register tiles: a thread owns 8 x 4 of each 64 x 64
// tile (rows tn + 8 i, columns tm + 16 j of a logit tile; rows tn + 8 i,
// columns 4 tm .. 4 tm + 3 of an output box), reading its operands as
// float4: 12 reads a thread per 128 FMA. Rows sit kLd = 68 floats apart,
// so the 8 threads of a quarter warp read 8 rows in 32 banks, or one row by
// broadcast. Every operand comes in 64 x 64 boxes by cp.async into kStages
// ring slots of four boxes (four 16-byte copies a thread a box; rows past
// the end zero-filled, so 0 * NaN never enters a product): the next step's
// boxes load while this step's products run, one barrier a step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_f32 {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kBox = 64;          // columns of a streamed box
constexpr int kLd = kBox + 4;     // row stride of a box in shared memory
constexpr int kBoxFloats = 64 * kLd;
constexpr int kStages = 2;        // ring slots, four boxes each
constexpr int kMaxBoxes = 8;      // output boxes a CTA: 512 columns
constexpr int kSumThreads = 256;  // a second pass's block

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sweep parts of a tile of `units` units of work (pairs, key tiles): at
// least one, which writes zeros where the tile has none.
__host__ __device__ inline int part_count(int units, int chunk) {
  return units > chunk ? cdiv(units, chunk) : 1;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 64 x 64 box from `src` (row stride `stride` floats) into `dst`; rows
// at or past `valid` are zero-filled (and `src` itself is the only address
// handed over for them).
__device__ __forceinline__ void load_box(float* dst, const float* src,
                                         long long stride, int valid) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int c = threadIdx.x + x * kThreads;
    const int r = c >> 4, col = (c & 15) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * kLd + col, src + (ok ? r * stride : 0) + col, ok);
  }
}

// Ring slot of step i.
__device__ __forceinline__ float* slot_of(float* smem, int i) {
  return smem + (i % kStages) * 4 * kBoxFloats;
}

// Step i of a ring whose `load_next` loads the next step's boxes into its
// slot, then commits one group (an empty one past the last step, so the
// wait counts the same every step): wait for step i's boxes; every thread
// is then past step i - 1, so its slot takes step i + kStages - 1's.
// Returns step i's slot.
template <typename Load>
__device__ __forceinline__ const float* advance(float* smem, int i,
                                                Load& load_next) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  load_next();
  return slot_of(smem, i);
}

// c[i][j] += sum_w A[tn + 8 i][w] * B[tm + 16 j][w] over the box's 64
// columns, w in order.
__device__ __forceinline__ void tile_dot(float (&c)[8][4], const float* A,
                                         const float* B, int tn, int tm) {
  const float* a0 = A + tn * kLd;
  const float* b0 = B + tm * kLd;
#pragma unroll 2
  for (int w = 0; w < kBox; w += 4) {
    float4 y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * kLd + w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(a0 + 8 * i * kLd + w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = c[i][j];
        v = fmaf(x.x, y[j].x, v);
        v = fmaf(x.y, y[j].y, v);
        v = fmaf(x.z, y[j].z, v);
        v = fmaf(x.w, y[j].w, v);
        c[i][j] = v;
      }
    }
  }
}

// acc[i] += sum_m S[tn + 8 i][m] * Z[m][4 tm .. 4 tm + 3] over the tile's
// 64 rows m of Z, in order (S: a probability or dS tile; Z: a box of the
// operand the output multiplies).
__device__ __forceinline__ void tile_out(float4 (&acc)[8], const float* S,
                                         const float* Z, int tn, int tm) {
  const float* s0 = S + tn * kLd;
  const float* z0 = Z + 4 * tm;
#pragma unroll 2
  for (int m = 0; m < 64; m += 4) {
    float4 z[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      z[r] = *reinterpret_cast<const float4*>(z0 + (m + r) * kLd);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(s0 + 8 * i * kLd + m);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i].x = fmaf(pv[r], z[r].x, acc[i].x);
        acc[i].y = fmaf(pv[r], z[r].y, acc[i].y);
        acc[i].z = fmaf(pv[r], z[r].z, acc[i].z);
        acc[i].w = fmaf(pv[r], z[r].w, acc[i].w);
      }
    }
  }
}

}  // namespace flash_f32
