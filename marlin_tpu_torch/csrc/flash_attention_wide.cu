// Flash attention at head dims above 256, forward and backward, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// The wide counterparts of flash_attention_fwd.cu (B3) and
// flash_attention_bwd.cu (B4, B5), which are built for D and Dv up to 256:
// the reference (marlin_tpu/ops/flash_attention.py, _kernel and
// _bwd_dq_kernel / _bwd_dkv_kernel) zero-pads D and Dv to its 128-lane tile
// and takes any width, and so does the port through these kernels. The
// wrapper zero-pads D and Dv each to a multiple of 64 and calls them when
// either is above 256; zero columns change neither q_hat K^T, P V nor
// Delta. Same contract as the narrow kernels: base-2 softmax on the
// prescaled q_hat, -1e30 masks (never -inf), keys at or past Skv masked,
// causal k <= q, a window k > q - window, whole tiles outside the band
// skipped, GQA by index (K and V never replicated), l clamped at 1e-30,
// lse = m + log2(l) in (B, H, Sq) f32, dQ = scale * dS K, dK = ln2 * dS^T
// q_hat, dV = P^T dO summed over the KV head's group. No atomics are used:
// a CTA writes only its own outputs, or (the bf16 dK/dV with its group
// split, an f32 tile of several sweep parts) its own f32 partials, which a
// second pass merges in a fixed order, so O, lse, dQ, dK and dV come out
// bitwise the same run after run.
//
// Bound on the H100. At D = Dv = 512, S = 4096, causal, the forward runs
// 2 (D + Dv) FLOP, dQ 2 (2 D + Dv) and dK/dV 2 (2 D + 2 Dv) FLOP per live
// (q, k) pair, some 1000 FLOP per byte of their inputs and outputs: the
// tensor-core rate (989 TFLOP/s bf16) bounds them, and only wgmma reaches
// it.
//
// bf16 (flash_fwd_wide_bf16, flash_bwd_dq_wide_bf16,
// flash_bwd_dkv_wide_bf16): wgmma fed by TMA through an mbarrier ring
// (pieces in sm90.cuh).
//   * A CTA owns 64 rows (query rows for O and dQ, keys for dK and dV) and
//     up to 640 of the output's columns in 64-column boxes: a producer
//     warpgroup, whose one thread issues every TMA load (setmaxnreg hands
//     the rest of its registers on), and two consumer warpgroups. The
//     first consumer owns ceil(n / 2) of the CTA's n boxes, the second the
//     rest, each in an f32 accumulator of at most 160 registers. A wider
//     output splits over CTAs as evenly as whole boxes allow (D = 1024:
//     two CTAs of 512 columns), each of them computing the logits again.
//     dK/dV's parts of a key tile are dK's column shares, then dV's: a dV
//     part computes only S^T and adds P^T dO; a dK part also dP^T, and
//     adds dS^T q_hat (S^T twice in all: 1.25 times the counted FLOP at
//     D = Dv).
//   * The logits S = q_hat K^T (dQ: and dP = dO V^T; dK/dV: S^T = K q_hat^T
//     and dP^T = V dO^T) are computed once per (query tile, key tile) per
//     CTA: each consumer takes half of the tile's partners (SS wgmma,
//     m64n64k16 on the forward's 128-key tile, m64n32k16 on dQ's and a dV
//     part's 64-wide tiles: 160 accumulator registers leave no room for 64
//     of both S and dP), accumulated over D (Dv) in 64-column chunks; a dK
//     part's consumer 0 computes all of S^T and consumer 1 all of dP^T
//     (m64n64k16, a third less shared memory read per FLOP and half the
//     instructions), and each hands the other half of its columns over in
//     f32. The forward's online softmax trades each half's row max, and at
//     the end its row sum, through shared memory: both halves rescale by
//     one factor. P (dS; dK/dV: P^T or dS^T), rounded to bf16, goes to one
//     shared tile in the layout of TMA's 128-byte swizzle, and each
//     consumer adds P V (dS K; P^T dO or dS^T q_hat) into its own column
//     boxes, V (K; dO or q_hat) read as the MN-major B, two adjacent boxes
//     as one n128 product.
//   * Everything streams through one ring (a "full" mbarrier per slot
//     counting TMA bytes, an "empty" one that the 8 consumer warps arrive
//     on once their wgmma reading it have retired), in the order both
//     sides walk: per key tile the D/64 K boxes, then the output's V boxes
//     (dQ: the Dv/64 V boxes for dP, then the K boxes of dQ's own columns
//     once more; dK/dV, per query tile: the D/64 q_hat boxes, in a dK part
//     each slot's beside the dO boxes of the same columns, then the part's
//     own q_hat or dO boxes once more), the two consumers' groups of boxes
//     of the output interleaved. A slot holds a group
//     of boxes (2 for the forward, 4 for dQ, 4 or 2 for dK/dV): the ring's
//     waits, frees and wgmma groups cost the same for a group as for one
//     box, and they, not the bytes, bound a kernel that waits for every
//     box (PERF.md). The CTA's fixed tiles (q_hat and dO; dK/dV: K, and for
//     a dK part V) stay resident in shared memory where they leave room
//     for at least four slots; otherwise (the forward above D = 640, dQ
//     above D + Dv = 704, a dK part above D + Dv = 1088) their 64 x 64
//     chunks ride in the slots beside the streamed boxes. The ring takes
//     what is left of the 227 KB, up to 16 slots, so shared memory does
//     not grow with the head dim beyond the resident tiles.
//   * A consumer keeps one wgmma group in flight: it issues group i, then
//     frees group i - 1's slot once that group has retired.
//   * dK/dV walks the query heads of its KV head's group, each head's live
//     query tiles in turn (query_range). Where B x Hk x key tiles x parts
//     CTAs would not fill two waves of the card, the wrapper splits the
//     group into G equal parts (MLA, one KV head of 16 query heads: G = 4),
//     each a CTA that stores f32 partial sums; flash_dkv_group_sum adds
//     them in part order and rounds once. Every streamed q_hat or dO box
//     comes from L2 once per key tile that reads it (some 65 FLOP per
//     byte), but the time goes to the consumers' chain, not to the loads
//     (PERF.md); lse and Delta are read a query tile ahead of their use.
// They have no ping-pong of two tiles per warpgroup and no TMA multicast
// across a cluster; those are the next steps toward the bound.
//
// f32 (flash_fwd_wide_f32, flash_bwd_dq_wide_f32, flash_bwd_dkv_wide_f32):
// register-tiled FMA on the CUDA cores fed by a cp.async ring, up to 512
// output columns a CTA, each tile's sweep split into parts by its live
// work and merged or summed by a second pass in part order. The forward
// and dQ are built from flash_fwd_dq_f32.cuh (a CTA owns 64 query rows),
// the dK/dV from flash_dkv_f32.cuh (64 keys); both headers hold the design.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_dkv_f32.cuh"
#include "flash_fwd_dq_f32.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr float kLn2 = 0.693147180559945309f;

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

// ---------------------------------------------------------------------
// f32: the forward, dQ and dK/dV on the CUDA cores
// ---------------------------------------------------------------------

// B3, wide, f32 (flash_fwd_dq_f32.cuh holds the design and its pieces): a
// CTA's query tile, its sweep part's key tiles and its share of O's
// columns are cut here.
__global__ void __launch_bounds__(flash_f32::kThreads, 1)
flash_fwd_wide_f32(const fwd_dq_f32::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const fwd_dq_f32::Cta c =
      fwd_dq_f32::cta_of(a, fwd_dq_f32::share_count(a.DV));
  int first, n;
  fwd_dq_f32::key_tiles(c.t * fwd_dq_f32::kQueries, fwd_dq_f32::kFwdKeys,
                        a.Skv, a.causal, a.window, &first, &n);
  const int parts = flash_f32::part_count(n, a.chunk);
  if (c.p >= parts) return;
  const int kt0 = first + c.p * a.chunk;
  const int kt1 = min(kt0 + a.chunk, first + n);
  const fwd_dq_f32::Share s = fwd_dq_f32::share_of(a.DV, c.z);
  fwd_dq_f32::fwd_sweep<flash_f32::kMaxBoxes>(
      a, c, kt0, kt1, s, a.v + flash_f32::kBox * s.b0, parts,
      reinterpret_cast<float*>(smem_raw));
}

// The wide f32 forward's second pass where a query tile has several parts:
// their O, m and l merged in part order (a float4 of one row a step).
__global__ void __launch_bounds__(flash_f32::kSumThreads)
flash_fwd_merge_f32(const fwd_dq_f32::Args a) {
  const long long n = (long long)a.B * a.Sq * a.H * (a.DV / 4);
  for (long long e = blockIdx.x * (long long)flash_f32::kSumThreads +
                     threadIdx.x;
       e < n; e += (long long)gridDim.x * flash_f32::kSumThreads) {
    const int parts =
        fwd_dq_f32::row_parts(a, e, a.DV, fwd_dq_f32::kFwdKeys);
    if (parts > 1) fwd_dq_f32::merge_parts(a, e, parts);
  }
}

// B4, wide, f32: a CTA's query tile, its sweep part's key tiles and its
// share of dQ's columns.
__global__ void __launch_bounds__(flash_f32::kThreads, 1)
flash_bwd_dq_wide_f32(const fwd_dq_f32::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const fwd_dq_f32::Cta c =
      fwd_dq_f32::cta_of(a, fwd_dq_f32::share_count(a.D));
  int first, n;
  fwd_dq_f32::key_tiles(c.t * fwd_dq_f32::kQueries, fwd_dq_f32::kDqKeys,
                        a.Skv, a.causal, a.window, &first, &n);
  const int parts = flash_f32::part_count(n, a.chunk);
  if (c.p >= parts) return;
  const int kt0 = first + c.p * a.chunk;
  const int kt1 = min(kt0 + a.chunk, first + n);
  const fwd_dq_f32::Share s = fwd_dq_f32::share_of(a.D, c.z);
  fwd_dq_f32::dq_sweep<flash_f32::kMaxBoxes>(
      a, c, kt0, kt1, s, a.k + flash_f32::kBox * s.b0, parts,
      reinterpret_cast<float*>(smem_raw));
}

// The wide f32 dQ's second pass where a query tile has several parts:
// their partial sums added in part order, times scale.
__global__ void __launch_bounds__(flash_f32::kSumThreads)
flash_dq_part_sum_f32(const fwd_dq_f32::Args a) {
  const long long n = (long long)a.B * a.Sq * a.H * (a.D / 4);
  for (long long e = blockIdx.x * (long long)flash_f32::kSumThreads +
                     threadIdx.x;
       e < n; e += (long long)gridDim.x * flash_f32::kSumThreads) {
    const int parts = fwd_dq_f32::row_parts(a, e, a.D, fwd_dq_f32::kDqKeys);
    if (parts > 1) fwd_dq_f32::sum_parts(a, e, parts);
  }
}

// B5, wide, f32 (flash_dkv_f32.cuh holds the design and its pieces): a
// CTA's column share is all of dK and dV where D + DV <= 512, else one of
// dK's shares, then dV's; the CTA's key tile, its sweep part's pairs, its
// share and where they go are cut here.
__global__ void __launch_bounds__(dkv_f32::kThreads, 1)
flash_bwd_dkv_wide_f32(const dkv_f32::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const dkv_f32::Cta c = dkv_f32::cta_of(a, dkv_f32::share_count(a.D, a.DV));
  int tile0, n_qt;
  dkv_f32::query_tiles(c.t * dkv_f32::kKeys, a.Sq, a.causal, a.window,
                       &tile0, &n_qt);
  const int pairs = a.H / a.Hk * n_qt;  // (query head, query tile), head-major
  const int parts = dkv_f32::part_count(pairs, a.chunk);
  if (c.p >= parts) return;
  const int first = c.p * a.chunk;
  const int last = min(first + a.chunk, pairs);
  const dkv_f32::Share s = dkv_f32::share_of(a.D, a.DV, c.z);
  dkv_f32::sweep<dkv_f32::kMaxBoxes>(
      a, c, tile0, n_qt, first, last, s, a.q + dkv_f32::kBox * s.dk0,
      a.dout + dkv_f32::kBox * s.dv0, dkv_f32::dest_of(a, c, parts),
      reinterpret_cast<float*>(smem_raw));
}

// The wide f32 dK/dV's second pass where a key tile has several parts:
// their partial sums added in part order (a float4 of one row a step).
__global__ void __launch_bounds__(dkv_f32::kSumThreads)
flash_dkv_part_sum_f32(const dkv_f32::Args a) {
  const long long n = (long long)a.B * a.Skv * a.Hk * ((a.D + a.DV) / 4);
  for (long long e = blockIdx.x * (long long)dkv_f32::kSumThreads +
                     threadIdx.x;
       e < n; e += (long long)gridDim.x * dkv_f32::kSumThreads) {
    const int parts = dkv_f32::row_parts(a, e);
    if (parts > 1) dkv_f32::sum_parts(a, e, parts);
  }
}

// ---------------------------------------------------------------------
// bf16 forward and dQ: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------

constexpr int kQRows = 64;    // query rows per CTA
constexpr int kFwdBN = 128;   // keys per forward tile, 64 per consumer
constexpr int kDqBN = 64;     // keys per dQ tile, 32 per consumer
constexpr int kFwdGroup = 2;  // 64-column boxes a forward ring slot holds
constexpr int kDqGroup = 4;   // and a dQ ring slot
constexpr int kMaxBoxes = 5;  // 64-column output boxes per consumer
static_assert(kFwdGroup % 2 == 0 && kDqGroup % 2 == 0,
              "a group's boxes pair up into n128 products from its first");
constexpr int kMaxStages = 16;         // ring slots at most
// Ring slots at least: a consumer keeps its last group's slot until its
// next group's wgmma are issued, and between the two it waits for and
// frees the other consumer's group, so its next group is two slots on; with
// two slots that is the slot it still holds, and the ring stops.
constexpr int kMinStages = 3;
constexpr int kMinResidentStages = 4;  // slots beside resident q_hat, dO
static_assert(kMinResidentStages >= kMinStages, "a resident ring moves");
constexpr int kBf16Threads = 384;      // the producer and two consumers
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr int kChunk = kQRows * 128;   // bytes of a 64 x 64 bf16 box

// CTAs on grid z for an output `width` columns wide (a multiple of 64):
// at most 2 * kMaxBoxes boxes a CTA.
__host__ __device__ inline int out_chunks(int width) {
  return (width / 64 + 2 * kMaxBoxes - 1) / (2 * kMaxBoxes);
}

// A CTA's share of the output on grid z: the boxes [first, first + n[0] +
// n[1]), the first n[0] consumer 0's and the next n[1] consumer 1's. Each
// consumer's boxes stream in groups of G (a ring slot each, the last group
// holding the rest), the two consumers' groups interleaved: the CTA's u-th
// group is consumer (u & 1)'s (u >> 1)-th. n[0] is n[1] or n[1] + 1, so
// consumer 0 never has fewer groups, and its odd one out comes last.
struct OutSplit {
  int first, n[2];
  __host__ __device__ OutSplit(int width, int z) {
    const int nbox = width / 64, chunks = out_chunks(width);
    first = z * nbox / chunks;
    const int count = (z + 1) * nbox / chunks - first;
    n[0] = (count + 1) / 2;
    n[1] = count / 2;
  }
  // The first output column of consumer `w`'s box `x`.
  __host__ __device__ int col(int w, int x) const {
    return (first + w * n[0] + x) * 64;
  }
  // Groups of G boxes of both consumers.
  __host__ __device__ int groups(int G) const {
    return (n[0] + G - 1) / G + (n[1] + G - 1) / G;
  }
};

// A walk of the ring: the slot of the next group and the parity of its
// round (slot s's n-th fill, n from 0, completes phase n of full[s] and
// the n-th release phase n of empty[s]).
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
  __device__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// The ring: `stages` slots of `slot_bytes` from `base`.
struct Ring {
  unsigned char* base;
  int slot_bytes, stages;
  uint64_t* full;
  uint64_t* empty;

  __device__ unsigned char* at(int s) const { return base + s * slot_bytes; }
  // Producer: wait until the slot at `p` is free (in its first round it
  // is: a fresh barrier reads its phase "-1" as complete) and tell its
  // full barrier the bytes coming.
  __device__ void acquire(const RingPos& p, uint32_t bytes) const {
    sm90::mbar_wait(&empty[p.s], p.phase ^ 1);
    sm90::mbar_arrive_expect_tx(&full[p.s], bytes);
  }
  // Consumer: wait until the group at `p` has landed.
  __device__ void wait(const RingPos& p) const {
    sm90::mbar_wait(&full[p.s], p.phase);
  }
  // Consumer warp: its reads of slot s have retired.
  __device__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&empty[s]);
  }
  __device__ void init() const {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
  }
};

// Byte offsets into the forward's (1024-aligned) dynamic shared memory:
// P (64 x 128 keys, bf16: two 64 x 64 boxes, one per consumer), q_hat's
// D / 64 chunks when resident, the ring (a slot: kFwdGroup 128-key K or V
// boxes and, when q_hat is not resident, kFwdGroup q_hat chunks after
// them), the consumers' row maxima and sums (2 x 64 f32 each), the
// barriers.
struct FwdLayout {
  int p, q, ring, slot, stats, bars, bytes;
  __host__ __device__ FwdLayout(int D, int stages, int resident)
      : p(0),
        q(2 * kChunk),
        ring(q + (resident ? D / 64 * kChunk : 0)),
        slot(kFwdGroup * (kFwdBN * 128 + (resident ? 0 : kChunk))),
        stats(ring + stages * slot),
        bars(stats + 4 * kQRows * (int)sizeof(float)),
        bytes(bars + 8 * (2 * stages + 1) + 1024) {}
};

// The same for dQ: dS (64 x 64 keys, bf16, one box), q_hat's and dO's
// chunks when resident, the ring (kDqGroup 64-key K or V boxes and, when
// not resident, as many q_hat or dO chunks), the barriers.
struct DqLayout {
  int ds, q, o, ring, slot, bars, bytes;
  __host__ __device__ DqLayout(int D, int DV, int stages, int resident)
      : ds(0),
        q(kChunk),
        o(q + (resident ? D / 64 * kChunk : 0)),
        ring(o + (resident ? DV / 64 * kChunk : 0)),
        slot(kDqGroup * (kDqBN * 128 + (resident ? 0 : kChunk))),
        bars(ring + stages * slot),
        bytes(bars + 8 * (2 * stages + 1) + 1024) {}
};

// Byte offset of the bf16 pair at (row, column 2 t of n8-tile `chunk`) of
// a 64 x 64 box in the 128-byte-swizzled layout that TMA writes and the
// K-major wgmma descriptor reads.
__device__ __forceinline__ int swizzled(int row, int chunk, int t) {
  return row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t;
}

// B3, wide, bf16: one CTA per (b, h, 64 query rows, output chunk); the
// query tiles on grid y (causal: heaviest first), B * H on grid x.
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_wide_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    float* __restrict__ lse_chunks, int H, int Hk, int Sq,
                    int Skv, int D, int DV, int causal, int window,
                    int stages, int resident) {
  constexpr int G = kFwdGroup;
  constexpr uint32_t kv = kFwdBN * 128;  // bytes of a K or V box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const FwdLayout L(D, stages, resident);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  const Ring ring{smem + L.ring, L.slot, stages, full, full + stages};
  uint64_t* qbar = full + 2 * stages;
  float* stats = reinterpret_cast<float*>(smem + L.stats);

  const int mt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int m0 = mt * kQRows;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const OutSplit sp(DV, blockIdx.z);
  const int nd = D / 64, nu = sp.groups(G);
  int lo, hi;
  key_range(m0, kQRows, kFwdBN, Skv, causal, window, &lo, &hi);
  const int n_tiles = hi > lo ? (hi - lo + kFwdBN - 1) / kFwdBN : 0;

  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(qbar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread loads
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    if (resident) {
      sm90::mbar_arrive_expect_tx(qbar, nd * kChunk);
      for (int c = 0; c < nd; ++c)
        sm90::tma_load_4d(smem + L.q + c * kChunk, &tq, qbar, c * 64, h, m0,
                          b);
    }
    RingPos p;
    for (int j = 0; j < n_tiles; ++j) {
      const int n0 = lo + j * kFwdBN;
      for (int c0 = 0; c0 < nd; c0 += G, p.next(stages)) {
        const int gb = min(G, nd - c0);
        ring.acquire(p, gb * (resident ? kv : kv + kChunk));
        unsigned char* dst = ring.at(p.s);
        for (int x = 0; x < gb; ++x) {
          sm90::tma_load_4d(dst + x * kv, &tk, &full[p.s], (c0 + x) * 64, hk,
                            n0, b);
          if (!resident)
            sm90::tma_load_4d(dst + G * kv + x * kChunk, &tq, &full[p.s],
                              (c0 + x) * 64, h, m0, b);
        }
      }
      for (int u = 0; u < nu; ++u, p.next(stages)) {
        const int w = u & 1, x0 = (u >> 1) * G;
        const int gb = min(G, sp.n[w] - x0);
        ring.acquire(p, gb * kv);
        for (int x = 0; x < gb; ++x)
          sm90::tma_load_4d(ring.at(p.s) + x * kv, &tv, &full[p.s],
                            sp.col(w, x0 + x), hk, n0, b);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row in the warp's 16 (and + 8)
  const int t = lane % 4;  // accumulator column pair
  const int row0 = warp * 16 + g;  // this thread's rows row0, row0 + 8
  const int qp0 = m0 + row0;
  const int kw = w * kFwdBN / 2;  // this consumer's first key of a tile
  const int mine = sp.n[w];
  const uint32_t p_base = sm90::smem_u32(smem + L.p);
  const uint32_t q_base = sm90::smem_u32(smem + L.q);

  float mrow[2] = {kNegInf, kNegInf};
  float lrow[2] = {0.f, 0.f};  // this thread's partial sums of its keys
  float acc[kMaxBoxes * 32];   // O: this consumer's boxes, 32 f32 a box
#pragma unroll
  for (int e = 0; e < kMaxBoxes * 32; ++e) acc[e] = 0.f;

  if (resident) sm90::mbar_wait(qbar, 0);  // even with no key tile
  RingPos p;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = lo + j * kFwdBN;

    // S = q_hat K^T over this consumer's 64 keys: groups of G K boxes of
    // four k16 steps each, one wgmma group a slot.
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
    int pend = -1;
    for (int c0 = 0; c0 < nd; c0 += G, p.next(stages)) {
      ring.wait(p);
      const uint32_t slot = sm90::smem_u32(ring.at(p.s));
#pragma unroll
      for (int x = 0; x < G; ++x) {
        if (c0 + x >= nd) break;
        const uint32_t a =
            resident ? q_base + (c0 + x) * kChunk : slot + G * kv + x * kChunk;
        const uint32_t bk = slot + x * kv + kw * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<0>(sc, sm90::desc_sw128(a + kk * 32, 16, 1024),
                            sm90::desc_sw128(bk + kk * 32, 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pend >= 0) ring.release(pend);
      pend = p.s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    ring.release(pend);

    // Per-element masks only where the tile straddles an edge.
    const bool edge = n0 + kFwdBN > Skv ||
                      (causal && n0 + kFwdBN - 1 > m0) ||
                      (window && n0 <= m0 + kQRows - 1 - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = n0 + kw + nt * 8 + 2 * t + (e & 1);
          if (!key_live(qp0 + 8 * (e >> 1), kp, Skv, causal, window))
            sc[nt * 4 + e] = kNegInf;
        }
      }
    }

    // Online softmax in base 2: the row max over both consumers' keys.
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    }
    if (t == 0) {
      stats[w * kQRows + row0] = mx[0];
      stats[w * kQRows + row0 + 8] = mx[1];
    }
    // Both maxima written; both consumers' P V of the last tile retired.
    sm90::named_barrier(1, kConsumerThreads);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn =
          fmaxf(mx[r], stats[(1 - w) * kQRows + row0 + 8 * r]);
      corr[r] = exp2f(mrow[r] - mn);
      mrow[r] = mn;
      lrow[r] *= corr[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = exp2f(sc[e] - mrow[(e >> 1) & 1]);
      lrow[(e >> 1) & 1] += sc[e];
    }
#pragma unroll
    for (int e = 0; e < kMaxBoxes * 32; ++e) acc[e] *= corr[(e >> 1) & 1];

    // P, rounded to bf16, into this consumer's box of the shared P tile.
    unsigned char* pt = smem + L.p + w * kChunk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(pt + swizzled(row0 + 8 * r, nt, t)) =
            sm90::pack_bf16(sc[nt * 4 + 2 * r], sc[nt * 4 + 2 * r + 1]);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(2, kConsumerThreads);  // the whole P tile written

    // O += P V for this consumer's boxes: P the K-major A (128 keys, 8 k16
    // steps), V the MN-major B (k16 step = 16 keys = 2048 bytes in). The
    // other consumer's groups are only waited for and released.
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    pend = -1;
    for (int u = 0; u < nu; ++u, p.next(stages)) {
      ring.wait(p);
      if ((u & 1) != w) {
        ring.release(p.s);
        continue;
      }
      const uint32_t slot = sm90::smem_u32(ring.at(p.s));
      const int x0 = (u >> 1) * G, gb = min(G, mine - x0);
#pragma unroll
      for (int x = 0; x < kMaxBoxes; x += 2) {
        // Boxes x and x + 1 (slot boxes x - x0 and the next, kv apart: the
        // LBO) as one n128 product where both are in the group, else x as
        // an n64 one. G is even, so a group starts on an even box.
        if (x < x0 || x >= x0 + gb) continue;
        const uint32_t vb = slot + (x - x0) * kv;
        if (x + 1 < kMaxBoxes && x + 1 < x0 + gb) {
          float(&d)[64] = *reinterpret_cast<float(*)[64]>(&acc[32 * x]);
#pragma unroll
          for (int kc = 0; kc < kFwdBN / 16; ++kc)
            sm90::wgmma_ss<1>(
                d,
                sm90::desc_sw128(p_base + (kc / 4) * kChunk + (kc % 4) * 32,
                                 16, 1024),
                sm90::desc_sw128(vb + kc * 16 * 128, kv, 1024), 1);
        } else {
          float(&d)[32] = *reinterpret_cast<float(*)[32]>(&acc[32 * x]);
#pragma unroll
          for (int kc = 0; kc < kFwdBN / 16; ++kc)
            sm90::wgmma_ss<1>(
                d,
                sm90::desc_sw128(p_base + (kc / 4) * kChunk + (kc % 4) * 32,
                                 16, 1024),
                sm90::desc_sw128(vb + kc * 16 * 128, kv, 1024), 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pend >= 0) ring.release(pend);
      pend = p.s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (pend >= 0) ring.release(pend);
  }

  // l over both consumers' keys: a + b == b + a, so both get the same.
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffff, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffff, lrow[r], 2);
  }
  if (t == 0) {
    stats[(2 + w) * kQRows + row0] = lrow[0];
    stats[(2 + w) * kQRows + row0 + 8] = lrow[1];
  }
  sm90::named_barrier(1, kConsumerThreads);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaxf(lrow[r] + stats[(3 - w) * kQRows + row0 + 8 * r], 1e-30f);

  const int col0 = sp.col(w, 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    if (qp >= Sq) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow =
        o + (((long long)b * Sq + qp) * H + h) * DV + col0 + 2 * t;
#pragma unroll
    for (int x = 0; x < kMaxBoxes; ++x) {
      if (x >= mine) break;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + x * 64 + nt * 8) =
            __floats2bfloat162_rn(acc[32 * x + nt * 4 + 2 * r] * inv,
                                  acc[32 * x + nt * 4 + 2 * r + 1] * inv);
    }
    if (w == 0 && t == 0) {
      const float ls = mrow[r] + log2f(l[r]);
      if (blockIdx.z == 0) lse[(long long)bh * Sq + qp] = ls;
      if (lse_chunks)
        lse_chunks[((long long)blockIdx.z * gridDim.x + bh) * Sq + qp] = ls;
    }
  }
}

// B4, wide, bf16: one CTA per (b, h, 64 query rows, chunk of dQ's
// columns), laid out on the grid as the forward. Per 64-key tile:
//   S = q_hat K^T, dP = dO V^T   SS wgmma, each consumer its 32 keys
//   dS = P (dP - Delta)          in registers, under the forward's masks,
//                                rounded to bf16 into the shared dS tile
//   dQ += dS K                   SS wgmma on the consumer's column boxes,
//                                K's boxes streamed again as MN-major B
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_wide_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Hk, int Sq,
                       int Skv, int D, int DV, int causal, int window,
                       float scale, int stages, int resident) {
  constexpr int G = kDqGroup;
  constexpr uint32_t kv = kDqBN * 128;  // bytes of a K or V box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const DqLayout L(D, DV, stages, resident);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  const Ring ring{smem + L.ring, L.slot, stages, full, full + stages};
  uint64_t* qbar = full + 2 * stages;

  const int mt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int m0 = mt * kQRows;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const OutSplit sp(D, blockIdx.z);
  const int nd = D / 64;
  const int ndv = DV / 64;
  const int nu = sp.groups(G);
  int lo, hi;
  key_range(m0, kQRows, kDqBN, Skv, causal, window, &lo, &hi);
  const int n_tiles = hi > lo ? (hi - lo + kDqBN - 1) / kDqBN : 0;

  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(qbar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread loads
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    if (resident) {
      sm90::mbar_arrive_expect_tx(qbar, (nd + ndv) * kChunk);
      for (int c = 0; c < nd; ++c)
        sm90::tma_load_4d(smem + L.q + c * kChunk, &tq, qbar, c * 64, h, m0,
                          b);
      for (int c = 0; c < ndv; ++c)
        sm90::tma_load_4d(smem + L.o + c * kChunk, &tdo, qbar, c * 64, h, m0,
                          b);
    }
    const uint32_t box = resident ? kv : kv + kChunk;
    RingPos p;
    for (int j = 0; j < n_tiles; ++j) {
      const int n0 = lo + j * kDqBN;
      for (int c0 = 0; c0 < nd; c0 += G, p.next(stages)) {
        const int gb = min(G, nd - c0);
        ring.acquire(p, gb * box);
        unsigned char* dst = ring.at(p.s);
        for (int x = 0; x < gb; ++x) {
          sm90::tma_load_4d(dst + x * kv, &tk, &full[p.s], (c0 + x) * 64, hk,
                            n0, b);
          if (!resident)
            sm90::tma_load_4d(dst + G * kv + x * kChunk, &tq, &full[p.s],
                              (c0 + x) * 64, h, m0, b);
        }
      }
      for (int c0 = 0; c0 < ndv; c0 += G, p.next(stages)) {
        const int gb = min(G, ndv - c0);
        ring.acquire(p, gb * box);
        unsigned char* dst = ring.at(p.s);
        for (int x = 0; x < gb; ++x) {
          sm90::tma_load_4d(dst + x * kv, &tv, &full[p.s], (c0 + x) * 64, hk,
                            n0, b);
          if (!resident)
            sm90::tma_load_4d(dst + G * kv + x * kChunk, &tdo, &full[p.s],
                              (c0 + x) * 64, h, m0, b);
        }
      }
      for (int u = 0; u < nu; ++u, p.next(stages)) {
        const int w = u & 1, x0 = (u >> 1) * G;
        const int gb = min(G, sp.n[w] - x0);
        ring.acquire(p, gb * kv);
        for (int x = 0; x < gb; ++x)
          sm90::tma_load_4d(ring.at(p.s) + x * kv, &tk, &full[p.s],
                            sp.col(w, x0 + x), hk, n0, b);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's rows row0, row0 + 8
  const int qp0 = m0 + row0;
  const int kw = w * kDqBN / 2;  // this consumer's first key of a tile
  const int mine = sp.n[w];
  const uint32_t ds_base = sm90::smem_u32(smem + L.ds);
  const uint32_t q_base = sm90::smem_u32(smem + L.q);
  const uint32_t o_base = sm90::smem_u32(smem + L.o);

  // lse and Delta of the thread's rows: plain loads, 0 past Sq.
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    lrow[r] = qp < Sq ? lse[(long long)bh * Sq + qp] : 0.f;
    drow[r] = qp < Sq ? delta[(long long)bh * Sq + qp] : 0.f;
  }
  float dqa[kMaxBoxes * 32];  // dQ: this consumer's boxes, 32 f32 a box
#pragma unroll
  for (int e = 0; e < kMaxBoxes * 32; ++e) dqa[e] = 0.f;

  if (resident) sm90::mbar_wait(qbar, 0);  // even with no key tile
  RingPos p;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = lo + j * kDqBN;

    // S = q_hat K^T and dP = dO V^T over this consumer's 32 keys, one
    // wgmma group a slot, one group kept in flight across both sweeps.
    float sc[16], dp[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = dp[e] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    int pend = -1;
    for (int c0 = 0; c0 < nd; c0 += G, p.next(stages)) {
      ring.wait(p);
      const uint32_t slot = sm90::smem_u32(ring.at(p.s));
#pragma unroll
      for (int x = 0; x < G; ++x) {
        if (c0 + x >= nd) break;
        const uint32_t a =
            resident ? q_base + (c0 + x) * kChunk : slot + G * kv + x * kChunk;
        const uint32_t bk = slot + x * kv + kw * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<0>(sc, sm90::desc_sw128(a + kk * 32, 16, 1024),
                            sm90::desc_sw128(bk + kk * 32, 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pend >= 0) ring.release(pend);
      pend = p.s;
    }
    for (int c0 = 0; c0 < ndv; c0 += G, p.next(stages)) {
      ring.wait(p);
      const uint32_t slot = sm90::smem_u32(ring.at(p.s));
#pragma unroll
      for (int x = 0; x < G; ++x) {
        if (c0 + x >= ndv) break;
        const uint32_t a =
            resident ? o_base + (c0 + x) * kChunk : slot + G * kv + x * kChunk;
        const uint32_t bv = slot + x * kv + kw * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<0>(dp, sm90::desc_sw128(a + kk * 32, 16, 1024),
                            sm90::desc_sw128(bv + kk * 32, 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      ring.release(pend);
      pend = p.s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    ring.release(pend);

    // dS = P (dP - Delta), P = exp2(S - lse); a dead pair (query past Sq,
    // key past Skv, causal or window) gets P = dS = 0 exactly. Masks only
    // where the tile straddles an edge.
    const bool edge = m0 + kQRows > Sq || n0 + kDqBN > Skv ||
                      (causal && n0 + kDqBN - 1 > m0) ||
                      (window && n0 <= m0 + kQRows - 1 - window);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = exp2f(sc[nt * 4 + e] - lrow[r]);
        if (edge) {
          const int qp = qp0 + 8 * r;
          const int kp = n0 + kw + nt * 8 + 2 * t + (e & 1);
          if (!(qp < Sq && key_live(qp, kp, Skv, causal, window))) pr = 0.f;
        }
        dp[nt * 4 + e] = pr * (dp[nt * 4 + e] - drow[r]);
      }
    }

    // dS, rounded to bf16, into this consumer's 32 columns of the shared
    // dS tile, once both consumers' dQ products of the last tile retired.
    sm90::named_barrier(1, kConsumerThreads);
    unsigned char* dst = smem + L.ds;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            dst + swizzled(row0 + 8 * r, kw / 8 + nt, t)) =
            sm90::pack_bf16(dp[nt * 4 + 2 * r], dp[nt * 4 + 2 * r + 1]);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(2, kConsumerThreads);  // the whole dS tile written

    // dQ += dS K for this consumer's boxes: dS the K-major A (64 keys, 4
    // k16 steps), K the MN-major B (k16 step = 16 keys = 2048 bytes in).
    sm90::fence_regs(dqa);
    sm90::wgmma_fence();
    pend = -1;
    for (int u = 0; u < nu; ++u, p.next(stages)) {
      ring.wait(p);
      if ((u & 1) != w) {
        ring.release(p.s);
        continue;
      }
      const uint32_t slot = sm90::smem_u32(ring.at(p.s));
      const int x0 = (u >> 1) * G, gb = min(G, mine - x0);
#pragma unroll
      for (int x = 0; x < kMaxBoxes; x += 2) {
        // Boxes x and x + 1 as one n128 product where both are in the
        // group, else x as an n64 one (as in the forward's P V).
        if (x < x0 || x >= x0 + gb) continue;
        const uint32_t kb = slot + (x - x0) * kv;
        if (x + 1 < kMaxBoxes && x + 1 < x0 + gb) {
          float(&d)[64] = *reinterpret_cast<float(*)[64]>(&dqa[32 * x]);
#pragma unroll
          for (int kc = 0; kc < kDqBN / 16; ++kc)
            sm90::wgmma_ss<1>(d,
                              sm90::desc_sw128(ds_base + kc * 32, 16, 1024),
                              sm90::desc_sw128(kb + kc * 16 * 128, kv, 1024),
                              1);
        } else {
          float(&d)[32] = *reinterpret_cast<float(*)[32]>(&dqa[32 * x]);
#pragma unroll
          for (int kc = 0; kc < kDqBN / 16; ++kc)
            sm90::wgmma_ss<1>(d,
                              sm90::desc_sw128(ds_base + kc * 32, 16, 1024),
                              sm90::desc_sw128(kb + kc * 16 * 128, kv, 1024),
                              1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pend >= 0) ring.release(pend);
      pend = p.s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dqa);
    if (pend >= 0) ring.release(pend);
  }

  const int col0 = sp.col(w, 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* row =
        dq + (((long long)b * Sq + qp) * H + h) * D + col0 + 2 * t;
#pragma unroll
    for (int x = 0; x < kMaxBoxes; ++x) {
      if (x >= mine) break;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(row + x * 64 + nt * 8) =
            __floats2bfloat162_rn(dqa[32 * x + nt * 4 + 2 * r] * scale,
                                  dqa[32 * x + nt * 4 + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 dK/dV: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------

constexpr int kDkvKeys = 64;      // keys per CTA
constexpr int kDkvBM = 64;        // queries per streamed tile, 32 a consumer
constexpr int kDkvMaxGroup = 4;   // 64-column boxes a ring slot holds at most
constexpr int kSumThreads = 256;  // the group sum's block

// One role's ring: slots, whether K (and V) are resident, boxes a slot.
struct RingCfg {
  int stages, resident, group;
};
// The dK parts' ring (r[0]) and the dV parts' (r[1]).
struct DkvRings {
  RingCfg r[2];
};

// A key tile's parts: out_chunks(D) dK parts, then out_chunks(DV) dV
// parts, each a CTA that owns its OutSplit of dK's (dV's) columns.
struct DkvPart {
  bool dk;
  OutSplit sp;
  __host__ __device__ DkvPart(int D, int DV, int z)
      : dk(z < out_chunks(D)),
        sp(dk ? D : DV, dk ? z : z - out_chunks(D)) {}
};

// Byte offsets into the dK/dV kernel's (1024-aligned) dynamic shared
// memory for a part of role `dk`: P^T or dS^T (64 keys x 64 queries, bf16,
// one box), (dK part) the consumers' handover of half their logits in f32
// (2 x 8 KB), K's D / 64 boxes and (dK part) V's DV / 64 when resident, the
// ring (a slot: `group` q_hat or dO boxes and, when K and V are not
// resident, as many K or V boxes after them), the barriers.
struct DkvLayout {
  int ds, xchg, k, v, ring, slot, bars, bytes;
  __host__ __device__ DkvLayout(int D, int DV, bool dk, int stages,
                                int resident, int group)
      : ds(0),
        xchg(kChunk),
        k(xchg + (dk ? 2 * kChunk : 0)),
        v(k + (resident ? D / 64 * kChunk : 0)),
        ring(v + (resident && dk ? DV / 64 * kChunk : 0)),
        slot(group * kChunk * (resident ? 1 : 2)),
        bars(ring + stages * slot),
        bytes(bars + 8 * (2 * stages + 1) + 1024) {}
};

// B5, wide, bf16: one CTA per (b, kv head, group part, part, 64 keys);
// (b, kv head, group part, part) on grid x, the key tiles on grid y (causal:
// key tile 0, which sees every query tile, launches first). The CTA walks
// the query heads of its group part, each head's live 64-row query tiles
// in turn, streaming q_hat and dO; its K (dK part: and V) stay. Per query
// tile:
//   S^T = K q_hat^T              SS wgmma; dV part: each consumer its 32
//   dP^T = V dO^T (dK part)      queries; dK part: consumer 0 S^T, consumer
//                                1 dP^T, over all 64, then each hands
//                                the other the other's 32 columns in f32
//   P^T, or dS^T = P^T (dP^T - Delta), each consumer its 32 queries, under
//                                the forward's masks (lse and Delta read
//                                per query column), rounded to bf16 into
//                                the shared tile
//   dV += P^T dO, dK += dS^T q_hat  SS wgmma on the consumer's column
//                                boxes, q_hat's or dO's boxes streamed
//                                again as MN-major B
// One group part (parts_g = 1) stores dK (times ln2) and dV in bf16;
// several store f32 partial sums into `ws` (parts_g, B, Skv, Hk, D + DV),
// which flash_dkv_group_sum adds in the parts' order.
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dkv_wide_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        float* __restrict__ ws, int B, int H, int Hk, int Sq,
                        int Skv, int D, int DV, int causal, int window,
                        int parts_g, DkvRings rings) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const int nz = out_chunks(D) + out_chunks(DV);
  const int z = blockIdx.x % nz;
  const int gp = blockIdx.x / nz % parts_g;
  const int bhk = blockIdx.x / nz / parts_g;
  const int b = bhk / Hk, hk = bhk % Hk;
  const DkvPart part(D, DV, z);
  const bool dkp = part.dk;
  const OutSplit& sp = part.sp;
  const RingCfg rc = rings.r[dkp ? 0 : 1];
  const int gs = rc.group, resident = rc.resident, stages = rc.stages;
  const DkvLayout L(D, DV, dkp, stages, resident, gs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  const Ring ring{smem + L.ring, L.slot, stages, full, full + stages};
  uint64_t* kvbar = full + 2 * stages;

  const int n0 = blockIdx.y * kDkvKeys;
  const int per = H / Hk / parts_g;  // query heads of a group part
  const int h0 = hk * (H / Hk) + gp * per;
  const int nd = D / 64, ndv = DV / 64;
  const int nu = sp.groups(gs);
  int lo, hi;
  query_range(n0, kDkvKeys, kDkvBM, Sq, causal, window, &lo, &hi);
  const int n_qt = hi > lo ? (hi - lo) / kDkvBM : 0;  // per query head
  const int n_tiles = per * n_qt;

  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(kvbar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread loads
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    if (resident) {
      sm90::mbar_arrive_expect_tx(kvbar, (nd + (dkp ? ndv : 0)) * kChunk);
      for (int c = 0; c < nd; ++c)
        sm90::tma_load_4d(smem + L.k + c * kChunk, &tk, kvbar, c * 64, hk,
                          n0, b);
      if (dkp)
        for (int c = 0; c < ndv; ++c)
          sm90::tma_load_4d(smem + L.v + c * kChunk, &tv, kvbar, c * 64, hk,
                            n0, b);
    }
    const uint32_t box = resident ? kChunk : 2 * kChunk;
    RingPos p;
    for (int i = 0; i < n_tiles; ++i) {
      const int h = h0 + i / n_qt, m0 = lo + i % n_qt * kDkvBM;
      // The logits' boxes. dK part: a slot holds gs / 2 q_hat boxes
      // (consumer 0's S^T) and then as many dO boxes (consumer 1's dP^T)
      // of the same columns; dV part: gs q_hat boxes. Riding K (V) boxes
      // follow the slot's gs streamed ones in the same order.
      const int per_slot = dkp ? gs / 2 : gs;
      for (int c0 = 0; c0 < max(nd, dkp ? ndv : 0); c0 += per_slot,
               p.next(stages)) {
        const int gq = min(per_slot, max(nd - c0, 0));
        const int go = dkp ? min(per_slot, max(ndv - c0, 0)) : 0;
        ring.acquire(p, (gq + go) * box);
        unsigned char* dst = ring.at(p.s);
        for (int x = 0; x < gq; ++x) {
          sm90::tma_load_4d(dst + x * kChunk, &tq, &full[p.s], (c0 + x) * 64,
                            h, m0, b);
          if (!resident)
            sm90::tma_load_4d(dst + (gs + x) * kChunk, &tk, &full[p.s],
                              (c0 + x) * 64, hk, n0, b);
        }
        for (int x = 0; x < go; ++x) {
          sm90::tma_load_4d(dst + (per_slot + x) * kChunk, &tdo, &full[p.s],
                            (c0 + x) * 64, h, m0, b);
          if (!resident)
            sm90::tma_load_4d(dst + (gs + per_slot + x) * kChunk, &tv,
                              &full[p.s], (c0 + x) * 64, hk, n0, b);
        }
      }
      for (int u = 0; u < nu; ++u, p.next(stages)) {
        const int w = u & 1, x0 = (u >> 1) * gs;
        const int gb = min(gs, sp.n[w] - x0);
        ring.acquire(p, gb * kChunk);
        for (int x = 0; x < gb; ++x)
          sm90::tma_load_4d(ring.at(p.s) + x * kChunk, dkp ? &tq : &tdo,
                            &full[p.s], sp.col(w, x0 + x), h, m0, b);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's keys n0 + row0, + 8
  const int qw = w * kDkvBM / 2;   // this consumer's first query of a tile
  const int mine = sp.n[w];
  const uint32_t ds_base = sm90::smem_u32(smem + L.ds);
  const uint32_t k_base = sm90::smem_u32(smem + L.k);
  const uint32_t v_base = sm90::smem_u32(smem + L.v);

  float acc[kMaxBoxes * 32];  // dK or dV: this consumer's boxes, 32 a box
#pragma unroll
  for (int e = 0; e < kMaxBoxes * 32; ++e) acc[e] = 0.f;

  // lse and (dK part) Delta of query tile i at the thread's 8 query
  // columns (2 t, 2 t + 1 of each n8 tile of this consumer's 32): plain
  // loads, 0 past Sq, issued a tile ahead of their use so that their
  // latency hides behind the tile before.
  float lcol[8], dcol[8];
  auto load_stats = [&](int i) {
    const int m0 = lo + i % n_qt * kDkvBM;
    const long long row = ((long long)b * H + h0 + i / n_qt) * Sq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qp = m0 + qw + (j >> 1) * 8 + 2 * t + (j & 1);
      lcol[j] = qp < Sq ? lse[row + qp] : 0.f;
      dcol[j] = dkp && qp < Sq ? delta[row + qp] : 0.f;
    }
  };
  if (n_tiles > 0) load_stats(0);

  if (resident) sm90::mbar_wait(kvbar, 0);  // even with no query tile
  RingPos p;
  for (int i = 0; i < n_tiles; ++i) {
    const int m0 = lo + i % n_qt * kDkvBM;

    // The logits, one wgmma group a slot, one group kept in flight. dK
    // part: consumer 0 S^T = K q_hat^T from the slot's q_hat boxes,
    // consumer 1 dP^T = V dO^T from its dO boxes, each over all 64 queries
    // (m64n64k16; a consumer with no box in a slot commits an empty
    // group). dV part: S^T, each consumer its 32 queries (m64n32k16) of
    // every q_hat box.
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
    int pend = -1;
    if (dkp) {
      const int half = gs / 2, n = w ? ndv : nd;
      const uint32_t res = w ? v_base : k_base;
      for (int c0 = 0; c0 < max(nd, ndv); c0 += half, p.next(stages)) {
        ring.wait(p);
        const uint32_t slot = sm90::smem_u32(ring.at(p.s));
#pragma unroll
        for (int x = 0; x < kDkvMaxGroup / 2; ++x) {
          if (x >= half || c0 + x >= n) break;
          const uint32_t a = resident ? res + (c0 + x) * kChunk
                                      : slot + (gs + w * half + x) * kChunk;
          const uint32_t bq = slot + (w * half + x) * kChunk;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<0>(sc, sm90::desc_sw128(a + kk * 32, 16, 1024),
                              sm90::desc_sw128(bq + kk * 32, 16, 1024), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (pend >= 0) ring.release(pend);
        pend = p.s;
      }
      sm90::wgmma_wait<0>();
      ring.release(pend);
    } else {
      float(&sh)[16] = *reinterpret_cast<float(*)[16]>(sc);
      for (int c0 = 0; c0 < nd; c0 += gs, p.next(stages)) {
        ring.wait(p);
        const uint32_t slot = sm90::smem_u32(ring.at(p.s));
#pragma unroll
        for (int x = 0; x < kDkvMaxGroup; ++x) {
          if (x >= gs || c0 + x >= nd) break;
          const uint32_t a = resident ? k_base + (c0 + x) * kChunk
                                      : slot + (gs + x) * kChunk;
          const uint32_t bq = slot + x * kChunk + qw * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<0>(sh, sm90::desc_sw128(a + kk * 32, 16, 1024),
                              sm90::desc_sw128(bq + kk * 32, 16, 1024), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (pend >= 0) ring.release(pend);
        pend = p.s;
      }
      sm90::wgmma_wait<0>();
      ring.release(pend);
    }
    sm90::fence_regs(sc);

    // dK part: each consumer keeps the logits of its own 32 query columns
    // (qw on) and hands the other 32 over in f32 through shared memory, in
    // the accumulator's layout (element e of thread i at e * 128 + i): half
    // 0 consumer 0's S^T columns 32-63, half 1 consumer 1's dP^T columns
    // 0-31. Then both hold S^T in sc[0..15] and dP^T in sc[16..31] for
    // their own columns. Barrier 1: both wrote, and both consumers'
    // products of the last tile (which read the shared tile) retired.
    float* xchg = reinterpret_cast<float*>(smem + L.xchg) + threadIdx.x % 128;
    if (dkp && w == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) xchg[e * 128] = sc[16 + e];
    } else if (dkp) {
#pragma unroll
      for (int e = 0; e < 16; ++e) xchg[(16 + e) * 128] = sc[e];
    }
    sm90::named_barrier(1, kConsumerThreads);
    if (dkp && w == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[16 + e] = xchg[(16 + e) * 128];
    } else if (dkp) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] = xchg[e * 128];
    }

    // P^T = exp2(S^T - lse), and for the dK part dS^T = P^T (dP^T -
    // Delta); a dead pair (query past Sq, key past Skv, causal or window)
    // gets exactly 0. Masks only where the tile straddles an edge.
    const bool edge = m0 + kDkvBM > Sq || n0 + kDkvKeys > Skv ||
                      (causal && n0 + kDkvKeys - 1 > m0) ||
                      (window && n0 <= m0 + kDkvBM - 1 - window);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 2 + (e & 1);
        float pr = exp2f(sc[nt * 4 + e] - lcol[j]);
        if (edge) {
          const int qp = m0 + qw + nt * 8 + 2 * t + (e & 1);
          const int kp = n0 + row0 + 8 * (e >> 1);
          if (!(qp < Sq && key_live(qp, kp, Skv, causal, window))) pr = 0.f;
        }
        sc[nt * 4 + e] = dkp ? pr * (sc[16 + nt * 4 + e] - dcol[j]) : pr;
      }
    }
    if (i + 1 < n_tiles) load_stats(i + 1);

    // P^T (dS^T), rounded to bf16, into this consumer's 32 columns of the
    // shared tile.
    unsigned char* dst = smem + L.ds;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            dst + swizzled(row0 + 8 * r, qw / 8 + nt, t)) =
            sm90::pack_bf16(sc[nt * 4 + 2 * r], sc[nt * 4 + 2 * r + 1]);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(2, kConsumerThreads);  // the whole tile written

    // dV += P^T dO (dK += dS^T q_hat) for this consumer's boxes: the tile
    // the K-major A (64 queries, 4 k16 steps), dO (q_hat) the MN-major B.
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    pend = -1;
    for (int u = 0; u < nu; ++u, p.next(stages)) {
      ring.wait(p);
      if ((u & 1) != w) {
        ring.release(p.s);
        continue;
      }
      const uint32_t slot = sm90::smem_u32(ring.at(p.s));
      const int x0 = (u >> 1) * gs, gb = min(gs, mine - x0);
#pragma unroll
      for (int x = 0; x < kMaxBoxes; x += 2) {
        // Boxes x and x + 1 as one n128 product where both are in the
        // group, else x as an n64 one (a group starts on an even box).
        if (x < x0 || x >= x0 + gb) continue;
        const uint32_t ob = slot + (x - x0) * kChunk;
        if (x + 1 < kMaxBoxes && x + 1 < x0 + gb) {
          float(&d)[64] = *reinterpret_cast<float(*)[64]>(&acc[32 * x]);
#pragma unroll
          for (int kc = 0; kc < kDkvBM / 16; ++kc)
            sm90::wgmma_ss<1>(d,
                              sm90::desc_sw128(ds_base + kc * 32, 16, 1024),
                              sm90::desc_sw128(ob + kc * 16 * 128, kChunk,
                                               1024),
                              1);
        } else {
          float(&d)[32] = *reinterpret_cast<float(*)[32]>(&acc[32 * x]);
#pragma unroll
          for (int kc = 0; kc < kDkvBM / 16; ++kc)
            sm90::wgmma_ss<1>(d,
                              sm90::desc_sw128(ds_base + kc * 32, 16, 1024),
                              sm90::desc_sw128(ob + kc * 16 * 128, kChunk,
                                               1024),
                              1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pend >= 0) ring.release(pend);
      pend = p.s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (pend >= 0) ring.release(pend);
  }

  const int col0 = sp.col(w, 0);
  const int width = dkp ? D : DV;
  const float f = dkp ? kLn2 : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = n0 + row0 + 8 * r;
    if (kp >= Skv) continue;
    const long long key = ((long long)b * Skv + kp) * Hk + hk;
    if (parts_g == 1) {
      __nv_bfloat16* row = (dkp ? dk : dv) + key * width + col0 + 2 * t;
#pragma unroll
      for (int x = 0; x < kMaxBoxes; ++x) {
        if (x >= mine) break;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(row + x * 64 + nt * 8) =
              __floats2bfloat162_rn(acc[32 * x + nt * 4 + 2 * r] * f,
                                    acc[32 * x + nt * 4 + 2 * r + 1] * f);
      }
    } else {
      float* row = ws + ((long long)gp * B * Skv * Hk + key) * (D + DV) +
                   (dkp ? 0 : D) + col0 + 2 * t;
#pragma unroll
      for (int x = 0; x < kMaxBoxes; ++x) {
        if (x >= mine) break;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(row + x * 64 + nt * 8) =
              make_float2(acc[32 * x + nt * 4 + 2 * r],
                          acc[32 * x + nt * 4 + 2 * r + 1]);
      }
    }
  }
}

// The dK/dV kernel's second pass where the group is split over G parts:
// dK = ln2 * (part 0 + part 1 + ...) and dV = part 0 + part 1 + ..., in
// that order, from `ws` (G, rows, D + DV) f32, rows = B * Skv * Hk, each
// rounded to bf16 once. A column pair per thread, so the sums are the same
// run after run.
__global__ void __launch_bounds__(kSumThreads)
flash_dkv_group_sum(const float* __restrict__ ws,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int G, long long rows,
                    int D, int DV) {
  const int pairs = (D + DV) / 2;
  const long long plane = rows * (D + DV);
  for (long long i = blockIdx.x * (long long)kSumThreads + threadIdx.x;
       i < rows * pairs; i += (long long)gridDim.x * kSumThreads) {
    const long long row = i / pairs;
    const int c = (int)(i % pairs) * 2;
    const float* src = ws + row * (D + DV) + c;
    float2 s = make_float2(0.f, 0.f);
    for (int g = 0; g < G; ++g) {
      const float2 x = *reinterpret_cast<const float2*>(src + g * plane);
      s.x += x.x;
      s.y += x.y;
    }
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(dk + row * D + c) =
          __floats2bfloat162_rn(s.x * kLn2, s.y * kLn2);
    else
      *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + c - D) =
          __floats2bfloat162_rn(s.x, s.y);
  }
}

// ---------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool valid(int dtype, int B, int H, int Hk, int Sq, int Skv, int D, int DV) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Hk >= 1 &&
         H % Hk == 0 && Sq >= 1 && Skv >= 1 && D >= 64 && DV >= 64 &&
         D % 64 == 0 && DV % 64 == 0 && B * H <= 65535 &&
         (Sq + kQRows - 1) / kQRows <= 65535;
}

// The ring for a layout, `make(stages, resident)`: q_hat (and dO) resident
// where they leave room for kMinResidentStages slots, else streamed; as
// many slots as the card's shared memory takes, up to kMaxStages. False
// when not even kMinStages streamed slots fit.
template <typename Make>
bool pick_ring(Make make, int* stages, int* resident) {
  int dev = 0, budget = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&budget,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  for (int res = 1; res >= 0; --res) {
    int s = kMaxStages;
    while (s > 0 && make(s, res).bytes > budget) --s;
    if (s >= (res ? kMinResidentStages : kMinStages)) {
      *stages = s;
      *resident = res;
      return true;
    }
  }
  return false;
}

cudaError_t run_fwd_bf16(const void* q, const void* k, const void* v,
                         void* o, float* lse, float* lse_chunks, int B,
                         int H, int Hk, int Sq, int Skv, int D, int DV,
                         int causal, int window, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = sm90::tmap_bshd(&tq, q, B, Sq, H, D, kQRows)) != cudaSuccess ||
      (err = sm90::tmap_bshd(&tk, k, B, Skv, Hk, D, kFwdBN)) !=
          cudaSuccess ||
      (err = sm90::tmap_bshd(&tv, v, B, Skv, Hk, DV, kFwdBN)) != cudaSuccess)
    return err;
  int stages, resident;
  if (!pick_ring([&](int s, int r) { return FwdLayout(D, s, r); }, &stages,
                 &resident))
    return cudaErrorInvalidValue;
  const int smem = FwdLayout(D, stages, resident).bytes;
  if ((err = set_smem(flash_fwd_wide_bf16, smem)) != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kQRows - 1) / kQRows, out_chunks(DV));
  flash_fwd_wide_bf16<<<grid, kBf16Threads, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, lse_chunks, H, Hk, Sq,
      Skv, D, DV, causal, window, stages, resident);
  return cudaGetLastError();
}

cudaError_t run_fwd_f32(const void* q, const void* k, const void* v, void* o,
                        float* lse, float* lse_chunks, float* ws, int B, int H,
                        int Hk, int Sq, int Skv, int D, int DV, int causal,
                        int window, int parts, cudaStream_t st) {
  const fwd_dq_f32::Args a{static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           nullptr,
                           nullptr,
                           static_cast<float*>(o),
                           lse,
                           lse_chunks,
                           ws,
                           B, H, Hk, Sq, Skv, D, DV, causal, window, 1.f,
                           parts, 0};
  return fwd_dq_f32::launch(flash_fwd_wide_f32, flash_fwd_merge_f32, a,
                            fwd_dq_f32::kFwdKeys, DV, st);
}

cudaError_t run_dq_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int B, int H, int Hk,
                        int Sq, int Skv, int D, int DV, int causal,
                        int window, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = sm90::tmap_bshd(&tq, q, B, Sq, H, D, kQRows)) != cudaSuccess ||
      (err = sm90::tmap_bshd(&tk, k, B, Skv, Hk, D, kDqBN)) != cudaSuccess ||
      (err = sm90::tmap_bshd(&tv, v, B, Skv, Hk, DV, kDqBN)) !=
          cudaSuccess ||
      (err = sm90::tmap_bshd(&tdo, dout, B, Sq, H, DV, kQRows)) !=
          cudaSuccess)
    return err;
  int stages, resident;
  if (!pick_ring([&](int s, int r) { return DqLayout(D, DV, s, r); },
                 &stages, &resident))
    return cudaErrorInvalidValue;
  const int smem = DqLayout(D, DV, stages, resident).bytes;
  if ((err = set_smem(flash_bwd_dq_wide_bf16, smem)) != cudaSuccess)
    return err;
  dim3 grid(B * H, (Sq + kQRows - 1) / kQRows, out_chunks(D));
  flash_bwd_dq_wide_bf16<<<grid, kBf16Threads, smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), H, Hk,
      Sq, Skv, D, DV, causal, window, scale, stages, resident);
  return cudaGetLastError();
}

cudaError_t run_dq_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, float* ws, int B, int H,
                       int Hk, int Sq, int Skv, int D, int DV, int causal,
                       int window, int parts, float scale, cudaStream_t st) {
  const fwd_dq_f32::Args a{static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           static_cast<const float*>(dout),
                           delta,
                           static_cast<float*>(dq),
                           const_cast<float*>(lse),
                           nullptr,
                           ws,
                           B, H, Hk, Sq, Skv, D, DV, causal, window, scale,
                           parts, 0};
  return fwd_dq_f32::launch(flash_bwd_dq_wide_f32, flash_dq_part_sum_f32, a,
                            fwd_dq_f32::kDqKeys, D, st);
}

// A dK/dV role's ring in `budget` bytes: K (and V) resident where they
// leave room for kMinResidentStages slots, of kDkvMaxGroup boxes, else of
// 2; otherwise streamed beside q_hat and dO, slots of kDkvMaxGroup boxes,
// else of 2, at least kMinStages; as many slots as fit, up to kMaxStages.
bool pick_dkv_ring(int D, int DV, bool dk, int budget, RingCfg* out) {
  for (int res = 1; res >= 0; --res) {
    for (int gs = kDkvMaxGroup; gs >= 2; gs /= 2) {
      int s = kMaxStages;
      while (s > 0 && DkvLayout(D, DV, dk, s, res, gs).bytes > budget) --s;
      if (s >= (res ? kMinResidentStages : kMinStages)) {
        *out = RingCfg{s, res, gs};
        return true;
      }
    }
  }
  return false;
}

cudaError_t run_dkv_bf16(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, float* ws,
                         int B, int H, int Hk, int Sq, int Skv, int D,
                         int DV, int causal, int window, int parts_g,
                         cudaStream_t st) {
  const long long nx =
      (long long)B * Hk * parts_g * (out_chunks(D) + out_chunks(DV));
  const int key_tiles = (Skv + kDkvKeys - 1) / kDkvKeys;
  if (parts_g < 1 || (H / Hk) % parts_g || (parts_g > 1 && ws == nullptr) ||
      nx > 0x7fffffff || key_tiles > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = sm90::tmap_bshd(&tq, q, B, Sq, H, D, kDkvBM)) != cudaSuccess ||
      (err = sm90::tmap_bshd(&tk, k, B, Skv, Hk, D, kDkvKeys)) !=
          cudaSuccess ||
      (err = sm90::tmap_bshd(&tv, v, B, Skv, Hk, DV, kDkvKeys)) !=
          cudaSuccess ||
      (err = sm90::tmap_bshd(&tdo, dout, B, Sq, H, DV, kDkvBM)) !=
          cudaSuccess)
    return err;
  int dev = 0, budget = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  DkvRings rings;
  if (!pick_dkv_ring(D, DV, true, budget, &rings.r[0]) ||
      !pick_dkv_ring(D, DV, false, budget, &rings.r[1]))
    return cudaErrorInvalidValue;
  int smem = 0;
  for (int role = 0; role < 2; ++role) {
    const RingCfg& c = rings.r[role];
    const int bytes =
        DkvLayout(D, DV, role == 0, c.stages, c.resident, c.group).bytes;
    if (bytes > smem) smem = bytes;
  }
  if ((err = set_smem(flash_bwd_dkv_wide_bf16, smem)) != cudaSuccess)
    return err;
  dim3 grid((unsigned)nx, key_tiles);
  flash_bwd_dkv_wide_bf16<<<grid, kBf16Threads, smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), ws, B, H, Hk, Sq, Skv, D, DV, causal,
      window, parts_g, rings);
  if ((err = cudaGetLastError()) != cudaSuccess || parts_g == 1) return err;
  const long long rows = (long long)B * Skv * Hk;
  const long long blocks = (rows * (D + DV) / 2 + kSumThreads - 1) /
                           kSumThreads;
  const long long most = 8LL * sms;  // a grid-stride loop past that
  flash_dkv_group_sum<<<(unsigned)(blocks < most ? blocks : most),
                        kSumThreads, 0, st>>>(
      ws, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      parts_g, rows, D, DV);
  return cudaGetLastError();
}

cudaError_t run_dkv_f32(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, float* ws,
                        int B, int H, int Hk, int Sq, int Skv, int D, int DV,
                        int causal, int window, int parts, cudaStream_t st) {
  const dkv_f32::Args a{static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(dout), lse, delta,
                        static_cast<float*>(dk), static_cast<float*>(dv), ws,
                        B, H, Hk, Sq, Skv, D, DV, causal, window, parts, 0};
  return dkv_f32::launch(flash_bwd_dkv_wide_f32, flash_dkv_part_sum_f32, a,
                         dkv_f32::share_count(D, DV), st);
}

}  // namespace

// C entry points, bound with ctypes (marlin_tpu_torch/ops/flash_attention.py).
// dtype: 0 = bf16, 1 = f32. Each returns the cudaError_t of its launch
// (0 = ok); D or DV not a multiple of 64, or a shape out of range, returns
// cudaErrorInvalidValue. Layouts as in flash_attention_fwd.cu and
// flash_attention_bwd.cu; `lse_chunks` (may be null) is (chunks, B, H, Sq)
// f32, every output chunk's copy of lse: DV's 640-column CTA shares for
// bf16 (out_chunks), its 512-column ones for f32 (fwd_dq_f32::share_count).
// The forward and dQ: `parts` parts of each query tile's key sweep, 1 for
// bf16; for f32 at most `parts`, cut by live work
// (ops/flash_attention.py::_f32_q_plan). Above 1, `workspace` holds their
// f32 partials (the forward: (parts, B, Sq, H, DV) then m and l, each
// (parts, shares, B, H, Sq); dQ: (parts, B, Sq, H, D)), which a second
// launch on the same stream merges in order.
extern "C" int marlin_flash_attention_fwd_wide(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, void* lse_chunks, void* workspace, int B, int H, int Hk,
    int Sq, int Skv, int D, int DV, int causal, int window, int parts,
    void* stream) {
  if (!valid(dtype, B, H, Hk, Sq, Skv, D, DV) || (dtype == 0 && parts != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* lc = static_cast<float*>(lse_chunks);
  if (dtype == 0)
    return (int)run_fwd_bf16(q, k, v, o, l, lc, B, H, Hk, Sq, Skv, D, DV,
                             causal, window, st);
  return (int)run_fwd_f32(q, k, v, o, l, lc, static_cast<float*>(workspace),
                          B, H, Hk, Sq, Skv, D, DV, causal, window, parts,
                          st);
}

extern "C" int marlin_flash_attention_bwd_dq_wide(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* workspace, int B,
    int H, int Hk, int Sq, int Skv, int D, int DV, int causal, int window,
    int parts, float scale, void* stream) {
  if (!valid(dtype, B, H, Hk, Sq, Skv, D, DV) || (dtype == 0 && parts != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)run_dq_bf16(q, k, v, dout, l, dl, dq, B, H, Hk, Sq, Skv, D,
                            DV, causal, window, scale, st);
  return (int)run_dq_f32(q, k, v, dout, l, dl, dq,
                         static_cast<float*>(workspace), B, H, Hk, Sq, Skv,
                         D, DV, causal, window, parts, scale, st);
}

// dK/dV: `parts_g` parts of each key tile's sweep. bf16: group parts, a
// divisor of H / Hk, each summing its contiguous 1 / parts_g of a KV
// head's query heads. f32: at most parts_g parts of (query head, query
// tile) pairs, cut by live work (ops/flash_attention.py::_f32_dkv_plan).
// Above 1, `workspace` is (parts_g, B, Skv, Hk, D + DV) f32 for their
// partial sums, which a second launch on the same stream adds in order.
extern "C" int marlin_flash_attention_bwd_dkv_wide(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* workspace,
    int B, int H, int Hk, int Sq, int Skv, int D, int DV, int causal,
    int window, int parts_g, void* stream) {
  if (!valid(dtype, B, H, Hk, Sq, Skv, D, DV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)run_dkv_bf16(q, k, v, dout, l, dl, dk, dv,
                             static_cast<float*>(workspace), B, H, Hk, Sq,
                             Skv, D, DV, causal, window, parts_g, st);
  return (int)run_dkv_f32(q, k, v, dout, l, dl, dk, dv,
                          static_cast<float*>(workspace), B, H, Hk, Sq, Skv,
                          D, DV, causal, window, parts_g, st);
}
