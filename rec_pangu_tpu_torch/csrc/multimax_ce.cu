// The K-max softmax cross-entropy of multi-interest models, for Hopper
// (sm_90a), float32: the logsumexp (forward) and the softmax term of the
// gradient (backward).
//
// For users u [B, K, D] (K interests each) and an item table [rows, D]:
//   z[b, v]   = max_k u[b, k] . item[v]           (ties: the lowest k wins)
//   lse[b]    = logsumexp_v z[b, v]
// over the items v < valid_v (rows past it are the table's padding and score
// -1e30, so exp gives exactly 0); with zero_row0, item 0 (padding and
// out-of-vocabulary) reads as a zero vector: z[b, 0] = 0, which counts in the
// denominator, and it gets no gradient.  The backward, unscaled and without
// the positive-class terms (the caller applies both, as the JAX package does):
//   p[b, v]        = exp(z[b, v] - lse[b])       (0 for padding and row 0)
//   du[b, k]       = sum_v p[b, v] [k*(b, v) = k] item[v]
//   d_items[v]     = sum_b p[b, v] u[b, k*(b, v)]
//
// Replaces the JAX package's K5f and K5b: rec_pangu_tpu/ops/kernels/
// multimax_ce.py, _fwd_kernel and _bwd_kernel (behind multimax_lse and
// multimax_grads).  Those walk the item table in sequence on the TPU's one
// core, carrying the running (max, sum) and the whole du in VMEM from one
// grid step to the next.  Hopper's blocks run in parallel in no order, so:
//
// * One z routine (ZTile) serves the forward (K5f) and the backward's P: a
//   block owns 32 users and walks its range of 128-item tiles; thread
//   (ty, tx) holds users 2 ty and 2 ty + 1, every interest, and items
//   tx + 16 j (j < 8), so z and k* come from a strict > over k in
//   registers (the lowest k wins ties).  Each (user, interest, item) is one
//   fmaf chain over the dims in order, on the CUDA cores: the plain
//   version's float32 products bit for bit, so P's z is the forward's and p
//   sums to 1 against its lse.  The users sit in shared memory as rows
//   [b K + k][D padded to 4]; each item tile arrives by 16-byte cp.async, a
//   tile ahead, into a ring of two, as rows padded to 4 (mod 32) words so
//   that 16-byte loads of 8 consecutive rows hit 32 distinct banks.  Per 4
//   dims a thread loads 8 item and 2 K user float4s for 64 K fmafs.  Split
//   TF32 on the tensor cores (3 mma.sync products) ran the forward in two
//   thirds of the time but moved z by a few float32 roundings: at |z| near
//   25 the gradients from its lse were 1.5e-5 to 3.5e-5 off the plain
//   version's (their gates allow 1e-5), and near-ties went to another
//   interest.
// * The forward reduces each thread's running (max, sum) over the 16 lanes
//   that share a user, tile by tile, in a fixed order; each block writes
//   its range's partial (max, sum), and a second launch combines the ranges
//   in order.  The [B, K, V] logits never exist.
// * The backward (K5b) computes z, k* and p once per (b, v) and keeps them,
//   chunk by chunk of the item axis, in four launches.  P (ZTile's blocks)
//   writes p (f32) and k* (u8) to a workspace [B][chunk].  U reads them
//   back and sums the masked du product of each range of items (4 users x
//   K x 4 dims a thread) into a partial per range; S adds the ranges'
//   partials in range order.  D gives each block 256 items (128 past 64
//   dims) of d_items, reads p and k* of every user from the workspace (no
//   second z) and runs the masked product with u from shared memory (8
//   items x 8 dims a thread).  The workspace holds one chunk's pairs (about
//   1 GiB at most, whatever the table's size:
//   ops/kernels/multimax_ce.grads_plan).  No atomics: the same bits every
//   run.
//
// Bound: operations.  2 B K D V FLOP forward (524 GFLOP at B=1024, K=4, D=64,
// V=1,000,000: 7.8 ms at 67 TFLOP/s f32).  Backward 2 B V D (K + 2): z
// again, then one D-vector multiply-add per (b, v) into du and one into
// d_items, since each (b, v) reaches only its winning interest (786 GFLOP,
// 11.7 ms); this version runs z and those two as K-fold masked products in
// f32 on the CUDA cores (a gather of the winning row costs a shared-memory word per
// multiply-add; the masked register tiles reuse each word 16 K or 8 times),
// plus 5 B per (b, v) written by P and read by U and by D (15.4 GB at that
// shape, 4.6 ms at 3.35 TB/s).  The table (258 MB) takes 0.08 ms to read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUB = 32;                 // users a z block owns
constexpr int kTI = 128;                // items in a tile
constexpr int kTU = 2;                  // users a thread owns in a z product
static_assert(16 * kTU == kUB && kThreads == 16 * 16, "ZTile: 16 user lanes x 16 item lanes");
constexpr int kMaxK = 4;
constexpr int kMaxD = 128;
// blocks of the forward's user-tile launch: many waves of the 132 SMs (two
// blocks an SM), so that the last, partial wave costs little (the splits'
// partials are small)
constexpr int kFwdTargetBlocks = 2112;
constexpr float kNeg = -1e30f;

struct Args {
  const float* u;      // [B, K, D]
  const float* items;  // [rows, D]
  const float* lse;    // [B] (backward)
  int64_t B, rows, valid_v;
  int D, K, zero_row0;
  int user_tiles, item_tiles, splits, tiles_per_split;
};

__host__ __device__ int valid_tiles(const Args& A) { return (int)((A.valid_v + kTI - 1) / kTI); }

// Asynchronous N-byte copies from device to shared memory (cp.async; the
// 16-byte ones through L2 only).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [first, first + n) of src [*, D] (clamped to last_row) into dst
// [n][ld], asynchronously: 16-byte copies where every row is 16-byte
// aligned, else 4-byte ones; columns [D, ld) are left alone.
__device__ void stage_rows(float* dst, int ld, const float* __restrict__ src, int D, int n,
                           int64_t first, int64_t last_row) {
  if (D % 4 == 0 && ld % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q = D / 4;  // 16-byte pieces of a row
    for (int e = threadIdx.x; e < n * q; e += kThreads) {
      const int r = e / q, c = (e - r * q) * 4;
      const int64_t row = first + r < last_row ? first + r : last_row;
      cp_async<16>(dst + r * ld + c, src + row * D + c);
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < n; r += kThreads / 32) {
      const int64_t row = first + r < last_row ? first + r : last_row;
      for (int d = lane; d < D; d += 32) cp_async<4>(dst + r * ld + d, src + row * D + d);
    }
  }
  cp_commit();
}

// Words of a z product's rows in shared memory: D padded to 4 (with zeros).
__host__ __device__ int dims_padded(int D) { return (D + 3) & ~3; }

// Words of a staged item row: dims_padded(D), then to 4 (mod 32) words, so
// that 16-byte loads of 8 consecutive rows hit 32 distinct banks.
__host__ __device__ int item_ld(int D) {
  const int w = dims_padded(D);
  return w + (36 - w % 32) % 32;
}

// Shared memory of ZTile: the users [kUB K][dims_padded] and the ring of
// two item tiles [kTI][item_ld].
size_t z_smem_bytes(int D, int K) {
  return sizeof(float) * ((size_t)kUB * K * dims_padded(D) + 2 * (size_t)kTI * item_ld(D));
}

// The z product of the forward and of P: one block's users (user tile
// `user_tile`) against the item tiles [first, last), one tile a call, in
// order.  Thread (ty, tx) computes users kTU ty + s (s < kTU) of the user
// tile, every interest, against items tx + 16 j (j < 8) of each item tile.
template <int K>
struct ZTile {
  const Args& A;
  float* us;    // the users, rows b K + k [kUB K][dp], zero past D
  float* ring;  // two item tiles [kTI][ld], zero in [D, dp)
  int dp, ld, first, last;

  __device__ ZTile(const Args& args, float* smem, int user_tile, int first_tile, int last_tile)
      : A(args), first(first_tile), last(last_tile) {
    dp = dims_padded(A.D);
    ld = item_ld(A.D);
    us = smem;
    ring = us + kUB * K * dp;
    // past the last user, its rows again (their pairs are never written)
    const int64_t row0 = (int64_t)user_tile * kUB * K, last_row = A.B * K - 1;
    for (int e = threadIdx.x; e < kUB * K * dp; e += kThreads) {
      const int r = e / dp, d = e - r * dp;
      const int64_t row = row0 + r < last_row ? row0 + r : last_row;
      us[e] = d < A.D ? A.u[row * A.D + d] : 0.0f;
    }
    // the copies write a row's first D words; the rest of its last 4-dim
    // group meets the users' zeros
    for (int e = threadIdx.x; e < 2 * kTI; e += kThreads)
      for (int d = A.D; d < dp; ++d) ring[e * ld + d] = 0.0f;
    stage(first);
  }

  // Item tile `tile` into its slot of the ring, asynchronously.
  __device__ void stage(int tile) {
    stage_rows(ring + ((tile - first) & 1) * kTI * ld, ld, A.items, A.D, kTI,
               (int64_t)tile * kTI, A.rows - 1);
  }

  // The thread's z and k* over item tile `tile` (the next in order): each
  // (user, interest, item) one fmaf chain over the dims in order, the
  // largest interest by a strict >, kNeg past valid_v and 0 at row 0 with
  // zero_row0.  One barrier a tile: the tile is in, and every thread is
  // done with the one before, whose slot the next tile's copy then takes.
  __device__ void tile_z(int tile, float z[kTU][8], int ks[kTU][8]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    cp_wait_all();
    __syncthreads();
    if (tile + 1 < last) stage(tile + 1);
    float acc[kTU * K][8];
#pragma unroll
    for (int r = 0; r < kTU * K; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
    const float* irow = ring + ((tile - first) & 1) * kTI * ld + tx * ld;
    const float* urow = us + ty * kTU * K * dp;
    for (int d = 0; d < dp; d += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(irow + 16 * j * ld + d);
#pragma unroll
      for (int r = 0; r < kTU * K; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(urow + r * dp + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[r][j] = fmaf(a.x, b[j].x, acc[r][j]);
          acc[r][j] = fmaf(a.y, b[j].y, acc[r][j]);
          acc[r][j] = fmaf(a.z, b[j].z, acc[r][j]);
          acc[r][j] = fmaf(a.w, b[j].w, acc[r][j]);
        }
      }
    }
    const int64_t base = (int64_t)tile * kTI + tx;
#pragma unroll
    for (int s = 0; s < kTU; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float best = acc[s * K][j];
        int arg = 0;
#pragma unroll
        for (int k = 1; k < K; ++k)
          if (acc[s * K + k][j] > best) {
            best = acc[s * K + k][j];
            arg = k;
          }
        const int64_t v = base + 16 * j;
        if (v >= A.valid_v) best = kNeg;
        else if (A.zero_row0 && v == 0) best = 0.0f;
        z[s][j] = best;
        ks[s][j] = arg;
      }
  }
};

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ forward
// Block (user tile, split): the running (max, sum) of each of its users over
// the split's tiles up to the last valid one, in order, reduced over the 16
// lanes that share the user at each tile, written to pm / ps [splits, B].
template <int K>
__global__ void __launch_bounds__(kThreads, 2) lse_partial_kernel(Args A, float* __restrict__ pm,
                                                                  float* __restrict__ psum) {
  extern __shared__ float smem[];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int first = blockIdx.y * A.tiles_per_split;
  const int last = min(first + A.tiles_per_split, valid_tiles(A));
  float m[kTU], s[kTU];
#pragma unroll
  for (int q = 0; q < kTU; ++q) {
    m[q] = kNeg;
    s[q] = 0.0f;
  }
  if (first < last) {
    ZTile<K> zt(A, smem, blockIdx.x, first, last);
    for (int tile = first; tile < last; ++tile) {
      float z[kTU][8];
      int ks[kTU][8];
      zt.tile_z(tile, z, ks);
#pragma unroll
      for (int q = 0; q < kTU; ++q) {
        float tmax = z[q][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, z[q][j]);
        const float m_new = fmaxf(m[q], half_max(tmax));
        float e = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) e += expf(z[q][j] - m_new);
        s[q] = s[q] * expf(m[q] - m_new) + half_sum(e);
        m[q] = m_new;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int q = 0; q < kTU; ++q) {
      const int64_t b = (int64_t)blockIdx.x * kUB + ty * kTU + q;
      if (b < A.B) {
        pm[blockIdx.y * A.B + b] = m[q];
        psum[blockIdx.y * A.B + b] = s[q];
      }
    }
  }
}

// lse[b] from the splits' partials, combined in split order.
__global__ void lse_combine_kernel(const float* __restrict__ pm, const float* __restrict__ psum,
                                   int splits, int64_t B, float* __restrict__ lse) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m = kNeg;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s * B + b]);
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += psum[s * B + b] * expf(pm[s * B + b] - m);
  lse[b] = m + logf(sum);
}

// ----------------------------------------------------------------- backward
// K5b runs chunk by chunk over the item axis: a chunk is chunk_tiles tiles
// of kTI items, and the workspace holds one chunk's pairs, so its size does
// not grow with the table.  Per chunk, four launches:
//  P  pairs_kernel, block (user tile, split): z and k* of each (b, v) of the
//     split's tiles by ZTile and p = exp(z - lse),
//     written to the workspace as p [B][chunk] (f32) and k* [B][chunk] (u8);
//  U  users_kernel, block (64 users, split): the masked du product of the
//     split's items from the workspace, written as the split's partial du;
//  S  add_splits_kernel: du (+)= the splits' partials, in split order;
//  D  items_kernel, block = 256 items (128 past 64 dims): their d_items
//     rows from p and k* of every user; z is not recomputed.
// P holds ZTile's registers and shared memory (100 KiB at K = 4, D = 64), so
// two blocks share an SM; U and D run 4 x 4 x K and 8 x 8 register tiles
// fed by 16-byte shared loads.  No
// atomics: the same bits every run.

struct Plan {
  int chunk_tiles;      // item tiles of a chunk
  int tiles_per_split;  // item tiles of a P or U block
  int chunks;           // chunks over the table
  int splits;           // P or U blocks of a full chunk per user group
  __host__ __device__ int64_t chunk_items() const { return (int64_t)chunk_tiles * kTI; }
};

constexpr int kPairs = 2048;  // (user, item) pairs U and D stage at a time: 8 a thread

// A staging thread's 8 pairs (p and k* of one user, 8 items from `at`)
// into its own slots of the raw tiles rp [kThreads][8] and rk [kThreads][8],
// asynchronously; read_pairs reads them back once they have arrived.
__device__ __forceinline__ void stage_pairs(float* rp, unsigned char* rk, const float* wp,
                                            const unsigned char* wk, int64_t at) {
  cp_async<16>(rp + 8 * threadIdx.x, wp + at);
  cp_async<16>(rp + 8 * threadIdx.x + 4, wp + at + 4);
  cp_async<8>(rk + 8 * threadIdx.x, wk + at);
}

__device__ __forceinline__ void read_pairs(const float* rp, const unsigned char* rk, float p[8],
                                           unsigned kk[8]) {
  const float4 a = *reinterpret_cast<const float4*>(rp + 8 * threadIdx.x);
  const float4 b = *reinterpret_cast<const float4*>(rp + 8 * threadIdx.x + 4);
  const uint2 k = *reinterpret_cast<const uint2*>(rk + 8 * threadIdx.x);
  p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w, p[4] = b.x, p[5] = b.y, p[6] = b.z, p[7] = b.w;
#pragma unroll
  for (int j = 0; j < 8; ++j) kk[j] = ((j < 4 ? k.x : k.y) >> (8 * (j % 4))) & 0xffu;
}

// The items of chunk `chunk` whose pairs P writes: whole tiles up to the
// last one that holds a valid item (p = 0 past valid_v within it).
__device__ int64_t live_items(const Args& A, const Plan& P, int chunk) {
  const int64_t base = (int64_t)chunk * P.chunk_items();
  const int64_t end = min((int64_t)min(A.item_tiles, valid_tiles(A)) * kTI,
                          base + P.chunk_items());
  return end > base ? end - base : 0;
}

// P.  Thread (ty, tx) of ZTile writes p and k* of users ty * kTU + s,
// items tx + 16 j.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
    pairs_kernel(Args A, Plan P, int chunk, float* __restrict__ wp,
                 unsigned char* __restrict__ wk) {
  extern __shared__ float smem[];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t ci = P.chunk_items(), chunk_base = (int64_t)chunk * ci;
  const int first = chunk * P.chunk_tiles + blockIdx.y * P.tiles_per_split;
  const int last = min(min(first + P.tiles_per_split, (chunk + 1) * P.chunk_tiles),
                       min(A.item_tiles, valid_tiles(A)));
  if (first >= last) return;
  float l[kTU];
#pragma unroll
  for (int s = 0; s < kTU; ++s) {
    const int64_t b = (int64_t)blockIdx.x * kUB + ty * kTU + s;
    l[s] = b < A.B ? A.lse[b] : 0.0f;
  }
  ZTile<K> zt(A, smem, blockIdx.x, first, last);
  for (int tile = first; tile < last; ++tile) {
    const int64_t base = (int64_t)tile * kTI;
    float z[kTU][8];
    int ks[kTU][8];
    zt.tile_z(tile, z, ks);
#pragma unroll
    for (int s = 0; s < kTU; ++s) {
      const int64_t b = (int64_t)blockIdx.x * kUB + ty * kTU + s;
      if (b >= A.B) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t v = base + tx + 16 * j;
        const bool live = v < A.valid_v && !(A.zero_row0 && v == 0);
        const int64_t at = b * ci + (v - chunk_base);
        __stcs(wp + at, live ? expf(z[s][j] - l[s]) : 0.0f);
        wk[at] = (unsigned char)ks[s][j];
      }
    }
  }
}

// U.  Block (user group, split): users [UB blockIdx.x, ...), the split's
// live items of the chunk in stages of SI.  Thread (ug, dg) owns users
// UT ug + s, every k and dims 4 dg + 64 c + e (c < DC, e < 4): per item one
// 16-byte load of item dims and K loads of UT users' masked p (pm
// [K][SI][UB], one word broadcast over the warp's dim groups) feed 16 K
// FMAs.  Staging thread: user t % UB, items 8 (t / UB) + j.
template <int K, int DC>
__global__ void __launch_bounds__(kThreads, 2)
    users_kernel(Args A, Plan P, int chunk, const float* __restrict__ wp,
                 const unsigned char* __restrict__ wk, float* __restrict__ partial) {
  constexpr int UT = 4 / DC, UB = 16 * UT, SI = kPairs / UB;
  extern __shared__ float smem[];
  const int Dp = (A.D + 3) & ~3;
  float* const ibuf = smem;                    // [2][SI][Dp]
  float* const pmb = smem + 2 * SI * Dp;        // [2][K][SI][UB]
  float* const rp = pmb + 2 * K * SI * UB;      // raw pairs [kThreads][8]
  unsigned char* const rk = reinterpret_cast<unsigned char*>(rp + kPairs);
  const int dg = threadIdx.x % 16, ug = threadIdx.x / 16;
  const int64_t ci = P.chunk_items(), chunk_base = (int64_t)chunk * ci;
  const int64_t s0 = (int64_t)blockIdx.y * P.tiles_per_split * kTI;
  const int64_t s1 = min(s0 + (int64_t)P.tiles_per_split * kTI, live_items(A, P, chunk));
  float acc[UT][K][4 * DC];
#pragma unroll
  for (int s = 0; s < UT; ++s)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < 4 * DC; ++e) acc[s][k][e] = 0.0f;

  if (s1 > s0) {  // whole tiles: a multiple of SI items
    for (int r = threadIdx.x; r < 2 * SI; r += kThreads)
      for (int d = A.D; d < Dp; ++d) smem[r * Dp + d] = 0.0f;
    int doff[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) doff[c] = min(4 * dg + 64 * c, Dp - 4);
    const int sb = threadIdx.x % UB, sq = (threadIdx.x / UB) * 8;
    const int64_t b = (int64_t)blockIdx.x * UB + sb;
    auto fetch = [&](int stage) {
      if (b < A.B) stage_pairs(rp, rk, wp, wk, b * ci + s0 + (int64_t)stage * SI + sq);
    };
    auto put = [&](float* pm) {
      float p[8];
      unsigned kk[8];
      read_pairs(rp, rk, p, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k)
          pm[(k * SI + sq + j) * UB + sb] = b < A.B && kk[j] == (unsigned)k ? p[j] : 0.0f;
    };
    const int stages = (int)((s1 - s0) / SI);
    const int64_t row0 = chunk_base + s0;
    fetch(0);
    stage_rows(ibuf, Dp, A.items, A.D, SI, row0, A.rows - 1);
    cp_wait_all();
    put(pmb);
    __syncthreads();
    for (int st = 0; st < stages; ++st) {
      const int cur = st & 1;
      if (st + 1 < stages) {
        fetch(st + 1);
        stage_rows(ibuf + (cur ^ 1) * SI * Dp, Dp, A.items, A.D, SI,
                   row0 + (int64_t)(st + 1) * SI, A.rows - 1);
      }
      const float* it = ibuf + cur * SI * Dp;
      const float* pm = pmb + cur * K * SI * UB;
#pragma unroll 2
      for (int i = 0; i < SI; ++i) {
        float4 iv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) iv[c] = *reinterpret_cast<const float4*>(it + i * Dp + doff[c]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float w[UT];
          if constexpr (UT == 4) {
            const float4 q = *reinterpret_cast<const float4*>(pm + (k * SI + i) * UB + 4 * ug);
            w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
          } else {
            const float2 q = *reinterpret_cast<const float2*>(pm + (k * SI + i) * UB + 2 * ug);
            w[0] = q.x, w[1] = q.y;
          }
#pragma unroll
          for (int s = 0; s < UT; ++s)
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              acc[s][k][4 * c] = fmaf(w[s], iv[c].x, acc[s][k][4 * c]);
              acc[s][k][4 * c + 1] = fmaf(w[s], iv[c].y, acc[s][k][4 * c + 1]);
              acc[s][k][4 * c + 2] = fmaf(w[s], iv[c].z, acc[s][k][4 * c + 2]);
              acc[s][k][4 * c + 3] = fmaf(w[s], iv[c].w, acc[s][k][4 * c + 3]);
            }
        }
      }
      if (st + 1 < stages) {
        cp_wait_all();
        put(pmb + (cur ^ 1) * K * SI * UB);
      }
      __syncthreads();
    }
  }
  float* out = partial + (int64_t)blockIdx.y * A.B * K * A.D;
#pragma unroll
  for (int s = 0; s < UT; ++s) {
    const int64_t b = (int64_t)blockIdx.x * UB + UT * ug + s;
    if (b >= A.B) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * dg + 64 * c + e;
          if (d < A.D) out[(b * K + k) * A.D + d] = acc[s][k][4 * c + e];
        }
  }
}

// S.  out[i] = (accumulate ? out[i] : 0) + the splits' partials[s][i], in
// split order.
__global__ void add_splits_kernel(const float* __restrict__ partials, int splits, int64_t count,
                                  float* __restrict__ out, int accumulate) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = accumulate ? out[i] : 0.0f;
  for (int b = 0; b < splits; ++b) s = __fadd_rn(s, __ldg(partials + (int64_t)b * count + i));
  out[i] = s;
}

// D.  Block = IB items of the chunk from blockIdx.x IB (IB = 256 with DG = 8
// dim groups, for D <= 64; 128 with 16, for D <= 128).  Thread (ig, dg)
// owns items 4 ig + j and IB / 2 + 4 ig + j (j < 4) and dims
// 4 dg + 4 DG c + e (c < 2, e < 4): d_items[v][d] = sum over users b, then
// k, in order, of fmaf([k*(b, v) = k] p[b, v], u[b, k, d]): one chain an
// element, so its bits depend on neither the chunks nor the tiling.  Each
// stage of SU users is double-buffered: the users' rows by cp.async, p and
// k* through registers into the masked tile pm [K][SU][IB]; one barrier a
// stage.  Staging thread: user t / (IB / 8), items 8 (t % (IB / 8)) + j.
template <int K, int DG>
__global__ void __launch_bounds__(kThreads, 2)
    items_kernel(Args A, Plan P, int chunk, const float* __restrict__ wp,
                 const unsigned char* __restrict__ wk, float* __restrict__ d_items) {
  constexpr int IB = 8 * (kThreads / DG), SU = kPairs / IB;
  extern __shared__ float smem[];
  const int Dp = (A.D + 3) & ~3;
  float* const ubuf = smem;                     // [2][SU K][Dp]
  float* const pmb = smem + 2 * SU * K * Dp;     // [2][K][SU][IB]
  float* const rp = pmb + 2 * K * SU * IB;       // raw pairs [kThreads][8]
  unsigned char* const rk = reinterpret_cast<unsigned char*>(rp + kPairs);
  const int dg = threadIdx.x % DG, ig = threadIdx.x / DG;
  const int64_t ci = P.chunk_items(), off = (int64_t)blockIdx.x * IB;
  const int64_t base = (int64_t)chunk * ci + off;
  const int tiles = min(P.chunk_tiles, A.item_tiles - chunk * P.chunk_tiles);
  const int64_t n_items = (int64_t)tiles * kTI - off;  // the chunk's items from base
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;

  if (base < A.valid_v) {
    for (int r = threadIdx.x; r < 2 * SU * K; r += kThreads)
      for (int d = A.D; d < Dp; ++d) smem[r * Dp + d] = 0.0f;
    int uoff[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) uoff[c] = min(4 * dg + 4 * DG * c, Dp - 4);
    const int sb = threadIdx.x / (IB / 8), sq = (threadIdx.x % (IB / 8)) * 8;
    const bool in_chunk = sq < n_items;  // whole tiles: all 8 items or none
    const int64_t last_row = A.B * K - 1;
    auto fetch = [&](int stage) {
      const int64_t b = (int64_t)stage * SU + sb;
      if (b < A.B && in_chunk) stage_pairs(rp, rk, wp, wk, b * ci + off + sq);
    };
    auto put = [&](float* pm, int stage) {
      float p[8];
      unsigned kk[8];
      read_pairs(rp, rk, p, kk);
      const bool live = (int64_t)stage * SU + sb < A.B && in_chunk;
#pragma unroll
      for (int j = 0; j < 8; ++j)  // tiles past the last valid one hold no pairs
        if (!live || base + sq + j >= A.valid_v) p[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = kk[j] == (unsigned)k ? p[j] : 0.0f;
        float4* dst = reinterpret_cast<float4*>(pm + (k * SU + sb) * IB + sq);
        dst[0] = make_float4(w[0], w[1], w[2], w[3]);
        dst[1] = make_float4(w[4], w[5], w[6], w[7]);
      }
    };
    const int stages = (int)((A.B + SU - 1) / SU);
    fetch(0);
    stage_rows(ubuf, Dp, A.u, A.D, SU * K, 0, last_row);
    cp_wait_all();
    put(pmb, 0);
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int cur = s & 1;
      if (s + 1 < stages) {
        fetch(s + 1);
        stage_rows(ubuf + (cur ^ 1) * SU * K * Dp, Dp, A.u, A.D, SU * K,
                   (int64_t)(s + 1) * SU * K, last_row);
      }
      const float* ub = ubuf + cur * SU * K * Dp;
      const float* pm = pmb + cur * K * SU * IB;
#pragma unroll 2
      for (int b = 0; b < SU; ++b) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* wrow = pm + (k * SU + b) * IB;
          const float4 w0 = *reinterpret_cast<const float4*>(wrow + 4 * ig);
          const float4 w1 = *reinterpret_cast<const float4*>(wrow + IB / 2 + 4 * ig);
          const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 uv = *reinterpret_cast<const float4*>(ub + (b * K + k) * Dp + uoff[c]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][4 * c] = fmaf(w[i], uv.x, acc[i][4 * c]);
              acc[i][4 * c + 1] = fmaf(w[i], uv.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(w[i], uv.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(w[i], uv.w, acc[i][4 * c + 3]);
            }
          }
        }
      }
      if (s + 1 < stages) {
        cp_wait_all();
        put(pmb + (cur ^ 1) * K * SU * IB, s + 1);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int local = i < 4 ? 4 * ig + i : IB / 2 + 4 * ig + i - 4;
    const int64_t v = base + local;
    if (local >= n_items || v >= A.rows) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d0 = 4 * dg + 4 * DG * c;
      if (d0 >= A.D) continue;
      float* dst = d_items + v * A.D + d0;
      if (A.D % 4 == 0) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < A.D) dst[e] = acc[i][4 * c + e];
      }
    }
  }
}

bool shape_ok(long long B, int K, int D, long long rows, long long valid_v) {
  return B > 0 && K >= 1 && K <= kMaxK && D >= 1 && D <= kMaxD && rows >= 1 &&
         valid_v >= 1 && valid_v <= rows && B * K * D < (1LL << 40) && rows < (1LL << 40);
}

Args make_args(const void* u, const void* items, const void* lse, long long B, int K, int D,
               long long rows, long long valid_v, int zero_row0, int target_blocks) {
  Args A;
  A.u = static_cast<const float*>(u);
  A.items = static_cast<const float*>(items);
  A.lse = static_cast<const float*>(lse);
  A.B = B;
  A.rows = rows;
  A.valid_v = valid_v;
  A.D = D;
  A.K = K;
  A.zero_row0 = zero_row0;
  A.user_tiles = (int)((B + kUB - 1) / kUB);
  A.item_tiles = (int)((rows + kTI - 1) / kTI);
  int splits = (target_blocks + A.user_tiles - 1) / A.user_tiles;
  splits = splits < 1 ? 1 : (splits > A.item_tiles ? A.item_tiles : splits);
  A.tiles_per_split = (A.item_tiles + splits - 1) / splits;
  A.splits = (A.item_tiles + A.tiles_per_split - 1) / A.tiles_per_split;
  return A;
}

// The backward's plan from the caller's chunk_tiles and tiles_per_split
// (ops/kernels/multimax_ce.grads_plan); false if they do not make one.
bool make_plan(long long rows, int chunk_tiles, int tiles_per_split, Plan* P) {
  const long long item_tiles = (rows + kTI - 1) / kTI;
  if (chunk_tiles < 1 || tiles_per_split < 1 || tiles_per_split > chunk_tiles ||
      chunk_tiles > item_tiles)
    return false;
  P->chunk_tiles = chunk_tiles;
  P->tiles_per_split = tiles_per_split;
  P->chunks = (int)((item_tiles + chunk_tiles - 1) / chunk_tiles);
  P->splits = (chunk_tiles + tiles_per_split - 1) / tiles_per_split;
  return true;
}

// Workspace words of the backward: p [B][chunk], k* [B][chunk] bytes, and
// the partial du of each split of a chunk.
long long grads_words(long long B, int K, int D, const Plan& P) {
  const long long pairs = B * P.chunk_items();
  return pairs + pairs / 4 + (long long)P.splits * B * K * D;
}

// The shared-memory opt-in of each instantiation, per device: the forward,
// P, U and D (each at up to 64 and past 64 dims).
size_t g_opted[6][kMaxK + 1][rp::kMaxDevices] = {};

template <int K>
cudaError_t launch_lse(const Args& A, float* pm, float* psum, float* lse, cudaStream_t st) {
  const size_t bytes = z_smem_bytes(A.D, K);
  cudaError_t err = rp::opt_in((const void*)lse_partial_kernel<K>, bytes, g_opted[0][K]);
  if (err != cudaSuccess) return err;
  lse_partial_kernel<K><<<dim3(A.user_tiles, A.splits), kThreads, bytes, st>>>(A, pm, psum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_combine_kernel<<<(unsigned)((A.B + 255) / 256), 256, 0, st>>>(pm, psum, A.splits, A.B,
                                                                     lse);
  return cudaGetLastError();
}

// U's and D's double-buffered rows (n a stage, D padded to 4) and masked
// p, and the raw pairs (p and k*) of a stage.
size_t staged_smem_bytes(int D, int K, int rows, int pairs) {
  return sizeof(float) * 2 * ((size_t)rows * ((D + 3) & ~3) + (size_t)K * pairs) +
         (size_t)pairs * 5;
}

template <int K, int DC>
cudaError_t launch_users(const Args& A, const Plan& P, int chunk, int splits, const float* wp,
                         const unsigned char* wk, float* partial, cudaStream_t st) {
  constexpr int UB = 16 * (4 / DC), SI = kPairs / UB;
  const size_t bytes = staged_smem_bytes(A.D, K, SI, kPairs);
  cudaError_t err = rp::opt_in((const void*)users_kernel<K, DC>, bytes, g_opted[1 + DC][K]);
  if (err != cudaSuccess) return err;
  users_kernel<K, DC><<<dim3((unsigned)((A.B + UB - 1) / UB), splits), kThreads, bytes, st>>>(
      A, P, chunk, wp, wk, partial);
  return cudaGetLastError();
}

template <int K, int DG>
cudaError_t launch_items(const Args& A, const Plan& P, int chunk, int tiles, const float* wp,
                         const unsigned char* wk, float* d_items, cudaStream_t st) {
  constexpr int IB = 8 * (kThreads / DG), SU = kPairs / IB;
  const size_t bytes = staged_smem_bytes(A.D, K, SU * K, kPairs);
  cudaError_t err = rp::opt_in((const void*)items_kernel<K, DG>, bytes, g_opted[DG == 8 ? 4 : 5][K]);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(((int64_t)tiles * kTI + IB - 1) / IB);
  items_kernel<K, DG><<<blocks, kThreads, bytes, st>>>(A, P, chunk, wp, wk, d_items);
  return cudaGetLastError();
}

// One launch of chunk `chunk`: stage 0 = P (p and k* into the workspace),
// 1 = U (the splits' partial du into the workspace), 2 = S (out = du
// [B, K, D], added to when `accumulate`), 3 = D (out = d_items [rows, D],
// the chunk's rows).
template <int K>
cudaError_t launch_stage(const Args& A, const Plan& P, int chunk, int stage, int accumulate,
                         float* work, float* out, cudaStream_t st) {
  const int64_t pairs = A.B * P.chunk_items();
  float* wp = work;
  unsigned char* wk = reinterpret_cast<unsigned char*>(work + pairs);
  float* partial = work + pairs + pairs / 4;
  const int first = chunk * P.chunk_tiles;
  const int tiles = P.chunk_tiles < A.item_tiles - first ? P.chunk_tiles : A.item_tiles - first;
  const int splits = (tiles + P.tiles_per_split - 1) / P.tiles_per_split;
  if (stage == 0) {
    const size_t bytes = z_smem_bytes(A.D, K);
    const cudaError_t err = rp::opt_in((const void*)pairs_kernel<K>, bytes, g_opted[1][K]);
    if (err != cudaSuccess) return err;
    pairs_kernel<K><<<dim3(A.user_tiles, splits), kThreads, bytes, st>>>(A, P, chunk, wp, wk);
  } else if (stage == 1) {
    return A.D <= 64 ? launch_users<K, 1>(A, P, chunk, splits, wp, wk, partial, st)
                     : launch_users<K, 2>(A, P, chunk, splits, wp, wk, partial, st);
  } else if (stage == 2) {
    const int64_t count = A.B * K * A.D;
    add_splits_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(partial, splits, count,
                                                                      out, accumulate);
  } else {
    return A.D <= 64 ? launch_items<K, 8>(A, P, chunk, tiles, wp, wk, out, st)
                     : launch_items<K, 16>(A, P, chunk, tiles, wp, wk, out, st);
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_grads(const Args& A, const Plan& P, float* du, float* d_items, float* work,
                         cudaStream_t st) {
  for (int c = 0; c < P.chunks; ++c) {
    // a chunk past the valid items adds nothing to du: only its rows of
    // d_items are written (as 0)
    const bool live = c == 0 || (int64_t)c * P.chunk_items() < A.valid_v;
    for (int stage = live ? 0 : 3; stage < 4; ++stage) {
      const cudaError_t err = launch_stage<K>(A, P, c, stage, c > 0, work,
                                              stage == 2 ? du : d_items, st);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// 4-byte words of workspace rp_multimax_lse_f32 needs.
extern "C" long long rp_multimax_lse_workspace_words(long long B, int K, int D, long long rows) {
  if (!shape_ok(B, K, D, rows, 1)) return 0;
  const Args A = make_args(nullptr, nullptr, nullptr, B, K, D, rows, 1, 0, kFwdTargetBlocks);
  return 2LL * A.splits * B;
}

// u [B, K, D], items [rows, D], lse [B], all float32, contiguous, on the
// current device; workspace: at least rp_multimax_lse_workspace_words words.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rp_multimax_lse_f32(const void* u, const void* items, void* lse, void* workspace,
                                   long long workspace_words, long long B, int K, int D,
                                   long long rows, long long valid_v, int zero_row0,
                                   void* stream) {
  if (!shape_ok(B, K, D, rows, valid_v) ||
      workspace_words < rp_multimax_lse_workspace_words(B, K, D, rows))
    return (int)cudaErrorInvalidValue;
  const Args A = make_args(u, items, nullptr, B, K, D, rows, valid_v, zero_row0,
                           kFwdTargetBlocks);
  float* pm = static_cast<float*>(workspace);
  float* psum = pm + (int64_t)A.splits * B;
  float* out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch_lse<1>(A, pm, psum, out, st);
    case 2: return (int)launch_lse<2>(A, pm, psum, out, st);
    case 3: return (int)launch_lse<3>(A, pm, psum, out, st);
    default: return (int)launch_lse<4>(A, pm, psum, out, st);
  }
}

// 4-byte words of workspace rp_multimax_grads_f32 needs with the plan
// (chunk_tiles, tiles_per_split); 0 if the shape or plan is refused.
extern "C" long long rp_multimax_grads_workspace_words(long long B, int K, int D, long long rows,
                                                       int chunk_tiles, int tiles_per_split) {
  Plan P;
  if (!shape_ok(B, K, D, rows, 1) || !make_plan(rows, chunk_tiles, tiles_per_split, &P))
    return 0;
  return grads_words(B, K, D, P);
}

// The forward's inputs and its lse [B]; writes du [B, K, D] and d_items
// [rows, D] (every row, padding included), chunk by chunk of chunk_tiles
// item tiles, tiles_per_split tiles a P block.  workspace: at least
// rp_multimax_grads_workspace_words words.  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int rp_multimax_grads_f32(const void* u, const void* items, const void* lse, void* du,
                                     void* d_items, void* workspace, long long workspace_words,
                                     long long B, int K, int D, long long rows,
                                     long long valid_v, int zero_row0, int chunk_tiles,
                                     int tiles_per_split, void* stream) {
  Plan P;
  if (!shape_ok(B, K, D, rows, valid_v) || !make_plan(rows, chunk_tiles, tiles_per_split, &P) ||
      workspace_words < grads_words(B, K, D, P))
    return (int)cudaErrorInvalidValue;
  const Args A = make_args(u, items, lse, B, K, D, rows, valid_v, zero_row0, 1);
  float* g_du = static_cast<float*>(du);
  float* g_items = static_cast<float*>(d_items);
  float* work = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch_grads<1>(A, P, g_du, g_items, work, st);
    case 2: return (int)launch_grads<2>(A, P, g_du, g_items, work, st);
    case 3: return (int)launch_grads<3>(A, P, g_du, g_items, work, st);
    default: return (int)launch_grads<4>(A, P, g_du, g_items, work, st);
  }
}

// One launch of the backward, for checks and timing: stage 0 (P), 1 (U),
// 2 (S) or 3 (D) of chunk `chunk`, as launch_stage says; the workspace
// carries P's pairs to U and D, and U's partials to S.
extern "C" int rp_multimax_grads_stage_f32(const void* u, const void* items, const void* lse,
                                           void* out, void* workspace, long long workspace_words,
                                           long long B, int K, int D, long long rows,
                                           long long valid_v, int zero_row0, int chunk_tiles,
                                           int tiles_per_split, int chunk, int stage,
                                           int accumulate, void* stream) {
  Plan P;
  if (!shape_ok(B, K, D, rows, valid_v) || !make_plan(rows, chunk_tiles, tiles_per_split, &P) ||
      workspace_words < grads_words(B, K, D, P) || chunk < 0 || chunk >= P.chunks || stage < 0 ||
      stage > 3)
    return (int)cudaErrorInvalidValue;
  const Args A = make_args(u, items, lse, B, K, D, rows, valid_v, zero_row0, 1);
  float* work = static_cast<float*>(workspace);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch_stage<1>(A, P, chunk, stage, accumulate, work, o, st);
    case 2: return (int)launch_stage<2>(A, P, chunk, stage, accumulate, work, o, st);
    case 3: return (int)launch_stage<3>(A, P, chunk, stage, accumulate, work, o, st);
    default: return (int)launch_stage<4>(A, P, chunk, stage, accumulate, work, o, st);
  }
}
