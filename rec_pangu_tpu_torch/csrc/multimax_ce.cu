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
// * The forward (K5f) gives each block 32 users (128 rows of u at K=4, held
//   in shared memory) and a contiguous range of 128-item tiles.  Per tile the
//   K products run as one 128 x 128 x D register-tiled product (a thread owns
//   2 users x K interests x 8 items), the max over K stays in registers, and
//   the block's running (max, sum) per user is updated tile by tile in a
//   fixed order.  Each block writes its range's partial (max, sum); a second
//   launch combines the ranges in order.  The [B, K, V] logits never exist.
// * The backward (K5b) is two launches that both recompute z and k*.  One
//   gives each block a 128-item tile of d_items and walks all users (each
//   d_items row written once, by one thread); the other gives each block 32
//   users and a range of item tiles, and writes its range's partial du, which
//   a third launch sums in range order.  No atomics: the same bits every run.
//
// Bound: operations.  2 B K D V FLOP forward (524 GFLOP at B=1024, K=4, D=64,
// V=1,000,000: 7.8 ms at 67 TFLOP/s f32).  Backward 2 B V D (K + 2): z again,
// then one D-vector multiply-add per (b, v) into du and one into d_items,
// since each (b, v) reaches only its winning interest (786 GFLOP, 11.7 ms);
// this first version runs those two as K-fold masked products, three times
// the forward's work.  The table (258 MB) takes 0.08 ms to read.  f32 on CUDA
// cores, no tensor cores in this first version: the reference's products are
// f32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTU = 2;                  // users a thread owns in the z product
constexpr int kUB = 16 * kTU;           // users a block owns
constexpr int kTI = 128;                // items in a tile: 16 threads x 8
constexpr int kMaxK = 4;
constexpr int kMaxD = 128;
// blocks of the user-tile launches: many waves of the 132 SMs, so that the
// last, partial wave costs little (the splits' partials are small)
constexpr int kFwdTargetBlocks = 2112;
constexpr int kBwdTargetBlocks = 1056;
constexpr int kDuThreadsPerUser = kThreads / kUB;               // 8
constexpr int kDuDims = (kMaxD + kDuThreadsPerUser - 1) / kDuThreadsPerUser;  // 16
constexpr int kItemDims = (kMaxD + 15) / 16;                    // 8
constexpr int kPsLd = kTI + 1;          // row strides of the p and k* tiles
constexpr int kKsLd = kTI + 4;
constexpr float kNeg = -1e30f;

struct Args {
  const float* u;      // [B, K, D]
  const float* items;  // [rows, D]
  const float* lse;    // [B] (backward)
  int64_t B, rows, valid_v;
  int D, K, zero_row0;
  int user_tiles, item_tiles, splits, tiles_per_split;
};

__host__ __device__ int rows_ld(int K) { return kUB * K + 4; }

// Shared memory: the block's users, transposed [D][kUB * K + 4] (rows b * K +
// k), and one item tile [kTI][D + 1].
struct Tiles {
  float* us;
  float* is;
  int uld, ild;
  __device__ Tiles(float* base, int D, int K) {
    uld = rows_ld(K);
    ild = D + 1;
    us = base;
    is = us + D * uld;
  }
};

__device__ void load_users(const Args& A, const Tiles& t, int user_tile) {
  const int R = kUB * A.K;
  const int64_t first = (int64_t)user_tile * R, last_row = A.B * A.K - 1;
  for (int e = threadIdx.x; e < R * A.D; e += kThreads) {
    const int r = e / A.D, d = e - r * A.D;
    const int64_t row = first + r < last_row ? first + r : last_row;
    t.us[d * t.uld + r] = A.u[row * A.D + d];
  }
}

__device__ void load_items(const Args& A, const Tiles& t, int64_t base) {
  for (int e = threadIdx.x; e < kTI * A.D; e += kThreads) {
    const int i = e / A.D, d = e - i * A.D;
    const int64_t row = base + i < A.rows ? base + i : A.rows - 1;
    t.is[i * t.ild + d] = A.items[row * A.D + d];
  }
}

// The thread's z and k* over the tile at `base`: users ty * kTU + s, items
// tx + 16 j.  Padding rows score kNeg; with zero_row0 item 0 scores 0.
template <int K>
__device__ void tile_z(const Args& A, const Tiles& t, int64_t base, float z[kTU][8],
                       int ks[kTU][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[kTU][K][8];
#pragma unroll
  for (int s = 0; s < kTU; ++s)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[s][k][j] = 0.0f;
  const float* urow = t.us + ty * kTU * K;
  const float* icol = t.is + tx * t.ild;
#pragma unroll 2
  for (int d = 0; d < A.D; ++d) {
    float a[kTU * K];
    if constexpr ((kTU * K) % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kTU * K / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(urow + d * t.uld)[q];
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kTU * K; ++q) a[q] = urow[d * t.uld + q];
    }
    float b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = icol[16 * j * t.ild + d];
#pragma unroll
    for (int s = 0; s < kTU; ++s)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[s][k][j] = fmaf(a[s * K + k], b[j], acc[s][k][j]);
  }
#pragma unroll
  for (int s = 0; s < kTU; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float best = acc[s][0][j];
      int arg = 0;
#pragma unroll
      for (int k = 1; k < K; ++k)
        if (acc[s][k][j] > best) {
          best = acc[s][k][j];
          arg = k;
        }
      const int64_t v = base + tx + 16 * j;
      if (v >= A.valid_v) best = kNeg;
      else if (A.zero_row0 && v == 0) best = 0.0f;
      z[s][j] = best;
      ks[s][j] = arg;
    }
}

// Reductions over the 16 threads that share a user (half a warp).
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

size_t z_smem_floats(int D, int K) { return (size_t)D * rows_ld(K) + (size_t)kTI * (D + 1); }

// ------------------------------------------------------------------ forward
// Block (user tile, split): the running (max, sum) of each of its users over
// the split's tiles, in order, written to pm / ps [splits, B].
template <int K>
__global__ void __launch_bounds__(kThreads) lse_partial_kernel(Args A, float* __restrict__ pm,
                                                               float* __restrict__ psum) {
  extern __shared__ float smem[];
  Tiles t(smem, A.D, K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_users(A, t, blockIdx.x);
  float m[kTU], s[kTU];
#pragma unroll
  for (int q = 0; q < kTU; ++q) {
    m[q] = kNeg;
    s[q] = 0.0f;
  }
  const int first = blockIdx.y * A.tiles_per_split;
  const int last = min(first + A.tiles_per_split, A.item_tiles);
  for (int tile = first; tile < last; ++tile) {
    const int64_t base = (int64_t)tile * kTI;
    __syncthreads();
    load_items(A, t, base);
    __syncthreads();
    float z[kTU][8];
    int ks[kTU][8];
    tile_z<K>(A, t, base, z, ks);
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
// p and k* of the tile into shared memory: ps [kUB][kPsLd], kss [kUB][kKsLd].
template <int K>
__device__ void tile_p(const Args& A, const Tiles& t, int64_t base, int user_tile, float* ps,
                       unsigned char* kss) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float z[kTU][8];
  int ks[kTU][8];
  tile_z<K>(A, t, base, z, ks);
#pragma unroll
  for (int q = 0; q < kTU; ++q) {
    const int bl = ty * kTU + q;
    const int64_t b = (int64_t)user_tile * kUB + bl;
    const float l = b < A.B ? A.lse[b] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tx + 16 * j;
      const int64_t v = base + i;
      const bool live = b < A.B && v < A.valid_v && !(A.zero_row0 && v == 0);
      ps[bl * kPsLd + i] = live ? expf(z[q][j] - l) : 0.0f;
      kss[bl * kKsLd + i] = (unsigned char)ks[q][j];
    }
  }
}

// Block = one item tile: d_items rows [tile * kTI, ...) over all users.  A
// thread owns items tx + 16 i and dims ty + 16 e.
template <int K>
__global__ void __launch_bounds__(kThreads, 1) items_grad_kernel(Args A,
                                                                 float* __restrict__ d_items) {
  extern __shared__ float smem[];
  Tiles t(smem, A.D, K);
  float* ps = t.is + kTI * t.ild;
  unsigned char* kss = reinterpret_cast<unsigned char*>(ps + kUB * kPsLd);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t base = (int64_t)blockIdx.x * kTI;
  // dims ty + 16 e < D for e < dims (the threads with ty < D % 16 take one more)
  const int dims = (A.D - ty + 15) / 16;
  load_items(A, t, base);
  float acc[8][kItemDims];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < kItemDims; ++e) acc[i][e] = 0.0f;
  for (int ut = 0; ut < A.user_tiles; ++ut) {
    __syncthreads();
    load_users(A, t, ut);
    __syncthreads();
    tile_p<K>(A, t, base, ut, ps, kss);
    __syncthreads();
    const int users = (int)min((int64_t)kUB, A.B - (int64_t)ut * kUB);
    for (int bl = 0; bl < users; ++bl) {
      float w[8];
      int kk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        w[i] = ps[bl * kPsLd + tx + 16 * i];
        kk[i] = kss[bl * kKsLd + tx + 16 * i];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float wk[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) wk[i] = kk[i] == k ? w[i] : 0.0f;
#pragma unroll
        for (int e = 0; e < kItemDims; ++e) {
          if (e >= dims) break;
          const float uv = t.us[(ty + 16 * e) * t.uld + bl * K + k];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][e] = fmaf(wk[i], uv, acc[i][e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t v = base + tx + 16 * i;
    if (v >= A.rows) continue;
#pragma unroll
    for (int e = 0; e < kItemDims; ++e)
      if (e < dims) d_items[v * A.D + ty + 16 * e] = acc[i][e];
  }
}

// Block (user tile, split): the split's partial du [B, K, D] for its users.
// A thread owns user threadIdx.x / 8 and dims (threadIdx.x % 8) + 8 e.
template <int K>
__global__ void __launch_bounds__(kThreads, 1) users_grad_kernel(Args A,
                                                                 float* __restrict__ partial) {
  extern __shared__ float smem[];
  Tiles t(smem, A.D, K);
  float* ps = t.is + kTI * t.ild;
  unsigned char* kss = reinterpret_cast<unsigned char*>(ps + kUB * kPsLd);
  const int bl = threadIdx.x / kDuThreadsPerUser, g = threadIdx.x % kDuThreadsPerUser;
  const int dims = (A.D - g + kDuThreadsPerUser - 1) / kDuThreadsPerUser;  // g + 8 e < D
  load_users(A, t, blockIdx.x);
  float acc[K][kDuDims];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < kDuDims; ++e) acc[k][e] = 0.0f;
  const int first = blockIdx.y * A.tiles_per_split;
  const int last = min(first + A.tiles_per_split, A.item_tiles);
  for (int tile = first; tile < last; ++tile) {
    const int64_t base = (int64_t)tile * kTI;
    __syncthreads();
    load_items(A, t, base);
    __syncthreads();
    tile_p<K>(A, t, base, blockIdx.x, ps, kss);
    __syncthreads();
    for (int i = 0; i < kTI; ++i) {
      const float w = ps[bl * kPsLd + i];
      const int kk = kss[bl * kKsLd + i];
      float wk[K];
#pragma unroll
      for (int k = 0; k < K; ++k) wk[k] = kk == k ? w : 0.0f;
#pragma unroll
      for (int e = 0; e < kDuDims; ++e) {
        if (e >= dims) break;
        const float it = t.is[i * t.ild + g + kDuThreadsPerUser * e];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k][e] = fmaf(wk[k], it, acc[k][e]);
      }
    }
  }
  const int64_t b = (int64_t)blockIdx.x * kUB + bl;
  if (b >= A.B) return;
  float* out = partial + (int64_t)blockIdx.y * A.B * K * A.D + b * K * A.D;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < kDuDims; ++e)
      if (e < dims) out[k * A.D + g + kDuThreadsPerUser * e] = acc[k][e];
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

// The shared-memory opt-in of each instantiation, per device.
size_t g_opted[3][kMaxK + 1][rp::kMaxDevices] = {};

template <int K>
cudaError_t launch_lse(const Args& A, float* pm, float* psum, float* lse, cudaStream_t st) {
  const size_t bytes = sizeof(float) * z_smem_floats(A.D, K);
  cudaError_t err = rp::opt_in((const void*)lse_partial_kernel<K>, bytes, g_opted[0][K]);
  if (err != cudaSuccess) return err;
  lse_partial_kernel<K><<<dim3(A.user_tiles, A.splits), kThreads, bytes, st>>>(A, pm, psum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_combine_kernel<<<(unsigned)((A.B + 255) / 256), 256, 0, st>>>(pm, psum, A.splits, A.B,
                                                                     lse);
  return cudaGetLastError();
}

size_t grad_smem_bytes(int D, int K) {
  return sizeof(float) * (z_smem_floats(D, K) + (size_t)kUB * kPsLd) + (size_t)kUB * kKsLd;
}

template <int K>
cudaError_t launch_grads(const Args& A, float* du, float* d_items, float* partial,
                         cudaStream_t st) {
  const size_t bytes = grad_smem_bytes(A.D, K);
  cudaError_t err = rp::opt_in((const void*)items_grad_kernel<K>, bytes, g_opted[1][K]);
  if (err != cudaSuccess) return err;
  err = rp::opt_in((const void*)users_grad_kernel<K>, bytes, g_opted[2][K]);
  if (err != cudaSuccess) return err;
  items_grad_kernel<K><<<A.item_tiles, kThreads, bytes, st>>>(A, d_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  users_grad_kernel<K><<<dim3(A.user_tiles, A.splits), kThreads, bytes, st>>>(A, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rp::sum_slices(partial, A.splits, A.B * K * A.D, du, st);
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

// 4-byte words of workspace rp_multimax_grads_f32 needs.
extern "C" long long rp_multimax_grads_workspace_words(long long B, int K, int D,
                                                       long long rows) {
  if (!shape_ok(B, K, D, rows, 1)) return 0;
  const Args A = make_args(nullptr, nullptr, nullptr, B, K, D, rows, 1, 0, kBwdTargetBlocks);
  return (long long)A.splits * B * K * D;
}

// The forward's inputs and its lse [B]; writes du [B, K, D] and d_items
// [rows, D] (every row, padding included).  workspace: at least
// rp_multimax_grads_workspace_words words.  Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int rp_multimax_grads_f32(const void* u, const void* items, const void* lse, void* du,
                                     void* d_items, void* workspace, long long workspace_words,
                                     long long B, int K, int D, long long rows,
                                     long long valid_v, int zero_row0, void* stream) {
  if (!shape_ok(B, K, D, rows, valid_v) ||
      workspace_words < rp_multimax_grads_workspace_words(B, K, D, rows))
    return (int)cudaErrorInvalidValue;
  const Args A = make_args(u, items, lse, B, K, D, rows, valid_v, zero_row0, kBwdTargetBlocks);
  float* g_du = static_cast<float*>(du);
  float* g_items = static_cast<float*>(d_items);
  float* partial = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch_grads<1>(A, g_du, g_items, partial, st);
    case 2: return (int)launch_grads<2>(A, g_du, g_items, partial, st);
    case 3: return (int)launch_grads<3>(A, g_du, g_items, partial, st);
    default: return (int)launch_grads<4>(A, g_du, g_items, partial, st);
  }
}
