// One dense-semantics Adam step on an embedding table, with the table's
// gradient summed in the same call, for Hopper (sm_90a).
//
// For every table row r, with g the sum of r's cotangent rows (0 when r is
// absent from the batch), in optax's order (rec_pangu_tpu/ops/kernels/
// fused_adam.py:165-171):
//
//   m = b1*m + (1-b1)*g
//   v = b2*v + (1-b2)*g*g
//   p = p - lr*(m*inv_b1c) / (sqrt(v*inv_b2c) + eps)
//
// Replaces the JAX package's K3 (fused_adam.py, _adam_tile_kernel behind
// planned_adam_update).  That kernel keeps each vocab tile's gradient in VMEM
// while it accumulates the tile's chunks of a host sort plan by one-hot
// matmuls, then streams p, m and v through Adam, so the dense gradient never
// reaches device memory.  Here:
//
// 1. the levels of segment_sum.cuh sum each run of equal ids with a fixed
//    tree of warps, however long the run, into a compact [n, dim] buffer at
//    the run's first sorted position, and mark the positions where runs
//    start (one 32-bit word per 32 sorted entries);
// 2. a small launch finds where each tile's entries start in the sorted ids;
// 3. a block owns a tile of table rows: it copies its runs' sums into a
//    shared-memory gradient tile (reading one start word per 32 entries, so
//    a tile with one huge run costs little), then streams its slice of p, m
//    and v once and updates them in place.  No block reads another block's
//    rows, so in place is safe; the JAX kernel's fresh output buffers were a
//    Mosaic write-back workaround, not part of the value.
//
// Bound: bytes.  p, m and v are each read and written once (6 x 205.5 MB at
// the bench shape), the cotangent rows and the ids read once: 1.250 GB,
// 0.373 ms at 3.35 TB/s.  The compact buffer adds up to twice the rows' bytes
// (written, then read).  The tile stream is float4 and coalesced.  Every
// operation is rounded on its own (__fmul_rn and friends: no fused
// multiply-add), in the order above, so a row whose gradient sums the same
// terms in the same order gets the same bits as the plain PyTorch version.
// No atomics: the result is the same bits on every run.
//
// Two options, each a template flag, so the kernel without them is the one
// above: a dense gradient [num_rows, dim] f32 added to each tile's run sums
// before the Adam math (g = sums + dense, the JAX kernel's has_dense stream:
// the streaming softmax-CE's item gradient, fused_adam.py:153-155), and m
// and v stored as bfloat16 (REC_PANGU_TPU_MOMENT_DTYPE=bf16): loaded exactly
// into f32, all arithmetic f32, stored rounded to nearest even, as
// jnp.astype does (fused_adam.py:162-168).  At the sequence bench shape
// (1,007,616 x 64, 51,200 history rows) the dense stream makes the bound
// 1,818,959,872 B (0.543 ms) with f32 moments and 1,303,060,480 B (0.389 ms)
// with bf16 ones.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

struct Hyper {
  float lr, b1, b2, eps, inv_b1c, inv_b2c;
};

__device__ __forceinline__ void adam(float g, float& p, float& m, float& v, const Hyper& h) {
  const float mu = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(__fsub_rn(1.0f, h.b1), g));
  const float nu =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fsub_rn(1.0f, h.b2), __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_b2c)), h.eps);
  const float step = __fdiv_rn(__fmul_rn(h.lr, __fmul_rn(mu, h.inv_b1c)), den);
  p = __fsub_rn(p, step);
  m = mu;
  v = nu;
}

// Tile of table row `id`: -1 below the table, num_tiles at or past its end.
__device__ __forceinline__ int64_t tile_of(int32_t id, int64_t num_rows, int tile_rows,
                                           int64_t num_tiles) {
  if (id < 0) return -1;
  if (id >= num_rows) return num_tiles;
  return id / tile_rows;
}

// starts[t] = the first sorted position whose id lies in tile t or later,
// for t in [0, num_tiles]: tile t's entries are [starts[t], starts[t + 1]).
// Thread i (in [0, n]) writes the entries of the tiles that begin between
// sorted positions i - 1 and i, so each entry is written exactly once.
__global__ void tile_starts_kernel(const int32_t* __restrict__ sorted_ids, int64_t n,
                                   int64_t num_rows, int tile_rows, int64_t num_tiles,
                                   int32_t* __restrict__ starts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int64_t prev =
      i == 0 ? -1 : tile_of(__ldg(sorted_ids + i - 1), num_rows, tile_rows, num_tiles);
  const int64_t cur =
      i == n ? num_tiles + 1 : tile_of(__ldg(sorted_ids + i), num_rows, tile_rows, num_tiles);
  const int64_t last = cur < num_tiles ? cur : num_tiles;
  for (int64_t t = prev + 1; t <= last; ++t) starts[t] = (int32_t)i;
}

// Copies the run sums that start at the set bits of `bits` (sorted positions
// chunk + b) into acc, 8 rows in flight (few registers: the block's Adam
// stream that follows wants many warps).  Every lane of the warp calls it
// with the same arguments.
template <int kCols>
__device__ __forceinline__ void copy_runs(unsigned bits, int64_t chunk,
                                          const int32_t* __restrict__ sorted_ids,
                                          const float* __restrict__ sums, int dim,
                                          int64_t base, float* acc) {
  const int lane = threadIdx.x & 31;
  const bool mine = (bits >> lane) & 1u;
  const int rank = __popc(bits & ((1u << lane) - 1u));
  const int count = __popc(bits);
  constexpr int kGroup = 8;
  for (int c0 = 0; c0 < dim; c0 += 32 * kCols) {
    for (int r0 = 0; r0 < count; r0 += kGroup) {
      float buf[kGroup][kCols];
      int row[kGroup];  // in the tile, -1 for none
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const unsigned sel = __ballot_sync(rp::kFull, mine && rank == r0 + g);
        const int64_t j = chunk + (sel ? __ffs(sel) - 1 : 0);
        row[g] = sel ? (int)(__ldg(sorted_ids + j) - base) : -1;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = c0 + lane + 32 * k;
          buf[g][k] = sel && c < dim ? __ldg(sums + j * dim + c) : 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (row[g] < 0) continue;  // the same for every lane
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < dim) acc[row[g] * dim + c] = buf[g][k];  // < 48 KB: no overflow
        }
      }
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// kW moment values of type MT, loaded and stored as one access
template <typename MT, int kW>
struct alignas(sizeof(MT) * kW) Pack {
  MT v[kW];
};

template <typename V, int kCols, typename MT = float, bool kDense = false>
__global__ void __launch_bounds__(256)
    fused_adam_kernel(const int32_t* __restrict__ sorted_ids, const float* __restrict__ sums,
                      const uint32_t* __restrict__ run_starts,
                      const int32_t* __restrict__ tile_starts, float* __restrict__ p,
                      MT* __restrict__ m, MT* __restrict__ v, int64_t num_rows, int dim,
                      int tile_rows, Hyper h, const float* __restrict__ dense) {
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int64_t base = (int64_t)blockIdx.x * tile_rows;
  const int64_t tile = num_rows - base < tile_rows ? num_rows - base : tile_rows;
  for (int64_t i = threadIdx.x; i < tile * dim; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  // the tile's entries are [lo, hi); warp w reads the start words of chunks
  // first + 32w + lane, ... (the loop bound is the same for every lane)
  const int lane = threadIdx.x & 31;
  const int64_t lo = __ldg(tile_starts + blockIdx.x);
  const int64_t hi = __ldg(tile_starts + blockIdx.x + 1);
  const int64_t first = lo / rp::kChunk, end = (hi + rp::kChunk - 1) / rp::kChunk;
  for (int64_t c = first + (threadIdx.x >> 5) * 32; c < end; c += (blockDim.x >> 5) * 32) {
    unsigned word = 0;
    if (c + lane < end) {
      const int64_t s = (c + lane) * rp::kChunk;
      word = __ldg(run_starts + c + lane);
      if (s < lo) word &= ~0u << (lo - s);
      if (hi - s < rp::kChunk) word &= (1u << (hi - s)) - 1u;
    }
    unsigned busy = __ballot_sync(rp::kFull, word != 0);
    while (busy) {
      const int l = __ffs(busy) - 1;
      busy &= busy - 1;
      copy_runs<kCols>(__shfl_sync(rp::kFull, word, l), (c + l) * rp::kChunk, sorted_ids, sums,
                       dim, base, acc);
    }
  }
  __syncthreads();

  constexpr int kWidth = sizeof(V) / sizeof(float);
  const int64_t count = tile * dim / kWidth;
  const V* gs = reinterpret_cast<const V*>(acc);
  V* ps = reinterpret_cast<V*>(p + base * dim);
  using MP = Pack<MT, kWidth>;
  MP* ms = reinterpret_cast<MP*>(m + base * dim);
  MP* vs = reinterpret_cast<MP*>(v + base * dim);
  const V* ds = kDense ? reinterpret_cast<const V*>(dense + base * dim) : nullptr;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    V pv = ps[i], gv = gs[i];
    MP mv = ms[i], vv = vs[i];
    float* pf = reinterpret_cast<float*>(&pv);
    float* gf = reinterpret_cast<float*>(&gv);
    if constexpr (kDense) {
      const V dv = ds[i];
      const float* df = reinterpret_cast<const float*>(&dv);
#pragma unroll
      for (int k = 0; k < kWidth; ++k) gf[k] = __fadd_rn(gf[k], df[k]);
    }
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      float mf = to_f32(mv.v[k]), vf = to_f32(vv.v[k]);
      adam(gf[k], pf[k], mf, vf, h);
      mv.v[k] = from_f32(mf, (MT*)nullptr);
      vv.v[k] = from_f32(vf, (MT*)nullptr);
    }
    ps[i] = pv;
    ms[i] = mv;
    vs[i] = vv;
  }
}

// The scratch of one call, carved from one workspace: the run sums [n, dim]
// f32 first (the workspace's own alignment), then the run-start words
// [ceil(n / 32)], the tile starts [tiles + 1] and the levels.
struct Scratch {
  float* sums;
  uint32_t* run_starts;
  int32_t* tile_starts;
  void* levels;
};

int64_t scratch_words(int64_t n, int dim, int64_t tiles) {
  return n * dim + (n + rp::kChunk - 1) / rp::kChunk + tiles + 1 + rp::workspace_words(n, dim);
}

Scratch carve(void* workspace, int64_t n, int dim, int64_t tiles) {
  float* sums = static_cast<float*>(workspace);
  uint32_t* run_starts = reinterpret_cast<uint32_t*>(sums + n * dim);
  int32_t* tile_starts =
      reinterpret_cast<int32_t*>(run_starts + (n + rp::kChunk - 1) / rp::kChunk);
  return Scratch{sums, run_starts, tile_starts, tile_starts + tiles + 1};
}

// The tile kernel for one moment type and dense option, at the widths the
// row allows (float4 when dim % 4 == 0 and the arrays are aligned).
template <typename MT, bool kDense>
cudaError_t launch_tiles(const int32_t* s, const Scratch& scratch, float* p, void* m, void* v,
                         int64_t num_rows, int dim, int tile_rows, const Hyper& h,
                         const float* dense, unsigned grid, size_t shared, cudaStream_t st) {
  const auto aligned = [](const void* ptr, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(ptr) % a == 0;
  };
  const bool vec4 = dim % 4 == 0 && aligned(p, 16) && aligned(m, 4 * sizeof(MT)) &&
                    aligned(v, 4 * sizeof(MT)) && (!kDense || aligned(dense, 16));
  MT* mm = static_cast<MT*>(m);
  MT* vv = static_cast<MT*>(v);
#define RP_ADAM(V, COLS)                                                                  \
  fused_adam_kernel<V, COLS, MT, kDense><<<grid, 256, shared, st>>>(                       \
      s, scratch.sums, scratch.run_starts, scratch.tile_starts, p, mm, vv, num_rows, dim, \
      tile_rows, h, dense)
  switch (rp::cols_per_lane(dim) * (vec4 ? 1 : -1)) {
    case 1: RP_ADAM(float4, 1); break;
    case 2: RP_ADAM(float4, 2); break;
    case 4: RP_ADAM(float4, 4); break;
    case -1: RP_ADAM(float, 1); break;
    case -2: RP_ADAM(float, 2); break;
    default: RP_ADAM(float, 4);
  }
#undef RP_ADAM
  return cudaGetLastError();
}

}  // namespace

// 4-byte words of scratch rp_fused_adam_f32 needs.
extern "C" long long rp_fused_adam_workspace_words(long long n, long long num_rows, int dim,
                                                   int tile_rows) {
  return scratch_words(n, dim, (num_rows + tile_rows - 1) / tile_rows);
}

// sorted_ids [n] i32 ascending and perm [n] i32 (a stable sort of the fused
// ids), rows [*, dim] f32; p [num_rows, dim] f32 and m, v [num_rows, dim]
// (f32, or bf16 when moments_bf16), updated in place; dense [num_rows, dim]
// f32 added to the gradient, or null; workspace of workspace_words 4-byte
// words (at least rp_fused_adam_workspace_words(n, num_rows, dim,
// tile_rows)), written before it is read.  tile_rows * dim * 4 bytes of
// shared memory per block, at most 48 KB.  All contiguous on the current
// device.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rp_fused_adam_f32(const void* sorted_ids, const void* perm, const void* rows,
                                 long long n, void* workspace, long long workspace_words,
                                 void* p, void* m, void* v, long long num_rows, int dim,
                                 int tile_rows, float lr, float b1, float b2, float eps,
                                 float inv_b1c, float inv_b2c, const void* dense,
                                 int moments_bf16, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || num_rows <= 0 || dim <= 0 || tile_rows <= 0 ||
      (long long)tile_rows * dim * 4 > 48 * 1024 ||
      workspace_words < rp_fused_adam_workspace_words(n, num_rows, dim, tile_rows))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (num_rows + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(sorted_ids);
  const Scratch scratch = carve(workspace, n, dim, blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = rp::segment_sum(s, static_cast<const int32_t*>(perm),
                                    static_cast<const float*>(rows), n, dim,
                                    rp::Output{scratch.sums, false, num_rows},
                                    scratch.run_starts, scratch.levels, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  tile_starts_kernel<<<(unsigned)((n + threads) / threads), threads, 0, st>>>(
      s, n, num_rows, tile_rows, blocks, scratch.tile_starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t shared = (size_t)tile_rows * dim * sizeof(float);
  const Hyper h{lr, b1, b2, eps, inv_b1c, inv_b2c};
  float* pp = static_cast<float*>(p);
  const float* dd = static_cast<const float*>(dense);
  const unsigned grid = (unsigned)blocks;
  if (moments_bf16) {
    err = dd ? launch_tiles<__nv_bfloat16, true>(s, scratch, pp, m, v, num_rows, dim, tile_rows,
                                                 h, dd, grid, shared, st)
             : launch_tiles<__nv_bfloat16, false>(s, scratch, pp, m, v, num_rows, dim,
                                                  tile_rows, h, dd, grid, shared, st);
  } else {
    err = dd ? launch_tiles<float, true>(s, scratch, pp, m, v, num_rows, dim, tile_rows, h, dd,
                                         grid, shared, st)
             : launch_tiles<float, false>(s, scratch, pp, m, v, num_rows, dim, tile_rows, h, dd,
                                          grid, shared, st);
  }
  return (int)err;
}
