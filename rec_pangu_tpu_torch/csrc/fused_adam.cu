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
// 3. a block owns a tile of table rows (tile_plan in ops/kernels/fused_adam.py:
//    at most 2048 floats, whole 128-byte lines, and enough tiles to give
//    every SM several blocks at every width).  Its threads list the tile's run starts
//    from the start words (so a tile with one huge run costs a word per 32
//    entries), then copy each run's sum, one thread a (run, column) pair,
//    into a zeroed shared-memory gradient tile.  Then the block streams its
//    slice of p, m and v once, as 16-byte vectors over the slice's flat
//    extent whatever the row width, and updates them in place.  No block
//    reads another block's rows, so in place is safe; the JAX kernel's fresh
//    output buffers were a Mosaic write-back workaround, not part of the
//    value.
//
// Bound: bytes.  p, m and v are each read and written once (6 x 205.5 MB at
// the bench shape), the cotangent rows and the ids read once: 1.250 GB,
// 0.373 ms at 3.35 TB/s.  The compact buffer adds up to twice the rows' bytes
// (written, then read).  Every operation is rounded on its own (__fmul_rn
// and friends: no fused multiply-add), in the order above, so a row whose
// gradient sums the same terms in the same order gets the same bits as the
// plain PyTorch version; how the sums reach the tile changes no bit.  No
// float atomics: the result is the same bits on every run.
//
// Two options, each a template flag, so the kernel without them is the one
// above: a dense gradient [num_rows, dim] f32 added to each tile's run sums
// before the Adam math (g = sums + dense, the JAX kernel's has_dense stream:
// the streaming softmax-CE's item gradient, fused_adam.py:153-155), and m
// and v stored as bfloat16 (REC_PANGU_TPU_MOMENT_DTYPE=bf16): loaded exactly
// into f32, all arithmetic f32, stored rounded to nearest even, as
// jnp.astype does (fused_adam.py:162-168), four values (8 bytes) an access.
// At the sequence bench shape (1,007,616 x 64, 51,200 history rows) the
// dense stream makes the bound 1,818,959,872 B (0.543 ms) with f32 moments
// and 1,303,060,480 B (0.389 ms) with bf16 ones.
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// Adam on one element whose moments are stored as MT.
template <typename MT>
__device__ __forceinline__ void adam_stored(float g, float& p, MT& m, MT& v, const Hyper& h) {
  float mf = to_f32(m), vf = to_f32(v);
  adam(g, p, mf, vf, h);
  m = from_f32(mf, (MT*)nullptr);
  v = from_f32(vf, (MT*)nullptr);
}

// kW values of type T, loaded and stored as one access
template <typename T, int kW>
struct alignas(sizeof(T) * kW) Pack {
  T v[kW];
};

constexpr int kThreads = 256;  // a tile block's threads

// Block b owns table rows [b * tile_rows, ...): its gradient tile in shared
// memory (tile_rows * dim floats), then the list of its run starts
// (tile_rows sorted positions: an in-range id starts one run at most).  The
// tile's slices of p, m, v (and dense) are streamed as groups of kW floats
// over their flat extent, the last tile's ragged end one float at a time.
template <typename MT, bool kDense, int kW>
__global__ void __launch_bounds__(kThreads)
    adam_tile_kernel(const int32_t* __restrict__ sorted_ids, const float* __restrict__ sums,
                     const uint32_t* __restrict__ run_starts,
                     const int32_t* __restrict__ tile_starts, float* __restrict__ p,
                     MT* __restrict__ m, MT* __restrict__ v, const float* __restrict__ dense,
                     int64_t num_rows, int dim, int tile_rows, Hyper h) {
  extern __shared__ float4 smem[];
  __shared__ int listed;
  float* acc = reinterpret_cast<float*>(smem);
  int32_t* runs = reinterpret_cast<int32_t*>(acc + tile_rows * dim);
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t base = (int64_t)blockIdx.x * tile_rows;
  const int rows = num_rows - base < tile_rows ? (int)(num_rows - base) : tile_rows;
  const int floats = rows * dim;
  const int64_t lo = __ldg(tile_starts + blockIdx.x);
  const int64_t hi = __ldg(tile_starts + blockIdx.x + 1);
  for (int i = tid; i < floats; i += kThreads) acc[i] = 0.0f;
  if (tid == 0) listed = 0;
  __syncthreads();

  // list the run starts of the tile's entries [lo, hi): thread t reads the
  // start word of chunk first + t, + kThreads, ... (a warp-uniform loop)
  const int64_t first = lo / rp::kChunk, end = (hi + rp::kChunk - 1) / rp::kChunk;
  for (int64_t c0 = first; c0 < end; c0 += kThreads) {
    const int64_t c = c0 + tid;
    unsigned word = 0;
    if (c < end) {
      const int64_t s = c * rp::kChunk;
      word = __ldg(run_starts + c);
      if (s < lo) word &= ~0u << (lo - s);
      if (hi - s < rp::kChunk) word &= (1u << (hi - s)) - 1u;
    }
    const int count = __popc(word);
    int upto = count;  // the warp's inclusive scan of the counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(rp::kFull, upto, o);
      if (lane >= o) upto += y;
    }
    int at = 0;
    if (lane == 31 && upto > 0) at = atomicAdd(&listed, upto);
    at = __shfl_sync(rp::kFull, at, 31) + upto - count;
    for (; word; word &= word - 1) runs[at++] = (int32_t)(c * rp::kChunk + __ffs(word) - 1);
  }
  __syncthreads();

  // each run's sum to its row of the tile: a thread a (run, column) pair
  const int pairs = listed * dim;
  for (int f = tid; f < pairs; f += kThreads) {
    const int k = f / dim, col = f - k * dim;
    const int32_t j = runs[k];
    const int row = (int)(__ldg(sorted_ids + j) - base);
    acc[row * dim + col] = __ldg(sums + (int64_t)j * dim + col);
  }
  __syncthreads();

  using V = Pack<float, kW>;
  using MP = Pack<MT, kW>;
  float* ps = p + base * dim;
  MT* ms = m + base * dim;
  MT* vs = v + base * dim;
  const float* ds = kDense ? dense + base * dim : nullptr;
  const int groups = floats / kW;
  V* pg = reinterpret_cast<V*>(ps);
  MP* mg = reinterpret_cast<MP*>(ms);
  MP* vg = reinterpret_cast<MP*>(vs);
  const V* gg = reinterpret_cast<const V*>(acc);
  const V* dg = reinterpret_cast<const V*>(ds);
#pragma unroll 4
  for (int q = tid; q < groups; q += kThreads) {
    V pv = pg[q], gv = gg[q];
    MP mv = mg[q], vv = vg[q];
    if constexpr (kDense) {
      const V dv = dg[q];
#pragma unroll
      for (int k = 0; k < kW; ++k) gv.v[k] = __fadd_rn(gv.v[k], dv.v[k]);
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) adam_stored(gv.v[k], pv.v[k], mv.v[k], vv.v[k], h);
    pg[q] = pv;
    mg[q] = mv;
    vg[q] = vv;
  }
  for (int e = groups * kW + tid; e < floats; e += kThreads) {  // the ragged end
    const float g = kDense ? __fadd_rn(acc[e], ds[e]) : acc[e];
    adam_stored(g, ps[e], ms[e], vs[e], h);
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

// Shared memory of a tile block: its gradient tile and its run list.
size_t tile_shared(int tile_rows, int dim) {
  return (size_t)tile_rows * dim * sizeof(float) + (size_t)tile_rows * sizeof(int32_t);
}

// The tile kernel for one moment type and dense option, float4 groups when
// every tile's slice is whole float4s (tile_rows * dim % 4 == 0) and every
// array is aligned to its group's bytes, else one float at a time.
template <typename MT, bool kDense>
cudaError_t launch_tiles(const int32_t* s, const Scratch& scratch, float* p, void* m, void* v,
                         int64_t num_rows, int dim, int tile_rows, const Hyper& h,
                         const float* dense, unsigned grid, cudaStream_t st) {
  const auto aligned = [](const void* ptr, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(ptr) % a == 0;
  };
  const bool vec4 = (int64_t)tile_rows * dim % 4 == 0 && aligned(p, 16) &&
                    aligned(m, 4 * sizeof(MT)) && aligned(v, 4 * sizeof(MT)) &&
                    (!kDense || aligned(dense, 16));
  MT* mm = static_cast<MT*>(m);
  MT* vv = static_cast<MT*>(v);
  const size_t shared = tile_shared(tile_rows, dim);
  if (vec4)
    adam_tile_kernel<MT, kDense, 4><<<grid, kThreads, shared, st>>>(
        s, scratch.sums, scratch.run_starts, scratch.tile_starts, p, mm, vv, dense, num_rows,
        dim, tile_rows, h);
  else
    adam_tile_kernel<MT, kDense, 1><<<grid, kThreads, shared, st>>>(
        s, scratch.sums, scratch.run_starts, scratch.tile_starts, p, mm, vv, dense, num_rows,
        dim, tile_rows, h);
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
// tile_rows)), written before it is read.  tile_rows * (dim + 1) * 4 bytes
// of shared memory per block, at most 48 KB.  All contiguous on the current
// device.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rp_fused_adam_f32(const void* sorted_ids, const void* perm, const void* rows,
                                 long long n, void* workspace, long long workspace_words,
                                 void* p, void* m, void* v, long long num_rows, int dim,
                                 int tile_rows, float lr, float b1, float b2, float eps,
                                 float inv_b1c, float inv_b2c, const void* dense,
                                 int moments_bf16, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || num_rows <= 0 || dim <= 0 || tile_rows <= 0 ||
      tile_shared(tile_rows, dim) > 48 * 1024 ||
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
                                    scratch.run_starts, scratch.levels, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  tile_starts_kernel<<<(unsigned)((n + threads) / threads), threads, 0, st>>>(
      s, n, num_rows, tile_rows, blocks, scratch.tile_starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Hyper h{lr, b1, b2, eps, inv_b1c, inv_b2c};
  float* pp = static_cast<float*>(p);
  const float* dd = static_cast<const float*>(dense);
  const unsigned grid = (unsigned)blocks;
  if (moments_bf16) {
    err = dd ? launch_tiles<__nv_bfloat16, true>(s, scratch, pp, m, v, num_rows, dim, tile_rows,
                                                 h, dd, grid, st)
             : launch_tiles<__nv_bfloat16, false>(s, scratch, pp, m, v, num_rows, dim,
                                                  tile_rows, h, dd, grid, st);
  } else {
    err = dd ? launch_tiles<float, true>(s, scratch, pp, m, v, num_rows, dim, tile_rows, h, dd,
                                         grid, st)
             : launch_tiles<float, false>(s, scratch, pp, m, v, num_rows, dim, tile_rows, h, dd,
                                          grid, st);
  }
  return (int)err;
}
