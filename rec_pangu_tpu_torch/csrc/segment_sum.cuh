// Segment sums of embedding cotangent rows over a stable sort of the ids,
// shared by the table gradient (embedding_grad.cu) and the fused table Adam
// (fused_adam.cu).
//
// Input: the batch's fused ids sorted on the device with a stable sort
// (sorted_ids [n] ascending, perm [n] the batch position of each sorted
// entry) and the cotangent rows [n_batch, dim] in batch order.  Equal ids
// form runs in the sorted stream; a run's sum is the table row's gradient.
//
// The sums are a fixed tree, so the work of a warp is bounded however long
// a run is, and the bits are the same on every run:
//
// - Level 0: warp w takes the 32 sorted entries [32w, 32w + 32), loads their
//   rows (all 32 at once at dim <= 32; independent loads: the row indices
//   come from a shuffle, not from the loop) and sums each run of equal ids
//   in sorted order.  A run that starts and ends inside the chunk is
//   complete and is written to its output row.  The chunk's first and last runs may go on
//   in the neighbouring chunks: they become two "pieces" of the next level,
//   (id, partial sum), the second a zero row when the whole chunk is one run.
// - Level L + 1 is level L's pieces, 2 per chunk, again sorted by id, and is
//   reduced the same way, until a level fits one chunk: there every run is
//   complete.  131,072 ids take levels of 131,072, 8,192, 512 and 32 entries.
//
// No two threads ever write the same output element, so there are no
// atomics.  Within a chunk the terms are added in sorted order, which is
// batch order (the sort is stable); pieces are then added in sorted order.
// Adding the zero rows changes no sum.  Ids outside [0, num_rows) form runs
// like any other and are dropped where they would be written.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;  // sorted entries one warp reduces

// Columns a lane holds per pass over the rows (kCols, one pass covers
// 32 * kCols columns) and rows it has in flight (kGroup): 32 registers of
// row data whatever the width, so at dim <= 32 a chunk's 32 rows are
// loaded at once.
__host__ __device__ constexpr int group_rows(int cols) { return 32 / cols; }

inline int cols_per_lane(int dim) { return dim <= 32 ? 1 : dim <= 64 ? 2 : 4; }

// Entries of the level after a level of n entries (two pieces per chunk),
// 0 when n fits one chunk and that level is the last.
__host__ __device__ inline int64_t next_level_size(int64_t n) {
  return n > kChunk ? 2 * ((n + kChunk - 1) / kChunk) : 0;
}

// 4-byte words of workspace the levels after the first need: two buffers
// (read one, write the other) of next_level_size(n) entries, each entry an
// id, a position and a row of dim floats.
inline int64_t workspace_words(int64_t n, int dim) {
  return 2 * next_level_size(n) * (2 + (int64_t)dim);
}

struct Level {
  const int32_t* keys;  // [n] ascending ids
  const int32_t* src;   // the row of `rows` each entry adds; null: its own index
  const int32_t* pos;   // the level-0 position each entry's sum starts at; null: its own index
  const float* rows;
  int64_t n;
};

struct Pieces {  // the next level's buffers; keys == nullptr on the last level
  int32_t* keys;
  int32_t* pos;
  float* rows;
};

struct Output {
  float* rows;      // complete runs go to rows + (by_id ? id : pos) * dim
  bool by_id;
  int64_t num_rows; // runs of ids outside [0, num_rows) are dropped
};

// Every lane of the warp calls it with the same run: lane l holds the run's
// columns c0 + l + 32k.
template <int kCols>
__device__ __forceinline__ void flush_run(const float (&sum)[kCols], int32_t id,
                                          int32_t pos, bool complete, int64_t slot,
                                          bool zero_next, const Pieces& next,
                                          const Output& out, int dim, int c0) {
  const int lane = threadIdx.x & 31;
  float* dst;
  if (complete) {
    if (id < 0 || id >= out.num_rows) return;
    dst = out.rows + (int64_t)(out.by_id ? id : pos) * dim;
  } else {
    dst = next.rows + slot * dim;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = c0 + lane + 32 * k;
    if (c < dim) {
      dst[c] = sum[k];
      if (zero_next) dst[dim + c] = 0.0f;
    }
  }
}

// One level: warp w reduces entries [32w, 32w + 32) of `in`.  On level 0,
// `starts` (when not null) gets, per chunk, the bits of the entries that
// begin a run of an id in [0, num_rows).
template <int kCols>
__global__ void __launch_bounds__(256)
    reduce_level_kernel(Level in, Pieces next, Output out, int dim,
                        uint32_t* __restrict__ starts) {
  constexpr int kGroup = group_rows(kCols);
  const int lane = threadIdx.x & 31;
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t base = w * kChunk;
  if (base >= in.n) return;  // the whole warp leaves together
  const int cnt = in.n - base < kChunk ? (int)(in.n - base) : kChunk;
  const int64_t i = base + lane;
  const bool valid = lane < cnt;
  const int32_t key = valid ? __ldg(in.keys + i) : 0;
  const int32_t src = !valid ? 0 : in.src ? __ldg(in.src + i) : (int32_t)i;
  const int32_t pos = !valid ? 0 : in.pos ? __ldg(in.pos + i) : (int32_t)i;
  const int32_t first = __shfl_sync(kFull, key, 0);
  const int32_t last = __shfl_sync(kFull, key, cnt - 1);
  const int last_lane = __ffs(__ballot_sync(kFull, valid && key == last)) - 1;

  if (starts != nullptr) {
    const int32_t up = __shfl_up_sync(kFull, key, 1);
    const int32_t before = lane > 0 ? up : (i > 0 ? __ldg(in.keys + i - 1) : key);
    const bool start = valid && key >= 0 && key < out.num_rows && (i == 0 || before != key);
    const unsigned bits = __ballot_sync(kFull, start);
    if (lane == 0) starts[w] = bits;
  }
  const bool last_level = next.keys == nullptr;
  const int32_t last_pos = __shfl_sync(kFull, pos, last_lane);
  if (!last_level && lane == 0) {
    next.keys[2 * w] = first;
    next.pos[2 * w] = pos;
    next.keys[2 * w + 1] = last;
    next.pos[2 * w + 1] = last_pos;
  }

  for (int c0 = 0; c0 < dim; c0 += 32 * kCols) {
    float sum[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) sum[k] = 0.0f;
    int32_t cur = first;  // id of the run being summed
    int run_lane = 0;     // its first entry in the chunk
    for (int e0 = 0; e0 < cnt; e0 += kGroup) {
      float buf[kGroup][kCols];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int e = e0 + g;
        const float* row = in.rows + (int64_t)__shfl_sync(kFull, src, e & 31) * dim;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = c0 + lane + 32 * k;
          buf[g][k] = e < cnt && c < dim ? __ldg(row + c) : 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int e = e0 + g;
        const int32_t ke = __shfl_sync(kFull, key, e & 31);
        if (e >= cnt) break;  // the same for every lane
        if (ke != cur) {      // the run of `cur` ended at e - 1
          const int32_t p = __shfl_sync(kFull, pos, run_lane);
          // a run before the last one: complete unless it is the first
          flush_run(sum, cur, p, last_level || cur != first, 2 * w, false, next, out, dim, c0);
#pragma unroll
          for (int k = 0; k < kCols; ++k) sum[k] = 0.0f;
          cur = ke;
          run_lane = e;
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) sum[k] = __fadd_rn(sum[k], buf[g][k]);
      }
    }
    // the last run: the second piece, or the first (and a zero second piece)
    // when the chunk is one run
    const int32_t p = __shfl_sync(kFull, pos, run_lane);
    flush_run(sum, cur, p, last_level, cur == first ? 2 * w : 2 * w + 1,
              !last_level && cur == first, next, out, dim, c0);
  }
}

// Reduces sorted_ids / perm / rows into `out`, launching one level after
// another on `stream`.  workspace: workspace_words(n, dim) words; starts:
// ceil(n / 32) words or null.  n must be below 2^31.
inline cudaError_t segment_sum(const int32_t* sorted_ids, const int32_t* perm,
                               const float* rows, int64_t n, int dim, Output out,
                               uint32_t* starts, void* workspace, cudaStream_t stream) {
  const int64_t cap = next_level_size(n);
  int32_t* const buffers[2] = {
      static_cast<int32_t*>(workspace),
      static_cast<int32_t*>(workspace) + cap * (2 + (int64_t)dim)};
  Level in{sorted_ids, perm, nullptr, rows, n};
  for (int level = 0; in.n > 0; ++level) {
    const int64_t m = next_level_size(in.n);
    int32_t* buf = buffers[level & 1];
    const Pieces next = m ? Pieces{buf, buf + cap, reinterpret_cast<float*>(buf + 2 * cap)}
                          : Pieces{nullptr, nullptr, nullptr};
    const int threads = 256;
    const int64_t warps = (in.n + kChunk - 1) / kChunk;
    const int64_t blocks = (warps * 32 + threads - 1) / threads;
    uint32_t* marks = level == 0 ? starts : nullptr;
    switch (cols_per_lane(dim)) {
      case 1:
        reduce_level_kernel<1><<<(unsigned)blocks, threads, 0, stream>>>(in, next, out, dim,
                                                                          marks);
        break;
      case 2:
        reduce_level_kernel<2><<<(unsigned)blocks, threads, 0, stream>>>(in, next, out, dim,
                                                                          marks);
        break;
      default:
        reduce_level_kernel<4><<<(unsigned)blocks, threads, 0, stream>>>(in, next, out, dim,
                                                                          marks);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m == 0) return err;
    in = Level{next.keys, nullptr, next.pos, next.rows, m};
  }
  return cudaSuccess;
}

}  // namespace rp
