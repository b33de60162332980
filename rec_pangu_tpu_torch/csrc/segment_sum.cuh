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
// All levels run in one launch.  A warp that has written its chunk's pieces
// counts itself at the next level's chunk they fall in (16 chunks feed
// one); the warp that completes that count reduces the parent chunk, and so
// on up, so a level's chunk starts as soon as its own inputs are written,
// with no launch between levels.  Which warp reduces a chunk changes no sum.
//
// No two threads ever write the same output element, so the sums take no
// float atomics (the counts are integer ones).  Within a chunk the terms are added in sorted order, which is
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

__host__ __device__ inline int64_t chunks_of(int64_t n) { return (n + kChunk - 1) / kChunk; }

constexpr int kFanIn = kChunk / 2;  // chunks whose pieces fill one chunk of the next level
constexpr int kMaxLevels = 8;       // 2^31 - 1 ids take 8 levels

// The levels after the first, carved from the workspace in 4-byte words:
// each level's ids, positions and rows of dim floats, then, per chunk of
// each of those levels, the count of its producer chunks done (zeroed by
// segment_sum before the launch).
struct TreeLayout {
  int levels;
  int64_t n[kMaxLevels];
  int64_t keys[kMaxLevels], pos[kMaxLevels], rows[kMaxLevels], done[kMaxLevels];
  int64_t counts, words;  // the first count word, and the words in all
};

inline TreeLayout tree_layout(int64_t n, int dim) {
  TreeLayout l{};
  l.n[0] = n;
  l.levels = 1;
  while (l.levels < kMaxLevels && next_level_size(l.n[l.levels - 1]) > 0) {
    l.n[l.levels] = next_level_size(l.n[l.levels - 1]);
    ++l.levels;
  }
  int64_t at = 0;
  for (int L = 1; L < l.levels; ++L) {
    l.keys[L] = at;
    l.pos[L] = at + l.n[L];
    l.rows[L] = at + 2 * l.n[L];
    at += l.n[L] * (2 + (int64_t)dim);
  }
  l.counts = at;
  for (int L = 1; L < l.levels; ++L) {
    l.done[L] = at;
    at += chunks_of(l.n[L]);
  }
  l.words = at;
  return l;
}

// 4-byte words of workspace segment_sum needs for n entries of dim columns.
inline int64_t workspace_words(int64_t n, int dim) { return tree_layout(n, dim).words; }

// Of which the counts, at the end.
inline int64_t count_words(int64_t n) {
  const TreeLayout l = tree_layout(n, 0);
  return l.words - l.counts;
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

// Every level's buffers, for the kernel.
struct Tree {
  Level base;  // level 0: the sorted batch
  int32_t* keys[kMaxLevels];
  int32_t* pos[kMaxLevels];
  float* rows[kMaxLevels];
  uint32_t* done[kMaxLevels];
  int64_t n[kMaxLevels];
  int levels;
};

// Level 0 reads the caller's arrays, unchanged during the launch, through
// the read-only path; the later levels read what other warps of the launch
// wrote, through L2.
template <typename T>
__device__ __forceinline__ T load(const T* p, bool shared_in_launch) {
  return shared_in_launch ? __ldcg(p) : __ldg(p);
}

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

// The warp reduces entries [32w, 32w + 32) of `in` (w < chunks_of(in.n)).
// On level 0, `starts` (when not null) gets, per chunk, the bits of the
// entries that begin a run of an id in [0, num_rows).
template <int kCols>
__device__ __forceinline__ void reduce_chunk(const Level& in, int64_t w, bool later,
                                             const Pieces& next, const Output& out, int dim,
                                             uint32_t* __restrict__ starts) {
  constexpr int kGroup = group_rows(kCols);
  const int lane = threadIdx.x & 31;
  const int64_t base = w * kChunk;
  const int cnt = in.n - base < kChunk ? (int)(in.n - base) : kChunk;
  const int64_t i = base + lane;
  const bool valid = lane < cnt;
  const int32_t key = valid ? load(in.keys + i, later) : 0;
  const int32_t src = !valid ? 0 : in.src ? load(in.src + i, later) : (int32_t)i;
  const int32_t pos = !valid ? 0 : in.pos ? load(in.pos + i, later) : (int32_t)i;
  const int32_t first = __shfl_sync(kFull, key, 0);
  const int32_t last = __shfl_sync(kFull, key, cnt - 1);
  const int last_lane = __ffs(__ballot_sync(kFull, valid && key == last)) - 1;

  if (starts != nullptr) {
    const int32_t up = __shfl_up_sync(kFull, key, 1);
    const int32_t before = lane > 0 ? up : (i > 0 ? load(in.keys + i - 1, later) : key);
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
          buf[g][k] = e < cnt && c < dim ? load(row + c, later) : 0.0f;
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

// Warp w reduces level 0's chunk w, then, while it is the last of a
// parent chunk's producers to finish, that parent, up to the last level.
// (The levels' buffers are indexed by level, so the parameter is read in
// place, not copied to local memory.)
template <int kCols>
__global__ void __launch_bounds__(256)
    segment_sum_kernel(const __grid_constant__ Tree t, Output out, int dim,
                       uint32_t* __restrict__ starts) {
  const int lane = threadIdx.x & 31;
  int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= chunks_of(t.n[0])) return;  // the whole warp leaves together
  for (int L = 0;; ++L) {
    const bool last_level = L + 1 == t.levels;
    const Level in = L == 0 ? t.base : Level{t.keys[L], nullptr, t.pos[L], t.rows[L], t.n[L]};
    const Pieces next = last_level ? Pieces{nullptr, nullptr, nullptr}
                                   : Pieces{t.keys[L + 1], t.pos[L + 1], t.rows[L + 1]};
    reduce_chunk<kCols>(in, w, L > 0, next, out, dim, L == 0 ? starts : nullptr);
    if (last_level) return;
    // publish the pieces (every lane's stores, then one count), and go on
    // only as the parent's last producer, after the others' pieces are seen
    const int64_t parent = w / kFanIn;
    const int64_t left = chunks_of(t.n[L]) - parent * kFanIn;
    const uint32_t producers = left < kFanIn ? (uint32_t)left : (uint32_t)kFanIn;
    __threadfence();
    __syncwarp();
    uint32_t done = 0;
    if (lane == 0) done = atomicAdd(t.done[L + 1] + parent, 1u) + 1u;
    if (__shfl_sync(kFull, done, 0) != producers) return;
    __threadfence();
    w = parent;
  }
}

// Reduces sorted_ids / perm / rows into `out` in one launch on `stream`.
// workspace: workspace_words(n, dim) words, 4-byte aligned; counts:
// count_words(n) words the caller has zeroed on the stream, or null to use
// the workspace's own, zeroed here first; starts: ceil(n / 32) words or
// null.  n must be below 2^31.
inline cudaError_t segment_sum(const int32_t* sorted_ids, const int32_t* perm,
                               const float* rows, int64_t n, int dim, Output out,
                               uint32_t* starts, void* workspace, uint32_t* counts,
                               cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const TreeLayout l = tree_layout(n, dim);
  if (next_level_size(l.n[l.levels - 1]) > 0) return cudaErrorInvalidValue;  // too many levels
  int32_t* ws = static_cast<int32_t*>(workspace);
  Tree t{};
  t.base = Level{sorted_ids, perm, nullptr, rows, n};
  t.levels = l.levels;
  for (int L = 0; L < l.levels; ++L) {
    t.n[L] = l.n[L];
    if (L == 0) continue;
    t.keys[L] = ws + l.keys[L];
    t.pos[L] = ws + l.pos[L];
    t.rows[L] = reinterpret_cast<float*>(ws + l.rows[L]);
    t.done[L] = counts != nullptr ? counts + (l.done[L] - l.counts)
                                  : reinterpret_cast<uint32_t*>(ws + l.done[L]);
  }
  if (counts == nullptr && l.words > l.counts) {
    const cudaError_t err =
        cudaMemsetAsync(ws + l.counts, 0, (l.words - l.counts) * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  const int threads = 256;
  const unsigned blocks = (unsigned)((chunks_of(n) * 32 + threads - 1) / threads);
  switch (cols_per_lane(dim)) {
    case 1:
      segment_sum_kernel<1><<<blocks, threads, 0, stream>>>(t, out, dim, starts);
      break;
    case 2:
      segment_sum_kernel<2><<<blocks, threads, 0, stream>>>(t, out, dim, starts);
      break;
    default:
      segment_sum_kernel<4><<<blocks, threads, 0, stream>>>(t, out, dim, starts);
  }
  return cudaGetLastError();
}

}  // namespace rp
