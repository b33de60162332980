// Stable LSD radix sort of a batch's fused ids, for Hopper (sm_90a): the
// prep of the table gradient (embedding_grad.cu) and of the fused table
// Adam, which both sum runs of equal ids in sorted order.
//
// Keys: key = clamp(id, -1, num_rows) + 1 in [0, num_rows + 1], so only
// key_bits = bit_length(num_rows + 1) bits are sorted (21 for a 1,605,632-row
// table), in `passes` digits of `digit_bits` each (at most 8 bits, 256
// buckets: 3 passes of 7 bits at 21 key bits).  The sort writes the clamped
// ids (key - 1) and each one's batch position, both int32.  In-range ids end
// up exactly where a stable sort of the raw ids puts them, because every id
// below 0 still sorts first and every id at or past num_rows last; the
// callers drop both kinds.
//
// One launch counts every pass's digits at once (and, when asked, sets a bit
// per in-range row the batch touches: the table gradient's zero fill skips
// those rows).  Then one launch a pass, in the manner of a "onesweep" sort:
// a block takes the next tile of 1024 entries (a tile counter, so a block
// only ever waits on tiles that blocks already hold), ranks each entry among
// the tile's equal digits in input order (the equal digits of a warp's
// round of 32 found by a ballot a digit bit; counts carried across rounds
// and warps in shared memory), publishes its digit counts, and finds the
// counts of all earlier tiles by decoupled look-back (each status word holds
// a flag and a count; a thread a digit reads four predecessors at a time and
// stops at the first inclusive prefix).  The tile is reordered by digit in
// shared memory, so each digit's entries leave as one contiguous run.
//
// Stable: an entry's position is the count of equal digits before it in
// earlier tiles, earlier warps of its tile, earlier rounds of its warp and
// lower lanes of its round, all of which precede it in input order.  Every
// count is an integer, so the result is the same on every run.
//
// Bound: latency, not bytes.  131,072 ids are 0.5 MB: each pass reads and
// writes about 1 MB, microseconds of bandwidth; the launches and the chain
// of L2 round trips in each pass (tile counter, loads, look-back, scatter)
// set the time, so small tiles (many blocks, few rounds each) win.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp {
namespace sort {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // entries a block ranks
constexpr int kMaxDigitBits = 8;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kMaxPasses = 4;
constexpr int kWindow = 4;  // predecessors a look-back step reads at once
constexpr int kRecentBits = 9;       // a block's table of ids it marked last
constexpr unsigned long long kAggregate = 1ull << 32;  // status: the tile's own count
constexpr unsigned long long kPrefix = 2ull << 32;     // status: count over tiles <= it

struct Plan {
  int key_bits, digit_bits, passes;
};

inline int bit_length(int64_t x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

// A plan the kernels take: it covers every key of a num_rows table.
inline bool plan_ok(int64_t num_rows, Plan p) {
  return num_rows >= 1 && num_rows <= 0x7fffffffLL && p.key_bits == bit_length(num_rows + 1) &&
         p.digit_bits >= 1 && p.digit_bits <= kMaxDigitBits && p.passes >= 1 &&
         p.passes <= kMaxPasses && p.digit_bits * p.passes >= p.key_bits;
}

// The workspace, in 4-byte words: `head` words of the caller's (the row
// marks first, ceil(num_rows / 32) words, when the sort sets them), the
// digit counts of every pass, the tile counters and the look-back statuses,
// all zeroed by sort_begin; then a second key and position buffer the passes
// ping-pong with the output.
struct Layout {
  int64_t marks, hist, counters, status, zeroed, tmp_keys, tmp_pos, words;
};

inline int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

inline Layout layout(int64_t n, Plan p, int64_t head) {
  const int64_t radix = 1LL << p.digit_bits;
  Layout l;
  l.marks = 0;
  l.hist = head;
  l.counters = l.hist + p.passes * radix;
  l.status = (l.counters + p.passes + 1) / 2 * 2;  // 8-byte aligned
  l.zeroed = l.status + 2 * p.passes * tiles_of(n) * radix;
  const int64_t tmp = p.passes > 1 ? n : 0;
  l.tmp_keys = l.zeroed;
  l.tmp_pos = l.tmp_keys + tmp;
  l.words = l.tmp_pos + tmp;
  return l;
}

__device__ __forceinline__ int32_t clamp_id(int32_t id, int32_t num_rows) {
  return id < -1 ? -1 : (id > num_rows ? num_rows : id);
}

// digit of a clamped id v at `shift`: bits of the key v + 1
__device__ __forceinline__ uint32_t digit_of(int32_t v, int shift, uint32_t mask) {
  return (((uint32_t)v + 1u) >> shift) & mask;
}

// The lanes of the warp with a valid digit equal to this lane's (only the
// lane itself when it is not valid), from one ballot a digit bit: cheaper
// than __match_any_sync on this card.  Every lane of the warp calls it.
__device__ __forceinline__ unsigned digit_peers(uint32_t d, bool valid, int bits) {
  unsigned peers = __ballot_sync(kFull, valid);
  for (int b = 0; b < bits; ++b) {
    const unsigned set = __ballot_sync(kFull, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? set : ~set;
  }
  return valid ? peers : 1u << (threadIdx.x & 31);
}

// Sets row v's bit in `marks` if v is a valid in-range id.  A lane whose
// left neighbour holds the same id leaves it to that lane, and so does an
// id the block's `recent` table (when not null) last saw marked, so a hot id
// costs few atomics.  Every lane of the warp calls it.
__device__ __forceinline__ void mark_row(int32_t v, bool valid, int32_t num_rows,
                                         uint32_t* __restrict__ marks, int32_t* recent) {
  const bool in = valid && v >= 0 && v < num_rows;
  const int32_t left = __shfl_up_sync(kFull, in ? v : -1, 1);
  if (!in || ((threadIdx.x & 31) != 0 && left == v)) return;
  if (recent != nullptr) {
    int32_t* slot = recent + ((uint32_t)v * 2654435761u >> (32 - kRecentBits));
    if (*slot == v) return;
    *slot = v;
  }
  atomicOr(marks + (v >> 5), 1u << (v & 31));
}

// Every pass's digit counts over all n ids (and the row marks, when `marks`
// is not null), one tile a block.
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int32_t* __restrict__ ids, int64_t n, int32_t num_rows, Plan p,
                     uint32_t* __restrict__ hist, uint32_t* __restrict__ marks) {
  __shared__ uint32_t counts[kMaxPasses * kMaxRadix];
  __shared__ int32_t recent[1 << kRecentBits];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int radix = 1 << p.digit_bits;
  const uint32_t mask = radix - 1;
  for (int i = t; i < p.passes * radix; i += kThreads) counts[i] = 0;
  for (int i = t; i < (1 << kRecentBits); i += kThreads) recent[i] = -1;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile + warp * (kPerThread * 32) + lane;
  int32_t v[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    v[r] = base + r * 32 < n ? clamp_id(__ldg(ids + base + r * 32), num_rows) : 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const bool valid = base + r * 32 < n;
    if (marks != nullptr) mark_row(v[r], valid, num_rows, marks, recent);
    if (valid)
      for (int q = 0; q < p.passes; ++q)
        atomicAdd(&counts[q * radix + digit_of(v[r], q * p.digit_bits, mask)], 1u);
  }
  __syncthreads();
  for (int i = t; i < p.passes * radix; i += kThreads)
    if (counts[i] != 0) atomicAdd(hist + i, counts[i]);
}

// The row marks alone, of ids in any order (the gradient of a presorted
// batch).
__global__ void __launch_bounds__(kThreads)
    mark_kernel(const int32_t* __restrict__ ids, int64_t n, int32_t num_rows,
                uint32_t* __restrict__ marks) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  mark_row(valid ? __ldg(ids + i) : -1, valid, num_rows, marks, nullptr);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* s) {
  return *reinterpret_cast<const volatile unsigned long long*>(s);
}

__device__ __forceinline__ void store_status(unsigned long long* s, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(s) = v;
}

// The count of digit d over tiles [0, tile), from their statuses.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* status, int64_t tile,
                                              int d, int radix) {
  uint32_t sum = 0;
  for (int64_t j = tile - 1;; j -= kWindow) {
    unsigned long long s[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k)
      s[k] = j - k >= 0 ? load_status(status + (j - k) * radix + d) : kPrefix;
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      while ((s[k] >> 32) == 0) s[k] = load_status(status + (j - k) * radix + d);
      sum += (uint32_t)s[k];
      if ((s[k] >> 32) == (kPrefix >> 32)) return sum;
    }
  }
}

// Exclusive prefix sum over the block's threads, in thread order.
__device__ __forceinline__ unsigned long long block_exclusive_sum(
    unsigned long long x, unsigned long long* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + inc - x;
}

struct Pass {
  const int32_t* src_keys;  // clamped ids; on the first pass the raw ids
  const int32_t* src_pos;   // null on the first pass: the position is the index
  int32_t* dst_keys;
  int32_t* dst_pos;
  const uint32_t* hist;     // [radix] this pass's digit counts over all n
  uint32_t* counter;        // the next tile to take
  unsigned long long* status;  // [tiles][radix]
  int64_t n;
  int32_t num_rows;
  int shift, bits, radix;
};

__global__ void __launch_bounds__(kThreads) pass_kernel(Pass a) {
  __shared__ uint32_t warp_counts[kWarps][kMaxRadix];  // then each warp's start in its digit
  __shared__ uint32_t tile_start[kMaxRadix];           // the tile's first entry of each digit
  __shared__ uint32_t out_start[kMaxRadix];  // a digit's output position, less tile_start
  __shared__ int32_t tile_keys[kTile];
  __shared__ int32_t tile_pos[kTile];
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ uint32_t tile_id;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t mask = a.radix - 1;
  if (t == 0) tile_id = atomicAdd(a.counter, 1u);
  const uint32_t digit_count = t < a.radix ? __ldg(a.hist + t) : 0u;
  for (int i = t; i < kWarps * kMaxRadix; i += kThreads) (&warp_counts[0][0])[i] = 0;
  __syncthreads();
  const int64_t tile = tile_id;

  // entry e = base + 32 r of the tile: warp-major, then round, then lane,
  // which is input order
  const int64_t base = tile * kTile + warp * (kPerThread * 32) + lane;
  int32_t key[kPerThread], pos[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = base + r * 32;
    if (i >= a.n) {
      key[r] = 0;
      pos[r] = -1;  // no entry
    } else if (a.src_pos != nullptr) {
      key[r] = __ldg(a.src_keys + i);
      pos[r] = __ldg(a.src_pos + i);
    } else {
      key[r] = clamp_id(__ldg(a.src_keys + i), a.num_rows);
      pos[r] = (int32_t)i;
    }
  }

  // rank among the warp's equal digits so far, round by round
  uint32_t rank[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const bool valid = pos[r] >= 0;
    const uint32_t d = digit_of(key[r], a.shift, mask);
    const unsigned peers = digit_peers(d, valid, a.bits);
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (valid && lane == leader) {
      before = warp_counts[warp][d];
      warp_counts[warp][d] = before + __popc(peers);
    }
    rank[r] = __shfl_sync(kFull, before, leader) + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();

  // per digit: each warp's start among the tile's equal digits, and the
  // tile's count, published for the later tiles
  uint32_t total = 0;
  if (t < a.radix) {
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_counts[w][t];
      warp_counts[w][t] = total;
      total += c;
    }
    store_status(a.status + tile * a.radix + t, (tile == 0 ? kPrefix : kAggregate) | total);
  }
  // one scan gives the digit's start over all n (high half) and in the tile (low half)
  const unsigned long long packed = (unsigned long long)digit_count << 32 | total;
  const unsigned long long starts = block_exclusive_sum(packed, warp_sums);
  if (t < a.radix) tile_start[t] = (uint32_t)starts;
  __syncthreads();

  // the tile in digit order, in shared memory
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (pos[r] < 0) continue;
    const uint32_t d = digit_of(key[r], a.shift, mask);
    const uint32_t at = tile_start[d] + warp_counts[warp][d] + rank[r];
    tile_keys[at] = key[r];
    tile_pos[at] = pos[r];
  }
  if (t < a.radix) {
    const uint32_t earlier = tile == 0 ? 0u : look_back(a.status, tile, t, a.radix);
    if (tile > 0) store_status(a.status + tile * a.radix + t, kPrefix | (earlier + total));
    out_start[t] = (uint32_t)(starts >> 32) + earlier - tile_start[t];
  }
  __syncthreads();

  const int64_t left = a.n - tile * kTile;
  const int count = left < kTile ? (int)left : kTile;
  for (int j = t; j < count; j += kThreads) {
    const int32_t k = tile_keys[j];
    const uint32_t at = out_start[digit_of(k, a.shift, mask)] + j;
    a.dst_keys[at] = k;
    a.dst_pos[at] = tile_pos[j];
  }
}

// Zeroes the workspace's head and counts the digits (and marks the rows
// when `mark`) on `stream`.
inline cudaError_t sort_begin(const int32_t* ids, int64_t n, int32_t num_rows, Plan p,
                              void* workspace, int64_t head, bool mark, cudaStream_t stream) {
  const Layout l = layout(n, p, head);
  uint32_t* ws = static_cast<uint32_t*>(workspace);
  if (l.zeroed > 0) {
    const cudaError_t err = cudaMemsetAsync(ws, 0, l.zeroed * sizeof(uint32_t), stream);
    if (err != cudaSuccess) return err;
  }
  if (n == 0) return cudaSuccess;
  histogram_kernel<<<(unsigned)tiles_of(n), kThreads, 0, stream>>>(
      ids, n, num_rows, p, ws + l.hist, mark ? ws + l.marks : nullptr);
  return cudaGetLastError();
}

// The passes, after sort_begin on the same workspace: sorted (clamped ids)
// and perm (batch positions) [n] int32.
inline cudaError_t sort_finish(const int32_t* ids, int64_t n, int32_t num_rows, Plan p,
                               int32_t* sorted, int32_t* perm, void* workspace,
                               int64_t head, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const Layout l = layout(n, p, head);
  uint32_t* ws = static_cast<uint32_t*>(workspace);
  const int radix = 1 << p.digit_bits;
  const int64_t tiles = tiles_of(n);
  const int32_t* src_keys = ids;
  const int32_t* src_pos = nullptr;
  for (int q = 0; q < p.passes; ++q) {
    // the last pass writes the output; the others alternate before it
    const bool to_out = (p.passes - 1 - q) % 2 == 0;
    int32_t* dst_keys = to_out ? sorted : reinterpret_cast<int32_t*>(ws + l.tmp_keys);
    int32_t* dst_pos = to_out ? perm : reinterpret_cast<int32_t*>(ws + l.tmp_pos);
    const Pass a{src_keys,
                 src_pos,
                 dst_keys,
                 dst_pos,
                 ws + l.hist + q * radix,
                 ws + l.counters + q,
                 reinterpret_cast<unsigned long long*>(ws + l.status) + q * tiles * radix,
                 n,
                 num_rows,
                 q * p.digit_bits,
                 p.digit_bits,
                 radix};
    pass_kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_keys = dst_keys;
    src_pos = dst_pos;
  }
  return cudaSuccess;
}

}  // namespace sort
}  // namespace rp
