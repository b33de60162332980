// Exact row top-k for Hopper (sm_90a): each row's k largest float32 scores,
// best first, with their column ids as int32.
//
// Replaces no TPU kernel.  The JAX package calls jax.lax.top_k
// (rec_pangu_tpu/serving/scorer.py:72) and left it to XLA; the port took
// torch.topk there, whose multi-block radix select reads a [1,024, 1 M]
// score matrix about five times (four 8-bit digit-count passes and a
// gather).  This kernel was added for retrieval (serving/scorer.py), where
// that select took 72% of a request's device time.
//
// Order.  A score's 32-bit key is order-preserving: every bit of a negative
// flipped, the sign bit of a non-negative set, and every NaN 0xffffffff, so
// NaN sorts above +inf as torch.topk orders it.  Ties go to the smallest
// ids: the kernel ranks V = key << 32 | ~id, 64 bits that no two columns
// share, descending.  So the answer is the same bits on every run, and a
// valid torch.topk answer.
//
// Bound: bytes.  One read of the scores (4.1 GB at [1,024, 1 M]: 1.22 ms at
// 3.35 TB/s); the answer and the workspace are small.  The design reads the
// scores once, then again only the chunks that hold a candidate, and a row
// in full again only where its ties or its crowding need it.  A warp takes
// a row's columns a chunk of 512 at a time (16 a lane).
//
// 1. Histogram (read 1).  Blocks own (row, slice); each counts the top 12
//    bits of its keys in shared memory with integer atomics and adds the
//    nonzero bins into the row's global histogram, so the counts do not
//    depend on the order of blocks or items.  12 bits are 8 bins an octave
//    of scores; at 11 (4 an octave) the k-th key's bin and those above it
//    held more than 1,016 keys in 829 of 1,024 rows of cosine scores over
//    1 M items at k = 200, and each such row was read again.  Each chunk's
//    largest key goes to the workspace, its top 16 bits.
// 2. Threshold (one block a row).  Scans the histogram from the top for the
//    bin b* that holds the row's k-th key.  The row is resolved when the
//    keys in b* and above fit the candidate buffer (capacity C).  Otherwise
//    it joins the next level's list and the same two steps run on the next
//    digit of V, over the keys whose prefix matched: 12, 10 and 10 bits of
//    the key, then 11, 11 and 10 bits of ~id.  Every level's grid is
//    launched every call and finds its list empty when no row refines, so
//    the host never waits for the device.  At the last level the prefix is
//    all of V, which one column holds, so every row is resolved by then.
// 3. Filter (the second read, of some chunks).  A chunk whose largest key
//    cannot reach the row's prefix holds no candidate and is not read: the
//    k-th key lies in about the top 2e-4 of a row at k = 200 of 1 M, so a
//    few hundred chunks of a row's 1,954 hold one, whatever the columns'
//    order.  The others append every V whose top bits reach the prefix to
//    the row's buffer, one atomic a warp.  Their count is known from the
//    histograms: at least k, at most C.
// 4. Finish (one block a row).  A bitonic sort of the buffer in shared
//    memory, descending; the first k give the ids, and each value is read
//    back from scores[row, id], so it is the score's own bits.
//
// Loads are 16-byte (float4) where the row length is a multiple of 4 and the
// base is aligned, four in flight a lane; otherwise 4-byte, sixteen.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // histogram, filter and threshold blocks
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 512;  // finish blocks
constexpr int kChunk = 512;          // columns a warp takes at once
constexpr int kPerLane = kChunk / 32;
constexpr int kMaxBins = 4096;       // the widest digit, 12 bits
constexpr int kLevels = 6;
constexpr int kMaxK = 256;
constexpr int kMaxCapacity = 2048;   // the finish sorts at most this many in shared memory
constexpr int kStateWords = 8;
// level l fixes kBits[l] bits of V and counts the next kWidth[l]
__constant__ int kBits[kLevels] = {0, 12, 22, 32, 43, 54};
__constant__ int kWidth[kLevels] = {12, 10, 10, 11, 11, 10};

struct RowState {
  uint32_t pk;     // the prefix's key bits (the top min(bits, 32) bits of the key)
  uint32_t pl;     // the prefix's ~id bits past the key (the top bits - 32 bits of ~id)
  uint32_t bits;   // bits of V the prefix fixes
  uint32_t above;  // columns whose V lies above the prefix's range: fewer than k
  uint32_t fill;   // the filter's append count
  uint32_t pad[kStateWords - 5];
};
static_assert(sizeof(RowState) == kStateWords * 4, "RowState is kStateWords words");

__host__ __device__ inline long long chunks_of(long long N) { return (N + kChunk - 1) / kChunk; }

// The workspace: candidates [B][capacity] u64, histograms [B][kMaxBins],
// states [B], list counts [kLevels] (padded to 8 words), lists [kLevels][B],
// chunk maxima [B][chunks_of(N)] u16.
struct Work {
  unsigned long long* cand;
  uint32_t* hist;
  RowState* state;
  uint32_t* counts;
  uint32_t* lists;
  uint16_t* top;
  long long B, chunks;
  int capacity;
};

__host__ __device__ inline long long zeroed_words(long long B) {
  return B * kMaxBins + B * kStateWords + 8;
}

__host__ __device__ inline long long workspace_words(long long B, long long N, int capacity) {
  return 2 * B * capacity + zeroed_words(B) + kLevels * B + (B * chunks_of(N) + 1) / 2;
}

inline Work make_work(void* workspace, long long B, long long N, int capacity) {
  Work w;
  w.cand = static_cast<unsigned long long*>(workspace);
  w.hist = reinterpret_cast<uint32_t*>(w.cand + B * capacity);
  w.state = reinterpret_cast<RowState*>(w.hist + B * kMaxBins);
  w.counts = reinterpret_cast<uint32_t*>(w.state + B);
  w.lists = w.counts + 8;
  w.top = reinterpret_cast<uint16_t*>(w.lists + kLevels * B);
  w.B = B;
  w.chunks = chunks_of(N);
  w.capacity = capacity;
  return w;
}

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t flipped = u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
  return x != x ? 0xffffffffu : flipped;
}

// Whether column (key, lo = ~id) lies in the prefix's range at `bits` fixed
// bits, and its next `width`-bit digit.
struct Prefix {
  uint32_t pk, pl;
  int bits, width;

  __device__ __forceinline__ bool matches(uint32_t key, uint32_t lo) const {
    if (bits == 0) return true;
    if (bits <= 32) return (key >> (32 - bits)) == pk;
    return key == pk && (lo >> (64 - bits)) == pl;
  }
  __device__ __forceinline__ uint32_t digit(uint32_t key, uint32_t lo) const {
    const uint32_t mask = (1u << width) - 1u;
    if (bits + width <= 32) return (key >> (32 - bits - width)) & mask;
    return (lo >> (64 - bits - width)) & mask;
  }
  // V's top `bits` bits at or above the prefix
  __device__ __forceinline__ bool reaches(uint32_t key, uint32_t lo) const {
    if (bits <= 32) return (key >> (32 - bits)) >= pk;
    return key > pk || (key == pk && (lo >> (64 - bits)) >= pl);
  }
  // whether a chunk whose largest key has the top 16 bits `top16` may hold
  // a column that reaches (or matches) the prefix; bits >= 1
  __device__ __forceinline__ bool may_reach(uint32_t top16) const {
    if (bits <= 16) return (top16 >> (16 - bits)) >= pk;
    return top16 >= (bits <= 32 ? pk >> (bits - 16) : pk >> 16);
  }
};

// Lane `lane`'s column i of the chunk from column c0.
template <bool kVec>
__device__ __forceinline__ long long column(long long c0, int lane, int i) {
  return kVec ? c0 + 4 * ((i >> 2) * 32 + lane) + (i & 3) : c0 + i * 32 + lane;
}

// Lane `lane`'s scores of the chunk from column c0, columns past `end` 0.
// On the vector path c0 and end are multiples of 4.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const float* __restrict__ row, long long c0,
                                           long long end, int lane, float (&x)[kPerLane]) {
  if (kVec) {
#pragma unroll
    for (int u = 0; u < kPerLane / 4; ++u) {
      const long long c = column<true>(c0, lane, 4 * u);
      const float4 v = c < end ? __ldcs(reinterpret_cast<const float4*>(row + c))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * u] = v.x;
      x[4 * u + 1] = v.y;
      x[4 * u + 2] = v.z;
      x[4 * u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long c = column<false>(c0, lane, i);
      x[i] = c < end ? __ldcs(row + c) : 0.f;
    }
  }
}

__device__ __forceinline__ long long row_of(const Work& w, int level, long long i) {
  return level == 0 ? i : (long long)w.lists[(long long)level * w.B + i];
}

__device__ __forceinline__ long long rows_at(const Work& w, int level) {
  return level == 0 ? w.B : (long long)w.counts[level];
}

// Step 1 at `level`: items (row of the level's list, slice), grid-stride.
// At level 0 every chunk is read and its largest key kept; past it only the
// chunks that may hold a column of the prefix.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const float* __restrict__ scores, long long N, long long slice_len,
                     int slices, int level, Work w) {
  __shared__ uint32_t hist[kMaxBins];
  const long long items = rows_at(w, level) * slices;
  const int width = kWidth[level];
  const int bins = 1 << width;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long row = row_of(w, level, item / slices);
    const long long s = item % slices;
    for (int i = threadIdx.x; i < bins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const RowState st = w.state[row];
    const Prefix pre{st.pk, st.pl, kBits[level], width};
    const long long begin = s * slice_len;
    const long long end = min(N, begin + slice_len);
    const long long n = end > begin ? (end - begin + kChunk - 1) / kChunk : 0;
    const float* p = scores + row * N;
    uint16_t* top = w.top + row * w.chunks + begin / kChunk;
    if (level == 0) {
      for (long long q = warp; q < n; q += kWarps) {
        const long long c0 = begin + q * kChunk;
        float x[kPerLane];
        load_chunk<kVec>(p, c0, end, lane, x);
        uint32_t most = 0;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          if (column<kVec>(c0, lane, i) < end) {
            const uint32_t key = order_key(x[i]);
            atomicAdd(&hist[key >> 20], 1u);
            most = max(most, key);
          }
        }
        most = __reduce_max_sync(0xffffffffu, most);
        if (lane == 0) top[q] = (uint16_t)(most >> 16);
      }
    } else {
      for (long long g = (long long)warp * 32; g < n; g += kWarps * 32) {
        unsigned live = __ballot_sync(0xffffffffu, g + lane < n && pre.may_reach(top[g + lane]));
        while (live) {
          const long long c0 = begin + (g + __ffs(live) - 1) * kChunk;
          live &= live - 1;
          float x[kPerLane];
          load_chunk<kVec>(p, c0, end, lane, x);
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const long long c = column<kVec>(c0, lane, i);
            const uint32_t key = order_key(x[i]), lo = ~(uint32_t)c;
            if (c < end && pre.matches(key, lo)) atomicAdd(&hist[pre.digit(key, lo)], 1u);
          }
        }
      }
    }
    __syncthreads();
    uint32_t* g = w.hist + row * kMaxBins;
    for (int i = threadIdx.x; i < bins; i += kThreads)
      if (hist[i]) atomicAdd(g + i, hist[i]);
    __syncthreads();
  }
}

// Step 2 at `level`: one block a row of the level's list, grid-stride.
__global__ void __launch_bounds__(kThreads)
    threshold_kernel(int level, int k, Work w, unsigned long long* refined) {
  __shared__ uint32_t sums[kThreads];
  __shared__ int refine;
  const long long n = rows_at(w, level);
  const int width = kWidth[level];
  const int per = (1 << width) / kThreads;  // 16, 8 or 4 bins a thread
  const int t = threadIdx.x;
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long row = row_of(w, level, i);
    RowState* st = w.state + row;
    uint32_t* h = w.hist + row * kMaxBins;
    const uint32_t need = (uint32_t)k - st->above;
    uint32_t c[kMaxBins / kThreads];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kMaxBins / kThreads; ++j) {
      c[j] = j < per ? h[t * per + j] : 0u;
      sum += c[j];
    }
    sums[t] = sum;
    if (t == 0) refine = 0;
    __syncthreads();
    // suffix sums over the threads: sums[t] = sum of the bins of threads >= t
    for (int o = 1; o < kThreads; o <<= 1) {
      const uint32_t add = t + o < kThreads ? sums[t + o] : 0u;
      __syncthreads();
      sums[t] += add;
      __syncthreads();
    }
    const uint32_t incl = sums[t];
    const uint32_t excl = incl - sum;
    if (excl < need && need <= incl) {  // exactly one thread: the counts fall from the top
      uint32_t acc = excl;
      for (int j = per - 1; j >= 0; --j) {
        if (acc + c[j] >= need) {
          const uint32_t b = (uint32_t)(t * per + j);
          const int bits = kBits[level] + width;
          RowState s = *st;
          if (bits <= 32) {
            s.pk = (s.pk << width) | b;
          } else {
            s.pl = (s.pl << width) | b;
          }
          s.bits = (uint32_t)bits;
          s.above += acc;
          s.fill = 0;
          *st = s;
          if (s.above + c[j] > (uint32_t)w.capacity && bits < 64) {
            const uint32_t slot = atomicAdd(w.counts + level + 1, 1u);
            w.lists[(long long)(level + 1) * w.B + slot] = (uint32_t)row;
            if (level == 0) atomicAdd(refined, 1ull);
            refine = 1;
          }
          break;
        }
        acc += c[j];
      }
    }
    __syncthreads();
    if (refine) {  // the next level counts into the same row
      for (int j = t; j < kMaxBins; j += kThreads) h[j] = 0u;
    }
    __syncthreads();
  }
}

// Step 3: every (row, slice) block appends the row's selected columns from
// the chunks that may hold one; a warp tests 32 chunks at once.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    filter_kernel(const float* __restrict__ scores, long long N, long long slice_len, int slices,
                  Work w) {
  const long long row = blockIdx.x / slices;
  const long long s = blockIdx.x % slices;
  const RowState st = w.state[row];
  const Prefix pre{st.pk, st.pl, (int)st.bits, 0};
  const long long begin = s * slice_len;
  const long long end = min(N, begin + slice_len);
  const long long n = end > begin ? (end - begin + kChunk - 1) / kChunk : 0;
  const float* p = scores + row * N;
  const uint16_t* top = w.top + row * w.chunks + begin / kChunk;
  unsigned long long* out = w.cand + row * w.capacity;
  uint32_t* fill = &w.state[row].fill;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long g = (long long)warp * 32; g < n; g += kWarps * 32) {
    unsigned live = __ballot_sync(0xffffffffu, g + lane < n && pre.may_reach(top[g + lane]));
    while (live) {
      const long long c0 = begin + (g + __ffs(live) - 1) * kChunk;
      live &= live - 1;
      float x[kPerLane];
      load_chunk<kVec>(p, c0, end, lane, x);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const long long c = column<kVec>(c0, lane, i);
        const uint32_t key = order_key(x[i]), lo = ~(uint32_t)c;
        const bool take = c < end && pre.reaches(key, lo);
        const unsigned mask = __ballot_sync(0xffffffffu, take);
        if (mask == 0u) continue;
        uint32_t base = 0;
        if (lane == 0) base = atomicAdd(fill, (uint32_t)__popc(mask));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (take) {
          const uint32_t pos = base + (uint32_t)__popc(mask & ((1u << lane) - 1u));
          if (pos < (uint32_t)w.capacity) out[pos] = ((unsigned long long)key << 32) | lo;
        }
      }
    }
  }
}

// Step 4: one block a row sorts its buffer and writes the first k.
__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(const float* __restrict__ scores, long long N, int k, Work w,
                  float* __restrict__ values, int32_t* __restrict__ ids) {
  __shared__ unsigned long long v[kMaxCapacity];
  const long long row = blockIdx.x;
  const int n = min((int)w.state[row].fill, w.capacity);
  int size = 1;
  while (size < n) size <<= 1;
  const unsigned long long* in = w.cand + row * w.capacity;
  for (int i = threadIdx.x; i < size; i += kFinishThreads) v[i] = i < n ? in[i] : 0ull;
  __syncthreads();
  // bitonic sort, descending: V > 0 for every column, so the padding sinks
  for (int span = 2; span <= size; span <<= 1) {
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < size / 2; i += kFinishThreads) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const bool down = (a & span) == 0;
        const unsigned long long x = v[a], y = v[b];
        if (down ? x < y : x > y) {
          v[a] = y;
          v[b] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += kFinishThreads) {
    const uint32_t id = ~(uint32_t)v[i];
    values[row * k + i] = scores[row * N + id];
    ids[row * k + i] = (int32_t)id;
  }
}

int refine_grid() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return 8 * sms;
}

template <bool kVec>
cudaError_t launch(const float* scores, long long N, int k, long long slice_len, int slices,
                   const Work& w, unsigned long long* refined, float* values, int32_t* ids,
                   cudaStream_t st) {
  const long long B = w.B;
  cudaError_t err = cudaMemsetAsync(w.hist, 0, zeroed_words(B) * 4, st);
  if (err != cudaSuccess) return err;
  const int grid = refine_grid();
  histogram_kernel<kVec><<<(unsigned)(B * slices), kThreads, 0, st>>>(scores, N, slice_len,
                                                                     slices, 0, w);
  threshold_kernel<<<(unsigned)B, kThreads, 0, st>>>(0, k, w, refined);
  for (int level = 1; level < kLevels; ++level) {
    histogram_kernel<kVec><<<grid, kThreads, 0, st>>>(scores, N, slice_len, slices, level, w);
    threshold_kernel<<<(unsigned)(B < grid ? B : grid), kThreads, 0, st>>>(level, k, w, refined);
  }
  filter_kernel<kVec><<<(unsigned)(B * slices), kThreads, 0, st>>>(scores, N, slice_len, slices,
                                                                   w);
  finish_kernel<<<(unsigned)B, kFinishThreads, 0, st>>>(scores, N, k, w, values, ids);
  return cudaGetLastError();
}

}  // namespace

// scores [B, N] float32, contiguous; values [B, k] float32 and ids [B, k]
// int32 out; workspace of workspace_words(B, N, capacity) words (the
// wrapper's ops/kernels/row_topk.workspace_words), 8-byte aligned; refined: a device counter that gains the rows of
// this call that refined past the first digit.  slices: blocks a row in the
// histogram and filter passes, each over ceil(N / slices) columns rounded up
// to whole chunks.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int rp_row_topk_f32(const void* scores, void* values, void* ids, void* workspace,
                               long long workspace_words_given, long long B, long long N, int k,
                               int capacity, int slices, void* refined, void* stream) {
  if (B < 1 || N < 1 || N > 0x7fffffffLL || k < 1 || k > kMaxK || k > N || capacity < k ||
      capacity > kMaxCapacity || slices < 1 || slices > N ||
      B * (long long)slices > 0x7fffffffLL ||
      workspace_words_given < workspace_words(B, N, capacity) ||
      (reinterpret_cast<uintptr_t>(workspace) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const long long slice_len = ((N + slices - 1) / slices + kChunk - 1) / kChunk * kChunk;
  const Work w = make_work(workspace, B, N, capacity);
  const float* s = static_cast<const float*>(scores);
  float* out_v = static_cast<float*>(values);
  int32_t* out_i = static_cast<int32_t*>(ids);
  unsigned long long* r = static_cast<unsigned long long*>(refined);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  return (int)(vec ? launch<true>(s, N, k, slice_len, slices, w, r, out_v, out_i, st)
                   : launch<false>(s, N, k, slice_len, slices, w, r, out_v, out_i, st));
}
