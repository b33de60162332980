// Dense table gradient of the fused embedding lookup, for Hopper (sm_90a).
//
//   grad[r, :] = sum over i with ids[i] == r of rows[i, :]     r in [0, rows)
//
// written for every table row, zeros where no id falls.
//
// Replaces the JAX package's planned backward (K2:
// rec_pangu_tpu/ops/kernels/embedding_grad.py, _chunk_kernel behind
// presorted_segment_accumulate) and its device-sorted twin (K7:
// _accumulate_kernel behind sorted_segment_accumulate).  Those kernels sum
// each vocab tile's 128-entry chunks of a sort plan with one-hot MXU
// matmuls, because the TPU has no fast scatter.  Here the ids are sorted on
// the device by the radix sort of radix_sort.cuh, then the levels of
// segment_sum.cuh sum each run of equal ids with a fixed tree of warps and
// write its row once, however long the run.
//
// Bound: bytes.  The dense gradient is written once (rows x dim x 4 B, 205.5
// MB at the bench shape), the cotangent rows and the ids are read once:
// 222.8 MB, 0.0665 ms at 3.35 TB/s.  Every row is written once: the sort's
// first launch, which reads every id anyway, sets a bit per in-range row the
// batch touches; a second stream then zeroes only the rows without a bit
// (coalesced float4 stores, a warp per 32 rows), while the caller's stream
// runs the sort's passes and the levels, whose complete runs write the
// touched rows.  The two streams write disjoint rows, so the result does not
// depend on their order.  No float atomics: one warp writes each touched
// row, so the result is the same bits on every run.
//
// The fill still saturates the card's write bandwidth alone with one block
// of 128 threads an SM: more threads or blocks only crowd the latency-bound
// work beside it, and fewer no longer keep up.  Its stores are evict-first,
// so the cotangent rows stay in L2 for the levels, and it asks for the
// largest shared-memory carve-out, so the sort's passes can start beside
// it.  The wrapper forks the fill just before the passes; the passes run
// about 1.5 times slower beside it and the levels follow them, so the fill
// ends last and sets the time (PERF.md, section 6).
//
// The wrapper (ops/kernels/embedding_grad.py) forks and joins the streams;
// the entry points below each launch on the stream they are given.  For a
// batch sorted elsewhere, rp_mark_rows marks the rows in a pass of its own.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_sort.cuh"
#include "segment_sum.cuh"

namespace {

constexpr int kFillThreads = 128;
constexpr int kFillBlocksPerSm = 1;  // leaves each SM room for the sort and the levels

// Zeroes the rows whose bit in `marks` is clear: warp w takes rows [32w,
// 32w + 32), one mark word, and stores its rows' zero vectors lane by lane.
// per_row vectors of V a row; shift = log2(per_row), or -1 when per_row is
// not a power of two.
template <typename V>
__global__ void __launch_bounds__(kFillThreads)
    fill_unmarked_kernel(float* __restrict__ out, int64_t num_rows, int per_row, int shift,
                         const uint32_t* __restrict__ marks) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  V zero;
  float* z = reinterpret_cast<float*>(&zero);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) z[k] = 0.0f;
  const int lane = threadIdx.x & 31;
  const int64_t words = (num_rows + 31) / 32;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < words;
       w += warps) {
    const uint32_t m = __ldg(marks + w);
    const int rows = num_rows - 32 * w < 32 ? (int)(num_rows - 32 * w) : 32;
    if (m == (rows == 32 ? 0xffffffffu : (1u << rows) - 1u)) continue;  // every row touched
    V* dst = reinterpret_cast<V*>(out) + w * 32 * per_row;
    const int count = rows * per_row;
    for (int j = lane; j < count; j += 32) {
      const int r = shift >= 0 ? j >> shift : j / per_row;
      if (!((m >> r) & 1u)) __stcs(dst + j, zero);  // evict first: keep the rows in L2
    }
  }
}

// Asks for the fill to run with the SM's largest shared memory carve-out:
// an SM changes its carve-out only when idle, so a fill that held the
// L1-heavy one would keep the sort's passes (which need shared memory) off
// every SM it runs on until it ends.
cudaError_t prefer_shared() {
  cudaError_t err = cudaFuncSetAttribute((const void*)fill_unmarked_kernel<float4>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute((const void*)fill_unmarked_kernel<float>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool vec4_rows(const void* grad, int dim) {
  return dim % 4 == 0 && reinterpret_cast<uintptr_t>(grad) % 16 == 0;
}

bool sort_args_ok(long long n, long long num_rows, rp::sort::Plan p, long long words,
                  long long head, bool mark) {
  return n >= 0 && n <= 0x7fffffffLL && rp::sort::plan_ok(num_rows, p) && head >= 0 &&
         (!mark || head >= (num_rows + 31) / 32) &&
         words >= rp::sort::layout(n, p, head).words;
}

}  // namespace

// 4-byte words of scratch rp_embedding_grad_levels_f32 needs for n ids of
// dim columns.
extern "C" long long rp_embedding_grad_workspace_words(long long n, int dim) {
  return rp::workspace_words(n, dim);
}

// 4-byte words of the levels' counts for n ids, which the caller may zero
// with other work (see rp_embedding_grad_levels_f32).
extern "C" long long rp_embedding_grad_count_words(long long n) { return rp::count_words(n); }

// 4-byte words of workspace the radix sort of n ids needs under the plan
// (key_bits, digit_bits, passes), with `head` words of the caller's first
// (the row marks, ceil(num_rows / 32) words, when the sort sets them).
extern "C" long long rp_radix_sort_workspace_words(long long n, int digit_bits, int passes,
                                                   long long head) {
  return rp::sort::layout(n, rp::sort::Plan{0, digit_bits, passes}, head).words;
}

// The sort's first launches on `stream`: zeroes the workspace's first head
// words and its own counters, counts every pass's digits of ids [n] i32,
// and, when `mark`, sets bit r % 32 of word r / 32 for each row r in [0,
// num_rows) that an id hits.  The plan is sort_plan's in embedding_grad.py;
// key_bits must be bit_length(num_rows + 1).  Returns cudaGetLastError() (0
// = launched).
extern "C" int rp_radix_sort_begin(const void* ids, long long n, long long num_rows,
                                   int key_bits, int digit_bits, int passes, void* workspace,
                                   long long workspace_words, long long head, int mark,
                                   void* stream) {
  const rp::sort::Plan p{key_bits, digit_bits, passes};
  if (!sort_args_ok(n, num_rows, p, workspace_words, head, mark != 0))
    return (int)cudaErrorInvalidValue;
  return (int)rp::sort::sort_begin(static_cast<const int32_t*>(ids), n, (int32_t)num_rows, p,
                                   workspace, head, mark != 0,
                                   static_cast<cudaStream_t>(stream));
}

// The sort's passes on `stream`, after rp_radix_sort_begin with the same
// arguments: sorted [n] i32 gets clamp(id, -1, num_rows) in ascending order,
// perm [n] i32 each entry's batch position (a stable sort).
extern "C" int rp_radix_sort_finish(const void* ids, long long n, long long num_rows,
                                    int key_bits, int digit_bits, int passes, void* sorted,
                                    void* perm, void* workspace, long long workspace_words,
                                    long long head, void* stream) {
  const rp::sort::Plan p{key_bits, digit_bits, passes};
  if (!sort_args_ok(n, num_rows, p, workspace_words, head, false))
    return (int)cudaErrorInvalidValue;
  return (int)rp::sort::sort_finish(static_cast<const int32_t*>(ids), n, (int32_t)num_rows, p,
                                    static_cast<int32_t*>(sorted), static_cast<int32_t*>(perm),
                                    workspace, head, static_cast<cudaStream_t>(stream));
}

// The row marks of ids [n] i32 in any order, on `stream`: zeroes the first
// `words` words of marks (at least ceil(num_rows / 32): the marks, then any
// of the caller's) and sets the bit of each row in [0, num_rows) an id hits.
extern "C" int rp_mark_rows(const void* ids, long long n, long long num_rows, void* marks,
                            long long words, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || num_rows <= 0 || num_rows > 0x7fffffffLL ||
      words < (num_rows + 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(marks, 0, words * sizeof(uint32_t), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  rp::sort::mark_kernel<<<(unsigned)((n + rp::sort::kThreads - 1) / rp::sort::kThreads),
                          rp::sort::kThreads, 0, st>>>(static_cast<const int32_t*>(ids), n,
                                                       (int32_t)num_rows,
                                                       static_cast<uint32_t*>(marks));
  return (int)cudaGetLastError();
}

// Zeroes the rows of grad [num_rows, dim] f32 whose bit in marks is clear,
// on `stream`; the other rows are left as they are.
extern "C" int rp_fill_unmarked_f32(void* grad, long long num_rows, int dim, const void* marks,
                                    void* stream) {
  if (num_rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const bool vec4 = vec4_rows(grad, dim);
  const int per_row = vec4 ? dim / 4 : dim;
  if ((long long)per_row * 32 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int shift = (per_row & (per_row - 1)) == 0 ? __builtin_ctz(per_row) : -1;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t words = (num_rows + 31) / 32;
  const int64_t warps_a_block = kFillThreads / 32;
  int64_t blocks = (words + warps_a_block - 1) / warps_a_block;
  if (blocks > (int64_t)sms * kFillBlocksPerSm) blocks = (int64_t)sms * kFillBlocksPerSm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grad);
  const uint32_t* m = static_cast<const uint32_t*>(marks);
  if (vec4) {
    fill_unmarked_kernel<float4><<<(unsigned)blocks, kFillThreads, 0, st>>>(g, num_rows,
                                                                            per_row, shift, m);
  } else {
    fill_unmarked_kernel<float><<<(unsigned)blocks, kFillThreads, 0, st>>>(g, num_rows, per_row,
                                                                           shift, m);
  }
  return (int)cudaGetLastError();
}

// The levels alone on `stream`: the touched rows of grad [num_rows, dim]
// f32, from sorted_ids / perm (a stable sort of the fused ids) and rows
// [*, dim] f32; workspace of workspace_words 4-byte words (at least
// rp_embedding_grad_workspace_words(n, dim)); counts: the levels' counts,
// rp_embedding_grad_count_words(n) words already zeroed on the stream (the
// table gradient zeroes them with the sort's head), or null to zero the
// workspace's own first.  The other rows are not written.
extern "C" int rp_embedding_grad_levels_f32(const void* sorted_ids, const void* perm,
                                            const void* rows, long long n, void* grad,
                                            long long num_rows, int dim, void* workspace,
                                            long long workspace_words, void* counts,
                                            void* stream) {
  if (n < 0 || n > 0x7fffffffLL || num_rows <= 0 || dim <= 0 ||
      workspace_words < rp::workspace_words(n, dim))
    return (int)cudaErrorInvalidValue;
  return (int)rp::segment_sum(static_cast<const int32_t*>(sorted_ids),
                              static_cast<const int32_t*>(perm),
                              static_cast<const float*>(rows), n, dim,
                              rp::Output{static_cast<float*>(grad), true, num_rows}, nullptr,
                              workspace, static_cast<uint32_t*>(counts),
                              static_cast<cudaStream_t>(stream));
}

// Readies the current device for the fill: sets the fill's carve-out and
// creates the library's second stream there, which it returns (null if
// either fails).  The wrapper calls it once a device, when the library
// loads or at the device's first call, and keeps the stream: every caller
// on the device shares it.  Safe during stream capture (neither call is
// captured).
extern "C" void* rp_fill_stream_create() {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  if (cudaThreadExchangeStreamCaptureMode(&mode) != cudaSuccess) return nullptr;
  cudaStream_t stream = nullptr;
  if (prefer_shared() != cudaSuccess ||
      cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) != cudaSuccess)
    stream = nullptr;
  cudaThreadExchangeStreamCaptureMode(&mode);
  return stream;
}
