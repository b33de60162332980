// Dense table gradient of the fused embedding lookup, for Hopper (sm_90a).
//
//   grad[r, :] = sum over i with ids[i] == r of rows[i, :]     r in [0, rows)
//
// written for every table row, zeros where no id falls.
//
// Replaces the JAX package's planned backward (K2:
// rec_pangu_tpu/ops/kernels/embedding_grad.py, _chunk_kernel behind
// presorted_segment_accumulate).  That kernel sums each vocab tile's
// 128-entry chunks of a host sort plan with one-hot MXU matmuls, because the
// TPU has no fast scatter.  Here the ids are sorted on the device (a stable
// sort, done by the wrapper); a first launch fills the gradient with zeros,
// then the levels of segment_sum.cuh sum each run of equal ids with a fixed
// tree of warps and write its row once, however long the run.
//
// Bound: bytes.  The dense gradient is written once (rows x dim x 4 B, 205.5
// MB at the bench shape), the cotangent rows and the ids are read once:
// 222.8 MB, 0.0665 ms at 3.35 TB/s.  The fill is the bulk and streams
// coalesced float4 stores; the rows the batch touches are written a second
// time (16.8 MB at the bench shape).  No float atomics: one warp writes each
// output row, so the result is the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

template <typename V>
__global__ void fill_zero_kernel(float* __restrict__ out, int64_t count) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  V zero;
  float* z = reinterpret_cast<float*>(&zero);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) z[k] = 0.0f;
  V* dst = reinterpret_cast<V*>(out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count / kWidth;
       i += stride)
    dst[i] = zero;
}

}  // namespace

// 4-byte words of scratch rp_embedding_grad_f32 needs for n ids of dim
// columns.
extern "C" long long rp_embedding_grad_workspace_words(long long n, int dim) {
  return rp::workspace_words(n, dim);
}

// sorted_ids [n] i32 ascending and perm [n] i32 (a stable sort of the fused
// ids), rows [*, dim] f32, grad [num_rows, dim] f32 (every element written),
// workspace of workspace_words 4-byte words (at least
// rp_embedding_grad_workspace_words(n, dim)).  All contiguous on the current
// device.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rp_embedding_grad_f32(const void* sorted_ids, const void* perm,
                                     const void* rows, long long n, void* grad,
                                     long long num_rows, int dim, void* workspace,
                                     long long workspace_words, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || num_rows <= 0 || dim <= 0 ||
      workspace_words < rp::workspace_words(n, dim))
    return (int)cudaErrorInvalidValue;
  float* g = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t count = (int64_t)num_rows * dim;
  const int threads = 256;
  const bool vec4 = count % 4 == 0 && reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  int64_t blocks = (count / (vec4 ? 4 : 1) + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks an SM
  if (vec4) {
    fill_zero_kernel<float4><<<(unsigned)blocks, threads, 0, st>>>(g, count);
  } else {
    fill_zero_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(g, count);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rp::segment_sum(static_cast<const int32_t*>(sorted_ids),
                              static_cast<const int32_t*>(perm),
                              static_cast<const float*>(rows), n, dim,
                              rp::Output{g, true, num_rows}, nullptr, workspace, st);
}
