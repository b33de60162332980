// Helpers shared by the fused encoder (fused_encoder.cu), the global-attention
// encoder (global_attn.cu) and the K-max softmax CE (multimax_ce.cu): warp
// reductions, the dropout masks' counter hash, the ordered sum of per-block
// partial slices, and the shared-memory opt-in.
//
// The dropout hash has one twin outside this file, in torch integer
// operations (ops/kernels/fused_encoder.dropout_scale), so that the card and
// the CPU drop the same elements for a seed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp {

constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is tracked

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The 32-bit finalizer of the dropout hash.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// The key of sample n's mask on `stream` (the fused encoder's 3 * layer +
// site; IOCRec's own sites above every layer's).
__device__ __forceinline__ uint32_t dropout_key(uint32_t seed, uint32_t n, uint32_t stream) {
  return mix32(mix32(mix32(seed ^ 0x9e3779b9u) ^ n) ^ stream);
}

// Element `index` of a mask is kept when its draw is at least `threshold`:
// the factor is then `scale`, else 0.
__device__ __forceinline__ float dropout_factor(uint32_t key, uint32_t index,
                                                uint32_t threshold, float scale) {
  return mix32(key ^ mix32(index)) >= threshold ? scale : 0.0f;
}

// out[i] = sum over slices s, in order, of partials[s * count + i]: the
// parameter gradients of blocks that each own a slice, summed in a fixed
// order, so the bits repeat from run to run with no atomics.
__global__ void sum_slices_kernel(const float* __restrict__ partials, int slices, int64_t count,
                                  float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int b = 0; b < slices; ++b) s = __fadd_rn(s, __ldg(partials + (int64_t)b * count + i));
  out[i] = s;
}

inline cudaError_t sum_slices(const float* partials, int slices, int64_t count, float* out,
                              cudaStream_t stream) {
  sum_slices_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(partials, slices, count,
                                                                        out);
  return cudaGetLastError();
}

// Opts `kernel` in to `bytes` of dynamic shared memory on the current device
// when it needs more than 48 KB and more than before (opted[device], one
// array per kernel), so that a launch captured into a CUDA graph after one
// at the same shape calls nothing else.
inline cudaError_t opt_in(const void* kernel, size_t bytes, size_t* opted) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > opted[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[device] = bytes;
  }
  return cudaSuccess;
}

}  // namespace rp
