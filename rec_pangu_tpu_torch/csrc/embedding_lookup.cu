// Fused-table embedding lookup for Hopper (sm_90a).
//
//   out[r, :] = table[sparse[r] + offsets[r % F], :]     r in [0, B*F)
//
// Replaces the JAX package's scan-select forward (K1:
// rec_pangu_tpu/ops/kernels/embedding_grad.py, _select_tile_kernel and
// _select_kernel behind _select_stream).  That kernel streams the whole table
// through VMEM and picks rows with one-hot matmuls because the TPU has no
// fast row gather.  Hopper gathers natively, so this kernel reads only the
// rows it needs and keeps the value, not the layout: no host sort plan.
//
// Bound: bytes.  Each looked-up row is read once and written once, plus the
// ids; there is no arithmetic to speak of.  The design keeps the traffic at
// that minimum: consecutive threads own consecutive 16-byte pieces of a row
// (a group of D/4 threads per row), so every row is read and written with
// coalesced float4 accesses; the per-field offset add is folded in, so the
// fused ids are never materialized in device memory.  Addresses are 64-bit.
//
// A row id outside [0, rows) reads nothing and writes zeros, as in K1, where
// such an id matches no one-hot column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__device__ __forceinline__ V zero_value();

template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }

template <>
__device__ __forceinline__ float4 zero_value<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// V is float4 (dim % 4 == 0, 16-byte aligned pointers) or float.
template <typename V>
__global__ void embedding_lookup_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ sparse,
                                        const int32_t* __restrict__ offsets,
                                        float* __restrict__ out,
                                        int64_t rows, int64_t n, int fields,
                                        int dim) {
  const int64_t per_row = dim / (int)(sizeof(V) / sizeof(float));
  const int64_t total = n * per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t r = t / per_row;
    const int64_t c = t - r * per_row;
    const int64_t id = (int64_t)__ldg(sparse + r) + (int64_t)__ldg(offsets + r % fields);
    V v = zero_value<V>();
    if (id >= 0 && id < rows) {
      v = __ldg(reinterpret_cast<const V*>(table + id * dim) + c);
    }
    reinterpret_cast<V*>(out + r * dim)[c] = v;
  }
}

template <typename V>
void launch(const float* table, const int32_t* sparse, const int32_t* offsets,
            float* out, int64_t rows, int64_t n, int fields, int dim,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (dim / (int64_t)(sizeof(V) / sizeof(float)));
  int64_t blocks = (total + threads - 1) / threads;
  // the loop strides over anything beyond this many blocks
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  embedding_lookup_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      table, sparse, offsets, out, rows, n, fields, dim);
}

}  // namespace

// table [rows, dim] f32, sparse [n / fields, fields] i32, offsets [fields]
// i32, out [n, dim] f32; all contiguous on the current device.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rp_embedding_lookup_f32(const void* table, const void* sparse,
                                       const void* offsets, void* out,
                                       long long rows, long long n, int fields,
                                       int dim, void* stream) {
  if (n <= 0 || dim <= 0 || fields <= 0) return (int)cudaErrorInvalidValue;
  const bool vec4 = dim % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* t = static_cast<const float*>(table);
  const int32_t* s = static_cast<const int32_t*>(sparse);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<float4>(t, s, o, y, rows, n, fields, dim, st);
  } else {
    launch<float>(t, s, o, y, rows, n, fields, dim, st);
  }
  return (int)cudaGetLastError();
}
