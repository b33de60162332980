// IOCRec's global-attention encoder for Hopper (sm_90a), float32: forward and
// backward.
//
// For each sample n of x [N, L, D], with flax-layout weights Wk, Wv [D, D]
// ([in, out]), biases bk, bv [D] and the learned query bank Q [L, D]:
//   k = x Wk + bk,  v = x Wv + bv
//   P = softmax_rows(Q k^T)            (no 1/sqrt(D) scale and no padding mask)
//   y = (P v) * drop                    (inverted dropout on the output)
//
// Replaces the JAX package's K6f and K6b: rec_pangu_tpu/ops/kernels/
// global_attn.py, _fwd_kernel and _bwd_kernel (reached through _call and the
// global_attn custom VJP).  That kernel scores a tile of TB samples as one
// [TB*L, TB*L] block-diagonal matrix and expands Q by a one-hot product, to
// feed the TPU's matrix unit.  None of that carries over.  Here the forward
// gives each sample one thread block that holds x, Q, k, v and P in shared
// memory (62 KB at L=50, D=64); only x and y cross device memory, and the
// weights (32 KB) come from L2.  The products use 4 x 4 register tiles whose
// columns are strided so that neighbouring threads read neighbouring words;
// a warp owns a row of scores (L <= 64: two keys a lane).
//
// The backward recomputes each sample's forward from x and then
//   dctx = dy * drop, dv = P^T dctx, dP = dctx v^T,
//   dS = P * (dP - rowsum(dP * P)),
//   dQ += dS k, dk = dS^T Q,
//   dWk += x^T dk, dbk += colsum(dk), dWv += x^T dv, dbv += colsum(dv),
//   dx = dk Wk^T + dv Wv^T.
// dQ, dWk, dbk, dWv and dbv are sums over all samples.  No float atomics: a
// block owns the samples [b * per_block, (b + 1) * per_block), per_block =
// ceil(N / 264) (a function of N alone), and a private slice of `partials`
// that it adds each sample's terms to (an entry always by the same thread, in
// sample order); a second launch sums the slices in block order.  The bits
// repeat from run to run.
//
// Dropout draws the fused encoder's counter hash (csrc/kernel_common.cuh and
// ops/kernels/fused_encoder.dropout_scale): element (l, c) of sample n is kept
// when mix(key ^ mix(l * D + c)) >= threshold, key = mix(mix(mix(seed ^
// 0x9e3779b9) ^ n) ^ stream), with `stream` chosen by the caller apart from
// the encoder's 3 * layer + site.  The backward draws the same masks again.
//
// Bound: operations.  1,459,200 FLOP a sample forward at L=50, D=64 (4.48
// GFLOP at N=3072) against 78 MB of x and y; the backward recomputes k, v and
// P (not P v) and does twice the forward's products again, 12 L D^2 + 10 L^2 D
// a sample.  f32 on CUDA cores, no tensor cores in this first version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

using rp::dropout_factor;
using rp::dropout_key;
using rp::warp_max;
using rp::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;     // a warp holds a score row: two keys a lane
constexpr int kMaxD = 128;
constexpr int kMaxBwdBlocks = 264;

struct Dropout {
  uint32_t seed, stream, threshold;
  float scale;
  int on;
};

// The factor of element `index` of the sample whose key is `key`: scale when
// kept, 0 when dropped.
__device__ __forceinline__ float drop_factor(const Dropout& d, uint32_t key, uint32_t index) {
  return dropout_factor(key, index, d.threshold, d.scale);
}

__device__ __forceinline__ uint32_t sample_key(const Dropout& d, uint32_t n) {
  return dropout_key(d.seed, n, d.stream);
}

// A matrix operand: element (r, c) at p[r * rs + c * cs].
struct Mat {
  const float* p;
  int rs, cs;
  __device__ __forceinline__ float at(int r, int c) const { return p[r * rs + c * cs]; }
};

// For m < M, n < N: epi(m, n, sum_k A(m, k) B(k, n) + sum_k A2(m, k) B2(k, n))
// with K2 = 0 for one product.  A thread owns 4 rows and 4 columns strided by
// ceil(N / 4), so neighbouring threads read neighbouring columns; each sum is
// taken in ascending k, one fused multiply-add at a time.
template <class Epi>
__device__ void gemm(Mat A, Mat B, int K, Mat A2, Mat B2, int K2, int M, int N, Epi epi) {
  const int cstride = (N + 3) / 4;
  const int items = ((M + 3) / 4) * cstride;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int m0 = (item / cstride) * 4;
    const int c = item % cstride;
    int ms[4], ns[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ms[r] = min(m0 + r, M - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) ns[j] = min(c + j * cstride, N - 1);
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A.at(ms[r], k);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B.at(k, ns[j]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
    for (int k = 0; k < K2; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A2.at(ms[r], k);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B2.at(k, ns[j]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + r < M && c + j * cstride < N) epi(m0 + r, c + j * cstride, acc[r][j]);
  }
}

struct Params {
  const float* x;   // [N, L, D]
  const float* wk;  // [D, D], flax [in, out]
  const float* bk;  // [D]
  const float* wv;
  const float* bv;
  const float* q;   // [L, D]
  int L, D;
  Dropout drop;
};

// Shared-memory layout of one sample: x, Q, k, v [L][D + 1] and P [L][L + 1].
struct Arena {
  float *x, *q, *k, *v, *p;
  int ld, lp;
  __device__ Arena(float* base, int L, int D) {
    ld = D + 1;
    lp = L + 1;
    x = base;
    q = x + L * ld;
    k = q + L * ld;
    v = k + L * ld;
    p = v + L * ld;
  }
};

__device__ void load_rows(const float* __restrict__ src, int L, int D, float* dst, int ld) {
  for (int i = threadIdx.x; i < L * D; i += kThreads) dst[(i / D) * ld + i % D] = src[i];
}

// k, v and P of one sample whose x and Q are in the arena.
__device__ void forward_sample(const Params& P, const Arena& a) {
  const int L = P.L, D = P.D;
  const Mat none{nullptr, 0, 0};
  const Mat xs{a.x, a.ld, 1};
  float* ks = a.k;
  float* vs = a.v;
  const int ld = a.ld;
  const float* bk = P.bk;
  const float* bv = P.bv;
  gemm(xs, Mat{P.wk, D, 1}, D, none, none, 0, L, D,
       [&](int l, int c, float s) { ks[l * ld + c] = s + bk[c]; });
  gemm(xs, Mat{P.wv, D, 1}, D, none, none, 0, L, D,
       [&](int l, int c, float s) { vs[l * ld + c] = s + bv[c]; });
  __syncthreads();
  // scores and their softmax: a warp a row, two keys a lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = warp; l < L; l += kWarps) {
    const float* qrow = a.q + l * ld;
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      s[h] = __int_as_float(0xff800000);  // -inf
      if (j < L) {
        const float* krow = a.k + j * ld;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
        s[h] = acc;
      }
    }
    const float m = warp_max(fmaxf(s[0], s[1]));
    float e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) e[h] = lane + 32 * h < L ? expf(s[h] - m) : 0.0f;
    const float sum = warp_sum(e[0] + e[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < L) a.p[l * a.lp + lane + 32 * h] = e[h] / sum;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) global_attn_fwd_kernel(Params P, float* __restrict__ y) {
  extern __shared__ float smem[];
  const int L = P.L, D = P.D;
  const int64_t n = blockIdx.x;
  Arena a(smem, L, D);
  load_rows(P.x + n * L * D, L, D, a.x, a.ld);
  load_rows(P.q, L, D, a.q, a.ld);
  __syncthreads();
  forward_sample(P, a);
  const Mat none{nullptr, 0, 0};
  float* out = y + n * L * D;
  const Dropout& dr = P.drop;
  const uint32_t key = sample_key(dr, (uint32_t)n);
  // ctx = P v, times the dropout factor
  gemm(Mat{a.p, a.lp, 1}, Mat{a.v, a.ld, 1}, L, none, none, 0, L, D,
       [&](int l, int c, float s) {
         out[l * D + c] = dr.on ? __fmul_rn(s, drop_factor(dr, key, (uint32_t)(l * D + c))) : s;
       });
}

// The per-block gradient slice: dWk [D, D], dbk [D], dWv [D, D], dbv [D],
// dQ [L, D], in this order.
__host__ __device__ int64_t grad_floats(int L, int D) {
  return 2 * ((int64_t)D * D + D) + (int64_t)L * D;
}

struct BwdParams {
  Params p;
  const float* dy;
  float* dx;
  float* partials;
  int64_t n;
  int per_block;
};

__global__ void __launch_bounds__(kThreads) global_attn_bwd_kernel(BwdParams B) {
  extern __shared__ float smem[];
  const Params& P = B.p;
  const int L = P.L, D = P.D;
  Arena a(smem, L, D);
  // two more [L][D + 1] buffers (dctx, later dk; dv) and dP / dS [L][L + 1]
  float* cbuf = a.p + L * a.lp;
  float* dvbuf = cbuf + L * a.ld;
  float* dps = dvbuf + L * a.ld;
  const int ld = a.ld, lp = a.lp;
  const Mat none{nullptr, 0, 0};
  float* g = B.partials + (int64_t)blockIdx.x * grad_floats(L, D);
  float* gwk = g;
  float* gbk = gwk + D * D;
  float* gwv = gbk + D;
  float* gbv = gwv + D * D;
  float* gq = gbv + D;
  load_rows(P.q, L, D, a.q, ld);
  const int64_t first = (int64_t)blockIdx.x * B.per_block;
  const int64_t last = first + B.per_block < B.n ? first + B.per_block : B.n;
  const Dropout& dr = P.drop;
  for (int64_t n = first; n < last; ++n) {
    const bool init = n == first;  // the first sample stores, the rest add
    load_rows(P.x + n * L * D, L, D, a.x, ld);
    const uint32_t key = sample_key(dr, (uint32_t)n);
    const float* dy = B.dy + n * L * D;
    for (int i = threadIdx.x; i < L * D; i += kThreads) {
      const float d = dy[i];
      cbuf[(i / D) * ld + i % D] = dr.on ? __fmul_rn(d, drop_factor(dr, key, (uint32_t)i)) : d;
    }
    __syncthreads();
    forward_sample(P, a);  // k, v, P; ends with a barrier
    // dv = P^T dctx and dP = dctx v^T
    gemm(Mat{a.p, 1, lp}, Mat{cbuf, ld, 1}, L, none, none, 0, L, D,
         [&](int j, int c, float s) { dvbuf[j * ld + c] = s; });
    gemm(Mat{cbuf, ld, 1}, Mat{a.v, 1, ld}, D, none, none, 0, L, L,
         [&](int l, int j, float s) { dps[l * lp + j] = s; });
    __syncthreads();
    // dS = P * (dP - rowsum(dP * P)), a warp a row
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int l = warp; l < L; l += kWarps) {
      float t = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < L) t = fmaf(dps[l * lp + j], a.p[l * lp + j], t);
      }
      t = warp_sum(t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < L) dps[l * lp + j] = a.p[l * lp + j] * (dps[l * lp + j] - t);
      }
    }
    __syncthreads();
    // dQ += dS k; dk = dS^T Q (into the dctx buffer, dead since dP)
    gemm(Mat{dps, lp, 1}, Mat{a.k, ld, 1}, L, none, none, 0, L, D,
         [&](int l, int c, float s) {
           float* e = gq + l * D + c;
           *e = init ? s : *e + s;
         });
    gemm(Mat{dps, 1, lp}, Mat{a.q, ld, 1}, L, none, none, 0, L, D,
         [&](int j, int c, float s) { cbuf[j * ld + c] = s; });
    __syncthreads();
    // dWk += x^T dk, dWv += x^T dv, the bias sums, dx = dk Wk^T + dv Wv^T
    gemm(Mat{a.x, 1, ld}, Mat{cbuf, ld, 1}, L, none, none, 0, D, D,
         [&](int i, int c, float s) {
           float* e = gwk + i * D + c;
           *e = init ? s : *e + s;
         });
    gemm(Mat{a.x, 1, ld}, Mat{dvbuf, ld, 1}, L, none, none, 0, D, D,
         [&](int i, int c, float s) {
           float* e = gwv + i * D + c;
           *e = init ? s : *e + s;
         });
    for (int c = threadIdx.x; c < 2 * D; c += kThreads) {
      const float* src = c < D ? cbuf + c : dvbuf + (c - D);
      float s = 0.0f;
      for (int l = 0; l < L; ++l) s += src[l * ld];
      float* e = c < D ? gbk + c : gbv + (c - D);
      *e = init ? s : *e + s;
    }
    float* dx = B.dx + n * L * D;
    gemm(Mat{cbuf, ld, 1}, Mat{P.wk, 1, D}, D, Mat{dvbuf, ld, 1}, Mat{P.wv, 1, D}, D, L, D,
         [&](int l, int i, float s) { dx[l * D + i] = s; });
    __syncthreads();
  }
}

bool shape_ok(long long n, int L, int D) {
  return n > 0 && n <= 0x7fffffffLL && L > 0 && L <= kMaxL && D > 0 && D <= kMaxD;
}

size_t fwd_smem(int L, int D) {
  return sizeof(float) * ((size_t)4 * L * (D + 1) + (size_t)L * (L + 1));
}

size_t bwd_smem(int L, int D) {
  return sizeof(float) * ((size_t)6 * L * (D + 1) + (size_t)2 * L * (L + 1));
}

int bwd_blocks(long long n, int* per_block) {
  *per_block = (int)((n + kMaxBwdBlocks - 1) / kMaxBwdBlocks);
  return (int)((n + *per_block - 1) / *per_block);
}

Params make_params(const void* x, const void* wk, const void* bk, const void* wv,
                   const void* bv, const void* q, int L, int D, unsigned seed, unsigned stream,
                   unsigned threshold, float scale, int drop_on) {
  Params P;
  P.x = static_cast<const float*>(x);
  P.wk = static_cast<const float*>(wk);
  P.bk = static_cast<const float*>(bk);
  P.wv = static_cast<const float*>(wv);
  P.bv = static_cast<const float*>(bv);
  P.q = static_cast<const float*>(q);
  P.L = L;
  P.D = D;
  P.drop = Dropout{seed, stream, threshold, scale, drop_on};
  return P;
}

}  // namespace

// x [n, L, D], wk and wv [D, D] (flax [in, out]), bk and bv [D], q [L, D],
// y [n, L, D], all float32, contiguous, on the current device.  Dropout: a
// kept element is scaled by `scale`; drop_on = 0 keeps every element.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rp_global_attn_fwd_f32(const void* x, const void* wk, const void* bk,
                                      const void* wv, const void* bv, const void* q, void* y,
                                      long long n, int L, int D, unsigned seed, unsigned stream,
                                      unsigned threshold, float scale, int drop_on,
                                      void* stream_ptr) {
  if (!shape_ok(n, L, D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = fwd_smem(L, D);
  static size_t opted[rp::kMaxDevices] = {};
  cudaError_t err = rp::opt_in((const void*)global_attn_fwd_kernel, bytes, opted);
  if (err != cudaSuccess) return (int)err;
  Params P = make_params(x, wk, bk, wv, bv, q, L, D, seed, stream, threshold, scale, drop_on);
  global_attn_fwd_kernel<<<(unsigned)n, kThreads, bytes, static_cast<cudaStream_t>(stream_ptr)>>>(
      P, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

// 4-byte words of workspace rp_global_attn_bwd_f32 needs: the blocks'
// gradient slices.
extern "C" long long rp_global_attn_bwd_workspace_words(long long n, int L, int D) {
  if (n <= 0) return 0;
  int per_block = 0;
  return (long long)bwd_blocks(n, &per_block) * grad_floats(L, D);
}

// The backward: the forward's inputs and dropout arguments, dy [n, L, D];
// writes dx [n, L, D] and, to grads, dWk [D, D], dbk [D], dWv [D, D], dbv [D]
// and dQ [L, D] concatenated in this order.  workspace: at least
// rp_global_attn_bwd_workspace_words 4-byte words.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int rp_global_attn_bwd_f32(const void* x, const void* wk, const void* bk,
                                      const void* wv, const void* bv, const void* q,
                                      const void* dy, void* dx, void* grads, void* workspace,
                                      long long workspace_words, long long n, int L, int D,
                                      unsigned seed, unsigned stream, unsigned threshold,
                                      float scale, int drop_on, void* stream_ptr) {
  if (!shape_ok(n, L, D) || workspace_words < rp_global_attn_bwd_workspace_words(n, L, D))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = bwd_smem(L, D);
  static size_t opted[rp::kMaxDevices] = {};
  cudaError_t err = rp::opt_in((const void*)global_attn_bwd_kernel, bytes, opted);
  if (err != cudaSuccess) return (int)err;
  int per_block = 0;
  const int blocks = bwd_blocks(n, &per_block);
  BwdParams B;
  B.p = make_params(x, wk, bk, wv, bv, q, L, D, seed, stream, threshold, scale, drop_on);
  B.dy = static_cast<const float*>(dy);
  B.dx = static_cast<float*>(dx);
  B.partials = static_cast<float*>(workspace);
  B.n = n;
  B.per_block = per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  global_attn_bwd_kernel<<<(unsigned)blocks, kThreads, bytes, st>>>(B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rp::sum_slices(B.partials, blocks, grad_floats(L, D), static_cast<float*>(grads),
                             st);
}
