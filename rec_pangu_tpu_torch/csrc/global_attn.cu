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
// feed the TPU's matrix unit.  None of that carries over.
//
// Dropout draws the fused encoder's counter hash (csrc/kernel_common.cuh and
// ops/kernels/fused_encoder.dropout_scale): element (l, c) of sample n is kept
// when mix(key ^ mix(l * D + c)) >= threshold, key = mix(mix(mix(seed ^
// 0x9e3779b9) ^ (first + n)) ^ stream), with `stream` chosen by the caller
// apart from the encoder's 3 * layer + site and `first` the block's first
// row in the global batch (0 outside a data-parallel mesh).  The backward
// draws the same masks again.
//
// The backward (K6b) recomputes each sample's k, v and P from x and then
//   dctx = dy * drop, dv = P^T dctx, dP = dctx v^T,
//   dS = P * (dP - rowsum(dP * P)),
//   dQ += dS k, dk = dS^T Q,
//   dWk += x^T dk, dbk += colsum(dk), dWv += x^T dv, dbv += colsum(dv),
//   dx = dk Wk^T + dv Wv^T.
// Bounds: operations in both directions, f32 on CUDA cores.  The forward does
// 4 L D^2 + 4 L^2 D FLOP a sample (1,459,200 at L=50, D=64; 4.48 GFLOP, 0.067
// ms at 67 TFLOP/s for N=3072) against 2 x 12.8 KB of x and y; the backward
// 12 L D^2 + 10 L^2 D (4.06 MFLOP; 12.5 GFLOP, 0.186 ms) against 3 x 12.8 KB
// of x, dy and dx.
//
// Design, both directions.  Each replaced a block of 256 threads a sample
// that read the weights from L2 inside its product loops and took scalar
// shared-memory operands: on an H100 80GB HBM3 at 700 W, at IOCRec's shape,
// the backward (which also wrote its gradient slice to device memory after
// every sample) went from 1.76 to 0.60 ms, the forward from 0.435 to 0.235
// ms (3072 samples, dropout 0.5; 0.077 ms at 1024 without).
// - Groups.  A group of 256 threads takes one sample at a time, with a named
//   barrier of its own; a block runs several groups over one copy of Q (and
//   of Wk and Wv where they fit).  The forward's blocks hold as many groups
//   as fit, up to four (kFwdGroups; four at IOCRec's shape, 32 warps an SM),
//   with min(SMs, ceil(N / groups)) blocks: group j of the G in all takes
//   samples [j N / G, (j + 1) N / G).  The backward's blocks hold two groups
//   at IOCRec's shape, over 264 gradient slices (below).
// - Resident weights.  That variant loads Q, Wk and Wv into shared memory
//   once a block; a sample's only device-memory traffic is its x and y (and
//   dy and dx).  The recompute (x W) reads W along its rows k-major; dx (dk
//   W^T) reads W along its rows too, as dot products.  Shapes whose buffers
//   do not fit run the streamed variant: W and W^T read as float4 rows from
//   zero-padded copies that a transpose kernel writes into the workspace
//   first (coalesced on both sides).  The forward's resident variant takes
//   every D <= 64 (L=64 with three groups); the backward's every D <= 64
//   but L=64.
// - One recompute.  project_kv, score_rows and softmax_rows compute k, v and
//   P for both kernels, so the backward's P is the forward's bit for bit.
//   The forward then takes y = P v, with P's rows in x's buffer (dead once k
//   and v are written) and the dropout factor in the epilogue, which stores
//   y as float4.
// - Register tiles.  Every product gives a thread 4 x 4 outputs (kTw = 4),
//   its operands read as float4 from shared memory: 8 floats for 16 FMAs.
//   An operand stored k-major gives 4 neighbouring rows of one k; one stored
//   with k contiguous gives 4 k of one row, the thread's rows then strided
//   (tm + r * tiles).  A warp takes a block of 4 x 8 tiles; every buffer's row
//   stride is an odd number of float4 (68 at D=64), so the 4 or 8 rows a warp
//   reads at one k lie in different bank quads.  Each phase ends at one
//   barrier: k and v; scores; softmax; then the forward's P v, or the
//   backward's dP; dv (into v's buffer) with dS; dQ with dk (into dctx's
//   buffer); dWk, dWv, the bias sums and dx.  The softmax and dS take a
//   quarter-warp a row.  L is padded to Lp = 52 (a multiple of 4) and D to
//   Dp (of 8, so that kTw may be 8) with zeros; P and dS are 0 past L, so
//   the padding adds nothing to any sum.
// - Gradient sums on chip (backward).  dWk and dWv (a 4 x 4 tile of each a
//   thread at D=64) and an entry of dbk|dbv live in registers across the
//   group's samples; dQ's sums live in the group's shared memory (registers
//   are the scarcer: 512 threads get 128 each).  Each entry belongs to one
//   thread and is summed one fused multiply-add at a time, l ascending
//   within a sample and samples ascending.  The group writes its gradient
//   slice to device memory once, at the end.  No float atomics: kSlices = 264
//   slices (2 x 132 SMs, whatever the card); slice s takes samples
//   [s N / S, (s + 1) N / S) with S = min(N, 264), a function of N alone; a
//   second launch (rp::sum_slices) adds the slices in order.  The bits
//   repeat from run to run, and the two variants give the same bits.  So do
//   the forward's: a sample's y does not depend on the group that takes it.
// - What bounds them: the products.  An SM delivers 32 floats a clock from
//   shared memory to registers and issues 128 FMAs, so 4 x 4 tiles (a float
//   every 2 FMAs) run at most at half the FMA rate; 4 x 8 tiles need more
//   than the 128 registers a backward thread has and spill.  The probes
//   (scripts/torch_global_attn_{fwd,bwd}.py --variants): the backward's
//   products take about 0.45 of its 0.60 ms; the forward's 0.156 of its
//   0.235 ms, 30 TB/s of operands, the card's shared-memory rate.  Four
//   forward groups of 256 threads get 64 registers each (4 to 8 B spilled)
//   and beat three groups (80 registers, 0.243 ms) and four of 128 threads
//   (0.257 ms).
// Shared memory, floats (Lp = 52, Dp = 64, stride 68 at IOCRec's shape):
//   both: Q Lp x 68 (3,536) + resident Wk, Wv 2 x Dp x 68 (8,704) a block;
//   forward, each group: x (later the scores and P), k, v 3 x Lp x 68
//   (10,608); four groups: 54,672 floats = 218,688 B of the 232,448 a block
//   may opt in to;
//   backward, each group: x, dctx (later dk), k, v (later dv) 4 x Lp x 68
//   (14,144), P, dP (later dS) 2 x Lp x Lp (5,408), dQ's sums Lp x Dp
//   (3,328); two groups: 58,000 floats = 232,000 B.  The streamed variants
//   at the largest shape (L=64, D=128): forward 135,168 B (one group),
//   backward 201,728 B.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

using rp::dropout_factor;
using rp::dropout_key;

constexpr int kMaxL = 64;     // a quarter-warp holds a score row: eight keys a lane
constexpr int kMaxD = 128;

struct Dropout {
  uint32_t seed, stream, threshold;
  float scale;
  int on;
  uint32_t first;  // the hash's sample index of sample 0 (a block's first global row)
};

// The factor of element `index` of the sample whose key is `key`: scale when
// kept, 0 when dropped.
__device__ __forceinline__ float drop_factor(const Dropout& d, uint32_t key, uint32_t index) {
  return dropout_factor(key, index, d.threshold, d.scale);
}

__device__ __forceinline__ uint32_t sample_key(const Dropout& d, uint32_t n) {
  return dropout_key(d.seed, d.first + n, d.stream);
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

constexpr int kSlices = 264;          // gradient slices: 2 x 132, whatever the card
constexpr int kGroupThreads = 256;    // the backward's threads on one sample
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kTw = 4;                // tile width of the L x D and D x D products
constexpr size_t kMaxSmem = 232448;   // the shared memory a block may opt in to
constexpr int kAuto = -1, kStreamed = 0, kResident = 1;  // variants

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// A row stride of an odd number of float4: eight consecutive rows read as
// float4 at one column lie in eight different bank quads.
__host__ __device__ constexpr int odd4(int x) { return (x / 4) % 2 ? x : x + 4; }

// The per-slice gradient: dWk [D, D], dbk [D], dWv [D, D], dbv [D], dQ [L, D],
// in this order.
__host__ __device__ int64_t grad_floats(int L, int D) {
  return 2 * ((int64_t)D * D + D) + (int64_t)L * D;
}

// One group's sample buffers, floats: x, dctx (later dk), k, v (later dv)
// [Lp][ld]; P, dP (later dS) [Lp][Lp]; and with dQ's sums in shared memory,
// those [Lp][Dp].
__host__ __device__ int sample_floats(int Lp, int Dp, int ld, bool dq_shared) {
  return 4 * Lp * ld + 2 * Lp * Lp + (dq_shared ? Lp * Dp : 0);
}

// v[e][q] = element e's value at k + q (e < E): E rows `step` apart, k
// contiguous (p[e * step + k + q]), one float4 a row.
template <int E>
__device__ __forceinline__ void load_kquad(const float* p, int step, int k, float (&v)[E][4]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float4 t = *reinterpret_cast<const float4*>(p + e * step + k);
    v[e][0] = t.x;
    v[e][1] = t.y;
    v[e][2] = t.z;
    v[e][3] = t.w;
  }
}

// v[e] = p[e] for e < E, as float4: a k-major operand's E elements of one k.
template <int E>
__device__ __forceinline__ void load_run(const float* p, float (&v)[E]) {
#pragma unroll
  for (int g = 0; g < E / 4; ++g) {
    const float4 t = *reinterpret_cast<const float4*>(p + 4 * g);
    v[4 * g] = t.x;
    v[4 * g + 1] = t.y;
    v[4 * g + 2] = t.z;
    v[4 * g + 3] = t.w;
  }
}

// Row or column e (< E) of tile t: E t + e for a k-major operand, t + e *
// tiles for one with k contiguous.
template <bool KMajor, int E>
__device__ __forceinline__ int tile_index(int t, int e, int tiles) {
  return KMajor ? E * t + e : t + e * tiles;
}

// acc[r][j] += sum over k < K of A(m_r, k) B(k, n_j), k ascending, one fused
// multiply-add at a time; m_r = tile_index<AK, 4>(tm, r, mt), n_j =
// tile_index<BK, C>(tn, j, nt).  A(m, k) is a[k * lda + m] when AK, else
// a[m * lda + k]; B(k, n) is b[k * ldb + n] when BK, else b[n * ldb + k].
// K, the strides and the pointers are multiples of 4 floats.  A thread reads
// 4 + C floats for every 4 C multiply-adds: a k-major operand one k at a
// time, one with k contiguous four k at a time (fewer live registers).
template <bool AK, bool BK, int C>
__device__ __forceinline__ void tile_fma(const float* a, int lda, const float* b, int ldb, int tm,
                                         int tn, int mt, int nt, int K, float (&acc)[4][C]) {
  const float* pa = AK ? a + 4 * tm : a + tm * lda;
  const float* pb = BK ? b + C * tn : b + tn * ldb;
  const int astep = mt * lda, bstep = nt * ldb;
  for (int k = 0; k < K; k += 4) {
    float ar[AK ? 1 : 4][4], br[BK ? 1 : C][4];
    if (!AK) load_kquad<AK ? 1 : 4>(pa, astep, k, ar);
    if (!BK) load_kquad<BK ? 1 : C>(pb, bstep, k, br);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float av[4], bv[C];
      if (AK) {
        load_run<4>(pa + (k + q) * lda, av);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = ar[AK ? 0 : r][q];
      }
      if (BK) {
        load_run<C>(pb + (k + q) * ldb, bv);
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j) bv[j] = br[BK ? 0 : j][q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
    }
  }
}

// p[0 .. C) <- row, as float4.
template <int C>
__device__ __forceinline__ void store_row(float* p, const float (&row)[C]) {
#pragma unroll
  for (int g = 0; g < C / 4; ++g)
    *reinterpret_cast<float4*>(p + 4 * g) =
        make_float4(row[4 * g], row[4 * g + 1], row[4 * g + 2], row[4 * g + 3]);
}

// Sum and maximum over the 8 lanes of a quarter-warp (all 32 lanes call).
__device__ __forceinline__ float quarter_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quarter_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst [rows_p][ld] <- src [rows][cols], zero past rows and cols (up to cols_p).
__device__ void load_padded(const float* __restrict__ src, int rows, int cols, float* dst,
                            int rows_p, int cols_p, int ld, int tid, int threads) {
  for (int i = tid; i < rows_p * cols_p; i += threads) {
    const int r = i / cols_p, c = i % cols_p;
    dst[r * ld + c] = r < rows && c < cols ? src[r * cols + c] : 0.0f;
  }
}

// The barrier of group g alone (named barrier g + 1; 0 is __syncthreads), a
// group of kGT threads.
template <int kGT = kGroupThreads>
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(kGT) : "memory");
}

// Tile (tm, tn) of item `slot` of a phase over a grid of mt x nt tiles: a
// warp takes a block of 4 x 8 tiles, so that its float4 reads of an operand
// at one k touch 4 or 8 rows (in different bank quads) or 8 neighbouring
// quads of one row.  False for the slots past the grid's edge.
__device__ __forceinline__ bool tile_at(int slot, int mt, int nt, int& tm, int& tn) {
  const int blocks_n = (nt + 7) / 8, b = slot / 32, lane = slot % 32;
  tm = 4 * (b / blocks_n) + lane / 8;
  tn = 8 * (b % blocks_n) + lane % 8;
  return tm < mt && tn < nt;
}

__host__ __device__ constexpr int tile_slots(int mt, int nt) {
  return 32 * ((mt + 3) / 4) * ((nt + 7) / 8);
}

// ---------------------------------------------------------------------------
// One recompute for both directions: k, v and P of a sample, by thread t of
// a group of kGT.  The backward's P is the forward's, bit for bit.

// k = x Wk + bk and v = x Wv + bv, x [Lp][ld] in shared memory (0 past L and
// D), W read k-major (row stride ldw, 0 past D); rows past L are 0.
template <int kGT>
__device__ __forceinline__ void project_kv(const Params& P, const float* xs, const float* wk,
                                           const float* wv, int ldw, float* ks, float* vs,
                                           int Lp, int Dp, int ld, int t) {
  const int L = P.L, D = P.D, lt = Lp / 4, dw = Dp / kTw, s_ldw = tile_slots(lt, dw);
  for (int slot = t; slot < 2 * s_ldw; slot += kGT) {
    const bool is_v = slot >= s_ldw;
    int tm, tn;
    if (!tile_at(is_v ? slot - s_ldw : slot, lt, dw, tm, tn)) continue;
    const float* bias = is_v ? P.bv : P.bk;
    float* out = is_v ? vs : ks;
    float acc[4][kTw] = {};
    tile_fma<false, true, kTw>(xs, ld, is_v ? wv : wk, ldw, tm, tn, lt, dw, Dp, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int l = tm + r * lt;
      float row[kTw];
#pragma unroll
      for (int j = 0; j < kTw; ++j) {
        const int c = kTw * tn + j;
        row[j] = l < L ? acc[r][j] + (c < D ? bias[c] : 0.0f) : 0.0f;
      }
      store_row<kTw>(out + l * ld + kTw * tn, row);
    }
  }
}

// The scores Q k^T into ps [Lp][Lp].
template <int kGT>
__device__ __forceinline__ void score_rows(const float* qs, const float* ks, float* ps, int Lp,
                                           int Dp, int ld, int t) {
  const int lt = Lp / 4, s_ll = tile_slots(lt, lt);
  for (int slot = t; slot < s_ll; slot += kGT) {
    int tm, tn;
    if (!tile_at(slot, lt, lt, tm, tn)) continue;
    float acc[4][4] = {};
    tile_fma<false, false, 4>(qs, ld, ks, ld, tm, tn, lt, lt, Dp, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(tm + r * lt) * Lp + tn + j * lt] = acc[r][j];
  }
}

// P = softmax of each score row in place, a quarter-warp a row (8 keys a
// lane); 0 past L.  A warp's four rows are all below Lp or all past it.
template <int kGT>
__device__ __forceinline__ void softmax_rows(float* ps, int L, int Lp, int t) {
  const int quarter = t / 8, ql = t % 8;
  for (int l = quarter; l < Lp; l += 4 * (kGT / 32)) {
    float* row = ps + l * Lp;
    const bool valid = l < L;
    float sv[8];
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int j = ql + 8 * h;
      sv[h] = valid && j < L ? row[j] : __int_as_float(0xff800000);  // -inf
    }
    float m = sv[0];
#pragma unroll
    for (int h = 1; h < 8; ++h) m = fmaxf(m, sv[h]);
    m = quarter_max(valid ? m : 0.0f);
    float e[8], sum = 0.0f;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      e[h] = valid && ql + 8 * h < L ? expf(sv[h] - m) : 0.0f;
      sum += e[h];
    }
    const float total = quarter_sum(sum);
    const float inv = valid ? __frcp_rn(total) : 0.0f;
#pragma unroll
    for (int h = 0; h < 8; ++h)
      if (ql + 8 * h < Lp) row[ql + 8 * h] = e[h] * inv;
  }
}

// ---------------------------------------------------------------------------
// The forward (K6f): see the header for its design.

constexpr int kFwdGroups = 4;          // groups a block, at most
constexpr int kFwdGroupThreads = 256;  // the forward's threads on one sample

// One forward group's buffers, floats: x [Lp][ld], which the scores and P
// [Lp][Lp] take over once k and v are written, then k and v [Lp][ld].
__host__ __device__ constexpr int fwd_x_floats(int Lp, int ld) { return Lp * (ld > Lp ? ld : Lp); }
__host__ __device__ constexpr int fwd_group_floats(int Lp, int ld) {
  return fwd_x_floats(Lp, ld) + 2 * Lp * ld;
}

struct FwdParams {
  Params p;
  float* y;
  const float* wpad;  // streamed: Wk, Wv, each [Dp][Dp], zero-padded
  int64_t n;
  int vec;            // D % 4 == 0 and x, y 16-byte aligned: float4 loads and stores
  int Lp, Dp, ld;
};

// blockDim.x / kGT groups; kResident: Wk, Wv in shared memory, else read
// from `wpad`.  Group j of the grid's G takes samples [j N / G, (j + 1) N / G).
template <int kGT, bool kResident>
__global__ void __launch_bounds__(kFwdGroups * kGT, 1) global_attn_fwd_kernel(FwdParams F) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Params& P = F.p;
  const int L = P.L, D = P.D, Lp = F.Lp, Dp = F.Dp, ld = F.ld;
  const int lt = Lp / 4, dt = Dp / 4, s_ld4 = tile_slots(lt, dt);
  float* qs = smem;           // [Lp][ld]
  float* wks = qs + Lp * ld;  // resident: [Dp][ld]
  float* wvs = wks + Dp * ld;
  float* groups = kResident ? wvs + Dp * ld : wks;
  load_padded(P.q, L, D, qs, Lp, Dp, ld, threadIdx.x, blockDim.x);
  if (kResident) {
    load_padded(P.wk, D, D, wks, Dp, Dp, ld, threadIdx.x, blockDim.x);
    load_padded(P.wv, D, D, wvs, Dp, Dp, ld, threadIdx.x, blockDim.x);
  }
  __syncthreads();
  const float* wk = kResident ? wks : F.wpad;
  const float* wv = kResident ? wvs : F.wpad + Dp * Dp;
  const int ldw = kResident ? ld : Dp;

  const int per_block = blockDim.x / kGT;
  const int g = threadIdx.x / kGT, t = threadIdx.x % kGT;
  const int64_t total = (int64_t)gridDim.x * per_block, j = (int64_t)blockIdx.x * per_block + g;
  const int64_t first = j * F.n / total, last = (j + 1) * F.n / total;
  float* xs = groups + g * fwd_group_floats(Lp, ld);  // x, then the scores and P
  float* ks = xs + fwd_x_floats(Lp, ld);
  float* vs = ks + Lp * ld;
  const Dropout& dr = P.drop;
  for (int64_t n = first; n < last; ++n) {
    // x, zero-padded to [Lp][Dp] (P overwrote the last sample's padding)
    const float* xg = P.x + n * L * D;
    if (F.vec) {
      const int dq = Dp / 4;
      for (int i = t; i < Lp * dq; i += kGT) {
        const int l = i / dq, c = 4 * (i % dq);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (l < L && c < D) v = *reinterpret_cast<const float4*>(xg + l * D + c);
        *reinterpret_cast<float4*>(xs + l * ld + c) = v;
      }
    } else {
      for (int i = t; i < Lp * Dp; i += kGT) {
        const int l = i / Dp, c = i % Dp;
        xs[l * ld + c] = l < L && c < D ? xg[l * D + c] : 0.0f;
      }
    }
    group_sync<kGT>(g);
    project_kv<kGT>(P, xs, wk, wv, ldw, ks, vs, Lp, Dp, ld, t);
    group_sync<kGT>(g);
    score_rows<kGT>(qs, ks, xs, Lp, Dp, ld, t);  // x is dead
    group_sync<kGT>(g);
    softmax_rows<kGT>(xs, L, Lp, t);
    group_sync<kGT>(g);
    // y = (P v) * drop: P with k contiguous, v k-major, so that a thread
    // owns 4 rows strided by lt and 4 neighbouring columns
    float* yg = F.y + n * L * D;
    const uint32_t key = sample_key(dr, (uint32_t)n);
    for (int slot = t; slot < s_ld4; slot += kGT) {
      int tm, tn;
      if (!tile_at(slot, lt, dt, tm, tn)) continue;
      float acc[4][4] = {};
      tile_fma<false, true, 4>(xs, Lp, vs, ld, tm, tn, lt, dt, Lp, acc);
      const int c = 4 * tn;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = tm + r * lt;
        if (l >= L) continue;
        if (dr.on) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = __fmul_rn(acc[r][q], drop_factor(dr, key, (uint32_t)(l * D + c + q)));
        }
        if (F.vec) {
          if (c < D)
            *reinterpret_cast<float4*>(yg + l * D + c) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < D) yg[l * D + c + q] = acc[r][q];
        }
      }
    }
    group_sync<kGT>(g);  // the next sample overwrites x, which holds P
  }
}

// ---------------------------------------------------------------------------
// The backward (K6b): see the header for its design.

struct BwdParams {
  Params p;
  const float* dy;
  float* dx;
  const float* wpad;  // streamed: Wk, Wv, Wk^T, Wv^T, each [Dp][Dp], zero-padded
  float* partials;    // [slices][grad_floats]
  int64_t n;
  int vec;            // D % 4 == 0 and x, dy 16-byte aligned: float4 reads
  int slices;
  int Lp, Dp, ld;
};

// kGroups groups of kGroupThreads; kResident: Wk, Wv in shared memory, else
// streamed from `wpad`; kWT: the dWk|dWv tile slots a thread owns; kQT: the
// dQ tile slots it owns in registers, or 0 for dQ's sums in shared memory.
template <int kGroups, bool kResident, int kWT, int kQT>
__global__ void __launch_bounds__(kGroups * kGroupThreads, 1)
    global_attn_bwd_kernel(BwdParams B) {
  constexpr bool kDqShared = kQT == 0;
  constexpr int kBlockThreads = kGroups * kGroupThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Params& P = B.p;
  const int L = P.L, D = P.D, Lp = B.Lp, Dp = B.Dp, ld = B.ld;
  const int lt = Lp / 4, dt = Dp / 4, dw = Dp / kTw;  // tiles: 4 rows; 4 or kTw columns
  const int gfloats = sample_floats(Lp, Dp, ld, kDqShared);
  float* qs = smem;           // [Lp][ld]
  float* wks = qs + Lp * ld;  // resident: [Dp][ld]
  float* wvs = wks + Dp * ld;
  float* groups = kResident ? wvs + Dp * ld : wks;
  load_padded(P.q, L, D, qs, Lp, Dp, ld, threadIdx.x, kBlockThreads);
  if (kResident) {
    load_padded(P.wk, D, D, wks, Dp, Dp, ld, threadIdx.x, kBlockThreads);
    load_padded(P.wv, D, D, wvs, Dp, Dp, ld, threadIdx.x, kBlockThreads);
  }
  // x's and dctx's padding stays 0: each sample writes only its L x D values,
  // and dk (which replaces dctx) is 0 past L and past D.  dQ's sums start at 0.
  const int zeroed = 2 * Lp * ld + (kDqShared ? Lp * Dp : 0);
  for (int i = threadIdx.x; i < kGroups * zeroed; i += kBlockThreads) {
    const int gi = i / zeroed, e = i % zeroed;
    groups[gi * gfloats + (e < 2 * Lp * ld ? e : e + 2 * Lp * ld + 2 * Lp * Lp)] = 0.0f;
  }
  __syncthreads();
  // k = x W + b reads W k-major; dx = dk W^T + dv W^T reads W with k (its
  // output axis) contiguous when resident, W^T k-major when streamed.
  const float* wk = kResident ? wks : B.wpad;
  const float* wv = kResident ? wvs : B.wpad + Dp * Dp;
  const float* wkx = kResident ? wks : B.wpad + 2 * Dp * Dp;
  const float* wvx = kResident ? wvs : B.wpad + 3 * Dp * Dp;
  const int ldw = kResident ? ld : Dp;

  const int g = threadIdx.x / kGroupThreads, t = threadIdx.x % kGroupThreads;
  const int s = blockIdx.x * kGroups + g;
  if (s >= B.slices) return;  // the whole group: no barrier of the block follows
  float* xs = groups + g * gfloats;
  float* cs = xs + Lp * ld;    // dctx, then dk
  float* ks = cs + Lp * ld;
  float* vs = ks + Lp * ld;    // v, then dv
  float* ps = vs + Lp * ld;    // P
  float* dps = ps + Lp * Lp;   // dP, then dS
  float* qsum = dps + Lp * Lp;  // dQ's sums [Lp][Dp] when kDqShared
  const int quarter = t / 8, ql = t % 8;  // a quarter-warp a row of scores
  // slots of the phases: L x D and D x D products in 4 x kTw tiles, L x L
  // products, dv and dx in 4 x 4 tiles
  const int s_ldw = tile_slots(lt, dw), s_ll = tile_slots(lt, lt), s_ld4 = tile_slots(lt, dt),
            s_w = tile_slots(dt, dw);

  float gw[kWT][4][kTw];                  // the slice's dWk (slot < s_w) or dWv tiles
  float gq[kDqShared ? 1 : kQT][4][kTw];  // dQ's, when held in registers
  float gb = 0.0f;                         // an entry of [dbk | dbv]
#pragma unroll
  for (int i = 0; i < kWT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kTw; ++j) gw[i][r][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kDqShared ? 1 : kQT); ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kTw; ++j) gq[i][r][j] = 0.0f;

  const Dropout& dr = P.drop;
  const int64_t first = s * B.n / B.slices, last = (s + 1) * B.n / B.slices;
  for (int64_t n = first; n < last; ++n) {
    // x and dctx = dy * drop, as float4 where x and dy allow it (one of
    // each in flight a thread: more costs registers the products need)
    const float* xg = P.x + n * L * D;
    const float* dyg = B.dy + n * L * D;
    const uint32_t key = sample_key(dr, (uint32_t)n);
    if (B.vec) {
      const int dq = D / 4, quads = L * dq;
      for (int i = t; i < quads; i += kGroupThreads) {
        const float4 xv = *reinterpret_cast<const float4*>(xg + 4 * i);
        float4 d = *reinterpret_cast<const float4*>(dyg + 4 * i);
        const int l = i / dq, c = 4 * (i % dq), e = 4 * i;
        *reinterpret_cast<float4*>(xs + l * ld + c) = xv;
        if (dr.on) {
          d.x = __fmul_rn(d.x, drop_factor(dr, key, (uint32_t)e));
          d.y = __fmul_rn(d.y, drop_factor(dr, key, (uint32_t)e + 1));
          d.z = __fmul_rn(d.z, drop_factor(dr, key, (uint32_t)e + 2));
          d.w = __fmul_rn(d.w, drop_factor(dr, key, (uint32_t)e + 3));
        }
        *reinterpret_cast<float4*>(cs + l * ld + c) = d;
      }
    } else {
      for (int e = t; e < L * D; e += kGroupThreads) {
        const int l = e / D, c = e % D;
        const float d = dyg[e];
        xs[l * ld + c] = xg[e];
        cs[l * ld + c] = dr.on ? __fmul_rn(d, drop_factor(dr, key, (uint32_t)e)) : d;
      }
    }
    group_sync(g);
    // k = x Wk + bk, v = x Wv + bv; the scores Q k^T into P's buffer; P
    project_kv<kGroupThreads>(P, xs, wk, wv, ldw, ks, vs, Lp, Dp, ld, t);
    group_sync(g);
    score_rows<kGroupThreads>(qs, ks, ps, Lp, Dp, ld, t);
    group_sync(g);
    softmax_rows<kGroupThreads>(ps, L, Lp, t);
    group_sync(g);
    // dP = dctx v^T
    for (int slot = t; slot < s_ll; slot += kGroupThreads) {
      int tm, tn;
      if (!tile_at(slot, lt, lt, tm, tn)) continue;
      float acc[4][4] = {};
      tile_fma<false, false, 4>(cs, ld, vs, ld, tm, tn, lt, lt, Dp, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) dps[(tm + r * lt) * Lp + tn + j * lt] = acc[r][j];
    }
    group_sync(g);
    // dv = P^T dctx into v's buffer (v is dead), and dS = P * (dP -
    // rowsum(dP * P)) in place, a quarter-warp a row
    for (int slot = t; slot < s_ld4; slot += kGroupThreads) {
      int tm, tn;
      if (!tile_at(slot, lt, dt, tm, tn)) continue;
      float acc[4][4] = {};
      tile_fma<true, true, 4>(ps, Lp, cs, ld, tm, tn, lt, dt, Lp, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) store_row<4>(vs + (4 * tm + r) * ld + 4 * tn, acc[r]);
    }
    for (int l = quarter; l < Lp; l += 4 * kGroupWarps) {
      float* d = dps + l * Lp;
      const float* p = ps + l * Lp;
      float rs = 0.0f;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int j = ql + 8 * h;
        if (j < Lp) rs = fmaf(d[j], p[j], rs);
      }
      rs = quarter_sum(rs);
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int j = ql + 8 * h;
        if (j < Lp) d[j] = p[j] * (d[j] - rs);
      }
    }
    group_sync(g);
    // dQ += dS k into the thread's own tiles (in shared memory or registers);
    // dk = dS^T Q into dctx's buffer, dealt out from thread s_ldw on
    if (kDqShared) {
      for (int slot = t; slot < s_ldw; slot += kGroupThreads) {
        int tm, tn;
        if (!tile_at(slot, lt, dw, tm, tn)) continue;
        float acc[4][kTw];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < kTw; ++j) acc[r][j] = qsum[(tm + r * lt) * Dp + kTw * tn + j];
        tile_fma<false, true, kTw>(dps, Lp, ks, ld, tm, tn, lt, dw, Lp, acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) store_row<kTw>(qsum + (tm + r * lt) * Dp + kTw * tn, acc[r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < (kDqShared ? 1 : kQT); ++i) {
        int tm, tn;
        if (tile_at(t + i * kGroupThreads, lt, dw, tm, tn))
          tile_fma<false, true, kTw>(dps, Lp, ks, ld, tm, tn, lt, dw, Lp, gq[i]);
      }
    }
    for (int slot = (t + kGroupThreads - s_ldw % kGroupThreads) % kGroupThreads; slot < s_ldw;
         slot += kGroupThreads) {
      int tm, tn;
      if (!tile_at(slot, lt, dw, tm, tn)) continue;
      float acc[4][kTw] = {};
      tile_fma<true, true, kTw>(dps, Lp, qs, ld, tm, tn, lt, dw, Lp, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) store_row<kTw>(cs + (4 * tm + r) * ld + kTw * tn, acc[r]);
    }
    group_sync(g);
    // dWk += x^T dk or dWv += x^T dv into the thread's own tiles, the bias
    // sums into its own entry of [dbk | dbv], and dx = dk Wk^T + dv Wv^T
#pragma unroll
    for (int i = 0; i < kWT; ++i) {
      const int w = t + i * kGroupThreads;
      const bool is_v = w >= s_w;
      int tm, tn;
      if (w < 2 * s_w && tile_at(is_v ? w - s_w : w, dt, dw, tm, tn))
        tile_fma<true, true, kTw>(xs, ld, is_v ? vs : cs, ld, tm, tn, dt, dw, Lp, gw[i]);
    }
    if (t < 2 * Dp) {
      const float* col = t < Dp ? cs + t : vs + (t - Dp);
      for (int l = 0; l < Lp; ++l) gb += col[l * ld];
    }
    float* dxg = B.dx + n * L * D;
    for (int slot = t; slot < s_ld4; slot += kGroupThreads) {
      int tm, tn;
      if (!tile_at(slot, lt, dt, tm, tn)) continue;
      float acc[4][4] = {};
      tile_fma<false, !kResident, 4>(cs, ld, wkx, ldw, tm, tn, lt, dt, Dp, acc);
      tile_fma<false, !kResident, 4>(vs, ld, wvx, ldw, tm, tn, lt, dt, Dp, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = tm + r * lt;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = tile_index<!kResident, 4>(tn, j, dt);
          if (l < L && i < D) dxg[l * D + i] = acc[r][j];
        }
      }
    }
    group_sync(g);  // the next sample overwrites x, dk and dv
  }

  // the slice, written once
  float* out = B.partials + (int64_t)s * grad_floats(L, D);
  float* owk = out;
  float* obk = owk + D * D;
  float* owv = obk + D;
  float* obv = owv + D * D;
  float* oq = obv + D;
#pragma unroll
  for (int i = 0; i < kWT; ++i) {
    const int w = t + i * kGroupThreads;
    const bool is_v = w >= s_w;
    int tm, tn;
    if (w >= 2 * s_w || !tile_at(is_v ? w - s_w : w, dt, dw, tm, tn)) continue;
    float* o = is_v ? owv : owk;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kTw; ++j) {
        const int row = 4 * tm + r, c = kTw * tn + j;
        if (row < D && c < D) o[row * D + c] = gw[i][r][j];
      }
  }
  if (kDqShared) {
    for (int e = t; e < L * D; e += kGroupThreads) oq[e] = qsum[(e / D) * Dp + e % D];
  } else {
#pragma unroll
    for (int i = 0; i < (kDqShared ? 1 : kQT); ++i) {
      int tm, tn;
      if (!tile_at(t + i * kGroupThreads, lt, dw, tm, tn)) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < kTw; ++j) {
          const int l = tm + r * lt, c = kTw * tn + j;
          if (l < L && c < D) oq[l * D + c] = gq[i][r][j];
        }
    }
  }
  if (t < 2 * Dp) {
    const int c = t < Dp ? t : t - Dp;
    if (c < D) (t < Dp ? obk : obv)[c] = gb;
  }
}

// out: Wk, Wv, Wk^T, Wv^T, each [Dp][Dp] with zeros past D; a 32 x 32 tile a
// block, read and written along rows.
__global__ void pad_weights_kernel(const float* __restrict__ wk, const float* __restrict__ wv,
                                   int D, int Dp, float* __restrict__ out) {
  __shared__ float tile[32][33];
  const float* w = blockIdx.z ? wv : wk;
  float* wp = out + (size_t)blockIdx.z * Dp * Dp;
  float* wt = out + (size_t)(2 + blockIdx.z) * Dp * Dp;
  const int r = blockIdx.y * 32 + threadIdx.y, c = blockIdx.x * 32 + threadIdx.x;
  const float v = r < D && c < D ? w[r * D + c] : 0.0f;
  if (r < Dp && c < Dp) wp[r * Dp + c] = v;
  tile[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  const int tr = blockIdx.x * 32 + threadIdx.y, tc = blockIdx.y * 32 + threadIdx.x;
  if (tr < Dp && tc < Dp) wt[tr * Dp + tc] = tile[threadIdx.x][threadIdx.y];
}

bool shape_ok(long long n, int L, int D) {
  return n > 0 && n <= 0x7fffffffLL && L > 0 && L <= kMaxL && D > 0 && D <= kMaxD;
}

// The current device's SM count (kept a device), 0 where CUDA fails.
int sm_count() {
  static int counts[rp::kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= rp::kMaxDevices) return 0;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    counts[device] = 0;
  return counts[device];
}

// The forward's launch at one shape: the variant, the groups a block (as
// many as the shared memory holds, at most kFwdGroups), the blocks (at most
// one an SM) and their shared memory.
struct FwdPlan {
  bool ok, resident;
  int Lp, Dp, ld, groups, blocks;
  size_t smem;
  int64_t wpad_words;  // the streamed variant's padded weights (pad_weights_kernel)
};

FwdPlan fwd_plan(long long n, int L, int D, int variant, int sms) {
  FwdPlan f{};
  f.Lp = round4(L);
  f.Dp = round8(D);
  f.ld = odd4(f.Dp);
  const int64_t cap = kMaxSmem / sizeof(float), q = (int64_t)f.Lp * f.ld,
                w = (int64_t)2 * f.Dp * f.ld, gf = fwd_group_floats(f.Lp, f.ld);
  const int64_t resident_groups = q + w < cap ? (cap - q - w) / gf : 0;
  const int64_t streamed_groups = q < cap ? (cap - q) / gf : 0;
  f.resident = variant == kAuto ? resident_groups > 0 : variant == kResident;
  const int64_t groups = f.resident ? resident_groups : streamed_groups;
  f.groups = (int)(groups < kFwdGroups ? groups : kFwdGroups);
  f.ok = shape_ok(n, L, D) && sms > 0 && f.groups > 0 &&
         (variant == kAuto || variant == kStreamed || variant == kResident);
  if (!f.ok) return f;
  f.smem = sizeof(float) * (q + (f.resident ? w : 0) + f.groups * gf);
  const long long blocks = (n + f.groups - 1) / f.groups;
  f.blocks = (int)(blocks < sms ? blocks : sms);
  f.wpad_words = f.resident ? 0 : (int64_t)4 * f.Dp * f.Dp;
  return f;
}

template <int kGT, bool kResident>
cudaError_t launch_fwd(const FwdParams& F, const FwdPlan& plan, cudaStream_t st) {
  static size_t opted[rp::kMaxDevices] = {};
  const void* fn = (const void*)global_attn_fwd_kernel<kGT, kResident>;
  cudaError_t err = rp::opt_in(fn, plan.smem, opted);
  if (err != cudaSuccess) return err;
  global_attn_fwd_kernel<kGT, kResident>
      <<<(unsigned)plan.blocks, plan.groups * kGT, plan.smem, st>>>(F);
  return cudaGetLastError();
}

// The backward's launch at one shape: the variant, its shared memory, slices
// and blocks.
struct BwdPlan {
  bool ok, resident;
  int Lp, Dp, ld, slices, blocks;
  size_t smem;
  int64_t wpad_words;  // the streamed variant's padded weights, at the workspace's start
};

BwdPlan bwd_plan(long long n, int L, int D, int variant) {
  BwdPlan b{};
  b.Lp = round4(L);
  b.Dp = round8(D);
  b.ld = odd4(b.Dp);
  const size_t q = (size_t)b.Lp * b.ld;
  const size_t resident_bytes =
      sizeof(float) * (q + (size_t)2 * b.Dp * b.ld + 2 * sample_floats(b.Lp, b.Dp, b.ld, true));
  const bool fits = b.Dp <= 64 && resident_bytes <= kMaxSmem;
  b.resident = variant == kAuto ? fits : variant == kResident;
  b.ok = shape_ok(n, L, D) && (variant == kAuto || variant == kStreamed || fits);
  b.smem = b.resident ? resident_bytes
                      : sizeof(float) * (q + sample_floats(b.Lp, b.Dp, b.ld, false));
  b.slices = (int)(n < kSlices ? n : kSlices);
  b.blocks = b.resident ? (b.slices + 1) / 2 : b.slices;
  b.wpad_words = b.resident ? 0 : (int64_t)4 * b.Dp * b.Dp;
  return b;
}

template <int kGroups, bool kResident, int kWT, int kQT>
cudaError_t launch_bwd(const BwdParams& B, const BwdPlan& plan, cudaStream_t st) {
  static size_t opted[rp::kMaxDevices] = {};
  const void* fn = (const void*)global_attn_bwd_kernel<kGroups, kResident, kWT, kQT>;
  cudaError_t err = rp::opt_in(fn, plan.smem, opted);
  if (err != cudaSuccess) return err;
  global_attn_bwd_kernel<kGroups, kResident, kWT, kQT>
      <<<(unsigned)plan.blocks, kGroups * kGroupThreads, plan.smem, st>>>(B);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* wk, const void* bk, const void* wv,
                   const void* bv, const void* q, int L, int D, unsigned seed, unsigned stream,
                   unsigned threshold, float scale, int drop_on, unsigned first) {
  Params P;
  P.x = static_cast<const float*>(x);
  P.wk = static_cast<const float*>(wk);
  P.bk = static_cast<const float*>(bk);
  P.wv = static_cast<const float*>(wv);
  P.bv = static_cast<const float*>(bv);
  P.q = static_cast<const float*>(q);
  P.L = L;
  P.D = D;
  P.drop = Dropout{seed, stream, threshold, scale, drop_on, first};
  return P;
}

}  // namespace

// 4-byte words of workspace rp_global_attn_fwd_f32 needs for `variant` on
// the current device: the streamed variant's padded weights, 0 for the
// resident one; -1 for a shape or variant it does not take.
extern "C" long long rp_global_attn_fwd_workspace_words(long long n, int L, int D, int variant) {
  const FwdPlan plan = fwd_plan(n, L, D, variant, sm_count());
  return plan.ok ? plan.wpad_words : -1;
}

// The forward's groups on the current device for n samples of L x D (the
// variant picked from the shape): group j of them takes samples
// [j n / G, (j + 1) n / G).  0 for a shape it does not take.
extern "C" long long rp_global_attn_fwd_groups(long long n, int L, int D) {
  const FwdPlan plan = fwd_plan(n, L, D, kAuto, sm_count());
  return plan.ok ? (long long)plan.blocks * plan.groups : 0;
}

// x [n, L, D], wk and wv [D, D] (flax [in, out]), bk and bv [D], q [L, D],
// y [n, L, D], all float32, contiguous, on the current device.  Dropout: a
// kept element is scaled by `scale`; drop_on = 0 keeps every element.
// variant: -1 picks from the shape's shared memory, 1 keeps the weights in
// shared memory (where they fit), 0 streams them.  workspace: at least
// rp_global_attn_fwd_workspace_words 4-byte words.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int rp_global_attn_fwd_f32(const void* x, const void* wk, const void* bk,
                                      const void* wv, const void* bv, const void* q, void* y,
                                      void* workspace, long long workspace_words, long long n,
                                      int L, int D, unsigned seed, unsigned stream,
                                      unsigned threshold, float scale, int drop_on,
                                      unsigned first, int variant, void* stream_ptr) {
  const FwdPlan plan = fwd_plan(n, L, D, variant, sm_count());
  if (!plan.ok || workspace_words < plan.wpad_words) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  FwdParams F;
  F.p = make_params(x, wk, bk, wv, bv, q, L, D, seed, stream, threshold, scale, drop_on,
                    first);
  F.y = static_cast<float*>(y);
  F.wpad = static_cast<const float*>(workspace);
  F.n = n;
  F.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  F.Lp = plan.Lp;
  F.Dp = plan.Dp;
  F.ld = plan.ld;
  if (plan.resident) return (int)launch_fwd<kFwdGroupThreads, true>(F, plan, st);
  const unsigned tiles = (unsigned)(plan.Dp + 31) / 32;
  pad_weights_kernel<<<dim3(tiles, tiles, 2), dim3(32, 32), 0, st>>>(
      F.p.wk, F.p.wv, D, plan.Dp, static_cast<float*>(workspace));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd<kFwdGroupThreads, false>(F, plan, st);
}

// 4-byte words of workspace rp_global_attn_bwd_f32 needs for `variant`: the
// streamed variant's padded weights, then the slices' gradients.  0 for a
// shape or variant it does not take.
extern "C" long long rp_global_attn_bwd_workspace_words(long long n, int L, int D, int variant) {
  const BwdPlan plan = bwd_plan(n, L, D, variant);
  if (!plan.ok) return 0;
  return plan.wpad_words + (long long)plan.slices * grad_floats(L, D);
}

// The backward: the forward's inputs and dropout arguments, dy [n, L, D];
// writes dx [n, L, D] and, to grads, dWk [D, D], dbk [D], dWv [D, D], dbv [D]
// and dQ [L, D] concatenated in this order.  variant: -1 picks from the
// shape's shared memory, 1 keeps the weights in shared memory (where they
// fit), 0 streams them.  workspace: at least rp_global_attn_bwd_workspace_words
// 4-byte words.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int rp_global_attn_bwd_f32(const void* x, const void* wk, const void* bk,
                                      const void* wv, const void* bv, const void* q,
                                      const void* dy, void* dx, void* grads, void* workspace,
                                      long long workspace_words, long long n, int L, int D,
                                      unsigned seed, unsigned stream, unsigned threshold,
                                      float scale, int drop_on, unsigned first, int variant,
                                      void* stream_ptr) {
  const BwdPlan plan = bwd_plan(n, L, D, variant);
  if (!plan.ok || workspace_words < rp_global_attn_bwd_workspace_words(n, L, D, variant))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  BwdParams B;
  B.p = make_params(x, wk, bk, wv, bv, q, L, D, seed, stream, threshold, scale, drop_on,
                    first);
  B.dy = static_cast<const float*>(dy);
  B.dx = static_cast<float*>(dx);
  B.wpad = static_cast<const float*>(workspace);
  B.partials = static_cast<float*>(workspace) + plan.wpad_words;
  B.n = n;
  B.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  B.slices = plan.slices;
  B.Lp = plan.Lp;
  B.Dp = plan.Dp;
  B.ld = plan.ld;
  cudaError_t err;
  if (plan.resident) {
    err = launch_bwd<2, true, 8 / kTw, 0>(B, plan, st);
  } else {
    const unsigned tiles = (unsigned)(plan.Dp + 31) / 32;
    pad_weights_kernel<<<dim3(tiles, tiles, 2), dim3(32, 32), 0, st>>>(
        B.p.wk, B.p.wv, D, plan.Dp, static_cast<float*>(workspace));
    err = cudaGetLastError();
    if (err == cudaSuccess) err = launch_bwd<1, false, 32 / kTw, 8 / kTw>(B, plan, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)rp::sum_slices(B.partials, plan.slices, grad_floats(L, D), static_cast<float*>(grads),
                             st);
}
