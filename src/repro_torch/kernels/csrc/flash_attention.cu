// Flash attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V in
// one kernel, with causal, sliding-window and ragged-tail masks and an
// online softmax over the planner's KV chunks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:27
// (_kernel, launched by flash_attention at :71; reached through
// kernels/ops.py attention).
//
// What it computes, per (bh, query row): for each KV chunk of kv_chunk
// columns, in order,
//     s     = (q . k^T) * scale                     fp32 sums of exact products
//     s     = ok ? s : -1e30                        causal: col <= row; window:
//                                                   col > row - window; col < T
//     m_new = max(m, max over the chunk of s)
//     p     = ok ? exp(s - m_new) : 0
//     corr  = exp(m - m_new)
//     l     = l * corr + sum over the chunk of p    (fp32 p)
//     o     = o * corr + (p rounded to v's dtype) . v   fp32 sums
// and finally out = o / max(l, 1e-30), cast once to q's dtype.  A row with
// every column masked keeps l = 0 and o = 0, so it comes out 0 (not NaN):
// the mask value is the finite -1e30 of the reference, never -inf, so
// -1e30 - -1e30 = 0 and exp of it is 1, then masked to 0.
//
// Numerics, choice (a): the reference takes one softmax over a whole chunk
// (the planner picks kv_chunk = T up to 4096) before it rounds p to bf16,
// so p is rounded relative to the chunk's row max.  A block cannot hold a
// 64 x 4096 fp32 score tile in 227 KB of shared memory, so kv_chunk is a
// launch parameter separate from the kernel's own 64-column sub-tile, and
// each chunk takes two passes over its sub-tiles: the first computes the
// scores only for the chunk's row max, the second recomputes them and
// exponentiates against that max -- the reference's numbers (p, its bf16
// rounding, l and o), up to fp32 summation order and the last bit of expf.
// It costs one more Q K^T product per chunk: 1.5x the operations of a
// single pass.  Against the plain version on the card the bf16 output is
// held to one bf16 step at the largest |value|, fp32 to 1e-5 of it.
//
// What bounds it on this card: operations at long S (at BH 14, S = T =
// 4096, D 64, causal: 3.0e10 multiply-add operations, 30 us at the bf16
// tensor-core peak, while q, k, v and o are 29 MB, 9 us at 3.35 TB/s), bytes
// at short S (BH 56, S = T = 256, D 64: 2.2 us of bytes, 0.9 us of
// operations).
//
// What the design does about it (a plain kernel that is right first):
//   * one block per (bh, 64-row query tile), 256 threads; the q tile stays
//     in shared memory as fp32 for the whole KV loop, so q is read once;
//   * K and V are staged 64 columns at a time through shared memory as fp32
//     (zero-filled past the ragged edge, nothing read past T), and both
//     products run as fp32 FFMA: each thread owns query rows ty + 16 i and
//     key columns tx + 16 j (4 x 4 scores), and output columns tx + 16 jj;
//   * the running m, l and the fp32 output accumulator live in registers;
//     a row's max and sum reduce across the 16 lanes that own it with warp
//     shuffles;
//   * a sub-tile or chunk whose every (row, column) pair is masked for the
//     whole block is skipped (the reference's step leaves o, m and l
//     unchanged there), and the causally heaviest query tiles launch first;
//   * wgmma, TMA, cp.async pipelining and bf16 tensor-core products are left
//     for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // key/value columns per staged sub-tile
constexpr int THREADS = 256;  // 16 x 16: ty owns rows, tx owns columns
constexpr float NEG_INF = -1e30f;
enum { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int BH, S, T, D, kv_chunk, causal, window;
  float scale;
};

template <int DM>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (DM + 1) + (size_t)BKV * (DM + 1) +
                          (size_t)BKV * DM + (size_t)BQ * (BKV + 1));
}

// rows [t0, t0 + BKV) of a (T, D) matrix into dst (fp32, row stride ld);
// rows at or past hi and columns at or past D read as zero
template <typename T, int DM>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int t0, int hi, int D) {
  for (int idx = threadIdx.x; idx < BKV * DM; idx += THREADS) {
    const int c = idx / DM, d = idx % DM, col = t0 + c;
    dst[c * ld + d] =
        (col < hi && d < D) ? to_f(src[(size_t)col * D + d]) : 0.f;
  }
}

// the thread's 4 x 4 unscaled scores: rows ty + 16 i, columns tx + 16 j
template <int DM>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DM; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (DM + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (DM + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
}

__device__ __forceinline__ bool visible(const Args& a, int row, int col,
                                        int hi) {
  return col < hi && (!a.causal || col <= row) &&
         (!a.window || col > row - a.window);
}

template <typename T, int DM>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][DM + 1]
  float* Ks = Qs + BQ * (DM + 1);     // [BKV][DM + 1]
  float* Vs = Ks + BKV * (DM + 1);    // [BKV][DM]
  float* Ps = Vs + BKV * DM;          // [BQ][BKV + 1], p rounded to T
  constexpr int DJ = DM / 16;         // output columns per thread
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // the causally heaviest (last) query tiles launch first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.S * a.D;
  const T* k = static_cast<const T*>(a.k) + bh * a.T * a.D;
  const T* v = static_cast<const T*>(a.v) + bh * a.T * a.D;
  T* o = static_cast<T*>(a.o) + bh * a.S * a.D;

  for (int idx = threadIdx.x; idx < BQ * DM; idx += THREADS) {
    const int r = idx / DM, d = idx % DM, row = row0 + r;
    Qs[r * (DM + 1) + d] =
        (row < a.S && d < a.D) ? to_f(q[(size_t)row * a.D + d]) : 0.f;
  }

  int rows[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = row0 + ty + 16 * i;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // the columns any row of this block may see
  const int row_last = min(row0 + BQ, a.S) - 1;
  const int col_hi = a.causal ? min(a.T, row_last + 1) : a.T;
  const int col_lo = a.window ? max(0, row0 - a.window + 1) : 0;

  for (int c0 = 0; c0 < a.T; c0 += a.kv_chunk) {
    const int lo = max(c0, col_lo);
    const int hi = min(c0 + a.kv_chunk, col_hi);
    if (lo >= hi) continue;   // every pair masked: o, m, l stay as they are

    // pass 1: the chunk's row max
    float cmax[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
    for (int t0 = lo; t0 < hi; t0 += BKV) {
      __syncthreads();
      stage<T, DM>(Ks, DM + 1, k, t0, hi, a.D);
      __syncthreads();
      float s[4][4];
      scores<DM>(Qs, Ks, ty, tx, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sc = visible(a, rows[i], t0 + tx + 16 * j, hi)
                               ? s[i][j] * a.scale
                               : NEG_INF;
          cmax[i] = fmaxf(cmax[i], sc);
        }
    }
    float m_new[4], corr[4], lsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        cmax[i] = fmaxf(cmax[i], __shfl_xor_sync(0xffffffffu, cmax[i], off));
      m_new[i] = fmaxf(m[i], cmax[i]);
      corr[i] = expf(m[i] - m_new[i]);
      lsum[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr[i];
    }

    // pass 2: p against the chunk's max, o += p v
    for (int t0 = lo; t0 < hi; t0 += BKV) {
      __syncthreads();
      stage<T, DM>(Ks, DM + 1, k, t0, hi, a.D);
      stage<T, DM>(Vs, DM, v, t0, hi, a.D);
      __syncthreads();
      float s[4][4];
      scores<DM>(Qs, Ks, ty, tx, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = visible(a, rows[i], t0 + tx + 16 * j, hi)
                              ? expf(s[i][j] * a.scale - m_new[i])
                              : 0.f;
          lsum[i] += p;
          Ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = to_f(from_f<T>(p));
        }
      __syncthreads();
      const int n = min(BKV, hi - t0);
      for (int c = 0; c < n; ++c) {
        float pv[4], vv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[c * DM + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj)
            acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);
      l[i] = l[i] * corr[i] + lsum[i];
      m[i] = m_new[i];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rows[i] >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < a.D) o[(size_t)rows[i] * a.D + d] = from_f<T>(acc[i][jj] / den);
    }
  }
}

template <typename T, int DM>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.S + BQ - 1) / BQ, a.BH);
  flash_fwd_kernel<T, DM><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, stream);
  if (a.D <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// q (BH, S, D), k/v (BH, T, D), o (BH, S, D), all contiguous and of dtype
// `dtype` (0 fp32, 1 bf16); D <= 128; KV consumed in chunks of kv_chunk
// columns (the last one ragged).  causal / window as in the reference
// (window 0 = none).  Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int T, int D, int kv_chunk, int causal,
                                   int window, float scale, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || T < 1 || D < 1 || D > 128 ||
      kv_chunk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, BH, S, T, D, kv_chunk, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return launch_d<float>(a, s);
  if (dtype == BF16) return launch_d<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
