// ArrayFlex K-collapse GEMM for Hopper (sm_90a), with the fused
// prologue/epilogue of the reference kernel, plus its expert-batched form,
// each on float weights and on int8 weight codes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/arrayflex_gemm.py:
//   af_gemm           <- _kernel, fp32/bf16 operands
//   af_gemm_q         <- _kernel, int8 weights: W8 (quant) and W8A8
//                        (quant + act_quant)
//   af_expert_gemm    <- _expert_kernel, fp32/bf16 operands
//   af_expert_gemm_q  <- _expert_kernel, int8 weights: the int8-only form
//                        of the MoE expert banks (quant) and W8A8
//                        (quant + act_quant)
// (launched by arrayflex_gemm / arrayflex_expert_gemm).
//
// What it computes:
//   af_gemm:  out = [r +] act((g*X)@W [+ b]) [* ((g*X)@W2 [+ b2])]
//             X[M,K], W/W2[K,N]; the rmsnorm scale g multiplies each staged
//             x element in fp32 and rounds back to the operand type before
//             the product (the reference's prologue_phase), the epilogue
//             runs once at the store in store_phase order: dequant -> bias
//             -> act -> gate multiply -> residual -> one cast.
//   W8:       W/W2 hold int8 codes, converted exactly to fp32 for the FFMA
//             chain; the per-column scales s/s2 multiply the accumulators
//             at the store (exact: a column scale factors out of the K sum).
//   W8A8:     each x tile of the reference's tiling -- quant_bm rows by one
//             main-loop step of quant_kk columns -- is quantized with one
//             fp32 scale (quantize_tile: amax * fp32(1/127), round half
//             to even, clip +-127) after the prologue, the chain runs int8 x int8 ->
//             int32 (__dp4a), and each step's int32 partial folds into the
//             fp32 accumulator as acc + float(iacc) * scale, in increasing
//             step order.
//   expert:   X[E,T,K] @ W[E,K,N] -> [E,T,N], blockIdx.z walks E, the same
//             main loop, only the dequant at the store.  On int8 codes
//             without act_quant (an MoE expert bank under W8) it is the
//             W8 chain: the codes widen exactly to fp32 for the FFMA chain
//             and each expert's per-column scale multiplies once, at the
//             store.
//
// What bounds it on this card: at decode (M = batch rows, a handful) every
// weight byte is read once for a few rows of work, so the GEMM is bound by
// streaming the weights from HBM (3.35 TB/s on an H100 SXM), and int8
// codes halve those bytes against bf16; at a large prefill chunk the same
// GEMM is bound by operations.  This version does neither optimally: it is
// a plain kernel (FFMA, or __dp4a for W8A8) that is right first.
//
// What the design does about it:
//   * one (BM x 64) output tile per block, 256 threads; BM = 64 (4 x 4
//     outputs a thread) for large M and BM = 16 (1 x 4 outputs a thread)
//     for decode-sized M, so a 4-row decode GEMM wastes 4x rather than 16x
//     of its work on masked rows;
//   * float forms: K is consumed in ceil(K / (BK * k_collapse)) main-loop
//     iterations; each stages k_collapse BK-wide sub-tiles of X (and W, W2)
//     in shared memory, widened to fp32 on load, and runs k_collapse
//     sub-dots into the fp32 register accumulator(s).  k_collapse is the
//     planner's collapse depth and stays a launch parameter; BK = 32 is the
//     kernel's own (a TPU-sized (128, 512) fp32 panel does not fit in 227 KB
//     of shared memory).  Every thread adds the K terms of its outputs in
//     increasing K order, so the result does not depend on k_collapse;
//   * W8A8: the quantization tile is the reference's, not the block's (a
//     64-row block of a 1024-row prefill sees half of a 128-row tile, and
//     the reference step is up to 16 of this kernel's sub-steps), so each
//     block first reduces the amax of the whole reference tile from global
//     memory, then stages its own rows as packed int8 codes BKQ columns at
//     a time.  Every block of a tile computes the same scale, so no second
//     launch or cross-block exchange is needed.  Rounding follows the
//     reference's compiled kernel op for op: the scale as amax times the
//     constant fp32(1/127) (XLA folds the division by 127 into that
//     multiply), an IEEE division of x by it (__fdiv_rn), rintf (half to
//     even), an exact int32 partial (<= 512 * 127^2 < 2^24, so it also
//     converts to float exactly), and a fold written __fmul_rn / __fadd_rn
//     so nvcc cannot contract it into an FMA;
//   * ragged M/N/K edges are masked on load (zeros) and on store; nothing
//     is padded in device memory;
//   * wgmma, TMA, cp.async pipelining and vector loads are left for later
//     work: this kernel reads each element with a scalar load.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int BKQ = 64;          // W8A8: K columns staged per sub-step ...
constexpr int KQ = BKQ / 4;      // ... as 4 int8 codes per 32-bit word
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB: the most a block may use

enum Dtype { F32 = 0, BF16 = 1 };
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_SILU) return y / (1.0f + expf(-y));
  if (act == ACT_GELU) {  // tanh approximation, jax.nn.gelu's default
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  return y;
}

struct Args {
  const void* x;
  const void* w;
  const void* w2;
  const float* w_scale;                   // int8 forms: per-column scales
  const float* w2_scale;
  const float* bias;
  const float* bias2;
  const void* residual;
  const float* g;
  void* out;
  int M, N, K;
  long long ldx, ldw, ldr, ldo;           // row strides (elements)
  long long bsx, bsw, bso, bss;           // batch strides (elements)
  int k_collapse;
  int activation;
  int quant_bm, quant_kk;                 // W8A8: the reference's x tile
};

// x element (r, c) of one batch element after the step prologue: the
// rmsnorm scale in fp32, rounded back to x's type (prologue_phase).
template <typename TX>
__device__ __forceinline__ float x_at(const Args& a, const TX* x, int r,
                                      int c) {
  float v = to_f(x[(long long)r * a.ldx + c]);
  if (a.g != nullptr) v = to_f(from_f<TX>(v * a.g[c]));
  return v;
}

// Carry-propagate store of one thread's TM x 4 outputs at rows r0.., columns
// c0..: the epilogue once, in store_phase order.  The multiplies are
// __fmul_rn so that nvcc does not fuse one with the add after it: each
// rounds on its own, as in the plain version.
template <typename TX, typename TO, int TM, bool DUAL>
__device__ __forceinline__ void store_tile(const Args& a,
                                           float (&acc)[TM][4],
                                           float (&acc2)[TM][4],
                                           int r0, int c0) {
  const TX* res = static_cast<const TX*>(a.residual);
  TO* out = static_cast<TO*>(a.out) + blockIdx.z * a.bso;
  const float* ws = a.w_scale ? a.w_scale + blockIdx.z * a.bss : nullptr;
  const float* ws2 = a.w2_scale ? a.w2_scale + blockIdx.z * a.bss : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + i;
    if (r >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= a.N) continue;
      float y = acc[i][j];
      if (ws != nullptr) y = __fmul_rn(y, ws[c]);
      if (a.bias != nullptr) y = __fadd_rn(y, a.bias[c]);
      float o = activate(y, a.activation);
      if (DUAL) {
        float y2 = acc2[i][j];
        if (ws2 != nullptr) y2 = __fmul_rn(y2, ws2[c]);
        if (a.bias2 != nullptr) y2 = __fadd_rn(y2, a.bias2[c]);
        o = __fmul_rn(o, y2);
      }
      if (res != nullptr) o = __fadd_rn(to_f(res[(long long)r * a.ldr + c]), o);
      out[(long long)r * a.ldo + c] = from_f<TO>(o);
    }
  }
}

// One (BM x BN) output tile of batch element blockIdx.z, float chain.  TX: x
// (and residual) type, TW: w/w2 type (float, bf16 or int8 codes), TO:
// output type.
template <typename TX, typename TW, typename TO, int BM, bool DUAL>
__global__ void __launch_bounds__(THREADS)
af_gemm_kernel(Args a) {
  constexpr int TM = BM / 16;           // rows per thread
  extern __shared__ float smem[];
  const int kk = BK * a.k_collapse;     // K width of one main-loop step
  const int lda = kk + 1;               // padded: rows land on other banks
  float* As = smem;                     // [BM][kk + 1]
  float* Bs = As + BM * lda;            // [kk][BN]
  float* Bs2 = Bs + kk * BN;            // [kk][BN] (dual only)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, K = a.K;
  const TX* x = static_cast<const TX*>(a.x) + blockIdx.z * a.bsx;
  const TW* w = static_cast<const TW*>(a.w) + blockIdx.z * a.bsw;
  const TW* w2 = DUAL ? static_cast<const TW*>(a.w2) : nullptr;

  float acc[TM][4];
  float acc2[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      acc2[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < K; k0 += kk) {
    // stage the x tile, with the rmsnorm scale as its prologue
    for (int idx = tid; idx < BM * kk; idx += THREADS) {
      const int r = idx / kk, c = idx - r * kk;
      const int gr = m0 + r, gc = k0 + c;
      As[r * lda + c] = (gr < M && gc < K) ? x_at(a, x, gr, gc) : 0.f;
    }
    // stage the w (and w2) panel
    for (int idx = tid; idx < kk * BN; idx += THREADS) {
      const int c = idx / BN, n = idx - c * BN;
      const int gk = k0 + c, gn = n0 + n;
      const bool ok = gk < K && gn < N;
      const long long off = (long long)gk * a.ldw + gn;
      Bs[idx] = ok ? to_f(w[off]) : 0.f;
      if (DUAL) Bs2[idx] = ok ? to_f(w2[off]) : 0.f;
    }
    __syncthreads();
    // the k-deep chain: k_collapse sub-dots of width BK into the same
    // fp32 accumulator(s)
    for (int s = 0; s < a.k_collapse; ++s) {
#pragma unroll 8
      for (int kb = 0; kb < BK; ++kb) {
        const int k = s * BK + kb;
        float xa[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) xa[i] = As[(ty * TM + i) * lda + k];
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k * BN + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(xa[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(xa[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(xa[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(xa[i], b.w, acc[i][3]);
        }
        if (DUAL) {
          const float4 b2 =
              *reinterpret_cast<const float4*>(&Bs2[k * BN + tx * 4]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc2[i][0] = fmaf(xa[i], b2.x, acc2[i][0]);
            acc2[i][1] = fmaf(xa[i], b2.y, acc2[i][1]);
            acc2[i][2] = fmaf(xa[i], b2.z, acc2[i][2]);
            acc2[i][3] = fmaf(xa[i], b2.w, acc2[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }
  store_tile<TX, TO, TM, DUAL>(a, acc, acc2, m0 + ty * TM, n0 + tx * 4);
}

// quantize_tile's element rule: round(v / scale) half to even, clip +-127.
__device__ __forceinline__ int quant_code(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ int pack4(const int (&b)[4]) {
  return (int)((unsigned)(b[0] & 0xff) | ((unsigned)(b[1] & 0xff) << 8) |
               ((unsigned)(b[2] & 0xff) << 16) |
               ((unsigned)(b[3] & 0xff) << 24));
}

// The largest value over the block (every thread must call it).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, red[i]);
  __syncthreads();                      // red is written again next step
  return m;
}

// One (BM x BN) output tile of batch element blockIdx.z, W8A8 chain: x
// quantized per reference tile, int8 codes w (and w2).
template <typename TX, typename TO, int BM, bool DUAL>
__global__ void __launch_bounds__(THREADS)
af_gemm_w8a8_kernel(Args a) {
  constexpr int TM = BM / 16;
  constexpr int LDA = KQ + 1;           // padded: rows land on other banks
  __shared__ int As[BM * LDA];          // packed x codes [BM][KQ]
  __shared__ __align__(16) int Bs[KQ * BN];            // packed w codes
  __shared__ __align__(16) int Bs2[DUAL ? KQ * BN : 4];
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, K = a.K;
  const TX* x = static_cast<const TX*>(a.x) + blockIdx.z * a.bsx;
  const int8_t* w = static_cast<const int8_t*>(a.w) + blockIdx.z * a.bsw;
  const int8_t* w2 = DUAL ? static_cast<const int8_t*>(a.w2) : nullptr;
  // rows of the reference quantization tile that holds this block's rows
  // (quant_bm is M itself or a multiple of BM, so it holds all of them)
  const int t0 = (m0 / a.quant_bm) * a.quant_bm;
  const int t1 = min(t0 + a.quant_bm, M);

  float acc[TM][4];
  float acc2[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      acc2[i][j] = 0.f;
    }

  for (int c0 = 0; c0 < K; c0 += a.quant_kk) {   // one reference step
    const int c1 = min(c0 + a.quant_kk, K);
    const int width = c1 - c0;
    // the tile's scale, from the amax over all of its rows
    float m = 0.f;
    const long long n_el = (long long)(t1 - t0) * width;
    for (long long idx = tid; idx < n_el; idx += THREADS) {
      const int r = t0 + (int)(idx / width);
      const int c = c0 + (int)(idx % width);
      m = fmaxf(m, fabsf(x_at(a, x, r, c)));
    }
    // times fp32(1/127), as the reference's compiled quantizer computes it
    const float scale = __fmul_rn(fmaxf(block_max(m, red), 1e-12f),
                                  1.0f / 127.0f);

    int iacc[TM][4];
    int iacc2[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        iacc[i][j] = 0;
        iacc2[i][j] = 0;
      }
    for (int cb = c0; cb < c1; cb += BKQ) {
      // stage this block's x rows as codes, 4 K-consecutive per word
      for (int idx = tid; idx < BM * KQ; idx += THREADS) {
        const int r = idx / KQ, q = idx - r * KQ;
        const int gr = m0 + r;
        int b[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int gc = cb + 4 * q + t;
          b[t] = (gr < M && gc < c1) ? quant_code(x_at(a, x, gr, gc), scale)
                                     : 0;
        }
        As[r * LDA + q] = pack4(b);
      }
      // stage the w (and w2) codes, 4 K-consecutive per word
      for (int idx = tid; idx < KQ * BN; idx += THREADS) {
        const int q = idx / BN, n = idx - q * BN;
        const int gn = n0 + n;
        int b[4], b2[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int gk = cb + 4 * q + t;
          const bool ok = gk < c1 && gn < N;
          const long long off = (long long)gk * a.ldw + gn;
          b[t] = ok ? (int)w[off] : 0;
          b2[t] = (DUAL && ok) ? (int)w2[off] : 0;
        }
        Bs[idx] = pack4(b);
        if (DUAL) Bs2[idx] = pack4(b2);
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < KQ; ++q) {
        int xa[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) xa[i] = As[(ty * TM + i) * LDA + q];
        const int4 bw = *reinterpret_cast<const int4*>(&Bs[q * BN + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          iacc[i][0] = __dp4a(xa[i], bw.x, iacc[i][0]);
          iacc[i][1] = __dp4a(xa[i], bw.y, iacc[i][1]);
          iacc[i][2] = __dp4a(xa[i], bw.z, iacc[i][2]);
          iacc[i][3] = __dp4a(xa[i], bw.w, iacc[i][3]);
        }
        if (DUAL) {
          const int4 bw2 =
              *reinterpret_cast<const int4*>(&Bs2[q * BN + tx * 4]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            iacc2[i][0] = __dp4a(xa[i], bw2.x, iacc2[i][0]);
            iacc2[i][1] = __dp4a(xa[i], bw2.y, iacc2[i][1]);
            iacc2[i][2] = __dp4a(xa[i], bw2.z, iacc2[i][2]);
            iacc2[i][3] = __dp4a(xa[i], bw2.w, iacc2[i][3]);
          }
        }
      }
      __syncthreads();
    }
    // fold this step's exact int32 partial, times its tile scale
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn((float)iacc[i][j], scale));
        if (DUAL)
          acc2[i][j] =
              __fadd_rn(acc2[i][j], __fmul_rn((float)iacc2[i][j], scale));
      }
  }
  store_tile<TX, TO, TM, DUAL>(a, acc, acc2, m0 + ty * TM, n0 + tx * 4);
}

template <typename TX, typename TW, typename TO, int BM, bool DUAL>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int kk = BK * a.k_collapse;
  const size_t smem =
      sizeof(float) * ((size_t)BM * (kk + 1) + (size_t)kk * BN * (DUAL ? 2 : 1));
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      af_gemm_kernel<TX, TW, TO, BM, DUAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  af_gemm_kernel<TX, TW, TO, BM, DUAL><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO, int BM, bool DUAL>
int launch_w8a8(const Args& a, int batch, cudaStream_t stream) {
  // a block's rows must lie in one quantization tile
  if (a.quant_bm < 1 || a.quant_kk < 1 ||
      (a.quant_bm < a.M && a.quant_bm % BM != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  af_gemm_w8a8_kernel<TX, TO, BM, DUAL><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// W8A8 (act_quant) or the float chain, at BM = 16 for decode-sized M.
template <typename TX, typename TW, typename TO, bool DUAL>
int launch_bm(const Args& a, bool act_quant, int batch, cudaStream_t stream) {
  if (act_quant)
    return a.M <= 16 ? launch_w8a8<TX, TO, 16, DUAL>(a, batch, stream)
                     : launch_w8a8<TX, TO, 64, DUAL>(a, batch, stream);
  return a.M <= 16 ? launch<TX, TW, TO, 16, DUAL>(a, batch, stream)
                   : launch<TX, TW, TO, 64, DUAL>(a, batch, stream);
}

template <typename TX, typename TW, bool DUAL>
int launch_out(const Args& a, int out_dtype, bool act_quant, int batch,
               cudaStream_t stream) {
  if (out_dtype == F32)
    return launch_bm<TX, TW, float, DUAL>(a, act_quant, batch, stream);
  if (out_dtype == BF16)
    return launch_bm<TX, TW, __nv_bfloat16, DUAL>(a, act_quant, batch, stream);
  return (int)cudaErrorInvalidValue;
}

// TW = int8_t for the int8 forms; x is fp32 or bf16.
template <typename TW, bool DUAL>
int launch_x(const Args& a, int x_dtype, int out_dtype, bool act_quant,
             int batch, cudaStream_t stream) {
  if (x_dtype == F32)
    return launch_out<float, TW, DUAL>(a, out_dtype, act_quant, batch, stream);
  if (x_dtype == BF16)
    return launch_out<__nv_bfloat16, TW, DUAL>(a, out_dtype, act_quant, batch,
                                                stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// X[M,K] @ W[K,N] (+ W2) with the fused prologue/epilogue.  x/w/w2 and the
// residual share dtype `in_dtype`; bias, bias2 and g are fp32.  A null
// pointer turns its operand off.  Returns cudaGetLastError() of the launch.
extern "C" int af_gemm(int in_dtype, int out_dtype, const void* x,
                       const void* w, const void* w2, const float* bias,
                       const float* bias2, const void* residual,
                       const float* g, void* out, int M, int N, int K,
                       long long ldx, long long ldw, long long ldr,
                       long long ldo, int k_collapse, int activation,
                       void* stream) {
  if (k_collapse < 1 || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, w2, nullptr, nullptr, bias, bias2, residual, g, out, M, N, K,
         ldx, ldw, ldr, ldo, 0, 0, 0, 0, k_collapse, activation, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dual = w2 != nullptr;
  if (in_dtype == F32)
    return dual ? launch_out<float, float, true>(a, out_dtype, false, 1, s)
                : launch_out<float, float, false>(a, out_dtype, false, 1, s);
  if (in_dtype == BF16)
    return dual ? launch_out<__nv_bfloat16, __nv_bfloat16, true>(
                      a, out_dtype, false, 1, s)
                : launch_out<__nv_bfloat16, __nv_bfloat16, false>(
                      a, out_dtype, false, 1, s);
  return (int)cudaErrorInvalidValue;
}

// X[M,K] @ W[K,N] (+ W2) on int8 weight codes w/w2 with fp32 per-column
// scales w_scale/w2_scale (required), the same prologue/epilogue as
// af_gemm; x and the residual have dtype `x_dtype`.  act_quant = 0: W8, the
// float chain at k_collapse; act_quant = 1: W8A8 on the reference's x
// tiles of quant_bm rows (M itself, or a multiple of 64) by quant_kk
// columns (k_collapse is then only part of how quant_kk was chosen).
extern "C" int af_gemm_q(int x_dtype, int out_dtype, int act_quant,
                         const void* x, const void* w, const void* w2,
                         const float* w_scale, const float* w2_scale,
                         const float* bias, const float* bias2,
                         const void* residual, const float* g, void* out,
                         int M, int N, int K, long long ldx, long long ldw,
                         long long ldr, long long ldo, int k_collapse,
                         int activation, int quant_bm, int quant_kk,
                         void* stream) {
  const bool dual = w2 != nullptr;
  if (k_collapse < 1 || M < 1 || N < 1 || K < 1 || w_scale == nullptr ||
      (dual && w2_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x, w, w2, w_scale, w2_scale, bias, bias2, residual, g, out, M, N,
         K, ldx, ldw, ldr, ldo, 0, 0, 0, 0, k_collapse, activation, quant_bm,
         quant_kk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dual ? launch_x<int8_t, true>(a, x_dtype, out_dtype, act_quant != 0,
                                       1, s)
              : launch_x<int8_t, false>(a, x_dtype, out_dtype,
                                        act_quant != 0, 1, s);
}

// X[E,T,K] @ W[E,K,N] -> out[E,T,N], all contiguous; x and w may differ in
// dtype only as (fp32, bf16), the fp32-query x bf16-cache attention product.
extern "C" int af_expert_gemm(int x_dtype, int w_dtype, int out_dtype,
                              const void* x, const void* w, void* out, int E,
                              int T, int K, int N, int k_collapse,
                              void* stream) {
  if (k_collapse < 1 || E < 1 || T < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         out, T, N, K, K, N, 0, N, (long long)T * K, (long long)K * N,
         (long long)T * N, 0, k_collapse, ACT_NONE, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == F32 && w_dtype == F32)
    return launch_out<float, float, false>(a, out_dtype, false, E, s);
  if (x_dtype == BF16 && w_dtype == BF16)
    return launch_out<__nv_bfloat16, __nv_bfloat16, false>(a, out_dtype,
                                                           false, E, s);
  if (x_dtype == F32 && w_dtype == BF16)
    return launch_out<float, __nv_bfloat16, false>(a, out_dtype, false, E, s);
  return (int)cudaErrorInvalidValue;
}

// X[E,T,K] @ W[E,K,N] -> out[E,T,N] on int8 codes, all contiguous: x fp32
// or bf16, w int8 codes, w_scale (E, N) fp32 dequantized per (expert,
// column) at the store.  act_quant = 0: the int8-only form (MoE expert
// banks under W8), the float chain at k_collapse; act_quant = 1: W8A8,
// each expert's x quantized on the reference's tiles of quant_bm rows by
// quant_kk columns.
extern "C" int af_expert_gemm_q(int x_dtype, int out_dtype, int act_quant,
                                const void* x, const void* w,
                                const float* w_scale, void* out, int E, int T,
                                int K, int N, int k_collapse, int quant_bm,
                                int quant_kk, void* stream) {
  if (k_collapse < 1 || E < 1 || T < 1 || N < 1 || K < 1 ||
      w_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, w_scale, nullptr, nullptr, nullptr, nullptr, nullptr,
         out, T, N, K, K, N, 0, N, (long long)T * K, (long long)K * N,
         (long long)T * N, N, k_collapse, ACT_NONE, quant_bm, quant_kk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_x<int8_t, false>(a, x_dtype, out_dtype, act_quant != 0, E, s);
}
