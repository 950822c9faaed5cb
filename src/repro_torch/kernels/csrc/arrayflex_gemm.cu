// ArrayFlex K-collapse GEMM for Hopper (sm_90a), with the fused
// prologue/epilogue of the reference kernel, plus its expert-batched form.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/arrayflex_gemm.py:
//   af_gemm         <- _kernel         (launched by arrayflex_gemm)
//   af_expert_gemm  <- _expert_kernel  (launched by arrayflex_expert_gemm)
//
// What it computes:
//   af_gemm:  out = [r +] act((g*X)@W [+ b]) [* ((g*X)@W2 [+ b2])]
//             X[M,K], W/W2[K,N]; the rmsnorm scale g multiplies each staged
//             x element in fp32 and rounds back to the operand type before
//             the product (the reference's prologue_phase), the epilogue
//             runs once at the store in store_phase order: bias -> act ->
//             gate multiply -> residual -> one cast.
//   af_expert_gemm: X[E,T,K] @ W[E,K,N] -> [E,T,N], blockIdx.z walks E,
//             the same main loop, no epilogue.
//
// What bounds it on this card: at decode (M = batch rows, a handful) every
// weight byte is read once for a few rows of work, so the GEMM is bound by
// streaming the weights from HBM (3.35 TB/s on an H100 SXM); at a large
// prefill chunk the same GEMM is bound by operations.  This first version
// does neither optimally: it is a plain FFMA kernel that is right first.
//
// What the design does about it:
//   * one (BM x 64) output tile per block, 256 threads; BM = 64 (4 x 4
//     outputs a thread) for large M and BM = 16 (1 x 4 outputs a thread)
//     for decode-sized M, so a 4-row decode GEMM wastes 4x rather than 16x
//     of its FFMA work on masked rows;
//   * K is consumed in ceil(K / (BK * k_collapse)) main-loop iterations;
//     each iteration stages k_collapse BK-wide sub-tiles of X (and W, W2)
//     in shared memory, widened to fp32 on load, and runs k_collapse
//     sub-dots into the fp32 register accumulator(s).  k_collapse is the
//     planner's collapse depth and stays a launch parameter; BK = 32 is the
//     kernel's own (a TPU-sized (128, 512) fp32 panel does not fit in 227 KB
//     of shared memory).  Every thread adds the K terms of its outputs in
//     increasing K order, so the result does not depend on k_collapse;
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
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB: the most a block may use

enum Dtype { F32 = 0, BF16 = 1 };
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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
  const float* bias;
  const float* bias2;
  const void* residual;
  const float* g;
  void* out;
  int M, N, K;
  long long ldx, ldw, ldr, ldo;           // row strides (elements)
  long long bsx, bsw, bso;                // batch strides (elements)
  int k_collapse;
  int activation;
};

// One (BM x BN) output tile of batch element blockIdx.z.  TX: x (and
// residual) type, TW: w/w2 type, TO: output type.
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
  TO* out = static_cast<TO*>(a.out) + blockIdx.z * a.bso;

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
      float v = 0.f;
      if (gr < M && gc < K) {
        v = to_f(x[(long long)gr * a.ldx + gc]);
        if (a.g != nullptr) v = to_f(from_f<TX>(v * a.g[gc]));
      }
      As[r * lda + c] = v;
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

  // carry-propagate store: the epilogue once, in store_phase order
  const TX* res = static_cast<const TX*>(a.residual);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      float y = acc[i][j];
      if (a.bias != nullptr) y += a.bias[c];
      float o = activate(y, a.activation);
      if (DUAL) {
        float y2 = acc2[i][j];
        if (a.bias2 != nullptr) y2 += a.bias2[c];
        o = o * y2;
      }
      if (res != nullptr) o = to_f(res[(long long)r * a.ldr + c]) + o;
      out[(long long)r * a.ldo + c] = from_f<TO>(o);
    }
  }
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

template <typename TX, typename TW, typename TO, bool DUAL>
int launch_bm(const Args& a, int batch, cudaStream_t stream) {
  if (a.M <= 16) return launch<TX, TW, TO, 16, DUAL>(a, batch, stream);
  return launch<TX, TW, TO, 64, DUAL>(a, batch, stream);
}

template <typename TX, typename TW, bool DUAL>
int launch_out(const Args& a, int out_dtype, int batch, cudaStream_t stream) {
  if (out_dtype == F32) return launch_bm<TX, TW, float, DUAL>(a, batch, stream);
  if (out_dtype == BF16)
    return launch_bm<TX, TW, __nv_bfloat16, DUAL>(a, batch, stream);
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
  Args a{x, w, w2, bias, bias2, residual, g, out, M, N, K, ldx, ldw, ldr,
         ldo, 0, 0, 0, k_collapse, activation};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dual = w2 != nullptr;
  if (in_dtype == F32)
    return dual ? launch_out<float, float, true>(a, out_dtype, 1, s)
                : launch_out<float, float, false>(a, out_dtype, 1, s);
  if (in_dtype == BF16)
    return dual ? launch_out<__nv_bfloat16, __nv_bfloat16, true>(a, out_dtype, 1, s)
                : launch_out<__nv_bfloat16, __nv_bfloat16, false>(a, out_dtype, 1, s);
  return (int)cudaErrorInvalidValue;
}

// X[E,T,K] @ W[E,K,N] -> out[E,T,N], all contiguous; x and w may differ in
// dtype only as (fp32, bf16), the fp32-query x bf16-cache attention product.
extern "C" int af_expert_gemm(int x_dtype, int w_dtype, int out_dtype,
                              const void* x, const void* w, void* out, int E,
                              int T, int K, int N, int k_collapse,
                              void* stream) {
  if (k_collapse < 1 || E < 1 || T < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, nullptr, nullptr, nullptr, nullptr, out, T, N, K,
         K, N, 0, N, (long long)T * K, (long long)K * N, (long long)T * N,
         k_collapse, ACT_NONE};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == F32 && w_dtype == F32)
    return launch_out<float, float, false>(a, out_dtype, E, s);
  if (x_dtype == BF16 && w_dtype == BF16)
    return launch_out<__nv_bfloat16, __nv_bfloat16, false>(a, out_dtype, E, s);
  if (x_dtype == F32 && w_dtype == BF16)
    return launch_out<float, __nv_bfloat16, false>(a, out_dtype, E, s);
  return (int)cudaErrorInvalidValue;
}
