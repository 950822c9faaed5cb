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
// Numerics, choice (a) (bf16): the reference takes one softmax over a
// whole chunk (the planner picks kv_chunk = T up to 4096) before it rounds
// p to bf16, so p is rounded relative to the chunk's row max.  A block
// cannot hold a 64 x 4096 fp32 score tile in 227 KB of shared memory, so
// kv_chunk is a launch parameter separate from the kernel's own 64-column
// sub-tile, and each chunk takes two passes over its sub-tiles: the first
// computes the scores only for the chunk's row max, the second recomputes
// them and exponentiates against that max -- the reference's numbers (p,
// its bf16 rounding, l and o), up to fp32 summation order and the last bit
// of expf.  It costs one more Q K^T product per chunk: 1.5x the operations
// of a single pass.
//
// fp32 needs no second pass.  p is rounded to v's dtype, which for fp32 v
// is no rounding at all, so nothing depends on the max p is taken against:
// exp(s - m_chunk) = exp(s - m_sub) * exp(m_sub - m_chunk) up to fp32
// rounding, and l and o rescale by the same factor.  One pass, with the
// running max rescaled per sub-tile (FlashAttention-2's recurrence),
// computes the same function up to fp32 rounding, with 2/3 of the
// operations; and the chunk edges, which only place the bf16 roundings,
// do not cut its sub-tiles.  Against the plain version on the card the
// bf16 output is held to one bf16 step at the largest |value|, fp32 to
// 1e-5 of it.
//
// What bounds it on this card: operations at long S (at BH 14, S = T =
// 4096, D 64, causal: 3.0e10 multiply-add operations, 30 us at the bf16
// tensor-core peak, while q, k, v and o are 29 MB, 9 us at 3.35 TB/s), bytes
// at short S (BH 56, S = T = 256, D 64: 2.2 us of bytes, 0.9 us of
// operations).  At short S and long T (S 128, T 4097) it is the number of
// query tiles: 2 tiles x 14 heads are 28 blocks for 132 SMs.
//
// Two kernels, chosen by operand type (the wrapper's written rule, counted
// per kernel): bf16 q, k, v launch flash_tc_kernel (entry
// flash_attention_tc), fp32 the FFMA flash_fwd_kernel (entry
// flash_attention_fwd; the tensor cores cannot give IEEE fp32).
//
// flash_tc_kernel, bf16: both products on the tensor cores as
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 (tc.cuh), FlashAttention-2's
// layout.  mma.sync rather than wgmma: the second pass needs each score in
// the registers of the thread that holds its output row (mask, exp, bf16
// rounding, the row sums), which the m16n8 fragments give directly, and
// the per-warp 16-row tiles keep the diagonal and ragged tiles cheap.
//   * one block per (bh, 64-row query tile), 4 warps, one per 16 rows; the
//     q tile is staged once and held as A fragments in registers;
//   * K and V sub-tiles of 64 columns stream through a two-slot ring by
//     16-byte cp.async, each thread's chunk offsets computed once
//     (KvChunks; zero-filled past the ragged edge and past D, padded to
//     the k16/n8 granularity: DM = 32, 64 or 128; nothing read past T;
//     scalar staging when D is not a multiple of 8);
//   * each chunk keeps the two passes of choice (a): pass 1 computes
//     S = Q K^T for the row max only, pass 2 recomputes S with the same
//     fragment sequence (so it never sees a score above pass 1's max),
//     p = ok ? exp(s * scale - m) : 0, rounds p to bf16 in registers and
//     feeds it as the A operand of P V (the m16n8 C fragments of two
//     column tiles are the m16k16 A fragment: S and P never touch shared
//     memory); l sums the fp32 p;
//   * the row max and sums reduce over the 4 lanes of a quad; the causally
//     heaviest query tiles launch first, sub-tiles no row of the block can
//     see are skipped, and a warp whose 16 rows see a whole sub-tile skips
//     the per-element mask (the same numbers);
//   * short S, long T: the wrapper splits each chunk's columns into
//     n_split ranges (kv_splits in flash_attention.py, a pure function of
//     BH, S, T, kv_chunk and the SM count).  A first launch (MODE_MAX)
//     writes each split's row max; a second (MODE_PV) takes the running max
//     up to its chunk from those -- the m_new of the unsplit kernel -- and
//     writes its split's l and unnormalized o against it, so the splits of a
//     chunk add with no rescaling; the combine kernel folds the chunks in
//     order with corr = exp(m - m_new) and divides.  Only the order of the
//     fp32 sums changes.
//
// flash_fwd_kernel, fp32, on the FFMA pipes (the tensor cores cannot give
// IEEE fp32).  At BH 14, S = T = 4096, D 64, causal it is bound by
// operations (3.0e10 at 67 TFLOP/s: 449 us), so the design keeps the FMA
// pipes fed:
//   * one block per (bh, 64-row query tile), 4 warps; the q tile is staged
//     once; 32-row K and V sub-tiles stream through a two-slot ring by
//     16-byte cp.async, each thread's chunk offsets computed once
//     (KvChunks, as the bf16 kernel; a chunk past the last visible column
//     or past D zero-filled by the copy's source size, without a branch;
//     scalar staging only where D is not a multiple of 4): one barrier a
//     sub-tile, the next sub-tile's loads in flight while this one's sums
//     run;
//   * a warp owns 16 query rows outright, a lane 4 of them (lr + 4 i) by 4
//     keys (lc + 8 j) of the scores and by DM / 8 output columns.  Q K^T
//     reads 4 d-steps of a q row or a k row in one float4 (rows padded by
//     4 floats, so the 8 rows a load touches fall on distinct banks): 8
//     loads for 64 FMAs.  K stays row-major, as cp.async copies it; the
//     d-major layout is p's: a warp writes its p tile transposed into its
//     own [key][row] slice of shared memory (a lane's 4 rows as one
//     float4), and P V reads one float4 of p and two of V rows per key: 3
//     loads for 32 FMAs at D 64;
//   * one pass a sub-tile (above): the running max rescaled per sub-tile; a
//     row's max and sum reduce over its 8 lanes with shuffles, and p needs
//     only __syncwarp, never a block barrier; the mask is a warp-uniform
//     branch, taken only by warps whose rows do not see every key of the
//     sub-tile; exp through the ex2 unit (__expf: within 2 ulp where p is
//     near 1, far inside the fp32 tolerance);
//   * 61 KB of shared memory and at most 168 registers at D <= 64, so three
//     blocks (12 warps) share an SM;
//   * blocks launch in index order, so the index runs over the heads
//     fastest and over the query tiles heaviest first: every head's
//     longest causal tiles start in the first wave (with the tiles of one
//     head first, the last head's longest tiles started last and the tail
//     ran a quarter of the time on a few SMs);
//   * as in the bf16 kernel: the -1e30 mask with p = ok ? exp(s - m) : 0 (a
//     fully masked row ends with l = 0, o = 0 and comes out 0), the columns
//     no row of the block can see skipped, out = o / max(l, 1e-30).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BKV = 32;       // fp32: key/value rows per staged sub-tile
constexpr int THREADS = 128;
constexpr int PLD = 16 + 4;   // a warp's p slice: [BKV keys][16 rows + pad]
constexpr float NEG_INF = -1e30f;
enum { F32 = 0 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int BH, S, T, D, kv_chunk, causal, window;
  float scale;
};

// One thread's 16-byte chunks of a ROWS-row K or V sub-tile of T elements
// (DM / (16 / sizeof(T)) chunks a row, rows padded by one chunk), their
// rows, columns and shared offsets computed once; staging a sub-tile at key
// row t0 then costs an address and a bound per chunk.
template <typename T, int DM, int NTHR, int ROWS = 64>
struct KvChunks {
  static constexpr int EPC = 16 / sizeof(T);      // elements a chunk
  static constexpr int LD = DM + EPC;
  static constexpr int N = ROWS * (DM / EPC) / NTHR;
  int r[N], c[N];
  uint32_t off[N];
  __device__ KvChunks() {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * NTHR;
      r[j] = i / (DM / EPC);
      c[j] = (i % (DM / EPC)) * EPC;
      off[j] = sizeof(T) * (r[j] * LD + c[j]);
    }
  }
  // stage() where every chunk is whole or wholly past D (D a multiple of
  // EPC): each chunk one cp.async, zero-filled through its source size
  __device__ __forceinline__ void stage_whole(uint32_t dst, const T* src,
                                              int t0, int hi, int D) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int row = t0 + r[j];
      const bool ok = row < hi && c[j] < D;
      tc::cp_async16_part(dst + off[j],
                          ok ? src + (size_t)row * D + c[j] : src,
                          ok ? 16 : 0);
    }
  }
  // rows t0.. of the (T, D) matrix src into the slot at shared address
  // dst; rows at or past hi and columns at or past D as zeros
  __device__ __forceinline__ void stage(uint32_t dst, const T* src, int t0,
                                        int hi, int D) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int row = t0 + r[j];
      const int n = row < hi ? D - c[j] : 0;
      tc::cp_chunk(dst + off[j],
                   n > 0 ? src + (size_t)row * D + c[j] : src, n, EPC);
    }
  }
};

template <int DM>
constexpr size_t smem_bytes() {   // q tile, two K and two V slots, p slices
  return sizeof(float) * ((size_t)(BQ + 4 * BKV) * (DM + 4) +
                          (size_t)(THREADS / 32) * BKV * PLD);
}

__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return col < a.T && (!a.causal || col <= row) &&
         (!a.window || col > row - a.window);
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <int DM>
__global__ void __launch_bounds__(THREADS, DM <= 64 ? 3 : 2) flash_fwd_kernel(Args a) {
  constexpr int LD = DM + 4;            // padded rows (float4 banks)
  constexpr int NG = DM / 32;           // float4 groups of output columns
  extern __shared__ __align__(16) float fa32_smem[];
  float* Qs = fa32_smem;                // [BQ][LD]
  float* Ks = Qs + BQ * LD;             // [2][BKV][LD]
  float* Vs = Ks + 2 * BKV * LD;        // [2][BKV][LD]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lr = lane / 8, lc = lane % 8;
  // this warp's p slice: [BKV keys][PLD], a lane's 4 rows at lr * 4
  float* Ps = Vs + 2 * BKV * LD + warp * BKV * PLD;
  // blocks launch in index order: the causally heaviest (last) query tiles
  // of every head first, then the next tile of every head, so the longest
  // blocks start in the first wave and short ones fill the tail
  const int n_tiles = (a.S + BQ - 1) / BQ;
  const int row0 = (n_tiles - 1 - (int)(blockIdx.x / a.BH)) * BQ;
  const size_t bh = blockIdx.x % a.BH;
  const int wrow0 = row0 + warp * 16;   // the warp's first query row
  const float* q = static_cast<const float*>(a.q) + bh * a.S * a.D;
  const float* k = static_cast<const float*>(a.k) + bh * a.T * a.D;
  const float* v = static_cast<const float*>(a.v) + bh * a.T * a.D;
  float* out = static_cast<float*>(a.o) + bh * a.S * a.D;
  const bool vec = a.D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;

  // the columns any row of this block may see
  const int row_last = min(row0 + BQ, a.S) - 1;
  const int col_hi = a.causal ? min(a.T, row_last + 1) : a.T;
  const int col_lo = a.window ? max(0, row0 - a.window + 1) : 0;
  const int n_sub = col_lo < col_hi ? (col_hi - col_lo + BKV - 1) / BKV : 0;

  const KvChunks<float, DM, THREADS, BKV> kv;
  const uint32_t ks_addr = tc::smem_addr(Ks), vs_addr = tc::smem_addr(Vs);
  // K and V rows t0.. into ring slot `slot`
  auto stage_kv = [&](int slot, int t0) {
    if (vec) {
      kv.stage_whole(ks_addr + slot * 4 * BKV * LD, k, t0, col_hi, a.D);
      kv.stage_whole(vs_addr + slot * 4 * BKV * LD, v, t0, col_hi, a.D);
    } else {
      tc::stage_tile<BKV, DM, THREADS>(Ks + slot * BKV * LD, LD, k, a.D, t0,
                                       col_hi, 0, a.D, false);
      tc::stage_tile<BKV, DM, THREADS>(Vs + slot * BKV * LD, LD, v, a.D, t0,
                                       col_hi, 0, a.D, false);
    }
  };

  // a lane's query rows wrow0 + lr + 4 i, key columns t0 + lc + 8 j and
  // output columns 32 g + 4 lc + e
  float m[4], l[4], o[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][g][e] = 0.f;
  }

  if (n_sub > 0) {
    tc::stage_tile<BQ, DM, THREADS>(Qs, LD, q, a.D, row0, a.S, 0, a.D, vec);
    stage_kv(0, col_lo);
    tc::cp_async_commit();
  }
  for (int j = 0; j < n_sub; ++j) {
    tc::cp_async_wait(0);
    __syncthreads();      // sub-tile j is in; slot (j + 1) % 2 is free
    if (j + 1 < n_sub) {
      stage_kv((j + 1) % 2, col_lo + (j + 1) * BKV);
      tc::cp_async_commit();
    }
    const float* K = Ks + (j % 2) * BKV * LD;
    const float* V = Vs + (j % 2) * BKV * LD;
    const int t0 = col_lo + j * BKV;

    // s = q . k over d in increasing order, 4 d-steps a load
    float s[4][BKV / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj) s[i][jj] = 0.f;
#pragma unroll
    for (int d = 0; d < DM; d += 4) {
      float qv[4][4], kk[BKV / 8][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ld4(Qs + (warp * 16 + lr + 4 * i) * LD + d, qv[i]);
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj) ld4(K + (lc + 8 * jj) * LD + d, kk[jj]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < BKV / 8; ++jj)
            s[i][jj] = fmaf(qv[i][e], kk[jj][e], s[i][jj]);
    }

    // scale and mask; a warp whose 16 rows see every column of the
    // sub-tile skips the per-element mask (the same numbers)
    const bool all = t0 + BKV <= a.T &&
                     (!a.causal || t0 + BKV - 1 <= wrow0) &&
                     (!a.window || t0 > wrow0 + 15 - a.window);
    float m_new[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wrow0 + lr + 4 * i;
      float smax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj) {
        const float sc = __fmul_rn(s[i][jj], a.scale);
        s[i][jj] = all || visible(a, row, t0 + lc + 8 * jj) ? sc : NEG_INF;
        smax = fmaxf(smax, s[i][jj]);
      }
      // the running max over the row's 8 lanes, and the rescale
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, off));
      m_new[i] = fmaxf(m[i], smax);
      const float corr = __expf(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] = __fmul_rn(l[i], corr);
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][g][e] *= corr;
    }
    if (all) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj) {
          s[i][jj] = __expf(s[i][jj] - m_new[i]);
          l[i] += s[i][jj];               // the lane's part of the row sum
        }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj) {
          s[i][jj] = visible(a, wrow0 + lr + 4 * i, t0 + lc + 8 * jj)
                         ? __expf(s[i][jj] - m_new[i])
                         : 0.f;
          l[i] += s[i][jj];
        }
    }
    // p into the warp's [key][row] slice, a lane's 4 rows as one float4
#pragma unroll
    for (int jj = 0; jj < BKV / 8; ++jj)
      *reinterpret_cast<float4*>(Ps + (lc + 8 * jj) * PLD + lr * 4) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    __syncwarp();
    // o += p v in increasing key order (keys the block cannot see hold p =
    // 0 and zero-filled v rows)
#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float pv[4], vv[NG][4];
      ld4(Ps + c * PLD + lr * 4, pv);
#pragma unroll
      for (int g = 0; g < NG; ++g) ld4(V + c * LD + 32 * g + 4 * lc, vv[g]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][g][e] = fmaf(pv[i], vv[g][e], o[i][g][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = wrow0 + lr + 4 * i;
    if (row >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 32 * g + 4 * lc + e;
        if (d < a.D) out[(size_t)row * a.D + d] = o[i][g][e] / den;
      }
  }
}

template <int DM>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (a.S + BQ - 1) / BQ * a.BH;
  flash_fwd_kernel<DM><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 32) return launch<32>(a, stream);
  if (a.D <= 64) return launch<64>(a, stream);
  return launch<128>(a, stream);
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16)

constexpr int TQ = 64;          // query rows per block, 16 per warp
constexpr int TKV = 64;         // key/value columns per staged sub-tile
constexpr int TC_THREADS = 128;
enum { MODE_FULL = 0, MODE_MAX = 1, MODE_PV = 2 };

struct TcArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int BH, S, T, D, kv_chunk, causal, window;
  float scale;
  int n_chunks, n_split;
  float* mpart;   // split path: (BH, n_chunks, n_split, S) row maxima
  float* lpart;   // (BH, n_chunks, n_split, S) row sums of p
  float* opart;   // (BH, n_chunks, n_split, S, D) unnormalized p v
};

template <int DM>
constexpr size_t tc_smem_bytes() {   // q tile + two K and two V slots
  return sizeof(__nv_bfloat16) * (size_t)(TQ + 4 * TKV) * (DM + 8);
}

__device__ __forceinline__ bool tc_visible(const TcArgs& a, int row, int col,
                                           int hi) {
  return col < hi && (!a.causal || col <= row) &&
         (!a.window || col > row - a.window);
}

// every (row, column) of warp rows r0..r0+15 x columns t0..t0+TKV-1 is
// visible: the warp skips the per-element mask
__device__ __forceinline__ bool tc_all_visible(const TcArgs& a, int r0, int t0,
                                               int hi) {
  return t0 + TKV <= hi && (!a.causal || t0 + TKV - 1 <= r0) &&
         (!a.window || t0 > r0 + 15 - a.window);
}

// Unscaled scores of the warp's 16 rows against the 64 columns of one K
// slot: s[nt] holds columns 8 nt + 2t, +1 of rows g and g + 8.  Both passes
// call this, so both compute each score with the same mma sequence.
template <int DM>
__device__ __forceinline__ void tc_scores(const uint32_t (&qf)[DM / 16][4],
                                          const __nv_bfloat16* Ks,
                                          float (&s)[TKV / 8][4]) {
  constexpr int LD = DM + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < TKV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
#pragma unroll
    for (int np = 0; np < TKV / 16; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, Ks + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                             kk * 16 + ((lane / 8) % 2) * 8);
      tc::mma(s[2 * np], qf[kk], b[0], b[1]);
      tc::mma(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
}

// at D <= 64 four blocks (16 warps) share an SM: the kernel is bound by
// latency (exp, the mask, the staging), so registers are capped at 128
template <int DM, int MODE>
__global__ void __launch_bounds__(TC_THREADS, DM <= 64 ? 4 : 2)
    flash_tc_kernel(TcArgs a) {
  using tc::bf16;
  constexpr int LD = DM + 8;          // padded rows (ldmatrix banks)
  constexpr int NTD = DM / 8;         // output n8 tiles
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);   // [TQ][LD]
  bf16* Ks = Qs + TQ * LD;                       // [2][TKV][LD]
  bf16* Vs = Ks + 2 * TKV * LD;                  // [2][TKV][LD]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TQ;   // heaviest first
  const size_t bh = blockIdx.y;
  const bf16* q = a.q + bh * a.S * a.D;
  const bf16* k = a.k + bh * a.T * a.D;
  const bf16* v = a.v + bh * a.T * a.D;
  const bool vec = a.D % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;

  const KvChunks<bf16, DM, TC_THREADS> kv;
  const uint32_t ks_addr = tc::smem_addr(Ks), vs_addr = tc::smem_addr(Vs);
  // K (and V) rows t0.. into ring slot `slot`
  auto stage_k = [&](int slot, int t0, int hi) {
    if (vec)
      kv.stage(ks_addr + slot * 2 * TKV * LD, k, t0, hi, a.D);
    else
      tc::stage_tile<TKV, DM, TC_THREADS>(Ks + slot * TKV * LD, LD, k, a.D,
                                          t0, hi, 0, a.D, false);
  };
  auto stage_v = [&](int slot, int t0, int hi) {
    if (vec)
      kv.stage(vs_addr + slot * 2 * TKV * LD, v, t0, hi, a.D);
    else
      tc::stage_tile<TKV, DM, TC_THREADS>(Vs + slot * TKV * LD, LD, v, a.D,
                                          t0, hi, 0, a.D, false);
  };

  tc::stage_tile<TQ, DM, TC_THREADS>(Qs, LD, q, a.D, row0, a.S, 0, a.D, vec);
  tc::cp_async_commit();
  tc::cp_async_wait(0);
  __syncthreads();
  uint32_t qf[DM / 16][4];
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
    tc::ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                                (lane / 16) * 8);

  const int wrow0 = row0 + warp * 16;   // the warp's first query row
  const int rows[2] = {wrow0 + lane / 4, wrow0 + lane / 4 + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NTD][4];
#pragma unroll
  for (int nt = 0; nt < NTD; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // the columns any row of this block may see
  const int row_last = min(row0 + TQ, a.S) - 1;
  const int col_hi = a.causal ? min(a.T, row_last + 1) : a.T;
  const int col_lo = a.window ? max(0, row0 - a.window + 1) : 0;

  // chunks this block walks: all of them, or (split) one chunk's one range
  int c_first = 0, c_last = a.n_chunks, split = 0;
  if (MODE != MODE_FULL) {
    c_first = blockIdx.z / a.n_split;
    c_last = c_first + 1;
    split = blockIdx.z % a.n_split;
  }
  for (int c = c_first; c < c_last; ++c) {
    const int c0 = c * a.kv_chunk;
    int lo = max(c0, col_lo);
    int hi = min(c0 + a.kv_chunk, col_hi);
    if (MODE != MODE_FULL && lo < hi) {   // this split's sub-tile range
      const int per = (hi - lo + a.n_split - 1) / a.n_split;
      const int w = (per + TKV - 1) / TKV * TKV;
      lo = lo + split * w;
      hi = min(lo + w, hi);
    }
    const int n_sub = lo < hi ? (hi - lo + TKV - 1) / TKV : 0;
    const size_t part = ((bh * a.n_chunks + c) * a.n_split + split) *
                        (size_t)a.S;
    if (MODE == MODE_FULL && n_sub == 0) continue;   // o, m, l unchanged

    float m_new[2], corr[2] = {1.f, 1.f};
    if (MODE != MODE_PV) {
      // pass 1: the row max over this chunk (or split)
      float cmax[2] = {NEG_INF, NEG_INF};
      if (n_sub > 0) {
        __syncthreads();                // the slots' last readers are done
        stage_k(0, lo, hi);
        tc::cp_async_commit();
      }
      for (int j = 0; j < n_sub; ++j) {
        tc::cp_async_wait(0);
        __syncthreads();
        if (j + 1 < n_sub) {
          stage_k((j + 1) % 2, lo + (j + 1) * TKV, hi);
          tc::cp_async_commit();
        }
        float s[TKV / 8][4];
        tc_scores<DM>(qf, Ks + (j % 2) * TKV * LD, s);
        const int t0 = lo + j * TKV;
        if (tc_all_visible(a, wrow0, t0, hi)) {
#pragma unroll
          for (int nt = 0; nt < TKV / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cmax[e / 2] = fmaxf(cmax[e / 2], __fmul_rn(s[nt][e], a.scale));
        } else {
#pragma unroll
          for (int nt = 0; nt < TKV / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = t0 + nt * 8 + 2 * (lane % 4) + e % 2;
              if (tc_visible(a, rows[e / 2], col, hi))
                cmax[e / 2] =
                    fmaxf(cmax[e / 2], __fmul_rn(s[nt][e], a.scale));
            }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
        cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
      }
      if (MODE == MODE_MAX) {
        if (lane % 4 == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (rows[h] < a.S) a.mpart[part + rows[h]] = cmax[h];
        return;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m[h], cmax[h]);
        corr[h] = expf(m[h] - m_new[h]);
      }
#pragma unroll
      for (int nt = 0; nt < NTD; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e / 2];
    } else {
      // split pass 2: m_new is the running max through chunk c, from every
      // split's row max of chunks 0..c
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = NEG_INF;
        if (rows[h] < a.S)
          for (int cc = 0; cc <= c; ++cc)
            for (int i = 0; i < a.n_split; ++i)
              m_new[h] = fmaxf(
                  m_new[h],
                  a.mpart[((bh * a.n_chunks + cc) * a.n_split + i) *
                              (size_t)a.S + rows[h]]);
      }
    }

    // pass 2: p against m_new, rounded to bf16, o += p v
    float lsum[2] = {0.f, 0.f};
    if (n_sub > 0) {
      __syncthreads();
      stage_k(0, lo, hi);
      stage_v(0, lo, hi);
      tc::cp_async_commit();
    }
    for (int j = 0; j < n_sub; ++j) {
      tc::cp_async_wait(0);
      __syncthreads();
      if (j + 1 < n_sub) {
        stage_k((j + 1) % 2, lo + (j + 1) * TKV, hi);
        stage_v((j + 1) % 2, lo + (j + 1) * TKV, hi);
        tc::cp_async_commit();
      }
      const int cur = (j % 2) * TKV * LD, t0 = lo + j * TKV;
      float s[TKV / 8][4];
      tc_scores<DM>(qf, Ks + cur, s);
      if (tc_all_visible(a, wrow0, t0, hi)) {
#pragma unroll
        for (int nt = 0; nt < TKV / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                expf(__fmul_rn(s[nt][e], a.scale) - m_new[e / 2]);
            lsum[e / 2] += p;
            s[nt][e] = p;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < TKV / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t0 + nt * 8 + 2 * (lane % 4) + e % 2;
            const float p = tc_visible(a, rows[e / 2], col, hi)
                                ? expf(__fmul_rn(s[nt][e], a.scale) -
                                       m_new[e / 2])
                                : 0.f;
            lsum[e / 2] += p;
            s[nt][e] = p;
          }
      }
      // P (16 x 64 keys) as four m16k16 A fragments; V^T through
      // ldmatrix.trans as the B operand
#pragma unroll
      for (int kk = 0; kk < TKV / 16; ++kk) {
        const uint32_t pa[4] = {
            tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < DM / 16; ++np) {
          uint32_t b[4];
          tc::ldmatrix_x4_trans(
              b, Vs + cur + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                     np * 16 + (lane / 16) * 8);
          tc::mma(o[2 * np], pa, b[0], b[1]);
          tc::mma(o[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
    }
    if (MODE == MODE_PV) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= a.S) continue;
        if (lane % 4 == 0) a.lpart[part + rows[h]] = lsum[h];
        float* op = a.opart + (part + rows[h]) * a.D;
#pragma unroll
        for (int nt = 0; nt < NTD; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = nt * 8 + 2 * (lane % 4) + e;
            if (d < a.D) op[d] = o[nt][2 * h + e];
          }
      }
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), lsum[h]);
      m[h] = m_new[h];
    }
  }

  bf16* out = a.o + bh * a.S * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= a.S) continue;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nt * 8 + 2 * (lane % 4) + e;
        if (d < a.D)
          out[(size_t)rows[h] * a.D + d] =
              __float2bfloat16_rn(o[nt][2 * h + e] / den);
      }
  }
}

// Split path, last step: per (bh, row, d) the chunks in order, each chunk's
// splits added against their shared running max, then o / max(l, 1e-30).
__global__ void flash_combine_kernel(TcArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.S * a.D) return;
  const int row = idx / a.D, d = idx % a.D;
  const size_t bh = blockIdx.y;
  float m = NEG_INF, l = 0.f, o = 0.f;
  for (int c = 0; c < a.n_chunks; ++c) {
    const size_t base = (bh * a.n_chunks + c) * a.n_split * (size_t)a.S;
    float cmax = NEG_INF;
    for (int i = 0; i < a.n_split; ++i)
      cmax = fmaxf(cmax, a.mpart[base + i * (size_t)a.S + row]);
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    float ls = 0.f, os = 0.f;
    for (int i = 0; i < a.n_split; ++i) {
      const size_t r = base + i * (size_t)a.S + row;
      ls += a.lpart[r];
      os += a.opart[r * a.D + d];
    }
    l = __fadd_rn(__fmul_rn(l, corr), ls);
    o = __fadd_rn(__fmul_rn(o, corr), os);
    m = m_new;
  }
  a.o[(bh * a.S + row) * a.D + d] = __float2bfloat16_rn(o / fmaxf(l, 1e-30f));
}

template <int DM, int MODE>
int launch_tc_mode(const TcArgs& a, int splits, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<DM, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.S + TQ - 1) / TQ, a.BH, splits);
  flash_tc_kernel<DM, MODE><<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DM>
int launch_tc(const TcArgs& a, cudaStream_t stream) {
  if (a.n_split == 1) return launch_tc_mode<DM, MODE_FULL>(a, 1, stream);
  const int z = a.n_chunks * a.n_split;
  int rc = launch_tc_mode<DM, MODE_MAX>(a, z, stream);
  if (rc != 0) return rc;
  rc = launch_tc_mode<DM, MODE_PV>(a, z, stream);
  if (rc != 0) return rc;
  const dim3 grid((a.S * a.D + 255) / 256, a.BH);
  flash_combine_kernel<<<grid, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, S, D), k/v (BH, T, D), o (BH, S, D), all contiguous fp32 (dtype
// 0; bf16 takes flash_attention_tc); D <= 128; KV consumed in chunks of
// kv_chunk columns (the last one ragged).  causal / window as in the
// reference (window 0 = none).  Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int T, int D, int kv_chunk, int causal,
                                   int window, float scale, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || T < 1 || D < 1 || D > 128 ||
      kv_chunk < 1 || window < 0 || dtype != F32 ||
      (long long)((S + BQ - 1) / BQ) * BH > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, BH, S, T, D, kv_chunk, causal, window, scale};
  return launch_d(a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) each flash_attention_tc launch takes at
// head dim D (<= 128).
extern "C" long long flash_attention_tc_smem(int D) {
  if (D < 1 || D > 128) return -1;
  return (long long)(D <= 32   ? tc_smem_bytes<32>()
                     : D <= 64 ? tc_smem_bytes<64>()
                               : tc_smem_bytes<128>());
}

// The same function on the tensor-core kernel, q/k/v/o bf16.  n_split = 1:
// one launch; n_split > 1: the split path's three launches, with fp32
// scratch mpart and lpart of (BH, ceil(T / kv_chunk), n_split, S) and
// opart of (BH, ceil(T / kv_chunk), n_split, S, D) elements.
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* o, int BH, int S,
                                  int T, int D, int kv_chunk, int causal,
                                  int window, float scale, int n_split,
                                  float* mpart, float* lpart, float* opart,
                                  void* stream) {
  const int n_chunks = kv_chunk > 0 ? (T + kv_chunk - 1) / kv_chunk : 0;
  if (BH < 1 || BH > 65535 || S < 1 || T < 1 || D < 1 || D > 128 ||
      kv_chunk < 1 || window < 0 || n_split < 1 ||
      n_chunks * n_split > 65535 ||
      (n_split > 1 && (!mpart || !lpart || !opart)))
    return (int)cudaErrorInvalidValue;
  const TcArgs a{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o), BH, S, T, D, kv_chunk,
                 causal, window, scale, n_chunks, n_split, mpart, lpart,
                 opart};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_tc<32>(a, s);
  if (D <= 64) return launch_tc<64>(a, s);
  return launch_tc<128>(a, s);
}
