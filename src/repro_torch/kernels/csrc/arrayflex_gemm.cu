// ArrayFlex K-collapse GEMM for Hopper (sm_90a), with the fused
// prologue/epilogue of the reference kernel, plus its expert-batched form,
// each on float weights and on int8 weight codes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/arrayflex_gemm.py:
//   af_gemm           <- _kernel, fp32 operands (FFMA)
//   af_gemm_tc        <- _kernel, bf16 operands (tensor cores)
//   af_gemm_q         <- _kernel, int8 weights: W8 (quant) on fp32 x and
//                        W8A8 (quant + act_quant; at M <= 16 the W8A8
//                        narrow tile, above it the int8 tensor-core tile)
//   af_gemm_q_tc      <- _kernel, int8 weights with bf16 x: W8 on the
//                        tensor cores
//   af_expert_gemm    <- _expert_kernel, fp32 x with fp32 or bf16 w
//   af_expert_gemm_tc <- _expert_kernel, bf16 operands (tensor cores)
//   af_expert_gemm_q  <- _expert_kernel, int8 weights: the int8-only form
//                        of the MoE expert banks (quant) and W8A8
//                        (quant + act_quant; at T <= 16 the W8A8 narrow
//                        tile, above it the int8 tensor-core tile)
// (launched by arrayflex_gemm / arrayflex_expert_gemm).
//
// What it computes:
//   af_gemm:  out = [r +] act((g*X)@W [+ b]) [* ((g*X)@W2 [+ b2])]
//             X[M,K], W/W2[K,N]; the rmsnorm scale g multiplies each staged
//             x element in fp32 and rounds back to the operand type before
//             the product (the reference's prologue_phase), the epilogue
//             runs once at the store in store_phase order: dequant -> bias
//             -> act -> gate multiply -> residual -> one cast.
//   W8:       W/W2 hold int8 codes, converted exactly to x's type (fp32 for
//             the FFMA chain, bf16 for the tensor cores); the per-column
//             scales s/s2 multiply the accumulators at the store (exact: a
//             column scale factors out of the K sum).
//   W8A8:     each x tile of the reference's tiling -- quant_bm rows by one
//             main-loop step of quant_kk columns -- is quantized with one
//             fp32 scale (quantize_tile: amax * fp32(1/127), round half
//             to even, clip +-127) after the prologue, the products run
//             int8 x int8 -> int32 (__dp4a at M <= 16, the int8 tensor
//             cores above), and each step's int32 partial folds into the
//             fp32 accumulator as acc + float(iacc) * scale, in increasing
//             step order.
//   expert:   X[E,T,K] @ W[E,K,N] -> [E,T,N], blockIdx.z walks E, the same
//             main loop, only the dequant at the store.  On int8 codes
//             without act_quant (an MoE expert bank under W8) it is the
//             W8 chain on fp32 or bf16 x: the codes widen exactly to fp32
//             for the FFMA chain (bf16 x code and fp32 x code are exact
//             fp32 products, the reference's widening to x's type with
//             fp32 sums) and each expert's per-column scale multiplies
//             once, at the store.
//
// What bounds it on this card: at decode (M = batch rows, a handful) every
// weight byte is read once for a few rows of work, so the GEMM is bound by
// streaming the weights from HBM (3.35 TB/s on an H100 SXM), and int8
// codes halve those bytes against bf16; at a large prefill chunk the same
// GEMM is bound by operations: 989 TFLOP/s for bf16 operands on the tensor
// cores, 67 TFLOP/s for fp32 on the FFMA pipes.
//
// The kernels are chosen by operand type and rows (the wrapper's written
// rules, counted per kernel): bf16 operands of the float forms launch
// af_gemm_tc_kernel (entries af_gemm_tc, and af_expert_gemm_tc with the
// expert axis on blockIdx.z), fp32 operands the FFMA kernels (entries
// af_gemm, af_expert_gemm); K1's W8 form on bf16 x launches
// af_gemm_tc_kernel on int8 codes (entry af_gemm_q_tc), on fp32 x the FFMA
// kernels (af_gemm_q).  K2's int8-only form takes the FFMA narrow tile at
// T <= 16 on either x type and, above, af_gemm_tc_kernel on int8 codes on
// bf16 x (entry af_expert_gemm_q_tc) or the FFMA wide tile on fp32 x.
// Every FFMA launch runs a narrow tile at 16 rows (M, or T) or fewer and
// the wide tile (af_gemm_ffma_kernel) above.  W8A8 (K1 and K2, either x
// type) runs the W8A8 narrow tile (__dp4a) at M (T) <= 16 and, above, a
// quantize pass into scratch followed by the int8 tensor-core tile
// (af_w8a8_quant_kernel, af_gemm_w8a8_tc_kernel).
//
// af_gemm_tc_kernel, bf16 x/w/w2/residual: the products run on the tensor
// cores as mma.sync.m16n8k16 bf16 x bf16 -> fp32 -- the arithmetic of the
// reference's matrix unit -- on operands staged by 16-byte cp.async into a
// ring of shared-memory sub-tiles and loaded with ldmatrix (tc.cuh).
// mma.sync rather than wgmma + TMA: its warp-level fragments are where the
// prologue and the per-element epilogue are written, it takes a 16-row
// tile for decode (wgmma's 64-row warpgroup tile would waste 4x there),
// and it builds in seconds.  wgmma with TMA is the next step for speed.
//   * k-collapse: one main-loop step stages k_collapse sub-tiles of
//     TC_BK = 32 columns between two barriers and runs their products into
//     the same fp32 fragments; the ring holds `stages` steps (up to 4,
//     fewer when k_collapse sub-tiles fill the tile's budget), so the next
//     steps' loads fly while one computes.  Every accumulator takes its
//     k16 products in increasing K order whatever k_collapse, the tile or
//     the stage count, so the output is bit-identical across them;
//   * what bounded the first version was latency inside each warp, not
//     bytes: staging recomputed each 16-byte chunk's addresses (~250
//     cycles a chunk a thread) and the prologue read g from global memory
//     in the product chain.  Each thread now computes its chunks' shared
//     offsets and global addresses once (Chunks), slots advance without
//     division, g rides the ring beside its x sub-tile, and decode tiles
//     load both k16 halves' fragments before their products;
//   * prologue: the rmsnorm scale multiplies each A-fragment element (x)
//     in fp32 after ldmatrix and rounds it back to bf16: x_at's rounding;
//   * epilogue: store_one's order and roundings per element of the C
//     fragments, stored as column pairs (bf16x2 / float2) where aligned;
//   * tiles: prefill (M > 16) 128 x 128 in 8 warps of 64 x 32 (dual: 128 x
//     64, two accumulator sets of 32 x 32 a warp, so the swiglu does not
//     spill); decode (M <= 16) one m16 row tile, rows past M zero, 32
//     columns a block in 4 warps of one n8 tile each, so N / 32 blocks
//     stream W (28 at the 896-wide sites, 4752 at the unembed) with a
//     32 KB ring, small enough that several blocks share an SM; the
//     896-wide sites stay latency-bound whatever the tiling;
//   * ragged M, N and K are zero-filled in shared memory (cp.async's
//     src-size at the edge chunk, zero stores past it), nothing is padded
//     in device memory; a base or row stride that is not 16-byte aligned
//     stages through scalar loads inside the same kernel, into the same
//     main loop;
//   * W8 (af_gemm_q_tc, the QUANT instantiations; with the expert axis,
//     af_expert_gemm_q_tc, K2's int8-only MoE banks above 16 rows: codes
//     offset by the expert's bsw, scales by bss): the reference widens
//     the codes to x's type and runs bf16 x bf16 -> fp32 on its matrix unit
//     (exact: |code| <= 127), which is this kernel's arithmetic.  The codes
//     stay int8 through the cp.async ring (16 a chunk: half the bytes of a
//     bf16 sub-tile, and no widened copy of W anywhere in device memory)
//     and widen to bf16 in registers as each B fragment is built: four
//     byte loads a fragment, each (k, col) a lane needs read directly
//     (ldmatrix moves 16-bit elements, so it cannot transpose bytes), then
//     two exact conversions and a pack a register.  Chosen over a widening
//     pass through shared memory, which would add a barrier and a bf16
//     copy of every sub-tile to the ring; the B rows are padded by one
//     chunk so a fragment's four K rows fall on distinct banks.  The
//     per-column scales multiply the fp32 accumulators first at the store
//     (__fmul_rn, store_one's order), then bias, act, gate, residual, one
//     cast.  x, g, the residual and the prologue are the bf16 form's; the
//     bf16 instantiations compile as before (QUANT is a template flag);
//   * the batch axis (K2: an MoE expert, or one batch x kv-head of
//     attn.qk / attn.pv) is blockIdx.z: x, w and out are offset by their
//     batch strides before anything else, so the alignment test is taken
//     per element (with T * K not a multiple of 8, some experts' bases are
//     misaligned and stage through the scalar path), and an element's
//     bits do not depend on how many others share the launch.  K2's
//     tiles: the decode tile for T <= 16 (an MoE bank's one capacity row
//     is one row of 16, 24 or 64 column blocks an expert), the 128 x 128
//     prefill tile, and 128 x 64 where N <= 64 (attn.pv's head dim).  The
//     fp32 score tile of attn.qk leaves through the same shared-memory
//     epilogue.
//
// af_gemm_narrow_kernel, at decode (M <= 16): every af_gemm launch and
// every W8 af_gemm_q launch on fp32 x (fp32 or int8-code w, one or two
// contractions, any N), af_expert_gemm at T <= 16, and af_expert_gemm_q's
// int8-only form at T <= 16 (the MoE banks, on fp32 or bf16 x).  The
// 64-column tile that ran them first did so on ceil(N / 64) blocks -- 14
// at an 896-wide site, each walking K = 4864 in one chain with scalar loads
// between two barriers (W8 mlp.wo on an H100: 308 us to read 4.4 MB of
// codes), 12 of its 16 rows zeros at M = 4.  Here a block splits K into 16
// fixed slices, one warp each: a warp
// stages its slice's w panel (and w2's, in the same ring slot), x rows and
// g as 16-byte cp.async chunks (int8 codes 16 a chunk) into its own ring
// of main-loop steps (k_collapse 32-row sub-tiles, up to half the ring),
// keeps its outputs as fmaf chains over the slice in K order (two sets for
// the dual), and the slices' partials add in slice order at the end.  The
// split is fixed by K alone, so the output is the same bits at every
// k_collapse and every width, though not the wide tile's single chain
// (both hold the plain version's fp32 tolerance).  Why not that single
// chain here: with one output a thread, each SM holds one computing warp
// whose chain waits on a shared-memory load every K step, and few warps
// stage the scattered rows of w; 16 slices give an SM 16 warps for both.
//   * width: a block's columns.  With 8 fp32 columns each block read
//     32-byte pieces of every w row, half a DRAM burst, and the fp32 MoE
//     banks streamed at about half of HBM's rate; 32 fp32 columns, a w
//     row's 128 bytes, stream them at bmm's pace.  K1 and K2's int8-only
//     form take the widest of their type's widths (fp32 32 / 16 / 8, int8
//     128 / 64 / 32 / 16) whose grid (K2: blocks x experts) still fills the
//     card, so a 128-wide site keeps 16 blocks and the unembed and the MoE
//     banks stream 128-byte rows (nw_cols); K2's fp32 form takes 32.  A
//     lane owns
//     COLS / 32 neighbouring columns of every row (COLS >= 32), or one
//     column of every (32 / COLS)-th row, with room for 4 rows of sums at
//     M <= 4 (the decode batch) and 16 above: 16 rows' room at M = 4 held
//     4x the registers it used, and with it the W8 dual's 152 blocks ran
//     one an SM, in two waves (NwShape);
//   * int8 codes widen to fp32 as they leave shared memory with a byte
//     permute and an add, exact (nw_widen), once for all of a lane's rows;
//     the per-column scales multiply first at the store (store_one);
//   * the ring's budget is the whole SM where the grid has at most a block
//     an SM (each block streams alone), else half of it (two blocks an SM:
//     one's loads overlap another's sums and store), and a ring holds no
//     more steps than its slice needs, so a short K frees the SM;
//   * the partials buffer is [contraction][slice][M rows][width] over the
//     rings (the dual's 64 int8 columns at M = 16: 128 KB);
//   * x is staged in its own type (fp32, or the served MoE banks' bf16, 8
//     a chunk: no widened copy of x in device memory, no extra launch) and
//     widened exactly as it leaves shared memory (a bf16's bits under the
//     high half);
//   * K2: the expert on blockIdx.z, operands and per-column scales offset
//     per expert before the alignment tests (an expert's bits do not depend
//     on E), bf16 w (the fp32 query against a bf16 cache) staged as bf16
//     and widened exactly, the half-SM ring (a bank is thousands of
//     blocks).  Larger M (T) takes the wide tile.
//
// af_gemm_w8a8_narrow_kernel, W8A8 at decode (M <= 16; K2 at T <= 16: the
// MoE banks' one capacity row, attn.qk's g query rows).  On a 64-column
// __dp4a tile (this file's W8A8 kernel at every M before this tile and
// the int8 tensor-core tile), every column block (x E experts) re-read the
// whole x tile from global memory for each reference step's amax,
// re-quantized every x element of its rows with an IEEE division, loaded
// the codes a byte at a time between two barriers, and kept 12 of 16 rows
// zero at M = 4 (15 at the banks): far from streaming the codes, which is
// what bounds W8A8 at decode.  Here, per block:
//   * x is quantized once, in the launch's own prologue (a separate
//     quantize launch would add one to every W8A8 GEMM of a host-bound
//     step): each reference step's amax over all M rows, then the int8
//     codes of all rows into shared memory, each step padded with zero
//     codes to whole 32-row sub-tiles (M x K bytes: 19 KB at M = 4, K =
//     4864), so no sub-tile and no 4-byte dp4a group straddles a step and
//     padding sits inside its own step only.  All 16 warps share the two
//     passes (amax, then codes), each a contiguous run of 128-column
//     pieces with QW_BATCH pieces' loads in flight at once (a warp a step, its
//     loads issued one after another, left the prologue many L2 latencies
//     deep);
//   * the codes stream as the narrow tile's do: 16 warps, each summing a
//     contiguous run of the sub-tiles through its own ring of 16-byte
//     cp.async chunks, the width from nw_cols with the grid counted over
//     experts (128 columns, 128-byte rows, at the banks and the unembed);
//     the ring's first sub-tiles are issued before the prologue, so they
//     fly while the block quantizes x;
//   * the product is __dp4a on four K rows of each column, transposed 4 x 4
//     bytes in registers with __byte_perm, against the broadcast word of
//     four x codes.  mma.sync.m16n8k32 s8 would need the same byte
//     transposes for its B fragments (ldmatrix cannot transpose bytes) and
//     waste 12 of 16 rows at M = 4; at M <= 16 the code stream, not the
//     arithmetic, bounds the kernel, so the simpler dp4a chain is kept;
//   * integer sums are exact in any order, so each warp adds its int32
//     sums into the step's partials in shared memory with atomicAdd where
//     its run passes a step boundary, and after a barrier every output
//     folds acc + float(iacc) * scale in increasing step order: the codes,
//     scales, int32 partials and fold are the plain version's
//     (_w8a8_accumulate) and the int8 tensor-core tile's, so the output is
//     their bits, whatever the width, ring depth or E;
//   * shared memory holds codes [M][round x padded step], partials
//     [contraction][round][M][width] int32 and the rings.  A round is as
//     many whole steps as fit (every step at every decode site of the
//     served models: 10 at qwen2's mlp.wo, 2.5 KB of partials); longer K
//     at M = 16 takes several rounds, each quantizing, streaming and
//     folding its own steps;
//   * a base or row stride off the 16-byte grid stages through scalar
//     loads into the same ring (nw_chunk); x is read with scalar loads in
//     the prologue at any alignment; the epilogue is store_one's.
//
// W8A8 above 16 rows (K1 af_gemm_q with act_quant at M > 16: the prefill
// chunk; K2 af_expert_gemm_q with act_quant at T > 16: attn.qk at g x
// chunk query rows) is bound by operations at the prefill chunk (1,979
// TOP/s int8 on the tensor cores) once x is read once.  One C entry makes
// two launches on the caller's stream:
//   * af_w8a8_quant_kernel quantizes x once a call into scratch that the
//     wrapper allocates: one cluster of 1-8 blocks a reference tile
//     (quant_bm rows by one quant_kk step, of one expert; more blocks
//     where the tiles are few), each block a run of its rows, each item
//     one row by 16 columns read with 16-byte loads where x's base, row
//     stride and step start allow (else scalar), g applied as x_at does;
//     the tile's amax by block reductions met through distributed shared
//     memory, its scale amax * fp32(1/127) stored once ([expert][row
//     tile][step] fp32), then quant_code (the IEEE division, rintf, clip)
//     of every element from the registers the first pass loaded (a block
//     of more than QT_ITEMS items a thread reads x again, from L2).  The
//     codes go to [expert][M rows][steps x kk32], kk32 = quant_kk rounded
//     up to 32: each step padded with zero codes to whole 32-column
//     sub-tiles, so no sub-tile straddles two steps, and each 32-column
//     group permuted (qt_col) so that an ldmatrix of the codes and an
//     ldmatrix.trans of the w codes meet at the same K;
//   * af_gemm_w8a8_tc_kernel: 128-row blocks (a block's rows lie in one
//     reference tile: quant_bm is M or a multiple of 128, else the launch
//     is refused), 128 x 128 in 8 warps of 64 x 32 where that grid fills
//     the card, else 128 x 64 in 8 warps of 32 x 32, the dual 128 x 64
//     with two accumulator sets; x codes and w (w2) codes staged by
//     16-byte cp.async into a double buffer of steps of 8 32-column
//     sub-tiles (rows past M, K rows past K and columns past N
//     zero-filled; w off the 16-byte grid through scalar loads in the same
//     kernel), one barrier a step; the products mma.sync.m16n8k32 s8 x s8
//     -> s32: A fragments by ldmatrix from the K-major codes, B fragments
//     by one ldmatrix.x4.trans of a 32-row by 16-byte block of the
//     N-major w codes (16-bit units: two columns at two neighbouring K
//     rows a register) and four byte permutes, which give the even and
//     the odd column of each pair their K rows in the order 2t, 2t+1,
//     2t+8, 2t+9 -- the order the quantize pass wrote the x codes in.  So
//     w needs no transpose through shared memory, no byte loads and no
//     second barrier, and a lane's accumulators cover four neighbouring
//     columns;
//   * each reference step's int32 partials are exact (integer sums in any
//     order; the zero codes of a step's padding against the next step's w
//     rows add nothing), and the fold acc + float(iacc) * scale runs per
//     step in increasing order (__fmul_rn / __fadd_rn, so nvcc cannot
//     contract it into an FMA), the scale read once a step; the epilogue
//     goes through a shared-memory fp32 tile in store_one's order, a
//     thread on one column pair (its scales and biases read once).  So the
//     output is the plain version's bits (_w8a8_accumulate) where the
//     store is the dequant alone, as the W8A8 narrow tile's is;
//   * K2: the expert on blockIdx.z, its operands, codes, scales and
//     per-column scales offset before the alignment tests, so an expert's
//     bits do not depend on E.
//
// af_gemm_ffma_kernel, the FFMA wide tile above 16 rows (fp32 af_gemm and
// W8 on fp32 x at M > 16, K2's fp32 form and its int8-only form on fp32 x
// at T > 16): no tensor core gives IEEE fp32, so each output stays one
// fmaf chain from 0 in increasing K order -- the same bits at every
// k_collapse and tile -- and what bounds it is the FFMA pipes' 67 TFLOP/s.
// The first tile here kept a 64 x 64 block of 4 x 4 outputs a thread,
// staged every operand element with a scalar load and an integer division
// into one buffer between two barriers, and ran at 22-28% of that bound.
// Now:
//   * 128 x 128 block tiles (128 x 64 with two accumulator sets for the
//     dual swiglu pair), 256 threads of 8 x 8 outputs held in registers:
//     per K row a thread reads two float4 of x and two of w (two 8-byte
//     bf16 or 4-byte int8 loads) for 64 fmaf.  Where that grid would not
//     give every SM two blocks, 128 x 64 tiles of 8 x 4 (the 896-column
//     projections of a 2048-token prefill) or, where those would not give
//     every SM one, 64 x 64 of 4 x 4 (the 128-column ones, attn.pv's 64);
//   * two blocks an SM (the launch bound caps a thread at 128 registers;
//     the ring at half the SM's shared memory), so one block's barrier and
//     loads hide behind the other's products;
//   * a ring of 2-4 main-loop steps, one barrier a step (run_ring): a step
//     is k_collapse sub-tiles of 16 K rows, or as many as leave room for
//     two steps; w and w2 arrive by 16-byte cp.async in their own type
//     (Chunks' addresses, computed once) while earlier steps compute; bf16
//     and int8 w widen exactly to fp32 as their fragments are read
//     (nw_widen's permute and add for the codes);
//   * x goes through registers so that it can be stored transposed, [K
//     row][rows], and a thread's rows are one float4 read: each thread
//     loads a 4-row unit of the next sub-tile (a vector a row where x and
//     its row stride allow, else scalar), applies the rmsnorm scale g once
//     per element (x_at's rounding), and stores it as float4 columns after
//     the current sub-tile's products;
//   * the row tiles run along blockIdx.x, so the blocks in flight share
//     w's column tiles and each is read from device memory about once;
//   * ragged M, N and K are zeros in shared memory (cp.async's src-size at
//     the edge chunk, zero stores past it), nothing is padded in device
//     memory; w off the 16-byte grid stages through scalar loads inside
//     the same kernel;
//   * the epilogue is store_one's math (epilogue_one) per element, stored
//     as float4 (fp32) or four bf16 where the row is aligned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB: the most a block may use

enum Dtype { F32 = 0, BF16 = 1, I8 = 2 };   // I8: int8 w, in the queries
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

// The epilogue of one output element (r, c), once, in store_phase order:
// its value before the cast.  The multiplies are __fmul_rn so that nvcc
// does not fuse one with the add after it: each rounds on its own, as in
// the plain version.
template <typename TX, bool DUAL>
__device__ __forceinline__ float epilogue_one(const Args& a, float y,
                                              float y2, int r, int c,
                                              const float* ws,
                                              const float* ws2,
                                              const TX* res) {
  if (ws != nullptr) y = __fmul_rn(y, ws[c]);
  if (a.bias != nullptr) y = __fadd_rn(y, a.bias[c]);
  float o = activate(y, a.activation);
  if (DUAL) {
    if (ws2 != nullptr) y2 = __fmul_rn(y2, ws2[c]);
    if (a.bias2 != nullptr) y2 = __fadd_rn(y2, a.bias2[c]);
    o = __fmul_rn(o, y2);
  }
  if (res != nullptr) o = __fadd_rn(to_f(res[(long long)r * a.ldr + c]), o);
  return o;
}

// ... and its store, with the one cast
template <typename TX, typename TO, bool DUAL>
__device__ __forceinline__ void store_one(const Args& a, float y, float y2,
                                          int r, int c, const float* ws,
                                          const float* ws2, const TX* res,
                                          TO* out) {
  if (r >= a.M || c >= a.N) return;
  out[(long long)r * a.ldo + c] =
      from_f<TO>(epilogue_one<TX, DUAL>(a, y, y2, r, c, ws, ws2, res));
}

// The main loop over a ring of `stages` slots of step_bytes each at shared
// address `ring`: issue(step, slot) stages a step's sub-tiles with
// cp.async (and commits one group), run(step, slot) computes them.  WARP:
// the ring is one warp's own (its lanes stage and compute it), so the
// barriers are the warp's.
template <bool WARP = false>
__device__ __forceinline__ void ring_sync() {
  if (WARP) __syncwarp(); else __syncthreads();
}

template <bool WARP = false, typename Issue, typename Run>
__device__ __forceinline__ void run_ring(uint32_t ring, uint32_t step_bytes,
                                         int stages, int n_steps,
                                         Issue& issue, Run& run) {
  const uint32_t ring_end = ring + step_bytes * stages;
  if (stages >= 2) {
    // single barrier a step: the barrier that makes step j visible also
    // frees the slots of step j - 1, which then take step j + stages - 1
    uint32_t fill = ring, use = ring;
    for (int s = 0; s < stages - 1; ++s, fill += step_bytes) issue(s, fill);
    for (int step = 0; step < n_steps; ++step) {
      tc::cp_async_wait(stages - 2);
      ring_sync<WARP>();
      issue(step + stages - 1, fill);
      fill = fill + step_bytes == ring_end ? ring : fill + step_bytes;
      run(step, use);
      use = use + step_bytes == ring_end ? ring : use + step_bytes;
    }
  } else {
    for (int step = 0; step < n_steps; ++step) {
      ring_sync<WARP>();
      issue(step, ring);
      tc::cp_async_wait(0);
      ring_sync<WARP>();
      run(step, ring);
    }
  }
  tc::cp_async_wait(0);
}

// ---------------------------------------------------------------------------
// FFMA narrow decode tile at M <= 16 rows.  K1: every fp32-x launch of
// af_gemm and of af_gemm_q's W8 form (fp32 or int8-code w, one or two
// contractions, any N); K2, the expert on blockIdx.z: fp32 af_expert_gemm
// at T <= 16 (fp32 or bf16 w), and af_expert_gemm_q's int8-only form at T
// <= 16 (int8 codes, fp32 or bf16 x)

constexpr int NW_SPLIT = 16;        // K slices a block: one warp each
constexpr int NW_THREADS = 32 * NW_SPLIT;
constexpr int NW_BK = 32;           // K rows of one staged sub-tile
constexpr int NW_RING = 8;          // sub-tiles a warp's ring holds (at most)
constexpr int NW_SMS = 132;         // SMs of an H100 SXM
constexpr int NW_FILL = 128;        // blocks that fill the card: one on all
                                    // but 4 of its SMs
constexpr int NW_EXPERT_COLS = 32;  // K2's fp32 / bf16-w width: an fp32 w
                                    // row's 128 bytes

// x row stride (elements) of a staged sub-tile: one 16-byte chunk past the
// 32 K columns, so the rows a warp reads start on other banks
template <typename TX>
__host__ __device__ constexpr int nw_ldx() {
  return NW_BK + 16 / (int)sizeof(TX);
}

// The width (output columns a block) of K1 at M rows, N columns, and of
// K2's int8-only form at T = M rows of `batch` experts: the widest of the
// weight type's widths whose grid (blocks x batch) still fills the card,
// else the narrowest.  fp32 w: 32 (a w row's 128 bytes), 16, 8; int8
// codes: 128 (128 bytes) at M <= 4 only -- a lane keeps rows x columns / 32
// sums, and 16 rows x 4 columns, twice for the dual, would pass the 128
// registers a thread of a 512-thread block may hold -- then 64, 32, 16 (one
// 16-byte chunk of codes).  It depends on M, N, the weight type and the
// batch alone, never on k_collapse, and the sums do not depend on it.
inline int nw_cols(int M, int N, bool int8, int batch = 1) {
  auto fills = [N, batch](int cols) {
    return (long long)(N + cols - 1) / cols * batch >= NW_FILL;
  };
  if (int8) {
    if (M <= 4 && fills(128)) return 128;
    return fills(64) ? 64 : fills(32) ? 32 : 16;
  }
  return fills(32) ? 32 : fills(16) ? 16 : 8;
}

// sub-tiles a warp sums: the K slices are whole 32-row sub-tiles, fixed by
// K alone
__host__ __device__ __forceinline__ int nw_per(int K) {
  const int n_all = (K + NW_BK - 1) / NW_BK;
  return (n_all + NW_SPLIT - 1) / NW_SPLIT;
}

// bytes of one ring slot (one sub-tile): x (M rows), w (and w2), g
template <typename TX, typename TW, int COLS, bool DUAL>
__host__ __device__ __forceinline__ int nw_slot(int M) {
  return (int)sizeof(TX) * M * nw_ldx<TX>() +
         (DUAL ? 2 : 1) * (int)sizeof(TW) * NW_BK * COLS + 4 * NW_BK;
}

// one 16-byte chunk of n valid elements of T at src into shared address d
// (generic pointer dp): a 16-byte cp.async where the source allows, else
// scalar
template <typename T>
__device__ __forceinline__ void nw_chunk(uint32_t d, T* dp, const T* src,
                                         int n, bool vec) {
  constexpr int EPC = 16 / sizeof(T);
  if (vec)
    tc::cp_chunk(d, src, n, EPC);
  else
    for (int e = 0; e < EPC; ++e) dp[e] = e < n ? src[e] : tc::zero<T>();
}

// CPL neighbouring weights of one staged K row, widened exactly to fp32 as
// they leave shared memory: bf16 by its exact conversion; int8 codes
// without I2F (a quarter-rate instruction): a code xor 0x80 is u = code +
// 128, which under the exponent of 2^23 is the float 2^23 + u, and
// subtracting 2^23 + 128 leaves the code -- one permute and one add a
// code, all exact (the reference's w.astype(x.dtype)).
template <typename TW, int CPL>
__device__ __forceinline__ void nw_widen(const TW* p, float (&v)[CPL]) {
  if constexpr (std::is_same<TW, int8_t>::value) {
    uint32_t u;
    if constexpr (CPL == 4)
      u = *reinterpret_cast<const uint32_t*>(p);
    else if constexpr (CPL == 2)
      u = *reinterpret_cast<const uint16_t*>(p);
    else
      u = *reinterpret_cast<const uint8_t*>(p);
    u ^= 0x80808080u;
#pragma unroll
    for (int e = 0; e < CPL; ++e)
      v[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) -
             8388736.0f;
  } else {
#pragma unroll
    for (int e = 0; e < CPL; ++e) v[e] = to_f(p[e]);
  }
}

// The shape of a narrow tile of COLS columns with room for MR rows: a lane
// owns CPL neighbouring columns of RG-strided rows (COLS >= 32: CPL =
// COLS / 32, every row; else one column of every RG-th row, RG = 32 /
// COLS), NR rows at most, and keeps NW x NR x CPL sums.  It takes a full
// sub-tile KV K rows at a time (x as a KV-vector: 4 for a lane of one
// column, 2 for several, so its widened weights stay 2 CPL registers).
// MIN_BLOCKS is the launch bound's blocks an SM: 2 where the sums are few
// (K1 at M <= 4, K2 at up to 16 sums a lane), so the block fits 64
// registers and two share an SM; else 1, so ptxas does not squeeze 16
// rows' sums into 64 registers with spills.
template <typename TW, int COLS, int MR, bool DUAL, bool EXPERT>
struct NwShape {
  static constexpr int CPL = COLS > 32 ? COLS / 32 : 1;
  static constexpr int LPR = COLS / CPL;            // lanes across the tile
  static constexpr int RG = 32 / LPR;
  static constexpr int NR = MR / RG;
  static constexpr int NW = DUAL ? 2 : 1;           // contractions
  static constexpr int KV = CPL == 1 ? 4 : 2;
  static constexpr int MIN_BLOCKS =
      (EXPERT || MR <= 4) && NW * NR * CPL <= 16 ? 2 : 1;
};

// KV consecutive x elements of shared memory (16 bytes for fp32 at KV = 4)
// in one vector load, widened exactly to fp32 (bf16: its bits under the
// high half)
template <int KV>
__device__ __forceinline__ void nw_load(const float* p, float (&v)[KV]) {
  if constexpr (KV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}
template <int KV>
__device__ __forceinline__ void nw_load(const __nv_bfloat16* p,
                                        float (&v)[KV]) {
  if constexpr (KV == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = tc::bf16_lo(t.x);
    v[1] = tc::bf16_hi(t.x);
    v[2] = tc::bf16_lo(t.y);
    v[3] = tc::bf16_hi(t.y);
  } else {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    v[0] = tc::bf16_lo(t);
    v[1] = tc::bf16_hi(t);
  }
}

// One (M x COLS) output tile, TX (fp32, or bf16 for K2's int8-only form) x,
// TW (fp32, bf16 or int8 codes) w, fp32 sums, out fp32 or bf16 (out_bf16).
// x is staged in its own type and widened exactly as it leaves shared
// memory.  Warp s of the block sums K slice s
// (the s-th of NW_SPLIT runs of nw_per(K) whole 32-row sub-tiles, fixed by
// K alone) through a private cp.async ring of `stages` main-loop steps of
// `subs` sub-tiles (x rows, the COLS-column w panel -- and w2's, DUAL --
// and g); a lane (NwShape) keeps each output as an fmaf chain over the
// slice in increasing K order, the weights widened exactly to fp32 as they
// leave shared memory.  The slices' partials then add in slice order and
// the store applies store_one once: dequant (w_scale / w2_scale) -> bias
// -> act -> gate multiply -> residual -> one cast.  So every output is the
// same sum whatever k_collapse, the ring depth, the width or (K2) the
// number of experts.  EXPERT: of batch element blockIdx.z, its operands
// (and its per-column scales) offset before the alignment tests.
template <typename TX, typename TW, int COLS, int MR, bool DUAL, bool EXPERT>
__global__ void __launch_bounds__(
    NW_THREADS, (NwShape<TW, COLS, MR, DUAL, EXPERT>::MIN_BLOCKS))
af_gemm_narrow_kernel(Args a, int subs, int stages, int out_bf16) {
  extern __shared__ __align__(16) unsigned char nw_smem[];
  using Sh = NwShape<TW, COLS, MR, DUAL, EXPERT>;
  constexpr int CPL = Sh::CPL, LPR = Sh::LPR, RG = Sh::RG, NR = Sh::NR;
  constexpr int NW = Sh::NW, KV = Sh::KV;
  constexpr int W_EPC = 16 / sizeof(TW);           // w elements a chunk
  constexpr int W_CPR = COLS / W_EPC;              // chunks a w row
  constexpr int W_ELEMS = NW_BK * COLS;            // one panel's elements
  constexpr int W_BYTES = sizeof(TW) * W_ELEMS;
  constexpr int X_EPC = 16 / sizeof(TX);           // x elements a chunk
  constexpr int LDX = nw_ldx<TX>();
  // a full sub-tile's K loop: unrolled for a lane of one column, but kept
  // rolled where its sums and widened weights reach 32 registers; 4 steps
  // unrolled for a lane of several columns
  constexpr int KB_UNROLL =
      CPL > 1 ? 4 : NW * (NR + 4) >= 32 ? 1 : NW_BK / KV;
  static_assert(COLS % W_EPC == 0 && LPR * RG == 32 && MR % RG == 0 &&
                MR <= 16, "narrow tile shape");
  const int M = a.M, N = a.N, K = a.K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / LPR, c0 = (lane % LPR) * CPL;
  const int n0 = blockIdx.x * COLS;
  const long long z = EXPERT ? blockIdx.z : 0;
  const TX* x = static_cast<const TX*>(a.x) + z * a.bsx;
  const TW* w = static_cast<const TW*>(a.w) + z * a.bsw;
  const TW* w2 = static_cast<const TW*>(a.w2);     // K1's dual only
  const float* g = a.g;
  const bool xvec =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && a.ldx % X_EPC == 0;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    a.ldw % W_EPC == 0 &&
                    (!DUAL || reinterpret_cast<uintptr_t>(w2) % 16 == 0);
  const bool gvec = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int x_bytes = (int)sizeof(TX) * M * LDX;
  const int slot = nw_slot<TX, TW, COLS, DUAL>(M);
  // this warp's K slice: sub-tiles [sub0, sub0 + n_sub)
  const int n_all = (K + NW_BK - 1) / NW_BK;
  const int per = nw_per(K);
  const int sub0 = warp * per;
  const int n_sub = max(0, min(per, n_all - sub0));
  const int n_steps = (n_sub + subs - 1) / subs;
  const uint32_t step_bytes = (uint32_t)slot * subs;
  const uint32_t ring = tc::smem_addr(nw_smem) + warp * stages * step_bytes;
  unsigned char* const base_ptr = nw_smem + warp * stages * step_bytes;

  auto stage = [&](int sub, uint32_t b) {
    const int k0 = (sub0 + sub) * NW_BK;
    unsigned char* bp = base_ptr + (b - ring);
    for (int i = lane; i < M * (NW_BK / X_EPC); i += 32) {    // x rows
      const int rr = i / (NW_BK / X_EPC), cc = X_EPC * (i % (NW_BK / X_EPC));
      const int o = (int)sizeof(TX) * (rr * LDX + cc);
      nw_chunk(b + o, reinterpret_cast<TX*>(bp + o),
               x + (long long)rr * a.ldx + k0 + cc, K - k0 - cc, xvec);
    }
    for (int i = lane; i < W_CPR * NW_BK; i += 32) {          // w panel(s)
      const int rr = i / W_CPR, cc = W_EPC * (i % W_CPR), gk = k0 + rr;
      const int o = x_bytes + (int)sizeof(TW) * (rr * COLS + cc);
      const long long off = (long long)gk * a.ldw + n0 + cc;
      const int n = gk < K ? min(W_EPC, N - n0 - cc) : 0;
      nw_chunk(b + o, reinterpret_cast<TW*>(bp + o), w + off, n, wvec);
      if (DUAL)
        nw_chunk(b + o + W_BYTES, reinterpret_cast<TW*>(bp + o + W_BYTES),
                 w2 + off, n, wvec);
    }
    if (g != nullptr && lane < NW_BK / 4) {                  // g
      const int cc = 4 * lane, o = x_bytes + NW * W_BYTES + 4 * cc;
      nw_chunk(b + o, reinterpret_cast<float*>(bp + o), g + k0 + cc,
               K - k0 - cc, gvec);
    }
  };

  float acc[NW][NR][CPL];               // rows rl, rl + RG, ...; CPL columns
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[v][j][c] = 0.f;
  auto compute = [&](int sub, uint32_t b) {
    const unsigned char* S = base_ptr + (b - ring);
    const TX* X = reinterpret_cast<const TX*>(S);
    const TW* Ws = reinterpret_cast<const TW*>(S + x_bytes) + c0;
    const float* Gs = reinterpret_cast<const float*>(S + x_bytes + NW * W_BYTES);
    const int nk = min(NW_BK, K - (sub0 + sub) * NW_BK);
    if (nk == NW_BK) {
#pragma unroll (KB_UNROLL)
      for (int kb = 0; kb < NW_BK; kb += KV) {
        float wv[NW][KV][CPL];
#pragma unroll
        for (int v = 0; v < NW; ++v)
#pragma unroll
          for (int e = 0; e < KV; ++e)
            nw_widen<TW, CPL>(Ws + v * W_ELEMS + (kb + e) * COLS, wv[v][e]);
        float gv[KV] = {};
        if (g != nullptr) nw_load<KV>(Gs + kb, gv);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          if (rl + RG * j >= M) break;
          float xv[KV];
          nw_load<KV>(X + (rl + RG * j) * LDX + kb, xv);
          if (g != nullptr)       // the prologue: x_at's fp32 product
#pragma unroll
            for (int e = 0; e < KV; ++e)
              xv[e] = to_f(from_f<TX>(__fmul_rn(xv[e], gv[e])));
#pragma unroll
          for (int v = 0; v < NW; ++v)
#pragma unroll
            for (int c = 0; c < CPL; ++c)
#pragma unroll
              for (int e = 0; e < KV; ++e)
                acc[v][j][c] = fmaf(xv[e], wv[v][e][c], acc[v][j][c]);
        }
      }
    } else {
      for (int kb = 0; kb < nk; ++kb) {
        float wv[NW][CPL];
#pragma unroll
        for (int v = 0; v < NW; ++v)
          nw_widen<TW, CPL>(Ws + v * W_ELEMS + kb * COLS, wv[v]);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          if (rl + RG * j >= M) break;
          const TX* Xs = X + (rl + RG * j) * LDX;
          const float xv = g != nullptr
                               ? to_f(from_f<TX>(__fmul_rn(to_f(Xs[kb]), Gs[kb])))
                               : to_f(Xs[kb]);
#pragma unroll
          for (int v = 0; v < NW; ++v)
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[v][j][c] = fmaf(xv, wv[v][c], acc[v][j][c]);
        }
      }
    }
  };

  auto issue = [&](int step, uint32_t b) {
    if (step < n_steps)
      for (int s = 0, sub = step * subs; s < subs && sub < n_sub; ++s, ++sub)
        stage(sub, b + s * slot);
    tc::cp_async_commit();
  };
  auto run = [&](int step, uint32_t b) {
    for (int s = 0, sub = step * subs; s < subs && sub < n_sub; ++s, ++sub)
      compute(sub, b + s * slot);
  };
  run_ring<true>(ring, step_bytes, stages, n_steps, issue, run);

  // the slices' partials, [contraction][slice][M rows][COLS], over the rings
  __syncthreads();
  float* P = reinterpret_cast<float*>(nw_smem);
  const int pz = NW_SPLIT * M * COLS;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    if (rl + RG * j >= M) break;
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        P[v * pz + (warp * M + rl + RG * j) * COLS + c0 + c] = acc[v][j][c];
  }
  __syncthreads();
  const TX* res = static_cast<const TX*>(a.residual);
  const float* ws = a.w_scale != nullptr ? a.w_scale + z * a.bss : nullptr;
  for (int i = threadIdx.x; i < M * COLS; i += NW_THREADS) {
    const int r = i / COLS, c = i % COLS;
    float y = P[i], y2 = DUAL ? P[pz + i] : 0.f;
    for (int sl = 1; sl < NW_SPLIT; ++sl) {
      y = __fadd_rn(y, P[sl * M * COLS + i]);
      if (DUAL) y2 = __fadd_rn(y2, P[pz + sl * M * COLS + i]);
    }
    if (out_bf16)
      store_one<TX, __nv_bfloat16, DUAL>(
          a, y, y2, r, n0 + c, ws, a.w2_scale, res,
          static_cast<__nv_bfloat16*>(a.out) + z * a.bso);
    else
      store_one<TX, float, DUAL>(a, y, y2, r, n0 + c, ws, a.w2_scale, res,
                                 static_cast<float*>(a.out) + z * a.bso);
  }
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

// ---------------------------------------------------------------------------
// W8A8 narrow decode tile at M <= 16 rows (K1's af_gemm_q and K2's
// af_expert_gemm_q with act_quant; the expert on blockIdx.z)

constexpr int QW_BATCH = 2;         // prologue pieces a lane loads at once

// The shape of a W8A8 narrow tile of COLS columns with room for MR rows: a
// lane owns CPL neighbouring columns (COLS / 32, at least 1) of every row;
// at COLS = 16 the two half-warps take alternate 4-row groups of each
// sub-tile (KS = 2), so no lane idles at M = 1.  MIN_BLOCKS as NwShape's.
template <int COLS, int MR, bool DUAL>
struct QwShape {
  static constexpr int CPL = COLS >= 32 ? COLS / 32 : 1;
  static constexpr int LPC = COLS / CPL;          // lanes across the columns
  static constexpr int KS = 32 / LPC;             // lane groups across K
  static constexpr int NW = DUAL ? 2 : 1;
  static constexpr int MIN_BLOCKS = NW * MR * CPL <= 16 ? 2 : 1;
};

// What the host fixes for one launch: S reference steps of quant_kk
// columns, each a whole number of NW_BK-row sub-tiles (sps, the last one
// zero-padded), taken `round` steps at a time; `stages` ring slots a warp;
// the byte offsets of the partials, the steps' amax and the rings.
struct QwPlan {
  int steps, sps, round, stages;
  int p_off, amax_off, ring_off;
};

// Four K-consecutive codes of each of a lane's CPL columns, one dp4a
// operand a column: rows p, p + ld, p + 2 ld, p + 3 ld of CPL bytes each,
// a 4 x CPL byte block transposed in registers (ldmatrix moves 16-bit
// elements and cannot transpose bytes).
template <int CPL>
__device__ __forceinline__ void qw_col4(const int8_t* p, int ld,
                                        uint32_t (&v)[CPL]) {
  if constexpr (CPL == 4) {
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + ld);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * ld);
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * ld);
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);   // c0 c0 c1 c1
    const uint32_t t1 = __byte_perm(r0, r1, 0x7362);   // c2 c2 c3 c3
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    v[0] = __byte_perm(t0, t2, 0x5410);
    v[1] = __byte_perm(t0, t2, 0x7632);
    v[2] = __byte_perm(t1, t3, 0x5410);
    v[3] = __byte_perm(t1, t3, 0x7632);
  } else if constexpr (CPL == 2) {
    const uint32_t r0 = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t r1 = *reinterpret_cast<const uint16_t*>(p + ld);
    const uint32_t r2 = *reinterpret_cast<const uint16_t*>(p + 2 * ld);
    const uint32_t r3 = *reinterpret_cast<const uint16_t*>(p + 3 * ld);
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
    v[0] = __byte_perm(t0, t2, 0x5410);
    v[1] = __byte_perm(t0, t2, 0x7632);
  } else {
    const uint32_t r0 = *reinterpret_cast<const uint8_t*>(p);
    const uint32_t r1 = *reinterpret_cast<const uint8_t*>(p + ld);
    const uint32_t r2 = *reinterpret_cast<const uint8_t*>(p + 2 * ld);
    const uint32_t r3 = *reinterpret_cast<const uint8_t*>(p + 3 * ld);
    v[0] = __byte_perm(__byte_perm(r0, r1, 0x0040),
                       __byte_perm(r2, r3, 0x0040), 0x5410);
  }
}

// One (M x COLS) output tile of batch element blockIdx.z (K2's expert; 0
// for K1, whose batch strides are 0), W8A8 on int8 codes w (and w2), x of
// TX, out fp32 or bf16 (out_bf16).  Per round of whole reference steps:
//   * every warp primes its ring with its first sub-tiles of w codes;
//   * prologue: the round's x, as pieces of one step's row by 128 columns
//     (4 neighbours a lane), in contiguous runs a warp, read with x_at (the
//     rmsnorm prologue) QW_BATCH pieces at a time, all loads issued before
//     any is used; the amax of each step over all M rows
//     (warp maxima combined by atomicMax on the float bits, exact for
//     |x|), then, after a barrier, every element quantized with
//     quant_code into shared memory, each step padded with zero codes to
//     whole sub-tiles;
//   * main loop: warp s sums the s-th run of the round's sub-tiles through
//     its own cp.async ring: four K rows of each of its columns transposed
//     in registers (qw_col4), one __dp4a a row and column against the
//     broadcast word of four x codes, into int32 sums; where its run
//     passes a step boundary, and at its end, it adds them into the step's
//     partials with shared-memory atomicAdd (integer: exact in any order);
//   * fold: each output takes acc + float(iacc) * scale step by step in
//     increasing order (__fmul_rn / __fadd_rn, the plain version's fold).
// After the last round, store_one once per output.  The codes, the scales,
// every step's int32 partial and the fold are the plain version's, so the
// output is its bits, at every width, ring depth, round size and E.
template <typename TX, int COLS, int MR, bool DUAL>
__global__ void __launch_bounds__(NW_THREADS,
                                  (QwShape<COLS, MR, DUAL>::MIN_BLOCKS))
af_gemm_w8a8_narrow_kernel(Args a, QwPlan p, int out_bf16) {
  extern __shared__ __align__(16) unsigned char qw_smem[];
  using Sh = QwShape<COLS, MR, DUAL>;
  constexpr int CPL = Sh::CPL, LPC = Sh::LPC, KS = Sh::KS, NW = Sh::NW;
  constexpr int W_CPR = COLS / 16;                 // 16-byte chunks a w row
  constexpr int W_BYTES = NW_BK * COLS;            // one panel's codes
  constexpr int SLOT = NW * W_BYTES;
  constexpr int OPT = (MR * COLS + NW_THREADS - 1) / NW_THREADS;
  static_assert(COLS % 16 == 0 && LPC * KS == 32 && (NW_BK / 4) % KS == 0 &&
                MR <= 16, "W8A8 narrow tile shape");
  const int M = a.M, N = a.N, K = a.K, kk = a.quant_kk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = (lane % LPC) * CPL, kh = lane / LPC;
  const int n0 = blockIdx.x * COLS;
  const long long z = blockIdx.z;
  const TX* x = static_cast<const TX*>(a.x) + z * a.bsx;
  const int8_t* w = static_cast<const int8_t*>(a.w) + z * a.bsw;
  const int8_t* w2 = static_cast<const int8_t*>(a.w2);   // K1's dual only
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    a.ldw % 16 == 0 &&
                    (!DUAL || reinterpret_cast<uintptr_t>(w2) % 16 == 0);
  const int kkp = p.sps * NW_BK;                   // a step's code columns
  const int ldc = p.round * kkp;                   // codes row stride
  int8_t* const codes = reinterpret_cast<int8_t*>(qw_smem);
  int* const P = reinterpret_cast<int*>(qw_smem + p.p_off);
  unsigned* const amax = reinterpret_cast<unsigned*>(qw_smem + p.amax_off);
  const uint32_t ring = tc::smem_addr(qw_smem) + p.ring_off +
                        warp * p.stages * SLOT;
  unsigned char* const ring_ptr =
      qw_smem + p.ring_off + warp * p.stages * SLOT;
  const uint32_t ring_end = ring + p.stages * SLOT;
  auto scale_of = [&](int sl) {     // times fp32(1/127), as the reference's
    return __fmul_rn(fmaxf(__uint_as_float(amax[sl]), 1e-12f),  // compiled
                     1.0f / 127.0f);                             // quantizer
  };

  float facc[NW][OPT];
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int j = 0; j < OPT; ++j) facc[v][j] = 0.f;

  for (int s0 = 0; s0 < p.steps; s0 += p.round) {
    const int R = min(p.round, p.steps - s0);
    const int last_w = min(kk, K - (s0 + R - 1) * kk);
    const int n_all = (R - 1) * p.sps + (last_w + NW_BK - 1) / NW_BK;
    const int per = (n_all + NW_SPLIT - 1) / NW_SPLIT;
    const int sub0 = warp * per;
    const int n_sub = max(0, min(per, n_all - sub0));

    auto issue = [&](int j, uint32_t b) {
      if (j < n_sub) {
        const int sub = sub0 + j, sl = sub / p.sps;
        const int o = (sub - sl * p.sps) * NW_BK;
        const int k0 = (s0 + sl) * kk + o;
        const int nk = min(kk, K - (s0 + sl) * kk) - o;   // rows of the step
        unsigned char* bp = ring_ptr + (b - ring);
        for (int i = lane; i < W_CPR * NW_BK; i += 32) {
          const int rr = i / W_CPR, cc = 16 * (i % W_CPR), d = rr * COLS + cc;
          const long long off = (long long)(k0 + rr) * a.ldw + n0 + cc;
          const int n = rr < nk ? min(16, N - n0 - cc) : 0;
          nw_chunk(b + d, reinterpret_cast<int8_t*>(bp + d), w + off, n,
                   wvec);
          if (DUAL)
            nw_chunk(b + d + W_BYTES,
                     reinterpret_cast<int8_t*>(bp + d + W_BYTES), w2 + off, n,
                     wvec);
        }
      }
      tc::cp_async_commit();
    };

    // the ring: the first sub-tiles fly while the block quantizes x
    uint32_t fill = ring, use = ring;
    for (int j = 0; j < max(1, p.stages - 1); ++j, fill += SLOT)
      issue(j, fill);
    if (fill == ring_end) fill = ring;
    for (int i = threadIdx.x; i < NW * R * M * COLS; i += NW_THREADS)
      P[(i / (R * M * COLS)) * p.round * M * COLS + i % (R * M * COLS)] = 0;
    for (int i = threadIdx.x; i < R; i += NW_THREADS) amax[i] = 0u;
    __syncthreads();

    // prologue: warp s takes the s-th run of the (step, row, group) pieces
    const int gps = (kkp + 127) / 128;             // groups a step's row
    const int n_pcs = R * M * gps;
    const int ppw = (n_pcs + NW_SPLIT - 1) / NW_SPLIT;
    const int p0 = warp * ppw, p1 = min(n_pcs, p0 + ppw);
    // a warp's walk over its run's pieces: piece b is step sl, row r, group
    // g (warp-uniform; the lane's 4 step columns start at 128 g + 4 lane)
    auto seek = [&](int b, int& sl, int& r, int& g) {
      sl = b / (M * gps);
      r = (b - sl * M * gps) / gps;
      g = b - (sl * M + r) * gps;
    };
    auto step_on = [&](int& sl, int& r, int& g) {
      if (++g == gps) {
        g = 0;
        if (++r == M) {
          r = 0;
          ++sl;
        }
      }
    };
    // x_at of the 4 columns of each piece of a batch from piece b (0 past
    // the step or the run), every load issued before any is used
    auto load = [&](int b, float (&v)[QW_BATCH][4]) {
      int sl, r, g;
      seek(b, sl, r, g);
#pragma unroll
      for (int i = 0; i < QW_BATCH; ++i) {
        const int cs = (s0 + sl) * kk, ws_ = min(kk, K - cs);
        const int cl = 128 * g + 4 * lane;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[i][e] = b + i < p1 && cl + e < ws_ ? x_at(a, x, r, cs + cl + e)
                                               : 0.f;
        step_on(sl, r, g);
      }
    };
    int held = -1;                                  // step of m
    float m = 0.f;
    auto flush_max = [&]() {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) atomicMax(&amax[held], __float_as_uint(m));
      m = 0.f;
    };
    for (int b = p0; b < p1; b += QW_BATCH) {
      float v[QW_BATCH][4];
      load(b, v);
      int sl, r, g;
      seek(b, sl, r, g);
#pragma unroll
      for (int i = 0; i < QW_BATCH; ++i) {
        if (b + i >= p1) break;
        if (sl != held) {
          if (held >= 0) flush_max();
          held = sl;
        }
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v[i][0]), fabsf(v[i][1])),
                           fmaxf(fabsf(v[i][2]), fabsf(v[i][3]))));
        step_on(sl, r, g);
      }
    }
    if (held >= 0) flush_max();
    __syncthreads();
    for (int b = p0; b < p1; b += QW_BATCH) {      // x again, from L1 or L2
      float v[QW_BATCH][4];
      load(b, v);
      int sl, r, g;
      seek(b, sl, r, g);
#pragma unroll
      for (int i = 0; i < QW_BATCH; ++i) {
        if (b + i >= p1) break;
        const int cl = 128 * g + 4 * lane;
        if (cl < kkp) {
          const float scale = scale_of(sl);
          const int ws_ = min(kk, K - (s0 + sl) * kk);
          int q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            q[e] = cl + e < ws_ ? quant_code(v[i][e], scale) : 0;
          *reinterpret_cast<int*>(codes + r * ldc + sl * kkp + cl) = pack4(q);
        }
        step_on(sl, r, g);
      }
    }
    __syncthreads();                    // codes and amax

    // main loop
    int iacc[NW][MR][CPL];
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) iacc[v][r][c] = 0;
    int cur = sub0 / p.sps;                        // step of the sums held
    auto flush = [&]() {
#pragma unroll
      for (int v = 0; v < NW; ++v)
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r >= M) break;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            int val = iacc[v][r][c];
            if (KS == 2) val += __shfl_xor_sync(0xffffffffu, val, 16);
            if (kh == 0)
              atomicAdd(&P[((v * p.round + cur) * M + r) * COLS + c0 + c],
                        val);
            iacc[v][r][c] = 0;
          }
        }
    };
    auto run = [&](int j, uint32_t b) {
      const int sub = sub0 + j, sl = sub / p.sps;
      if (sl != cur) {
        flush();
        cur = sl;
      }
      const int8_t* Ws =
          reinterpret_cast<const int8_t*>(ring_ptr + (b - ring)) + c0;
      const int8_t* X = codes + sl * kkp + (sub - sl * p.sps) * NW_BK;
#pragma unroll
      for (int qi = 0; qi < NW_BK / 4 / KS; ++qi) {
        const int q = qi * KS + kh;
        uint32_t wq[NW][CPL];
#pragma unroll
        for (int v = 0; v < NW; ++v)
          qw_col4<CPL>(Ws + v * W_BYTES + 4 * q * COLS, COLS, wq[v]);
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r >= M) break;
          const int xw = *reinterpret_cast<const int*>(X + r * ldc + 4 * q);
#pragma unroll
          for (int v = 0; v < NW; ++v)
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              iacc[v][r][c] = __dp4a(xw, (int)wq[v][c], iacc[v][r][c]);
        }
      }
    };
    for (int j = 0; j < n_sub; ++j) {
      if (p.stages >= 2) {
        // sub-tile j has landed; every lane is done with slot j - 1,
        // which takes sub-tile j + stages - 1
        tc::cp_async_wait(p.stages - 2);
        __syncwarp();
        issue(j + p.stages - 1, fill);
        fill = fill + SLOT == ring_end ? ring : fill + SLOT;
      } else {
        tc::cp_async_wait(0);
        __syncwarp();
      }
      run(j, use);
      use = use + SLOT == ring_end ? ring : use + SLOT;
      if (p.stages == 1) {
        __syncwarp();
        issue(j + 1, ring);
      }
    }
    tc::cp_async_wait(0);
    if (n_sub > 0) flush();
    __syncthreads();

    // fold the round's steps in increasing order
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int i = threadIdx.x + j * NW_THREADS;
      if (i < M * COLS)
        for (int sl = 0; sl < R; ++sl)
#pragma unroll
          for (int v = 0; v < NW; ++v)
            facc[v][j] = __fadd_rn(
                facc[v][j],
                __fmul_rn((float)P[(v * p.round + sl) * M * COLS + i],
                          scale_of(sl)));
    }
    if (s0 + R < p.steps) __syncthreads();    // P and amax are reused
  }

  const TX* res = static_cast<const TX*>(a.residual);
  const float* ws = a.w_scale + z * a.bss;
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int i = threadIdx.x + j * NW_THREADS;
    if (i >= M * COLS) continue;
    const int r = i / COLS, c = n0 + i % COLS;
    const float y2 = DUAL ? facc[DUAL ? 1 : 0][j] : 0.f;
    if (out_bf16)
      store_one<TX, __nv_bfloat16, DUAL>(
          a, facc[0][j], y2, r, c, ws, a.w2_scale, res,
          static_cast<__nv_bfloat16*>(a.out) + z * a.bso);
    else
      store_one<TX, float, DUAL>(a, facc[0][j], y2, r, c, ws, a.w2_scale,
                                 res, static_cast<float*>(a.out) + z * a.bso);
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16 operands)

constexpr int TC_BK = 32;            // K columns of one staged sub-tile
constexpr int TC_MAX_STAGES = 4;     // main-loop steps the ring holds

template <int BM, int BN, bool DUAL, bool QUANT = false>
struct TcLayout {                    // one ring slot
  static constexpr int LDA = TC_BK + 8;   // padded rows (elements): the 8
  // row addresses of an ldmatrix land on distinct banks; int8 codes (QUANT)
  // pad by one 16-byte chunk, so the four K rows a fragment's byte loads
  // touch land on distinct banks too
  static constexpr int LDB = QUANT ? BN + 16 : BN + 8;
  static constexpr int W_SIZE = QUANT ? 1 : 2;   // bytes of a staged weight
  static constexpr int A_BYTES = 2 * BM * LDA;
  static constexpr int B_BYTES = W_SIZE * TC_BK * LDB;
  static constexpr int G_OFF = A_BYTES + B_BYTES * (DUAL ? 2 : 1);
  static constexpr int SLOT = G_OFF + 4 * TC_BK;  // + the sub-tile's g
  // the fp32 output tile(s) the epilogue reads, over the ring
  static constexpr int LDC = BN + 8;
  static constexpr int CTILE = BM * LDC * (DUAL ? 2 : 1);   // floats
  // the ring's budget: a prefill tile's about half the SM's shared memory
  // (two blocks an SM); a decode tile's 32 KB, so that enough 4-warp
  // blocks share an SM to keep W streaming (fewer stages at a deep k)
  static constexpr size_t BUDGET = BM <= 16 ? 32768 : 115712;
};

// One thread's share of staging a ROWS x COLS tile of ESIZE-byte elements
// (bf16, or int8 codes) in 16-byte chunks, its chunks' shared offsets and
// global addresses computed once.
template <int ROWS, int COLS, int NTHR, int ESIZE = 2>
struct Chunks {
  static constexpr int EPC = 16 / ESIZE;   // elements per chunk
  static constexpr int CPR = COLS / EPC;
  static constexpr int N = (ROWS * CPR + NTHR - 1) / NTHR;
  uint32_t off[N];   // byte offset in the tile
  int r[N], c[N];    // tile row and column of the chunk (r = -1: none)
  __device__ void init(int lds) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * NTHR;
      r[j] = i < ROWS * CPR ? i / CPR : -1;
      c[j] = (i % CPR) * EPC;
      off[j] = ESIZE * (r[j] * lds + c[j]);
    }
  }
};

// The B fragment (b0, b1) of one n8 tile at K offset kk from int8 codes
// staged row-major (row stride ldb bytes) in shared memory: lane 4 g + t
// reads codes (kk + 2t, col), (kk + 2t + 1, col), (kk + 2t + 8, col),
// (kk + 2t + 9, col) for col = n0 + g and widens each to bf16 (exact:
// |code| <= 127 has at most 7 significant bits).
__device__ __forceinline__ void b_frag_int8(uint32_t& b0, uint32_t& b1,
                                            const int8_t* B, int ldb, int kk,
                                            int n0, int lane) {
  const int8_t* p = B + (kk + 2 * (lane % 4)) * ldb + n0 + lane / 4;
  b0 = tc::pack_bf16((float)p[0], (float)p[ldb]);
  b1 = tc::pack_bf16((float)p[8 * ldb], (float)p[9 * ldb]);
}

__device__ __forceinline__ uint32_t prologue2(uint32_t v, float2 g) {
  // x_at's rounding on two packed bf16: x * g in fp32, back to bf16
  return tc::pack_bf16(tc::bf16_lo(v) * g.x, tc::bf16_hi(v) * g.y);
}

// The epilogue of one output pair (r, c), (r, c + 1), c even: the same
// per-element math as store_one, one paired store where both columns
// exist and the pair is aligned.  QUANT: the per-column scales ws (ws2)
// dequantize the accumulators first.
template <typename TO, bool DUAL, bool QUANT>
__device__ __forceinline__ void store_pair(const Args& a, const float (&y)[2],
                                           const float (&y2)[2], int r, int c,
                                           const float* ws, const float* ws2,
                                           const tc::bf16* res, TO* out,
                                           bool pairs) {
  if (r >= a.M || c >= a.N) return;
  if (!pairs || c + 1 >= a.N) {
    for (int e = 0; e < 2; ++e)
      store_one<tc::bf16, TO, DUAL>(a, y[e], y2[e], r, c + e,
                                    QUANT ? ws : nullptr,
                                    QUANT ? ws2 : nullptr, res, out);
    return;
  }
  float o[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float v = y[e];
    if constexpr (QUANT) v = __fmul_rn(v, ws[c + e]);
    if (a.bias != nullptr) v = __fadd_rn(v, a.bias[c + e]);
    o[e] = activate(v, a.activation);
    if (DUAL) {
      float v2 = y2[e];
      if constexpr (QUANT) v2 = __fmul_rn(v2, ws2[c + e]);
      if (a.bias2 != nullptr) v2 = __fadd_rn(v2, a.bias2[c + e]);
      o[e] = __fmul_rn(o[e], v2);
    }
  }
  if (res != nullptr) {
    const uint32_t rv =
        *reinterpret_cast<const uint32_t*>(res + (long long)r * a.ldr + c);
    o[0] = __fadd_rn(tc::bf16_lo(rv), o[0]);
    o[1] = __fadd_rn(tc::bf16_hi(rv), o[1]);
  }
  TO* d = out + (long long)r * a.ldo + c;
  if constexpr (sizeof(TO) == 4)
    *reinterpret_cast<float2*>(d) = make_float2(o[0], o[1]);
  else
    *reinterpret_cast<uint32_t*>(d) = tc::pack_bf16(o[0], o[1]);
}

// One (BM x BN) output tile in WM x WN warps, bf16 x, fp32 fragments;
// `stages` main-loop steps of k_collapse sub-tiles in the ring.  EXPERT: of
// batch element blockIdx.z (K2); K1's instantiations keep their operand
// pointers in the parameter space (a batch offset costs the 128 x 128
// tile, at its register budget, 3-8% at the prefill sites).  QUANT: w (w2)
// are int8 codes, staged as codes (16 a chunk), widened to bf16 as the B
// fragments are built and dequantized by the per-column scales at the
// store (K1's W8 form, af_gemm_q_tc; with EXPERT, K2's int8-only MoE banks
// above 16 rows, af_expert_gemm_q_tc, each expert's scales offset by bss);
// otherwise bf16.
template <typename TO, int BM, int BN, int WM, int WN, bool DUAL, bool EXPERT,
          bool QUANT = false>
__global__ void __launch_bounds__(WM * WN * 32)
af_gemm_tc_kernel(Args a, int stages) {
  using L = TcLayout<BM, BN, DUAL, QUANT>;
  using tc::bf16;
  using TW = typename std::conditional<QUANT, int8_t, bf16>::type;
  constexpr int NTHR = WM * WN * 32;
  constexpr int TMW = BM / WM, TNW = BN / WN;   // a warp's tile
  constexpr int MT = TMW / 16, NT = TNW / 8;    // its m16 / n8 tiles
  // decode-sized warp tiles load both k16 halves' fragments of a sub-tile
  // before their products, so the ldmatrix latencies overlap
  constexpr bool BATCH = MT * NT <= 2;
  constexpr int KH = TC_BK / 16;
  static_assert(TMW % 16 == 0 && (NT == 1 || NT % 2 == 0), "warp tile");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t ring = tc::smem_addr(tc_smem);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, K = a.K, kc = a.k_collapse;
  // K2: batch element blockIdx.z (an expert, or a batch x kv-head), offset
  // before the alignment tests, so each element's base decides its own
  // staging path
  const long long z = EXPERT ? blockIdx.z : 0;
  const bf16* x = static_cast<const bf16*>(a.x) + z * a.bsx;
  const TW* w = static_cast<const TW*>(a.w) + z * a.bsw;
  const TW* w2 = static_cast<const TW*>(a.w2);
  const float* g = a.g;
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && a.ldx % 8 == 0;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    a.ldw % (16 / sizeof(TW)) == 0 &&
                    (!DUAL || reinterpret_cast<uintptr_t>(w2) % 16 == 0);
  const bool gvec = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int n_sub = (K + TC_BK - 1) / TC_BK;
  const int n_steps = (n_sub + kc - 1) / kc;

  using XC = Chunks<BM, TC_BK, NTHR>;
  using WC = Chunks<TC_BK, BN, NTHR, sizeof(TW)>;
  XC xs;
  WC ws;
  xs.init(L::LDA);
  ws.init(L::LDB);
  const bf16* xp[XC::N];
  int x_ok[XC::N];                     // the chunk's row exists
  long long wo[WC::N];                 // the chunk's column offset in W
  int w_n[WC::N];                      // its valid columns
#pragma unroll
  for (int j = 0; j < XC::N; ++j) {
    x_ok[j] = xs.r[j] >= 0 && m0 + xs.r[j] < M;
    xp[j] = x + (x_ok[j] ? (long long)(m0 + xs.r[j]) * a.ldx + xs.c[j] : 0);
  }
#pragma unroll
  for (int j = 0; j < WC::N; ++j) {
    w_n[j] = ws.r[j] >= 0 ? min(WC::EPC, N - n0 - ws.c[j]) : 0;
    wo[j] = (long long)max(ws.r[j], 0) * a.ldw + n0 + ws.c[j];
  }

  float acc[MT][NT][4];
  float acc2[DUAL ? MT : 1][DUAL ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        if (DUAL) acc2[DUAL ? i : 0][DUAL ? j : 0][e] = 0.f;
      }

  // stage one sub-tile (x, w, w2 and g columns k0..k0+31) into a slot
  auto stage = [&](int sub, uint32_t slot) {
    const int k0 = sub * TC_BK;
    if (xvec) {
#pragma unroll
      for (int j = 0; j < XC::N; ++j)
        if (xs.r[j] >= 0)
          tc::cp_chunk(slot + xs.off[j], xp[j] + k0,
                       x_ok[j] ? K - k0 - xs.c[j] : 0, 8);
    } else {
      tc::stage_tile<BM, TC_BK, NTHR>(
          reinterpret_cast<bf16*>(tc_smem + (slot - ring)), L::LDA, x, a.ldx,
          m0, M, k0, K, false);
    }
    if (wvec) {
      const long long kofs = (long long)k0 * a.ldw;
#pragma unroll
      for (int j = 0; j < WC::N; ++j) {
        if (ws.r[j] < 0) continue;
        const int n = k0 + ws.r[j] < K ? w_n[j] : 0;
        tc::cp_chunk(slot + L::A_BYTES + ws.off[j], w + kofs + wo[j], n,
                     WC::EPC);
        if (DUAL)
          tc::cp_chunk(slot + L::A_BYTES + L::B_BYTES + ws.off[j],
                       w2 + kofs + wo[j], n, WC::EPC);
      }
    } else {
      TW* base = reinterpret_cast<TW*>(tc_smem + (slot - ring) + L::A_BYTES);
      tc::stage_tile<TC_BK, BN, NTHR>(base, L::LDB, w, a.ldw, k0, K, n0, N,
                                      false);
      if (DUAL)
        tc::stage_tile<TC_BK, BN, NTHR>(base + L::B_BYTES / sizeof(TW),
                                        L::LDB, w2, a.ldw, k0, K, n0, N,
                                        false);
    }
    if (g != nullptr && threadIdx.x < TC_BK / 4) {
      const int c = k0 + 4 * threadIdx.x;
      const uint32_t d = slot + L::G_OFF + 16 * threadIdx.x;
      if (gvec) {
        tc::cp_chunk(d, c < K ? g + c : g, K - c, 4);
      } else {
        float* gd = reinterpret_cast<float*>(tc_smem + (d - ring));
        for (int e = 0; e < 4; ++e) gd[e] = c + e < K ? g[c + e] : 0.f;
      }
    }
  };

  // the products of one staged sub-tile, k16 by k16, in K order
  auto compute = [&](int sub, uint32_t slot) {
    const unsigned char* S = tc_smem + (slot - ring);
    const bf16* As = reinterpret_cast<const bf16*>(S);
    const bf16* Bs = reinterpret_cast<const bf16*>(S + L::A_BYTES);
    const float* Gs = reinterpret_cast<const float*>(S + L::G_OFF);
    const int k0 = sub * TC_BK;
    const int brow = lane % 8 + ((lane / 8) % 2) * 8;
    uint32_t af[BATCH ? KH : 1][MT][4];
    uint32_t bf[BATCH ? KH : 1][NT][2], bf2[BATCH ? KH : 1][NT][2];
    auto load = [&](int kk, int h) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::ldmatrix_x4(af[h][mt], As + (wm * TMW + mt * 16 + lane % 16) *
                                            L::LDA + kk + (lane / 16) * 8);
      if (g != nullptr) {
        const float2 g01 = *reinterpret_cast<const float2*>(Gs + kk + 2 * (lane % 4));
        const float2 g89 = *reinterpret_cast<const float2*>(Gs + kk + 8 + 2 * (lane % 4));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          af[h][mt][0] = prologue2(af[h][mt][0], g01);
          af[h][mt][1] = prologue2(af[h][mt][1], g01);
          af[h][mt][2] = prologue2(af[h][mt][2], g89);
          af[h][mt][3] = prologue2(af[h][mt][3], g89);
        }
      }
#pragma unroll
      for (int b = 0; b < (DUAL ? 2 : 1); ++b) {
        const bf16* Bm = Bs + b * (L::B_BYTES / 2);
        auto& dst = b ? bf2 : bf;
        if constexpr (QUANT) {
          const int8_t* Bq =
              reinterpret_cast<const int8_t*>(S + L::A_BYTES + b * L::B_BYTES);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            b_frag_int8(dst[h][nt][0], dst[h][nt][1], Bq, L::LDB, kk,
                        wn * TNW + nt * 8, lane);
        } else if constexpr (NT == 1) {
          uint32_t r2[2];
          tc::ldmatrix_x2_trans(r2, Bm + (kk + brow) * L::LDB + wn * TNW);
          dst[h][0][0] = r2[0];
          dst[h][0][1] = r2[1];
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r4[4];
            tc::ldmatrix_x4_trans(r4, Bm + (kk + brow) * L::LDB + wn * TNW +
                                          np * 16 + (lane / 16) * 8);
            dst[h][2 * np][0] = r4[0];
            dst[h][2 * np][1] = r4[1];
            dst[h][2 * np + 1][0] = r4[2];
            dst[h][2 * np + 1][1] = r4[3];
          }
        }
      }
    };
    auto product = [&](int h) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma(acc[mt][nt], af[h][mt], bf[h][nt][0], bf[h][nt][1]);
          if (DUAL)
            tc::mma(acc2[DUAL ? mt : 0][DUAL ? nt : 0], af[h][mt],
                    bf2[h][nt][0], bf2[h][nt][1]);
        }
    };
    if constexpr (BATCH) {
#pragma unroll
      for (int h = 0; h < KH; ++h)
        if (k0 + 16 * h < K) load(16 * h, h);
#pragma unroll
      for (int h = 0; h < KH; ++h)
        if (k0 + 16 * h < K) product(h);
    } else {
#pragma unroll
      for (int h = 0; h < KH; ++h)
        if (k0 + 16 * h < K) {
          load(16 * h, 0);
          product(0);
        }
    }
  };

  // stage ring slots as (stage, sub-tile): stage st holds step st + j
  // stages for j = 0, 1, ...; slots advance without division
  const uint32_t step_bytes = (uint32_t)L::SLOT * kc;
  auto issue = [&](int step, uint32_t base) {
    if (step < n_steps)
      for (int s = 0, sub = step * kc; s < kc && sub < n_sub; ++s, ++sub)
        stage(sub, base + s * L::SLOT);
    tc::cp_async_commit();
  };
  auto run = [&](int step, uint32_t base) {
    for (int s = 0, sub = step * kc; s < kc && sub < n_sub; ++s, ++sub)
      compute(sub, base + s * L::SLOT);
  };
  run_ring(ring, step_bytes, stages, n_steps, issue, run);

  // The epilogue reads the fp32 tile back from shared memory (the ring is
  // free now) in a loop that is not unrolled, one column pair a thread at
  // a time: a compact body for any activation, and consecutive threads on
  // consecutive pairs of a row, so the stores coalesce.
  __syncthreads();                      // every warp is done with the ring
  float* Cs = reinterpret_cast<float*>(tc_smem);
  float* Cs2 = Cs + L::CTILE / (DUAL ? 2 : 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wm * TMW + mt * 16 + lane / 4 + 8 * h;
        const int cc = wn * TNW + nt * 8 + 2 * (lane % 4);
        *reinterpret_cast<float2*>(Cs + rr * L::LDC + cc) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (DUAL)
          *reinterpret_cast<float2*>(Cs2 + rr * L::LDC + cc) = make_float2(
              acc2[DUAL ? mt : 0][DUAL ? nt : 0][2 * h],
              acc2[DUAL ? mt : 0][DUAL ? nt : 0][2 * h + 1]);
      }
  __syncthreads();
  const bf16* res = static_cast<const bf16*>(a.residual);   // K1 only
  TO* out = static_cast<TO*>(a.out) + z * a.bso;
  const float* wsc = QUANT ? a.w_scale + z * a.bss : nullptr;
  const float* wsc2 = QUANT && DUAL ? a.w2_scale + z * a.bss : nullptr;
  const bool pairs =
      a.ldo % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TO)) == 0 &&
      (res == nullptr ||
       (a.ldr % 2 == 0 && reinterpret_cast<uintptr_t>(res) % 4 == 0));
#pragma unroll 1
  for (int i = threadIdx.x; i < BM * BN / 2; i += NTHR) {
    const int rr = i / (BN / 2), cc = 2 * (i % (BN / 2));
    const float2 v = *reinterpret_cast<const float2*>(Cs + rr * L::LDC + cc);
    float2 v2 = make_float2(0.f, 0.f);
    if (DUAL) v2 = *reinterpret_cast<const float2*>(Cs2 + rr * L::LDC + cc);
    const float y[2] = {v.x, v.y}, y2[2] = {v2.x, v2.y};
    store_pair<TO, DUAL, QUANT>(a, y, y2, m0 + rr, n0 + cc, wsc, wsc2, res,
                                out, pairs);
  }
}

// ---------------------------------------------------------------------------
// FFMA wide tile above 16 rows (fp32 x): K1's fp32 and W8 forms at M > 16,
// K2's fp32 form and its int8-only form on fp32 x at T > 16

constexpr int FW_BK = 16;           // K rows of one staged sub-tile
constexpr int FW_THREADS = 256;     // 16 x 16 threads
constexpr int FW_BUDGET = 113 * 1024;   // a block's ring: two blocks an SM
constexpr int FW_MAX_STAGES = 4;    // main-loop steps the ring holds
constexpr int FW_FILL = 2 * NW_SMS; // blocks that fill the card: two an SM

// One ring slot (one sub-tile) of a BM x BN tile on TW weights: x
// transposed, [FW_BK][BM] fp32 (a thread's rows are neighbours, so its x
// fragment is float4 loads), then w (and w2) [FW_BK][BN] in their own type,
// as their 16-byte chunks arrive.  A thread keeps TM x TN outputs (and TM x
// TN more for the dual pair's second contraction); its x unit, staged
// through registers, is 4 rows by XK K columns.
template <typename TW, int BM, int BN, bool DUAL>
struct FwLayout {
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int XK = FW_BK * BM / (4 * FW_THREADS);
  static constexpr int X_BYTES = 4 * FW_BK * BM;
  static constexpr int W_BYTES = (int)sizeof(TW) * FW_BK * BN;
  static constexpr int SLOT = X_BYTES + W_BYTES * (DUAL ? 2 : 1);
};

// Four neighbouring weights of one staged K row, widened exactly to fp32
// as they leave shared memory (one vector load): fp32 as they are, bf16
// under the high half, int8 codes by nw_widen's permute and add.
__device__ __forceinline__ void fw_load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void fw_load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = tc::bf16_lo(t.x);
  v[1] = tc::bf16_hi(t.x);
  v[2] = tc::bf16_lo(t.y);
  v[3] = tc::bf16_hi(t.y);
}
__device__ __forceinline__ void fw_load4(const int8_t* p, float* v) {
  float t[4];
  nw_widen<int8_t, 4>(p, t);
  v[0] = t[0];
  v[1] = t[1];
  v[2] = t[2];
  v[3] = t[3];
}

// XK neighbouring x elements from p, the first n valid (zeros past them;
// n <= 0: none): one XK-vector load where vec and all XK are valid (p then
// on the vector's grid), else scalar loads.
template <int XK>
__device__ __forceinline__ void fw_ldx(const float* p, int n, bool vec,
                                       float (&v)[XK]) {
  if constexpr (XK == 4) {
    if (vec && n >= 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
      return;
    }
  } else if constexpr (XK == 2) {
    if (vec && n >= 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < XK; ++e) v[e] = e < n ? __ldg(p + e) : 0.f;
}

// Four outputs (r, c..c+3) of one row through epilogue_one, one vector
// store where all four exist and the row is aligned, else store_one each.
template <typename TO, bool DUAL>
__device__ __forceinline__ void fw_store4(const Args& a, const float* y,
                                          const float* y2, int r, int c,
                                          const float* ws, const float* ws2,
                                          const float* res, TO* out,
                                          bool vec) {
  if (r >= a.M || c >= a.N) return;
  if (!vec || c + 3 >= a.N) {
    for (int e = 0; e < 4; ++e)
      store_one<float, TO, DUAL>(a, y[e], DUAL ? y2[e] : 0.f, r, c + e, ws,
                                 ws2, res, out);
    return;
  }
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = epilogue_one<float, DUAL>(a, y[e], DUAL ? y2[e] : 0.f, r, c + e,
                                     ws, ws2, res);
  TO* d = out + (long long)r * a.ldo + c;
  if constexpr (sizeof(TO) == 4)
    *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
  else
    *reinterpret_cast<uint2*>(d) =
        make_uint2(tc::pack_bf16(o[0], o[1]), tc::pack_bf16(o[2], o[3]));
}

// One (BM x BN) output tile of batch element blockIdx.z (K1: z = 0, the
// batch strides 0), fp32 x, TW (fp32, bf16 or int8-code) w, out TO.  The
// row tiles run along blockIdx.x, so the blocks in flight share w's column
// tiles (the unembed's w is 545 MB, x 7 MB).  Thread (ty, tx) of 16 x 16
// keeps rows 4 ty..+3 (and BM / 2 + 4 ty..+3 at BM = 128) and columns
// 4 tx..+3 (and BN / 2 + 4 tx..+3 at BN = 128; DUAL: two sets at BN = 64)
// as fmaf chains from 0 in increasing K order, so the same bits at every
// k_collapse, ring depth and tile shape.  A main-loop step is `subs`
// sub-tiles; the ring holds `stages` >= 2 steps, one barrier a step
// (run_ring).  w (w2) arrive by 16-byte cp.async in their own type
// (Chunks' addresses, computed once; scalar loads where w is off the
// 16-byte grid); x goes through registers: each thread loads a 4-row by
// XK-column unit of a sub-tile (one XK-vector a row where x and the row
// allow, else scalar), applies g (x_at's rounding, once per element) and
// stores it transposed as XK float4 columns.  Step j + 1's x is loaded
// sub-tile by sub-tile while step j's sub-tile computes and stored after
// it, into step j + 1's slot (free since the barrier of step j).  Rows past
// M, K rows past K and columns past N are zeros in shared memory.
template <typename TW, typename TO, int BM, int BN, bool DUAL>
__global__ void __launch_bounds__(FW_THREADS, 2)
af_gemm_ffma_kernel(Args a, int subs, int stages) {
  using L = FwLayout<TW, BM, BN, DUAL>;
  constexpr int TM = L::TM, TN = L::TN, XK = L::XK;
  constexpr int KU = FW_BK / XK;       // x units along a sub-tile's K
  static_assert(!DUAL || BN == 64, "the dual pair takes 64 columns");
  static_assert((BM / 4) * KU == FW_THREADS, "one x unit a thread");
  extern __shared__ __align__(16) unsigned char fw_smem[];
  const uint32_t ring = tc::smem_addr(fw_smem);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.M, N = a.N, K = a.K;
  const long long z = blockIdx.z;
  const float* x = static_cast<const float*>(a.x) + z * a.bsx;
  const TW* w = static_cast<const TW*>(a.w) + z * a.bsw;
  const TW* w2 = static_cast<const TW*>(a.w2);
  const float* g = a.g;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    a.ldw % (16 / sizeof(TW)) == 0 &&
                    (!DUAL || reinterpret_cast<uintptr_t>(w2) % 16 == 0);
  const int n_sub = (K + FW_BK - 1) / FW_BK;
  const int n_steps = (n_sub + subs - 1) / subs;

  // this thread's x unit: rows 4 rq..+3, K columns XK kq..+XK-1 of a
  // sub-tile; a warp's lanes of one row read its sub-tile row together
  const int kq = tid % KU, rq = tid / KU;
  const int x_rows = min(4, M - m0 - 4 * rq);       // valid rows (<= 0: none)
  const bool xvec = XK > 1 && reinterpret_cast<uintptr_t>(x) % (4 * XK) == 0 &&
                    a.ldx % XK == 0;
  const float* xp = x + (long long)(m0 + 4 * rq) * a.ldx + XK * kq;

  // this thread's w chunks: rows wr0 + j * W_RS (j < W_NCH) of a sub-tile,
  // columns wcol..+W_EPC-1 (w_n of them valid), all from one pointer
  constexpr int W_EPC = 16 / (int)sizeof(TW), W_CPR = BN / W_EPC;
  constexpr int W_RS = FW_THREADS / W_CPR;
  constexpr int W_NCH = (FW_BK + W_RS - 1) / W_RS;
  const int wr0 = tid / W_CPR, wcol = tid % W_CPR * W_EPC;
  const int w_n = N - n0 - wcol;
  const long long w_off = (long long)wr0 * a.ldw + n0 + wcol;

  float acc[TM][TN];
  float acc2[DUAL ? TM : 1][DUAL ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      if (DUAL) acc2[DUAL ? i : 0][DUAL ? j : 0] = 0.f;
    }

  float xr[4][XK];                     // the x unit in flight ...
  float gv[XK];                        // ... and its columns' g
  auto x_load = [&](int sub) {
    const int k = sub * FW_BK + XK * kq, kn = K - k;   // valid columns
#pragma unroll
    for (int e = 0; e < XK; ++e)
      gv[e] = g != nullptr && e < kn ? __ldg(g + k + e) : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fw_ldx<XK>(xp + (long long)i * a.ldx + sub * FW_BK,
                 i < x_rows ? kn : 0, xvec, xr[i]);
  };
  // ... g applied here, after the products that hid the loads
  auto x_store = [&](uint32_t slot) {
    float* xs = reinterpret_cast<float*>(fw_smem + (slot - ring)) +
                XK * kq * BM + 4 * rq;
    if (g != nullptr)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < XK; ++e) xr[i][e] = __fmul_rn(xr[i][e], gv[e]);
#pragma unroll
    for (int e = 0; e < XK; ++e)
      *reinterpret_cast<float4*>(xs + e * BM) =
          make_float4(xr[0][e], xr[1][e], xr[2][e], xr[3][e]);
  };
  // w (and w2) of one sub-tile into a slot, by cp.async
  auto w_stage = [&](int sub, uint32_t slot) {
    const int k0 = sub * FW_BK;
    if (wvec) {
#pragma unroll
      for (int j = 0; j < W_NCH; ++j) {
        const int r = wr0 + j * W_RS;
        if (r >= FW_BK) break;
        const int n = k0 + r < K ? min(w_n, W_EPC) : 0;
        const long long src = w_off + (long long)(k0 + j * W_RS) * a.ldw;
        const uint32_t dst =
            slot + L::X_BYTES + (uint32_t)sizeof(TW) * (r * BN + wcol);
        tc::cp_chunk(dst, w + src, n, W_EPC);
        if (DUAL) tc::cp_chunk(dst + L::W_BYTES, w2 + src, n, W_EPC);
      }
    } else {
      TW* base = reinterpret_cast<TW*>(fw_smem + (slot - ring) + L::X_BYTES);
      tc::stage_tile<FW_BK, BN, FW_THREADS>(base, BN, w, a.ldw, k0, K, n0, N,
                                            false);
      if (DUAL)
        tc::stage_tile<FW_BK, BN, FW_THREADS>(base + L::W_BYTES / sizeof(TW),
                                              BN, w2, a.ldw, k0, K, n0, N,
                                              false);
    }
  };
  // the products of one staged sub-tile, K row by K row
  auto compute = [&](uint32_t slot) {
    const unsigned char* S = fw_smem + (slot - ring);
    const float* xs = reinterpret_cast<const float*>(S) + 4 * ty;
    const TW* ws_ = reinterpret_cast<const TW*>(S + L::X_BYTES) + 4 * tx;
#pragma unroll
    for (int k = 0; k < FW_BK; ++k) {
      float xa[TM], wb[TN], wb2[DUAL ? TN : 1];
      fw_load4(xs + k * BM, xa);
      if constexpr (TM == 8) fw_load4(xs + k * BM + BM / 2, xa + 4);
      fw_load4(ws_ + k * BN, wb);
      if constexpr (TN == 8) fw_load4(ws_ + k * BN + BN / 2, wb + 4);
      if constexpr (DUAL)
        fw_load4(ws_ + L::W_BYTES / sizeof(TW) + k * BN, wb2);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
          if (DUAL)
            acc2[DUAL ? i : 0][DUAL ? j : 0] =
                fmaf(xa[i], wb2[DUAL ? j : 0], acc2[DUAL ? i : 0][DUAL ? j : 0]);
        }
    }
  };

  const uint32_t step_bytes = (uint32_t)L::SLOT * subs;
  const uint32_t ring_end = ring + step_bytes * stages;
  // stage a step: w by cp.async (one group); x in place for the first
  // step, every later step's during the step before it
  auto issue = [&](int step, uint32_t base) {
    if (step < n_steps)
      for (int s = 0, sub = step * subs; s < subs && sub < n_sub; ++s, ++sub) {
        w_stage(sub, base + s * L::SLOT);
        if (step == 0) {
          x_load(sub);
          x_store(base + s * L::SLOT);
        }
      }
    tc::cp_async_commit();
  };
  auto run = [&](int step, uint32_t base) {
    const uint32_t next =
        base + step_bytes == ring_end ? ring : base + step_bytes;
    for (int s = 0, sub = step * subs; s < subs && sub < n_sub; ++s, ++sub) {
      const bool pre = sub + subs < n_sub;
      if (pre) x_load(sub + subs);
      compute(base + s * L::SLOT);
      if (pre) x_store(next + s * L::SLOT);
    }
  };
  run_ring(ring, step_bytes, stages, n_steps, issue, run);

  TO* out = static_cast<TO*>(a.out) + z * a.bso;
  const float* res = static_cast<const float*>(a.residual);   // K1 only
  const float* wsc = a.w_scale ? a.w_scale + z * a.bss : nullptr;
  const float* wsc2 = a.w2_scale ? a.w2_scale + z * a.bss : nullptr;
  const bool vec = a.ldo % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TO)) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      fw_store4<TO, DUAL>(a, acc[i] + 4 * h,
                          DUAL ? acc2[DUAL ? i : 0] : nullptr, r,
                          n0 + BN / 2 * h + 4 * tx, wsc, wsc2, res, out, vec);
  }
}

// ---------------------------------------------------------------------------
// W8A8 above 16 rows: the quantize pass into scratch and the int8
// tensor-core tile (K1's af_gemm_q and K2's af_expert_gemm_q with
// act_quant at M, or T, > 16; the expert on blockIdx.z)

constexpr int QT_SUB = 32;          // code columns of one k32 sub-tile
constexpr int QT_CLUSTER = 8;       // the quantize pass: most blocks (a
                                    // cluster) a reference tile, ...
constexpr int QT_THREADS = 128;     // ... threads a block, ...
constexpr int QT_ITEMS = 4;         // ... and items (a row by 16
                                    // columns) a thread holds in registers
constexpr int QT_BM = 128;          // the tile's rows
constexpr int QT_SUBS = 8;          // sub-tiles a step of the tile's double
                                    // buffer

// The scratch of one launch, fixed by M (T), K, the reference's tile
// (quant_bm, quant_kk) and the batch: codes [batch][M][steps * kk32]
// int8, kk32 = quant_kk rounded up to 32, then from the next 16-byte
// boundary scales [batch][rtiles][steps] fp32.  The wrapper's
// w8a8_scratch computes the same layout.
struct QtLayout {
  int steps, rtiles, kk32;
  long long ldc;                    // bytes a code row
  long long codes_bytes, scales_off, bytes;
};

inline QtLayout qt_layout(int M, int K, int quant_bm, int quant_kk,
                          int batch) {
  QtLayout l;
  l.steps = (K + quant_kk - 1) / quant_kk;
  l.rtiles = (M + quant_bm - 1) / quant_bm;
  l.kk32 = (quant_kk + QT_SUB - 1) / QT_SUB * QT_SUB;
  l.ldc = (long long)l.steps * l.kk32;
  l.codes_bytes = (long long)batch * M * l.ldc;
  l.scales_off = (l.codes_bytes + 15) / 16 * 16;
  l.bytes = l.scales_off + 4LL * batch * l.rtiles * l.steps;
  return l;
}

// The x column (from the start of its 32-column group) whose code sits at
// position p of the group: positions 4t..4t+3 of each 16-column half hold
// its columns 2t, 2t+1, 2t+8, 2t+9 -- the K order in which the tile's
// byte permutes hand a B fragment its w rows.
__host__ __device__ constexpr int qt_col(int p) {
  return 16 * (p / 16) + 2 * ((p % 16) / 4) + (p & 1) + 8 * ((p >> 1) & 1);
}

// 16 neighbouring elements of T from p, the first n valid (zeros past
// them), widened exactly to fp32: 16-byte loads where vec and all 16 are
// valid (p then on the 16-byte grid), else scalar loads.
template <typename T>
__device__ __forceinline__ void qt_load16(const T* p, int n, bool vec,
                                          float (&v)[16]) {
  if (vec && n >= 16) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = reinterpret_cast<const float4*>(p)[i];
        v[4 * i] = q.x;
        v[4 * i + 1] = q.y;
        v[4 * i + 2] = q.z;
        v[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[i];
        const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[8 * i + 2 * j] = tc::bf16_lo(u[j]);
          v[8 * i + 2 * j + 1] = tc::bf16_hi(u[j]);
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = e < n ? to_f(p[e]) : 0.f;
  }
}

// The quantize pass: one cluster of `cl` blocks a reference tile --
// quant_bm rows (row tile blockIdx.y / cl) by one quant_kk step
// (blockIdx.x) of expert blockIdx.z -- each block a run of the tile's rows.
// An item is one row by 16 code columns of the step (padded to kk32); each
// thread loads QT_ITEMS items a batch, all loads in flight before any is
// used, with x_at's prologue (g in fp32, rounded back to x's type).  The
// blocks' amax meet through distributed shared memory (each reads every
// block's, between two cluster barriers), so every block holds the tile's
// scale, amax * fp32(1/127) as the reference's compiled quantizer computes
// it (block 0 stores it); then every item's 16 codes (quant_code) go out
// as one 16-byte store, in qt_col's order, zeros past the step.  A block of
// one batch quantizes from the registers its amax pass loaded; more items
// read x again (L2).  Several blocks a tile where the tiles are few
// (qt_cluster): a tile's 128 rows on one SM left the pass at 8-10 us a
// launch on the prefill chunk's 896-wide sites (4 steps x 8 row tiles: 32
// SMs busy).
template <typename TX>
__global__ void __launch_bounds__(QT_THREADS)
af_w8a8_quant_kernel(const TX* x, const float* g, int8_t* codes,
                     float* scales, int M, int K, long long ldx,
                     long long bsx, int quant_bm, int quant_kk, int cl,
                     QtLayout l) {
  namespace cg = cooperative_groups;
  constexpr int BATCH = QT_ITEMS * QT_THREADS;
  __shared__ float red[QT_THREADS / 32];
  __shared__ float part;                    // this block's amax
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x, t = blockIdx.y / cl;
  const long long z = blockIdx.z;
  const int rpb = (quant_bm + cl - 1) / cl;                   // rows a block
  const int r0 = t * quant_bm + rank * rpb;
  const int nr = max(0, min(rpb, min(quant_bm, M - t * quant_bm) -
                                     rank * rpb));
  const int c0 = s * quant_kk, nc = min(quant_kk, K - c0);
  const TX* xt = x + z * bsx + (long long)r0 * ldx + c0;
  const float* gt = g != nullptr ? g + c0 : nullptr;
  const bool xvec = reinterpret_cast<uintptr_t>(xt) % 16 == 0 &&
                    (ldx * (long long)sizeof(TX)) % 16 == 0;
  const bool gvec = reinterpret_cast<uintptr_t>(gt) % 16 == 0;
  const int halves = l.kk32 / 16;          // items a row
  const int n_items = nr * halves;

  float v[QT_ITEMS][16];
  auto load = [&](int b0) {
#pragma unroll
    for (int u = 0; u < QT_ITEMS; ++u) {
      const int i = b0 + u * QT_THREADS + threadIdx.x;
      const int r = i / halves, c = 16 * (i - r * halves);
      const int n = i < n_items ? nc - c : 0;
      qt_load16(xt + (long long)r * ldx + c, n, xvec, v[u]);
      if (gt != nullptr && n > 0) {
        float gv[16];
        qt_load16(gt + c, n, gvec, gv);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[u][e] = to_f(from_f<TX>(__fmul_rn(v[u][e], gv[e])));
      }
    }
  };

  float m = 0.f;
  for (int b0 = 0; b0 < n_items; b0 += BATCH) {
    load(b0);
#pragma unroll
    for (int u = 0; u < QT_ITEMS; ++u)
#pragma unroll
      for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(v[u][e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = red[0];
#pragma unroll
    for (int i = 1; i < QT_THREADS / 32; ++i) b = fmaxf(b, red[i]);
    part = b;
  }
  cluster.sync();                          // every block's part is written
  float amax = 0.f;
  for (int r = 0; r < cl; ++r)
    amax = fmaxf(amax, *cluster.map_shared_rank(&part, r));
  cluster.sync();                          // and read, before any exits
  // times fp32(1/127), as the reference's compiled quantizer computes it
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  if (rank == 0 && threadIdx.x == 0)
    scales[(z * l.rtiles + t) * l.steps + s] = scale;

  int8_t* ct = codes + (z * M + r0) * l.ldc + (long long)s * l.kk32;
  for (int b0 = 0; b0 < n_items; b0 += BATCH) {
    if (n_items > BATCH) load(b0);
#pragma unroll
    for (int u = 0; u < QT_ITEMS; ++u) {
      const int i = b0 + u * QT_THREADS + threadIdx.x;
      if (i >= n_items) continue;
      const int r = i / halves, h = i - r * halves;
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          word |= (uint32_t)(quant_code(v[u][qt_col(4 * j + b)], scale) &
                             0xff) << (8 * b);
        wd[j] = word;
      }
      *reinterpret_cast<uint4*>(ct + r * l.ldc + 16 * h) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

// What the host fixes for one launch of the tile: the scratch's codes and
// scales, and their layout.
struct QtPlan {
  const int8_t* codes;
  const float* scales;
  QtLayout l;
};

// One slot of the double buffer (a 32-column sub-tile): x codes [BM][32]
// and w (w2) codes [32][BN], each row padded by one 16-byte chunk, so the 8
// rows an ldmatrix reads land on distinct banks; the epilogue's fp32
// tile(s) [BM][BN + 16] over the buffer (a float4 store of 8 lanes on two
// rows lands on distinct banks).
template <int BM, int BN, bool DUAL>
struct QtTile {
  static constexpr int LDA = QT_SUB + 16;           // bytes
  static constexpr int LDB = BN + 16;               // bytes
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int B_BYTES = QT_SUB * LDB;
  static constexpr int SLOT = A_BYTES + B_BYTES * (DUAL ? 2 : 1);
  static constexpr int LDC = BN + 16;               // floats
  static constexpr int CTILE = BM * LDC * (DUAL ? 2 : 1);
  static constexpr size_t SMEM =                    // bytes
      std::max((size_t)2 * QT_SUBS * SLOT, sizeof(float) * CTILE);
};

// One (BM x BN) output tile of batch element blockIdx.z in WM x WN warps:
// the int8 products of the quantized x (p.codes) and w (w2) on the tensor
// cores, each reference step's exact int32 partial folded into the fp32
// accumulators times that step's scale, in step order; then store_one's
// epilogue (TR: the residual's type, x's).  The operands run through a
// double buffer of QT_SUBS sub-tiles a step: one barrier a step, the next
// step's copies in flight while this one computes (deeper rings of fewer
// sub-tiles a step ran slower).
template <typename TR, typename TO, int BM, int BN, int WM, int WN, bool DUAL>
__global__ void __launch_bounds__(WM * WN * 32)
af_gemm_w8a8_tc_kernel(Args a, QtPlan p) {
  using L = QtTile<BM, BN, DUAL>;
  constexpr int NTHR = WM * WN * 32;
  constexpr int TMW = BM / WM, TNW = BN / WN;   // a warp's tile
  constexpr int MT = TMW / 16, NG = TNW / 16;   // its m16 tiles, 16-column
                                                // groups (two n8 tiles each)
  constexpr int NW = DUAL ? 2 : 1;              // contractions
  static_assert(TMW % 16 == 0 && TNW % 16 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char qt_smem[];
  const uint32_t ring = tc::smem_addr(qt_smem);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, K = a.K, kk = a.quant_kk;
  const int sps = p.l.kk32 / QT_SUB;            // sub-tiles a step
  const int n_sub = p.l.steps * sps;
  const long long ldc = p.l.ldc;
  // batch element blockIdx.z (an expert, or a batch x kv-head; 0 for K1),
  // offset before the alignment test
  const long long z = blockIdx.z;
  const int8_t* codes = p.codes + z * M * ldc;
  const float* scales =
      p.scales + (z * p.l.rtiles + m0 / a.quant_bm) * p.l.steps;
  const int8_t* w = static_cast<const int8_t*>(a.w) + z * a.bsw;
  const int8_t* w2 = static_cast<const int8_t*>(a.w2);   // K1's dual only
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    a.ldw % 16 == 0 &&
                    (!DUAL || reinterpret_cast<uintptr_t>(w2) % 16 == 0);

  using XC = Chunks<BM, QT_SUB, NTHR, 1>;
  using WC = Chunks<QT_SUB, BN, NTHR, 1>;
  XC xs;
  WC ws;
  xs.init(L::LDA);
  ws.init(L::LDB);
  const int8_t* xp[XC::N];
  int x_n[XC::N];                      // 16: the chunk's row exists
  long long wo[WC::N];                 // the chunk's column offset in W
  int w_n[WC::N];                      // its valid columns
#pragma unroll
  for (int j = 0; j < XC::N; ++j) {
    const bool ok = xs.r[j] >= 0 && m0 + xs.r[j] < M;
    x_n[j] = ok ? 16 : 0;
    xp[j] = codes + (ok ? (long long)(m0 + xs.r[j]) * ldc + xs.c[j] : 0);
  }
#pragma unroll
  for (int j = 0; j < WC::N; ++j) {
    w_n[j] = ws.r[j] >= 0 ? min(16, N - n0 - ws.c[j]) : 0;
    wo[j] = (long long)max(ws.r[j], 0) * a.ldw + n0 + ws.c[j];
  }

  // stage sub-tile `sub` (code columns 32 sub.., w rows from k0) into a
  // slot: K rows past K zero (the step padding's codes are zero, so the
  // next step's w rows in a padded sub-tile add nothing)
  auto stage = [&](int sub, uint32_t slot) {
    const int st = sub / sps;
    const int k0 = st * kk + (sub - st * sps) * QT_SUB;
#pragma unroll
    for (int j = 0; j < XC::N; ++j)
      if (xs.r[j] >= 0)
        tc::cp_chunk(slot + xs.off[j], xp[j] + (long long)sub * QT_SUB,
                     x_n[j], 16);
    if (wvec) {
      const long long kofs = (long long)k0 * a.ldw;
#pragma unroll
      for (int j = 0; j < WC::N; ++j) {
        if (ws.r[j] < 0) continue;
        const int n = k0 + ws.r[j] < K ? w_n[j] : 0;
        tc::cp_chunk(slot + L::A_BYTES + ws.off[j], w + kofs + wo[j], n, 16);
        if (DUAL)
          tc::cp_chunk(slot + L::A_BYTES + L::B_BYTES + ws.off[j],
                       w2 + kofs + wo[j], n, 16);
      }
    } else {
      int8_t* base =
          reinterpret_cast<int8_t*>(qt_smem + (slot - ring) + L::A_BYTES);
      tc::stage_tile<QT_SUB, BN, NTHR>(base, L::LDB, w, a.ldw, k0, K, n0, N,
                                       false);
      if (DUAL)
        tc::stage_tile<QT_SUB, BN, NTHR>(base + L::B_BYTES, L::LDB, w2,
                                         a.ldw, k0, K, n0, N, false);
    }
  };

  // [contraction][m16 tile][n8 tile: 2q the even, 2q + 1 the odd columns
  // of 16-column group q][fragment]
  int iacc[NW][MT][2 * NG][4];
  float acc[NW][MT][2 * NG][4];
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[v][i][j][e] = 0.f;

  // the products of one staged sub-tile; a step's first zeroes the int32
  // sums and loads the step's scale, its last folds the sums in with it
  float sc = 0.f;
  auto compute = [&](int sub, uint32_t slot) {
    const unsigned char* S = qt_smem + (slot - ring);
    const int st = sub / sps, o = sub - st * sps;
    if (o == 0) {
      sc = __ldg(scales + st);
#pragma unroll
      for (int v = 0; v < NW; ++v)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) iacc[v][i][j][e] = 0;
    }
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      tc::ldmatrix_x4(af[mt], S + (wm * TMW + mt * 16 + lane % 16) * L::LDA +
                                  (lane / 16) * 16);
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      // lane l gives row l of the 32 K rows: matrix i is K rows 8i..8i+7
      const unsigned char* Bs =
          S + L::A_BYTES + v * L::B_BYTES + lane * L::LDB + wn * TNW;
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        // r[i]: columns 2g, 2g + 1 at K rows 8i + 2t, 8i + 2t + 1
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, Bs + 16 * q);
        const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420);  // column 2g
        const uint32_t e1 = __byte_perm(r[2], r[3], 0x6420);
        const uint32_t d0 = __byte_perm(r[0], r[1], 0x7531);  // 2g + 1
        const uint32_t d1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_s8(iacc[v][mt][2 * q], af[mt], e0, e1);
          tc::mma_s8(iacc[v][mt][2 * q + 1], af[mt], d0, d1);
        }
      }
    }
    if (o == sps - 1) {
#pragma unroll
      for (int v = 0; v < NW; ++v)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[v][i][j][e] = __fadd_rn(
                  acc[v][i][j][e], __fmul_rn((float)iacc[v][i][j][e], sc));
    }
  };

  const uint32_t step_bytes = (uint32_t)L::SLOT * QT_SUBS;
  const int n_steps = (n_sub + QT_SUBS - 1) / QT_SUBS;
  auto issue = [&](int step, uint32_t base) {
    if (step < n_steps)
      for (int s = 0, sub = step * QT_SUBS; s < QT_SUBS && sub < n_sub;
           ++s, ++sub)
        stage(sub, base + s * L::SLOT);
    tc::cp_async_commit();
  };
  auto run = [&](int step, uint32_t base) {
    for (int s = 0, sub = step * QT_SUBS; s < QT_SUBS && sub < n_sub;
         ++s, ++sub)
      compute(sub, base + s * L::SLOT);
  };
  run_ring(ring, step_bytes, 2, n_steps, issue, run);

  // the fp32 tile(s) through shared memory (the ring is free now): a
  // lane's row g (g + 8) of group q holds columns 16q + 4t .. 16q + 4t + 3
  // as (even c0, odd c0, even c1, odd c1) (c2, c3)
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(qt_smem);
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = wm * TMW + mt * 16 + lane / 4 + 8 * h;
          const int cc = wn * TNW + 16 * q + 4 * (lane % 4);
          *reinterpret_cast<float4*>(Cs + (v * BM + rr) * L::LDC + cc) =
              make_float4(acc[v][mt][2 * q][2 * h],
                          acc[v][mt][2 * q + 1][2 * h],
                          acc[v][mt][2 * q][2 * h + 1],
                          acc[v][mt][2 * q + 1][2 * h + 1]);
        }
  __syncthreads();
  // then store_one's math, each thread on one column pair (its scales and
  // biases loaded once) of every RSTEP-th row, consecutive threads on
  // consecutive pairs of a row, UNROLL rows' loads in flight: with the
  // per-column loads in every row's iteration, one row at a time, the
  // epilogue's latency was most of a launch at the dual and the 896-wide
  // sites
  constexpr int PR = BN / 2, RSTEP = NTHR / PR;
  const TR* res = static_cast<const TR*>(a.residual);     // K1 only
  TO* out = static_cast<TO*>(a.out) + z * a.bso;
  const int cpi = threadIdx.x % PR, c = n0 + 2 * cpi;
  const int nc = min(2, N - c);                 // the pair's columns
  float sv[NW][2] = {}, bv[NW][2] = {};
  const float* wsv[2] = {a.w_scale + z * a.bss, a.w2_scale};
  const float* bsv[2] = {a.bias, a.bias2};
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (e < nc) {
        sv[v][e] = wsv[v][c + e];
        if (bsv[v] != nullptr) bv[v][e] = bsv[v][c + e];
      }
  const bool pair = nc == 2 && a.ldo % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TO)) == 0;
#pragma unroll 4
  for (int rr = threadIdx.x / PR; rr < BM; rr += RSTEP) {
    const int r = m0 + rr;
    if (r >= M || nc <= 0) continue;
    const float2 yv = *reinterpret_cast<const float2*>(Cs + rr * L::LDC +
                                                       2 * cpi);
    float2 y2v = make_float2(0.f, 0.f);
    if (DUAL)
      y2v = *reinterpret_cast<const float2*>(Cs + (BM + rr) * L::LDC +
                                             2 * cpi);
    const float y[2] = {yv.x, yv.y}, y2[2] = {y2v.x, y2v.y};
    float o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {        // store_one's order and roundings
      float t = __fmul_rn(y[e], sv[0][e]);
      if (a.bias != nullptr) t = __fadd_rn(t, bv[0][e]);
      o[e] = activate(t, a.activation);
      if (DUAL) {
        float t2 = __fmul_rn(y2[e], sv[NW - 1][e]);
        if (a.bias2 != nullptr) t2 = __fadd_rn(t2, bv[NW - 1][e]);
        o[e] = __fmul_rn(o[e], t2);
      }
      if (res != nullptr && e < nc)
        o[e] = __fadd_rn(to_f(res[(long long)r * a.ldr + c + e]), o[e]);
    }
    TO* d = out + (long long)r * a.ldo + c;
    if (pair) {
      if constexpr (sizeof(TO) == 4)
        *reinterpret_cast<float2*>(d) = make_float2(o[0], o[1]);
      else
        *reinterpret_cast<uint32_t*>(d) = tc::pack_bf16(o[0], o[1]);
    } else {
      for (int e = 0; e < nc; ++e) d[e] = from_f<TO>(o[e]);
    }
  }
}

// The tile's width at M rows, N columns and `batch` experts: 128 columns
// (8 warps of 64 x 32) where the 128 x 128 grid fills the card, else 64
// (8 warps of 32 x 32: twice the blocks, where the 1024-row prefill
// chunk's 896-wide sites would fill 56 SMs); the dual takes 64, with two
// accumulator sets.
inline int qt_cols(int M, int N, bool dual, int batch) {
  if (dual) return 64;
  const long long blocks =
      (long long)((M + QT_BM - 1) / QT_BM) * ((N + 127) / 128) * batch;
  return blocks >= NW_SMS ? 128 : 64;
}

// The tile at width BN.  smem_only: report the dynamic shared memory the
// launch takes, and launch nothing.
template <typename TR, typename TO, int BN, int WM, int WN, bool DUAL>
int launch_qt_tile(const Args& a, const QtPlan& p, int batch,
                   cudaStream_t stream, size_t* smem_only) {
  constexpr size_t smem = QtTile<QT_BM, BN, DUAL>::SMEM;
  static_assert(smem <= (size_t)MAX_SMEM, "W8A8 tile shared memory");
  if (smem_only != nullptr) {
    *smem_only = smem;
    return 0;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      af_gemm_w8a8_tc_kernel<TR, TO, QT_BM, BN, WM, WN, DUAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + QT_BM - 1) / QT_BM, batch);
  af_gemm_w8a8_tc_kernel<TR, TO, QT_BM, BN, WM, WN, DUAL>
      <<<grid, WM * WN * 32, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <typename TR, typename TO, bool DUAL>
int launch_qt_w(const Args& a, const QtPlan& p, int batch,
                cudaStream_t stream, size_t* smem_only) {
  if constexpr (DUAL) {
    return launch_qt_tile<TR, TO, 64, 4, 2, true>(a, p, batch, stream,
                                                  smem_only);
  } else {
    if (qt_cols(a.M, a.N, false, batch) == 128)
      return launch_qt_tile<TR, TO, 128, 2, 4, false>(a, p, batch, stream,
                                                      smem_only);
    return launch_qt_tile<TR, TO, 64, 4, 2, false>(a, p, batch, stream,
                                                   smem_only);
  }
}

// The quantize pass's blocks a reference tile (a cluster): the fewest of
// 1, 2, 4 and 8 whose grid reaches two blocks an SM, and no more than the
// tile's rows.
inline int qt_cluster(const QtLayout& l, int quant_bm, int batch) {
  const long long tiles = (long long)l.steps * l.rtiles * batch;
  int cl = 1;
  while (cl < QT_CLUSTER && cl < quant_bm && tiles * cl < 2 * NW_SMS)
    cl *= 2;
  return cl;
}

// The quantize pass alone: x of TX (rows ldx apart, experts bsx apart) into
// the scratch of layout l, a cluster of qt_cluster blocks a reference tile
// (launched with the cluster's shape as a launch attribute).
template <typename TX>
int launch_qt_quant(const Args& a, const QtLayout& l, void* scratch,
                    int batch, cudaStream_t stream) {
  const int cl = qt_cluster(l, a.quant_bm, batch);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.steps, l.rtiles * cl, batch);
  cfg.blockDim = dim3(QT_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, af_w8a8_quant_kernel<TX>, static_cast<const TX*>(a.x), a.g,
      static_cast<int8_t*>(scratch),
      reinterpret_cast<float*>(static_cast<char*>(scratch) + l.scales_off),
      a.M, a.K, a.ldx, a.bsx, a.quant_bm, a.quant_kk, cl, l);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// Checks shared by the W8A8 entries above 16 rows: the quantization tile
// (quant_bm rows must be M or a multiple of the tile's 128, so a block's
// rows lie in one reference tile), the types, the batch and the grid, and
// (unless layout_only) the scratch: 16-byte aligned, at least l.bytes.
inline int qt_check(const Args& a, int x_dtype, int out_dtype, int batch,
                    const void* scratch, long long scratch_bytes,
                    QtLayout& l, bool layout_only) {
  if (a.M < 1 || a.N < 1 || a.K < 1 || a.quant_bm < 1 || a.quant_kk < 1 ||
      (a.quant_bm < a.M && a.quant_bm % QT_BM != 0) || batch < 1 ||
      batch > 65535 || (x_dtype != F32 && x_dtype != BF16) ||
      (out_dtype != F32 && out_dtype != BF16))
    return (int)cudaErrorInvalidValue;
  l = qt_layout(a.M, a.K, a.quant_bm, a.quant_kk, batch);
  if ((long long)l.rtiles * QT_CLUSTER > 65535 ||
      (a.M + QT_BM - 1) / QT_BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (!layout_only &&
      (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
       scratch_bytes < l.bytes))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// W8A8 above 16 rows: the quantize pass into `scratch`, then the int8
// tensor-core tile, both on `stream`; `batch` experts on z.  A refused
// launch launches nothing.  smem_only: report the tile's dynamic shared
// memory, and launch nothing.
template <bool DUAL>
int launch_qt(const Args& a, int x_dtype, int out_dtype, int batch,
              void* scratch, long long scratch_bytes, cudaStream_t stream,
              size_t* smem_only = nullptr) {
  QtLayout l;
  int rc = qt_check(a, x_dtype, out_dtype, batch, scratch, scratch_bytes, l,
                    smem_only != nullptr);
  if (rc != 0) return rc;
  const QtPlan p{static_cast<const int8_t*>(scratch),
                 reinterpret_cast<const float*>(
                     static_cast<const char*>(scratch) + l.scales_off),
                 l};
  auto tile = [&](size_t* so) {
    if (x_dtype == F32)
      return out_dtype == F32
                 ? launch_qt_w<float, float, DUAL>(a, p, batch, stream, so)
                 : launch_qt_w<float, __nv_bfloat16, DUAL>(a, p, batch,
                                                           stream, so);
    return out_dtype == F32
               ? launch_qt_w<__nv_bfloat16, float, DUAL>(a, p, batch, stream,
                                                         so)
               : launch_qt_w<__nv_bfloat16, __nv_bfloat16, DUAL>(
                     a, p, batch, stream, so);
  };
  size_t smem = 0;
  rc = tile(&smem);
  if (rc != 0 || smem_only != nullptr) {
    if (smem_only != nullptr) *smem_only = smem;
    return rc;
  }
  rc = x_dtype == F32
           ? launch_qt_quant<float>(a, l, scratch, batch, stream)
           : launch_qt_quant<__nv_bfloat16>(a, l, scratch, batch, stream);
  if (rc != 0) return rc;
  return tile(nullptr);
}

// The FFMA wide tile (fp32 x) at BM x BN: a ring step of k_collapse
// sub-tiles, or of as many as leave room for two steps in the block's
// budget (every output is the same fmaf chain whatever the step), and as
// many steps as the budget holds, 2 to FW_MAX_STAGES.  smem_only: report
// the dynamic shared memory the launch takes, and launch nothing.
template <typename TW, typename TO, int BM, int BN, bool DUAL>
int launch_fw(const Args& a, int batch, cudaStream_t stream,
              size_t* smem_only) {
  using L = FwLayout<TW, BM, BN, DUAL>;
  const int subs =
      std::max(1, std::min(a.k_collapse, FW_BUDGET / (2 * L::SLOT)));
  const int stages =
      std::min(FW_MAX_STAGES, FW_BUDGET / (L::SLOT * subs));
  const size_t smem = (size_t)L::SLOT * subs * stages;
  if (smem_only != nullptr) {
    *smem_only = smem;
    return 0;
  }
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      af_gemm_ffma_kernel<TW, TO, BM, BN, DUAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  af_gemm_ffma_kernel<TW, TO, BM, BN, DUAL>
      <<<grid, FW_THREADS, smem, stream>>>(a, subs, stages);
  return (int)cudaGetLastError();
}

template <typename TW, int BM, int BN, bool DUAL>
int launch_fw_out(const Args& a, int out_dtype, int batch,
                  cudaStream_t stream, size_t* smem_only) {
  if (out_dtype == F32)
    return launch_fw<TW, float, BM, BN, DUAL>(a, batch, stream, smem_only);
  if (out_dtype == BF16)
    return launch_fw<TW, __nv_bfloat16, BM, BN, DUAL>(a, batch, stream,
                                                      smem_only);
  return (int)cudaErrorInvalidValue;
}

// The FFMA wide tile's shape at M rows, N columns and `batch` experts: 128
// rows by 128 columns (64 for the dual pair) where that grid gives every SM
// two blocks; else 128 x 64 where that grid gives every SM one (the 896-
// column projections of a 2048-token prefill); else 64 x 64 (the 128-column
// ones, attn.pv's 64-column head), so that the smaller grids still reach
// every SM.  The tile changes no bit of the output.
inline long long fw_blocks(int M, int N, int batch, int bm, int bn) {
  return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn) * batch;
}

template <typename TW, bool DUAL>
int launch_ffma(const Args& a, int out_dtype, int batch, cudaStream_t stream,
                size_t* smem_only = nullptr) {
  if (DUAL || a.N > 64) {
    if (fw_blocks(a.M, a.N, batch, 128, DUAL ? 64 : 128) >= FW_FILL)
      return launch_fw_out<TW, 128, DUAL ? 64 : 128, DUAL>(
          a, out_dtype, batch, stream, smem_only);
    if (!DUAL && fw_blocks(a.M, a.N, batch, 128, 64) >= NW_SMS)
      return launch_fw_out<TW, 128, 64, false>(a, out_dtype, batch, stream,
                                               smem_only);
  }
  return launch_fw_out<TW, 64, 64, DUAL>(a, out_dtype, batch, stream,
                                         smem_only);
}

// The narrow FFMA tile at width COLS, M <= MR rows (batch blocks along z
// for K2), out fp32 or bf16 (out_dtype).  The warps' rings share a budget:
// the whole SM where the grid has at most a block an SM (K1's small sites,
// the MoE router: each block streams alone), else half of it, so two blocks
// share an SM and one's loads overlap another's sums and store (the MoE
// banks, the unembed).  A warp's ring holds up to NW_RING sub-tiles of its
// share, in steps of k_collapse sub-tiles (at most half the ring and the
// slice, at least one), and no more steps than its slice needs plus one,
// so a short K leaves the SM to other blocks.  smem_only: report the dynamic shared
// memory the launch takes, and launch nothing.
template <typename TX, typename TW, int COLS, int MR, bool DUAL, bool EXPERT>
int launch_narrow(const Args& a, int out_dtype, int batch,
                  cudaStream_t stream, size_t* smem_only = nullptr) {
  if (a.M > MR || (out_dtype != F32 && out_dtype != BF16))
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.N + COLS - 1) / COLS;
  const int slot = nw_slot<TX, TW, COLS, DUAL>(a.M);
  const int budget = EXPERT || (long long)blocks * batch > NW_SMS
                         ? MAX_SMEM / 2 : MAX_SMEM;
  const int fit = std::max(1, std::min(NW_RING, budget / NW_SPLIT / slot));
  const int per = nw_per(a.K);
  const int subs = std::max(1, std::min({a.k_collapse, fit / 2, per}));
  const int steps = (per + subs - 1) / subs;
  const int stages = std::max(1, std::min(fit / subs, steps + 1));
  const size_t smem =
      std::max((size_t)NW_SPLIT * stages * subs * slot,
               sizeof(float) * NW_SPLIT * a.M * COLS * (DUAL ? 2 : 1));
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem_only != nullptr) {
    *smem_only = smem;
    return 0;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      af_gemm_narrow_kernel<TX, TW, COLS, MR, DUAL, EXPERT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(blocks, 1, batch);
  af_gemm_narrow_kernel<TX, TW, COLS, MR, DUAL, EXPERT>
      <<<grid, NW_THREADS, smem, stream>>>(a, subs, stages,
                                           out_dtype == BF16);
  return (int)cudaGetLastError();
}

// The narrow tile at width COLS: room for 4 rows of sums a lane where M
// <= 4 (the decode batch; an MoE bank's capacity row), so a lane of 16
// rows' room does not hold 4x the registers it uses, else 16
template <typename TX, typename TW, int COLS, bool DUAL, bool EXPERT>
int launch_narrow_rows(const Args& a, int out_dtype, int batch,
                       cudaStream_t stream, size_t* smem_only) {
  if (a.M <= 4)
    return launch_narrow<TX, TW, COLS, 4, DUAL, EXPERT>(
        a, out_dtype, batch, stream, smem_only);
  if constexpr (COLS <= 64)
    return launch_narrow<TX, TW, COLS, 16, DUAL, EXPERT>(
        a, out_dtype, batch, stream, smem_only);
  return (int)cudaErrorInvalidValue;
}

// The narrow tile at the width nw_cols picks: K1 at M <= 16 (TX = float;
// TW = float for af_gemm, int8_t for af_gemm_q's W8 form on fp32 x), or
// K2's int8-only form at T <= 16 (EXPERT, TW = int8_t, TX = float or bf16,
// `batch` experts on z)
template <typename TX, typename TW, bool DUAL, bool EXPERT>
int launch_narrow_w(const Args& a, int out_dtype, int batch,
                    cudaStream_t stream, size_t* smem_only = nullptr) {
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  switch (nw_cols(a.M, a.N, Q, batch)) {
    case 8:
      if constexpr (!Q)
        return launch_narrow_rows<TX, TW, 8, DUAL, EXPERT>(
            a, out_dtype, batch, stream, smem_only);
      break;
    case 16:
      return launch_narrow_rows<TX, TW, 16, DUAL, EXPERT>(
          a, out_dtype, batch, stream, smem_only);
    case 32:
      return launch_narrow_rows<TX, TW, 32, DUAL, EXPERT>(
          a, out_dtype, batch, stream, smem_only);
    case 64:
      if constexpr (Q)
        return launch_narrow_rows<TX, TW, 64, DUAL, EXPERT>(
            a, out_dtype, batch, stream, smem_only);
      break;
    case 128:
      if constexpr (Q)
        return launch_narrow_rows<TX, TW, 128, DUAL, EXPERT>(
            a, out_dtype, batch, stream, smem_only);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// The W8A8 narrow tile's plan at width COLS: the ring's budget is the
// narrow tile's (the whole SM where the grid has at most a block an SM,
// else half of it); a round holds as many whole reference steps as fit
// beside a ring of at least one slot a warp (all of them at every decode
// site of the served models), the warp rings take up to NW_RING slots of
// what is left, and no more than the round's longest warp run plus one.
// Where not even one step fits the budget, the whole SM is tried.  Returns
// the dynamic shared memory, 0 where nothing fits.
template <int COLS, bool DUAL>
size_t qw_plan(const Args& a, int batch, QwPlan& p) {
  constexpr long long SLOT = (DUAL ? 2 : 1) * NW_BK * COLS;
  auto up16 = [](long long v) { return (v + 15) / 16 * 16; };
  p.steps = (a.K + a.quant_kk - 1) / a.quant_kk;
  p.sps = (a.quant_kk + NW_BK - 1) / NW_BK;
  const long long blocks = (long long)((a.N + COLS - 1) / COLS) * batch;
  const long long budgets[2] = {blocks > NW_SMS ? MAX_SMEM / 2 : MAX_SMEM,
                                MAX_SMEM};
  for (long long budget : budgets)
    for (int R = p.steps; R >= 1; --R) {
      const long long p_off = up16((long long)a.M * R * p.sps * NW_BK);
      const long long amax_off =
          p_off + 4LL * (DUAL ? 2 : 1) * R * a.M * COLS;
      const long long ring_off = amax_off + up16(4LL * R);
      const long long per = ((long long)R * p.sps + NW_SPLIT - 1) / NW_SPLIT;
      const long long fit = (budget - ring_off) / (NW_SPLIT * SLOT);
      const long long stages = std::min<long long>({NW_RING, fit, per + 1});
      if (stages < 1) continue;
      p.round = R;
      p.stages = (int)stages;
      p.p_off = (int)p_off;
      p.amax_off = (int)amax_off;
      p.ring_off = (int)ring_off;
      return (size_t)(ring_off + NW_SPLIT * stages * SLOT);
    }
  return 0;
}

// The W8A8 narrow tile at width COLS, M <= MR rows (batch experts on z for
// K2), out fp32 or bf16 (out_dtype).  The quantization tile must hold all
// M rows (quant_bm >= M: the reference's tile at M <= 128).  smem_only:
// report the dynamic shared memory the launch takes, and launch nothing.
template <typename TX, int COLS, int MR, bool DUAL>
int launch_qw(const Args& a, int out_dtype, int batch, cudaStream_t stream,
              size_t* smem_only) {
  if (a.M > MR || a.quant_bm < a.M || a.quant_kk < 1 ||
      (out_dtype != F32 && out_dtype != BF16))
    return (int)cudaErrorInvalidValue;
  QwPlan p;
  const size_t smem = qw_plan<COLS, DUAL>(a, batch, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (smem_only != nullptr) {
    *smem_only = smem;
    return 0;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      af_gemm_w8a8_narrow_kernel<TX, COLS, MR, DUAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.N + COLS - 1) / COLS, 1, batch);
  af_gemm_w8a8_narrow_kernel<TX, COLS, MR, DUAL>
      <<<grid, NW_THREADS, smem, stream>>>(a, p, out_dtype == BF16);
  return (int)cudaGetLastError();
}

// The W8A8 narrow tile at the int8 width nw_cols picks (the grid counted
// as blocks x batch), with room for 4 rows of sums a lane at M <= 4 and 16
// above (nw_cols gives 128 columns at M <= 4 only); x fp32 or bf16
template <typename TX, bool DUAL>
int launch_qw_w(const Args& a, int out_dtype, int batch, cudaStream_t stream,
                size_t* smem_only) {
  const bool few = a.M <= 4;
  switch (nw_cols(a.M, a.N, true, batch)) {
    case 16:
      return few ? launch_qw<TX, 16, 4, DUAL>(a, out_dtype, batch, stream,
                                               smem_only)
                 : launch_qw<TX, 16, 16, DUAL>(a, out_dtype, batch, stream,
                                                smem_only);
    case 32:
      return few ? launch_qw<TX, 32, 4, DUAL>(a, out_dtype, batch, stream,
                                               smem_only)
                 : launch_qw<TX, 32, 16, DUAL>(a, out_dtype, batch, stream,
                                                smem_only);
    case 64:
      return few ? launch_qw<TX, 64, 4, DUAL>(a, out_dtype, batch, stream,
                                               smem_only)
                 : launch_qw<TX, 64, 16, DUAL>(a, out_dtype, batch, stream,
                                                smem_only);
    case 128:
      if (few)
        return launch_qw<TX, 128, 4, DUAL>(a, out_dtype, batch, stream,
                                           smem_only);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <bool DUAL>
int launch_qw_x(const Args& a, int x_dtype, int out_dtype, int batch,
                cudaStream_t stream, size_t* smem_only = nullptr) {
  if (x_dtype == F32)
    return launch_qw_w<float, DUAL>(a, out_dtype, batch, stream, smem_only);
  if (x_dtype == BF16)
    return launch_qw_w<__nv_bfloat16, DUAL>(a, out_dtype, batch, stream,
                                            smem_only);
  return (int)cudaErrorInvalidValue;
}

// Launch with the deepest ring (up to TC_MAX_STAGES steps) inside the
// tile's budget, at least two steps where they fit the SM, else one.
// smem_only: report the dynamic shared memory the launch takes, and
// launch nothing.
template <typename TO, int BM, int BN, int WM, int WN, bool DUAL, bool EXPERT,
          bool QUANT>
int launch_tc_k(const Args& a, int batch, cudaStream_t stream,
                size_t* smem_only) {
  using L = TcLayout<BM, BN, DUAL, QUANT>;
  const size_t step_bytes = (size_t)L::SLOT * a.k_collapse;
  int stages = TC_MAX_STAGES;
  while (stages > 2 && stages * step_bytes > L::BUDGET) --stages;
  if (stages * step_bytes > (size_t)MAX_SMEM) stages = 1;
  const size_t smem = std::max(stages * step_bytes, sizeof(float) * L::CTILE);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem_only != nullptr) {
    *smem_only = smem;
    return 0;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      af_gemm_tc_kernel<TO, BM, BN, WM, WN, DUAL, EXPERT, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  af_gemm_tc_kernel<TO, BM, BN, WM, WN, DUAL, EXPERT, QUANT>
      <<<grid, WM * WN * 32, smem, stream>>>(a, stages);
  return (int)cudaGetLastError();
}

// K1 (batch 1) or K2's expert axis (batch > 1): only the latter offsets
// its operands per blockIdx.z.  QUANT (int8 codes): K1's W8 form, and K2's
// int8-only MoE banks above 16 rows (the prefill tiles only: at T <= 16
// the banks take the narrow FFMA tile).
template <typename TO, int BM, int BN, int WM, int WN, bool DUAL, bool QUANT>
int launch_tc(const Args& a, int batch, cudaStream_t stream,
              size_t* smem_only) {
  if (batch > 1) {
    if constexpr (!QUANT || (BM > 16 && !DUAL))
      return launch_tc_k<TO, BM, BN, WM, WN, DUAL, true, QUANT>(
          a, batch, stream, smem_only);
    return (int)cudaErrorInvalidValue;
  }
  if (batch != 1) return (int)cudaErrorInvalidValue;
  return launch_tc_k<TO, BM, BN, WM, WN, DUAL, false, QUANT>(a, 1, stream,
                                                              smem_only);
}

// decode-sized M (one m16 row tile, 32 columns a block in 4 warps) or the
// prefill tiles (128 x 128; 128 x 64 for the dual pair and for N <= 64,
// attn.pv's head dim, which would leave half of a 128-wide tile empty);
// `batch` blocks along z
template <typename TO, bool DUAL, bool QUANT = false>
int launch_tc_m(const Args& a, int batch, cudaStream_t stream,
                size_t* smem_only = nullptr) {
  if (a.M <= 16)
    return launch_tc<TO, 16, 32, 1, 4, DUAL, QUANT>(a, batch, stream,
                                                     smem_only);
  if constexpr (!DUAL)
    if (a.N > 64)
      return launch_tc<TO, 128, 128, 2, 4, false, QUANT>(a, batch, stream,
                                                          smem_only);
  return launch_tc<TO, 128, 64, 4, 2, DUAL, QUANT>(a, batch, stream,
                                                   smem_only);
}

}  // namespace

// X[M,K] @ W[K,N] (+ W2) with the fused prologue/epilogue on the FFMA
// kernels: x/w/w2 and the residual fp32 (in_dtype 0; bf16 operands take
// af_gemm_tc); bias, bias2 and g are fp32.  A null pointer turns its
// operand off.  M <= 16 (decode) takes the narrow tile -- K in 16 fixed
// slices, one or two contractions, any N, the width from M and N -- and
// larger M the FFMA wide tile (one fmaf chain an output).  Returns
// cudaGetLastError() of the launch.
extern "C" int af_gemm(int in_dtype, int out_dtype, const void* x,
                       const void* w, const void* w2, const float* bias,
                       const float* bias2, const void* residual,
                       const float* g, void* out, int M, int N, int K,
                       long long ldx, long long ldw, long long ldr,
                       long long ldo, int k_collapse, int activation,
                       void* stream) {
  if (k_collapse < 1 || M < 1 || N < 1 || K < 1 || in_dtype != F32)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, w2, nullptr, nullptr, bias, bias2, residual, g, out, M, N, K,
         ldx, ldw, ldr, ldo, 0, 0, 0, 0, k_collapse, activation, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dual = w2 != nullptr;
  if (M <= 16)
    return dual ? launch_narrow_w<float, float, true, false>(a, out_dtype, 1, s)
                : launch_narrow_w<float, float, false, false>(a, out_dtype, 1,
                                                              s);
  return dual ? launch_ffma<float, true>(a, out_dtype, 1, s)
              : launch_ffma<float, false>(a, out_dtype, 1, s);
}

// The same function on the tensor-core kernel: x/w/w2 and the residual
// bf16, out fp32 or bf16 (out_dtype), bias, bias2 and g fp32.  Returns
// cudaGetLastError() of the launch.
extern "C" int af_gemm_tc(int out_dtype, const void* x, const void* w,
                          const void* w2, const float* bias,
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
  if (out_dtype == F32)
    return dual ? launch_tc_m<float, true>(a, 1, s)
                : launch_tc_m<float, false>(a, 1, s);
  if (out_dtype == BF16)
    return dual ? launch_tc_m<__nv_bfloat16, true>(a, 1, s)
                : launch_tc_m<__nv_bfloat16, false>(a, 1, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) af_gemm_tc / af_expert_gemm_tc (quant = 0)
// or af_gemm_q_tc (quant = 1) take at M rows (T for the expert form), N
// columns, k_collapse and dual; -1 where they refuse the launch.
extern "C" long long af_gemm_tc_smem(int M, int N, int k_collapse, int dual,
                                     int quant) {
  if (M < 1 || N < 1 || k_collapse < 1) return -1;
  Args a{};
  a.M = M;
  a.N = N;
  a.k_collapse = k_collapse;
  size_t smem = 0;
  int rc;
  if (quant)
    rc = dual ? launch_tc_m<float, true, true>(a, 1, nullptr, &smem)
              : launch_tc_m<float, false, true>(a, 1, nullptr, &smem);
  else
    rc = dual ? launch_tc_m<float, true>(a, 1, nullptr, &smem)
              : launch_tc_m<float, false>(a, 1, nullptr, &smem);
  return rc == 0 ? (long long)smem : -1;
}

// X[M,K] @ W[K,N] (+ W2) on int8 weight codes w/w2 with fp32 per-column
// scales w_scale/w2_scale (required), the same prologue/epilogue as
// af_gemm; x and the residual have dtype `x_dtype`.  act_quant = 0: W8 on
// fp32 x (bf16 x takes af_gemm_q_tc), on the narrow tile at M <= 16 (the
// codes through its cp.async ring, widened exactly to fp32 as they leave
// shared memory, the scales first at the store), else on the FFMA wide
// tile (the codes staged as int8, widened as its fragments are read);
// act_quant = 1: W8A8 on the reference's x tiles of
// quant_bm rows (M itself, or at M > 16 a multiple of 128) by quant_kk
// columns (k_collapse is then only part of how quant_kk was chosen), on
// the W8A8 narrow tile at M <= 16 (x quantized once a block, the codes
// through the warp rings, the width from M and N), else the quantize pass
// into `scratch` (scratch_bytes, 16-byte aligned: af_w8a8_scratch_bytes)
// and the int8 tensor-core tile, two launches on `stream`.
extern "C" int af_gemm_q(int x_dtype, int out_dtype, int act_quant,
                         const void* x, const void* w, const void* w2,
                         const float* w_scale, const float* w2_scale,
                         const float* bias, const float* bias2,
                         const void* residual, const float* g, void* out,
                         int M, int N, int K, long long ldx, long long ldw,
                         long long ldr, long long ldo, int k_collapse,
                         int activation, int quant_bm, int quant_kk,
                         void* scratch, long long scratch_bytes,
                         void* stream) {
  const bool dual = w2 != nullptr;
  if (k_collapse < 1 || M < 1 || N < 1 || K < 1 || w_scale == nullptr ||
      (dual && w2_scale == nullptr) || (!act_quant && x_dtype != F32))
    return (int)cudaErrorInvalidValue;      // bf16 x under W8: af_gemm_q_tc
  Args a{x, w, w2, w_scale, w2_scale, bias, bias2, residual, g, out, M, N,
         K, ldx, ldw, ldr, ldo, 0, 0, 0, 0, k_collapse, activation, quant_bm,
         quant_kk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_quant && M <= 16)
    return dual ? launch_qw_x<true>(a, x_dtype, out_dtype, 1, s)
                : launch_qw_x<false>(a, x_dtype, out_dtype, 1, s);
  if (act_quant)
    return dual ? launch_qt<true>(a, x_dtype, out_dtype, 1, scratch,
                                  scratch_bytes, s)
                : launch_qt<false>(a, x_dtype, out_dtype, 1, scratch,
                                   scratch_bytes, s);
  if (M <= 16)
    return dual ? launch_narrow_w<float, int8_t, true, false>(a, out_dtype, 1,
                                                              s)
                : launch_narrow_w<float, int8_t, false, false>(a, out_dtype,
                                                               1, s);
  return dual ? launch_ffma<int8_t, true>(a, out_dtype, 1, s)
              : launch_ffma<int8_t, false>(a, out_dtype, 1, s);
}

// W8 on the tensor-core kernel: x and the residual bf16, w/w2 int8 codes
// with fp32 per-column scales w_scale/w2_scale (required), out fp32 or bf16
// (out_dtype), the same prologue/epilogue as af_gemm_tc with the dequant
// first at the store.  Returns cudaGetLastError() of the launch.
extern "C" int af_gemm_q_tc(int out_dtype, const void* x, const void* w,
                            const void* w2, const float* w_scale,
                            const float* w2_scale, const float* bias,
                            const float* bias2, const void* residual,
                            const float* g, void* out, int M, int N, int K,
                            long long ldx, long long ldw, long long ldr,
                            long long ldo, int k_collapse, int activation,
                            void* stream) {
  const bool dual = w2 != nullptr;
  if (k_collapse < 1 || M < 1 || N < 1 || K < 1 || w_scale == nullptr ||
      (dual && w2_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x, w, w2, w_scale, w2_scale, bias, bias2, residual, g, out, M, N, K,
         ldx, ldw, ldr, ldo, 0, 0, 0, 0, k_collapse, activation, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == F32)
    return dual ? launch_tc_m<float, true, true>(a, 1, s)
                : launch_tc_m<float, false, true>(a, 1, s);
  if (out_dtype == BF16)
    return dual ? launch_tc_m<__nv_bfloat16, true, true>(a, 1, s)
                : launch_tc_m<__nv_bfloat16, false, true>(a, 1, s);
  return (int)cudaErrorInvalidValue;
}

// K2's fp32 x (TW w) at T <= 16 on the narrow tile, 32 columns a block,
// the expert on z
template <typename TW>
int launch_expert_narrow(const Args& a, int out_dtype, int E,
                         cudaStream_t stream, size_t* smem_only = nullptr) {
  return launch_narrow<float, TW, NW_EXPERT_COLS, 16, false, true>(
      a, out_dtype, E, stream, smem_only);
}

// X[E,T,K] @ W[E,K,N] -> out[E,T,N] on the FFMA kernels, all contiguous:
// x and w fp32, or (fp32, bf16), the fp32-query x bf16-cache attention
// product (bf16 x bf16 takes af_expert_gemm_tc).  T <= 16 (decode: an MoE
// bank's capacity rows, a KV head's query rows) takes the narrow tile, K
// in 16 fixed slices, larger T the FFMA wide tile; E <= 65535.
extern "C" int af_expert_gemm(int x_dtype, int w_dtype, int out_dtype,
                              const void* x, const void* w, void* out, int E,
                              int T, int K, int N, int k_collapse,
                              void* stream) {
  if (k_collapse < 1 || E < 1 || E > 65535 || T < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         out, T, N, K, K, N, 0, N, (long long)T * K, (long long)K * N,
         (long long)T * N, 0, k_collapse, ACT_NONE, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype != F32 || (w_dtype != F32 && w_dtype != BF16))
    return (int)cudaErrorInvalidValue;
  if (T <= 16) {
    return w_dtype == F32
               ? launch_expert_narrow<float>(a, out_dtype, E, s)
               : launch_expert_narrow<__nv_bfloat16>(a, out_dtype, E, s);
  }
  return w_dtype == F32
             ? launch_ffma<float, false>(a, out_dtype, E, s)
             : launch_ffma<__nv_bfloat16, false>(a, out_dtype, E, s);
}

// The narrow FFMA tile at M rows (T for the expert form), N columns, K,
// k_collapse, x of x_dtype (0 fp32, 1 bf16) and w of w_dtype (0 fp32, 1
// bf16, 2 int8 codes), one or two contractions, as K1's tile (expert = 0:
// fp32 x, fp32 or int8 w) or K2's over `expert` experts (fp32 x with fp32
// or bf16 w, or the int8-only form: fp32 or bf16 x, int8 w; one
// contraction): af_narrow_smem gives the dynamic shared memory (bytes) of
// one launch (one expert's grid for K2: the ring budget does not depend on
// E), af_narrow_cols its width; -1 where the tile does not take the launch.
extern "C" long long af_narrow_smem(int M, int N, int K, int k_collapse,
                                    int w_dtype, int dual, int expert,
                                    int x_dtype) {
  if (M < 1 || M > 16 || N < 1 || K < 1 || k_collapse < 1 || expert < 0 ||
      expert > 65535 || (x_dtype != F32 && x_dtype != BF16))
    return -1;
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_collapse = k_collapse;
  size_t smem = 0;
  int rc = (int)cudaErrorInvalidValue;
  if (expert && !dual && w_dtype == I8)
    rc = x_dtype == F32
             ? launch_narrow_w<float, int8_t, false, true>(a, F32, expert,
                                                           nullptr, &smem)
             : launch_narrow_w<__nv_bfloat16, int8_t, false, true>(
                   a, F32, expert, nullptr, &smem);
  else if (x_dtype != F32)
    rc = (int)cudaErrorInvalidValue;
  else if (expert && !dual && w_dtype == F32)
    rc = launch_expert_narrow<float>(a, F32, 1, nullptr, &smem);
  else if (expert && !dual && w_dtype == BF16)
    rc = launch_expert_narrow<__nv_bfloat16>(a, F32, 1, nullptr, &smem);
  else if (!expert && (w_dtype == F32 || w_dtype == I8)) {
    if (w_dtype == F32)
      rc = dual ? launch_narrow_w<float, float, true, false>(a, F32, 1,
                                                             nullptr, &smem)
                : launch_narrow_w<float, float, false, false>(a, F32, 1,
                                                              nullptr, &smem);
    else
      rc = dual ? launch_narrow_w<float, int8_t, true, false>(a, F32, 1,
                                                              nullptr, &smem)
                : launch_narrow_w<float, int8_t, false, false>(
                      a, F32, 1, nullptr, &smem);
  }
  return rc == 0 ? (long long)smem : -1;
}

extern "C" int af_narrow_cols(int M, int N, int w_dtype, int expert) {
  if (M < 1 || M > 16 || N < 1 || expert < 0 || expert > 65535) return -1;
  if (expert && w_dtype == I8) return nw_cols(M, N, true, expert);
  if (expert) return w_dtype == F32 || w_dtype == BF16 ? NW_EXPERT_COLS : -1;
  if (w_dtype != F32 && w_dtype != I8) return -1;
  return nw_cols(M, N, w_dtype == I8);
}

// The FFMA wide tile (K1's fp32 and W8 forms at M > 16, K2's fp32 and
// int8-only forms on fp32 x at T > 16) at M rows, N columns, `batch`
// experts (1 for K1), k_collapse and w of w_dtype (0 fp32, 1 bf16, 2 int8
// codes), one or two contractions: the dynamic shared memory (bytes) of one
// launch; -1 where the tile does not take it.
extern "C" long long af_ffma_smem(int M, int N, int batch, int k_collapse,
                                  int w_dtype, int dual) {
  if (M <= 16 || N < 1 || batch < 1 || k_collapse < 1 ||
      (dual && w_dtype == BF16))
    return -1;
  Args a{};
  a.M = M;
  a.N = N;
  a.k_collapse = k_collapse;
  size_t smem = 0;
  int rc = (int)cudaErrorInvalidValue;
  if (w_dtype == F32)
    rc = dual ? launch_ffma<float, true>(a, F32, batch, nullptr, &smem)
              : launch_ffma<float, false>(a, F32, batch, nullptr, &smem);
  else if (w_dtype == I8)
    rc = dual ? launch_ffma<int8_t, true>(a, F32, batch, nullptr, &smem)
              : launch_ffma<int8_t, false>(a, F32, batch, nullptr, &smem);
  else if (w_dtype == BF16)
    rc = launch_ffma<__nv_bfloat16, false>(a, F32, batch, nullptr, &smem);
  return rc == 0 ? (long long)smem : -1;
}

// The W8A8 narrow tile (af_gemm_q / af_expert_gemm_q with act_quant at M,
// or T, <= 16) over `batch` experts (1 for K1): af_w8a8_cols gives its
// width, af_w8a8_smem the dynamic shared memory (bytes) of one launch at
// quantization steps of quant_kk columns, one or two contractions; -1 where
// the tile does not take the launch.
extern "C" int af_w8a8_cols(int M, int N, int batch) {
  if (M < 1 || M > 16 || N < 1 || batch < 1 || batch > 65535) return -1;
  return nw_cols(M, N, true, batch);
}

extern "C" long long af_w8a8_smem(int M, int N, int K, int quant_kk,
                                  int dual, int batch) {
  if (M < 1 || M > 16 || N < 1 || K < 1 || quant_kk < 1 || batch < 1 ||
      batch > 65535 || (dual && batch != 1))
    return -1;
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.quant_bm = M;
  a.quant_kk = quant_kk;
  size_t smem = 0;
  const int rc = dual ? launch_qw_x<true>(a, F32, F32, 1, nullptr, &smem)
                      : launch_qw_x<false>(a, F32, F32, batch, nullptr, &smem);
  return rc == 0 ? (long long)smem : -1;
}

// The same batched product on the tensor-core kernel: x and w bf16, out
// fp32 or bf16 (out_dtype), all contiguous; each expert a z-slice of the
// af_gemm_tc grid (E <= 65535).  Returns cudaGetLastError() of the launch.
extern "C" int af_expert_gemm_tc(int out_dtype, const void* x, const void* w,
                                 void* out, int E, int T, int K, int N,
                                 int k_collapse, void* stream) {
  if (k_collapse < 1 || E < 1 || E > 65535 || T < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         out, T, N, K, K, N, 0, N, (long long)T * K, (long long)K * N,
         (long long)T * N, 0, k_collapse, ACT_NONE, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == F32) return launch_tc_m<float, false>(a, E, s);
  if (out_dtype == BF16) return launch_tc_m<__nv_bfloat16, false>(a, E, s);
  return (int)cudaErrorInvalidValue;
}

// X[E,T,K] @ W[E,K,N] -> out[E,T,N] on int8 codes, all contiguous: x fp32
// or bf16, w int8 codes, w_scale (E, N) fp32 dequantized per (expert,
// column) at the store; E <= 65535.  act_quant = 0: the int8-only form
// (MoE expert banks under W8): at T <= 16 the narrow tile (x staged in its
// own type, the codes through the warp rings, widened exactly to fp32; the
// width from T, N and E), larger T on fp32 x the FFMA wide tile at
// k_collapse (bf16 x above 16 rows takes af_expert_gemm_q_tc); act_quant
// = 1: W8A8, each expert's x quantized on the reference's tiles of
// quant_bm rows by quant_kk columns: at T <= 16 the W8A8 narrow tile (the
// width from T, N and E, as the int8-only form's), larger T the quantize
// pass into `scratch` (scratch_bytes, 16-byte aligned:
// af_w8a8_scratch_bytes at batch E) and the int8 tensor-core tile, the
// expert on z of both.
extern "C" int af_expert_gemm_q(int x_dtype, int out_dtype, int act_quant,
                                const void* x, const void* w,
                                const float* w_scale, void* out, int E, int T,
                                int K, int N, int k_collapse, int quant_bm,
                                int quant_kk, void* scratch,
                                long long scratch_bytes, void* stream) {
  if (k_collapse < 1 || E < 1 || E > 65535 || T < 1 || N < 1 || K < 1 ||
      w_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, w_scale, nullptr, nullptr, nullptr, nullptr, nullptr,
         out, T, N, K, K, N, 0, N, (long long)T * K, (long long)K * N,
         (long long)T * N, N, k_collapse, ACT_NONE, quant_bm, quant_kk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_quant && T <= 16)
    return launch_qw_x<false>(a, x_dtype, out_dtype, E, s);
  if (act_quant)
    return launch_qt<false>(a, x_dtype, out_dtype, E, scratch, scratch_bytes,
                            s);
  if (T <= 16) {
    if (x_dtype == F32)
      return launch_narrow_w<float, int8_t, false, true>(a, out_dtype, E, s);
    if (x_dtype == BF16)
      return launch_narrow_w<__nv_bfloat16, int8_t, false, true>(
          a, out_dtype, E, s);
    return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == F32) return launch_ffma<int8_t, false>(a, out_dtype, E, s);
  return (int)cudaErrorInvalidValue;     // bf16 x: af_expert_gemm_q_tc
}

// K2's int8-only form above 16 rows on bf16 x (the MoE expert banks of a
// prefill under W8): af_gemm_tc_kernel's QUANT instantiations with the
// expert on blockIdx.z -- its codes offset by the expert's bsw, its
// per-(expert, column) scales by bss at the store, dequant first and one
// cast -- at the prefill tiles (128 x 128; 128 x 64 for N <= 64).  x bf16,
// w int8 codes, w_scale (E, N) fp32, out fp32 or bf16 (out_dtype), all
// contiguous; T > 16, E <= 65535.  Returns cudaGetLastError() of the
// launch.
extern "C" int af_expert_gemm_q_tc(int out_dtype, const void* x,
                                   const void* w, const float* w_scale,
                                   void* out, int E, int T, int K, int N,
                                   int k_collapse, void* stream) {
  if (k_collapse < 1 || E < 1 || E > 65535 || T <= 16 || N < 1 || K < 1 ||
      w_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, nullptr, w_scale, nullptr, nullptr, nullptr, nullptr, nullptr,
         out, T, N, K, K, N, 0, N, (long long)T * K, (long long)K * N,
         (long long)T * N, N, k_collapse, ACT_NONE, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == F32) return launch_tc_m<float, false, true>(a, E, s);
  if (out_dtype == BF16)
    return launch_tc_m<__nv_bfloat16, false, true>(a, E, s);
  return (int)cudaErrorInvalidValue;
}

// W8A8 above 16 rows (af_gemm_q / af_expert_gemm_q with act_quant at M, or
// T, > 16) over `batch` experts (1 for K1), quantization tiles of quant_bm
// rows by quant_kk columns: af_w8a8_scratch_bytes gives the scratch one
// launch needs (codes, then scales), af_w8a8_tc_cols the tile's width and
// af_w8a8_tc_smem its dynamic shared memory; -1 where the tile does not
// take the launch (M <= 16, or a quant_bm that splits a block).
extern "C" long long af_w8a8_scratch_bytes(int M, int K, int quant_bm,
                                           int quant_kk, int batch) {
  Args a{};
  a.M = M;
  a.N = 1;
  a.K = K;
  a.quant_bm = quant_bm;
  a.quant_kk = quant_kk;
  QtLayout l;
  if (M <= 16 || qt_check(a, F32, F32, batch, nullptr, 0, l, true) != 0)
    return -1;
  return l.bytes;
}

extern "C" int af_w8a8_tc_cols(int M, int N, int dual, int batch) {
  if (M <= 16 || N < 1 || batch < 1 || batch > 65535 || (dual && batch != 1))
    return -1;
  return qt_cols(M, N, dual != 0, batch);
}

extern "C" long long af_w8a8_tc_smem(int M, int N, int K, int quant_bm,
                                     int quant_kk, int dual, int batch) {
  if (M <= 16 || (dual && batch != 1)) return -1;
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.quant_bm = quant_bm;
  a.quant_kk = quant_kk;
  size_t smem = 0;
  const int rc =
      dual ? launch_qt<true>(a, F32, F32, 1, nullptr, 0, nullptr, &smem)
           : launch_qt<false>(a, F32, F32, batch, nullptr, 0, nullptr, &smem);
  return rc == 0 ? (long long)smem : -1;
}

// The quantize pass of W8A8 above 16 rows alone (its time and its output
// are measured and checked on their own): x [batch][M][K] of x_dtype (rows
// ldx, experts bsx elements apart) with the rmsnorm scale g (null: none)
// into `scratch` in af_w8a8_scratch_bytes's layout.  Returns
// cudaGetLastError() of the launch.
extern "C" int af_w8a8_quantize(int x_dtype, const void* x, const float* g,
                                void* scratch, long long scratch_bytes,
                                int M, int K, long long ldx, long long bsx,
                                int batch, int quant_bm, int quant_kk,
                                void* stream) {
  Args a{};
  a.x = x;
  a.g = g;
  a.M = M;
  a.N = 1;
  a.K = K;
  a.ldx = ldx;
  a.bsx = bsx;
  a.quant_bm = quant_bm;
  a.quant_kk = quant_kk;
  QtLayout l;
  if (M <= 16) return (int)cudaErrorInvalidValue;
  const int rc =
      qt_check(a, x_dtype, F32, batch, scratch, scratch_bytes, l, false);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == F32
             ? launch_qt_quant<float>(a, l, scratch, batch, s)
             : launch_qt_quant<__nv_bfloat16>(a, l, scratch, batch, s);
}
