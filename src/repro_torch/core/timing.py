"""ArrayFlex latency & clock models — Eqs. (1)-(7) of the paper.

Matrix multiply X[T,M] = A[T,N] x B[N,M] on an R x C weight-stationary SA:

  Eq.(1)  L        = 2R + C + T - 2                     (conventional, k=1)
  Eq.(3)  L(k)     = R + R/k + C/k + T - 2              (k-collapsed)
  Eq.(4)  L_tot(k) = L(k) * ceil(N/R) * ceil(M/C)
  Eq.(5)  T_clk(k) = d_FF + d_mul + d_add + k(d_CSA + 2 d_mux)
  Eq.(6)  T_abs(k) = L_tot(k) * T_clk(k)
  Eq.(7)  k_hat    = sqrt( (R+C)/(R+T-2) * (d_FF+d_mul+d_add)/(d_CSA+2d_mux) )

Fused epilogues (bias add, activation, gated multiply) extend Eq.(5): the
carry-propagate stage at the collapsed-block boundary gains ``e`` fused
vector operations, each adding ``d_epi`` to the critical path, so

  Eq.(5')  T_clk(k, e) = T_clk(k) + e * d_epi
  Eq.(6')  T_abs(k, e) = n_con * L_tot(k) * T_clk(k, e)

where ``n_con`` counts fused contractions (2 for the dual-GEMM swiglu
epilogue, which streams both weight matrices through the same collapsed
schedule).  Because the epilogue term is k-independent while the cycle
count falls with k, a fused epilogue shifts the Eq.(6) argmin toward
deeper collapse — ``best_k`` re-picks k accordingly.

Clock numbers are calibrated to the paper's 28nm silicon results:
conventional SA 2.0 GHz; ArrayFlex 1.8 / 1.7 / 1.4 GHz at k = 1 / 2 / 4.
A least-squares fit of Eq.(5) to those three points gives
d_base = 492.6 ps and d_inc = 54.4 ps (the 'linear' model); 'table' mode
uses the published frequencies exactly and falls back to the fit elsewhere.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class TimingParams:
    # Eq.(5) coefficients (ps), least-squares fit to the paper's silicon
    d_base_ps: float = 492.6      # d_FF + d_mul + d_add
    d_inc_ps: float = 54.35       # d_CSA + 2*d_mux
    conventional_period_ps: float = 500.0   # 2.0 GHz fixed-pipeline SA
    # published ArrayFlex operating points (GHz)
    freq_table_ghz: tuple = ((1, 1.8), (2, 1.7), (4, 1.4))
    mode: str = "table"           # "table" | "linear"
    supported_k: tuple = (1, 2, 4)
    # Eq.(5') epilogue coefficient: critical-path cost of one fused vector
    # op (bias add / activation / gated multiply) at the carry-propagate
    # stage.  Sized like a CSA+mux stage — the epilogue ALU sits behind the
    # same collapsed-block boundary the carry-propagate adder does.
    d_epilogue_ps: float = 54.35
    # Eq.(5') activation-quantize coefficient: critical-path cost of the
    # dynamic per-tile quantizer (amax reduce + reciprocal scale +
    # round/clip) that feeds the MAC datapath each collapsed-block step.
    # 0 on datapaths with no quantize boundary (fp32, weight-only int8 —
    # activations arrive at datapath width there).
    d_actq_ps: float = 0.0

    def clock_period_ps(self, k: int, epilogue_ops: int = 0,
                        actq_ops: int = 0) -> float:
        """Eq.(5'): minimum clock period of a k-collapsed ArrayFlex
        pipeline with ``epilogue_ops`` fused vector ops and ``actq_ops``
        activation-quantize stages at the boundary."""
        epi = (epilogue_ops * self.d_epilogue_ps
               + actq_ops * self.d_actq_ps)
        if self.mode == "table":
            for kk, ghz in self.freq_table_ghz:
                if kk == k:
                    return 1000.0 / ghz + epi
        return self.d_base_ps + k * self.d_inc_ps + epi

    def clock_ghz(self, k: int, epilogue_ops: int = 0,
                  actq_ops: int = 0) -> float:
        return 1000.0 / self.clock_period_ps(k, epilogue_ops, actq_ops)


DEFAULT_TIMING = TimingParams()


@dataclass(frozen=True)
class IntTimingParams(TimingParams):
    """Eq.(5)/(7) coefficients for an **int8-weight** ArrayFlex datapath
    (fp32 accumulation, per-output-channel dequant at the boundary).

    What changes vs the fp32 fit and why:

    * ``d_base_ps`` (= d_FF + d_mul + d_add) shrinks *moderately*: the
      8x8 multiplier is far smaller than the fp32 one, but d_FF and the
      accumulate add stay — accumulation is fp32 by contract, so d_add is
      still the fp32 adder.  492.6 -> 372.6 ps (the fitted fp32 d_mul
      shrunk by ~120 ps).
    * ``d_inc_ps`` (= d_CSA + 2 d_mux, the per-k collapse cost) shrinks
      *a lot*: the transparent stages' carry-save chain carries 8-bit
      partial products instead of 32-bit ones, so the CSA stage is a
      single narrow full-adder row and the bypass muxes switch a narrow
      bus.  54.35 -> 15.0 ps.

    Because d_base/d_inc RISES (9.1 -> 24.8), Eq.(7)'s k_hat rises too:
    the int8 datapath amortizes its (cheap) collapse stages over more
    merged pipeline levels, so the Eq.(6') argmin moves toward DEEPER
    collapse than the fp32 datapath picks at the same (M, N, T) — e.g.
    T=512 plans k=2 under fp32 silicon and k=4 here.  There is no
    published int8 silicon to tabulate, so ``mode="linear"`` prices
    every k from the Eq.(5) fit.

    The conventional (fixed-pipeline) int8 SA comparator clocks at
    ``conventional_period_ps = 357.1`` (2.8 GHz): the k=1 linear period
    (387.6 ps) scaled by the same mux-overhead ratio the fp32 numbers
    exhibit (500 / 546.95).

    The per-output-channel dequant multiply is NOT part of these
    coefficients: it resolves at the carry-propagate boundary exactly
    like a fused epilogue op, so the substrate prices it as one extra
    Eq.(5') boundary op per contraction (``d_epilogue_ps``).
    """

    d_base_ps: float = 372.6     # d_FF + d_mul(int8) + d_add(fp32 accum)
    d_inc_ps: float = 15.0       # d_CSA(8-bit chain) + 2*d_mux(narrow bus)
    conventional_period_ps: float = 357.1   # 2.8 GHz fixed-pipeline int8 SA
    freq_table_ghz: tuple = ()
    mode: str = "linear"         # no published int8 silicon: use the fit


INT8_TIMING = IntTimingParams()


@dataclass(frozen=True)
class W8A8TimingParams(IntTimingParams):
    """Eq.(5)/(7) coefficients for the **fully-int8** (W8A8) datapath:
    int8 weights x int8 activations with an int32 accumulator.

    What changes vs the weight-only int8 fit and why:

    * ``d_base_ps`` shrinks again: the weight-only datapath still paid the
      fp32 accumulate adder (``d_add``) because activations arrived at
      fp32 width.  With activations quantized at the boundary the MAC is
      int8 x int8 -> int32 end to end, so d_add is a narrow int32
      carry-select add.  372.6 -> 280.0 ps (~93 ps shaved off the adder).
    * ``d_inc_ps`` stays 15.0: the collapse chain already carried narrow
      partial products under weight-only int8.
    * ``d_actq_ps = 54.35``: the *new* Eq.(5') boundary term.  The dynamic
      per-tile quantizer (amax reduce over the tile, reciprocal scale,
      round/clip to int8) sits at the collapsed-block boundary in front of
      the MAC array, exactly where the carry-propagate/epilogue ALU sits
      behind it, so it is sized like one epilogue stage.  Like the fused
      epilogue term it is k-independent while cycle counts fall with k —
      so pricing the quantize boundary pushes the Eq.(6') argmin toward
      deeper collapse.  On the pinned (M=896, N=4864, T=512) decode cell
      this term is decisive: without it the W8A8 coefficients pick k=2
      (like fp32 silicon), with it the argmin moves to k=4.

    The conventional fixed-pipeline W8A8 comparator clocks at 269.7 ps
    (3.71 GHz): the k=1 linear period (295.0 ps) scaled by the same
    mux-overhead ratio the fp32 numbers exhibit (500 / 546.95).  It pays
    the same ``d_actq_ps`` per period (a fixed pipeline still has to
    quantize), keeping the *saving* a measure of transparent pipelining.

    The per-tile activation scale resolves at the carry-propagate boundary
    together with the weight dequant — the substrate folds both into the
    fused ``store_phase`` dequant, so no extra epilogue op is priced for
    the activation scale beyond the ``d_actq_ps`` stage itself.
    """

    d_base_ps: float = 280.0     # d_FF + d_mul(int8) + d_add(int32 accum)
    conventional_period_ps: float = 269.7   # 3.71 GHz fixed-pipeline W8A8
    d_actq_ps: float = 54.35     # per-tile amax + scale + round/clip stage


W8A8_TIMING = W8A8TimingParams()

# precision name -> the TimingParams pricing that datapath's Eq.(5)-(7)
PRECISION_TIMING = {"fp32": DEFAULT_TIMING, "int8": INT8_TIMING,
                    "w8a8": W8A8_TIMING}


def timing_for(precision: str) -> TimingParams:
    """The Eq.(5)-(7) coefficient set for a datapath precision."""
    try:
        return PRECISION_TIMING[precision]
    except KeyError:
        raise ValueError(f"unknown datapath precision {precision!r}; "
                         f"supported: {sorted(PRECISION_TIMING)}")


def latency_cycles_conventional(R: int, C: int, T: int) -> int:
    """Eq.(1)."""
    return 2 * R + C + T - 2


def latency_cycles(R: int, C: int, T: int, k: int) -> int:
    """Eq.(3).  k must divide R and C for exact collapse."""
    return R + math.ceil(R / k) + math.ceil(C / k) + T - 2


def num_tiles(N: int, M: int, R: int, C: int) -> int:
    return math.ceil(N / R) * math.ceil(M / C)


def total_cycles(M: int, N: int, T: int, R: int, C: int, k: int) -> int:
    """Eq.(4)."""
    return latency_cycles(R, C, T, k) * num_tiles(N, M, R, C)


def total_cycles_conventional(M: int, N: int, T: int, R: int, C: int) -> int:
    return latency_cycles_conventional(R, C, T) * num_tiles(N, M, R, C)


def t_abs_ps(M: int, N: int, T: int, R: int, C: int, k: int,
             params: TimingParams = DEFAULT_TIMING,
             epilogue_ops: int = 0, contractions: int = 1,
             actq_ops: int = 0, extra_cycles: int = 0) -> float:
    """Eq.(6''): absolute execution time (ps) on a k-collapsed ArrayFlex.

    ``epilogue_ops`` prices fused post-GEMM work into the per-step period
    (Eq. 5'); ``actq_ops`` prices the dynamic activation-quantize boundary
    stages of a W8A8 datapath; ``contractions`` > 1 streams that many
    weight matrices through the same collapsed schedule (the dual-GEMM
    swiglu epilogue).  ``extra_cycles`` serializes additional array
    cycles in front of the schedule — the ICI ingress of a
    pipeline-stage activation transfer, clocked at the array's period.
    It multiplies the k-dependent period but not the k-dependent cycle
    count, so unlike the boundary-op terms it pushes the Eq.(6) argmin
    toward SHALLOWER collapse (a k-collapsed array pays the transfer at
    its slower clock).
    """
    return ((contractions * total_cycles(M, N, T, R, C, k) + extra_cycles)
            * params.clock_period_ps(k, epilogue_ops, actq_ops))


def t_abs_conventional_ps(M: int, N: int, T: int, R: int, C: int,
                          params: TimingParams = DEFAULT_TIMING,
                          contractions: int = 1,
                          epilogue_ops: int = 0,
                          actq_ops: int = 0,
                          extra_cycles: int = 0) -> float:
    """Fixed-pipeline SA at its (higher) max clock, with the SAME fused
    epilogue datapath (``epilogue_ops`` boundary ops on the period), the
    SAME activation-quantize stages (``actq_ops``), and the SAME
    serialized transfer cycles (``extra_cycles`` — a fixed pipeline must
    ship stage activations too).  Pricing all three into both machines
    keeps the *saving* a measure of the transparent-pipelining technique
    alone — otherwise every fused GEMM would be charged the epilogue
    against an epilogue-free baseline that must run it as an (uncosted)
    post-pass anyway."""
    return ((contractions * total_cycles_conventional(M, N, T, R, C)
             + extra_cycles)
            * (params.conventional_period_ps
               + epilogue_ops * params.d_epilogue_ps
               + actq_ops * params.d_actq_ps))


def k_hat(R: int, C: int, T: int,
          params: TimingParams = DEFAULT_TIMING) -> float:
    """Eq.(7): continuous optimal collapse depth."""
    return math.sqrt(((R + C) / (R + T - 2))
                     * (params.d_base_ps / params.d_inc_ps))


def best_k(M: int, N: int, T: int, R: int, C: int,
           params: TimingParams = DEFAULT_TIMING,
           epilogue_ops: int = 0, actq_ops: int = 0,
           extra_cycles: int = 0) -> int:
    """Discrete argmin of Eq.(6'') over the supported collapse depths.

    The epilogue and activation-quantize terms are additive on the
    period, so they never change the ordering *between* two depths with
    equal cycle counts but can tip the argmin toward deeper collapse
    (fewer boundary crossings amortize the fixed boundary cost better).
    ``extra_cycles`` (serialized stage-transfer ingress) works the other
    way: every extra cycle is paid at the k-collapsed period, so a
    transfer-heavy GEMM tips toward shallower collapse."""
    return min(params.supported_k,
               key=lambda k: t_abs_ps(M, N, T, R, C, k, params,
                                      epilogue_ops, actq_ops=actq_ops,
                                      extra_cycles=extra_cycles))
