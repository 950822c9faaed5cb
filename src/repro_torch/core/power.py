"""ArrayFlex power / energy / EDP model (paper §IV-B).

Normalized switched-capacitance split of a conventional PE:
  combinational (multiplier+adder) : c_comb
  pipeline registers               : c_reg
  clock tree                       : c_clk
ArrayFlex adds the 3:2 CSA + bypass muxes (c_extra, in series even at k=1 —
the paper's 16% PE area overhead).  In shallow mode a (k-1)/k fraction of the
pipeline registers is bypassed AND clock-gated, removing their register and
clock-tree power.  Dynamic power = f * C_active (leakage is negligible at
28nm relative to the SA's switching power and is omitted, as in the paper's
relative comparisons).

Calibration targets (paper Fig. 9): ArrayFlex consumes slightly MORE power
than conventional in normal mode, 13-15% LESS averaged over full runs on a
128x128 SA, 17-23% less on 256x256, and 1.4-1.8x better EDP.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.timing import TimingParams, DEFAULT_TIMING, \
    t_abs_ps, t_abs_conventional_ps


@dataclass(frozen=True)
class PowerParams:
    c_comb: float = 0.50
    c_reg: float = 0.33
    c_clk: float = 0.17
    c_extra: float = 0.22     # CSA + bypass muxes (ArrayFlex only)
    # fraction of register/clock power that can NOT be gated in shallow mode
    # (weight-stationary regs, output accumulators, control): only the
    # bypassed pipeline registers inside collapsed blocks actually gate.
    reg_active_floor: float = 0.30

    def conventional_cap(self) -> float:
        return self.c_comb + self.c_reg + self.c_clk

    def arrayflex_cap(self, k: int) -> float:
        active = self.reg_active_floor + (1.0 - self.reg_active_floor) / k
        return (self.c_comb + self.c_extra
                + self.c_reg * active + self.c_clk * active)


DEFAULT_POWER = PowerParams()


def power_conventional(tp: TimingParams = DEFAULT_TIMING,
                       pp: PowerParams = DEFAULT_POWER) -> float:
    """Relative dynamic power of the fixed-pipeline SA (arbitrary units)."""
    return tp.clock_ghz(1) * 0.0 + (1000.0 / tp.conventional_period_ps) \
        * pp.conventional_cap()


def power_arrayflex(k: int, tp: TimingParams = DEFAULT_TIMING,
                    pp: PowerParams = DEFAULT_POWER) -> float:
    return tp.clock_ghz(k) * pp.arrayflex_cap(k)


def layer_energy(M, N, T, R, C, k, tp=DEFAULT_TIMING, pp=DEFAULT_POWER):
    """(energy, time_ps) of one layer on ArrayFlex at collapse k."""
    t = t_abs_ps(M, N, T, R, C, k, tp)
    return power_arrayflex(k, tp, pp) * t, t


def layer_energy_conventional(M, N, T, R, C, tp=DEFAULT_TIMING,
                              pp=DEFAULT_POWER):
    t = t_abs_conventional_ps(M, N, T, R, C, tp)
    return power_conventional(tp, pp) * t, t


def network_summary(layers, R, C, tp=DEFAULT_TIMING, pp=DEFAULT_POWER,
                    choose_k=None):
    """Full-run totals for a list of (M, N, T) layers.

    Returns dict with total times, average powers, savings and EDP gain —
    the quantities of paper Figs. 8 & 9.
    """
    from repro_torch.core.timing import best_k
    t_af = e_af = t_cv = e_cv = 0.0
    ks = []
    for (M, N, T) in layers:
        k = choose_k(M, N, T) if choose_k else best_k(M, N, T, R, C, tp)
        ks.append(k)
        e, t = layer_energy(M, N, T, R, C, k, tp, pp)
        e_af += e
        t_af += t
        e, t = layer_energy_conventional(M, N, T, R, C, tp, pp)
        e_cv += e
        t_cv += t
    p_af, p_cv = e_af / t_af, e_cv / t_cv
    return {
        "k_per_layer": ks,
        "time_arrayflex_ps": t_af, "time_conventional_ps": t_cv,
        "latency_saving": 1.0 - t_af / t_cv,
        "avg_power_arrayflex": p_af, "avg_power_conventional": p_cv,
        "power_saving": 1.0 - p_af / p_cv,
        "edp_gain": (p_cv * t_cv * t_cv) / (p_af * t_af * t_af),
    }
