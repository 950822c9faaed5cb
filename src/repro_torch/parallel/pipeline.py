"""GPipe-style pipeline parallelism over a mesh's "pod" axis, driven by
one controller.

Port of the reference's ``parallel/pipeline.py``.  The reference runs its
schedules inside ``shard_map``: every stage executes at every tick (on
placeholder zeros where it has no real input, so the loop body traces
once) and activations hop stage to stage by ``collective_permute``.  The
port's single controller runs each stage once, in order, on its own
device — the hop is a ``.to(next_device)`` — so a pipelined step launches
exactly the kernels a colocated step launches, and no stage computes a
placeholder.  Each stage's work is the same function on the same inputs,
so the values are the reference's.

``staged_step`` is the single-microbatch serving schedule the
disaggregated engine pipelines its decode and prefill steps with;
``gpipe`` / ``make_pipelined`` the generic multi-microbatch schedule.
The cost model at the bottom (``PipelineCost`` ... ``plan``) is the
reference's, copied: it is framework-free.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.runtime import to_device
from repro_torch.roofline import trace as _trace


def stage_devices(mesh, axis_name: str = "pod"):
    """The device of each stage: the mesh's devices along ``axis_name``
    (index 0 on every other axis)."""
    return [mesh.device({axis_name: s})
            for s in range(mesh.shape[axis_name])]


def staged_step(fn, x0, states, devices):
    """Single-microbatch pipeline step (serving path).

    ``fn(s, x, state) -> (y, new_state)`` is stage ``s``'s layer block on
    its slice of the model; ``x0`` the stage-0 input (the embedded token
    chunk); ``states`` each stage's cache slice; ``devices`` each stage's
    device.  Stage ``s`` runs once, on the activation stage ``s - 1`` sent
    it, and commits its own state.  Returns ``(y_last, states)``: the
    last stage's output, on its device, and the committed states — the
    reference's ``staged_step`` with its placeholder ticks left out (they
    commit nothing and their outputs are masked away).  Each hand-off to
    the next stage is a collective-permute (``roofline.trace``)."""
    states = list(states)
    x = x0
    for s, dev in enumerate(devices):
        if s:
            _trace.collective("collective-permute", x, 2)
        x, states[s] = fn(s, to_device(x, dev), states[s])
    return x, states


def gpipe(fn, stage_params, x_micro, devices):
    """Run a P-stage pipeline over M microbatches.

    fn: (params_i, x) -> y, same shape.  stage_params: one params object
    per stage (on that stage's device).  x_micro: (M, mb, d)
    microbatches.  Tick ``t`` runs stage ``s`` on microbatch ``t - s``
    (the GPipe fill/drain schedule of ``M + P - 1`` ticks); the last
    stage's outputs are gathered, in microbatch order, on x_micro's
    device (the reference's final broadcast)."""
    P, M = len(devices), x_micro.shape[0]
    home = x_micro.device
    outputs = [None] * M
    inflight = [None] * P         # the activation each stage receives
    for t in range(M + P - 1):
        # the last stage first, so a stage's input this tick is the one
        # its predecessor produced at the previous tick
        for s in reversed(range(P)):
            m = t - s
            if not 0 <= m < M:
                continue
            x_in = x_micro[m] if s == 0 else inflight[s]
            y = fn(stage_params[s], to_device(x_in, devices[s]))
            if s == P - 1:
                outputs[m] = to_device(y, home)
            else:
                _trace.collective("collective-permute", y, 2)
                inflight[s + 1] = to_device(y, devices[s + 1])
    return torch.stack(outputs)


def make_pipelined(fn, mesh, *, axis_name: str = "pod"):
    """The pipelined function of ``fn`` over ``mesh``'s ``axis_name``:
    ``(stage_params, x_micro) -> outputs``, ``stage_params`` a sequence
    with one params tree per stage (the reference stacks them on axis 0),
    each moved to its stage's device."""
    devices = stage_devices(mesh, axis_name)

    def place(tree, dev):
        if isinstance(tree, dict):
            return {k: place(v, dev) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(place(v, dev) for v in tree)
        return to_device(tree, dev)

    def run(stage_params, x_micro):
        if len(stage_params) != len(devices):
            raise ValueError(f"{len(stage_params)} stage params for "
                             f"{len(devices)} stages")
        placed = [place(p, d) for p, d in zip(stage_params, devices)]
        return gpipe(fn, placed, x_micro, devices)

    return run


# ---------------------------------------------------------------------------
# ArrayFlex-at-cluster-scale: pipeline-depth planning with Eq.(6)/(7).
#
# The paper's tradeoff — merge pipeline stages to cut cycle count at the
# cost of a slower clock — recurs one level up in pipeline parallelism
# across pods:
#
#   collapse k pods into one pipeline stage
#     -> fewer stages  P(k) = P/k          (shorter fill/drain "skew"),
#     -> slower "clock" per stage: stage time grows with the per-stage layer
#        count, exactly T_clock(k) = d_base + k*d_inc with
#        d_base = per-microbatch dispatch/collective overhead and
#        d_inc  = per-pod layer compute time.
#
# GPipe latency for M microbatches on P/k stages:
#   T = (M + P/k - 1) * T_stage(k)   — isomorphic to Eq.(6) with T<-M, R,C<-P.
# Setting dT/dk = 0 reproduces Eq.(7) with the same structure; the discrete
# argmin below picks the deployed stage count.


@dataclass(frozen=True)
class PipelineCost:
    n_pods: int                 # P: pods available (max pipeline stages)
    microbatches: int           # M: per-step microbatches
    layer_time_ms: float        # per-pod layer-block compute time
    overhead_ms: float          # per-microbatch stage overhead (dispatch+p2p)


def stage_time_ms(c: PipelineCost, k: int) -> float:
    """T_clock analogue: time of one collapsed stage (k pods' layers)."""
    return c.overhead_ms + k * c.layer_time_ms


def pipeline_latency_ms(c: PipelineCost, k: int) -> float:
    """Eq.(6) analogue: (M + P/k - 1) * T_stage(k)."""
    stages = max(1, c.n_pods // k)
    return (c.microbatches + stages - 1) * stage_time_ms(c, k)


def k_hat(c: PipelineCost) -> float:
    """Eq.(7) analogue (continuous optimum)."""
    if c.microbatches <= 1:
        return float(c.n_pods)
    return math.sqrt(c.n_pods * c.overhead_ms
                     / ((c.microbatches - 1) * c.layer_time_ms))


def best_collapse(c: PipelineCost) -> int:
    ks = [k for k in range(1, c.n_pods + 1) if c.n_pods % k == 0]
    return min(ks, key=lambda k: pipeline_latency_ms(c, k))


def plan(c: PipelineCost) -> dict:
    k = best_collapse(c)
    base = pipeline_latency_ms(c, 1)
    bestt = pipeline_latency_ms(c, k)
    return {
        "k": k, "k_hat": k_hat(c), "stages": c.n_pods // k,
        "latency_ms": bestt, "latency_ms_k1": base,
        "saving": 1.0 - bestt / base,
        "bubble_fraction": (c.n_pods // k - 1)
        / (c.microbatches + c.n_pods // k - 1),
    }
