"""Fault tolerance: heartbeats, straggler detection, checkpoint-restart.

At 1000+ nodes, MTBF is minutes-to-hours; the framework's contract is:

  * every host heartbeats every step (step index + step wall-time),
  * the monitor flags DEAD hosts (no heartbeat within `dead_after_s`) and
    STRAGGLERS (step time > `straggler_factor` x the fleet median —
    mitigation: the launcher excludes them at the next restart boundary and
    the elastic planner (runtime.elastic) re-shards),
  * the training driver checkpoints asynchronously every `ckpt_every` steps
    and restarts from the latest durable step on failure, replaying the
    deterministic data pipeline from that step (data.pipeline contract).

On a single-process CPU container the monitor runs in-process (hosts are
simulated), but the logic is the same one a GCS/etcd-backed deployment uses;
tests/test_torch_resilience.py drives the monitor's dead-host and straggler
scenarios, and tests/test_torch_runtime_restart.py the restart loop against
the port's ``checkpoint.CheckpointManager``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np


@dataclass
class Heartbeat:
    step: int
    step_time_s: float
    wall_time: float


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, dead_after_s: float = 60.0,
                 straggler_factor: float = 2.0, clock=time.monotonic):
        self.n_hosts = n_hosts
        self.dead_after_s = dead_after_s
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.beats: Dict[int, Heartbeat] = {}

    def beat(self, host: int, step: int, step_time_s: float):
        self.beats[host] = Heartbeat(step, step_time_s, self.clock())

    def dead_hosts(self):
        now = self.clock()
        out = []
        for h in range(self.n_hosts):
            hb = self.beats.get(h)
            if hb is None or now - hb.wall_time > self.dead_after_s:
                out.append(h)
        return out

    def stragglers(self):
        times = [hb.step_time_s for hb in self.beats.values()]
        if len(times) < max(2, self.n_hosts // 2):
            return []
        med = float(np.median(times))
        return [h for h, hb in self.beats.items()
                if hb.step_time_s > self.straggler_factor * med]


# exceptions the restart loop treats as recoverable node failures by
# default: hardware/runtime crashes and I/O errors.  Programming errors
# (TypeError, ValueError, ...) propagate — restarting cannot fix them and
# retrying silently would loop max_restarts times before surfacing.
RECOVERABLE = (RuntimeError, OSError)


@dataclass
class FaultToleranceManager:
    """Drives the checkpoint-restart loop around a train step."""

    ckpt_manager: object                  # checkpoint.CheckpointManager
    monitor: HeartbeatMonitor
    ckpt_every: int = 100
    max_restarts: int = 100
    host_index: int = 0                   # this process's host id for beats
    restarts: int = field(default=0)
    cold_restarts: int = field(default=0)

    def should_checkpoint(self, step: int) -> bool:
        return step > 0 and step % self.ckpt_every == 0

    def health_action(self) -> str:
        """'ok' | 'restart' (dead host) | 'replan' (stragglers only)."""
        if self.monitor.dead_hosts():
            return "restart"
        if self.monitor.stragglers():
            return "replan"
        return "ok"

    def run(self, state, step_fn: Callable, data_source, n_steps: int,
            inject_failure: Optional[Callable] = None,
            recoverable: tuple = RECOVERABLE,
            cold_restart: str = "raise"):
        """Resumable loop: state must be a pytree the ckpt manager can save.

        `step_fn(state, batch) -> state`; `inject_failure(step)` raises to
        simulate a crash (tests).  Returns (state, steps_run, restarts).

        Only exceptions in `recoverable` trigger checkpoint-restart
        (default: :data:`RECOVERABLE` — runtime/hardware and I/O errors);
        everything else propagates immediately.  A failure with *no*
        durable checkpoint is a **cold restart**: `cold_restart="raise"`
        (default) re-raises the original exception — replaying from step 0
        silently is almost never what a production job wants — while
        `"restart"` opts in to the replay, counted in `cold_restarts`
        (training state must be rebuilt by the caller's step-0 semantics:
        the initial `state` object is reused as passed).
        """
        if cold_restart not in ("raise", "restart"):
            raise ValueError(f"cold_restart={cold_restart!r}: "
                             f"expected 'raise' or 'restart'")
        init_state = state
        start = self.ckpt_manager.latest_step()
        if start is not None:
            state, start = self.ckpt_manager.restore(state)
        step = 0 if start is None else start
        while step < n_steps:
            try:
                if inject_failure is not None:
                    inject_failure(step)
                t0 = time.monotonic()
                batch = data_source.batch_at(step)
                state = step_fn(state, batch)
                self.monitor.beat(self.host_index, step,
                                  time.monotonic() - t0)
                step += 1
                if self.should_checkpoint(step):
                    self.ckpt_manager.save_async(step, state)
            except recoverable:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt_manager.wait()
                restored, rstep = self.ckpt_manager.restore(state)
                if restored is not None:
                    state, step = restored, rstep
                elif cold_restart == "restart":
                    self.cold_restarts += 1
                    state, step = init_state, 0
                else:
                    raise
        self.ckpt_manager.wait()
        return state, step, self.restarts
