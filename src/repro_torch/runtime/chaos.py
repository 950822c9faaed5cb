"""Deterministic, seeded fault injection for the serving stack.

Chaos engineering only pays off if a failure found once can be replayed
forever, so every injection decision here is a pure function of
``(seed, injection point, per-point draw index)`` — independent of wall
clock, interleaving, and of how many *other* points drew before it.  A
failing seed from CI reproduces bit-identically on a laptop.

Injection points (registered by the code under test, fired through the
ambient :func:`fire`):

=====================  ====================================================
``substrate.dispatch``  a GEMM launch fault (``KernelFault``) at the
                        substrate dispatch entry (``kernels/substrate.py``)
                        — fires at jit-trace time, i.e. at the
                        launch/trace boundary of a compiled step
``engine.sample``       corrupt a decode tick's logits to NaN/Inf before
                        sampling (``serving/engine.py``)
``pool.alloc``          report page-pool exhaustion even when pages are
                        free (``serving/paged.py``)
``engine.tick``         kill the engine mid-stream (``EngineCrash``) at a
                        tick boundary (``serving/engine.py``)
``transfer.kv``         drop a pod->pod K/V handoff in the disaggregated
                        engine (``TransferFault``; ``serving/disagg.py``)
``disagg.pod``          kill a decode pod mid-stream — resident sequences
                        preempt and re-admit through prefill recompute
                        (``serving/disagg.py``)
=====================  ====================================================

Probabilities are drawn per *draw index* ``n`` via
``random.Random(f"{seed}:{point}:{n}")``; the deterministic ``*_at``
triggers fire exactly at draw ``n == at`` (CI pins faults with these).
The draw counters and the fired-event log (``chaos_draws`` /
``chaos_log``) are chaos-owned mutable state: the AFL03 lint confines
their mutation to this module, and they ride along in engine snapshots so
a restored engine continues the *same* replayable draw sequence.

This module imports nothing from ``repro_torch`` (stdlib only): the substrate
and the paged allocator reach it lazily without import cycles.
"""
from __future__ import annotations

import contextlib
import contextvars
import random
from dataclasses import dataclass, fields, replace
from typing import Dict, List, Optional, Tuple

# injection point -> (probability field, deterministic-trigger field)
POINT_FIELDS = {
    "substrate.dispatch": ("gemm_fault", "gemm_fault_at"),
    "engine.sample": ("nan_logits", "nan_logits_at"),
    "pool.alloc": ("page_exhaust", "page_exhaust_at"),
    "engine.tick": ("crash", "crash_at"),
    "transfer.kv": ("kv_transfer", "kv_transfer_at"),
    "disagg.pod": ("pod_lost", "pod_lost_at"),
}

# parse_spec key -> config field (short names for the --chaos flag)
_SPEC_KEYS = {
    "seed": "seed",
    "gemm": "gemm_fault", "gemm_at": "gemm_fault_at",
    "nan": "nan_logits", "nan_at": "nan_logits_at",
    "pages": "page_exhaust", "pages_at": "page_exhaust_at",
    "crash": "crash", "crash_at": "crash_at",
    "kv": "kv_transfer", "kv_at": "kv_transfer_at",
    "pod": "pod_lost", "pod_at": "pod_lost_at",
}


@dataclass(frozen=True)
class ChaosConfig:
    """Per-point fault probabilities (``0.0`` = off) and deterministic
    draw-index triggers (``-1`` = off; ``n`` fires exactly at draw n)."""

    seed: int = 0
    gemm_fault: float = 0.0
    nan_logits: float = 0.0
    page_exhaust: float = 0.0
    crash: float = 0.0
    kv_transfer: float = 0.0
    pod_lost: float = 0.0
    gemm_fault_at: int = -1
    nan_logits_at: int = -1
    page_exhaust_at: int = -1
    crash_at: int = -1
    kv_transfer_at: int = -1
    pod_lost_at: int = -1

    def without_crash(self) -> "ChaosConfig":
        """The same faults minus the mid-stream kill — what a restored
        engine inherits by default, so crash replay cannot livelock on
        re-raising the crash it just recovered from."""
        return replace(self, crash=0.0, crash_at=-1)


def parse_spec(spec: str) -> ChaosConfig:
    """``"seed=3,gemm=0.05,nan_at=2,crash=0.01"`` -> :class:`ChaosConfig`.
    Keys: seed, gemm, nan, pages, crash (+ ``_at`` variants)."""
    kw = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"chaos spec entry {part!r}: expected key=value")
        key, _, val = part.partition("=")
        field = _SPEC_KEYS.get(key.strip())
        if field is None:
            raise ValueError(f"unknown chaos spec key {key!r} "
                             f"(known: {', '.join(sorted(_SPEC_KEYS))})")
        typ = {f.name: f.type for f in fields(ChaosConfig)}[field]
        kw[field] = int(val) if typ == "int" else float(val)
    return ChaosConfig(**kw)


class ChaosEngine:
    """Draw state for one engine: per-point draw counters + fired log.

    ``fire(point)`` advances the point's counter and decides from
    ``Random(f"{seed}:{point}:{n}")`` (or the ``*_at`` trigger) — the
    decision for draw ``n`` never depends on other points' history, which
    is what makes a single seed replay under changed interleavings.
    """

    def __init__(self, config: ChaosConfig):
        self.config = config
        self.chaos_draws: Dict[str, int] = {p: 0 for p in POINT_FIELDS}
        self.chaos_log: List[Tuple[str, int, str]] = []   # (point, n, detail)

    def fire(self, point: str, detail: str = "") -> bool:
        prob_field, at_field = POINT_FIELDS[point]
        n = self.chaos_draws[point]
        self.chaos_draws[point] = n + 1
        prob = getattr(self.config, prob_field)
        at = getattr(self.config, at_field)
        hit = (n == at) or (
            prob > 0.0
            and random.Random(f"{self.config.seed}:{point}:{n}").random()
            < prob)
        if hit:
            self.chaos_log.append((point, n, detail))
        return hit

    # ----------------------------------------------------- snapshot state
    def state_snapshot(self) -> dict:
        """Draw counters + log, pure-python (rides in engine snapshots)."""
        return {"config": {f.name: getattr(self.config, f.name)
                           for f in fields(ChaosConfig)},
                "draws": dict(self.chaos_draws),
                "log": [list(e) for e in self.chaos_log]}

    def load_state(self, snap: dict) -> None:
        self.chaos_draws.update(snap["draws"])
        self.chaos_log[:] = [tuple(e) for e in snap["log"]]

    @staticmethod
    def config_from_snapshot(snap: dict) -> ChaosConfig:
        return ChaosConfig(**snap["config"])


# --------------------------------------------------------------------------
# ambient activation: the engine scopes its ChaosEngine around each tick so
# substrate dispatch / page allocation fire without threading a handle
# through every call signature.

_ACTIVE: contextvars.ContextVar[Optional[ChaosEngine]] = \
    contextvars.ContextVar("repro_chaos_active", default=None)


def active() -> Optional[ChaosEngine]:
    return _ACTIVE.get()


def fire(point: str, detail: str = "") -> bool:
    """Fire ``point`` on the ambient engine; False when chaos is off."""
    eng = _ACTIVE.get()
    return eng.fire(point, detail) if eng is not None else False


@contextlib.contextmanager
def scope(engine: Optional[ChaosEngine]):
    """Activate ``engine`` for the duration (None = explicit no-chaos)."""
    token = _ACTIVE.set(engine)
    try:
        yield engine
    finally:
        _ACTIVE.reset(token)
