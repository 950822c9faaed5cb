"""Typed serving errors + the request-outcome taxonomy.

Port of the reference's ``serving/errors.py`` (framework-free, a copy).
Every request the engine touches terminates with exactly one
:class:`Outcome`; the engine counts them in ``stats["outcome_*"]`` and
``chip_smoke.py``'s resilience runs check the counters.  The exception
hierarchy lets callers distinguish "you sent a bad request" from "the
system is shedding load" from "a kernel fault ate your stream" without
string matching.

:class:`AdmissionError` deliberately subclasses ``ValueError``: callers
catching ``ValueError`` around ``submit`` keep working.
"""
from __future__ import annotations

import enum


class Outcome(str, enum.Enum):
    """Terminal state of a request.  ``str`` values are the stats keys
    (``stats[f"outcome_{o.value}"]``) and the bench/report vocabulary."""

    OK = "ok"                              # full stream delivered
    REJECTED_OVERLOAD = "rejected_overload"  # bounded queue shed it at submit
    DEADLINE_EXPIRED = "deadline_expired"  # TTFT/total deadline passed
    PREEMPTED_RETRIED = "preempted_retried"  # finished, but was preempted
    FAILED = "failed"                      # invalid, kernel fault, watchdog


OUTCOMES = tuple(o.value for o in Outcome)


class ServingError(Exception):
    """Base of every typed serving failure."""


class AdmissionError(ServingError, ValueError):
    """``submit`` refused the request (invalid prompt or queue overload).
    The request is finished with its outcome before this raises."""

    def __init__(self, msg: str, outcome: Outcome = Outcome.FAILED):
        super().__init__(msg)
        self.outcome = outcome


class DeadlineExceeded(ServingError):
    """A per-request TTFT or total deadline passed before completion."""


class KernelFault(ServingError):
    """A substrate GEMM launch failed: raised by the ``substrate.dispatch``
    chaos point before the launch (a CUDA build or launch error is never
    mapped to it, and propagates).  The engine retries the dispatch once;
    a persistent fault fails the requests bound to it with
    :attr:`Outcome.FAILED`."""


class TransferFault(KernelFault):
    """A pod->pod K/V handoff failed in the disaggregated engine
    (injected via the ``transfer.kv`` chaos point or real).  The engine
    retries the transfer up to its retry budget; a persistent fault fails
    the sequence with :attr:`Outcome.FAILED`."""


class PagePoolExhausted(ServingError):
    """No page could be obtained even after radix eviction and (under
    ``preempt_policy='youngest'``) preempting every other sequence."""


class EngineCrash(ServingError):
    """The engine was killed mid-stream (chaos ``crash`` point).  Recover
    with ``ServingEngine.restore(...)`` from ``engine.latest_snapshot()``;
    continuations are bit-identical to an uncrashed run."""
