"""Batched serving engine: chunked batched prefill + continuous batching.

Port of the reference's ``serving/engine.py`` (dense or paged K/V cache,
greedy or temperature sampling, the hardened lifecycle).  A fixed pool of
``max_batch`` sequence :class:`Slot`\\ s, each with an explicit lifecycle::

    FREE --admit--> PREFILL --(chunks exhausted)--> DECODE --EOS/limit--> FREE

*Admission* pops queued requests into free slots.  *Prefill* runs the
prompt (all but its final token) through ``lm.prefill_step`` in fixed-size
chunks — one dispatch per chunk covering **every** prefilling slot at once,
writing K/V only for the target rows.  *Decode* is the fused per-slot-
position step: one dispatch advances every DECODE slot by one token.  Each
tick interleaves at most one prefill-chunk dispatch with one decode
dispatch.  The chunk size defaults to ``core.planner.attention_plan``.

``prefill_mode``: ``"batched"`` (chunked ``lm.prefill_step``), ``"token"``
(token-by-token decode-path prefill, the baseline for equivalence tests)
or ``"auto"`` (batched when the model supports it).

The engine serves a prepared copy of the parameters
(``lm.prepare_params``: weights cast once to the compute dtype) on its
device — the card unless ``device="cpu"``.  A quantizing backend
(``arrayflex_int8``/``arrayflex_w8a8``) serves int8 weights quantized once
here (``lm.prequantize_params``), never inside a step.  Logits come back
fp32.  Sampling at temperature > 0 draws from a ``torch.Generator``
seeded with ``ServeConfig.seed`` (its draws differ from the reference's
``jax.random`` ones).

**Paged mode** (``ServeConfig.kv_pages > 0``): the dense per-slot K/V
region is replaced by a global page pool + per-sequence block tables
(``serving/paged.py``) and admission reserves *pages*, not slots —
concurrency is bounded by the page budget (``kv_pages``) instead of
``max_batch``, which only caps how many sequences share one dispatch (the
engine round-robins resident sequences over the ``max_batch`` rows).  The
page size comes from ``planner.page_plan`` unless given, and must divide
``max_seq`` so the gathered logical view has the dense cache length:
paged greedy streams are bit-identical to the dense path's (but W8A8's,
whose per-tile activation scales follow the batch's composition).
``prefix_cache=True`` adds the radix prefix cache: requests sharing a
prompt prefix map their leading block-table entries to the same physical
pages and skip the shared pages' prefill.

**Resilience**: every request terminates with a typed
:class:`~repro_torch.serving.errors.Outcome`, counted in
``stats["outcome_*"]``.  The hardened lifecycle adds

* a bounded queue (``max_queue``) with typed overload rejection at
  ``submit`` (:class:`~repro_torch.serving.errors.AdmissionError`),
* per-request TTFT/total deadlines (``ttft_deadline_ms``/``deadline_ms``)
  expired at tick boundaries,
* non-finite-logit detection after each decode dispatch with one bounded
  retry (``max_retries``) — a persistent NaN/Inf fails the affected
  requests instead of streaming garbage tokens,
* :class:`~repro_torch.serving.errors.KernelFault` retry around each
  dispatch (the substrate's ``substrate.dispatch`` chaos point; only an
  injected fault raises it — a CUDA build or launch error propagates),
* a per-tick heartbeat into
  :class:`~repro_torch.runtime.fault.HeartbeatMonitor` plus a stuck-tick
  watchdog (``watchdog_ticks``) that fails the head-of-line request
  instead of spinning forever,
* graceful degradation under ``preempt_policy="youngest"``: pages are
  reserved lazily and on mid-decode pool exhaustion the youngest resident
  sequence is preempted (pages released, request re-queued at the front,
  K/V recomputed on re-admission — through the radix prefix cache when
  warm) rather than deadlocking; preempted streams are bit-identical to
  un-preempted runs by the prefill == decode equivalence contract,
* crash recovery: ``snapshot()``/``ServingEngine.restore`` round-trip the
  scheduling state (queue, slot/sequence metadata, block tables, pool
  refcounts, radix tree, generator state, chaos draw counters) and the
  K/V cache (CPU copies) so an
  :class:`~repro_torch.serving.errors.EngineCrash` mid-stream resumes with
  bit-identical continuations.

A retried dispatch re-runs the step on the cache the faulted attempt
wrote in place: every K/V write depends only on the step's inputs and
lands on the positions the clean attempt writes, so the retry rewrites the
same bytes (``tests/test_torch_resilience.py`` holds logits and the whole
cache to a clean step's bit for bit).  A mamba sub-layer's recurrent
``state``/``conv`` leaves would not survive that (``state <- state *
exp(dt A) + upd`` run twice advances twice), so ``lm.decode_step``
advances them out of place and the engine commits the cache a step
returns only when the step is accepted: a faulted attempt, or one whose
logits a NaN retry rejects, leaves ``self.cache``'s recurrent leaves as
they were, as the reference's functional step leaves its cache
(``tests/test_torch_ssm_serving.py``).

SSM and hybrid models serve in token mode, as the reference does, with
its behaviour: a token-prefill step is a full-batch decode step, so every
other resident row advances its recurrent state on token 0 at its own
position, and a slot's state is not reset when a new request takes it.
The K/V rows that step writes are overwritten before they are attended;
a mamba state is not, so a request's stream can depend on what shares
the batch with it (ROADMAP Queue 3).

A sliding-window model (mixtral-8x22b) also serves in token mode, from a
dense K/V ring of ``min(window, max_seq)`` rows: each step writes its row
at ``pos % ring`` in place, so a retried step rewrites the same slot with
the same bytes.  The VLM and audio families serve in token mode too,
their cross-attending layers reading the ``xk`` / ``xv`` leaves
``lm.init_cache`` made: zeros, as in the reference, whose engine takes
no image embeddings or audio frames with a request; no step writes them.
``kv_cache_bytes`` counts the ring and the cross leaves.

Fault injection is driven by :mod:`repro_torch.runtime.chaos` (seeded,
replayable); ``ServeConfig.chaos`` activates it and the engine scopes the
chaos engine around each tick.  The reference draws ``substrate.dispatch``
while ``jax.jit`` traces a step: a step whose first trace succeeded is
cached and never draws again, and a step whose first trace raised is
traced anew at every later call (jax 0.9's jit caches no trace for it).
So the engine draws in each of its four steps (``decode``, ``prefill``,
``decode_paged``, ``prefill_paged``; the disaggregated engine adds a
fifth, ``decode_p``, its prefill role's token-mode step, which the
reference jits apart) once per site label and sub-layer
position of the period an attempt (``substrate.chaos_trace_scope``: the
reference's scan body holds the whole period, eight sub-layers for the
hybrid) until the step completes a dispatch at
its first attempt, and from then on runs it with the point inactive; a
step whose first attempt faulted draws at every dispatch.  A restored
engine starts with no step traced, as the reference's fresh jit does.

Disaggregated serving (``serving/disagg.py``) subclasses this engine: its
prefill role works on a cache of its own, so :meth:`_guarded_dispatch`
takes the name of the cache attribute a step works on and commits to
(``target``), and its decode steps run under ``self.dcfg`` (the engine's
config here, the decode role's there).

Strict routing audit (``substrate.strict_audit_scope`` or
``REPRO_STRICT_AUDIT=1``; ``serve.py --strict-audit``): a dispatch under an
unknown or empty site label raises ``RuntimeError("[AF007] ...")`` before
it launches, and :meth:`run_to_completion` checks every recorded label
against ``planner.model_gemms`` when the run ends.  The error propagates:
:meth:`_guarded_dispatch` retries only a ``KernelFault``, so a routing
violation is never retried and never becomes a typed outcome.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner
from repro_torch.kernels import substrate
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import lm
from repro_torch.parallel import sharding
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.serving.errors import (AdmissionError, DeadlineExceeded,
                                        EngineCrash, KernelFault, Outcome,
                                        PagePoolExhausted)
from repro_torch.serving.paged import PagePool, PagedSeq, RadixCache

PREFILL_CHUNK_CHOICES = (16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclass
class Request:
    prompt: list
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0
    out_tokens: list = field(default_factory=list)
    done: bool = False
    ttft_s: Optional[float] = None     # admission -> first generated token
    # --- resilience -----------------------------------------------------
    outcome: Optional[str] = None      # Outcome.value once done
    error: str = ""                    # human-readable failure detail
    preemptions: int = 0               # times preempted + re-queued
    t_submit: float = 0.0              # engine clock at submit
    resume_prompt: Optional[list] = None  # prompt + generated, for re-admit


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    max_seq: int = 256
    eos_id: int = -1           # -1: never stops early
    seed: int = 0
    prefill_mode: str = "auto"  # auto | batched | token
    prefill_chunk: int = 0      # 0 -> planner-chosen (attention_plan)
    # --- paged K/V (0 = dense slot mode) ---------------------------------
    kv_pages: int = 0           # physical pages in the pool (incl. scratch)
    page_size: int = 0          # tokens per page; 0 -> planner.page_plan
    prefix_cache: bool = False  # radix shared-prefix page reuse
    # --- resilience ------------------------------------------------------
    max_queue: int = 0          # bounded queue; 0 = unbounded (no shedding)
    deadline_ms: float = 0.0    # total per-request deadline; 0 = off
    ttft_deadline_ms: float = 0.0  # submit -> first token deadline; 0 = off
    max_retries: int = 1        # bounded retry of a faulted/NaN dispatch
    watchdog_ticks: int = 64    # consecutive no-progress ticks before the
    #                             stuck-tick watchdog fires; 0 = off
    snapshot_every_ticks: int = 0  # crash-recovery snapshot cadence; 0 = off
    preempt_policy: str = "none"   # none | youngest (paged lazy reservation)
    chaos: Optional[chaos_mod.ChaosConfig] = None  # fault injection


class Slot:
    """One sequence slot: FREE -> PREFILL -> DECODE -> FREE."""

    FREE, PREFILL, DECODE = "free", "prefill", "decode"

    def __init__(self, index: int):
        self.index = index
        self.state = Slot.FREE
        self.req: Optional[Request] = None
        self.pos = 0              # decode: position of the token in flight
        self.prefill_len = 0      # tokens to prefill (len(prompt) - 1)
        self.prefill_done = 0
        self.next_token = 0
        self.t_admit = 0.0

    @property
    def tokens(self) -> list:
        """The token sequence this residency must make resident: a
        preempted request re-admits with prompt + already-generated tokens
        (recompute-on-re-admission), as the paged path's
        ``_effective_prompt``."""
        return self.req.resume_prompt or self.req.prompt

    def assign(self, req: Request, now: float):
        self.req = req
        self.t_admit = now
        self.prefill_len = len(self.tokens) - 1
        self.prefill_done = 0
        if self.prefill_len == 0:
            self._to_decode()
        else:
            self.state = Slot.PREFILL
            self.pos = 0

    def _to_decode(self):
        self.state = Slot.DECODE
        self.pos = self.prefill_len
        self.next_token = self.tokens[-1]

    def finish_chunk(self, n_tokens: int):
        self.prefill_done += n_tokens
        if self.prefill_done >= self.prefill_len:
            self._to_decode()

    def release(self):
        self.req = None
        self.state = Slot.FREE

    @property
    def write_pos(self) -> int:
        """Next cache position this row writes (where a fused-decode
        dispatch may harmlessly deposit garbage: the row's next real write
        lands on the same position before it is ever attended)."""
        return self.prefill_done if self.state == Slot.PREFILL else self.pos


def _req_state(req: Request) -> dict:
    """Pure-python deep copy of a request for crash-recovery snapshots."""
    return dataclasses.asdict(req)


def _req_from_state(d: dict) -> Request:
    return Request(**copy.deepcopy(d))


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 *, device=None, clock=time.perf_counter):
        substrate.check_backend(cfg.gemm_backend)
        lm.check_supported(cfg)
        if serve_cfg.preempt_policy not in ("none", "youngest"):
            raise ValueError(
                f"unknown preempt_policy {serve_cfg.preempt_policy!r} "
                f"(known: none, youngest)")
        self.cfg = cfg
        # the config the decode steps run under (a disaggregated engine's
        # decode role)
        self.dcfg = cfg
        # the step the decode ticks run (a pipelined role's decode_step_pp)
        self._decode_fn = lm.decode_step
        self.device = resolve_device(device)
        # Sharded serving: cfg.mesh_shape activates the sharded GEMM
        # dispatch inside the lm steps (they scope the mesh themselves).
        # Resolve it now, so a config that needs more devices than exist
        # fails here with the --host-devices hint, not mid-serve.
        self.mesh = self._resolve_mesh(cfg)
        self.params = lm.prequantize_params(
            cfg, _to_device(lm.prepare_params(cfg, params), self.device))
        self.sc = serve_cfg
        self.clock = clock
        B, S = serve_cfg.max_batch, serve_cfg.max_seq
        self.queue: List[Request] = []
        self.gen = torch.Generator(device=self.device).manual_seed(
            serve_cfg.seed)

        mode = serve_cfg.prefill_mode
        if mode == "auto":
            mode = ("batched" if lm.supports_batched_prefill(cfg)
                    else "token")
        if mode == "batched" and not lm.supports_batched_prefill(cfg):
            raise ValueError(
                f"{cfg.name}: model family does not support batched "
                f"prefill; use prefill_mode='token' or 'auto'")
        if mode not in ("batched", "token"):
            raise ValueError(f"unknown prefill_mode {mode!r}")
        self.prefill_mode = mode
        # Eq.(6) at the serving layer: steps = ceil(prompt/chunk), per-step
        # cost affine in chunk * cache_len -> attention_plan picks the chunk.
        self.prefill_chunk = serve_cfg.prefill_chunk or min(S, max(
            1, planner.attention_plan(S, S, choices=PREFILL_CHUNK_CHOICES)))
        self.paged = serve_cfg.kv_pages > 0
        self.slots: List[Slot] = []
        self.active: List[PagedSeq] = []
        self._rr = 0                      # paged decode round-robin cursor
        if self.paged:
            if not lm.supports_paged_kv(cfg):
                raise ValueError(
                    f"{cfg.name}: model family does not support the paged "
                    f"KV path (see lm.supports_paged_kv); use kv_pages=0")
            if mode != "batched":
                raise ValueError("paged serving requires the batched "
                                 "prefill path (prefill_mode='batched' or "
                                 "'auto' on a supporting family)")
            # Eq.(6) again, applied to page geometry: block-table walk
            # overhead vs trailing-page waste (planner.page_plan)
            page = serve_cfg.page_size or planner.page_plan(S)
            if page <= 0 or S % page:
                raise ValueError(
                    f"page_size={page} must divide max_seq={S}: the "
                    f"gathered view must have the dense cache length "
                    f"(the paged/dense bit-exactness contract)")
            self.page_size = page
            self.pages_per_seq = S // page
            if (serve_cfg.preempt_policy == "none"
                    and serve_cfg.kv_pages < self.pages_per_seq + 1):
                # worst-case reservation needs a full sequence's pages up
                # front; lazy reservation (preempt_policy="youngest") can
                # run a tighter pool and degrade by preempting instead
                raise ValueError(
                    f"kv_pages={serve_cfg.kv_pages}: need at least "
                    f"{self.pages_per_seq + 1} (max_seq/page_size pages "
                    f"for one worst-case sequence + the scratch page), "
                    f"or set preempt_policy='youngest' for lazy "
                    f"reservation over a smaller pool")
            self.pool = PagePool(serve_cfg.kv_pages, page)
            self.radix = (RadixCache(page) if serve_cfg.prefix_cache
                          else None)
            self.cache = lm.init_paged_cache(cfg, serve_cfg.kv_pages, page,
                                             device=self.device)
        else:
            self.cache = lm.init_cache(cfg, B, S, device=self.device)
            self.slots = [Slot(i) for i in range(B)]

        # --- resilience state --------------------------------------------
        self._chaos = (chaos_mod.ChaosEngine(serve_cfg.chaos)
                       if serve_cfg.chaos is not None else None)
        # the reference's jit trace cache, per step: "cached" (the first
        # attempt completed: the substrate.dispatch point is inactive from
        # then on) or "retrace" (the first attempt faulted: every dispatch
        # draws); absent until the step's first attempt
        self._trace: dict = {}
        # single-host serving: the engine heartbeats host 0 once per tick;
        # an external supervisor (or test) reads dead_hosts()/stragglers()
        self.monitor = HeartbeatMonitor(1, dead_after_s=60.0)
        self._tick = 0
        self._no_progress = 0
        self._admit_seq = 0        # monotonic admission number (preemption)
        self._admitted = 0
        self._terminated = 0
        self._snapshots: List[dict] = []   # latest crash-recovery snapshot
        self.restored_requests: List[Request] = []  # set by restore()

        self.stats = dict(prefill_dispatches=0, decode_dispatches=0,
                          prefill_tokens=0, decode_tokens=0,
                          prefill_time_s=0.0, decode_time_s=0.0,
                          prefill_gemm_dispatches=0,
                          pages_used_peak=0, concurrency_peak=0,
                          prefix_hit_tokens=0,
                          sample_retries=0, kernel_fault_retries=0,
                          preemptions=0, watchdog_fired=0,
                          snapshots_taken=0,
                          **{f"outcome_{o.value}": 0 for o in Outcome})

    def _resolve_mesh(self, cfg):
        """``cfg``'s mesh (strict), which must lie on the engine's device
        type: the caches and the served tree live on the engine's
        device."""
        mesh = sharding.mesh_from_config(cfg)
        if mesh is not None:
            kinds = {d.type for d in mesh.devices.flat}
            if kinds != {self.device.type}:
                raise ValueError(
                    f"mesh {mesh} lies on {sorted(kinds)} but the engine "
                    f"runs on {self.device}: fan the host out on the "
                    f"engine's device type (launch.mesh.host_devices(N, "
                    f"{self.device.type!r}))")
        return mesh

    def kv_cache_bytes(self) -> int:
        """Resident cache bytes: the K/V (pool pages in paged mode, the
        dense (max_batch, max_seq) region, or a sliding window's ring,
        otherwise), the cross-attending layers' ``xk`` / ``xv`` and, for
        mamba sub-layers, the recurrent ``state`` and ``conv`` leaves."""
        return sum(t.numel() * t.element_size()
                   for layer in self.cache for t in layer.values())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray):
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------- intake
    def _finish(self, req: Request, outcome: Outcome, error: str = ""):
        """Terminate ``req`` with its typed outcome (idempotent)."""
        if req.done and req.outcome is not None:
            return
        req.done = True
        req.outcome = outcome.value
        req.error = error
        self._terminated += 1
        self.stats[f"outcome_{outcome.value}"] += 1

    def submit(self, req: Request):
        if not req.prompt:
            msg = f"request {req.rid}: empty prompt"
            self._finish(req, Outcome.FAILED, msg)
            raise AdmissionError(msg)
        if len(req.prompt) > self.sc.max_seq:
            msg = (f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                   f"exceeds max_seq={self.sc.max_seq}")
            self._finish(req, Outcome.FAILED, msg)
            raise AdmissionError(msg)
        if self.sc.max_queue and len(self.queue) >= self.sc.max_queue:
            # bounded queue: shed load with a typed rejection instead of
            # growing without bound (backpressure the caller can act on)
            msg = (f"request {req.rid}: queue full "
                   f"({len(self.queue)}/{self.sc.max_queue}) — overload, "
                   f"retry later")
            self._finish(req, Outcome.REJECTED_OVERLOAD, msg)
            raise AdmissionError(msg, Outcome.REJECTED_OVERLOAD)
        req.t_submit = self.clock()
        self.queue.append(req)

    def _admit(self):
        if self.paged:
            self._admit_paged()
            return
        now = self.clock()
        for slot in self.slots:
            if slot.state == Slot.FREE and self.queue:
                slot.assign(self.queue.pop(0), now)
                self._admitted += 1

    def _effective_prompt(self, req: Request) -> list:
        """The token sequence this admission must make resident: a
        preempted request re-admits with prompt + already-generated tokens
        (recompute-on-re-admission; prefix-cache hits make it cheap)."""
        return req.resume_prompt if req.resume_prompt else req.prompt

    def _admit_paged(self):
        """Memory-bounded admission: FIFO-pop the queue while the pool can
        reserve each request's page span — worst-case (prompt + max_new,
        clipped to max_seq) under ``preempt_policy="none"``, lazy (prompt
        only, grown page by page in decode) under ``"youngest"`` — minus
        whatever the radix prefix cache already holds.  Concurrency is
        whatever the page budget sustains, not ``max_batch``."""
        now = self.clock()
        while self.queue:
            req = self.queue[0]
            eff = self._effective_prompt(req)
            if self.sc.preempt_policy == "youngest":
                # lazy: cover the prompt (prefill writes 0..len-2, first
                # decode write at len-1); decode growth allocates the rest
                need = -(-len(eff) // self.page_size)
            else:
                target = min(len(eff) + req.max_new_tokens
                             - len(req.out_tokens), self.sc.max_seq)
                need = -(-target // self.page_size)
            shared: List[int] = []
            if self.radix is not None and len(eff) > 1:
                # only K/V of prompt[:-1] may be borrowed: the final
                # prompt token must run through this request's own decode
                # to produce its first logits
                shared = self.radix.match(eff[:-1])[:need]
                for pg in shared:
                    self.pool.incref(pg)   # pin before any eviction below
            fresh = need - len(shared)
            if fresh > self.pool.n_free and self.radix is not None:
                self.radix.evict(fresh - self.pool.n_free, self.pool)
            pages = self.pool.alloc(fresh)
            if pages is None:
                for pg in shared:          # head-of-line: retry next tick
                    self.pool.decref(pg)
                break
            self.queue.pop(0)
            seq = PagedSeq(req, self.pages_per_seq, prompt=eff)
            m = len(shared)
            seq.block_table[:m] = shared
            seq.block_table[m:m + len(pages)] = pages
            seq.n_shared = m
            seq.t_admit = now
            seq.admit_idx = self._admit_seq
            self._admit_seq += 1
            self._admitted += 1
            seq.prefill_done = m * self.page_size
            self.stats["prefix_hit_tokens"] += m * self.page_size
            if seq.prefill_done >= seq.prefill_len:
                seq.to_decode()
            self.active.append(seq)
            self.stats["concurrency_peak"] = max(
                self.stats["concurrency_peak"], len(self.active))
            self.stats["pages_used_peak"] = max(
                self.stats["pages_used_peak"], self.pool.n_used)

    def _publish_prefix(self, seq: PagedSeq):
        """Hand the sequence's full prompt pages to the radix tree once
        its prefill completes (K/V of prompt[:-1] is then resident)."""
        if self.radix is None or seq.published:
            return
        seq.published = True
        m = (len(seq.prompt) - 1) // self.page_size
        if m:
            self.radix.insert(seq.prompt[:m * self.page_size],
                              seq.block_table[:m], self.pool)

    def _release_paged(self, seq: PagedSeq):
        for pg in seq.block_table:
            if pg != PagePool.SCRATCH:
                self.pool.decref(pg)
        self.active.remove(seq)

    def _pos_vector(self) -> np.ndarray:
        return np.asarray([s.write_pos for s in self.slots], np.int64)

    # -------------------------------------------------- guarded dispatch
    def _guarded_dispatch(self, step: str, dispatch, rows,
                          target: str = "cache"):
        """Run one step (``dispatch()`` -> logits, or None for a prefill)
        under the fault guards: retry (at most ``max_retries`` times) on a
        :class:`KernelFault`, and on non-finite logits in the active
        ``rows`` (the ``engine.sample`` corruption point — also catches a
        *real* kernel producing NaN/Inf).  Returns ``(logits, bad_rows)``;
        ``bad_rows`` non-empty means the retry budget is spent and the
        caller must fail those rows' requests instead of sampling
        garbage.  A persistent KernelFault re-raises.

        ``dispatch()`` returns ``(logits or None, cache)``; the cache
        becomes the engine's attribute ``target`` (``self.cache``, or a
        disaggregated prefill role's ``self.pcache``) only when the
        attempt is accepted (it completed, and its logits are finite or
        the retries are spent).  Unless ``step`` is cached, each attempt
        draws the ``substrate.dispatch`` point once per site label and
        sub-layer position (module docstring).  A retry re-runs the step
        on the cache ``dispatch`` reads, which must be ``target``'s: its
        K/V tensors as the faulted attempt wrote them in place, which it
        rewrites with the same bytes, and its recurrent leaves as they
        were before the attempt; the generator is untouched (sampling
        happens after validation)."""
        retries = max(0, self.sc.max_retries)
        for attempt in range(retries + 1):
            cached = self._trace.get(step) == "cached"
            try:
                with (chaos_mod.scope(None) if cached
                      else substrate.chaos_trace_scope()):
                    logits, cache = dispatch()
            except KernelFault:
                self._trace[step] = "retrace"
                if attempt < retries:
                    self.stats["kernel_fault_retries"] += 1
                    continue
                raise
            self._trace.setdefault(step, "cached")
            if logits is None:           # prefill: nothing to sample
                setattr(self, target, cache)
                return None, ()
            if self._chaos is not None and self._chaos.fire("engine.sample"):
                # corrupt to NaN on even draws, +Inf on odd (both must be
                # caught by the same finiteness check)
                n = self._chaos.chaos_draws["engine.sample"] - 1
                logits = torch.full_like(
                    logits, float("nan") if n % 2 == 0 else float("inf"))
            finite = torch.isfinite(logits).all(dim=-1).cpu().numpy()
            bad = tuple(r for r in rows if not finite[r])
            if bad and attempt < retries:
                self.stats["sample_retries"] += 1
                continue
            setattr(self, target, cache)
            if not finite.all():
                # no row is sampled from non-finite logits (the bad rows'
                # tokens are dropped; multinomial refuses NaN rows)
                logits = torch.where(
                    torch.as_tensor(finite, device=logits.device)[:, None],
                    logits, torch.zeros((), dtype=logits.dtype,
                                        device=logits.device))
            return logits, bad
        raise AssertionError("unreachable")

    # ------------------------------------------------------------ prefill
    def _prefill_tick(self):
        if self.paged:
            self._prefill_tick_paged()
            return
        pre = [s for s in self.slots if s.state == Slot.PREFILL]
        if not pre:
            return
        if self.prefill_mode == "token":
            for slot in pre:
                self._prefill_token_by_token(slot)
            return
        B, C = self.sc.max_batch, self.prefill_chunk
        toks = np.zeros((B, C), np.int64)
        pos = self._pos_vector()
        lens = np.zeros(B, np.int64)
        for s in pre:
            c = min(C, s.prefill_len - s.prefill_done)
            toks[s.index, :c] = s.tokens[s.prefill_done:s.prefill_done + c]
            lens[s.index] = c
        try:
            self._run_prefill("prefill", lambda: lm.prefill_step(
                self.cfg, self.params, self.cache, self._tensor(toks),
                self._tensor(pos), self._tensor(lens)), lens)
        except KernelFault as exc:
            for s in pre:
                self._finish(s.req, Outcome.FAILED,
                             f"KernelFault during prefill: {exc}")
                s.release()
            return
        for s in pre:
            s.finish_chunk(int(lens[s.index]))

    def _run_prefill(self, step: str, run, lens: np.ndarray,
                     target: str = "cache"):
        """Run one guarded prefill-chunk dispatch on the cache ``target``
        names and book its time, tokens and GEMM dispatches (a retried
        attempt's included)."""
        t0 = self.clock()
        d0 = sum(substrate.DISPATCH_COUNTS.values())
        try:
            self._guarded_dispatch(step, lambda: (None, run()[1]), rows=(),
                                   target=target)
        finally:
            self.stats["prefill_gemm_dispatches"] += (
                sum(substrate.DISPATCH_COUNTS.values()) - d0)
        self._sync()
        self.stats["prefill_time_s"] += self.clock() - t0
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += int(lens.sum())

    def _prefill_tick_paged(self):
        pre = [s for s in self.active if s.state == PagedSeq.PREFILL]
        if not pre:
            return
        sel = pre[:self.sc.max_batch]
        B, C = self.sc.max_batch, self.prefill_chunk
        toks = np.zeros((B, C), np.int64)
        pos = np.zeros(B, np.int64)
        lens = np.zeros(B, np.int64)
        bt = np.zeros((B, self.pages_per_seq), np.int64)
        for r, s in enumerate(sel):
            c = min(C, s.prefill_len - s.prefill_done)
            toks[r, :c] = s.prompt[s.prefill_done:s.prefill_done + c]
            pos[r] = s.prefill_done
            lens[r] = c
            bt[r] = s.block_table
        try:
            self._run_prefill("prefill_paged", lambda: lm.prefill_step_paged(
                self.cfg, self.params, self.cache, self._tensor(toks),
                self._tensor(pos), self._tensor(lens), self._tensor(bt)),
                lens)
        except KernelFault as exc:
            for s in sel:
                self._finish(s.req, Outcome.FAILED,
                             f"KernelFault during prefill: {exc}")
                self._release_paged(s)
            return
        for r, s in enumerate(sel):
            s.prefill_done += int(lens[r])
            if s.prefill_done >= s.prefill_len:
                s.to_decode()
                self._publish_prefix(s)

    def _prefill_token_by_token(self, slot: Slot):
        """One full-batch decode dispatch per prompt token.  Other slots'
        rows run token 0 at their own next position: the K/V rows they
        write there are overwritten by their next real write before they
        are ever attended to, but a mamba sub-layer's recurrent state
        accumulates that token, as the reference's does (module
        docstring)."""
        for i, t in enumerate(slot.tokens[:-1]):
            toks = np.zeros(self.sc.max_batch, np.int64)
            toks[slot.index] = t
            pos_v = self._pos_vector()
            pos_v[slot.index] = i
            t0 = self.clock()
            try:
                self._guarded_dispatch("decode", lambda: (None, lm.decode_step(
                    self.cfg, self.params, self.cache, self._tensor(toks),
                    self._tensor(pos_v))[1]), rows=())
            except KernelFault as exc:
                self._finish(slot.req, Outcome.FAILED,
                             f"KernelFault during prefill: {exc}")
                slot.release()
                return
            self._sync()
            self.stats["prefill_time_s"] += self.clock() - t0
            self.stats["prefill_dispatches"] += 1
            self.stats["prefill_tokens"] += 1
            slot.prefill_done = i + 1
        slot._to_decode()

    # ------------------------------------------------- preemption (paged)
    def _youngest_other(self, s: PagedSeq) -> Optional[PagedSeq]:
        if self.sc.preempt_policy != "youngest":
            return None
        cands = [q for q in self.active if q is not s]
        return max(cands, key=lambda q: q.admit_idx) if cands else None

    def _preempt(self, victim: PagedSeq):
        """Release the victim's pages and re-queue it at the front; on
        re-admission the effective prompt (original + generated so far)
        is recomputed — through the radix prefix cache when warm — which
        reproduces the K/V state exactly (prefill == decode equivalence),
        so the continued stream is bit-identical."""
        req = victim.req
        req.preemptions += 1
        self.stats["preemptions"] += 1
        req.resume_prompt = list(req.prompt) + list(req.out_tokens)
        self._release_paged(victim)
        self.queue.insert(0, req)

    def _ensure_write_page(self, s: PagedSeq) -> bool:
        """Make sure the page backing ``s.pos`` exists before this tick's
        decode write (lazy reservation under ``preempt_policy="youngest"``).
        Escalation on exhaustion: radix eviction -> preempt the youngest
        *other* resident -> fail ``s`` itself (PagePoolExhausted).  Under
        ``"none"`` the worst-case reservation made this a no-op."""
        idx = s.pos // self.page_size
        if s.block_table[idx] != PagePool.SCRATCH:
            return True
        pages = self.pool.alloc(1)
        if pages is None and self.radix is not None:
            self.radix.evict(1, self.pool)
            pages = self.pool.alloc(1)
        while pages is None:
            victim = self._youngest_other(s)
            if victim is None:
                break
            self._preempt(victim)
            pages = self.pool.alloc(1)
        if pages is None:
            err = PagePoolExhausted(
                f"request {s.req.rid}: no page for decode growth at pos "
                f"{s.pos} after eviction and preemption")
            self._finish(s.req, Outcome.FAILED,
                         f"{type(err).__name__}: {err}")
            self._release_paged(s)
            return False
        s.block_table[idx] = pages[0]
        self.stats["pages_used_peak"] = max(
            self.stats["pages_used_peak"], self.pool.n_used)
        return True

    # ------------------------------------------------------------- decode
    def _sample(self, logits, temps: np.ndarray) -> np.ndarray:
        nxt = torch.argmax(logits, dim=-1)
        if (temps > 0).any():
            t = torch.as_tensor(temps, device=logits.device)
            probs = torch.softmax(
                logits / torch.clamp(t, min=1e-6)[:, None], dim=-1)
            sampled = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
            nxt = torch.where(t > 0, sampled, nxt)
        return nxt.cpu().numpy()

    def _finish_stream(self, req: Request):
        """Normal terminal: OK, or PREEMPTED_RETRIED if the stream was
        ever preempted and recomputed on the way."""
        self._finish(req, Outcome.PREEMPTED_RETRIED if req.preemptions
                     else Outcome.OK)

    def _decode_tick(self):
        if self.paged:
            self._decode_tick_paged()
            return
        dec = [s for s in self.slots if s.state == Slot.DECODE]
        if not dec:
            return
        toks = np.zeros(self.sc.max_batch, np.int64)
        for s in dec:
            toks[s.index] = s.next_token
        self._decode_rows("decode", lambda: self._decode_fn(
            self.dcfg, self.params, self.cache, self._tensor(toks),
            self._tensor(self._pos_vector())),
            [(s.index, s) for s in dec], Slot.release)

    def _decode_tick_paged(self):
        dec = [s for s in self.active if s.state == PagedSeq.DECODE]
        if not dec:
            return
        B = self.sc.max_batch
        # round-robin: when more sequences are resident than dispatch rows,
        # rotate so every sequence makes progress (no starvation)
        start = self._rr % len(dec)
        order = dec[start:] + dec[:start]
        sel: List[PagedSeq] = []
        for s in order:
            if len(sel) >= B:
                break
            if s not in self.active:   # preempted/failed by earlier growth
                continue
            if self._ensure_write_page(s):
                sel.append(s)
        # growth may have preempted a sequence selected earlier this loop
        sel = [s for s in sel if s in self.active]
        if not sel:
            return
        self._rr += len(sel)
        toks = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        bt = np.zeros((B, self.pages_per_seq), np.int64)
        for r, s in enumerate(sel):
            toks[r] = s.next_token
            pos[r] = s.pos
            bt[r] = s.block_table
        self._decode_rows("decode_paged", lambda: lm.decode_step_paged(
            self.dcfg, self.params, self.cache, self._tensor(toks),
            self._tensor(pos), self._tensor(bt)),
            list(enumerate(sel)), self._release_paged)

    def _decode_rows(self, step: str, dispatch, rows, release):
        """One guarded decode dispatch over ``rows`` ((row, sequence)
        pairs): sample each row's next token and append it to its request,
        or fail the rows typed — all of them on a persistent KernelFault,
        a row whose logits stayed non-finite through the retries.
        ``release`` frees a finished sequence."""
        t0 = self.clock()
        try:
            logits, bad = self._guarded_dispatch(
                step, dispatch, rows=[r for r, _ in rows])
        except KernelFault as exc:
            for _, s in rows:
                self._finish(s.req, Outcome.FAILED, f"KernelFault: {exc}")
                release(s)
            return
        temps = np.zeros(self.sc.max_batch, np.float32)
        for r, s in rows:
            temps[r] = s.req.temperature
        nxt = self._sample(logits, temps)
        self.stats["decode_time_s"] += self.clock() - t0
        self.stats["decode_dispatches"] += 1
        self.stats["decode_tokens"] += len(rows)
        now = self.clock()
        for r, s in rows:
            req = s.req
            if r in bad:
                self._finish(req, Outcome.FAILED,
                             "non-finite logits at sample time "
                             "(retry budget spent)")
                release(s)
                continue
            tok = int(nxt[r])
            if not req.out_tokens:
                req.ttft_s = now - s.t_admit
            req.out_tokens.append(tok)
            s.next_token = tok
            s.pos += 1
            if (tok == self.sc.eos_id
                    or len(req.out_tokens) >= req.max_new_tokens
                    or s.pos >= self.sc.max_seq - 1):
                self._finish_stream(req)
                release(s)

    # ---------------------------------------------------------- deadlines
    def _deadline_reason(self, req: Request, now: float) -> str:
        waited_ms = (now - req.t_submit) * 1e3
        if self.sc.deadline_ms and waited_ms > self.sc.deadline_ms:
            return (f"total deadline {self.sc.deadline_ms:g}ms passed "
                    f"({waited_ms:.1f}ms since submit)")
        if (self.sc.ttft_deadline_ms and not req.out_tokens
                and waited_ms > self.sc.ttft_deadline_ms):
            return (f"TTFT deadline {self.sc.ttft_deadline_ms:g}ms passed "
                    f"({waited_ms:.1f}ms since submit, no token yet)")
        return ""

    def _expire_deadlines(self):
        if not (self.sc.deadline_ms or self.sc.ttft_deadline_ms):
            return
        now = self.clock()
        for req in list(self.queue):
            why = self._deadline_reason(req, now)
            if why:
                self.queue.remove(req)
                self._finish(req, Outcome.DEADLINE_EXPIRED,
                             f"{DeadlineExceeded.__name__}: {why}")
        if self.paged:
            for s in list(self.active):
                why = self._deadline_reason(s.req, now)
                if why:
                    self._finish(s.req, Outcome.DEADLINE_EXPIRED,
                                 f"{DeadlineExceeded.__name__}: {why}")
                    self._release_paged(s)
        else:
            for slot in self.slots:
                if slot.state == Slot.FREE:
                    continue
                why = self._deadline_reason(slot.req, now)
                if why:
                    self._finish(slot.req, Outcome.DEADLINE_EXPIRED,
                                 f"{DeadlineExceeded.__name__}: {why}")
                    slot.release()

    # ----------------------------------------------------------- watchdog
    def _watchdog_fire(self):
        """Break a stuck engine: no admission, dispatch or termination for
        ``watchdog_ticks`` consecutive ticks means the head-of-line
        request can never be paid for — fail it (typed) and move on
        instead of spinning to max_ticks."""
        self.stats["watchdog_fired"] += 1
        self._no_progress = 0
        msg = (f"stuck-tick watchdog: no engine progress for "
               f"{self.sc.watchdog_ticks} ticks")
        if self.queue:
            req = self.queue.pop(0)
            self._finish(req, Outcome.FAILED,
                         f"{msg} — failing head-of-line request")
            return
        if self.paged and self.active:
            s = min(self.active, key=lambda q: q.admit_idx)
            self._finish(s.req, Outcome.FAILED, msg)
            self._release_paged(s)
        elif not self.paged:
            occ = [s for s in self.slots if s.state != Slot.FREE]
            if occ:
                s = min(occ, key=lambda q: q.t_admit)
                self._finish(s.req, Outcome.FAILED, msg)
                s.release()

    # --------------------------------------------------------------- run
    def _resident(self) -> bool:
        if self.paged:
            return bool(self.active)
        return any(s.state != Slot.FREE for s in self.slots)

    def _progress_sig(self):
        return (self.stats["prefill_dispatches"],
                self.stats["decode_dispatches"],
                self._admitted, self._terminated)

    def step(self):
        """One engine tick: expire deadlines, admit, at most one prefill
        chunk dispatch, one fused decode dispatch.  Returns True when the
        tick made progress (an admission, a dispatch, or a termination).

        Chaos point ``engine.tick``: an injected :class:`EngineCrash`
        raises out of here mid-stream; recover via ``restore()`` from
        ``latest_snapshot()``."""
        self._tick += 1
        if self._chaos is not None and self._chaos.fire(
                "engine.tick", f"tick={self._tick}"):
            raise EngineCrash(
                f"[chaos] engine killed at tick {self._tick} — restore "
                f"from latest_snapshot() and rerun run_to_completion()")
        with chaos_mod.scope(self._chaos):
            return self._step_inner()

    def _step_inner(self):
        sig0 = self._progress_sig()
        self._expire_deadlines()
        self._admit()
        if self._resident():
            self._prefill_tick()
            self._decode_tick()
        return self._progress_sig() != sig0

    def run_to_completion(self, max_ticks: int = 10000):
        ticks = 0
        if self.sc.snapshot_every_ticks and not self._snapshots:
            self._take_snapshot()
        while (self.queue or self._resident()) and ticks < max_ticks:
            t0 = self.clock()
            progress = self.step()
            # per-tick heartbeat: host 0's liveness + step time feed the
            # monitor an external supervisor would watch
            self.monitor.beat(0, self._tick, self.clock() - t0)
            ticks += 1
            if (self.sc.snapshot_every_ticks
                    and self._tick % self.sc.snapshot_every_ticks == 0):
                self._take_snapshot()
            if progress:
                self._no_progress = 0
            else:
                self._no_progress += 1
                if (self.sc.watchdog_ticks
                        and self._no_progress >= self.sc.watchdog_ticks):
                    self._watchdog_fire()
        if substrate.strict_audit_enabled():
            # post-run routing cross-check: every site label the steps
            # recorded must be known to planner.model_gemms ([AF007]
            # RuntimeError otherwise) — the runtime twin of the
            # analysis.dispatch_audit pass
            substrate.check_dispatch_sites()
        return ticks

    # ------------------------------------------------- snapshot / restore
    def _take_snapshot(self):
        self._snapshots[:] = [self.snapshot()]
        self.stats["snapshots_taken"] += 1

    def latest_snapshot(self) -> Optional[dict]:
        return self._snapshots[-1] if self._snapshots else None

    def snapshot(self) -> dict:
        """Deep copy of the scheduling state at a tick boundary: queue,
        slot/sequence metadata, block tables, pool refcounts, radix tree,
        generator state, stats, chaos draw counters and the cache — K/V
        and any recurrent leaves — as CPU tensor copies (the engine writes
        its K/V in place).
        ``restore()`` rebuilds an engine that continues with bit-identical
        streams."""
        snap = {
            "paged": self.paged,
            "tick": self._tick,
            "admit_seq": self._admit_seq,
            "admitted": self._admitted,
            "terminated": self._terminated,
            "rr": self._rr,
            "gen": self.gen.get_state(),
            "stats": dict(self.stats),
            "queue": [_req_state(r) for r in self.queue],
            "cache": tuple({k: t.to("cpu", copy=True) for k, t in
                            layer.items()} for layer in self.cache),
            "chaos": (self._chaos.state_snapshot()
                      if self._chaos is not None else None),
        }
        if self.paged:
            snap["seqs"] = [
                {"req": _req_state(s.req), "prompt": list(s.prompt),
                 "block_table": list(s.block_table),
                 "n_shared": s.n_shared, "published": s.published,
                 "state": s.state, "pos": s.pos,
                 "prefill_len": s.prefill_len,
                 "prefill_done": s.prefill_done,
                 "next_token": s.next_token, "t_admit": s.t_admit,
                 "admit_idx": s.admit_idx}
                for s in self.active]
            snap["pool"] = {"free_pages": list(self.pool.free_pages),
                            "refcounts": list(self.pool.refcounts)}
            snap["radix"] = (self.radix.to_snapshot()
                             if self.radix is not None else None)
        else:
            snap["slots"] = [
                {"state": s.state, "pos": s.pos,
                 "prefill_len": s.prefill_len,
                 "prefill_done": s.prefill_done,
                 "next_token": s.next_token, "t_admit": s.t_admit,
                 "req": _req_state(s.req) if s.req is not None else None}
                for s in self.slots]
        return snap

    def _load_snapshot(self, snap: dict):
        if bool(snap["paged"]) != self.paged:
            raise ValueError("snapshot/config mode mismatch: snapshot is "
                             f"{'paged' if snap['paged'] else 'dense'}, "
                             f"engine is "
                             f"{'paged' if self.paged else 'dense'}")
        self._tick = snap["tick"]
        self._admit_seq = snap["admit_seq"]
        self._admitted = snap["admitted"]
        self._terminated = snap["terminated"]
        self._rr = snap["rr"]
        self.gen.set_state(snap["gen"])
        self.stats.update(snap["stats"])
        for layer, saved in zip(self.cache, snap["cache"]):
            for k, t in layer.items():
                t.copy_(saved[k])
        self.queue = [_req_from_state(d) for d in snap["queue"]]
        restored: List[Request] = list(self.queue)
        if self.paged:
            self.pool.free_pages[:] = list(snap["pool"]["free_pages"])
            self.pool.refcounts[:] = list(snap["pool"]["refcounts"])
            if snap.get("radix") is not None:
                if self.radix is None:
                    raise ValueError("snapshot carries a radix tree but "
                                     "prefix_cache is off in this config")
                self.radix = RadixCache.from_snapshot(snap["radix"])
            self.active = []
            for d in snap["seqs"]:
                req = _req_from_state(d["req"])
                seq = PagedSeq(req, len(d["block_table"]),
                               prompt=d["prompt"])
                seq.block_table[:] = list(d["block_table"])
                seq.n_shared = d["n_shared"]
                seq.published = d["published"]
                seq.state = d["state"]
                seq.pos = d["pos"]
                seq.prefill_len = d["prefill_len"]
                seq.prefill_done = d["prefill_done"]
                seq.next_token = d["next_token"]
                seq.t_admit = d["t_admit"]
                seq.admit_idx = d["admit_idx"]
                self.active.append(seq)
                restored.append(req)
        else:
            for slot, d in zip(self.slots, snap["slots"]):
                slot.state = d["state"]
                slot.pos = d["pos"]
                slot.prefill_len = d["prefill_len"]
                slot.prefill_done = d["prefill_done"]
                slot.next_token = d["next_token"]
                slot.t_admit = d["t_admit"]
                slot.req = (_req_from_state(d["req"])
                            if d["req"] is not None else None)
                if slot.req is not None:
                    restored.append(slot.req)
        if self._chaos is not None and snap.get("chaos") is not None:
            self._chaos.load_state(snap["chaos"])
        self.restored_requests = restored

    @classmethod
    def restore(cls, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                snap: dict, *, device=None, clock=time.perf_counter,
                reinject_crash: bool = False) -> "ServingEngine":
        """Rebuild an engine from ``snapshot()`` state after a crash.

        In-flight requests are rebuilt as fresh :class:`Request` objects
        (exposed on ``restored_requests``) and continue bit-identically.
        The new engine prepares its own copy of ``params`` on its device:
        on the card, drop every reference to the crashed engine first, or
        two prepared trees share the card.  By default the inherited chaos
        config drops its ``crash`` triggers
        (:meth:`ChaosConfig.without_crash`): replaying the same seed would
        otherwise re-kill the engine at the same draw forever.  Pass
        ``reinject_crash=True`` to keep them."""
        if serve_cfg.chaos is not None and not reinject_crash:
            serve_cfg = dataclasses.replace(
                serve_cfg, chaos=serve_cfg.chaos.without_crash())
        eng = cls(cfg, params, serve_cfg, device=device, clock=clock)
        eng._load_snapshot(snap)
        return eng


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
