"""Disaggregated prefill/decode serving, on one device.

Port of the reference's ``serving/disagg.py`` at ``pp_stages = 1``.  The
colocated :class:`~repro_torch.serving.engine.ServingEngine` interleaves
at most one prefill-chunk dispatch with one decode dispatch a tick, on one
K/V cache.  Disaggregation splits the two phases into roles (the
reference's prefill and decode pods), each under its own objective:

* the **prefill role** runs chunked prefill into a cache of its own
  (``pcache``), with the chunk re-picked under the prefill objective
  (:data:`PREFILL_STEP_OVERHEAD`): with no decode stream to protect,
  per-dispatch overhead is the only thing the chunk trades against;
* the **decode role** runs the round-robin fused decode step on the
  decode cache (``cache``), under the decode role's config;
* a finished prefill **hands off** the request's K/V from ``pcache`` to
  ``cache``: dense mode copies the slot's row of every cache leaf (K/V,
  and a mamba layer's recurrent ``state`` / ``conv``), paged mode exactly
  the live pages the block table names.  The handoff is a failure domain:
  the ``transfer.kv`` chaos point drops it, the engine retries up to
  ``max_retries`` times, and a persistent fault fails the request with a
  typed :class:`~repro_torch.serving.errors.TransferFault` ->
  ``Outcome.FAILED``.

At ``pp_stages = 1`` the reference's pods are counts: it places no cache
on a device window, and its measurement model is one process that runs
both roles in turn.  The role configs carry ``pp_role``; with
``pp_stages <= 1`` the pricing scope the lm entry points enter is inert
and each role's plans are the colocated ones.

``pp_stages > 1`` pipelines each role's layers over its pods: the role
configs take a (pp, 1, 1) role mesh (the prefill pods' device window
``[0, pp)``, the decode pods' after it, strict: a host with fewer
devices raises at construction) and the steps run through
``lm.prefill_step_pp`` / ``lm.decode_step_pp``, each stage once on its
device; the handoff moves a row onto the decode cache's device.  The
reference's checks hold: dense K/V, ``prefill_pods == decode_pods ==
pp_stages`` and the batched prefill.  On one card every logical device
is the same one: the stages run one after another there and the caches
stay where the engine made them.

**Equivalence.**  Greedy streams equal the colocated engine's: K/V writes
are per-position projections (chunking never changes them), the handoff
copies bits, and the decode step runs the same math.  A W8A8 backend keeps
the colocated chunk (per-tile activation scales make tile geometry part of
its numerics).  Token-mode prefill runs a full-batch decode step on
``pcache``, so a mamba layer's co-resident rows there advance on token 0,
as they do in ``cache`` colocated — but in another cache: an SSM model's
disaggregated streams are the reference's disaggregated streams, not the
colocated ones (in both packages).

**Measurement model.**  One process runs both roles in turn, but the
engine keeps per-role busy clocks (``stats["prefill_time_s"]`` /
``stats["decode_time_s"]``, each read after a device synchronize).  In a
deployment the roles run concurrently, so a request's disaggregated TTFT
excludes the other role's work: ``ttft_virtual[rid]`` is the prefill
role's busy time spent on the request (admission to handoff, the handoff
included) plus the decode role's busy time to its first token.  The
disaggregated makespan is the larger role clock where colocated pays
their sum.

**Pod loss** (``disagg.pod`` chaos point): a decode pod dies mid-stream.
Dense mode preempts every DECODE-resident request (``resume_prompt`` =
prompt + generated, re-queued at the front, prefilled again on the
prefill role, handed off again) and cold-starts the decode cache; paged
mode preempts each decode-resident sequence through the engine's
``_preempt``.  Recovered streams finish ``PREEMPTED_RETRIED`` with the
undisturbed run's tokens.

The radix prefix cache (``prefix_cache=True``) is refused, as in the
reference: it assumes one cache owns the shared pages.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner
from repro_torch.kernels import substrate
from repro_torch.models import lm
from repro_torch.serving.engine import (PREFILL_CHUNK_CHOICES, Request,
                                        ServeConfig, ServingEngine, Slot)
from repro_torch.serving.errors import KernelFault, Outcome, TransferFault
from repro_torch.serving.paged import PagePool, PagedSeq

# Prefill-role chunk objective: with no decode stream to protect, the
# chunk only trades dispatch count against per-step cost, so the fixed
# per-dispatch overhead weighs heavier than in the colocated engine's
# attention_plan call.
PREFILL_STEP_OVERHEAD = 4.0


@dataclass(frozen=True)
class DisaggServeConfig(ServeConfig):
    """:class:`ServeConfig` plus the disaggregation geometry.

    ``prefill_pods`` / ``decode_pods`` size the two roles; ``pp_stages``
    pipelines layers over each role's pods (``1`` = no pipeline; ``> 1``
    requires ``prefill_pods == decode_pods == pp_stages``, dense K/V and
    the two role windows' devices)."""

    prefill_pods: int = 1
    decode_pods: int = 1
    pp_stages: int = 1


class DisaggServingEngine(ServingEngine):
    """Prefill/decode-disaggregated serving engine (module docstring).

    Scheduling stays the base engine's (admission, deadlines, watchdog,
    snapshots, chaos scope); only the prefill path is re-routed onto the
    prefill role's cache and config, with the K/V handoff bridging into
    the decode path."""

    def __init__(self, cfg: ModelConfig, params,
                 serve_cfg: DisaggServeConfig, *, device=None,
                 clock=time.perf_counter):
        if not isinstance(serve_cfg, DisaggServeConfig):
            raise TypeError("DisaggServingEngine needs a DisaggServeConfig "
                            f"(got {type(serve_cfg).__name__})")
        if serve_cfg.prefill_pods < 1 or serve_cfg.decode_pods < 1:
            raise ValueError(
                f"prefill_pods={serve_cfg.prefill_pods} / "
                f"decode_pods={serve_cfg.decode_pods}: each role needs at "
                f"least one pod")
        if serve_cfg.prefix_cache:
            raise ValueError(
                "prefix_cache=True is colocated-only: radix-shared pages "
                "assume one cache owns them, and the disaggregated handoff "
                "would either move shared pages twice or leave the decode "
                "pods reading pages they don't hold")
        pp = max(1, int(serve_cfg.pp_stages))
        if pp > 1:
            if serve_cfg.kv_pages:
                raise ValueError(
                    "pp_stages > 1 requires dense K/V (kv_pages=0): the "
                    "paged gather/scatter steps have no pipeline variant")
            if serve_cfg.prefill_pods != pp or serve_cfg.decode_pods != pp:
                raise ValueError(
                    f"pp_stages={pp} pipelines layers over each role's "
                    f"whole submesh: need prefill_pods == decode_pods == "
                    f"{pp}, got {serve_cfg.prefill_pods}+"
                    f"{serve_cfg.decode_pods}")

        super().__init__(cfg, params, serve_cfg, device=device, clock=clock)

        if pp > 1 and self.prefill_mode != "batched":
            raise ValueError("pp_stages > 1 requires the batched prefill "
                             "path (prefill_mode='batched' or 'auto' on a "
                             "supporting family)")
        # Role configs: same model, opposite plan objectives.  pp_role
        # engages the pricing scope inside the lm entry points; with
        # pp_stages <= 1 it is inert and the role plans are the colocated
        # ones bit for bit.  At pp_stages > 1 each role pipelines its
        # layers over a (pp, 1, 1) role mesh: the prefill pods' device
        # window first, the decode pods' after it.
        self.pp = pp
        self._prefill_fn = lm.prefill_step
        if pp > 1:
            self.pcfg = dataclasses.replace(
                cfg, pp_role="prefill", pp_stages=pp, mesh_shape=(pp, 1, 1),
                pod_offset=0)
            self.dcfg = dataclasses.replace(
                cfg, pp_role="decode", pp_stages=pp, mesh_shape=(pp, 1, 1),
                pod_offset=serve_cfg.prefill_pods)
            # fail at construction, not mid-serve: the role windows need
            # prefill_pods + decode_pods devices, and the model must
            # support the pipeline (stage-divisible layers, batched
            # prefill)
            lm._check_pp(self.pcfg)
            lm._check_pp(self.dcfg)
            self._pmesh = self._resolve_mesh(self.pcfg)
            self._dmesh = self._resolve_mesh(self.dcfg)
            self._decode_fn = lm.decode_step_pp
            self._prefill_fn = lm.prefill_step_pp
        else:
            self.pcfg = dataclasses.replace(cfg, pp_role="prefill")
            self.dcfg = dataclasses.replace(cfg, pp_role="decode")

        # Prefill-role chunk re-pick (PREFILL_STEP_OVERHEAD).  An explicit
        # serve_cfg.prefill_chunk wins, and a W8A8 backend keeps the
        # colocated pick: its per-tile activation scales make chunk
        # geometry part of the numerics.
        if (self.prefill_mode == "batched" and not serve_cfg.prefill_chunk
                and not substrate.backend_act_quantizes(cfg.gemm_backend)):
            S = serve_cfg.max_seq
            self.prefill_chunk = min(S, max(1, planner.attention_plan(
                S, S, choices=PREFILL_CHUNK_CHOICES,
                step_overhead=PREFILL_STEP_OVERHEAD)))

        # The prefill role's own cache; self.cache stays the decode
        # role's.  Paged mode mirrors the page pools with one shared
        # PagePool / block-table numbering, so the handoff is a copy at
        # the live page indices.
        if self.paged:
            self.pcache = lm.init_paged_cache(
                cfg, serve_cfg.kv_pages, self.page_size, device=self.device)
        else:
            self.pcache = lm.init_cache(
                cfg, serve_cfg.max_batch, serve_cfg.max_seq,
                device=self.device)

        self.stats.update(kv_transfer_pages=0, kv_transfer_bytes=0,
                          transfer_retries=0, pod_losses=0)
        # virtual role-clock marks per rid (module docstring): p0 =
        # prefill busy at admission; pused = prefill busy spent on the
        # request (handoff included); d0 = decode busy at handoff
        self._vt: Dict[int, dict] = {}
        self.ttft_virtual: Dict[int, float] = {}

    # ---------------------------------------------------------- handoff
    def _transfer_ok(self, detail: str) -> bool:
        """One ``transfer.kv`` chaos draw an attempt, retried up to the
        engine's retry budget.  True: the K/V move may proceed."""
        if self._chaos is None:
            return True
        retries = max(0, self.sc.max_retries)
        for attempt in range(retries + 1):
            if not self._chaos.fire("transfer.kv", detail):
                return True
            if attempt < retries:
                self.stats["transfer_retries"] += 1
        return False

    def _mark_handoff(self, req: Request):
        m = self._vt.get(req.rid)
        if m is not None:
            m["pused"] = self.stats["prefill_time_s"] - m["p0"]
            m["d0"] = self.stats["decode_time_s"]

    def _transfer_failed(self, req: Request, what: str):
        err = TransferFault(
            f"request {req.rid}: pod->pod K/V handoff{what} dropped "
            f"{self.sc.max_retries + 1} times (retry budget spent)")
        self._finish(req, Outcome.FAILED, f"{type(err).__name__}: {err}")

    def _copy(self, index) -> int:
        """Copy ``pcache[..][:, index]`` into ``cache`` for every leaf (a
        slot's row, or a tensor of page ids), timed on the prefill role's
        clock (the handoff is its egress); returns the bytes moved."""
        t0 = self.clock()
        moved = 0
        for src, dst in zip(self.pcache, self.cache):
            for key, p in src.items():
                part = p[:, index]
                # the cross-window move, onto the decode cache's device
                dst[key][:, index] = part.to(dst[key].device)
                moved += part.numel() * part.element_size()
        self._sync()
        self.stats["prefill_time_s"] += self.clock() - t0
        return moved

    def _handoff_dense(self, slot: Slot) -> bool:
        """Move the slot's prefilled cache row to the decode cache.  The
        whole row is copied: positions past ``prefill_len`` hold garbage,
        but decode writes each position before it is attended.  False: a
        persistent transfer fault, the request failed."""
        b = slot.index
        req = slot.req
        if not self._transfer_ok(f"rid={req.rid} slot={b}"):
            self._transfer_failed(req, "")
            slot.release()
            return False
        self.stats["kv_transfer_bytes"] += self._copy(b)
        self._mark_handoff(req)
        return True

    def _handoff_paged(self, seq: PagedSeq) -> bool:
        """Move exactly the live pages the block table names — positions
        ``[0, prefill_len)`` span the first ``ceil(prefill_len / page)``
        entries — not the pool.  False: a persistent fault."""
        req = seq.req
        n_pg = -(-seq.prefill_len // self.page_size) if seq.prefill_len \
            else 0
        idx = sorted({int(pg) for pg in seq.block_table[:n_pg]
                      if pg != PagePool.SCRATCH})
        if not idx:
            self._mark_handoff(req)
            return True
        if not self._transfer_ok(f"rid={req.rid} pages={len(idx)}"):
            self._transfer_failed(req, f" of {len(idx)} pages")
            self._release_paged(seq)
            return False
        ix = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        self.stats["kv_transfer_bytes"] += self._copy(ix)
        self.stats["kv_transfer_pages"] += len(idx)
        self._mark_handoff(req)
        return True

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
            self._run_prefill("prefill", lambda: self._prefill_fn(
                self.pcfg, self.params, self.pcache, self._tensor(toks),
                self._tensor(pos), self._tensor(lens)), lens,
                target="pcache")
        except KernelFault as exc:
            for s in pre:
                self._finish(s.req, Outcome.FAILED,
                             f"KernelFault during prefill: {exc}")
                s.release()
            return
        for s in pre:
            s.finish_chunk(int(lens[s.index]))
            if s.state == Slot.DECODE:
                self._handoff_dense(s)

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
                self.pcfg, self.params, self.pcache, self._tensor(toks),
                self._tensor(pos), self._tensor(lens), self._tensor(bt)),
                lens, target="pcache")
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
                self._handoff_paged(s)

    def _prefill_token_by_token(self, slot: Slot):
        """The decode-path step, token by token, on the prefill role's
        cache and config: the ``decode_p`` step of the draw book (the
        reference jits it apart from ``decode``)."""
        for i, t in enumerate(slot.tokens[:-1]):
            toks = np.zeros(self.sc.max_batch, np.int64)
            toks[slot.index] = t
            pos_v = self._pos_vector()
            pos_v[slot.index] = i
            t0 = self.clock()
            try:
                self._guarded_dispatch(
                    "decode_p", lambda: (None, lm.decode_step(
                        self.pcfg, self.params, self.pcache,
                        self._tensor(toks), self._tensor(pos_v))[1]),
                    rows=(), target="pcache")
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
        self._handoff_dense(slot)

    # ----------------------------------------------- virtual role clocks
    def _residents(self):
        if self.paged:
            return list(self.active)
        return [s for s in self.slots if s.req is not None]

    def _admit(self):
        before = {s.req.rid for s in self._residents()}
        super()._admit()
        pnow = self.stats["prefill_time_s"]
        decode_state = PagedSeq.DECODE if self.paged else Slot.DECODE
        for s in self._residents():
            if s.req.rid in before:
                continue
            self._vt[s.req.rid] = {"p0": pnow}
            if s.state == decode_state:
                # single-token prompt: nothing to prefill or hand off
                self._mark_handoff(s.req)

    def _decode_tick(self):
        decode_state = PagedSeq.DECODE if self.paged else Slot.DECODE
        pending = [s.req for s in self._residents()
                   if s.state == decode_state and not s.req.out_tokens]
        super()._decode_tick()
        dnow = self.stats["decode_time_s"]
        for req in pending:
            if req.out_tokens and req.rid not in self.ttft_virtual:
                m = self._vt.get(req.rid)
                if m is not None and "d0" in m:
                    self.ttft_virtual[req.rid] = \
                        m["pused"] + (dnow - m["d0"])

    # ----------------------------------------------------------- pod loss
    def _pod_loss(self):
        """A decode pod died: every decode-resident stream preempts and
        re-admits through the recompute path (prefilled again on the
        prefill role, handed off again); PREFILL residents live on the
        surviving role and continue untouched."""
        self.stats["pod_losses"] += 1
        if self.paged:
            for s in [q for q in self.active
                      if q.state == PagedSeq.DECODE]:
                self._preempt(s)
            return
        lost = False
        for slot in self.slots:
            if slot.state != Slot.DECODE:
                continue
            req = slot.req
            req.preemptions += 1
            self.stats["preemptions"] += 1
            req.resume_prompt = list(req.prompt) + list(req.out_tokens)
            slot.release()
            self.queue.insert(0, req)
            lost = True
        if lost:
            # the replacement decode pod starts cold; every re-admitted
            # stream rebuilds its row through prefill + handoff
            for layer in self.cache:
                for t in layer.values():
                    t.zero_()

    def _step_inner(self):
        if self._chaos is not None and self._chaos.fire(
                "disagg.pod", f"tick={self._tick}"):
            self._pod_loss()
        return super()._step_inner()

    # ------------------------------------------------- snapshot / restore
    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["pcache"] = tuple({k: t.to("cpu", copy=True)
                                for k, t in layer.items()}
                               for layer in self.pcache)
        return snap

    def _load_snapshot(self, snap: dict):
        super()._load_snapshot(snap)
        if "pcache" in snap:
            for layer, saved in zip(self.pcache, snap["pcache"]):
                for k, t in layer.items():
                    t.copy_(saved[k])
