"""Batched serving engine: chunked batched prefill + continuous batching.

Port of the reference's ``serving/engine.py`` (dense K/V cache, greedy or
temperature sampling).  A fixed pool of ``max_batch`` sequence
:class:`Slot`\\ s, each with an explicit lifecycle::

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
fp32; a non-finite logit row of a live request raises.  Sampling at temperature >
0 draws from a ``torch.Generator`` seeded with ``ServeConfig.seed`` (its
draws differ from the reference's ``jax.random`` ones).

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
pages and skip the shared pages' prefill.  Each admission reserves its
worst case (prompt + ``max_new_tokens``, clipped to ``max_seq``) up
front, the reference's ``preempt_policy="none"``; a request that does not
fit waits at the head of the queue.

Not ported yet (ROADMAP Queue 1, resilience): typed outcomes, deadlines,
retries, preemption (lazy page reservation), chaos injection and
snapshots; and disaggregated serving.
"""
from __future__ import annotations

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

    def assign(self, req: Request, now: float):
        self.req = req
        self.t_admit = now
        self.prefill_len = len(req.prompt) - 1
        self.prefill_done = 0
        if self.prefill_len == 0:
            self._to_decode()
        else:
            self.state = Slot.PREFILL
            self.pos = 0

    def _to_decode(self):
        self.state = Slot.DECODE
        self.pos = self.prefill_len
        self.next_token = self.req.prompt[-1]

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


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 *, device=None, clock=time.perf_counter):
        substrate.check_backend(cfg.gemm_backend)
        lm.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
            if serve_cfg.kv_pages < self.pages_per_seq + 1:
                raise ValueError(
                    f"kv_pages={serve_cfg.kv_pages}: need at least "
                    f"{self.pages_per_seq + 1} (max_seq/page_size pages "
                    f"for one worst-case sequence + the scratch page)")
            self.pool = PagePool(serve_cfg.kv_pages, page)
            self.radix = (RadixCache(page) if serve_cfg.prefix_cache
                          else None)
            self.cache = lm.init_paged_cache(cfg, serve_cfg.kv_pages, page,
                                             device=self.device)
            self._rr = 0                  # decode round-robin cursor
        else:
            self.cache = lm.init_cache(cfg, B, S, device=self.device)
            self.slots = [Slot(i) for i in range(B)]
        self.stats = dict(prefill_dispatches=0, decode_dispatches=0,
                          prefill_tokens=0, decode_tokens=0,
                          prefill_time_s=0.0, decode_time_s=0.0,
                          prefill_gemm_dispatches=0,
                          pages_used_peak=0, concurrency_peak=0,
                          prefix_hit_tokens=0)

    def kv_cache_bytes(self) -> int:
        """Resident K/V bytes (pool pages in paged mode, the dense
        (max_batch, max_seq) region otherwise)."""
        return sum(t.numel() * t.element_size()
                   for layer in self.cache for t in layer.values())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray):
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) > self.sc.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"exceeds max_seq={self.sc.max_seq}")
        self.queue.append(req)

    def _admit(self):
        if self.paged:
            self._admit_paged()
            return
        now = self.clock()
        for slot in self.slots:
            if slot.state == Slot.FREE and self.queue:
                slot.assign(self.queue.pop(0), now)

    def _admit_paged(self):
        """Memory-bounded admission: FIFO-pop the queue while the pool can
        reserve each request's worst-case page span (prompt + max_new,
        clipped to max_seq) minus whatever the radix prefix cache already
        holds.  Concurrency is whatever the page budget sustains, not
        ``max_batch``."""
        now = self.clock()
        while self.queue:
            req = self.queue[0]
            target = min(len(req.prompt) + req.max_new_tokens,
                         self.sc.max_seq)
            need = -(-target // self.page_size)
            shared: List[int] = []
            if self.radix is not None and len(req.prompt) > 1:
                # only K/V of prompt[:-1] may be borrowed: the final
                # prompt token must run through this request's own decode
                # to produce its first logits
                shared = self.radix.match(req.prompt[:-1])[:need]
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
            seq = PagedSeq(req, self.pages_per_seq)
            m = len(shared)
            seq.block_table[:m] = shared
            seq.block_table[m:m + len(pages)] = pages
            seq.t_admit = now
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
            toks[s.index, :c] = s.req.prompt[s.prefill_done:
                                             s.prefill_done + c]
            lens[s.index] = c
        self._run_prefill(lambda: lm.prefill_step(
            self.cfg, self.params, self.cache, self._tensor(toks),
            self._tensor(pos), self._tensor(lens)), lens)
        for s in pre:
            s.finish_chunk(int(lens[s.index]))

    def _run_prefill(self, step, lens: np.ndarray):
        """Run one prefill-chunk dispatch and book its time, tokens and
        GEMM dispatches."""
        t0 = self.clock()
        d0 = sum(substrate.DISPATCH_COUNTS.values())
        step()
        self._sync()
        self.stats["prefill_time_s"] += self.clock() - t0
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += int(lens.sum())
        self.stats["prefill_gemm_dispatches"] += (
            sum(substrate.DISPATCH_COUNTS.values()) - d0)

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
        self._run_prefill(lambda: lm.prefill_step_paged(
            self.cfg, self.params, self.cache, self._tensor(toks),
            self._tensor(pos), self._tensor(lens), self._tensor(bt)), lens)
        for r, s in enumerate(sel):
            s.prefill_done += int(lens[r])
            if s.prefill_done >= s.prefill_len:
                s.to_decode()
                self._publish_prefix(s)

    def _prefill_token_by_token(self, slot: Slot):
        """One full-batch decode dispatch per prompt token.  Other slots'
        rows write garbage at their own next position, which their next
        real write overwrites before it is ever attended to."""
        for i, t in enumerate(slot.req.prompt[:-1]):
            toks = np.zeros(self.sc.max_batch, np.int64)
            toks[slot.index] = t
            pos_v = self._pos_vector()
            pos_v[slot.index] = i
            t0 = self.clock()
            lm.decode_step(self.cfg, self.params, self.cache,
                           self._tensor(toks), self._tensor(pos_v))
            self._sync()
            self.stats["prefill_time_s"] += self.clock() - t0
            self.stats["prefill_dispatches"] += 1
            self.stats["prefill_tokens"] += 1
            slot.prefill_done = i + 1
        slot._to_decode()

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
        t0 = self.clock()
        logits, _ = lm.decode_step(self.cfg, self.params, self.cache,
                                   self._tensor(toks),
                                   self._tensor(self._pos_vector()))
        for s in self._emit(logits, [(s.index, s) for s in dec], t0):
            s.release()

    def _ensure_write_page(self, s: PagedSeq):
        """Make sure the page backing ``s.pos`` exists before this tick's
        decode write.  Admission reserved the worst case, so it does; were
        it missing, the radix tree gives up LRU pages before the pool is
        declared exhausted (the reference's lazy reservation, which grows
        here and preempts on exhaustion, is not ported)."""
        idx = s.pos // self.page_size
        if s.block_table[idx] != PagePool.SCRATCH:
            return
        pages = self.pool.alloc(1)
        if pages is None and self.radix is not None:
            self.radix.evict(1, self.pool)
            pages = self.pool.alloc(1)
        if pages is None:
            raise RuntimeError(
                f"request {s.req.rid}: no page for decode growth at pos "
                f"{s.pos} after radix eviction")
        s.block_table[idx] = pages[0]
        self.stats["pages_used_peak"] = max(
            self.stats["pages_used_peak"], self.pool.n_used)

    def _decode_tick_paged(self):
        dec = [s for s in self.active if s.state == PagedSeq.DECODE]
        if not dec:
            return
        B = self.sc.max_batch
        # round-robin: when more sequences are resident than dispatch rows,
        # rotate so every sequence makes progress (no starvation)
        start = self._rr % len(dec)
        sel = (dec[start:] + dec[:start])[:B]
        self._rr += len(sel)
        toks = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        bt = np.zeros((B, self.pages_per_seq), np.int64)
        for r, s in enumerate(sel):
            self._ensure_write_page(s)
            toks[r] = s.next_token
            pos[r] = s.pos
            bt[r] = s.block_table
        t0 = self.clock()
        logits, _ = lm.decode_step_paged(self.cfg, self.params, self.cache,
                                         self._tensor(toks),
                                         self._tensor(pos), self._tensor(bt))
        for s in self._emit(logits, list(enumerate(sel)), t0):
            self._release_paged(s)

    def _emit(self, logits, rows, t0: float) -> list:
        """Sample the next token of each (row, sequence) of a decode
        dispatch started at ``t0`` and append it to its request; returns
        the sequences that finished."""
        idx = [r for r, _ in rows]
        if not bool(torch.isfinite(logits[idx]).all()):
            raise FloatingPointError(
                f"non-finite logits in decode rows {idx} at positions "
                f"{[s.pos for _, s in rows]}")
        temps = np.zeros(self.sc.max_batch, np.float32)
        for r, s in rows:
            temps[r] = s.req.temperature
        nxt = self._sample(logits, temps)
        self.stats["decode_time_s"] += self.clock() - t0
        self.stats["decode_dispatches"] += 1
        self.stats["decode_tokens"] += len(rows)
        now = self.clock()
        finished = []
        for r, s in rows:
            req = s.req
            tok = int(nxt[r])
            if not req.out_tokens:
                req.ttft_s = now - s.t_admit
            req.out_tokens.append(tok)
            s.next_token = tok
            s.pos += 1
            if (tok == self.sc.eos_id
                    or len(req.out_tokens) >= req.max_new_tokens
                    or s.pos >= self.sc.max_seq - 1):
                req.done = True
                finished.append(s)
        return finished

    # --------------------------------------------------------------- run
    def _resident(self) -> bool:
        if self.paged:
            return bool(self.active)
        return any(s.state != Slot.FREE for s in self.slots)

    def step(self):
        """One engine tick: admit, at most one prefill chunk dispatch, one
        fused decode dispatch."""
        self._admit()
        if self._resident():
            self._prefill_tick()
            self._decode_tick()

    def run_to_completion(self, max_ticks: int = 10000):
        ticks = 0
        while (self.queue or self._resident()) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
