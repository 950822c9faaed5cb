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

Paged K/V, the prefix cache, resilience (typed outcomes, deadlines,
retries, preemption, snapshots) and disaggregated serving are not ported
yet.
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
        self.cache = lm.init_cache(cfg, B, S, device=self.device)
        self.slots = [Slot(i) for i in range(B)]
        self.stats = dict(prefill_dispatches=0, decode_dispatches=0,
                          prefill_tokens=0, decode_tokens=0,
                          prefill_time_s=0.0, decode_time_s=0.0,
                          prefill_gemm_dispatches=0)

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
        now = self.clock()
        for slot in self.slots:
            if slot.state == Slot.FREE and self.queue:
                slot.assign(self.queue.pop(0), now)

    def _pos_vector(self) -> np.ndarray:
        return np.asarray([s.write_pos for s in self.slots], np.int64)

    # ------------------------------------------------------------ prefill
    def _prefill_tick(self):
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
        t0 = self.clock()
        d0 = sum(substrate.DISPATCH_COUNTS.values())
        lm.prefill_step(self.cfg, self.params, self.cache, self._tensor(toks),
                        self._tensor(pos), self._tensor(lens))
        self._sync()
        self.stats["prefill_time_s"] += self.clock() - t0
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += int(lens.sum())
        self.stats["prefill_gemm_dispatches"] += (
            sum(substrate.DISPATCH_COUNTS.values()) - d0)
        for s in pre:
            s.finish_chunk(int(lens[s.index]))

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
        dec = [s for s in self.slots if s.state == Slot.DECODE]
        if not dec:
            return
        toks = np.zeros(self.sc.max_batch, np.int64)
        temps = np.zeros(self.sc.max_batch, np.float32)
        for s in dec:
            toks[s.index] = s.next_token
            temps[s.index] = s.req.temperature
        t0 = self.clock()
        logits, _ = lm.decode_step(self.cfg, self.params, self.cache,
                                   self._tensor(toks),
                                   self._tensor(self._pos_vector()))
        rows = [s.index for s in dec]
        if not bool(torch.isfinite(logits[rows]).all()):
            raise FloatingPointError(
                f"non-finite logits in decode rows {rows} at positions "
                f"{[s.pos for s in dec]}")
        nxt = self._sample(logits, temps)
        self.stats["decode_time_s"] += self.clock() - t0
        self.stats["decode_dispatches"] += 1
        self.stats["decode_tokens"] += len(dec)
        now = self.clock()
        for s in dec:
            req = s.req
            tok = int(nxt[s.index])
            if not req.out_tokens:
                req.ttft_s = now - s.t_admit
            req.out_tokens.append(tok)
            s.next_token = tok
            s.pos += 1
            if (tok == self.sc.eos_id
                    or len(req.out_tokens) >= req.max_new_tokens
                    or s.pos >= self.sc.max_seq - 1):
                req.done = True
                s.release()

    # --------------------------------------------------------------- run
    def _resident(self) -> bool:
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
