"""Deterministic, host-sharded data pipeline.

Two sources behind one iterator interface:
  * SyntheticLM  — seeded Zipf-ish token stream (CI / dry-runs / perf work);
  * MemmapCorpus — np.memmap-backed token file (production path).

Sharding contract: every host draws only its slice of the global batch
(``host_index``/``host_count``); step -> sample mapping is a pure function of
(seed, step), so restarts resume exactly and elastic re-sharding (a host
count change) re-partitions the same global stream without duplication.
"""
from __future__ import annotations

import threading
import queue
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    seed: int = 1234
    path: str = ""             # memmap token file ("" -> synthetic)
    dtype: str = "int32"


class SyntheticLM:
    """Deterministic Zipf-distributed tokens with structure (repeats) so a
    model can actually reduce loss on it."""

    def __init__(self, cfg: DataConfig, host_index=0, host_count=1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        out_tok = np.empty((self.local_batch, cfg.seq_len + 1), np.int32)
        for b in range(self.local_batch):
            g = self.host_index * self.local_batch + b
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, g]))
            z = rng.zipf(1.3, size=cfg.seq_len + 1)
            toks = (z % (cfg.vocab_size - 2)) + 2
            # inject copy structure: second half repeats the first quarter
            q = (cfg.seq_len + 1) // 4
            toks[2 * q:3 * q] = toks[:q]
            out_tok[b] = toks
        return {"tokens": out_tok[:, :-1],
                "labels": out_tok[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapCorpus:
    """Token file of shape (n_tokens,) read as strided windows."""

    def __init__(self, cfg: DataConfig, host_index=0, host_count=1):
        assert cfg.path
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype),
                                mode="r")
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        # one global permutation draw per step; hosts take disjoint slices
        idx = rng.integers(0, self.n_windows, size=cfg.global_batch)
        lo = self.host_index * self.local_batch
        windows = idx[lo:lo + self.local_batch]
        toks = np.stack([
            self.tokens[w * cfg.seq_len:w * cfg.seq_len + cfg.seq_len + 1]
            for w in windows]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of the next N batches."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def make_pipeline(cfg: DataConfig, host_index=0, host_count=1,
                  start_step: int = 0, prefetch: int = 2):
    src = (MemmapCorpus(cfg, host_index, host_count) if cfg.path
           else SyntheticLM(cfg, host_index, host_count))
    if prefetch:
        return Prefetcher(src, start_step=start_step, depth=prefetch)
    return src
