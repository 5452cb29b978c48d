"""Deterministic synthetic LM data with host sharding and prefetch (the
port's copy of ``repro.data.pipeline``; numpy only).

Each host takes its slice of the global batch, derived from (seed, step,
host) alone, so a restarted job resumes bit-identically mid-epoch (the
checkpoint stores the step) and ``batch_at`` gives the JAX package's arrays
bit for bit. Batches are numpy arrays: moving one to the device is the
trainer's job (``launch.train``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    pad_frac: float = 0.0  # fraction of trailing positions padded (-1 labels)


class SyntheticLM:
    """Deterministic token stream: batch(step) is a pure function of config."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg

    def batch_at(self, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        d = self.dcfg
        assert d.global_batch % num_hosts == 0
        local = d.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, host_id])
        )
        if self.cfg.input_kind == "tokens":
            toks = rng.integers(
                0, self.cfg.vocab_size, (local, d.seq_len + 1), dtype=np.int32
            )
            inputs, labels = toks[:, :-1], toks[:, 1:].copy()
        else:
            inputs = rng.standard_normal(
                (local, d.seq_len, self.cfg.d_model), dtype=np.float32
            )
            labels = rng.integers(
                0, self.cfg.vocab_size, (local, d.seq_len), dtype=np.int32
            )
        if d.pad_frac > 0:
            npad = int(d.seq_len * d.pad_frac)
            if npad:
                labels[:, -npad:] = -1
        return {"inputs": inputs, "labels": labels}


class Prefetcher:
    """Background-thread prefetch (depth-bounded), hiding host data latency."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2,
                 host_id: int = 0, num_hosts: int = 1):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._host = (host_id, num_hosts)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step, *self._host)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
