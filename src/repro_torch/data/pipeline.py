"""Own copy of ``repro/data/pipeline.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_runtime.py`` holds the two batch for
batch.  Batches are numpy arrays: ``forward_hidden`` moves them to the
model's device.

Deterministic, shard-aware token pipeline.

Design for 1000+ node operation:
  * every batch is a pure function of (seed, step, host_shard) — a restarted
    or replacement host reproduces exactly the batches it would have seen
    (no data-loss / no double-visit on failover, the property the trainer's
    restart test asserts);
  * backing store is either a synthetic deterministic stream or a memmapped
    token file (``np.memmap``, zero-copy reads, sequential window access);
  * a background prefetch thread keeps ``prefetch`` batches ready so host
    input never stalls the device step (overlap of input pipeline and
    compute).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    token_file: Optional[str] = None  # memmap path; None -> synthetic
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def synth_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0):
    """Materialize a synthetic corpus as a token file (for the memmap path)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, n_tokens, dtype=np.int32)
    toks.tofile(path)
    return path


class ShardedTokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch addressing ------------------------------------
    def batch_at(self, step: int) -> dict:
        """The host's shard of the global batch for ``step`` (pure function)."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + cfg.host_id * cfg.host_batch
        if self._mm is not None:
            n = len(self._mm) - (cfg.seq_len + 1)
            # per-row deterministic offsets (hash-spread to decorrelate)
            for r in range(cfg.host_batch):
                idx = (base + r) * 2654435761 % max(n, 1)
                rows.append(np.asarray(self._mm[idx:idx + cfg.seq_len + 1]))
            arr = np.stack(rows)
        else:
            rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
            arr = rng.integers(0, cfg.vocab,
                               (cfg.host_batch, cfg.seq_len + 1), dtype=np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    # -- prefetching iterator ----------------------------------------------
    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        cfg = self.cfg
        self._q = queue.Queue(maxsize=cfg.prefetch)
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
