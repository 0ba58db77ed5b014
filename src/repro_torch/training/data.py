"""Data pipeline: deterministic synthetic token stream (seeded, resumable)
with host-side background prefetch and per-host sharding.

Synthetic data is structured (Zipfian unigrams + local bigram correlations)
so cross-entropy actually decreases — good enough to validate end-to-end
training dynamics without shipping a corpus.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


class TokenStream:
    """Deterministic, seekable stream of (tokens, labels) batches."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0,
                 codebooks: int = 1):
        assert batch % num_hosts == 0
        self.vocab = vocab_size
        self.batch = batch // num_hosts
        self.seq = seq_len
        self.seed = seed
        self.host = host_id
        self.num_hosts = num_hosts
        self.codebooks = codebooks
        # Zipf-ish unigram table + a deterministic "grammar" matrix
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._shift = rng.integers(1, vocab_size, size=64)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, step, self.host))
        shape = (self.batch, self.seq + 1)
        if self.codebooks > 1:
            shape = shape + (self.codebooks,)
        toks = rng.choice(self.vocab, size=shape, p=self._probs).astype(np.int32)
        # bigram correlation: every odd position continues the previous token
        cont = (toks[:, :-1] + self._shift[step % 64]) % self.vocab
        mask = (np.arange(self.seq + 1)[1:] % 2 == 1)
        if self.codebooks > 1:
            toks[:, 1:][:, mask] = cont[:, mask]
        else:
            toks[:, 1:][:, mask] = cont[:, mask]
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering over a TokenStream."""

    def __init__(self, stream: TokenStream, start_step: int = 0, depth: int = 2):
        self.stream = stream
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self.stream.batch_at(s), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self):
        item = self._q.get()
        self.step += 1
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=1.0)
