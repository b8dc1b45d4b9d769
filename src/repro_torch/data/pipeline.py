"""Deterministic synthetic token pipeline with shard-aware skip-ahead.

The port's copy of ``repro.data.pipeline`` (numpy only, as there): batch
``t`` is a pure function of (seed, step, shard), so a restarted replica
regenerates exactly its slice without replaying the stream (the skip-ahead
contract the train loop's resume relies on); each data-parallel shard draws
only its rows; a background thread keeps ``prefetch`` batches ready.
``SyntheticLMDataset.batch`` returns the reference's arrays bit for bit,
``embeds`` included.

The token distribution is a Zipfian unigram mix with short-range repeats —
enough structure that cross entropy visibly decreases on a small run, while
staying fully offline.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLMDataset", "make_batch_iterator"]


class SyntheticLMDataset:
    """Stateless batch generator: ``batch(step, shard, nshards)``."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, input_kind: str = "tokens",
                 d_model: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.input_kind = input_kind
        self.d_model = d_model
        # Zipf-ish unigram distribution, fixed per dataset
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int, shard: int = 0,
              nshards: int = 1) -> Dict[str, np.ndarray]:
        if self.global_batch % nshards:
            raise ValueError(f"{nshards} shards do not divide a global "
                             f"batch of {self.global_batch}")
        rows = self.global_batch // nshards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        toks = rng.choice(self.vocab, size=(rows, self.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # short-range structure: with p=0.5 repeat the token 2 back
        rep = rng.random((rows, self.seq_len + 1)) < 0.5
        rep[:, :2] = False
        idx = np.where(rep)
        toks[idx] = toks[idx[0], idx[1] - 2]
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.input_kind == "embeds":
            # frontend stub: deterministic pseudo-embeddings from token ids
            out["embeds"] = rng.standard_normal(
                (rows, self.seq_len, self.d_model)).astype(np.float32)
        return out


def make_batch_iterator(ds: SyntheticLMDataset, start_step: int = 0,
                        shard: int = 0, nshards: int = 1,
                        prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator starting at ``start_step``."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step, shard, nshards), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
