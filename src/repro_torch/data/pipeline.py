"""Deterministic sharded token pipeline + host-side prefetch.

A copy of ``repro/data/pipeline.py`` (numpy only), so that the port imports
nothing of the JAX package; batches are numpy arrays, equal to the
reference's for the same (seed, step, shard).

Design constraints for 1000+-node runs:
  * determinism: batch contents are a pure function of (seed, step, shard) —
    restart/elastic-resize replays identically, no data-loss on failover;
  * host sharding: each host materializes only its slice of the global batch
    (shard = process_index), disjoint by construction;
  * prefetch: a background thread keeps a bounded queue of ready batches so
    host data work overlaps device compute.

Synthetic corpus: a seeded Philox stream over the vocab with a Zipf-ish skew,
plus shifted-label construction.  Swapping in a real tokenized corpus only
requires replacing ``SyntheticTokens._materialize``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


def host_shard_info(global_batch: int, num_hosts: int, host_id: int) -> tuple[int, int]:
    """(local_batch, offset) for this host's slice of the global batch."""
    assert global_batch % num_hosts == 0, (global_batch, num_hosts)
    local = global_batch // num_hosts
    return local, host_id * local


@dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    def batch_at(self, step: int) -> dict:
        """Materialize this host's batch for a given step (pure function)."""
        local, offset = host_shard_info(self.global_batch, self.num_hosts, self.host_id)
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, step, self.host_id])
        )
        # Zipf-ish skew without scipy: mix a geometric head with a uniform tail.
        head = rng.geometric(p=64.0 / self.vocab_size, size=(local, self.seq_len + 1))
        uni = rng.integers(0, self.vocab_size, size=(local, self.seq_len + 1))
        use_head = rng.random((local, self.seq_len + 1)) < 0.5
        toks = np.where(use_head, np.minimum(head, self.vocab_size - 1), uni)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with a bounded queue (double buffering)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surfaced on next __next__
                self._err = e
            finally:
                self._q.put(None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
