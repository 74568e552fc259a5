"""Synthetic token pipeline through the lock-free host queues.

Producer threads synthesize token batches (seeded, reproducible) and
insert them into their private SPSC rings of an :class:`MpscQueue`; the
trainer drains the fan-in.  This is the paper's Figure-1 topology
(client producer endpoints -> server consumer FIFO) with the global lock
deleted — host-side data feeding is a real concurrency domain beside the
step loop (input pipeline vs. dispatch vs. checkpoint writer threads).
The batches are numpy arrays, bit for bit those of the JAX package's
``data/pipeline.py`` (same ``SeedSequence``); the trainer moves them to
the device.

The stream is *deterministic per (seed, producer, sequence-number)*, so a
restart that re-feeds from step N reproduces the exact batches — the data
side of the checkpoint/restart contract.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core import nbb, transport
from repro_torch.core.host_queue import MpscQueue


def synth_batch(seed: int, producer: int, seq_no: int, batch: int,
                seq_len: int, vocab: int,
                extras_shape: Optional[tuple] = None) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch (Zipf-ish token distribution).

    With ``extras_shape``, a standard-normal float32 source of shape
    ``(batch,) + extras_shape`` drawn after the tokens from the same
    stream, stored under ``"extras"`` as the JAX package stores it.
    ``Model.loss`` reads only ``"image_embeds"``/``"frame_embeds"``, so
    in both packages such a batch trains the cross layers without a
    source unless the caller renames the key."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, producer, seq_no]))
    # Zipf over vocab, clipped — cheap stand-in for natural token stats.
    z = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    out = {"tokens": (z % vocab).astype(np.int32)}
    if extras_shape is not None:
        out["extras"] = rng.standard_normal(
            (batch,) + tuple(extras_shape)).astype(np.float32)
    return out


class DataPipeline:
    """N producer threads -> lock-free MPSC ring -> trainer.

    get() returns batches in a deterministic global order is NOT promised
    (MPSC fan-in is round-robin, matching event-message semantics); what
    is promised is every produced batch is consumed exactly once and each
    producer's sub-stream is FIFO (the NBB guarantee).
    """

    def __init__(self, batch: int, seq_len: int, vocab: int,
                 nproducers: int = 2, seed: int = 0, depth: int = 8,
                 extras_shape: Optional[tuple] = None):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self.seed, self.extras_shape = seed, extras_shape
        self._queue = MpscQueue(nproducers, capacity_per_producer=depth)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._produce, args=(i,), daemon=True)
            for i in range(nproducers)
        ]
        for t in self._threads:
            t.start()

    def _produce(self, pid: int) -> None:
        ring = self._queue.producer(pid)
        seq_no = 0
        while not self._stop.is_set():
            item = synth_batch(self.seed, pid, seq_no, self.batch,
                               self.seq_len, self.vocab, self.extras_shape)
            # Table-1 retry protocol via the shared Transport backoff:
            # spin on transient statuses, yield, then exponential sleep.
            transport.send_blocking(ring, item,
                                    should_stop=self._stop.is_set)
            seq_no += 1

    def get(self) -> Dict[str, np.ndarray]:
        status, item = transport.recv_blocking(self._queue)
        assert status == nbb.OK
        return item

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.get()

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
