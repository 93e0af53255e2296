"""Deterministic data pipeline: per-host sharded synthetic LM token streams
(and vector datasets for the KNN benchmarks), with double-buffered prefetch.

Port of ``src/repro/data/pipeline.py``, which is numpy only: the port keeps
its own copy, so a batch is bit-equal to the reference's for the same
arguments.

  * each host draws only its shard of the global batch (host_id/host_count),
  * the stream is stateless-resumable: batch i is a pure function of
    (seed, step) so restarts after failure reproduce the exact stream,
  * ``Prefetcher`` overlaps host-side batch synthesis with device compute.

Batches are numpy arrays; the trainer moves them to the device through
pinned memory (``repro_torch.launch.train``).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticTokenSource", "Prefetcher", "make_vector_dataset"]


class SyntheticTokenSource:
    """Zipf-ish token stream; batch(step) is deterministic in (seed, step)."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        host_count: int = 1,
        input_mode: str = "tokens",
        d_model: int = 0,
        enc_seq: int = 0,
        mrope: bool = False,
    ):
        if global_batch % host_count:
            raise ValueError(
                f"global_batch {global_batch} not divisible by hosts {host_count}"
            )
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_id = host_id
        self.input_mode = input_mode
        self.d_model = d_model
        self.enc_seq = enc_seq
        self.mrope = mrope

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step])
        )
        b, s = self.local_batch, self.seq_len
        # Zipf-like marginal over the vocab, cheap to draw.
        u = rng.random((b, s + 1))
        tokens = ((self.vocab_size - 1) * u ** 3).astype(np.int32)
        out: Dict[str, np.ndarray] = {"labels": tokens[:, 1:]}
        if self.input_mode == "embeddings":
            out["embeddings"] = rng.standard_normal(
                (b, s, self.d_model), dtype=np.float32
            )
        else:
            out["tokens"] = tokens[:, :-1]
        if self.enc_seq:
            out["tokens"] = tokens[:, :-1]
            out["enc_embeds"] = rng.standard_normal(
                (b, self.enc_seq, self.d_model), dtype=np.float32
            )
        if self.mrope:
            pos = np.arange(s, dtype=np.int32)
            out["mrope_positions"] = np.stack([pos, pos, pos])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering over a batch(step) source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        # Drain so the worker unblocks.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_vector_dataset(
    n: int, d: int, *, seed: int = 0, metric: str = "mips", clusters: int = 64
):
    """Synthetic clustered vector DB (Glove/Sift stand-in for benchmarks)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, clusters, size=n)
    x = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x
