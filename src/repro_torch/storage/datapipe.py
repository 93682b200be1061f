"""Training data pipeline with DDR-style double-buffered prefetch.

The port's copy of the JAX package's ``repro.storage.datapipe`` (numpy
on the host; batches leave as CPU ``torch.int32`` tensors whose values
equal the JAX package's numpy batches — moving them to the card is the
consumer's job).  The pipeline mirrors the paper's interface stack one
level up:

* **striping** — the token store is split across ``channels`` backing
  files;
* **way interleaving** — consecutive rows of a batch come from
  consecutive shards, so reads of one batch spread over every file;
* **DDR** — a ``2×ways``-deep prefetch queue feeds the training loop on
  both "edges" (producer and consumer never serialize on one buffer).

Deterministic resume: the cursor (global step) fully determines every
batch (synthetic: counter-keyed Philox; file-backed: affine cursor ->
offsets), so checkpoint manifests only carry ``{"cursor": int}``.
Hedged reads (straggler mitigation): if a chunk read exceeds
``hedge_ms``, the request is re-issued to a replica path and the
replica's response is used.
"""

from __future__ import annotations

import dataclasses
import pathlib
import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.sched import lower_static
from repro_torch.core.sim import MAX_CHANNELS, SSDConfig
from repro_torch.core.trace import OpTrace
from repro_torch.core.workload import RequestStream, datapipe_requests


@dataclasses.dataclass
class PipeState:
    cursor: int


def _pipe_ssd(pipe, ssd: SSDConfig | None) -> SSDConfig:
    # a store may have more shards than the modeled SSD has channels
    return ssd or SSDConfig(channels=min(len(pipe.store.maps), MAX_CHANNELS),
                            ways=pipe.ways)


def pipeline_io_requests(pipe, n_batches: int,
                         ssd: SSDConfig | None = None
                         ) -> RequestStream | None:
    """The request-level workload behind ``n_batches`` of a pipeline's
    reads: one read request per page with the pipe's *observed* hedge
    rate as non-payload duplicate requests.  Synthetic pipelines do no
    I/O and return None."""
    if not isinstance(pipe, FileBackedTokens):
        return None
    ssd = _pipe_ssd(pipe, ssd)
    nbytes = n_batches * pipe.batch * (pipe.seq + 1) * 4   # int32 tokens
    served = max(1, pipe.cursor * pipe.batch)
    hedge = min(1.0, pipe.hedged_reads / served)
    return datapipe_requests(nbytes, ssd, hedge_fraction=hedge)


def pipeline_io_trace(pipe, n_batches: int,
                      ssd: SSDConfig | None = None) -> OpTrace | None:
    """``pipeline_io_requests`` lowered by the static stripe scheduler —
    the placed input for ``repro_torch.storage.ssd_model.estimate_trace``
    and trace-aware geometry planning.  Synthetic pipelines return
    None."""
    requests = pipeline_io_requests(pipe, n_batches, ssd)
    if requests is None:
        return None
    ssd = _pipe_ssd(pipe, ssd)
    return lower_static(requests, ssd.channels, ssd.ways).trace


def _as_batch(toks: np.ndarray) -> dict[str, torch.Tensor]:
    """A [batch, seq + 1] int32 token block as the inputs / labels pair of
    CPU tensors (views of one block, as the numpy slices are)."""
    t = torch.from_numpy(toks)
    return {"inputs": t[:, :-1], "labels": t[:, 1:]}


class SyntheticTokens:
    """Counter-keyed deterministic token stream (CPU-cheap, resumable)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.cursor = 0

    def state(self) -> PipeState:
        return PipeState(self.cursor)

    def restore(self, st: PipeState) -> None:
        self.cursor = st.cursor

    def _batch(self, idx: int) -> dict[str, torch.Tensor]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=[0, 0, 0, idx]))
        return _as_batch(rng.integers(0, self.vocab,
                                      (self.batch, self.seq + 1),
                                      dtype=np.int32))

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        while True:
            b = self._batch(self.cursor)
            self.cursor += 1
            yield b


class StripedTokenStore:
    """File-backed store: tokens striped over ``channels`` .npy shards."""

    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.shards = sorted(self.dir.glob("shard_*.npy"))
        if not self.shards:
            raise FileNotFoundError(f"no shard_*.npy under {directory}")
        self.maps = [np.load(s, mmap_mode="r") for s in self.shards]
        self.tokens_per_shard = len(self.maps[0])

    @classmethod
    def write(cls, directory, tokens: np.ndarray, channels: int = 4):
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        per = len(tokens) // channels
        for c in range(channels):
            np.save(d / f"shard_{c:03d}.npy", tokens[c * per:(c + 1) * per])
        return cls(d)

    def read_chunk(self, shard: int, offset: int, n: int) -> np.ndarray:
        m = self.maps[shard % len(self.maps)]
        offset = offset % max(1, len(m) - n)
        return np.asarray(m[offset:offset + n])


class FileBackedTokens:
    """Batches from a striped store with interleaved, hedged, prefetched
    reads.  ``hedged_reads`` counts the reads re-issued to a replica."""

    def __init__(self, store: StripedTokenStore, batch: int, seq: int, *,
                 ways: int = 4, hedge_ms: float = 50.0):
        self.store, self.batch, self.seq = store, batch, seq
        self.ways, self.hedge_ms = ways, hedge_ms
        self.cursor = 0
        self.hedged_reads = 0
        self._q: queue.Queue = queue.Queue(maxsize=2 * ways)  # DDR: 2 edges
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def state(self) -> PipeState:
        return PipeState(self.cursor)

    def restore(self, st: PipeState) -> None:
        self.cursor = st.cursor

    def _assemble(self, idx: int) -> dict[str, torch.Tensor]:
        n_ch = len(self.store.maps)
        rows = []
        need = self.seq + 1
        for b in range(self.batch):
            g = idx * self.batch + b
            shard = g % n_ch                       # way-interleaved shard order
            off = (g // n_ch) * need
            rows.append(self._hedged_read(shard, off, need))
        return _as_batch(np.stack(rows).astype(np.int32))

    def _hedged_read(self, shard: int, off: int, n: int) -> np.ndarray:
        t0 = time.time()
        out = self.store.read_chunk(shard, off, n)
        if (time.time() - t0) * 1e3 > self.hedge_ms:
            # straggling channel: hedge to the replica (next shard)
            self.hedged_reads += 1
            out = self.store.read_chunk(shard + 1, off, n)
        return out

    def _producer(self):
        idx = self.cursor
        while not self._stop.is_set():
            try:
                self._q.put((idx, self._assemble(idx)), timeout=0.1)
                idx += 1
            except queue.Full:
                continue

    def __iter__(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            idx, batch = self._q.get()
            self.cursor = idx + 1
            yield batch

    def close(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
