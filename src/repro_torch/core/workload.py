"""Request-level workloads for the SSD simulator (DESIGN.md §2.6).

The port's own copy of the JAX package's ``repro.core.workload`` (numpy
only): the same builders give the same arrays for the same seeds.

The trace layer (``repro_torch.core.trace``) describes *what the flash
sees*: per-op class/channel/way arrays with the placement already
decided.  This module describes *what the host asks for*: a
:class:`RequestStream` of (arrival time, read/write, size-in-pages,
tenant) tuples with **no placement** — deciding which channel/way serves
each page is the scheduler's job (``repro_torch.core.sched``), either
offline (static policies lower a stream to an ``OpTrace`` that reaches
every engine) or inside the simulation fold (dynamic policies;
``repro_torch.core.sim.dispatch_trace``).

Builders cover the arrival processes queueing behaviour depends on:

* :func:`poisson_stream`   — open-loop Poisson arrivals at an offered load;
* :func:`bursty_stream`    — on/off bursts (checkpoint-like traffic);
* :func:`closed_loop_stream` — a queue-depth-N client that admits request
  i when its model of request i-N completes (fio-style QD sweeps);
* :func:`multi_tenant`     — merge streams into one arrival-ordered
  multi-tenant workload, preserving per-stream ids.

The storage tier's workloads are emitted here too
(``checkpoint_requests`` / ``datapipe_requests`` /
``kvoffload_requests``), and ``build_workload`` is the named registry of
every kind.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.nand import chip as nand_chip
from repro_torch.core.sim import SSDConfig
from repro_torch.core.trace import (OpTrace, READ, WRITE, hot_cold_trace,
                              mixed_trace, steady_trace)


@dataclasses.dataclass(frozen=True)
class RequestStream:
    """Placement-free request workload: arrays [R], arrival-ordered.

    ``payload`` marks requests that deliver user bytes (False = hedged
    duplicates: they occupy resources but the first response wins).
    ``hedge_of`` links each hedged duplicate to its primary request
    (-1 = not a hedge): the static lowering mirrors the primary's
    placement and the query layer resolves first-response-wins latency
    through it (None = no hedges, or legacy adjacent-duplicate streams).
    ``stream`` is the issuing client/tenant id — latency percentiles
    can be split per tenant after simulation.
    ``lpn`` is each request's starting *logical* page number — the
    address the FTL stage translates (slice E of the port); requests
    span ``lpn .. lpn + n_pages - 1``.  None means address-free (the
    FTL synthesises a sequential layout; non-FTL queries never read
    it)."""

    arrival_us: np.ndarray          # float32 [R], non-decreasing
    op_cls: np.ndarray              # int32 [R], READ/WRITE
    n_pages: np.ndarray             # int32 [R], >= 1
    stream: np.ndarray              # int32 [R]
    payload: np.ndarray | None = None   # bool [R]; None = all payload
    hedge_of: np.ndarray | None = None  # int32 [R]; -1 = not a hedge
    lpn: np.ndarray | None = None       # int64 [R]; None = address-free

    def __post_init__(self):
        r = len(self.arrival_us)
        for name in ("op_cls", "n_pages", "stream"):
            if len(getattr(self, name)) != r:
                raise ValueError(f"RequestStream.{name} has length "
                                 f"{len(getattr(self, name))}, "
                                 f"arrival_us has {r}")
        for name in ("payload", "hedge_of", "lpn"):
            arr = getattr(self, name)
            if arr is not None and len(arr) != r:
                raise ValueError(f"RequestStream.{name} length mismatch")
        if r == 0:
            return
        if self.lpn is not None and int(np.min(self.lpn)) < 0:
            raise ValueError("lpn must be non-negative")
        if float(np.min(self.arrival_us)) < 0:
            raise ValueError("arrival_us must be non-negative")
        if np.any(np.diff(np.asarray(self.arrival_us, np.float64)) < 0):
            raise ValueError("arrival_us must be non-decreasing (FCFS "
                             "dispatch order is the array order)")
        if int(np.min(self.n_pages)) < 1:
            raise ValueError("n_pages must be >= 1")
        if int(np.min(self.op_cls)) < 0:
            raise ValueError("op_cls must be non-negative")
        if self.hedge_of is not None:
            h = np.asarray(self.hedge_of, np.int64)
            bad = (h < -1) | (h >= r) | (h == np.arange(r))
            if bad.any():
                raise ValueError(
                    "hedge_of entries must be -1 or another request index")
            linked = h >= 0
            if linked.any():
                n_pages = np.asarray(self.n_pages, np.int64)
                if np.any(n_pages[linked] != n_pages[h[linked]]):
                    raise ValueError(
                        "a hedge duplicate must match its primary's "
                        "n_pages (it mirrors the primary op-for-op)")

    def hedge_mask(self) -> np.ndarray:
        """[R] True where the request is a linked hedge duplicate."""
        if self.hedge_of is None:
            return np.zeros(self.n_requests, bool)
        return np.asarray(self.hedge_of, np.int64) >= 0

    @property
    def n_requests(self) -> int:
        return len(self.arrival_us)

    @property
    def total_pages(self) -> int:
        return int(np.sum(self.n_pages))

    def payload_mask(self) -> np.ndarray:
        if self.payload is None:
            return np.ones(self.n_requests, bool)
        return self.payload.astype(bool)

    def describe(self) -> str:
        arr = np.asarray(self.arrival_us, np.float64)
        span = float(arr[-1]) if self.n_requests else 0.0
        reads = float(np.mean(self.op_cls == READ)) if self.n_requests else 0.0
        return (f"{self.n_requests} reqs / {self.total_pages} pages over "
                f"{span / 1e3:.2f} ms, read_frac={reads:.2f}, "
                f"{len(np.unique(self.stream))} stream(s)")


def _stream(arrival, op_cls, n_pages, stream, payload=None,
            lpn=None) -> RequestStream:
    r = len(arrival)
    return RequestStream(
        arrival_us=np.asarray(arrival, np.float32),
        op_cls=np.asarray(op_cls, np.int32),
        n_pages=(np.full(r, n_pages, np.int32)
                 if np.isscalar(n_pages) else np.asarray(n_pages, np.int32)),
        stream=(np.full(r, stream, np.int32)
                if np.isscalar(stream) else np.asarray(stream, np.int32)),
        payload=None if payload is None else np.asarray(payload, bool),
        lpn=None if lpn is None else np.asarray(lpn, np.int64))


def _classes(n: int, read_fraction: float, rng) -> np.ndarray:
    return np.where(rng.random(n) < read_fraction, READ, WRITE)


# ---------------------------------------------------------------------------
# Arrival-process builders
# ---------------------------------------------------------------------------


def poisson_stream(n_requests: int, mean_interarrival_us: float, *,
                   read_fraction: float = 1.0, pages_per_request: int = 1,
                   seed: int = 0, stream: int = 0) -> RequestStream:
    """Open-loop Poisson arrivals: offered load = pages_per_request /
    mean_interarrival_us pages/us, independent of service progress."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_us, n_requests)
    if n_requests:
        gaps[0] = 0.0                   # the stream starts at t = 0
    return _stream(np.cumsum(gaps), _classes(n_requests, read_fraction, rng),
                   pages_per_request, stream)


def bursty_stream(n_requests: int, burst_len: int, gap_us: float, *,
                  intra_us: float = 0.0, read_fraction: float = 1.0,
                  pages_per_request: int = 1, seed: int = 0,
                  stream: int = 0) -> RequestStream:
    """On/off bursts: ``burst_len`` requests ``intra_us`` apart, then an
    idle ``gap_us`` before the next burst — checkpoint-save-like traffic
    that exercises queue build-up and drain."""
    if burst_len < 1:
        raise ValueError("burst_len must be >= 1")
    i = np.arange(n_requests)
    arrival = (i // burst_len) * (burst_len * intra_us + gap_us) \
        + (i % burst_len) * intra_us
    rng = np.random.default_rng(seed)
    return _stream(arrival, _classes(n_requests, read_fraction, rng),
                   pages_per_request, stream)


def closed_loop_stream(n_requests: int, queue_depth: int, service_us: float,
                       *, read_fraction: float = 1.0,
                       pages_per_request: int = 1, seed: int = 0,
                       stream: int = 0) -> RequestStream:
    """Closed-loop queue-depth-N client (fio-style): request i is
    admitted when the client's single-server model of request i-N
    completes.  ``service_us`` is the client's per-request service
    estimate — the *simulated* device may be faster (queue drains,
    latency ≈ service) or slower (queue builds, latency grows), which
    is exactly the knee a QD sweep looks for."""
    if queue_depth < 1:
        raise ValueError("queue_depth must be >= 1")
    arrival = np.zeros(n_requests, np.float64)
    done = np.zeros(n_requests, np.float64)
    prev_done = 0.0
    for i in range(n_requests):
        arrival[i] = 0.0 if i < queue_depth else done[i - queue_depth]
        prev_done = max(arrival[i], prev_done) + service_us
        done[i] = prev_done
    rng = np.random.default_rng(seed)
    return _stream(arrival, _classes(n_requests, read_fraction, rng),
                   pages_per_request, stream)


def multi_tenant(streams) -> RequestStream:
    """Merge streams into one arrival-ordered workload.  Stream ids are
    re-tagged by position so per-tenant latency splits stay unambiguous
    even when inputs share an id.  Merge is stable: equal arrivals keep
    the input order (earlier stream first).  ``hedge_of`` links are
    remapped through the merge permutation (they never cross streams)."""
    streams = list(streams)
    if not streams:
        raise ValueError("multi_tenant needs at least one stream")
    arrival = np.concatenate([s.arrival_us for s in streams])
    order = np.argsort(arrival, kind="stable")
    cat = lambda xs: np.concatenate(xs)[order]  # noqa: E731
    hedge_of = None
    if any(s.hedge_of is not None for s in streams):
        # local primary index -> global pre-sort index -> post-sort index
        offsets = np.cumsum([0] + [s.n_requests for s in streams])
        h_g = np.concatenate([
            np.where(np.asarray(s.hedge_of, np.int64) >= 0,
                     np.asarray(s.hedge_of, np.int64) + off, -1)
            if s.hedge_of is not None
            else np.full(s.n_requests, -1, np.int64)
            for s, off in zip(streams, offsets)])
        inv = np.empty(len(order), np.int64)
        inv[order] = np.arange(len(order))
        h_s = h_g[order]
        hedge_of = np.where(h_s >= 0, inv[np.clip(h_s, 0, None)],
                            -1).astype(np.int32)
    with_lpn = [s.lpn is not None for s in streams]
    if any(with_lpn) and not all(with_lpn):
        raise ValueError(
            "cannot merge streams with and without logical addresses "
            "(lpn): give every tenant an lpn array or none")
    return RequestStream(
        arrival_us=np.asarray(arrival, np.float32)[order],
        op_cls=cat([s.op_cls for s in streams]),
        n_pages=cat([s.n_pages for s in streams]),
        stream=cat([np.full(s.n_requests, i, np.int32)
                    for i, s in enumerate(streams)]),
        payload=(None if all(s.payload is None for s in streams)
                 else cat([s.payload_mask() for s in streams])),
        hedge_of=hedge_of,
        lpn=None if not all(with_lpn) else cat([s.lpn for s in streams]))


def with_hedges(stream: RequestStream, fraction: float,
                after_us: float = 0.0, seed: int = 0) -> RequestStream:
    """Hedge a fraction of payload reads: each selected request gets a
    non-payload duplicate (``hedge_of`` = its primary) arriving
    ``after_us`` later — the straggler-mitigation knob of DESIGN.md
    §2.8.  First response wins, so the duplicate delivers no new bytes;
    the query layer takes the min over {primary, duplicate} completion.
    ``after_us=0`` inserts each duplicate right after its primary,
    reproducing the legacy adjacent-duplicate layout bit-for-bit."""
    if fraction <= 0.0 or stream.n_requests == 0:
        return stream
    r = stream.n_requests
    rng = np.random.default_rng(seed)
    draw = rng.random(r)
    hedged = ((draw < fraction) & (np.asarray(stream.op_cls) == READ)
              & stream.payload_mask() & ~stream.hedge_mask())
    if not hedged.any():
        return stream
    reps = 1 + hedged.astype(np.int64)
    new_of_old = np.cumsum(reps) - reps             # old idx -> new idx
    r2 = int(reps.sum())
    src = np.repeat(np.arange(r), reps)             # source request/slot
    is_dup = np.zeros(r2, bool)
    is_dup[new_of_old[hedged] + 1] = True
    arrival = np.asarray(stream.arrival_us, np.float64)[src]
    arrival[is_dup] += float(after_us)
    hedge_of = np.where(is_dup, new_of_old[src], -1)
    if stream.hedge_of is not None:                 # carry existing links
        old = np.asarray(stream.hedge_of, np.int64)[src]
        hedge_of = np.where(~is_dup & (old >= 0),
                            new_of_old[np.clip(old, 0, None)], hedge_of)
    payload = np.asarray(stream.payload_mask())[src] & ~is_dup
    # restore arrival order (after_us can push a duplicate past later
    # arrivals); the stable sort keeps a zero-offset duplicate glued
    # right after its primary, and hedge_of rides the permutation
    order = np.argsort(arrival, kind="stable")
    inv = np.empty(r2, np.int64)
    inv[order] = np.arange(r2)
    h_s = hedge_of[order]
    return RequestStream(
        arrival_us=arrival[order].astype(np.float32),
        op_cls=np.asarray(stream.op_cls, np.int32)[src][order],
        n_pages=np.asarray(stream.n_pages, np.int32)[src][order],
        stream=np.asarray(stream.stream, np.int32)[src][order],
        payload=None if payload.all() else payload[order],
        hedge_of=np.where(h_s >= 0, inv[np.clip(h_s, 0, None)],
                          -1).astype(np.int32),
        lpn=(None if stream.lpn is None
             else np.asarray(stream.lpn, np.int64)[src][order]))


def request_ops(stream: RequestStream
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Expand requests to page ops: (cls, arrival_us, request_id,
    payload), each [T = total_pages].  Every page op inherits its
    request's arrival and id — the shared front half of both the static
    lowering and the dynamic dispatch fold."""
    reps = np.asarray(stream.n_pages, np.int64)
    return (np.repeat(np.asarray(stream.op_cls, np.int32), reps),
            np.repeat(np.asarray(stream.arrival_us, np.float32), reps),
            np.repeat(np.arange(stream.n_requests, dtype=np.int32), reps),
            np.repeat(stream.payload_mask(), reps))


def request_lpns(stream: RequestStream, n_logical: int) -> np.ndarray:
    """Per-page-op logical page numbers [T = total_pages], wrapped into
    ``[0, n_logical)`` — the address half of :func:`request_ops`, which
    the FTL stage (slice E of the port) translates through the L2P map.
    Requests span ``lpn .. lpn + n_pages - 1``; address-free streams
    (``lpn is None``) synthesise a sequential layout (op ``t`` touches
    logical page ``t mod n_logical``), so legacy streams age a drive
    like a pure sequential writer."""
    if n_logical < 1:
        raise ValueError(f"n_logical must be >= 1, got {n_logical}")
    reps = np.asarray(stream.n_pages, np.int64)
    t = np.arange(int(reps.sum()), dtype=np.int64)
    if stream.lpn is None:
        return t % n_logical
    starts = np.cumsum(reps) - reps
    pos = t - np.repeat(starts, reps)          # op offset within request
    return (np.repeat(np.asarray(stream.lpn, np.int64), reps)
            + pos) % n_logical


def iter_request_chunks(stream: RequestStream, chunk_requests: int):
    """Slice a request stream into contiguous chunks of at most
    ``chunk_requests`` requests — the feeder for the streaming FTL path
    (``Simulator.run_stream(ftl=...)``), which translates and lowers
    chunk by chunk while carrying drive state.

    Address-free streams (``lpn is None``) synthesise their logical
    layout from the *global* op index inside :func:`request_lpns`, so
    naive slicing would restart every chunk at logical page 0; this
    helper materialises each request's unwrapped starting lpn first
    (``request_lpns`` wraps modulo the footprint later), making the
    chunked translation identical to the one-shot stream for any
    logical size."""
    if chunk_requests < 1:
        raise ValueError(
            f"chunk_requests must be >= 1, got {chunk_requests}")
    if stream.hedge_of is not None:
        raise ValueError(
            "hedged streams cannot be chunked (hedge_of links cross "
            "chunk boundaries) — hedging is one-shot-only")
    if stream.lpn is None and stream.n_requests:
        reps = np.asarray(stream.n_pages, np.int64)
        stream = dataclasses.replace(stream, lpn=np.cumsum(reps) - reps)
    arrays = {f.name: getattr(stream, f.name)
              for f in dataclasses.fields(stream)
              if isinstance(getattr(stream, f.name), np.ndarray)}
    for lo in range(0, stream.n_requests, chunk_requests):
        yield dataclasses.replace(
            stream, **{k: v[lo:lo + chunk_requests]
                       for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# Logically-addressed builders (the FTL aging workload class)
# ---------------------------------------------------------------------------


def _arrivals(n: int, mean_interarrival_us: float, rng) -> np.ndarray:
    """Zero arrivals (a saturating burst) or Poisson at the given mean."""
    if mean_interarrival_us <= 0.0:
        return np.zeros(n)
    gaps = rng.exponential(mean_interarrival_us, n)
    if n:
        gaps[0] = 0.0
    return np.cumsum(gaps)


def overwrite_stream(n_requests: int, footprint_pages: int, *,
                     read_fraction: float = 0.0,
                     mean_interarrival_us: float = 0.0,
                     pages_per_request: int = 1, seed: int = 0,
                     stream: int = 0) -> RequestStream:
    """Uniform-random overwrites of a ``footprint_pages`` logical
    region — the steady-state aging workload the analytic greedy-GC
    WAF model describes (``analytic_waf`` of the FTL stage).  Defaults to
    a pure-write saturating burst; ``mean_interarrival_us`` switches to
    Poisson arrivals and ``read_fraction`` mixes reads over the same
    footprint."""
    if footprint_pages < 1:
        raise ValueError(
            f"footprint_pages must be >= 1, got {footprint_pages}")
    if not 0.0 <= read_fraction <= 1.0:
        raise ValueError(
            f"read_fraction must be in [0, 1], got {read_fraction}")
    rng = np.random.default_rng(seed)
    return _stream(_arrivals(n_requests, mean_interarrival_us, rng),
                   _classes(n_requests, read_fraction, rng),
                   pages_per_request, stream,
                   lpn=rng.integers(0, footprint_pages, n_requests))


def aging_stream(n_requests: int, footprint_pages: int, *,
                 hot_fraction: float = 0.2, hot_traffic: float = 0.8,
                 read_fraction: float = 0.0,
                 mean_interarrival_us: float = 0.0,
                 pages_per_request: int = 1, seed: int = 0,
                 stream: int = 0) -> RequestStream:
    """Skewed (hot/cold) overwrites: a ``hot_fraction`` slice of the
    logical footprint receives ``hot_traffic`` of the requests — the
    locality real aging exhibits.  Cold data pins valid pages inside GC
    victims, so a single-frontier FTL amplifies *more* than under the
    uniform stream at the same overprovisioning (the hot/cold
    separation motivation)."""
    if footprint_pages < 2:
        raise ValueError(
            f"footprint_pages must be >= 2 (a hot and a cold page), "
            f"got {footprint_pages}")
    if not 0.0 < hot_fraction < 1.0:
        raise ValueError(
            f"hot_fraction must be in (0, 1), got {hot_fraction}")
    if not 0.0 <= hot_traffic <= 1.0:
        raise ValueError(
            f"hot_traffic must be in [0, 1], got {hot_traffic}")
    if not 0.0 <= read_fraction <= 1.0:
        raise ValueError(
            f"read_fraction must be in [0, 1], got {read_fraction}")
    rng = np.random.default_rng(seed)
    n_hot = min(footprint_pages - 1,
                max(1, int(round(hot_fraction * footprint_pages))))
    hot = rng.random(n_requests) < hot_traffic
    lpn = np.where(hot, rng.integers(0, n_hot, n_requests),
                   rng.integers(n_hot, footprint_pages, n_requests))
    return _stream(_arrivals(n_requests, mean_interarrival_us, rng),
                   _classes(n_requests, read_fraction, rng),
                   pages_per_request, stream, lpn=lpn)


# ---------------------------------------------------------------------------
# Storage-tier request emitters (stripe-lowered twins of the retired
# trace builders; regression-pinned numerically identical)
# ---------------------------------------------------------------------------


def _pages(nbytes: int, page_bytes: int) -> int:
    return max(1, -(-int(nbytes) // page_bytes))


def _bucket(n: int, max_ops: int) -> int:
    """Round a window length up to a power of two (bounded by max_ops) so
    byte-extrapolated estimates reuse jit cache entries across sizes."""
    return min(max_ops, 1 << (n - 1).bit_length())


def checkpoint_requests(nbytes: int, cfg: SSDConfig,
                        max_ops: int = 4096) -> RequestStream:
    """Checkpoint save: a zero-arrival pure write burst (the writer
    thread queues every chunk at once), one request per page.  Long
    bursts truncate to ``max_ops``; callers extrapolate by bytes."""
    n = _bucket(_pages(nbytes, nand_chip(cfg.cell).page_data_bytes), max_ops)
    return _stream(np.zeros(n), np.full(n, WRITE), 1, 0)


def datapipe_requests(nbytes: int, cfg: SSDConfig,
                      hedge_fraction: float = 0.0, seed: int = 0,
                      max_ops: int = 4096,
                      hedge_after_us: float = 0.0) -> RequestStream:
    """Data-pipeline refill: one read request per page; a
    ``hedge_fraction`` of reads gets a non-payload duplicate
    (straggler hedging — first response wins, so the duplicate delivers
    no new bytes and the static lowering mirrors its primary's
    placement shifted one channel).  ``hedge_after_us`` delays each
    duplicate's arrival past its primary's (0 = fire together, the
    legacy layout bit-for-bit — see ``with_hedges``)."""
    n = _bucket(_pages(nbytes, nand_chip(cfg.cell).page_data_bytes), max_ops)
    base = _stream(np.zeros(n), np.full(n, READ), 1, 0)
    return with_hedges(base, hedge_fraction, after_us=hedge_after_us,
                       seed=seed)


def kvoffload_requests(read_bytes_per_token: int, cfg: SSDConfig,
                       n_tokens: int = 8, append_bytes_per_token: int = 0,
                       max_ops: int = 4096) -> RequestStream:
    """Long-context decode: per token, a cold-KV read burst with the KV
    append writes interleaved evenly (write-back caching overlaps the
    append with the read stream).  Interleaving keeps the read/write
    mix representative when a huge per-token burst is truncated to the
    ``max_ops`` simulation window."""
    page = nand_chip(cfg.cell).page_data_bytes
    reads = _pages(read_bytes_per_token, page)
    writes = (_pages(append_bytes_per_token, page)
              if append_bytes_per_token > 0 else 0)
    # build only the simulated window: a GiB-scale burst is represented
    # by a max_ops-sized pattern with the same read/write mix
    per_tok = reads + writes
    if per_tok > max_ops:
        writes = round(writes * max_ops / per_tok) if writes else 0
        reads = max_ops - writes
    token = np.full(reads, READ, np.int32)
    if writes:
        at = np.linspace(0, reads, writes, endpoint=False).astype(int)
        token = np.insert(token, np.sort(at), WRITE)
    reps = min(n_tokens, -(-max_ops // len(token)))
    cls = np.tile(token, reps)[:max_ops]
    return _stream(np.zeros(cls.size), cls, 1, 0)


# ---------------------------------------------------------------------------
# Named registry (the workload-layer home of trace.workload_trace)
# ---------------------------------------------------------------------------


def _lowered(requests_fn):
    def build(cfg: SSDConfig, *args, **kw) -> OpTrace:
        from repro_torch.core.sched import lower_static
        return lower_static(requests_fn(*args, cfg=cfg, **kw),
                            cfg.channels, cfg.ways).trace
    return build


WORKLOAD_KINDS: tuple[str, ...] = (
    "steady_read", "steady_write", "mixed", "hot_cold",
    "checkpoint", "datapipe", "kvoffload",
    "poisson", "bursty", "closed_loop",
    "overwrite", "aging",
)

_BUILDERS = {
    "steady_read": lambda cfg, n_pages=512: steady_trace(
        n_pages, cfg.channels, cfg.ways, READ),
    "steady_write": lambda cfg, n_pages=512: steady_trace(
        n_pages, cfg.channels, cfg.ways, WRITE),
    "mixed": lambda cfg, n_ops=None, read_fraction=0.7, seed=0: mixed_trace(
        n_ops or 512 * cfg.channels, cfg.channels, cfg.ways,
        read_fraction, seed),
    "hot_cold": lambda cfg, n_ops=None, **kw: hot_cold_trace(
        n_ops or 512 * cfg.channels, cfg.channels, cfg.ways, **kw),
    "checkpoint": _lowered(
        lambda nbytes, cfg, **kw: checkpoint_requests(nbytes, cfg, **kw)),
    "datapipe": _lowered(
        lambda nbytes, cfg, **kw: datapipe_requests(nbytes, cfg, **kw)),
    "kvoffload": _lowered(
        lambda read_bytes_per_token, cfg, **kw: kvoffload_requests(
            read_bytes_per_token, cfg, **kw)),
    "poisson": _lowered(
        lambda cfg, n_requests=512, mean_interarrival_us=50.0, **kw:
        poisson_stream(n_requests, mean_interarrival_us, **kw)),
    "bursty": _lowered(
        lambda cfg, n_requests=512, burst_len=32, gap_us=2000.0, **kw:
        bursty_stream(n_requests, burst_len, gap_us, **kw)),
    "closed_loop": _lowered(
        lambda cfg, n_requests=512, queue_depth=8, service_us=50.0, **kw:
        closed_loop_stream(n_requests, queue_depth, service_us, **kw)),
    "overwrite": _lowered(
        lambda cfg, n_requests=512, footprint_pages=2048, **kw:
        overwrite_stream(n_requests, footprint_pages, **kw)),
    "aging": _lowered(
        lambda cfg, n_requests=512, footprint_pages=2048, **kw:
        aging_stream(n_requests, footprint_pages, **kw)),
}


def build_workload(kind: str, cfg: SSDConfig, **kw) -> OpTrace:
    """Named workload registry (benchmarks / examples / sweeps): the
    op-level kinds build traces directly; the request-level kinds build
    a ``RequestStream`` and lower it with the static stripe scheduler
    (pass the stream to ``Simulator.run(workload=..., sched_policy=...)``
    instead to pick a policy).  Unknown kinds raise a ValueError naming
    the valid kinds; unknown kwargs raise TypeError from the builder."""
    if kind not in _BUILDERS:
        raise ValueError(
            f"unknown workload kind {kind!r} "
            f"(one of {', '.join(WORKLOAD_KINDS)})")
    return _BUILDERS[kind](cfg, **kw)
