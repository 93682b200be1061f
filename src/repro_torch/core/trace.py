"""Heterogeneous op traces for the multi-channel SSD simulator.

Every engine of the port consumes an ``OpTrace``: per-op numpy arrays of
op-class index, channel, way and page parity, plus an ``OpClassTable``
mapping class indices to scalar timing.  Builders cover the paper's
steady streams, mixed read/write ratios and hot/cold skew; the same
arguments and seeds give the same arrays as the JAX package's builders.

``iter_trace_chunks`` and ``mixed_trace_chunks`` yield a trace as
chunks for the streaming engine, the second without materialising it;
both can rewrite each chunk through one carried fault sampler.
``checkpoint_trace``, ``datapipe_trace`` and ``kvoffload_trace`` are the
storage tier's request streams lowered by the static stripe scheduler.

``from_reference_table`` builds an ``OpClassTable`` from plain numpy
columns, which is how a table made elsewhere (for example by the JAX
package, converted to numpy) enters the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.interface import make_interface
from repro_torch.core.nand import chip as nand_chip
from repro_torch.core.sim import (MAX_CHANNELS, MAX_WAYS, SSDConfig,
                                  controller_arb_us, page_op_params)

READ, WRITE = 0, 1


@dataclasses.dataclass(frozen=True)
class OpClassTable:
    """Timing table of the op classes a trace indexes into (arrays [K])."""

    cmd_us: np.ndarray
    pre_us: np.ndarray
    slot_us: np.ndarray
    post_lo_us: np.ndarray
    post_hi_us: np.ndarray
    ctrl_us: np.ndarray       # shared-controller (FTL/firmware) share of slot
    arb_us: np.ndarray        # per-op firmware arbitration charge
    data_bytes: np.ndarray
    io_us: np.ndarray | None = None  # bus data-burst share of slot
                                     # (phase-resolved energy accounting)
    labels: tuple[str, ...] = ()

    @property
    def n_classes(self) -> int:
        return len(self.cmd_us)


@dataclasses.dataclass(frozen=True)
class OpTrace:
    """One op per entry; arrays [T] int32.  ``parity`` is the MLC
    lower/upper page alternation index of the op on its chip.
    ``payload`` marks ops that deliver user bytes — hedged duplicate
    reads occupy the bus/controller but are not counted as payload.
    ``arrival_us`` carries per-op request arrival times (float32 us;
    None = back-to-back): every engine lower-bounds an op's ready time
    by its arrival.  ``extra_us`` carries per-op additive reliability
    latency (float32 us; None = fault-free): every engine extends the
    op's chip occupancy — and hence its completion — by it, never the
    channel bus or the serial controller.

    Construction validates the geometry indices, once, for every
    engine."""

    cls: np.ndarray
    channel: np.ndarray
    way: np.ndarray
    parity: np.ndarray
    channels: int
    ways: int
    payload: np.ndarray | None = None      # bool [T]; None = all payload
    arrival_us: np.ndarray | None = None   # float32 [T]; None = all zero
    extra_us: np.ndarray | None = None     # float32 [T]; None = all zero

    def __post_init__(self):
        n = len(self.cls)
        for name in ("channel", "way", "parity"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"OpTrace.{name} has length "
                                 f"{len(getattr(self, name))}, cls has {n}")
        for name in ("payload", "arrival_us", "extra_us"):
            arr = getattr(self, name)
            if arr is not None and len(arr) != n:
                raise ValueError(f"OpTrace.{name} has length {len(arr)}, "
                                 f"cls has {n}")
        if n == 0:
            return
        for name, arr, bound in (("cls", self.cls, None),
                                 ("channel", self.channel, self.channels),
                                 ("way", self.way, self.ways),
                                 ("parity", self.parity, None)):
            lo, hi = int(np.min(arr)), int(np.max(arr))
            if lo < 0 or (bound is not None and hi >= bound):
                raise ValueError(
                    f"OpTrace.{name} out of range: [{lo}, {hi}] does not "
                    f"fit {name} bounds [0, {bound})" if bound is not None
                    else f"OpTrace.{name} must be non-negative, got {lo}")
        if self.arrival_us is not None and float(np.min(self.arrival_us)) < 0:
            raise ValueError("OpTrace.arrival_us must be non-negative")
        if self.extra_us is not None and float(np.min(self.extra_us)) < 0:
            raise ValueError("OpTrace.extra_us must be non-negative")

    @property
    def n_ops(self) -> int:
        return len(self.cls)

    def payload_mask(self) -> np.ndarray:
        if self.payload is None:
            return np.ones(self.n_ops, bool)
        return self.payload.astype(bool)

    def total_bytes(self, table: OpClassTable) -> int:
        return int(table.data_bytes[self.cls[self.payload_mask()]].sum())

    def read_fraction(self) -> float:
        """Fraction of *payload* ops that are reads — hedged duplicates
        are excluded, matching the byte accounting of ``total_bytes``."""
        mask = self.payload_mask()
        if not mask.any():
            return 0.0
        return float(np.mean(self.cls[mask] == READ))

    def validate_against(self, table: OpClassTable) -> None:
        """Geometry bounds are checked at construction; the op-class
        bound needs the timing table, so query layers call this before
        simulating (an out-of-range class used to gather garbage
        timings silently)."""
        if self.n_ops and int(np.max(self.cls)) >= table.n_classes:
            raise ValueError(
                f"OpTrace.cls out of range: max {int(np.max(self.cls))} "
                f">= table.n_classes {table.n_classes}")

    def describe(self) -> str:
        return (f"{self.n_ops} ops, {self.channels}ch x {self.ways}way, "
                f"read_frac={self.read_fraction():.2f}")


def op_class_table(cfg: SSDConfig) -> OpClassTable:
    """READ/WRITE op classes for one SSD design point."""
    iface = make_interface(cfg.interface)
    nand = nand_chip(cfg.cell)
    ops = [page_op_params(iface, nand, mode, cfg.ways)
           for mode in ("read", "write")]
    return OpClassTable(
        cmd_us=np.array([o.cmd_us for o in ops], np.float32),
        pre_us=np.array([o.pre_us for o in ops], np.float32),
        slot_us=np.array([o.slot_us for o in ops], np.float32),
        post_lo_us=np.array([o.post_lo_us for o in ops], np.float32),
        post_hi_us=np.array([o.post_hi_us for o in ops], np.float32),
        ctrl_us=np.array([o.ctrl_us for o in ops], np.float32),
        arb_us=np.array(
            [controller_arb_us(o.ctrl_us, cfg.channels) for o in ops],
            np.float32),
        data_bytes=np.array([o.data_bytes for o in ops], np.int64),
        io_us=np.array([o.io_us for o in ops], np.float32),
        labels=("read", "write"),
    )


_FLOAT_COLUMNS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
                  "ctrl_us", "arb_us")


def from_reference_table(columns: dict[str, np.ndarray]) -> OpClassTable:
    """``OpClassTable`` from plain numpy columns (for example the fields
    of a table built by the JAX package, converted to numpy): timing
    columns become float32, ``data_bytes`` int64, ``io_us`` stays
    optional and ``labels`` defaults to none."""
    missing = [f for f in _FLOAT_COLUMNS + ("data_bytes",)
               if f not in columns]
    if missing:
        raise ValueError(f"table columns missing: {', '.join(missing)}")
    io = columns.get("io_us")
    return OpClassTable(
        **{f: np.asarray(columns[f], np.float32) for f in _FLOAT_COLUMNS},
        data_bytes=np.asarray(columns["data_bytes"], np.int64),
        io_us=None if io is None else np.asarray(io, np.float32),
        labels=tuple(columns.get("labels", ())))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _finalize(cls, channel, way, channels, ways, payload=None):
    """Derive per-chip page parity: the i-th op on a chip programs the
    lower (even i) or upper (odd i) page of an MLC pair."""
    assert 1 <= channels <= MAX_CHANNELS, \
        f"channels must be in [1, {MAX_CHANNELS}], got {channels}"
    assert 1 <= ways <= MAX_WAYS, \
        f"ways must be in [1, {MAX_WAYS}], got {ways}"
    cls = np.asarray(cls, np.int32)
    channel = np.asarray(channel, np.int32)
    way = np.asarray(way, np.int32)
    parity = np.zeros_like(cls)
    counts = np.zeros((channels, ways), np.int64)
    for t in range(len(cls)):
        c, w = channel[t], way[t]
        parity[t] = counts[c, w] % 2
        counts[c, w] += 1
    return OpTrace(cls=cls, channel=channel, way=way, parity=parity,
                   channels=channels, ways=ways,
                   payload=(None if payload is None
                            else np.asarray(payload, bool)))


def _round_robin(n_ops: int, channels: int, ways: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(channel, way) placement of ``n_ops`` sequential pages: stripe
    round-robin over channels first, then over a channel's ways — the
    single definition every sequential builder (and the Table 3/4
    regression baseline) shares."""
    t = np.arange(n_ops)
    return t % channels, (t // channels) % ways


def steady_trace(n_pages_per_channel: int, channels: int, ways: int,
                 op_cls: int = READ) -> OpTrace:
    """Homogeneous stream, striped round-robin over channels then ways —
    the paper's §5.3 workload; reproduces the retired single-stream
    engines exactly at channels=1."""
    n = n_pages_per_channel * channels
    chan, way = _round_robin(n, channels, ways)
    return _finalize(np.full(n, op_cls), chan, way, channels, ways)


def mixed_trace(n_ops: int, channels: int, ways: int, read_fraction: float,
                seed: int = 0) -> OpTrace:
    """Mixed read/write traffic, channel/way round-robin placement."""
    rng = np.random.default_rng(seed)
    cls = np.where(rng.random(n_ops) < read_fraction, READ, WRITE)
    chan, way = _round_robin(n_ops, channels, ways)
    return _finalize(cls, chan, way, channels, ways)


def _rewrite_chunk(sampler, cls, channel, way, parity, channels, ways,
                   payload, arrival) -> OpTrace:
    """Run one chunk of op arrays through a carried ``FaultSampler`` and
    pack the rewrite into an ``OpTrace`` (chunked == one-shot because the
    sampler draws from one PCG64 stream regardless of chunk boundaries,
    DESIGN.md §2.8)."""
    if payload is None and sampler.spec.prog_fail_prob > 0.0:
        # byte conservation needs an explicit mask once remaps can strip
        # a failed write's credit — mirror sched.apply_faults exactly
        payload = np.ones(len(cls), bool)
    c2, ch2, w2, par2, arr2, ext2, pay2, _ = sampler.rewrite(
        cls, channel, way, parity, arrival=arrival, payload=payload)
    return OpTrace(
        cls=np.asarray(c2, np.int32), channel=np.asarray(ch2, np.int32),
        way=np.asarray(w2, np.int32), parity=np.asarray(par2, np.int32),
        channels=channels, ways=ways, payload=pay2,
        arrival_us=(None if arr2 is None
                    else np.asarray(arr2, np.float32)),
        extra_us=np.asarray(ext2, np.float32))


def iter_trace_chunks(trace: OpTrace, chunk_len: int, *, faults=None,
                      table: OpClassTable | None = None):
    """Yield ``trace`` as consecutive ``OpTrace`` chunks of at most
    ``chunk_len`` ops — the materialised-trace adapter for the
    constant-memory streaming engine.  Chunks carry the same geometry and
    slice ``payload`` / ``arrival_us`` / ``extra_us`` alongside the op
    arrays, so concatenating them reconstructs the trace exactly.

    With ``faults`` (a :class:`repro_torch.core.faults.FaultSpec`), each
    chunk is rewritten through one carried sampler: the concatenated
    chunks are bit-identical to ``repro_torch.core.sched.apply_faults``
    applied to the whole trace (remap inserts may make a chunk longer
    than ``chunk_len``).  ``table`` is required when the spec charges
    retries as per-class re-reads (``retry_step_us=None``)."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    sampler = None
    if faults is not None:
        if trace.extra_us is not None:
            raise ValueError("trace already carries extra_us; refusing to "
                             "re-apply faults")
        from repro_torch.core.faults import FaultSampler
        sampler = FaultSampler(faults, trace.channels, trace.ways,
                               table=table)
    for lo in range(0, trace.n_ops, chunk_len):
        hi = min(lo + chunk_len, trace.n_ops)
        payload = None if trace.payload is None else trace.payload[lo:hi]
        arrival = (None if trace.arrival_us is None
                   else trace.arrival_us[lo:hi])
        if sampler is not None:
            yield _rewrite_chunk(sampler, trace.cls[lo:hi],
                                 trace.channel[lo:hi], trace.way[lo:hi],
                                 trace.parity[lo:hi], trace.channels,
                                 trace.ways, payload, arrival)
            continue
        yield OpTrace(
            cls=trace.cls[lo:hi], channel=trace.channel[lo:hi],
            way=trace.way[lo:hi], parity=trace.parity[lo:hi],
            channels=trace.channels, ways=trace.ways,
            payload=payload, arrival_us=arrival,
            extra_us=(None if trace.extra_us is None
                      else trace.extra_us[lo:hi]))


def mixed_trace_chunks(n_ops: int, channels: int, ways: int,
                       read_fraction: float, *, chunk_len: int = 65536,
                       seed: int = 0, faults=None,
                       table: OpClassTable | None = None):
    """Generator twin of :func:`mixed_trace`: yields the *identical* op
    stream (same rng draws, same round-robin placement, same per-chip
    parity) in ``OpTrace`` chunks without ever materialising the whole
    trace.  The PCG64 stream draws doubles sequentially, so chunked
    ``random`` calls reproduce the single-shot draw; round-robin
    placement revisits a chip every ``channels * ways`` ops, so the
    per-chip parity counter of ``_finalize`` closes to
    ``(t // (channels * ways)) % 2``.

    With ``faults`` attached, every chunk is additionally rewritten
    through one carried :class:`repro_torch.core.faults.FaultSampler` —
    the fault draws come from ``faults.seed``'s own PCG64 streams
    (disjoint from the op-mix stream above), so the concatenated output
    is bit-identical to ``apply_faults(mixed_trace(...), faults,
    table)``."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    rng = np.random.default_rng(seed)
    sampler = None
    if faults is not None:
        from repro_torch.core.faults import FaultSampler
        sampler = FaultSampler(faults, channels, ways, table=table)
    period = channels * ways
    for lo in range(0, n_ops, chunk_len):
        hi = min(lo + chunk_len, n_ops)
        t = np.arange(lo, hi)
        cls = np.where(rng.random(hi - lo) < read_fraction, READ, WRITE)
        chan = (t % channels).astype(np.int32)
        way = ((t // channels) % ways).astype(np.int32)
        par = ((t // period) % 2).astype(np.int32)
        if sampler is not None:
            yield _rewrite_chunk(sampler, cls.astype(np.int32), chan, way,
                                 par, channels, ways, None, None)
            continue
        yield OpTrace(cls=cls.astype(np.int32), channel=chan, way=way,
                      parity=par, channels=channels, ways=ways)


def hot_cold_trace(n_ops: int, channels: int, ways: int,
                   read_fraction: float = 0.7, hot_fraction: float = 0.8,
                   hot_share: float = 0.25, seed: int = 0) -> OpTrace:
    """Skewed placement: ``hot_fraction`` of ops land on the ``hot_share``
    hottest chips (FTL hot/cold separation stress; no round-robin)."""
    rng = np.random.default_rng(seed)
    n_chips = channels * ways
    n_hot = max(1, int(round(hot_share * n_chips)))
    hot = rng.random(n_ops) < hot_fraction
    chip = np.where(hot, rng.integers(0, n_hot, n_ops),
                    rng.integers(0, n_chips, n_ops))
    cls = np.where(rng.random(n_ops) < read_fraction, READ, WRITE)
    return _finalize(cls, chip % channels, (chip // channels) % ways,
                     channels, ways)


def checkpoint_trace(nbytes: int, cfg: SSDConfig,
                     max_ops: int = 4096) -> OpTrace:
    """Checkpoint save: a pure write burst, chunk-striped across channels.
    Long bursts are truncated to ``max_ops``; callers extrapolate by
    bytes (the stream is steady-state).  The request stream of
    ``repro_torch.core.workload.checkpoint_requests`` lowered by the
    static ``stripe`` policy."""
    from repro_torch.core import sched, workload
    return sched.lower_static(
        workload.checkpoint_requests(nbytes, cfg, max_ops=max_ops),
        cfg.channels, cfg.ways).trace


def datapipe_trace(nbytes: int, cfg: SSDConfig, hedge_fraction: float = 0.0,
                   seed: int = 0, max_ops: int = 4096,
                   hedge_after_us: float = 0.0) -> OpTrace:
    """Data-pipeline refill: way-interleaved shard reads; a
    ``hedge_fraction`` of reads is re-issued on the next channel after
    ``hedge_after_us`` (straggler hedging duplicates traffic, it does
    not replace it).  The request stream of
    ``repro_torch.core.workload.datapipe_requests`` lowered by
    ``stripe``."""
    from repro_torch.core import sched, workload
    return sched.lower_static(
        workload.datapipe_requests(nbytes, cfg,
                                   hedge_fraction=hedge_fraction,
                                   seed=seed, max_ops=max_ops,
                                   hedge_after_us=hedge_after_us),
        cfg.channels, cfg.ways).trace


def kvoffload_trace(read_bytes_per_token: int, cfg: SSDConfig,
                    n_tokens: int = 8, append_bytes_per_token: int = 0,
                    max_ops: int = 4096) -> OpTrace:
    """Long-context decode: per token, a cold-KV read burst with the KV
    append writes interleaved evenly (write-back caching overlaps the
    append with the read stream), striped across channels.  The request
    stream of ``repro_torch.core.workload.kvoffload_requests`` lowered by
    ``stripe``."""
    from repro_torch.core import sched, workload
    return sched.lower_static(
        workload.kvoffload_requests(
            read_bytes_per_token, cfg, n_tokens=n_tokens,
            append_bytes_per_token=append_bytes_per_token, max_ops=max_ops),
        cfg.channels, cfg.ways).trace
