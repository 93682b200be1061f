"""Flash translation layer: L2P mapping, garbage collection, write
amplification (DESIGN.md §2.10).

Every engine in this repo simulates *physical* page ops.  A real drive
inserts a firmware stage between the host and the flash: the FTL keeps
a logical→physical page map, writes out-of-place into an append-only
frontier, and — when the free-block pool runs low — relocates the still
-valid pages of a victim block and erases it.  That relocation traffic
(GC) is what makes a sustained-overwrite ("aged") drive slower than a
fresh one, and the ratio of physical to host page writes is the write
amplification factor (WAF) every overprovisioning decision trades
against.

The port's own copy of the JAX package's host translator (numpy only,
so every output is bit-identical to it given the same PCG64 seeds).
This module is the stage between ``repro_torch.core.workload`` and
``repro_torch.core.sched``:

* :class:`FTLSpec` — geometry (blocks × pages/block), overprovisioning
  ratio, GC victim policy, per-op L2P firmware charge, preconditioning;
* :func:`translate` — deterministically expands a placement-free
  :class:`~repro_torch.core.workload.RequestStream` into the *physical* op
  stream the drive executes: host reads/writes re-classed to their
  map-charged FTL classes, GC relocation ops (victim reads + remap
  writes + a block erase) injected at the triggering host op's arrival
  time, all as ordinary trace ops — so the translated stream lowers
  through the existing scheduler and reaches every engine unchanged,
  and all five heterogeneous engines stay bit-agreeing on it;
* :func:`ftl_op_class_table` — the 7-class timing table the translated
  stream indexes (host read/write, map-charged FTL read/write, GC
  read/write, block erase).  The L2P lookup/update cost is charged as
  *controller* time per op (FMMU, arxiv 1704.03168: map management is
  firmware work that serialises through the controller, not free);
* :func:`analytic_waf` — the steady-state greedy/FIFO write
  amplification fixed point the WAF pin tests check against;
* a victim-policy registry (``GC_POLICIES``) mirroring
  ``workload.build_workload``: ``greedy`` (min valid count — EagleTree's
  ``Garbage_Collector_Greedy``) and ``lru`` (coldest = oldest-opened
  block).

Reliability integration (DESIGN.md §2.8): on the FTL path, program and
erase failures retire *blocks* through the same valid/free accounting —
a failed program wastes its frontier slot, re-programs at the next slot
and marks the block bad (it retires at its next erase instead of
returning to the pool); a failed erase retires the block outright,
shrinking the overprovisioning pool.  The per-op retry/jitter
surcharges still ride ``OpTrace.extra_us`` exactly as before; the
way-level retirement and ad-hoc remap inserts of
``sched.apply_faults`` are superseded here by block-level accounting
(the query layer zeroes ``prog_fail_prob`` / ``erase_fail_prob`` before
sampling surcharges so nothing double-applies).

Everything is host-side NumPy sampled outside the (max,+) folds —
translation is bit-deterministic given ``(stream, spec, fault seed)``,
which is what keeps every engine's answer reproducible.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

from repro_torch.core.interface import make_interface
from repro_torch.core.nand import chip as nand_chip
from repro_torch.core.sim import SSDConfig, controller_arb_us
from repro_torch.core.trace import READ, WRITE, OpClassTable, op_class_table
from repro_torch.core.workload import (RequestStream, request_lpns,
                                       request_ops)

#: Op-class indices of the FTL-extended table (rows 0/1 stay the plain
#: host read/write of ``trace.op_class_table`` so non-FTL traces price
#: identically on either table).
FTL_READ, FTL_WRITE, GC_READ, GC_WRITE, ERASE = 2, 3, 4, 5, 6

FTL_LABELS: tuple[str, ...] = ("read", "write", "ftl_read", "ftl_write",
                               "gc_read", "gc_write", "erase")

#: Registered GC victim-selection policies (see ``select_victim``).
GC_POLICIES: tuple[str, ...] = ("greedy", "lru")


def _greedy_victim(valid_count, candidates, fill_seq):
    """Min valid-count victim (ties: oldest fill, then lowest id)."""
    idx = np.flatnonzero(candidates)
    order = np.lexsort((idx, fill_seq[idx], valid_count[idx]))
    return int(idx[order[0]])


def _lru_victim(valid_count, candidates, fill_seq):
    """Coldest-block victim: the least recently *opened* full block
    (ties: lowest id) — its data has had the longest time to decay."""
    idx = np.flatnonzero(candidates)
    order = np.lexsort((idx, fill_seq[idx]))
    return int(idx[order[0]])


_VICTIM_SELECTORS = {"greedy": _greedy_victim, "lru": _lru_victim}


def select_victim(policy: str, valid_count, candidates, fill_seq) -> int:
    """Pick a GC victim among ``candidates`` (bool [blocks]) under a
    registered policy.  Unknown policies raise a ValueError naming the
    valid kinds (the ``build_workload`` registry contract)."""
    if policy not in _VICTIM_SELECTORS:
        raise ValueError(f"unknown GC policy {policy!r} "
                         f"(one of {', '.join(GC_POLICIES)})")
    return _VICTIM_SELECTORS[policy](np.asarray(valid_count),
                                     np.asarray(candidates),
                                     np.asarray(fill_seq))


@dataclasses.dataclass(frozen=True)
class FTLSpec:
    """One drive's translation-layer design point.

    ``overprovision`` is the spare fraction: physical capacity equals
    ``logical * (1 + overprovision)``, i.e. utilisation
    ``u = 1 / (1 + overprovision)`` — the axis the analytic WAF model
    is parameterised on.  ``map_us`` is the per-op L2P lookup/update
    firmware charge (controller time, FMMU); ``erase_us`` overrides the
    cell type's datasheet block-erase time (None = t_BERS).  With
    ``precondition`` the drive is silently filled and randomly
    overwritten ``precondition_passes`` logical passes before the
    measured stream, so the measured window sits at steady state."""

    blocks: int = 128
    pages_per_block: int = 64
    overprovision: float = 0.25
    gc_policy: str = "greedy"
    gc_free_blocks: int = 2          # GC while free blocks <= this
    map_us: float = 0.5              # L2P firmware charge per op (us)
    erase_us: float | None = None    # None -> cell t_BERS
    precondition: bool = False
    precondition_passes: float = 2.0
    seed: int = 0                    # preconditioning overwrite order

    def __post_init__(self):
        if self.blocks < 4:
            raise ValueError(f"blocks must be >= 4, got {self.blocks}")
        if self.pages_per_block < 1:
            raise ValueError("pages_per_block must be >= 1")
        if self.overprovision <= 0.0:
            raise ValueError(
                f"overprovision must be > 0 (an FTL with zero spare "
                f"capacity cannot collect garbage), got {self.overprovision}")
        if not 1 <= self.gc_free_blocks <= self.blocks // 2:
            raise ValueError(
                f"gc_free_blocks must be in [1, blocks//2], got "
                f"{self.gc_free_blocks}")
        if self.map_us < 0:
            raise ValueError("map_us must be >= 0")
        if self.erase_us is not None and self.erase_us < 0:
            raise ValueError("erase_us must be >= 0")
        if self.precondition_passes < 0:
            raise ValueError("precondition_passes must be >= 0")
        if self.gc_policy not in GC_POLICIES:
            raise ValueError(f"unknown GC policy {self.gc_policy!r} "
                             f"(one of {', '.join(GC_POLICIES)})")
        if self.logical_pages < 1:
            raise ValueError(
                "FTLSpec geometry leaves no logical capacity "
                f"({self.blocks} x {self.pages_per_block} pages at "
                f"overprovision {self.overprovision})")

    @property
    def total_pages(self) -> int:
        return self.blocks * self.pages_per_block

    @property
    def logical_pages(self) -> int:
        return int(self.total_pages / (1.0 + self.overprovision))

    @property
    def utilization(self) -> float:
        """Logical / physical page ratio (the analytic model's ``u``)."""
        return self.logical_pages / self.total_pages

    def describe(self) -> str:
        return (f"{self.blocks}blk x {self.pages_per_block}pg, "
                f"OP {self.overprovision:.2f} (u={self.utilization:.2f}), "
                f"gc={self.gc_policy}")


def analytic_waf(utilization: float) -> float:
    """Steady-state write amplification of greedy GC under uniform
    random overwrites.

    Under a uniform overwrite stream block validity decays monotonically
    with age, so greedy victim selection coincides with FIFO/LRU order
    and the steady-state WAF ``W`` solves the fixed point (Bux & Iliadis
    2010; Desnoyers 2012)::

        W = 1 / (1 - exp(-1 / (u * W)))

    where ``u`` is the logical/physical utilisation.  Finite
    pages-per-block lets measured greedy land a few percent below this
    (it skims slightly emptier-than-FIFO victims); the pin tests allow
    10%.
    """
    u = float(utilization)
    if not 0.0 < u < 1.0:
        raise ValueError(f"utilization must be in (0, 1), got {u}")
    w = 2.0
    for _ in range(500):
        w_next = 1.0 / (1.0 - math.exp(-1.0 / (u * w)))
        if abs(w_next - w) < 1e-12:
            break
        w = w_next
    return w


def ftl_op_class_table(cfg: SSDConfig, spec: FTLSpec) -> OpClassTable:
    """The 7-class timing table FTL-translated streams index.

    Rows 0/1 are exactly ``trace.op_class_table(cfg)`` (host read/write
    — a non-FTL trace prices identically on either table).  The FTL
    rows re-use the host timings with the L2P map charge ``spec.map_us``
    added to the *controller* occupancy (``ctrl_us``, with ``arb_us``
    re-derived): translation serialises through the firmware, it does
    not hold the NAND bus (FMMU).  GC read/write share the FTL timings
    but move no user payload; ERASE holds the bus only for its command
    handshake and then occupies the die for the block-erase time
    (t_BERS), moving zero bytes."""
    base = op_class_table(cfg)
    iface = make_interface(cfg.interface)
    nand = nand_chip(cfg.cell)
    m = float(spec.map_us)
    erase_us = float(spec.erase_us if spec.erase_us is not None
                     else nand.t_bers_us)

    def col(name, extra_rows):
        return np.concatenate(
            [np.asarray(getattr(base, name)),
             np.asarray(extra_rows, np.asarray(getattr(base, name)).dtype)])

    r, w = 0, 1                       # base-row indices
    ctrl = np.asarray(base.ctrl_us, np.float64)
    ftl_ctrl = [ctrl[r] + m, ctrl[w] + m, ctrl[r] + m, ctrl[w] + m, m]
    return OpClassTable(
        cmd_us=col("cmd_us", [base.cmd_us[r], base.cmd_us[w],
                              base.cmd_us[r], base.cmd_us[w],
                              iface.cmd_us]),
        pre_us=col("pre_us", [base.pre_us[r], base.pre_us[w],
                              base.pre_us[r], base.pre_us[w], 0.0]),
        slot_us=col("slot_us", [base.slot_us[r], base.slot_us[w],
                                base.slot_us[r], base.slot_us[w], m]),
        post_lo_us=col("post_lo_us", [base.post_lo_us[r], base.post_lo_us[w],
                                      base.post_lo_us[r], base.post_lo_us[w],
                                      erase_us]),
        post_hi_us=col("post_hi_us", [base.post_hi_us[r], base.post_hi_us[w],
                                      base.post_hi_us[r], base.post_hi_us[w],
                                      erase_us]),
        ctrl_us=col("ctrl_us", ftl_ctrl),
        arb_us=col("arb_us", [controller_arb_us(c, cfg.channels)
                              for c in ftl_ctrl]),
        data_bytes=col("data_bytes", [base.data_bytes[r], base.data_bytes[w],
                                      base.data_bytes[r], base.data_bytes[w],
                                      0]),
        io_us=col("io_us", [base.io_us[r], base.io_us[w],
                            base.io_us[r], base.io_us[w], 0.0]),
        labels=FTL_LABELS,
    )


@dataclasses.dataclass
class FTLStats:
    """Accounting the translation accumulates (DESIGN.md §2.10)."""

    host_pages_written: int = 0
    total_pages_written: int = 0     # host + GC relocation + reprograms
    gc_pages_moved: int = 0
    gc_reads: int = 0
    gc_writes: int = 0
    erases: int = 0
    prog_fails: int = 0
    blocks_retired: int = 0
    free_page_low_watermark: int = 0
    # per-block wear summary (ROADMAP wear leveling): computed from the
    # drive state's erase_count array when translate() returns, so it
    # covers the whole drive lifetime (preconditioning included) even
    # though the counters above reset to the measured window
    max_erase_count: int = 0
    mean_erase_count: float = 0.0

    @property
    def gc_op_count(self) -> int:
        """GC-injected trace ops (victim reads + remap writes + erases)."""
        return self.gc_reads + self.gc_writes + self.erases

    @property
    def waf(self) -> float:
        """Write amplification: physical / host page writes (1.0 when
        the window wrote nothing — a read-only stream amplifies
        nothing)."""
        if self.host_pages_written == 0:
            return 1.0
        return self.total_pages_written / self.host_pages_written


class FTLState:
    """Mutable translation state: the L2P/P2L maps, per-block valid
    counts and the free-block pool.  One instance spans a whole stream
    (and its preconditioning), so chunked translation would see the
    same drive the one-shot call does."""

    def __init__(self, spec: FTLSpec):
        self.spec = spec
        ppb = spec.pages_per_block
        self.l2p = np.full(spec.logical_pages, -1, np.int64)
        self.p2l = np.full(spec.total_pages, -1, np.int64)
        self.valid_count = np.zeros(spec.blocks, np.int64)
        self.full = np.zeros(spec.blocks, bool)
        self.bad = np.zeros(spec.blocks, bool)       # retire at next erase
        self.retired = np.zeros(spec.blocks, bool)   # out of the pool
        self.fill_seq = np.full(spec.blocks, -1, np.int64)
        self.erase_count = np.zeros(spec.blocks, np.int64)
        self._seq = 1
        self.free = collections.deque(range(1, spec.blocks))
        self.open_block = 0
        self.fill_seq[0] = 0
        self.next_page = 0
        self._ppb = ppb
        self.stats = FTLStats(
            free_page_low_watermark=self.free_pages)

    @property
    def free_pages(self) -> int:
        """Unwritten pages: the free pool plus the open block's tail."""
        return len(self.free) * self._ppb + (self._ppb - self.next_page)

    def _advance_frontier(self):
        self.full[self.open_block] = True
        if not self.free:
            raise RuntimeError(
                "FTL out of free blocks mid-allocation — geometry too "
                f"small for GC to keep up ({self.spec.describe()})")
        self.open_block = self.free.popleft()
        self.fill_seq[self.open_block] = self._seq
        self._seq += 1
        self.next_page = 0

    def alloc(self) -> int:
        """Claim the next frontier page; returns its physical number."""
        if self.next_page >= self._ppb:
            self._advance_frontier()
        ppn = self.open_block * self._ppb + self.next_page
        self.next_page += 1
        return ppn

    def map_write(self, lpn: int, ppn: int):
        """Point ``lpn`` at ``ppn``, invalidating any older copy."""
        old = self.l2p[lpn]
        if old >= 0:
            self.p2l[old] = -1
            self.valid_count[old // self._ppb] -= 1
        self.l2p[lpn] = ppn
        self.p2l[ppn] = lpn
        self.valid_count[ppn // self._ppb] += 1

    def gc_candidates(self) -> np.ndarray:
        return self.full & ~self.retired

    def note_watermark(self):
        fp = self.free_pages
        if fp < self.stats.free_page_low_watermark:
            self.stats.free_page_low_watermark = fp


@dataclasses.dataclass(frozen=True)
class FTLTranslation:
    """The physical op stream one host stream translates to.

    ``request_id`` maps each op back to its host request (-1 for GC
    relocation/erase ops); ``gc`` marks exactly those injected ops, so
    dropping them reconstructs the fresh-drive (no-aging) run the
    steady-state bandwidth cliff is measured against.  ``payload``
    carries the host byte credit: GC ops and failed programs move
    flash-internal bytes only."""

    op_cls: np.ndarray        # int32 [T'] indices into ftl_op_class_table
    arrival_us: np.ndarray    # float32 [T'] nondecreasing
    payload: np.ndarray       # bool [T']
    request_id: np.ndarray    # int32 [T'] host request, -1 for GC ops
    gc: np.ndarray            # bool [T'] GC-injected (reloc reads/writes,
                              # erases)
    stats: FTLStats
    state: FTLState           # final drive state (chained aging studies)

    @property
    def n_ops(self) -> int:
        return len(self.op_cls)


class _Emitter:
    """Append-only op-stream builder (list-backed; packs once)."""

    __slots__ = ("cls", "arrival", "payload", "rid", "gc")

    def __init__(self):
        self.cls: list[int] = []
        self.arrival: list[float] = []
        self.payload: list[bool] = []
        self.rid: list[int] = []
        self.gc: list[bool] = []

    def emit(self, cls, arrival, payload, rid, gc):
        self.cls.append(cls)
        self.arrival.append(arrival)
        self.payload.append(payload)
        self.rid.append(rid)
        self.gc.append(gc)


class _NullEmitter(_Emitter):
    """Preconditioning sink: the drive ages, nothing is simulated."""

    def emit(self, cls, arrival, payload, rid, gc):
        pass


def _program(state: FTLState, emitter, lpn: int, arrival: float,
             payload: bool, rid: int, cls: int, gc: bool,
             rng, prog_fail_prob: float):
    """Program one logical page at the write frontier, emitting the op
    (plus re-program attempts on program failure: the failed attempt
    wastes its frontier slot, keeps its bus/cell cost, loses the
    payload credit to the successful re-program, and marks its block
    bad — it retires at its next erase)."""
    for _ in range(64):
        ppn = state.alloc()
        if prog_fail_prob > 0.0 and rng.random() < prog_fail_prob:
            emitter.emit(cls, arrival, False, rid, gc)
            state.stats.total_pages_written += 1
            state.stats.prog_fails += 1
            state.bad[ppn // state._ppb] = True
            if gc:
                state.stats.gc_writes += 1
            continue
        emitter.emit(cls, arrival, payload, rid, gc)
        state.stats.total_pages_written += 1
        if gc:
            state.stats.gc_writes += 1
        state.map_write(lpn, ppn)
        return
    raise RuntimeError("64 consecutive program failures — "
                       "prog_fail_prob is unphysically high")


def _gc_cycle(state: FTLState, emitter, arrival: float,
              rng, prog_fail_prob: float, erase_fail_prob: float):
    """Relocate one victim's valid pages and erase it."""
    spec = state.spec
    candidates = state.gc_candidates()
    if not candidates.any():
        raise RuntimeError(
            "GC triggered with no collectable block "
            f"({spec.describe()}) — grow blocks or gc_free_blocks")
    victim = select_victim(spec.gc_policy, state.valid_count, candidates,
                           state.fill_seq)
    lo = victim * state._ppb
    lpns = state.p2l[lo: lo + state._ppb]
    valid = np.flatnonzero(lpns >= 0)
    if len(valid) >= state._ppb:
        # an age-ordered policy (lru) may reach a still-fully-valid cold
        # block: relocating it is net-zero but legal — the scan advances
        # to a decayed block next cycle.  Only a pool where NO candidate
        # has a single invalid page is a true deadlock.
        cand_idx = np.flatnonzero(candidates)
        if int(state.valid_count[cand_idx].min()) >= state._ppb:
            raise RuntimeError(
                "every collectable block is fully valid — the logical "
                "footprint has consumed the overprovisioning pool "
                f"({spec.describe()}); raise overprovision or shrink "
                "the workload footprint")
    for off in valid:
        lpn = int(lpns[off])
        emitter.emit(GC_READ, arrival, False, -1, True)
        state.stats.gc_reads += 1
        _program(state, emitter, lpn, arrival, False, -1, GC_WRITE, True,
                 rng, prog_fail_prob)
        state.stats.gc_pages_moved += 1
    # relocation emptied the victim (map_write invalidated each old copy)
    state.full[victim] = False
    state.fill_seq[victim] = -1
    emitter.emit(ERASE, arrival, False, -1, True)
    state.stats.erases += 1
    state.erase_count[victim] += 1
    erase_failed = (erase_fail_prob > 0.0
                    and rng.random() < erase_fail_prob)
    if erase_failed or state.bad[victim]:
        state.retired[victim] = True
        state.stats.blocks_retired += 1
    else:
        state.free.append(victim)
    state.note_watermark()


def _run_ops(state: FTLState, emitter, cls, arrival, rid, payload, lpns,
             rng, prog_fail_prob: float, erase_fail_prob: float):
    """Feed expanded host ops through the map, injecting GC on free-pool
    pressure.  GC ops inherit the triggering host op's arrival time, so
    the translated arrivals stay nondecreasing and the stream lowers
    through the unmodified scheduler."""
    spec = state.spec
    for i in range(len(cls)):
        a = float(arrival[i])
        if cls[i] == READ:
            emitter.emit(FTL_READ, a, bool(payload[i]), int(rid[i]), False)
            continue
        state.stats.host_pages_written += 1
        _program(state, emitter, int(lpns[i]), a, bool(payload[i]),
                 int(rid[i]), FTL_WRITE, False, rng, prog_fail_prob)
        guard = 0
        while len(state.free) <= spec.gc_free_blocks:
            _gc_cycle(state, emitter, a, rng, prog_fail_prob,
                      erase_fail_prob)
            guard += 1
            if guard > 4 * spec.blocks:
                raise RuntimeError(
                    "GC cannot reclaim space — overprovisioning too "
                    f"small for the footprint ({spec.describe()})")
        state.note_watermark()


def precondition_lpns(spec: FTLSpec) -> np.ndarray:
    """The preconditioning overwrite order: sequential fill of the whole
    logical space, then ``precondition_passes`` passes of uniform random
    overwrites seeded by ``spec.seed``.  One definition shared by the
    host translator and the torch translation engine
    (``repro_torch.core.ftl_scan``), so both age the same drive."""
    n = spec.logical_pages
    rng = np.random.default_rng(spec.seed)
    fill = np.arange(n, dtype=np.int64)
    over = rng.integers(0, n, int(round(spec.precondition_passes * n)))
    return np.concatenate([fill, over])


def _precondition(state: FTLState, rng_faults, prog_fail_prob: float,
                  erase_fail_prob: float):
    """Silently age the drive to steady state (``precondition_lpns``)
    with GC running.  Stats are reset afterwards, so the measured window
    reports steady-state WAF only."""
    spec = state.spec
    sink = _NullEmitter()
    lpns = precondition_lpns(spec)
    zeros_f = np.zeros(len(lpns), np.float32)
    _run_ops(state, sink, np.full(len(lpns), WRITE, np.int32), zeros_f,
             np.full(len(lpns), -1, np.int32), np.zeros(len(lpns), bool),
             lpns, rng_faults, prog_fail_prob, erase_fail_prob)
    retired = state.stats.blocks_retired
    state.stats = FTLStats(free_page_low_watermark=state.free_pages,
                           blocks_retired=retired)


def translate(stream: RequestStream, spec: FTLSpec, *,
              prog_fail_prob: float = 0.0, erase_fail_prob: float = 0.0,
              fault_seed: int = 0,
              state: FTLState | None = None) -> FTLTranslation:
    """Translate a host request stream into the physical op stream the
    drive executes (module docstring).  ``state`` chains aging across
    calls (None = a fresh drive, optionally preconditioned per the
    spec).  Program/erase failure sampling uses a PCG64 stream keyed
    ``SeedSequence([fault_seed, 2])`` — disjoint from the FaultSampler's
    per-op (``[seed, 0]``) and retirement (``[seed, 1]``) streams, so
    the retry/jitter surcharges the query layer samples afterwards stay
    bit-identical with or without FTL-owned failures."""
    if stream.n_requests == 0:
        raise ValueError("empty workload: no requests to translate")
    if int(np.max(stream.op_cls)) > WRITE:
        raise ValueError(
            "FTL translation consumes host READ/WRITE streams only "
            f"(got op class {int(np.max(stream.op_cls))})")
    rng_faults = np.random.default_rng(
        np.random.PCG64(np.random.SeedSequence([fault_seed, 2])))
    if state is None:
        state = FTLState(spec)
        if spec.precondition:
            _precondition(state, rng_faults, prog_fail_prob,
                          erase_fail_prob)
    cls, arrival, rid, payload = request_ops(stream)
    lpns = request_lpns(stream, spec.logical_pages)
    emitter = _Emitter()
    _run_ops(state, emitter, cls, arrival, rid, payload, lpns,
             rng_faults, prog_fail_prob, erase_fail_prob)
    state.stats.max_erase_count = int(state.erase_count.max())
    state.stats.mean_erase_count = float(state.erase_count.mean())
    return FTLTranslation(
        op_cls=np.asarray(emitter.cls, np.int32),
        arrival_us=np.asarray(emitter.arrival, np.float32),
        payload=np.asarray(emitter.payload, bool),
        request_id=np.asarray(emitter.rid, np.int32),
        gc=np.asarray(emitter.gc, bool),
        stats=state.stats, state=state)


__all__ = [
    "ERASE", "FTLSpec", "FTLState", "FTLStats", "FTLTranslation",
    "FTL_LABELS", "FTL_READ", "FTL_WRITE", "GC_POLICIES", "GC_READ",
    "GC_WRITE", "analytic_waf", "ftl_op_class_table", "precondition_lpns",
    "select_victim", "translate",
]
