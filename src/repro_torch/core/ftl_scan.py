"""Compiled FTL translation: the host translator of
``repro_torch.core.ftl`` re-expressed as a torch state machine on the
session's device (DESIGN.md §2.11; the JAX package's ``lax.scan``
machine, step for step).

``ftl.translate`` walks the host stream with a per-op Python loop over
dicts and deques.  This module runs the *same* translation as a fixed
sequence of tensor operations:

* the L2P/P2L maps, per-block valid counts, fill sequence, erase counts
  and the free-block FIFO (a ring buffer with monotonic head/tail
  cursors) are dense ``int64`` tensors with a leading lane axis ``[B]``,
  updated in place, so one step function serves ``translate_scan``
  (B = 1) and the aged design-space sweep (B = points), where the JAX
  package vmaps;
* each step is either a **host burst** (up to ``pages_per_block`` host
  ops, cut before the first op that would need a block allocation or
  fire the GC trigger — both prefix-closed, so the burst length is one
  masked ``cumsum``), a **single allocating write** (taken when the
  burst would be empty), or a **whole GC cycle** (every valid page of
  the victim relocated by one scatter, then the erase and the trigger
  re-check) — branchless, every path predicated on the lane's mode;
* ``torch`` has no dropping scatter, so ``l2p`` / ``p2l`` carry one
  extra slot at ``total_pages`` and the block arrays one at ``blocks``:
  a masked-out update lands in that bin, which is never read (lanes that
  drop write it with different values, harmlessly).  The real targets of
  one scatter never repeat;
* a step records three numbers a lane — host ops taken, relocations of
  the GC cycle (-1 for none) and the cycle's arrival — from which
  :func:`_rows` rebuilds, after the loop, the JAX machine's
  ``[steps, 2*ppb + 1]`` emission rows (burst ops in lanes
  ``0..ppb-1``, a cycle's read/write pairs at ``(2i, 2i+1)`` and its
  erase at ``2k``), so flattening rows in order recovers the host
  translator's op sequence;
* victim selection is a cascaded masked argmin reproducing the host's
  ``np.lexsort`` tie-break: greedy = (valid count, fill seq, block id),
  lru = (fill seq, block id).

Eager torch checks completion instead of re-running: the loop steps in
chunks of ``_CHUNK`` and reads the lanes' done flags and error bits once
a chunk.  Steps past a lane's end are state no-ops that emit nothing, so
the op sequence is the JAX machine's whatever the chunking.  On the card
a step is some 200 small kernels whose launches cost the host far more
than the device spends in them, so after a short eager warm-up the loop
captures ``_GRAPH`` steps as a CUDA graph over the state tensors and
replays it — the same kernels on the same tensors, so the same bits.

Block-level fault injection (``prog_fail_prob`` / ``erase_fail_prob``)
stays on the host path: its per-attempt RNG draws stay out of the fold,
and ``repro_torch.core.api`` routes those queries to ``ftl.translate``.
Errors are deferred: a lane latches an error bit and freezes, and the
caller raises the host translator's ``RuntimeError`` verbatim.
"""

from __future__ import annotations

import contextlib
import math
import threading
import typing

import numpy as np
import torch

from repro_torch.core.ftl import (ERASE, FTL_READ, FTL_WRITE, FTLSpec,
                                  FTLState, FTLStats, FTLTranslation, GC_READ,
                                  GC_WRITE, analytic_waf, precondition_lpns)
from repro_torch.core.trace import WRITE
from repro_torch.core.workload import (RequestStream, request_lpns,
                                       request_ops)
from repro_torch.device import resolve_device

#: ``mode`` register values (HOST bursts host ops; GC drains one whole
#: relocation cycle per step until the trigger clears).
MODE_HOST, MODE_GC = 0, 1

#: Latched error bits (decoded to the host translator's RuntimeErrors).
ERR_NO_FREE, ERR_GUARD, ERR_NO_CAND, ERR_ALL_VALID = 1, 2, 4, 8

_BIG = 2 ** 30

#: Steps between two reads of the lanes' done flags (one host sync each).
_CHUNK = 256
#: Steps of one captured CUDA graph (replayed _CHUNK // _GRAPH times a
#: chunk): capturing costs the host what eager steps do, so it is short.
_GRAPH = 64
#: Eager steps on the card before the capture (they load every kernel).
_WARM = 32
#: One capture at a time in a process: the blocks of a sharded sweep each
#: capture their own graph from their own thread.
_CAPTURE_LOCK = threading.Lock()

_I64 = torch.int64


class ScanFTLState(typing.NamedTuple):
    """The dense drive state the translation machine carries, every
    field with a leading lane axis ``[B]``.  Integers are ``int64``
    (``gather`` / ``scatter_`` indices), ``arrival`` is ``float32``.
    ``l2p`` / ``p2l`` hold ``total_pages + 1`` slots and the block
    arrays ``blocks + 1``: the last slot is the drop bin of masked
    scatters.  ``l2p`` is padded to ``total_pages`` so overprovisioning
    sweeps at fixed geometry share one shape (entries past
    ``logical_pages`` stay -1 forever)."""

    l2p: torch.Tensor          # [B, total+1] lpn -> ppn, -1 unmapped
    p2l: torch.Tensor          # [B, total+1] ppn -> lpn, -1 invalid
    valid_count: torch.Tensor  # [B, blocks+1]
    full: torch.Tensor         # bool [B, blocks+1]
    fill_seq: torch.Tensor     # [B, blocks+1] open order, -1 = not filled
    erase_count: torch.Tensor  # [B, blocks+1] lifetime erases (wear)
    free_q: torch.Tensor       # [B, blocks+1] FIFO ring of free block ids
    free_head: torch.Tensor    # [B] monotonic pop cursor
    free_tail: torch.Tensor    # [B] monotonic push cursor
    open_block: torch.Tensor   # [B]
    next_page: torch.Tensor    # [B] frontier offset in the open block
    seq: torch.Tensor          # [B] next fill_seq value
    h: torch.Tensor            # [B] host ops consumed *this fold*
    mode: torch.Tensor         # [B] MODE_*
    victim: torch.Tensor       # [B] current GC victim block
    guard: torch.Tensor        # [B] GC cycles since the last host write
    arrival: torch.Tensor      # f32 [B] triggering host arrival
    watermark: torch.Tensor    # [B] free-page low watermark
    host_w: torch.Tensor       # [B] stats: host pages written
    total_w: torch.Tensor      # [B] stats: physical pages written
    gc_pages: torch.Tensor     # [B] stats: pages relocated
    gc_reads: torch.Tensor     # [B] stats: GC reads emitted
    gc_writes: torch.Tensor    # [B] stats: GC writes emitted
    erases: torch.Tensor       # [B] stats: erases emitted
    err: torch.Tensor          # [B] latched ERR_* bits (0 = healthy)


_ARRAYS = ("l2p", "p2l", "valid_count", "full", "fill_seq", "erase_count",
           "free_q")
_REGISTERS = tuple(f for f in ScanFTLState._fields if f not in _ARRAYS)


def _lanes(x, n: int, device) -> torch.Tensor:
    return torch.full((n,), x, dtype=_I64, device=device)


def scan_state_fresh(spec: FTLSpec, n_lanes: int = 1,
                     device=None) -> ScanFTLState:
    """A fresh drive in scan form — field-for-field the state
    ``ftl.FTLState(spec)`` starts from (block 0 open, blocks 1.. free),
    repeated over ``n_lanes`` lanes."""
    dev = resolve_device(device)
    blocks, total = spec.blocks, spec.total_pages
    b = n_lanes

    def arr(n, fill, dtype=_I64):
        return torch.full((b, n), fill, dtype=dtype, device=dev)
    fill_seq = arr(blocks + 1, -1)
    fill_seq[:, 0] = 0
    free_q = arr(blocks + 1, 0)
    free_q[:, : blocks - 1] = torch.arange(1, blocks, device=dev)
    z = _lanes(0, b, dev)
    return ScanFTLState(
        l2p=arr(total + 1, -1), p2l=arr(total + 1, -1),
        valid_count=arr(blocks + 1, 0),
        full=arr(blocks + 1, False, torch.bool), fill_seq=fill_seq,
        erase_count=arr(blocks + 1, 0), free_q=free_q,
        free_head=z, free_tail=_lanes(blocks - 1, b, dev), open_block=z,
        next_page=z, seq=_lanes(1, b, dev), h=z, mode=z, victim=z, guard=z,
        arrival=torch.zeros((b,), dtype=torch.float32, device=dev),
        watermark=_lanes(total, b, dev), host_w=z, total_w=z, gc_pages=z,
        gc_reads=z, gc_writes=z, erases=z, err=z)


def scan_state_from_host(state: FTLState, device=None) -> ScanFTLState:
    """Convert a host ``FTLState`` (chained aging) into scan form (one
    lane on ``device``).  Rejects states carrying block-level fault
    history — the scan path is the fault-free translation engine."""
    if state.bad.any() or state.retired.any():
        raise ValueError(
            "scan translation requires a fault-free drive state "
            "(bad/retired blocks present — use ftl.translate)")
    dev = resolve_device(device)
    spec = state.spec
    blocks, total = spec.blocks, spec.total_pages

    def row(values, n, fill, dtype=_I64):
        out = np.full(n, fill, np.int64 if dtype == _I64 else bool)
        out[: len(values)] = values
        return torch.as_tensor(out[None], device=dev)
    free = np.fromiter(state.free, np.int64, len(state.free))
    st = state.stats

    def one(x):
        return _lanes(int(x), 1, dev)
    return ScanFTLState(
        l2p=row(state.l2p, total + 1, -1), p2l=row(state.p2l, total + 1, -1),
        valid_count=row(state.valid_count, blocks + 1, 0),
        full=row(state.full, blocks + 1, False, torch.bool),
        fill_seq=row(state.fill_seq, blocks + 1, -1),
        erase_count=row(state.erase_count, blocks + 1, 0),
        free_q=row(free, blocks + 1, 0), free_head=one(0),
        free_tail=one(len(free)), open_block=one(state.open_block),
        next_page=one(state.next_page), seq=one(state._seq), h=one(0),
        mode=one(0), victim=one(0), guard=one(0),
        arrival=torch.zeros((1,), dtype=torch.float32, device=dev),
        watermark=one(st.free_page_low_watermark),
        host_w=one(st.host_pages_written),
        total_w=one(st.total_pages_written), gc_pages=one(st.gc_pages_moved),
        gc_reads=one(st.gc_reads), gc_writes=one(st.gc_writes),
        erases=one(st.erases), err=one(0))


def _host_lane(fs: ScanFTLState, lane: int) -> dict:
    """Lane ``lane`` of a scan state as numpy arrays / Python ints."""
    return {k: (v[lane].cpu().numpy() if v.dim() == 2 else v[lane].item())
            for k, v in fs._asdict().items()}


def scan_state_to_host(fs: ScanFTLState, spec: FTLSpec,
                       lane: int = 0) -> FTLState:
    """Materialise lane ``lane`` of a scan state back into the host
    ``FTLState`` form, so chained aging studies and the result plumbing
    are agnostic to which translator ran."""
    x = _host_lane(fs, lane)
    blocks = spec.blocks
    st = FTLState(spec)
    st.l2p = x["l2p"][: spec.logical_pages].astype(np.int64).copy()
    st.p2l = x["p2l"][: spec.total_pages].astype(np.int64).copy()
    st.valid_count = x["valid_count"][:blocks].astype(np.int64).copy()
    st.full = x["full"][:blocks].astype(bool).copy()
    st.fill_seq = x["fill_seq"][:blocks].astype(np.int64).copy()
    st.erase_count = x["erase_count"][:blocks].astype(np.int64).copy()
    head, tail = x["free_head"], x["free_tail"]
    idx = (head + np.arange(tail - head)) % blocks
    st.free.clear()
    st.free.extend(int(b) for b in x["free_q"][idx])
    st.open_block = int(x["open_block"])
    st.next_page = int(x["next_page"])
    st._seq = int(x["seq"])
    st.stats = _stats_from(x, blocks)
    return st


def _stats_from(x: dict, blocks: int) -> FTLStats:
    ec = x["erase_count"][:blocks]
    return FTLStats(
        host_pages_written=int(x["host_w"]),
        total_pages_written=int(x["total_w"]),
        gc_pages_moved=int(x["gc_pages"]), gc_reads=int(x["gc_reads"]),
        gc_writes=int(x["gc_writes"]), erases=int(x["erases"]),
        free_page_low_watermark=int(x["watermark"]),
        max_erase_count=int(ec.max()), mean_erase_count=float(ec.mean()))


def _clone(fs: ScanFTLState) -> ScanFTLState:
    return fs._replace(**{k: getattr(fs, k).clone() for k in _ARRAYS})


class _Machine:
    """The constants and host-op arrays of one run of the translation
    machine over ``B`` lanes, and its step.  Host arrays are ``[n_host]``
    (shared by every lane) or ``[B, n_host]``, padded so that the
    ``ppb``-op window at ``h`` never clamps (``n_host >= n_eff + ppb``);
    ``n_eff`` / ``gc_free`` / ``is_lru`` are scalars or ``[B]``."""

    def __init__(self, blocks: int, ppb: int, n_lanes: int, is_write, arr,
                 lpn, n_eff, gc_free, is_lru, device):
        b = n_lanes
        self.blocks, self.ppb, self.total = blocks, ppb, blocks * ppb

        def lanes_of(x, dtype):
            t = torch.as_tensor(x, device=device).to(dtype)
            return t.reshape(-1, t.shape[-1]).expand(b, -1)

        def per_lane(x, dtype):
            return torch.as_tensor(x, device=device).to(dtype).expand(b)
        self.is_write = lanes_of(is_write, torch.bool)
        self.arr = lanes_of(arr, torch.float32)
        self.lpn = lanes_of(lpn, _I64)
        self.n_host = self.is_write.shape[1]
        self.n_eff = per_lane(n_eff, _I64)
        self.gc_free = per_lane(gc_free, _I64)
        self.is_lru = per_lane(is_lru, torch.bool)[:, None]
        self.lanes = torch.arange(ppb, dtype=_I64, device=device)
        j = self.lanes
        self.after = j[:, None] < j[None, :]      # [i, j]: j after i
        self.before = j[None, :] < j[:, None]     # [i, j]: j before i
        self.neg1 = torch.full((b, ppb), -1, dtype=_I64, device=device)
        self.ones = torch.ones((b, 1), dtype=_I64, device=device)

    def step(self, s: ScanFTLState, rec=None, t: int = 0) -> ScanFTLState:
        """One branchless fused step of every lane (the JAX machine's
        ``step``): both paths (host burst / GC cycle) run as predicated
        tensor math and the block/map arrays are updated in place.
        ``rec`` ([B, T] host-ops / relocations / arrival buffers)
        receives this step's emission record at column ``t``."""
        ppb, blocks, total = self.ppb, self.blocks, self.total
        lanes = self.lanes
        active = (s.err == 0) & ~((s.mode == MODE_HOST)
                                  & (s.h >= self.n_eff))
        gc_mode = s.mode == MODE_GC
        in_host = active & ~gc_mode
        in_gc = active & gc_mode

        # -- host burst: the next ppb-op window, cut at the first op
        # needing a block allocation (cumulative writes exceed the open
        # block's room) or — when the free pool already sits at the
        # trigger — after the first write, whose landing must re-check
        # GC.  Both cuts are prefix-closed, so the burst length is the
        # popcount of one mask
        hc = s.h.clamp(0, self.n_host - ppb)
        widx = hc[:, None] + lanes
        wlpn = torch.gather(self.lpn, 1, widx)
        stream_ok = in_host[:, None] & (widx < self.n_eff[:, None])
        w_lane = stream_ok & torch.gather(self.is_write, 1, widx)
        room = ppb - s.next_page
        w_cum = torch.cumsum(w_lane, 1)
        fits = stream_ok & (w_cum <= room[:, None])
        low = (s.free_tail - s.free_head) <= self.gc_free
        # a lane is at or before the first write iff no write precedes
        # it (the JAX step's ``lanes <= argmax(w_lane)``)
        allow = fits & (~(low & w_lane.any(1))[:, None]
                        | (w_cum == w_lane.to(_I64)))
        k_burst = allow.sum(1)
        b_open = in_host & (k_burst == 0)    # head write needs a block
        ntake = torch.where(in_host, torch.where(b_open, 1, k_burst), 0)
        wtake = (lanes < ntake[:, None]) & w_lane
        w_tk = wtake.sum(1)

        # -- GC cycle: every valid page of the victim relocates in this
        # one step (k <= ppb, so at most one block opens)
        v = s.victim
        vwin = v[:, None] * ppb + lanes
        win = torch.gather(s.p2l, 1, vwin)
        vmask = in_gc[:, None] & (win >= 0)
        k = vmask.sum(1)
        r_idx = torch.cumsum(vmask, 1) - 1
        glpn = win.clamp_min(0)

        # -- allocation (either path pops at most one free block)
        need_g = in_gc & (k > room)
        pop = b_open | need_g
        no_free = pop & (s.free_tail <= s.free_head)
        popped = torch.gather(s.free_q, 1,
                              (s.free_head % blocks)[:, None])[:, 0]
        open2 = torch.where(pop, popped, s.open_block)
        np0 = torch.where(b_open, 0, s.next_page)
        next_page = np0 + w_tk + k - ppb * need_g
        free_head = s.free_head + pop
        free_tail = s.free_tail + in_gc
        seq = s.seq + pop
        # block arrays, in place; the pop target and the erased victim
        # are always distinct blocks (a victim is full — never the open
        # block or a free one)
        vic_at = torch.where(in_gc, v, blocks)[:, None]
        s.full.scatter_(1, torch.where(pop, s.open_block, blocks)[:, None],
                        True)
        s.full.scatter_(1, vic_at, False)
        s.fill_seq.scatter_(1, torch.where(pop, popped, blocks)[:, None],
                            s.seq[:, None])
        s.fill_seq.scatter_(1, vic_at, -1)
        s.erase_count.scatter_add_(1, vic_at, self.ones)
        s.free_q.scatter_(1, torch.where(in_gc, s.free_tail % blocks,
                                         blocks)[:, None], v[:, None])

        # -- burst mapping (`FTLState.map_write`, vectorised): the last
        # write of each lpn owns the final L2P entry; every write
        # invalidates its predecessor — the pre-burst mapping for a first
        # occurrence, the previous duplicate's in-burst page otherwise
        wppn = (open2 * ppb + np0)[:, None] + (w_cum - 1)
        eqm = ((wlpn[:, :, None] == wlpn[:, None, :])
               & wtake[:, :, None] & wtake[:, None, :])
        is_last = wtake & ~(eqm & self.after).any(2)
        prev = torch.where(eqm & self.before, lanes, -1).amax(2)
        old_lane = torch.where(prev < 0, torch.gather(s.l2p, 1, wlpn),
                               torch.gather(wppn, 1, prev.clamp_min(0)))
        has_old = wtake & (old_lane >= 0)
        old_c = old_lane.clamp_min(0)

        # -- cycle mapping: relocations fill the frontier, spilling into
        # the popped block.  Burst and cycle lanes are disjoint, so each
        # map takes one scatter for new entries, and P2L's invalidations
        # (host predecessors / the victim window wipe) a second
        gr_in = r_idx < room[:, None]
        gppn = (torch.where(gr_in, s.open_block[:, None], popped[:, None])
                * ppb + torch.where(gr_in, s.next_page[:, None] + r_idx,
                                    r_idx - room[:, None]))
        s.l2p.scatter_(1, torch.where(vmask, glpn,
                                      torch.where(is_last, wlpn, total)),
                       torch.where(vmask, gppn, wppn))
        s.p2l.scatter_(1, torch.where(vmask, gppn,
                                      torch.where(wtake, wppn, total)),
                       torch.where(vmask, glpn, wlpn))
        s.p2l.scatter_(1, torch.where(in_gc[:, None], vwin,
                                      torch.where(has_old, old_c, total)),
                       -1)
        s.valid_count.scatter_add_(
            1, torch.where(has_old, old_c // ppb, blocks), self.neg1)
        s.valid_count.scatter_add_(
            1, torch.stack([torch.where(in_host, open2, blocks), vic_at[:, 0],
                            torch.where(in_gc, s.open_block, blocks),
                            torch.where(need_g, popped, blocks)], 1),
            torch.stack([w_tk, -k, torch.minimum(k, room), k - room], 1))

        guard = torch.where(w_tk > 0, 0, s.guard + in_gc)
        err = (s.err | no_free * ERR_NO_FREE
               | (in_gc & (guard > 4 * blocks)) * ERR_GUARD)

        # -- GC trigger + victim selection on the post-step arrays
        # (exactly the state the host's `while` loop re-tests).  The
        # cascaded masked argmin reproduces `np.lexsort`: min valid
        # (greedy only), then min fill_seq, then lowest block id
        free_blocks = free_tail - free_head
        trigger = ((w_tk > 0) | in_gc) & (free_blocks <= self.gc_free)
        full = s.full[:, :blocks]
        vc = s.valid_count[:, :blocks]
        fill_seq = s.fill_seq[:, :blocks]
        any_c = full.any(1)
        m_valid = torch.where(full, vc, _BIG).amin(1)
        c2 = full & (self.is_lru | (vc == m_valid[:, None]))
        m_fill = torch.where(c2, fill_seq, _BIG).amin(1)
        # argmax returns the first maximal index (0 when none is set);
        # it takes no bool on the card, hence the integer cast
        new_victim = torch.argmax(
            (c2 & (fill_seq == m_fill[:, None])).to(torch.int32), 1)
        err = (err | (trigger & ~any_c) * ERR_NO_CAND
               | (trigger & any_c & (m_valid >= ppb)) * ERR_ALL_VALID)

        # -- counters + watermark (the host samples it after each write
        # that starts no GC drain, and after each erase)
        lastw = torch.where(wtake, lanes, -1).amax(1)
        arrival = torch.where(
            w_tk > 0,
            torch.gather(self.arr, 1, (hc + lastw.clamp_min(0))[:, None])[:, 0],
            s.arrival)
        free_now = free_blocks * ppb + (ppb - next_page)
        watermark = torch.where(((w_tk > 0) & ~trigger) | in_gc,
                                torch.minimum(s.watermark, free_now),
                                s.watermark)
        if rec is not None:
            rec[0][:, t] = ntake
            rec[1][:, t] = torch.where(in_gc, k, -1)
            rec[2][:, t] = s.arrival
        return s._replace(
            free_head=free_head, free_tail=free_tail, open_block=open2,
            next_page=next_page, seq=seq, h=s.h + ntake,
            mode=torch.where(active, trigger.to(_I64), s.mode),
            victim=torch.where(trigger, new_victim, v), guard=guard,
            arrival=arrival, watermark=watermark, host_w=s.host_w + w_tk,
            total_w=s.total_w + w_tk + k, gc_pages=s.gc_pages + k,
            gc_reads=s.gc_reads + k, gc_writes=s.gc_writes + k,
            erases=s.erases + in_gc, err=err)

    def done(self, s: ScanFTLState) -> torch.Tensor:
        """[B] lanes whose stream is consumed (or that latched an error)."""
        return (((s.h >= self.n_eff) & (s.mode == MODE_HOST))
                | (s.err != 0))


def _records(n_lanes: int, n_steps: int, device):
    return (torch.zeros((n_lanes, n_steps), dtype=_I64, device=device),
            torch.full((n_lanes, n_steps), -1, dtype=_I64, device=device),
            torch.zeros((n_lanes, n_steps), dtype=torch.float32,
                        device=device))


class _GraphChunk:
    """``_GRAPH`` steps of ``m`` captured as one CUDA graph over the state
    ``fs`` (its arrays are updated in place; its registers are copied
    back at the end of the chunk, so replays chain), and over a
    ``[B, _GRAPH]`` record buffer when ``want_rows``.  Captured on a
    stream of the state's card under ``_CAPTURE_LOCK``, in thread-local
    mode: other threads (the other blocks of a sharded sweep) go on
    launching on their own streams meanwhile."""

    def __init__(self, m: _Machine, fs: ScanFTLState, want_rows: bool):
        b = fs.h.shape[0]
        self.state = fs._replace(**{f: getattr(fs, f).clone()
                                    for f in _REGISTERS})
        self.rec = _records(b, _GRAPH, fs.h.device) if want_rows else None
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(fs.h.device),
                capture_error_mode="thread_local"):
            out = self.state
            for i in range(_GRAPH):
                out = m.step(out, self.rec, i)
            for f in _REGISTERS:
                getattr(self.state, f).copy_(getattr(out, f))

    def replay(self) -> ScanFTLState:
        self.graph.replay()
        return self.state


def _drive(m: _Machine, fs: ScanFTLState, t_hint: int, cap: int,
           want_rows: bool = True):
    """Step ``fs`` until every lane has consumed its stream or latched an
    error, reading the lanes' done flags once a chunk: eager chunks of
    ``_CHUNK`` steps on the CPU; on the card ``_WARM`` eager steps, then
    chunks of replays of a captured ``_GRAPH``-step graph.  Returns ``(state,
    records | None, steps run)``; the record buffers start at ``t_hint``
    steps and double when full."""
    b = fs.h.shape[0]
    dev = fs.h.device
    size = max(_CHUNK, -(-t_hint // _CHUNK) * _CHUNK)
    rec = _records(b, size, dev) if want_rows else None
    chunk = None
    t = 0
    while True:
        n = _CHUNK if chunk is not None or dev.type != "cuda" else _WARM
        if rec is not None and t + n > rec[0].shape[1]:
            more = _records(b, rec[0].shape[1], dev)
            rec = tuple(torch.cat([a, x], 1) for a, x in zip(rec, more))
        if chunk is None:
            for i in range(n):
                fs = m.step(fs, rec, t + i)
        else:
            for i in range(0, n, _GRAPH):
                fs = chunk.replay()
                if rec is not None:
                    for a, x in zip(rec, chunk.rec):
                        a[:, t + i:t + i + _GRAPH].copy_(x)
        t += n
        if bool(m.done(fs).all()):
            break
        if t >= cap:     # pragma: no cover - the guard catches first
            raise RuntimeError("FTL scan translation failed to terminate")
        if chunk is None and dev.type == "cuda":
            chunk = _GraphChunk(m, fs, want_rows)
    if rec is not None:
        rec = tuple(x[:, :t] for x in rec)
    return fs, rec, t


def _rows(rec, cls_h, arr_h, pay_h, rid_h, ppb: int):
    """The JAX machine's ``[B, steps, 2*ppb + 1]`` emission rows
    (op_cls, arrival, payload, rid, valid), rebuilt from the step
    records: a host step's lanes ``0..dh-1`` are host ops ``h..h+dh-1``
    re-classed to FTL_READ / FTL_WRITE; a GC step's lanes ``0..2k-1``
    alternate GC_READ / GC_WRITE and lane ``2k`` is the erase, at the
    cycle's arrival; idle lanes are the payload-masked identity (class
    0, arrival 0, request -1)."""
    dh, gk, ga = rec
    b, t = dh.shape
    dev = dh.device
    n_host = cls_h.shape[-1]
    j = torch.arange(2 * ppb + 1, dtype=_I64, device=dev)
    h0 = torch.cumsum(dh, 1) - dh
    host = j < dh[:, :, None]
    src = (h0[:, :, None] + j).clamp(max=n_host - 1).reshape(b, -1)

    def pick(x):
        x = torch.as_tensor(x, device=dev)
        x = x.expand(b, -1) if x.dim() == 1 else x
        return torch.gather(x, 1, src).reshape(b, t, -1)
    h_cls = torch.where(pick(cls_h) == WRITE, FTL_WRITE, FTL_READ)
    gk3 = gk[:, :, None]
    gcv = (gk3 >= 0) & (j <= 2 * gk3)
    g_cls = torch.where(j < 2 * gk3, torch.where(j % 2 == 0, GC_READ,
                                                 GC_WRITE), ERASE)
    op_cls = torch.where(gcv, g_cls, torch.where(host, h_cls, 0))
    arrival = torch.where(gcv, ga[:, :, None],
                          torch.where(host, pick(arr_h), 0.0))
    payload = host & pick(pay_h).to(torch.bool)
    rid = torch.where(host, pick(rid_h), -1)
    return (op_cls.to(torch.int32), arrival.to(torch.float32), payload,
            rid.to(torch.int32), gcv | host)


def _host_arrays(cls, arr, pay, rid, lpns, n_b: int, device):
    """[n_b]-padded device copies of the host-op arrays."""
    pad = n_b - len(cls)

    def put(x, dtype):
        return torch.as_tensor(np.pad(np.asarray(x, dtype), (0, pad)),
                               device=device)
    return (put(cls, np.int32), put(arr, np.float32), put(pay, bool),
            put(rid, np.int32), put(lpns, np.int64))


def make_translate_fold(blocks: int, ppb: int, n_host: int, t_max: int):
    """The translation machine for a static ``(blocks, ppb, n_host,
    t_max)`` shape, as the JAX package builds it::

        fold(cls_h, arr_h, pay_h, rid_h, lpn_h, n_eff, gc_free, is_lru,
             state) -> (state', (op_cls, arrival, payload, rid, valid))

    Host arrays are ``[n_host]`` (shared by the lanes) or ``[B,
    n_host]``, padded so ``n_host >= n_eff + ppb``; ``n_eff`` /
    ``gc_free`` / ``is_lru`` are scalars or ``[B]``, the state's lanes
    set ``B``.  It runs exactly ``t_max`` steps and emits ``[B, t_max,
    2*ppb + 1]`` rows; flattening a lane's rows and keeping ``valid``
    recovers the host op order.  The input state is not modified."""

    def fold(cls_h, arr_h, pay_h, rid_h, lpn_h, n_eff, gc_free, is_lru,
             state):
        dev = state.h.device
        b = state.h.shape[0]
        cls_t = torch.as_tensor(np.asarray(cls_h), device=dev)
        if cls_t.shape[-1] != n_host:
            raise ValueError(f"host arrays hold {cls_t.shape[-1]} ops, the "
                             f"fold was built for {n_host}")
        m = _Machine(blocks, ppb, b, cls_t == WRITE, arr_h, lpn_h, n_eff,
                     gc_free, is_lru, dev)
        fs = _clone(state)._replace(h=torch.zeros_like(state.h))
        rec = _records(b, t_max, dev)
        for t in range(t_max):
            fs = m.step(fs, rec, t)
        return fs, _rows(rec, cls_t, arr_h, pay_h, rid_h, ppb)

    return fold


def _bucket(n: int, floor: int = 64) -> int:
    """Quantise ``n`` up to an eight-steps-per-octave ladder (multiples
    of ``2^(ceil(log2 n) - 3)``, <= ~14% slack) — the JAX package's
    buffer and padding ladder."""
    n = max(n, floor)
    base = 1 << max((n - 1).bit_length() - 3, 0)
    return -(-n // base) * base


def _est_waf(spec: FTLSpec) -> float:
    """Estimated steady-state WAF with a policy safety margin (lru
    decays worse than the greedy fixed point)."""
    return analytic_waf(spec.utilization) * (
        1.15 if spec.gc_policy == "greedy" else 2.5)


def estimate_t_max(spec: FTLSpec, n_reads: int, n_writes: int, *,
                   precondition: bool = False) -> int:
    """Initial record-buffer length in fused *steps* (the JAX package's
    estimate): at steady state every GC cycle costs ~3 steps on a mixed
    stream (the cycle itself, the allocating write that fired it, and
    the burst fragment it cut), the preconditioning stream ~2.  An
    underestimate only grows the buffer."""
    ppb = spec.pages_per_block
    n = n_reads + n_writes
    cycles = math.ceil(n_writes * _est_waf(spec) / ppb)
    rows_per_cycle = 2 if precondition else 3
    return _bucket(-(-n // ppb) + -(-n_writes // ppb)
                   + rows_per_cycle * cycles + spec.blocks // ppb + 32)


def estimate_ops(spec: FTLSpec, n_reads: int, n_writes: int) -> int:
    """Physical op-count estimate for one translated stream (host ops
    plus GC read/write pairs plus erases), unbucketed — the JAX sweep's
    first op-buffer length; the port's sweep knows the exact counts."""
    w = _est_waf(spec)
    ppb = spec.pages_per_block
    gc_pages = math.ceil(n_writes * max(w - 1.0, 0.0))
    erases = math.ceil(n_writes * w / ppb) + spec.blocks
    return n_reads + n_writes + 2 * gc_pages + erases


_ERR_ORDER = (ERR_NO_FREE, ERR_GUARD, ERR_NO_CAND, ERR_ALL_VALID)


def _raise_scan_error(err: int, spec: FTLSpec):
    """Decode a latched error bit to the host translator's message,
    verbatim (the check order mirrors which raise the host loop
    reaches first)."""
    msgs = {
        ERR_NO_FREE: "FTL out of free blocks mid-allocation — geometry "
                     f"too small for GC to keep up ({spec.describe()})",
        ERR_GUARD: "GC cannot reclaim space — overprovisioning too "
                   f"small for the footprint ({spec.describe()})",
        ERR_NO_CAND: "GC triggered with no collectable block "
                     f"({spec.describe()}) — grow blocks or "
                     "gc_free_blocks",
        ERR_ALL_VALID: "every collectable block is fully valid — the "
                       "logical footprint has consumed the "
                       f"overprovisioning pool ({spec.describe()}); "
                       "raise overprovision or shrink the workload "
                       "footprint",
    }
    for bit in _ERR_ORDER:
        if err & bit:
            raise RuntimeError(msgs[bit])
    raise RuntimeError(f"unknown FTL scan error bits {err}")


def _raise_lane_errors(fs: ScanFTLState, specs) -> None:
    """Raise the host message of the first lane that latched an error."""
    err = fs.err.cpu().numpy()
    if err.any():
        i = int(np.flatnonzero(err)[0])
        _raise_scan_error(int(err[i]), specs[i])


def _cap(n: int, blocks: int) -> int:
    """Hard ceiling on steps: the guard bounds GC cycles per host write
    and every step consumes a host op or runs a cycle."""
    return 2 * _bucket(n * (4 * blocks + 2) + 64)


def _run_machine(fs: ScanFTLState, spec: FTLSpec, cls, arr, pay, rid, lpns,
                 t_hint: int, want_rows: bool = True):
    """Run the translation machine (one lane) over one host-op batch
    until the stream is consumed.  Returns ``(final_state, rows)`` with
    ``rows`` the ``[steps, 2*ppb+1]`` emission rows (``_trim`` flattens
    and masks them; None without ``want_rows``)."""
    n = len(cls)
    ppb = spec.pages_per_block
    dev = fs.h.device
    n_b = _bucket(n + ppb)      # window slack: the ppb-op host slice
    cls_p, arr_p, pay_p, rid_p, lpn_p = _host_arrays(cls, arr, pay, rid,
                                                     lpns, n_b, dev)
    m = _Machine(spec.blocks, ppb, 1, cls_p == WRITE, arr_p, lpn_p, n,
                 spec.gc_free_blocks, spec.gc_policy == "lru", dev)
    fs = fs._replace(h=torch.zeros_like(fs.h))
    fs, rec, _ = _drive(m, fs, t_hint, _cap(n, spec.blocks), want_rows)
    _raise_lane_errors(fs, [spec])
    if not want_rows:
        return fs, None
    rows = _rows(rec, cls_p, arr_p, pay_p, rid_p, ppb)
    return fs, tuple(x[0] for x in rows)


def _trim(rows) -> tuple[np.ndarray, ...]:
    op_cls, arrival, payload, rid, valid = (x.cpu().numpy() for x in rows)
    m = valid.reshape(-1)
    cls = op_cls.reshape(-1)[m].astype(np.int32)
    return (cls, arrival.reshape(-1)[m].astype(np.float32),
            payload.reshape(-1)[m].astype(bool),
            rid.reshape(-1)[m].astype(np.int32), cls >= GC_READ)


def _reset_window(fs: ScanFTLState, ppb: int) -> ScanFTLState:
    """Zero the measured-window counters after preconditioning (wear —
    ``erase_count`` — persists), mirroring ``ftl._precondition``; works
    on any number of lanes."""
    free_now = ((fs.free_tail - fs.free_head) * ppb + (ppb - fs.next_page))
    z = torch.zeros_like(fs.host_w)
    return fs._replace(host_w=z, total_w=z, gc_pages=z, gc_reads=z,
                       gc_writes=z, erases=z, watermark=free_now, h=z)


#: Preconditioned drives a cache holds (least recently used first out).
PRE_STATES_MAX = 4


def preconditioned_lanes(specs, device, cache=None,
                         lock=None) -> ScanFTLState:
    """Fresh drives of ``specs`` (one lane each, one geometry), each
    aged by its preconditioning stream (``precondition_lpns``) where the
    spec asks, their window counters reset.  A pure function of the
    specs: with ``cache`` (an ``OrderedDict`` of one device, keyed on
    ``tuple(specs)``, at most ``PRE_STATES_MAX`` batches, least recently
    used first out) the batch ages once and later calls get copies.
    ``lock`` guards the cache where threads share it (the blocks of a
    sharded sweep on one device); the ageing itself runs outside it."""
    specs = list(specs)
    key = tuple(specs)
    guard = lock if lock is not None else contextlib.nullcontext()
    with guard:
        hit = None if cache is None else cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
    if hit is None:
        b = len(specs)
        blocks, ppb = specs[0].blocks, specs[0].pages_per_block
        hit = scan_state_fresh(specs[0], b, device)
        pre = [(precondition_lpns(s) if s.precondition
                else np.zeros(0, np.int64)) for s in specs]
        if any(len(p) for p in pre):
            p_b = _bucket(max(len(p) for p in pre) + ppb, floor=1)
            m = _Machine(blocks, ppb, b, np.ones(p_b, bool),
                         np.zeros(p_b, np.float32),
                         np.stack([np.pad(p, (0, p_b - len(p)))
                                   for p in pre]),
                         [len(p) for p in pre],
                         [s.gc_free_blocks for s in specs],
                         [s.gc_policy == "lru" for s in specs],
                         hit.h.device)
            t_pre = max(estimate_t_max(s, 0, len(p), precondition=True)
                        for s, p in zip(specs, pre) if len(p))
            hit, _, _ = _drive(m, hit, t_pre, _cap(p_b, blocks),
                               want_rows=False)
            _raise_lane_errors(hit, specs)
            hit = _reset_window(hit, ppb)
        if cache is not None:
            with guard:
                cache[key] = hit
                while len(cache) > PRE_STATES_MAX:
                    cache.popitem(last=False)
    return _clone(hit)


def translate_lanes(specs, stream: RequestStream, state: ScanFTLState):
    """Translate one host stream on every lane of ``state`` (lane i under
    ``specs[i]``'s address space, trigger and policy) and compact each
    lane's emission rows into its op sequence.  Returns ``(op_cls
    [B, t2], arrival [B, t2], n_ops [B])`` on the state's device, ``t2``
    the longest lane's op count (shorter lanes padded past ``n_ops``).
    The state is modified in place."""
    specs = list(specs)
    b = len(specs)
    blocks, ppb = specs[0].blocks, specs[0].pages_per_block
    dev = state.h.device
    cls, arr, rid, pay = request_ops(stream)
    n = len(cls)
    n_w = int(np.sum(cls == WRITE))
    n_b = _bucket(n + ppb)      # burst-window slack
    cls_p, arr_p, pay_p, rid_p, _ = _host_arrays(
        cls, arr, pay, rid, np.zeros(n, np.int64), n_b, dev)
    lpn = np.stack([np.pad(request_lpns(stream, s.logical_pages),
                           (0, n_b - n)) for s in specs])
    m = _Machine(blocks, ppb, b, cls_p == WRITE, arr_p, lpn, n,
                 [s.gc_free_blocks for s in specs],
                 [s.gc_policy == "lru" for s in specs], dev)
    t_max = max(estimate_t_max(s, n - n_w, n_w) for s in specs)
    state, rec, _ = _drive(m, state, t_max, _cap(n, blocks))
    _raise_lane_errors(state, specs)
    op_cls, arrival, _, _, valid = (
        x.reshape(b, -1) for x in _rows(rec, cls_p, arr_p, pay_p, rid_p,
                                        ppb))
    # position of the i-th valid lane by binary search on the running
    # popcount (gathers, no scatter)
    cum = torch.cumsum(valid, 1)
    n_ops = cum[:, -1]
    slot1 = torch.arange(1, int(n_ops.max()) + 1, dtype=_I64, device=dev)
    pos = torch.searchsorted(cum, slot1.expand(b, -1).contiguous(),
                             side="left").clamp(max=cum.shape[1] - 1)
    return (torch.gather(op_cls, 1, pos), torch.gather(arrival, 1, pos),
            n_ops)


def translate_scan(stream: RequestStream, spec: FTLSpec, *,
                   state: FTLState | None = None, device=None,
                   pre_states=None) -> FTLTranslation:
    """``ftl.translate`` as the torch machine on ``device`` (the card
    unless the caller asks for the CPU): identical op sequence, stats and
    final drive state for every fault-free translation.  ``state``
    chains aging exactly like the host path, except the input state is
    *not* mutated — use the returned ``FTLTranslation.state``.
    ``pre_states`` (an ``OrderedDict`` the caller owns, of one device)
    memoises the preconditioned drive per spec (see
    ``preconditioned_lanes``).  Block-level fault probabilities are not
    accepted here (RNG stays outside the folds); ``repro_torch.core.api``
    routes faulty translations to the host translator."""
    dev = resolve_device(device)
    if stream.n_requests == 0:
        raise ValueError("empty workload: no requests to translate")
    if int(np.max(stream.op_cls)) > WRITE:
        raise ValueError(
            "FTL translation consumes host READ/WRITE streams only "
            f"(got op class {int(np.max(stream.op_cls))})")
    if state is None:
        fs = preconditioned_lanes([spec], dev, pre_states)
    else:
        fs = scan_state_from_host(state, dev)
    # the machine runs the state's own spec (a chained state owns the
    # drive); the host-facing address space stays the caller's, exactly
    # like the host path's request_lpns call
    mspec = spec if state is None else state.spec
    cls, arrival, rid, payload = request_ops(stream)
    lpns = request_lpns(stream, spec.logical_pages)
    n_writes = int(np.sum(cls == WRITE))
    fs, rows = _run_machine(fs, mspec, cls, arrival, payload, rid, lpns,
                            estimate_t_max(mspec, len(cls) - n_writes,
                                           n_writes))
    op_cls, arr, pay, rid_o, gc = _trim(rows)
    out_state = scan_state_to_host(fs, mspec)
    return FTLTranslation(op_cls=op_cls, arrival_us=arr, payload=pay,
                          request_id=rid_o, gc=gc,
                          stats=out_state.stats, state=out_state)


__all__ = [
    "ERR_ALL_VALID", "ERR_GUARD", "ERR_NO_CAND", "ERR_NO_FREE",
    "MODE_GC", "MODE_HOST",
    "PRE_STATES_MAX", "ScanFTLState", "estimate_ops", "estimate_t_max",
    "make_translate_fold", "preconditioned_lanes",
    "scan_state_fresh", "scan_state_from_host", "scan_state_to_host",
    "translate_lanes", "translate_scan",
]
