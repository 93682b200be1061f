"""Scheduler / dispatch layer: maps request workloads onto flash
geometry (DESIGN.md §2.6).

The port's own copy of the JAX package's ``repro.core.sched`` (numpy
only): the same lowerings give the same arrays.

* **Static policies** decide placement offline from the op sequence
  alone and lower a :class:`repro_torch.core.workload.RequestStream` to
  an ``OpTrace`` — so they reach *every* engine (scan / cuda / oracle /
  streaming):

  - ``stripe``       — channel-first round-robin (channel = t mod C,
    way advances after a channel sweep), the trace builders'
    ``_round_robin``;
  - ``round_robin``  — way-first round-robin (way = t mod W, channel
    advances after a way sweep): fills one channel's ways before moving
    on, the other canonical firmware loop.

  Hedged duplicate requests (``payload=False``) mirror their primary's
  placement shifted one channel — the datapipe hedging rule.

* **Dynamic policies** cannot be lowered offline — the assignment
  depends on simulated occupancy, so they run as a joint
  dispatch+simulate fold (``repro_torch.core.sim.dispatch_trace``) whose
  carried occupancy row drives the decision:

  - ``least_loaded``   — op goes to the chip whose busy horizon ends
    first (global greedy);
  - ``earliest_ready`` — op goes to the channel whose bus drains first,
    then its least-loaded way.

Engines advertise dynamic support through the ``dispatch`` capability
in the ``repro_torch.core.api`` registry.

The reliability layer (DESIGN.md §2.8) enters here as a trace-rewrite
pass: :func:`apply_faults` samples a
:class:`repro_torch.core.faults.FaultSpec` against a placed ``OpTrace``
— read-retry/jitter surcharges land in ``extra_us`` and program faults
insert remap writes targeting the next non-retired way (bad-block
retirement is also a dispatch constraint for the dynamic policies, which
never place an op on a retired way).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.faults import FaultSampler, FaultSpec
from repro_torch.core.trace import OpTrace, _finalize
from repro_torch.core.workload import RequestStream, request_ops

STATIC_POLICIES: tuple[str, ...] = ("stripe", "round_robin")
DYNAMIC_POLICIES: tuple[str, ...] = ("least_loaded", "earliest_ready")
SCHED_POLICIES: tuple[str, ...] = STATIC_POLICIES + DYNAMIC_POLICIES


def policy_is_dynamic(policy: str) -> bool:
    """Validate a scheduler-policy literal once and return whether it
    needs the in-fold dispatch engine (mirrors
    ``sim.policy_is_batched`` for issue policies)."""
    if policy not in SCHED_POLICIES:
        raise ValueError(
            f"unknown sched policy {policy!r} (static: "
            f"{', '.join(STATIC_POLICIES)}; dynamic: "
            f"{', '.join(DYNAMIC_POLICIES)})")
    return policy in DYNAMIC_POLICIES


@dataclasses.dataclass(frozen=True)
class LoweredWorkload:
    """A request stream lowered onto a geometry: the placed ``OpTrace``
    plus the op→request map latency accounting needs.  ``trace`` keeps
    ``arrival_us=None`` when every arrival is zero, so zero-arrival
    lowerings are field-for-field identical to the retired builders."""

    trace: OpTrace
    request_id: np.ndarray          # int32 [T] op -> request index
    request_arrival_us: np.ndarray  # float32 [R]

    def request_latencies(self, completion_us) -> np.ndarray:
        """[R] request latency: last page-op completion − arrival, for
        *every* request including non-payload hedge duplicates — the
        query layer filters to payload requests before reporting
        percentiles (a duplicate is transport, not a request)."""
        comp = np.asarray(completion_us, np.float64)
        done = np.zeros(len(self.request_arrival_us), np.float64)
        np.maximum.at(done, self.request_id, comp)
        return done - np.asarray(self.request_arrival_us, np.float64)


def lower_static(stream: RequestStream, channels: int, ways: int,
                 policy: str = "stripe") -> LoweredWorkload:
    """Lower a request stream to a placed ``OpTrace`` under a static
    policy (see module docstring).  Placement slots advance over
    *payload* ops only; non-payload (hedged duplicate) ops copy their
    primary's placement shifted one channel."""
    if policy_is_dynamic(policy):
        raise ValueError(
            f"sched policy {policy!r} is dynamic — it cannot be lowered "
            "offline; run it through Simulator.run(workload=...) / "
            "sim.dispatch_trace (engines with the 'dispatch' capability)")
    cls, arrival, req_id, payload = request_ops(stream)
    slots = np.cumsum(payload) - 1                  # payload-op slot index
    if policy == "stripe":
        chan = slots % channels
        way = (slots // channels) % ways
    else:                                           # "round_robin": way-first
        way = slots % ways
        chan = (slots // ways) % channels
    if not payload.all():
        hof = (np.full(stream.n_requests, -1, np.int64)
               if stream.hedge_of is None
               else np.asarray(stream.hedge_of, np.int64))
        h = hof[req_id]                             # primary request per op
        is_h = h >= 0
        # duplicates without an explicit primary link: legacy adjacency
        # rule (their stagnant slot is the preceding payload op's)
        chan = np.where(~payload & ~is_h, (chan + 1) % channels, chan)
        if is_h.any():
            # hedge_of-linked duplicates mirror op j of their primary
            # request shifted one channel AND one way.  The channel
            # shift is the replica-read rule; the way shift keeps the
            # duplicate off the chip the stripe is about to reuse for
            # the *next* payload op — without it every duplicate queues
            # on exactly that chip and (FCFS issue being serial through
            # the controller) convoys the whole stream, inverting the
            # mitigation it exists to provide.
            reps = np.asarray(stream.n_pages, np.int64)
            starts = np.cumsum(reps) - reps         # [R] first-op index
            pos = np.arange(len(cls)) - starts[req_id]
            src = starts[np.clip(h, 0, None)] + pos
            chan = np.where(is_h, (chan[src] + 1) % channels, chan)
            way = np.where(is_h, (way[src] + 1) % ways, way)
    # _finalize owns the MLC per-chip page-parity derivation (the one
    # definition every trace builder shares); arrivals ride on top
    trace = dataclasses.replace(
        _finalize(cls, chan, way, channels, ways,
                  payload=None if payload.all() else payload),
        arrival_us=None if not np.any(arrival) else arrival)
    return LoweredWorkload(
        trace=trace, request_id=req_id,
        request_arrival_us=np.asarray(stream.arrival_us, np.float32))


def lower_ops(cls, arrival_us, channels: int, ways: int,
              policy: str = "stripe", payload=None) -> OpTrace:
    """Lower an already-expanded *op* stream (per-op class/arrival
    arrays) to a placed ``OpTrace`` under a static policy.

    This is the lowering the FTL stage uses (DESIGN.md §2.10): its
    translated stream interleaves host ops with GC relocation ops, and
    every op — payload or not — advances the placement slot, so GC
    traffic competes with host traffic for channels and ways exactly
    like the dynamic dispatch fold makes it compete for occupancy.
    (``lower_static`` differs deliberately: there, non-payload ops are
    hedged *duplicates* that mirror their primary's placement instead
    of consuming a slot.)"""
    if policy_is_dynamic(policy):
        raise ValueError(
            f"sched policy {policy!r} is dynamic — it cannot be lowered "
            "offline; run it through Simulator.run(workload=...) / "
            "sim.dispatch_trace (engines with the 'dispatch' capability)")
    cls = np.asarray(cls, np.int32)
    arrival = np.asarray(arrival_us, np.float32)
    slots = np.arange(len(cls))
    if policy == "stripe":
        chan = slots % channels
        way = (slots // channels) % ways
    else:                                           # "round_robin": way-first
        way = slots % ways
        chan = (slots // ways) % channels
    if payload is not None:
        payload = np.asarray(payload, bool)
        if payload.all():
            payload = None
    return dataclasses.replace(
        _finalize(cls, chan, way, channels, ways, payload=payload),
        arrival_us=None if not np.any(arrival) else arrival)


def apply_faults(trace: OpTrace, spec: FaultSpec, table=None, *,
                 sampler: FaultSampler | None = None,
                 request_id: np.ndarray | None = None
                 ) -> tuple[OpTrace, np.ndarray | None, FaultSampler]:
    """Rewrite a placed ``OpTrace`` under a :class:`FaultSpec`
    (DESIGN.md §2.8): read-retry + jitter surcharges land in
    ``extra_us`` and each program fault inserts a remap write right
    after the failed op, targeting the next non-retired way on the same
    channel (the failed original keeps its bus/cell cost but loses its
    payload byte credit to the remap, so byte totals are conserved).

    Returns ``(trace2, request_id2, sampler)`` — ``request_id2`` is the
    op→request map with remap ops inheriting their request (None in,
    None out), and the returned sampler carries the accumulated
    ``retry_hist`` / ``n_remap_ops`` / ``retired`` state (pass it back
    in for chunked streams so every chunk draws from the same PCG64
    position).  ``table`` (the OpClassTable) is required only when
    ``spec.retry_step_us`` is None, to price a retry as one re-read of
    its own op class."""
    if trace.extra_us is not None:
        raise ValueError(
            "trace already carries extra_us — faults were already applied "
            "(apply_faults must run once per stream)")
    if sampler is None:
        sampler = FaultSampler(spec, trace.channels, trace.ways, table)
    payload = trace.payload
    if payload is None and spec.prog_fail_prob > 0.0:
        # byte conservation needs an explicit mask once remaps can strip
        # a failed write's credit (None means "all payload")
        payload = np.ones(trace.n_ops, bool)
    cls2, ch2, w2, par2, arr2, ext2, pay2, rid2 = sampler.rewrite(
        np.asarray(trace.cls), np.asarray(trace.channel),
        np.asarray(trace.way), np.asarray(trace.parity),
        arrival=trace.arrival_us, payload=payload, request_id=request_id)
    trace2 = OpTrace(
        cls=cls2.astype(np.int32), channel=ch2.astype(np.int32),
        way=w2.astype(np.int32), parity=par2.astype(np.int32),
        channels=trace.channels, ways=trace.ways,
        payload=(None if pay2 is None or pay2.all()
                 else np.asarray(pay2, bool)),
        arrival_us=(None if arr2 is None
                    else np.asarray(arr2, np.float32)),
        extra_us=np.asarray(ext2, np.float32))
    return trace2, rid2, sampler


def lower_ops_chunk(cls, arrival_us, channels: int, ways: int,
                    policy: str = "stripe", payload=None,
                    slot_offset: int = 0) -> tuple[OpTrace, int]:
    """Chunked form of :func:`lower_ops`: lower one slice of an op
    stream whose earlier ops already consumed ``slot_offset`` placement
    slots, so concatenating the per-chunk traces is field-for-field
    identical to lowering the whole stream at once.

    Placement at a nonzero offset needs the page parity in closed form
    (``_finalize`` counts per-chip ops from zero): under both static
    policies every op advances the slot, each chip sees every
    ``channels * ways``-th slot, so op ``s``'s per-chip ordinal is
    ``s // (channels * ways)`` and its MLC parity is that ordinal mod 2
    — regression-pinned against ``_finalize`` in the sched tests.

    Returns ``(trace, next_offset)``; feed ``next_offset`` to the next
    chunk.  This is what lets the FTL translation stream through
    ``trace_chunk_fold`` (DESIGN.md §2.11) without materialising the
    full aged op trace."""
    if policy_is_dynamic(policy):
        raise ValueError(
            f"sched policy {policy!r} is dynamic — it cannot be lowered "
            "offline; run it through Simulator.run(workload=...) / "
            "sim.dispatch_trace (engines with the 'dispatch' capability)")
    cls = np.asarray(cls, np.int32)
    arrival = np.asarray(arrival_us, np.float32)
    slots = slot_offset + np.arange(len(cls))
    if policy == "stripe":
        chan = slots % channels
        way = (slots // channels) % ways
    else:                                           # "round_robin": way-first
        way = slots % ways
        chan = (slots // ways) % channels
    parity = (slots // (channels * ways)) % 2
    if payload is not None:
        payload = np.asarray(payload, bool)
        if payload.all():
            payload = None
    trace = OpTrace(
        cls=cls, channel=chan.astype(np.int32), way=way.astype(np.int32),
        parity=parity.astype(np.int32), channels=channels, ways=ways,
        payload=payload,
        arrival_us=None if not np.any(arrival) else arrival)
    return trace, slot_offset + len(cls)
