"""Wear-dependent reliability model: read-retry, fault injection, hedging.

The port's own copy of the JAX package's ``repro.core.faults`` (numpy
only; DESIGN.md §2.8): the same classes, the same PCG64 streams, the same
draws for the same seeds.  A :class:`FaultSpec` describes a drive's
degradation state — wear level, raw-bit-error-rate (RBER) curve,
read-retry step latencies, program/erase failure probabilities, and an
optional hedged-read mitigation policy.  A :class:`FaultSampler` turns a
spec into concrete per-op effects:

* **read retries** — each read op draws a geometric retry count with
  per-step success probability derived from the wear-scaled RBER,
  paying either the spec's explicit ``retry_step_us`` ladder or, when
  the ladder is ``None``, one full re-read (cmd + pre + slot) of its own
  op class per retry;
* **latency jitter** — a uniform ``[0, jitter_us)`` add-on per op;
* **program faults** — each write fails with ``prog_fail_prob`` and is
  remapped: a duplicate write is inserted right after it targeting the
  next non-retired way on the same channel (the failed op keeps its
  bus/cell cost but loses its payload byte credit to the remap);
* **bad-block retirement** — each (channel, way) is retired up front
  with ``erase_fail_prob`` (at least one way per channel survives);
  retired ways are a dispatch constraint for the dynamic policies.

Everything is sampled **outside** the fold from PCG64 streams keyed on
``spec.seed``, so every engine is bit-deterministic given
``(trace, FaultSpec, seed)``: the sampled effects reduce to a per-op
additive latency vector (``OpTrace.extra_us``) plus a trace rewrite, and
the fold itself stays engine-agnostic.  Chunked consumption (the
streaming engine) draws from the *same* streams: NumPy's PCG64 fills
``random((n, 3))`` row-major, so concatenated per-chunk draws are
bit-identical to one one-shot draw — a single carried sampler makes
chunked == one-shot exactly.

This module imports nothing from ``repro_torch.core.trace`` or
``repro_torch.core.sched`` (both consume it); it works on raw NumPy
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Mirror trace.READ / trace.WRITE without the circular import; pinned
# by a regression test against repro_torch.core.trace.
READ, WRITE = 0, 1

__all__ = ["FaultSpec", "FaultSampler"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Drive degradation + mitigation policy (all effects optional).

    ``wear`` interpolates the RBER geometrically from ``rber_fresh``
    (wear 0) to ``rber_worn`` (wear 1); the per-retry-step failure
    probability is ``min(rber / rber_ecc_limit, 0.95)``.  A spec whose
    every effect is off (``is_zero``) rewrites any trace to itself plus
    an all-zero ``extra_us`` — bit-identical results on every engine.
    """

    wear: float = 0.0
    rber_fresh: float = 1e-8
    rber_worn: float = 1e-4
    rber_ecc_limit: float = 1e-3
    retry_step_us: tuple[float, ...] | None = None
    max_retries: int = 8
    jitter_us: float = 0.0
    prog_fail_prob: float = 0.0
    erase_fail_prob: float = 0.0
    hedge_fraction: float = 0.0
    hedge_after_us: float | None = None
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.wear:
            raise ValueError(f"wear must be >= 0, got {self.wear}")
        for name in ("rber_fresh", "rber_worn", "rber_ecc_limit",
                     "jitter_us", "hedge_fraction"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        for name in ("prog_fail_prob", "erase_fail_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_step_us is not None:
            steps = tuple(float(s) for s in self.retry_step_us)
            if any(s < 0 for s in steps):
                raise ValueError("retry_step_us entries must be >= 0")
            object.__setattr__(self, "retry_step_us", steps)
        if self.hedge_after_us is not None and self.hedge_after_us < 0:
            raise ValueError("hedge_after_us must be >= 0")

    def rber(self) -> float:
        """Raw bit error rate at this wear level (geometric in wear)."""
        if self.rber_fresh <= 0.0:
            return 0.0
        return float(self.rber_fresh
                     * (self.rber_worn / self.rber_fresh) ** self.wear)

    def p_retry_step(self) -> float:
        """Per-retry-step failure probability (capped at 0.95)."""
        return float(np.clip(self.rber() / self.rber_ecc_limit, 0.0, 0.95))

    @property
    def is_zero(self) -> bool:
        """True when the rewrite is guaranteed to be a no-op + zeros."""
        return (self.p_retry_step() == 0.0 and self.jitter_us == 0.0
                and self.prog_fail_prob == 0.0
                and self.erase_fail_prob == 0.0 and self.max_retries >= 0)


def _cumcount(key: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its value group."""
    n = len(key)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    first = np.r_[True, sk[1:] != sk[:-1]]
    grp = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    occ = np.empty(n, np.int64)
    occ[order] = np.arange(n) - grp
    return occ


class FaultSampler:
    """Stateful per-op fault sampler; one instance spans a whole stream.

    Two independent PCG64 streams are derived from ``spec.seed``:
    ``SeedSequence([seed, 0])`` feeds the per-op draws (3 uniforms per
    op: retry, jitter, program-fault) and ``SeedSequence([seed, 1])``
    is consumed once at construction for bad-block retirement — so a
    sampler fed the same ops in any chunking produces bit-identical
    rewrites.  Accumulates ``retry_hist`` / ``n_remap_ops`` across
    chunks.
    """

    def __init__(self, spec: FaultSpec, channels: int, ways: int,
                 table=None) -> None:
        if channels < 1 or ways < 1:
            raise ValueError("channels and ways must be >= 1")
        self.spec = spec
        self.channels = int(channels)
        self.ways = int(ways)
        self._rng = np.random.default_rng(
            np.random.PCG64(np.random.SeedSequence([spec.seed, 0])))
        rng_ret = np.random.default_rng(
            np.random.PCG64(np.random.SeedSequence([spec.seed, 1])))
        retired = rng_ret.random((channels, ways)) < spec.erase_fail_prob
        # every channel keeps at least one live way (a fully-retired
        # channel would make its ops undispatchable)
        retired[retired.all(axis=1), 0] = False
        self.retired = retired
        self._next_way = self._build_next_way(retired)
        if spec.retry_step_us is not None:
            self._cum = np.concatenate(
                [[0.0], np.cumsum(np.asarray(spec.retry_step_us,
                                             np.float64))])
            self._r_cap = min(spec.max_retries, len(spec.retry_step_us))
            self._reread = None
        else:
            if table is None and spec.p_retry_step() > 0.0 \
                    and spec.max_retries > 0:
                raise ValueError(
                    "FaultSpec.retry_step_us is None: pass the OpClassTable "
                    "so retries can charge a per-class re-read")
            self._cum = None
            self._r_cap = spec.max_retries
            self._reread = (None if table is None else np.asarray(
                np.asarray(table.cmd_us, np.float64)
                + np.asarray(table.pre_us, np.float64)
                + np.asarray(table.slot_us, np.float64)))
        self._counts = np.zeros((channels, ways), np.int64)
        self._dirty = False
        self.retry_hist = np.zeros(spec.max_retries + 1, np.int64)
        self.n_remap_ops = 0

    @staticmethod
    def _build_next_way(retired: np.ndarray) -> np.ndarray:
        channels, ways = retired.shape
        nw = np.empty((channels, ways), np.int64)
        for c in range(channels):
            alive = np.flatnonzero(~retired[c])
            for w in range(ways):
                later = alive[alive > w]
                nw[c, w] = later[0] if len(later) else alive[0]
        return nw

    def sample(self, cls: np.ndarray):
        """Draw per-op effects for ``cls`` (consumes 3 uniforms per op).

        Returns ``(extra_us float32, write_fail bool, retries int64)``.
        """
        cls = np.asarray(cls)
        n = len(cls)
        u = self._rng.random((n, 3))
        spec = self.spec
        p = spec.p_retry_step()
        if p > 0.0 and self._r_cap > 0 and n:
            # geometric: P(R >= k) = p^k, truncated at the retry cap;
            # u == 0.0 gives log(0) = -inf -> +inf ratio, caught by the
            # cap before the integer cast
            with np.errstate(divide="ignore"):
                raw = np.floor(np.log(u[:, 0]) / np.log(p))
            r = np.minimum(raw, float(self._r_cap)).astype(np.int64)
        else:
            r = np.zeros(n, np.int64)
        r = np.where(cls == READ, r, 0)
        if self._cum is not None:
            extra = self._cum[r]
        elif self._reread is not None:
            extra = r * self._reread[cls]
        else:                       # table-free: p == 0 so r is all zero
            extra = np.zeros(n)
        if spec.jitter_us > 0.0:
            extra = extra + u[:, 1] * spec.jitter_us
        write_fail = (cls == WRITE) & (u[:, 2] < spec.prog_fail_prob)
        if n:
            self.retry_hist += np.bincount(
                r[cls == READ], minlength=len(self.retry_hist))
        return extra.astype(np.float32), write_fail, r

    def rewrite(self, cls, channel, way, parity, arrival=None, payload=None,
                request_id=None):
        """Sample faults for one chunk of ops and apply the rewrite.

        Inserts a remap write right after each failed write (same
        channel, next non-retired way, zero extra, inheriting the
        payload byte and request id; the failed original keeps its cost
        but drops its payload credit), and recomputes plane parity from
        the first remap onward (per-chip op order shifts there).  All
        arrays are returned rewritten; ``arrival`` / ``payload`` /
        ``request_id`` may be ``None`` and stay ``None``.
        """
        cls = np.asarray(cls, np.int64)
        channel = np.asarray(channel, np.int64)
        way = np.asarray(way, np.int64)
        parity = np.asarray(parity, np.int64)
        extra, write_fail, _ = self.sample(cls)
        fail_idx = np.flatnonzero(write_fail)
        if len(fail_idx):
            ins = fail_idx + 1
            new_of_old = np.arange(len(cls)) + np.searchsorted(
                ins, np.arange(len(cls)), side="right")
            cls2 = np.insert(cls, ins, cls[fail_idx])
            channel2 = np.insert(channel, ins, channel[fail_idx])
            way2 = np.insert(way, ins,
                             self._next_way[channel[fail_idx],
                                            way[fail_idx]])
            parity2 = np.insert(parity, ins, 0)
            extra2 = np.insert(extra.astype(np.float64), ins,
                               0.0).astype(np.float32)
            arrival2 = (None if arrival is None
                        else np.insert(np.asarray(arrival, np.float64), ins,
                                       np.asarray(arrival,
                                                  np.float64)[fail_idx]))
            if payload is None:
                payload2 = None
            else:
                payload2 = np.insert(np.asarray(payload, bool), ins,
                                     np.asarray(payload, bool)[fail_idx])
                payload2[new_of_old[fail_idx]] = False
            request_id2 = (None if request_id is None
                           else np.insert(np.asarray(request_id, np.int64),
                                          ins,
                                          np.asarray(request_id,
                                                     np.int64)[fail_idx]))
            recompute_from = (0 if self._dirty
                              else int(new_of_old[fail_idx[0]]))
            self._dirty = True
            self.n_remap_ops += len(fail_idx)
        else:
            cls2, channel2, way2, parity2, extra2 = (cls, channel, way,
                                                     parity, extra)
            arrival2, payload2, request_id2 = arrival, payload, request_id
            recompute_from = 0 if self._dirty else len(cls2)
        if recompute_from < len(cls2):
            # plane parity = per-chip occurrence count % 2, carried
            # across chunks; untouched before the first remap so a
            # zero-fault spec is bit-identical
            occ = _cumcount(channel2 * self.ways + way2)
            par_new = (self._counts[channel2, way2] + occ) % 2
            mask = np.arange(len(cls2)) >= recompute_from
            parity2 = np.where(mask, par_new, parity2)
        np.add.at(self._counts, (channel2, way2), 1)
        return (cls2, channel2, way2, parity2, arrival2, extra2, payload2,
                request_id2)
