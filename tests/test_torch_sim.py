"""The port's scan engine and numpy oracles against the JAX package.

The scan engine is held within 1e-6 relative of JAX's ``lax.scan`` fold
(the two run the same float32 operations in the same order; only XLA's
FMA contraction could tell them apart) over channels 1-4 x ways 1-16 x
both policies x arrivals/extras on and off.  The oracles are the same
numpy code and must be bit-equal."""

import numpy as np
import pytest
import torch

from repro.core import sim as j_sim
from repro.core import sim_ref as j_ref
from repro.core import trace as j_trace
from repro.core.energy import op_phase_energy_uj as j_energy
from repro_torch.core import sim, sim_ref, trace
from repro_torch.core.energy import op_phase_energy_uj

REL = 1e-6
FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
          "ctrl_us", "arb_us")


def pair(channels, ways, side, seed=0, n_ops=160, cell="mlc"):
    cfg = dict(interface="proposed", cell=cell, channels=channels, ways=ways)
    table = trace.op_class_table(sim.SSDConfig(**cfg))
    jtable = j_trace.op_class_table(j_sim.SSDConfig(**cfg))
    t = trace.mixed_trace(n_ops, channels, ways, 0.5, seed=seed)
    arr = ext = None
    if side:
        rng = np.random.default_rng(seed + 100)
        arr = np.cumsum(rng.exponential(12.0, n_ops)).astype(np.float32)
        ext = np.where(rng.random(n_ops) < 0.25,
                       rng.uniform(2, 30, n_ops), 0.0).astype(np.float32)
    t = trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                      parity=t.parity, channels=channels, ways=ways,
                      arrival_us=arr, extra_us=ext)
    jt = j_trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                         parity=t.parity, channels=channels, ways=ways,
                         arrival_us=arr, extra_us=ext)
    return table, jtable, t, jt


def cols(table):
    return tuple(torch.as_tensor(getattr(table, f)) for f in FIELDS)


def jargs(table, t):
    n = t.n_ops
    arr = np.zeros(n, np.float32) if t.arrival_us is None else t.arrival_us
    ext = np.zeros(n, np.float32) if t.extra_us is None else t.extra_us
    return (tuple(getattr(table, f) for f in FIELDS),
            (t.cls, t.channel, t.way, t.parity, arr, ext))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("channels", (1, 2, 3, 4))
@pytest.mark.parametrize("ways", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("batched", (False, True))
@pytest.mark.parametrize("side", (False, True))
def test_scan_matches_jax_scan(channels, ways, batched, side):
    table, jtable, t, jt = pair(channels, ways, side, seed=channels * ways)
    got = sim.trace_end_time(
        *cols(table), t.cls, t.channel, t.way, t.parity, t.arrival_us,
        t.extra_us, n_channels=channels, batched=batched)
    jtab, jtr = jargs(jtable, jt)
    want = j_sim.trace_end_time(*jtab, *jtr, n_channels=channels,
                                batched=batched)
    assert got.dtype == torch.float32
    assert rel(float(got), float(want)) <= REL
    # the oracle is the same event loop in both packages
    policy = "batched" if batched else "eager"
    assert sim_ref.simulate_trace_ref(table, t, policy) == \
        j_ref.simulate_trace_ref(jtable, jt, policy)


@pytest.mark.parametrize("channels,ways", [(1, 16), (2, 4), (4, 8)])
@pytest.mark.parametrize("side", (False, True))
def test_scan_energy_and_batch_match_jax(channels, ways, side):
    table, jtable, t, jt = pair(channels, ways, side, seed=3, cell="slc")
    e = op_phase_energy_uj(table, "proposed")
    je = j_energy(jtable, "proposed")
    assert np.array_equal(e, je)
    end, acc = sim.trace_end_time_energy(
        *cols(table), torch.as_tensor(e), t.cls, t.channel, t.way,
        t.parity, t.arrival_us, t.extra_us, n_channels=channels,
        batched=False)
    jtab, jtr = jargs(jtable, jt)
    jend, jacc = j_sim.trace_end_time_energy(*jtab, je, *jtr,
                                             n_channels=channels,
                                             batched=False)
    assert rel(float(end), float(jend)) <= REL
    assert rel(acc.numpy(), np.asarray(jacc)) <= REL
    oend, oacc = sim_ref.simulate_trace_energy_ref(table, t, "proposed")
    joend, joacc = j_ref.simulate_trace_energy_ref(jtable, jt, "proposed")
    assert oend == joend and np.array_equal(oacc, joacc)
    assert sim_ref.trace_bandwidth_ref_mb_s(table, t) == \
        j_ref.trace_bandwidth_ref_mb_s(jtable, jt)
    # three design points: the table, and two rescaled copies
    scales = np.array([1.0, 0.9, 1.15], np.float32)
    stacked = [np.stack([getattr(table, f) * s for s in scales])
               for f in FIELDS]
    got = sim.trace_end_time_batch(
        *(torch.as_tensor(x) for x in stacked), t.cls, t.channel, t.way,
        t.parity, t.arrival_us, t.extra_us, n_channels=channels,
        batched=True)
    want = j_sim.trace_end_time_batch(*stacked, *jtr, n_channels=channels,
                                      batched=True)
    assert got.shape == (3,) and rel(got.numpy(), np.asarray(want)) <= REL
