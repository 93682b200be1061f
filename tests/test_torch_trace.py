"""The port's trace layer against the JAX package: same arguments and seeds
give the same arrays; op-class tables field for field."""

import numpy as np
import pytest

from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro_torch.core import sim, trace

TRACE_FIELDS = ("cls", "channel", "way", "parity")
TABLE_FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
                "ctrl_us", "arb_us", "data_bytes", "io_us")


def assert_trace_equal(got, want):
    for f in TRACE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (got.channels, got.ways, got.payload) == (want.channels,
                                                     want.ways, want.payload)


@pytest.mark.parametrize("channels", (1, 2, 4))
@pytest.mark.parametrize("ways", (1, 2, 4, 8, 16))
def test_builders_equal(channels, ways):
    for op_cls in (trace.READ, trace.WRITE):
        assert_trace_equal(trace.steady_trace(64, channels, ways, op_cls),
                           j_trace.steady_trace(64, channels, ways, op_cls))
    for seed in (0, 3):
        assert_trace_equal(
            trace.mixed_trace(256, channels, ways, 0.6, seed=seed),
            j_trace.mixed_trace(256, channels, ways, 0.6, seed=seed))
        assert_trace_equal(
            trace.hot_cold_trace(256, channels, ways, seed=seed),
            j_trace.hot_cold_trace(256, channels, ways, seed=seed))


@pytest.mark.parametrize("interface", ("conv", "sync_only", "proposed"))
@pytest.mark.parametrize("cell", ("slc", "mlc"))
def test_op_class_table_equal(interface, cell):
    for channels, ways in ((1, 1), (1, 16), (2, 8), (4, 4), (3, 2)):
        got = trace.op_class_table(sim.SSDConfig(
            interface=interface, cell=cell, channels=channels, ways=ways))
        want = j_trace.op_class_table(j_sim.SSDConfig(
            interface=interface, cell=cell, channels=channels, ways=ways))
        for f in TABLE_FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and np.array_equal(g, w), f
        assert got.labels == want.labels


def test_from_reference_table_round_trip():
    jt = j_trace.op_class_table(j_sim.SSDConfig(channels=2, ways=4))
    got = trace.from_reference_table(
        {f: np.asarray(getattr(jt, f)) for f in TABLE_FIELDS})
    for f in TABLE_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(jt, f)), f
    f64 = trace.from_reference_table(
        {f: np.asarray(getattr(jt, f), np.float64) for f in TABLE_FIELDS})
    assert f64.slot_us.dtype == np.float32
    assert f64.data_bytes.dtype == np.int64
    with pytest.raises(ValueError, match="slot_us"):
        trace.from_reference_table({"cmd_us": jt.cmd_us})


def test_trace_validation_and_accounting():
    t = trace.mixed_trace(100, 2, 4, 0.5, seed=1)
    jt = j_trace.mixed_trace(100, 2, 4, 0.5, seed=1)
    table = trace.op_class_table(sim.SSDConfig(channels=2, ways=4))
    jtable = j_trace.op_class_table(j_sim.SSDConfig(channels=2, ways=4))
    assert t.total_bytes(table) == jt.total_bytes(jtable)
    assert t.read_fraction() == jt.read_fraction()
    assert t.describe() == jt.describe()
    with pytest.raises(ValueError, match="channel"):
        trace.OpTrace(cls=t.cls, channel=t.channel + 2, way=t.way,
                      parity=t.parity, channels=2, ways=4)
    with pytest.raises(ValueError, match="arrival"):
        trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                      parity=t.parity, channels=2, ways=4,
                      arrival_us=-np.ones(100, np.float32))
    with pytest.raises(ValueError, match="cls"):
        trace.OpTrace(cls=t.cls + 2, channel=t.channel, way=t.way,
                      parity=t.parity, channels=2,
                      ways=4).validate_against(table)
