"""The port's (max,+) host builders against the JAX package: combos,
dictionaries, arrival templates, written-rows masks and initial states
are bit-equal for the same trace and tables."""

import dataclasses

import numpy as np
import pytest

from repro.core import maxplus_form as j_mf
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("channels,ways", [(1, 1), (1, 16), (2, 4), (3, 2),
                                           (4, 8)])
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_combo_dictionaries_bit_equal(channels, ways, policy):
    cfg = dict(interface="proposed", cell="mlc", channels=channels,
               ways=ways)
    table = trace.op_class_table(sim.SSDConfig(**cfg))
    jtable = j_trace.op_class_table(j_sim.SSDConfig(**cfg))
    t = trace.mixed_trace(256, channels, ways, 0.6, seed=channels + ways)
    jt = j_trace.mixed_trace(256, channels, ways, 0.6, seed=channels + ways)
    combos, idx = mf.trace_combos(t)
    jcombos, jidx = j_mf.trace_combos(jt)
    assert combos == jcombos
    assert_bits(idx, jidx)
    layout = mf.StateLayout(channels, ways)
    jlayout = j_mf.StateLayout(channels, ways)
    assert dataclasses.astuple(layout) == dataclasses.astuple(jlayout)
    assert (layout.n_state, layout.origin, layout.n_completion_rows) == (
        jlayout.n_state, jlayout.origin, jlayout.n_completion_rows)
    assert_bits(mf.combo_matrices(table, combos, layout, policy),
                j_mf.combo_matrices(jtable, jcombos, jlayout, policy))
    assert_bits(mf.combo_arrival_offsets(table, combos, layout, policy),
                j_mf.combo_arrival_offsets(jtable, jcombos, jlayout, policy))
    assert_bits(mf.combo_written_rows(combos, layout),
                j_mf.combo_written_rows(jcombos, jlayout))
    assert_bits(mf.init_state(layout), j_mf.init_state(jlayout))


@pytest.mark.parametrize("ways", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("mode", ("read", "write"))
def test_transition_matrices_bit_equal(ways, mode):
    from repro.core.interface import make_interface as j_iface
    from repro.core.nand import chip as j_chip
    from repro_torch.core.interface import make_interface
    from repro_torch.core.nand import chip
    op = sim.page_op_params(make_interface("conv"), chip("mlc"), mode, ways)
    jop = j_sim.page_op_params(j_iface("conv"), j_chip("mlc"), mode, ways)
    for policy in ("eager", "batched"):
        assert_bits(mf.transition_matrices(op, ways, policy, arb_us=1.5),
                    j_mf.transition_matrices(jop, ways, policy, arb_us=1.5))


def test_identity_and_end_time():
    assert mf.NEG == j_mf.NEG == -1e30
    assert mf.N_STATE == j_mf.N_STATE and mf.PERIOD == j_mf.PERIOD
    assert_bits(mf.maxplus_eye(7), j_mf.maxplus_eye(7))
    rng = np.random.default_rng(4)
    state = rng.uniform(0, 100, (3, mf.StateLayout(2, 4).n_state)
                        ).astype(np.float32)
    assert_bits(mf.end_time_from_state(state, mf.StateLayout(2, 4)),
                j_mf.end_time_from_state(state, j_mf.StateLayout(2, 4)))
    for w in range(16):
        for batched in (False, True):
            assert mf.ready_offset_us(0.14, 25.0, w, batched) == \
                j_mf.ready_offset_us(0.14, 25.0, w, batched)
