"""The port's structured segment fold and prefix end-time folds against
the JAX package's, on the CPU: ``structured_segment_products`` at 1x1 to
8x16 under both policies with and without arrivals, surcharges and a
validity mask, ``structured_segment_energy`` and the prefix energy fold,
and ``trace_end_time_prefix[_batch]`` under both combines.  End times
and products bit-equal; energies within 1e-6 relative (see
``test_torch_logdepth.py``, whose comparison helpers these tests
share)."""

import numpy as np
import pytest

from repro.core import maxplus_form as jmf
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.core.energy import op_phase_energy_uj as j_phase_energy
from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace
from repro_torch.core.energy import op_phase_energy_uj
from test_torch_logdepth import j, same, t

ENERGY_REL = 1e-6
FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
          "ctrl_us", "arb_us")
GEOMETRIES = ((1, 1), (3, 5), (2, 16), (8, 16))


def cols(tables):
    """[B, K] float32 columns of a list of tables (the port's and JAX's
    tables are field-for-field equal)."""
    return [np.stack([np.asarray(getattr(tb, f), np.float32)
                      for tb in tables]) for f in FIELDS]


def scaled_tables(channels, ways, b, seed):
    """``b`` tables of the geometry with non-dyadic seeded timing."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        base = trace.op_class_table(sim.SSDConfig(
            channels=channels, ways=ways, cell=("slc", "mlc")[i % 2],
            interface=("conv", "proposed", "sync_only")[i % 3]))
        out.append(trace.from_reference_table({
            **{f: getattr(base, f) * rng.uniform(0.8, 1.2, len(base.cmd_us))
               for f in FIELDS}, "data_bytes": base.data_bytes}))
    return out


def side_arrays(n, seed, arrivals=True, extras=True, valid=True):
    rng = np.random.default_rng(seed)
    arr = (np.cumsum(rng.exponential(9.3, n)).astype(np.float32)
           if arrivals else None)
    ext = (np.where(rng.random(n) < 0.2, rng.random(n) * 13.7, 0.0)
           .astype(np.float32) if extras else None)
    ok = rng.random(n) < 0.8 if valid else None
    return arr, ext, ok


# --- the structured segment fold ---------------------------------------------


def structured(pkg, table_cols, tr, arr, ext, ok, channels, ways, batched,
               seg):
    if pkg == "jax":
        return np.asarray(jmf.structured_segment_products(
            *(j(c) for c in table_cols), j(tr.cls), j(tr.channel),
            j(tr.way), j(tr.parity), None if arr is None else j(arr),
            None if ext is None else j(ext), channels=channels, ways=ways,
            batched=batched, segment_len=seg,
            valid=None if ok is None else j(ok)))
    return mf.structured_segment_products(
        *(t(c) for c in table_cols), tr.cls, tr.channel, tr.way, tr.parity,
        arr, ext, channels=channels, ways=ways, batched=batched,
        segment_len=seg, valid=ok)


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("side", (False, True))
def test_structured_products_bit_equal_to_jax(channels, ways, policy, side):
    n = {1: 37, 3: 301, 2: 700, 8: 2048}[channels]
    tr = trace.mixed_trace(n, channels, ways, 0.6, seed=channels * ways)
    (tab,) = scaled_tables(channels, ways, 1, seed=n)
    c1 = [x[0] for x in cols([tab])]
    arr, ext, ok = side_arrays(n, seed=n, arrivals=side, extras=side,
                               valid=side)
    for seg in (7, 64):
        got = structured("torch", c1, tr, arr, ext, ok, channels, ways,
                         policy == "batched", seg)
        want = structured("jax", c1, tr, arr, ext, ok, channels, ways,
                          policy == "batched", seg)
        same(got, want)


@pytest.mark.parametrize("what", ("arrivals", "extras", "valid"))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_structured_products_each_side_input(what, policy):
    n, channels, ways = 150, 2, 4
    tr = trace.mixed_trace(n, channels, ways, 0.5, seed=3)
    tabs = scaled_tables(channels, ways, 3, seed=9)
    arr, ext, ok = side_arrays(n, 4, arrivals=what == "arrivals",
                               extras=what == "extras", valid=what == "valid")
    got = structured("torch", cols(tabs), tr, arr, ext, ok, channels, ways,
                     policy == "batched", 16)
    for b in range(3):   # the batch axis is JAX's vmap over tables
        want = structured("jax", [c[b] for c in cols(tabs)], tr, arr, ext,
                          ok, channels, ways, policy == "batched", 16)
        same(got[b], want)
    if what == "valid":
        # a masked-out op is the identity, not a zero-timing op
        keep = np.flatnonzero(ok)
        sub = trace.OpTrace(cls=tr.cls[keep], channel=tr.channel[keep],
                            way=tr.way[keep], parity=tr.parity[keep],
                            channels=channels, ways=ways)
        full = sim.trace_end_time_prefix(
            *(t(c[0]) for c in cols(tabs)), tr.cls, tr.channel, tr.way,
            tr.parity, n_channels=channels, n_ways=ways,
            batched=policy == "batched", valid=ok)
        dense = sim.trace_end_time_prefix(
            *(t(c[0]) for c in cols(tabs)), sub.cls, sub.channel, sub.way,
            sub.parity, n_channels=channels, n_ways=ways,
            batched=policy == "batched", segment_len=1)
        ref = sim.trace_end_time(
            *(t(c[0]) for c in cols(tabs)), sub.cls, sub.channel, sub.way,
            sub.parity, n_channels=channels, batched=policy == "batched")
        assert abs(float(full) - float(ref)) <= len(keep) * 2.0 ** -24 * \
            float(ref)
        assert abs(float(dense) - float(ref)) <= len(keep) * 2.0 ** -24 * \
            float(ref)


@pytest.mark.parametrize("seg", (None, 1, 7, 64))
def test_energy_folds_within_1e6_of_jax(seg):
    n, channels, ways = 333, 2, 4
    tr = trace.mixed_trace(n, channels, ways, 0.6, seed=seg or 0)
    cfg = dict(channels=channels, ways=ways, cell="mlc")
    tab = trace.op_class_table(sim.SSDConfig(**cfg))
    e = op_phase_energy_uj(tab, "proposed")
    je = j_phase_energy(j_trace.op_class_table(j_sim.SSDConfig(**cfg)),
                        "proposed")
    assert np.array_equal(e, np.asarray(je))
    got = mf.structured_segment_energy(t(e), tr.cls, tr.parity,
                                       segment_len=seg or 1)
    want = np.asarray(jmf.structured_segment_energy(
        j(je), j(tr.cls), j(tr.parity), segment_len=seg or 1))
    np.testing.assert_allclose(got.numpy(), want, rtol=ENERGY_REL, atol=0)
    arr, ext, _ = side_arrays(n, 5, valid=False)
    c1 = [x[0] for x in cols([tab])]
    end, sums = sim.trace_end_time_prefix_energy(
        *(t(c) for c in c1), t(e), tr.cls, tr.channel, tr.way, tr.parity,
        arr, ext, n_channels=channels, n_ways=ways, batched=False,
        segment_len=seg)
    j_end, j_sums = j_sim.trace_end_time_prefix_energy(
        *(j(c) for c in c1), j(je), j(tr.cls), j(tr.channel), j(tr.way),
        j(tr.parity), j(arr), j(ext), n_channels=channels, n_ways=ways,
        batched=False, segment_len=seg)
    same(end, j_end)
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums),
                               rtol=ENERGY_REL, atol=0)


# --- the prefix end-time folds -----------------------------------------------


@pytest.mark.parametrize("combine", ("chain", "assoc"))
@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("channels,ways", ((2, 4), (4, 3)))
def test_prefix_end_times_bit_equal_to_jax(combine, policy, channels, ways):
    n = 300
    tr = trace.mixed_trace(n, channels, ways, 0.6, seed=channels + ways)
    tabs = scaled_tables(channels, ways, 4, seed=n + channels)
    arr, ext, _ = side_arrays(n, 6, valid=False)
    cb = cols(tabs)
    ops_t = (tr.cls, tr.channel, tr.way, tr.parity, arr, ext)
    ops_j = tuple(j(x) for x in ops_t)
    kw = dict(n_channels=channels, n_ways=ways, batched=policy == "batched",
              combine=combine)
    for seg in (None, 64):
        got = sim.trace_end_time_prefix_batch(*(t(c) for c in cb), *ops_t,
                                              segment_len=seg, **kw)
        want = j_sim.trace_end_time_prefix_batch(*(j(c) for c in cb), *ops_j,
                                                 segment_len=seg, **kw)
        same(got, want)
    one = sim.trace_end_time_prefix(*(t(c[2]) for c in cb), *ops_t,
                                    segment_len=16, **kw)
    same(one, j_sim.trace_end_time_prefix(*(j(c[2]) for c in cb), *ops_j,
                                          segment_len=16, **kw))
    with pytest.raises(ValueError, match="unknown combine"):
        sim.trace_end_time_prefix(*(t(c[0]) for c in cb), *ops_t,
                                  n_channels=channels, n_ways=ways,
                                  batched=False, combine="tree")
