"""The port's host FTL translator (``repro_torch.core.ftl``, numpy) against
the JAX package's ``repro.core.ftl``, on the CPU.

Both are numpy on the same PCG64 streams (``default_rng(spec.seed)`` for
preconditioning, ``SeedSequence([fault_seed, 2])`` for block failures),
so every comparison here is exact: validation messages, victim choices,
``analytic_waf`` floats, the 7-class table column for column (values and
dtypes), and ``translate``'s op stream, stats and final drive state."""

import dataclasses

import numpy as np
import pytest

from repro.core import ftl as j_ftl
from repro.core import sim as j_sim
from repro.core import workload as j_wl
from repro_torch.core import ftl, sim
from repro_torch.core import workload as wl

TABLE_FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
                "ctrl_us", "arb_us", "data_bytes", "io_us")


def both(**kw):
    return ftl.FTLSpec(**kw), j_ftl.FTLSpec(**kw)


def assert_same_translation(got, want):
    """Op stream, stats and final drive state equal, dtypes included."""
    for f in ("op_cls", "arrival_us", "payload", "request_id", "gc"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    for f in ("l2p", "p2l", "valid_count", "full", "bad", "retired",
              "fill_seq", "erase_count"):
        assert np.array_equal(getattr(got.state, f), getattr(want.state, f)), f
    assert list(got.state.free) == list(want.state.free)
    assert (got.state.open_block, got.state.next_page, got.state._seq) == (
        want.state.open_block, want.state.next_page, want.state._seq)


@pytest.mark.parametrize("kw", [
    dict(blocks=2), dict(pages_per_block=0), dict(overprovision=0.0),
    dict(blocks=8, gc_free_blocks=7), dict(gc_free_blocks=0),
    dict(map_us=-1.0), dict(erase_us=-2.0), dict(precondition_passes=-1.0),
    dict(gc_policy="rr"), dict(blocks=4, pages_per_block=1,
                               overprovision=9.0)])
def test_spec_validation_messages_match_jax(kw):
    with pytest.raises(ValueError) as got:
        ftl.FTLSpec(**kw)
    with pytest.raises(ValueError) as want:
        j_ftl.FTLSpec(**kw)
    assert str(got.value) == str(want.value)


def test_constants_and_registry_match_jax():
    assert ftl.FTL_LABELS == j_ftl.FTL_LABELS
    assert ftl.GC_POLICIES == j_ftl.GC_POLICIES
    assert (ftl.FTL_READ, ftl.FTL_WRITE, ftl.GC_READ, ftl.GC_WRITE,
            ftl.ERASE) == (j_ftl.FTL_READ, j_ftl.FTL_WRITE, j_ftl.GC_READ,
                           j_ftl.GC_WRITE, j_ftl.ERASE)
    with pytest.raises(ValueError) as got:
        ftl.select_victim("bogus", np.ones(4), np.ones(4, bool),
                          np.arange(4))
    with pytest.raises(ValueError) as want:
        j_ftl.select_victim("bogus", np.ones(4), np.ones(4, bool),
                            np.arange(4))
    assert str(got.value) == str(want.value)
    for kind in ftl.GC_POLICIES:
        assert kind in str(got.value)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_victim_selection_matches_jax(policy, seed):
    """Random pools with many ties on the valid count (and, for lru, on
    the fill sequence): the same victim as JAX's, which is
    ``np.lexsort``'s first."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        valid = rng.integers(0, 4, 16)
        cand = rng.random(16) < 0.6
        cand[rng.integers(16)] = True
        fill = rng.integers(0, 5, 16)
        got = ftl.select_victim(policy, valid, cand, fill)
        assert got == j_ftl.select_victim(policy, valid, cand, fill)
        assert cand[got]


def test_spec_properties_and_analytic_waf_match_jax():
    for kw in (dict(blocks=64, pages_per_block=32, overprovision=0.25),
               dict(blocks=128, pages_per_block=8, overprovision=0.12),
               dict(blocks=1024, pages_per_block=64, overprovision=0.5,
                    gc_policy="lru")):
        s, j = both(**kw)
        assert (s.total_pages, s.logical_pages, s.utilization,
                s.describe()) == (j.total_pages, j.logical_pages,
                                  j.utilization, j.describe())
    for u in (0.3, 0.5, 0.7, 0.8, 0.8333, 0.9, 0.97):
        assert ftl.analytic_waf(u) == j_ftl.analytic_waf(u)
    for u in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError) as got:
            ftl.analytic_waf(u)
        with pytest.raises(ValueError) as want:
            j_ftl.analytic_waf(u)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cell", ("slc", "mlc"))
@pytest.mark.parametrize("kind", ("conv", "sync_only", "proposed"))
@pytest.mark.parametrize("channels", (1, 8))
def test_ftl_op_class_table_matches_jax(cell, kind, channels):
    for kw in (dict(), dict(map_us=0.7), dict(map_us=0.0, erase_us=123.0)):
        s, j = both(**kw)
        got = ftl.ftl_op_class_table(
            sim.SSDConfig(interface=kind, cell=cell, channels=channels,
                          ways=4), s)
        want = j_ftl.ftl_op_class_table(
            j_sim.SSDConfig(interface=kind, cell=cell, channels=channels,
                            ways=4), j)
        assert tuple(got.labels) == tuple(want.labels) == ftl.FTL_LABELS
        for f in TABLE_FIELDS:
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_precondition_lpns_matches_jax():
    for kw in (dict(blocks=64, pages_per_block=16, seed=3),
               dict(blocks=32, pages_per_block=8, precondition_passes=0.5),
               dict(blocks=16, pages_per_block=4, precondition_passes=0.0)):
        s, j = both(**kw)
        assert np.array_equal(ftl.precondition_lpns(s),
                              j_ftl.precondition_lpns(j))


@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_translate_matches_jax(policy, seed):
    """Preconditioned drive, a read/write mix with Poisson arrivals."""
    s, j = both(blocks=32, pages_per_block=16, overprovision=0.3,
                gc_policy=policy, precondition=True, seed=seed)
    args = dict(read_fraction=0.3, mean_interarrival_us=3.0, seed=seed)
    got = ftl.translate(wl.overwrite_stream(600, s.logical_pages, **args), s)
    want = j_ftl.translate(
        j_wl.overwrite_stream(600, j.logical_pages, **args), j)
    assert got.stats.gc_op_count > 0
    assert_same_translation(got, want)


@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_translate_with_block_failures_matches_jax(policy):
    s, j = both(blocks=64, pages_per_block=16, overprovision=0.3,
                gc_policy=policy)
    kw = dict(prog_fail_prob=0.002, erase_fail_prob=0.02, fault_seed=13)
    got = ftl.translate(wl.overwrite_stream(2500, s.logical_pages, seed=6),
                        s, **kw)
    want = j_ftl.translate(
        j_wl.overwrite_stream(2500, j.logical_pages, seed=6), j, **kw)
    assert got.stats.prog_fails > 0 and got.stats.blocks_retired > 0
    assert_same_translation(got, want)


def test_translate_chains_state_like_jax():
    s, j = both(blocks=32, pages_per_block=16, overprovision=0.3,
                precondition=True, seed=9)
    first = ftl.translate(wl.aging_stream(500, 300, seed=1), s)
    j_first = j_ftl.translate(j_wl.aging_stream(500, 300, seed=1), j)
    got = ftl.translate(wl.aging_stream(400, 300, seed=2), s,
                        state=first.state)
    want = j_ftl.translate(j_wl.aging_stream(400, 300, seed=2), j,
                           state=j_first.state)
    assert_same_translation(got, want)


def test_errors_match_jax():
    s, j = both(blocks=16, pages_per_block=8, overprovision=0.1)
    with pytest.raises(RuntimeError) as got:
        ftl.translate(wl.overwrite_stream(4000, s.logical_pages, seed=0), s,
                      erase_fail_prob=0.5, fault_seed=1)
    with pytest.raises(RuntimeError) as want:
        j_ftl.translate(j_wl.overwrite_stream(4000, j.logical_pages, seed=0),
                        j, erase_fail_prob=0.5, fault_seed=1)
    assert str(got.value) == str(want.value)
    s, j = both(blocks=8, pages_per_block=8, overprovision=0.15,
                precondition=True)
    with pytest.raises(RuntimeError) as got:
        ftl.translate(wl.overwrite_stream(64, 24, seed=3), s)
    with pytest.raises(RuntimeError) as want:
        j_ftl.translate(j_wl.overwrite_stream(64, 24, seed=3), j)
    assert str(got.value) == str(want.value)
    stream = wl.overwrite_stream(10, 64, seed=0)
    bad = dataclasses.replace(stream,
                              op_cls=np.full(stream.n_requests, 5, np.int32))
    with pytest.raises(ValueError, match="READ/WRITE"):
        ftl.translate(bad, ftl.FTLSpec())
    empty = dataclasses.replace(stream, **{
        f.name: getattr(stream, f.name)[:0]
        for f in dataclasses.fields(stream)
        if isinstance(getattr(stream, f.name), np.ndarray)})
    with pytest.raises(ValueError, match="empty workload"):
        ftl.translate(empty, ftl.FTLSpec())
