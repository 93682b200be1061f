"""The port's translation machine (``repro_torch.core.ftl_scan``, torch on
``device="cpu"``) against the JAX package's ``lax.scan`` machine and the
host translators, on the CPU.

All integer state machines, no float arithmetic (``arrival`` is only
copied): every comparison is exact.  The port's machine must be
op-for-op the port's host translator and JAX's scan — op classes,
arrivals, payloads, request ids, GC flags, stats, erase counts and the
final drive state — across the policy x geometry x overprovisioning
grid, errors included; its emission rows equal the JAX fold's row for
row; the lanes of one batched run equal single runs."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ftl as j_ftl
from repro.core import ftl_scan as j_scan
from repro.core import workload as j_wl
from repro_torch.core import ftl, ftl_scan
from repro_torch.core import workload as wl

CPU = "cpu"


def both(**kw):
    return ftl.FTLSpec(**kw), j_ftl.FTLSpec(**kw)


def assert_same_translation(got, want):
    for f in ("op_cls", "arrival_us", "payload", "request_id", "gc"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    for f in ("l2p", "p2l", "valid_count", "full", "fill_seq",
              "erase_count"):
        assert np.array_equal(getattr(got.state, f), getattr(want.state, f)), f
    assert list(got.state.free) == list(want.state.free)
    assert (got.state.open_block, got.state.next_page, got.state._seq) == (
        want.state.open_block, want.state.next_page, want.state._seq)


def _outcome(fn):
    try:
        return fn(), None
    except RuntimeError as e:
        return None, str(e)


# --- op-for-op agreement: the grid ------------------------------------------


@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
@pytest.mark.parametrize("blocks,ppb", [(16, 4), (32, 16), (64, 32)])
@pytest.mark.parametrize("op", [0.15, 0.28, 0.5])
def test_scan_matches_host_and_jax_grid(policy, blocks, ppb, op):
    """Preconditioned drives over the JAX package's acceptance grid: the
    port's machine == the port's host translator == JAX's scan (the
    deadlocking cells raise the same message on all three)."""
    s, j = both(blocks=blocks, pages_per_block=ppb, overprovision=op,
                gc_policy=policy, precondition=True)
    got, got_err = _outcome(lambda: ftl_scan.translate_scan(
        wl.overwrite_stream(200, 100, seed=3), s, device=CPU))
    host, host_err = _outcome(lambda: ftl.translate(
        wl.overwrite_stream(200, 100, seed=3), s))
    want, want_err = _outcome(lambda: j_scan.translate_scan(
        j_wl.overwrite_stream(200, 100, seed=3), j))
    assert got_err == host_err == want_err
    if got_err is None:
        assert_same_translation(got, host)
        assert_same_translation(got, want)


@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_scan_matches_host_read_mix(policy):
    """Reads, Poisson arrivals and a skewed footprint exercise every
    branch of the machine (host reads never touch the map)."""
    s, j = both(blocks=64, pages_per_block=16, overprovision=0.25,
                gc_policy=policy, precondition=True)
    kw = dict(read_fraction=0.3, mean_interarrival_us=2.0, seed=11)
    got = ftl_scan.translate_scan(wl.aging_stream(600, 450, **kw), s,
                                  device=CPU)
    assert got.stats.gc_op_count > 0
    assert_same_translation(got, ftl.translate(wl.aging_stream(600, 450,
                                                               **kw), s))
    assert_same_translation(got, j_ftl.translate(
        j_wl.aging_stream(600, 450, **kw), j))


@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_scan_chaining_matches_host(policy):
    """state= chains aging: scan->scan and host->scan both continue the
    drive exactly like host->host (stats stay cumulative)."""
    s = ftl.FTLSpec(blocks=64, pages_per_block=16, overprovision=0.28,
                    gc_policy=policy, precondition=True)
    s1 = wl.overwrite_stream(300, 120, seed=7)
    s2 = wl.overwrite_stream(300, 120, seed=8)
    ref = ftl.translate(s2, s, state=ftl.translate(s1, s).state)
    ts1 = ftl_scan.translate_scan(s1, s, device=CPU)
    assert_same_translation(
        ftl_scan.translate_scan(s2, s, state=ts1.state, device=CPU), ref)
    assert_same_translation(ftl_scan.translate_scan(
        s2, s, state=ftl.translate(s1, s).state, device=CPU), ref)


def test_scan_error_messages_match_host():
    s = ftl.FTLSpec(blocks=8, pages_per_block=8, overprovision=0.15,
                    precondition=True)
    stream = wl.overwrite_stream(64, 24, seed=3)
    with pytest.raises(RuntimeError) as host_err:
        ftl.translate(stream, s)
    with pytest.raises(RuntimeError) as scan_err:
        ftl_scan.translate_scan(stream, s, device=CPU)
    assert str(scan_err.value) == str(host_err.value)
    for bit in (ftl_scan.ERR_NO_FREE, ftl_scan.ERR_GUARD,
                ftl_scan.ERR_NO_CAND, ftl_scan.ERR_ALL_VALID, 16):
        with pytest.raises(RuntimeError) as got:
            ftl_scan._raise_scan_error(bit, s)
        with pytest.raises(RuntimeError) as want:
            j_scan._raise_scan_error(bit, j_ftl.FTLSpec(
                blocks=8, pages_per_block=8, overprovision=0.15,
                precondition=True))
        assert str(got.value) == str(want.value)


def test_scan_rejects_faulty_state_and_bad_streams():
    s = ftl.FTLSpec(blocks=32, pages_per_block=8, overprovision=0.3)
    st = ftl.FTLState(s)
    st.bad[3] = True
    with pytest.raises(ValueError, match="fault-free"):
        ftl_scan.scan_state_from_host(st, CPU)
    stream = wl.overwrite_stream(4, 4)
    empty = dataclasses.replace(stream, **{
        f.name: getattr(stream, f.name)[:0]
        for f in dataclasses.fields(stream)
        if isinstance(getattr(stream, f.name), np.ndarray)})
    with pytest.raises(ValueError, match="empty workload"):
        ftl_scan.translate_scan(empty, s, device=CPU)
    bad = dataclasses.replace(stream, op_cls=np.full(4, 3, np.int32))
    with pytest.raises(ValueError, match="READ/WRITE"):
        ftl_scan.translate_scan(bad, s, device=CPU)


def test_small_buffer_grows_and_converges():
    """A record buffer far below the emitted step count grows, it does
    not mis-translate."""
    s = ftl.FTLSpec(blocks=32, pages_per_block=8, overprovision=0.3)
    stream = wl.overwrite_stream(1500, 128, seed=5)
    cls, arr, rid, pay = wl.request_ops(stream)
    lpns = wl.request_lpns(stream, s.logical_pages)
    fs = ftl_scan.scan_state_from_host(ftl.FTLState(s), CPU)
    _, rows = ftl_scan._run_machine(fs, s, cls, arr, pay, rid, lpns, 1)
    assert rows[0].shape[0] > ftl_scan._CHUNK
    op_cls, arrival, payload, rid_o, gc = ftl_scan._trim(rows)
    want = ftl.translate(stream, s)
    assert np.array_equal(op_cls, want.op_cls)
    assert np.array_equal(rid_o, want.request_id)


# --- the fold against the JAX fold, row for row -----------------------------


def _fold_inputs(stream, spec, n_b):
    cls, arr, rid, pay = j_wl.request_ops(stream)
    lpns = j_wl.request_lpns(stream, spec.logical_pages)
    n = len(cls)

    def pad(x, dt):
        return np.pad(np.asarray(x, dt), (0, n_b - n))
    return n, (pad(cls, np.int32), pad(arr, np.float32), pad(pay, bool),
               pad(rid, np.int32), pad(lpns, np.int32))


@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_fold_rows_equal_jax_fold(policy):
    """``make_translate_fold`` at a fixed ``t_max``: the same
    ``[t_max, 2*ppb + 1]`` emission rows as JAX's fold, lane for lane,
    and the same final registers — from a fresh and from a preconditioned
    drive."""
    s, j = both(blocks=32, pages_per_block=8, overprovision=0.3,
                gc_policy=policy)
    stream = j_wl.overwrite_stream(400, 150, read_fraction=0.3, seed=5)
    n_b = j_scan._bucket(400 + 8)
    n, args = _fold_inputs(stream, j, n_b)
    aged = ftl.translate(wl.overwrite_stream(500, 150, seed=1), s).state
    j_aged = j_ftl.translate(j_wl.overwrite_stream(500, 150, seed=1),
                             j).state
    for st, j_st in ((ftl_scan.scan_state_fresh(s, 1, CPU),
                      j_scan.scan_state_fresh(j)),
                     (ftl_scan.scan_state_from_host(aged, CPU),
                      j_scan.scan_state_from_host(j_aged))):
        out, rows = ftl_scan.make_translate_fold(32, 8, n_b, 300)(
            *args, n, 2, policy == "lru", st)
        j_out, j_rows = j_scan.make_translate_fold(32, 8, n_b, 300)(
            *args, n, 2, policy == "lru", j_st)
        for got, want in zip(rows, j_rows):
            want = np.asarray(want)
            assert np.array_equal(got[0].numpy().astype(want.dtype), want)
        for f in ("h", "mode", "victim", "guard", "watermark", "host_w",
                  "total_w", "gc_pages", "erases", "err", "free_head",
                  "free_tail", "open_block", "next_page", "seq"):
            assert int(getattr(out, f)[0]) == int(getattr(j_out, f)), f
        assert np.array_equal(out.p2l[0, :-1].numpy(), np.asarray(j_out.p2l))
        assert np.array_equal(out.valid_count[0, :-1].numpy(),
                              np.asarray(j_out.valid_count))


def test_fold_leaves_its_input_state_alone():
    s = ftl.FTLSpec(blocks=16, pages_per_block=4, overprovision=0.3)
    st = ftl_scan.scan_state_fresh(s, 1, CPU)
    before = {k: v.clone() for k, v in st._asdict().items()}
    stream = j_wl.overwrite_stream(120, 40, seed=2)
    n, args = _fold_inputs(stream, s, j_scan._bucket(124))
    ftl_scan.make_translate_fold(16, 4, j_scan._bucket(124), 200)(
        *args, n, 2, False, st)
    for k, v in st._asdict().items():
        assert torch.equal(v, before[k]), k


def test_lanes_equal_single_runs():
    """B lanes of one fold (each its own lpn row, trigger and policy)
    equal B single-lane folds, state and rows."""
    specs = [ftl.FTLSpec(blocks=32, pages_per_block=8, overprovision=op,
                         gc_policy=g, gc_free_blocks=gf)
             for op, g, gf in ((0.2, "greedy", 2), (0.4, "lru", 2),
                               (0.25, "greedy", 1), (0.6, "lru", 3))]
    stream = wl.overwrite_stream(300, 140, read_fraction=0.2, seed=4)
    n_b = ftl_scan._bucket(300 + 8)
    n, args = _fold_inputs(stream, specs[0], n_b)
    lpn = np.stack([np.pad(wl.request_lpns(stream, s.logical_pages),
                           (0, n_b - n)) for s in specs])
    fold = ftl_scan.make_translate_fold(32, 8, n_b, 260)
    out, rows = fold(*args[:4], lpn, n, [s.gc_free_blocks for s in specs],
                     [s.gc_policy == "lru" for s in specs],
                     ftl_scan.scan_state_fresh(specs[0], 4, CPU))
    for i, s in enumerate(specs):
        one, one_rows = fold(*args[:4], lpn[i], n, s.gc_free_blocks,
                             s.gc_policy == "lru",
                             ftl_scan.scan_state_fresh(s, 1, CPU))
        for a, b in zip(rows, one_rows):
            assert torch.equal(a[i], b[0])
        for f in out._fields:
            assert torch.equal(getattr(out, f)[i], getattr(one, f)[0]), f


@pytest.mark.parametrize("policy", ftl.GC_POLICIES)
def test_victim_ties_break_to_the_lowest_block(policy):
    """Several full blocks with equal valid counts and equal fill
    sequence numbers: the trigger picks the lowest block id, as JAX's
    ``argmax`` and the host's ``np.lexsort`` do.  A drive state no
    translation reaches (fill sequence numbers are unique there), built
    by hand so the tie is exact."""
    s, j = both(blocks=8, pages_per_block=4, overprovision=0.5,
                gc_policy=policy)
    st = ftl.FTLState(s)
    st.l2p[:] = -1
    st.p2l[:] = -1
    st.valid_count[:] = 0
    for blk, lpn in ((5, 0), (2, 1), (6, 2), (3, 3)):
        st.full[blk] = True
        st.fill_seq[blk] = 4
        st.l2p[lpn] = blk * 4
        st.p2l[blk * 4] = lpn
        st.valid_count[blk] = 1
    st.valid_count[6] += 1         # block 6: two valid pages
    st.p2l[6 * 4 + 1] = 5
    st.l2p[5] = 6 * 4 + 1
    st.free.clear()
    st.free.extend([4, 7])         # two free blocks: a write triggers GC
    st.open_block, st.next_page, st._seq = 1, 0, 9
    stream = wl.overwrite_stream(1, 5, seed=0)
    stream = dataclasses.replace(stream, lpn=np.asarray([4]))
    n_b = ftl_scan._bucket(1 + 4)
    n, args = _fold_inputs(stream, s, n_b)
    out, _ = ftl_scan.make_translate_fold(8, 4, n_b, 1)(
        *args, n, 2, policy == "lru", ftl_scan.scan_state_from_host(st, CPU))
    j_st = j_scan.scan_state_from_host(_jax_state(st, j))
    j_out, _ = j_scan.make_translate_fold(8, 4, n_b, 1)(
        *args, n, 2, policy == "lru", j_st)
    assert int(out.mode[0]) == ftl_scan.MODE_GC == int(j_out.mode)
    assert int(out.victim[0]) == int(j_out.victim) == 2
    # the host translator agrees on its own lexsort
    assert ftl.select_victim(policy, st.valid_count, st.full,
                             st.fill_seq) == 2


def _jax_state(st, j_spec):
    """The same drive state as a JAX ``FTLState``."""
    out = j_ftl.FTLState(j_spec)
    for f in ("l2p", "p2l", "valid_count", "full", "fill_seq",
              "erase_count"):
        setattr(out, f, getattr(st, f).copy())
    out.free.clear()
    out.free.extend(st.free)
    out.open_block, out.next_page, out._seq = (st.open_block, st.next_page,
                                               st._seq)
    return out


# --- accounting and the sizing helpers --------------------------------------


def test_erase_counts_and_state_round_trip():
    s = ftl.FTLSpec(blocks=32, pages_per_block=8, overprovision=0.25,
                    precondition=True)
    stream = wl.overwrite_stream(400, 150, seed=9)
    th = ftl.translate(stream, s)
    ts = ftl_scan.translate_scan(stream, s, device=CPU)
    assert np.array_equal(th.state.erase_count, ts.state.erase_count)
    assert int(ts.state.erase_count.sum()) >= ts.stats.erases > 0
    back = ftl_scan.scan_state_to_host(
        ftl_scan.scan_state_from_host(ts.state, CPU), s)
    for f in ("l2p", "p2l", "valid_count", "full", "fill_seq",
              "erase_count"):
        assert np.array_equal(getattr(back, f), getattr(ts.state, f)), f
    assert list(back.free) == list(ts.state.free)
    assert back.stats == ts.stats


def test_estimates_and_bucket_equal_jax():
    for n in (1, 7, 63, 64, 65, 100, 1000, 4097, 123457):
        for floor in (1, 64):
            assert ftl_scan._bucket(n, floor) == j_scan._bucket(n, floor)
    for kw in (dict(), dict(overprovision=0.12, gc_policy="lru"),
               dict(blocks=1024, pages_per_block=64),
               dict(blocks=128, pages_per_block=32, overprovision=0.5)):
        s, j = both(**kw)
        for r, w in ((0, 0), (100, 0), (300, 700), (0, 157284)):
            assert ftl_scan.estimate_ops(s, r, w) == \
                j_scan.estimate_ops(j, r, w)
            for pre in (False, True):
                assert ftl_scan.estimate_t_max(s, r, w, precondition=pre) \
                    == j_scan.estimate_t_max(j, r, w, precondition=pre)


def test_preconditioned_drive_is_memoised_and_cloned():
    """Queries of one spec age the drive once into the caller's cache,
    bounded at PRE_STATES_MAX; the cache hands out copies, so a
    translation never changes what the next one starts from."""
    import collections
    s = ftl.FTLSpec(blocks=16, pages_per_block=8, overprovision=0.3,
                    precondition=True, seed=21)
    stream = wl.overwrite_stream(200, 80, seed=1)
    cache = collections.OrderedDict()
    a = ftl_scan.translate_scan(stream, s, device=CPU, pre_states=cache)
    assert list(cache) == [(s,)]
    b = ftl_scan.translate_scan(stream, s, device=CPU, pre_states=cache)
    assert_same_translation(a, b)
    assert_same_translation(a, ftl.translate(stream, s))
    for seed in range(ftl_scan.PRE_STATES_MAX + 1):
        ftl_scan.preconditioned_lanes(
            [dataclasses.replace(s, seed=seed)], CPU, cache)
    assert len(cache) == ftl_scan.PRE_STATES_MAX and (s,) not in cache
