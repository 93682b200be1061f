"""The compact form of the (max,+) dictionaries (``kernels/maxplus/
compact.py``), the CPU twin of the fold kernels' compact route, against
the plain folds and the JAX package's Pallas kernels.

On ``maxplus_form`` dictionaries the twin's folds over the compact records
must be ``torch.equal`` to ``maxplus_fold_ref`` / ``maxplus_fold_many_ref``
and to JAX's kernels in interpret mode, in every variant; the route's
precondition must accept what ``op_matrix`` builds (entries at NEG, the
identity pad combo, the batched way-0 round_start row, a fleet without
faults) and refuse what would make the route inexact.  The card's
pre-pass and compact kernels are held against this twin by
``tests/test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.maxplus import kernel as j_kernel
from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace
from repro_torch.kernels.maxplus import compact
from repro_torch.kernels.maxplus.kernel import maxplus_compact_kernel
from repro_torch.kernels.maxplus.ref import (maxplus_fold_many_ref,
                                             maxplus_fold_ref)

VARIANTS = ("periodic", "periodic+energy", "indexed",
            "indexed+arrivals+extras", "indexed+energy+arrivals+extras")
# (channels, ways, ops): short T at 8 x 16, where N = 146
GEOMETRIES = ((1, 1, 160), (2, 4, 160), (4, 8, 120), (8, 16, 40))
POLICIES = ("eager", "batched")
# lengths 0 (an empty lane) and 1, unsorted
MANY_LENGTHS = (70, 1, 93, 0, 31, 5)


def scaled_tables(rng, channels, ways, b):
    base = trace.op_class_table(sim.SSDConfig(channels=channels, ways=ways))
    return [trace.from_reference_table({
        **{f: getattr(base, f) * np.float32(rng.uniform(0.8, 1.2))
           for f in ("cmd_us", "pre_us", "slot_us", "post_lo_us",
                     "post_hi_us", "ctrl_us", "arb_us")},
        "data_bytes": base.data_bytes}) for _ in range(b)]


def fold_inputs(channels, ways, t, policy, seed=0, b=2):
    """A mixed trace's combo dictionary under ``b`` scaled tables, with
    its arrival offsets, written rows, and seeded arrivals, extras and
    energies (numpy)."""
    rng = np.random.default_rng(seed)
    tr = trace.mixed_trace(t, channels, ways, 0.6, seed=seed + 1)
    layout = mf.StateLayout(channels, ways)
    combos, idx = mf.trace_combos(tr)
    tabs = scaled_tables(rng, channels, ways, b)
    mats = np.stack([mf.combo_matrices(x, combos, layout, policy)
                     for x in tabs])
    m, n = mats.shape[1], mats.shape[2]
    return dict(
        mats=mats, s0=np.zeros((b, n), np.float32), idx=idx,
        arrivals=np.cumsum(rng.exponential(12.0, t)).astype(np.float32),
        extras=np.where(rng.random(t) < 0.2, rng.uniform(1, 40, t),
                        0.0).astype(np.float32),
        gvec=np.stack([mf.combo_arrival_offsets(x, combos, layout, policy)
                       for x in tabs]),
        wvec=np.broadcast_to(mf.combo_written_rows(combos, layout),
                             (b, m, n)).copy(),
        energy=rng.uniform(0, 3, (b, m, 5)).astype(np.float32), t=t)


def variant_kwargs(variant, d):
    kw = {}
    if "indexed" in variant:
        kw["idx"] = d["idx"]
    if "energy" in variant:
        kw["energy"] = d["energy"]
    if "arrivals" in variant:
        kw.update(arrivals=d["arrivals"], gvec=d["gvec"],
                  extras=d["extras"], wvec=d["wvec"])
    return kw


def as_tuple(x):
    return tuple(np.asarray(v) for v in (x if isinstance(x, tuple) else (x,)))


def bit_equal(a, b):
    return (a.dtype == b.dtype == np.float32 and a.shape == b.shape
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("channels,ways,t", GEOMETRIES)
def test_compact_fold_equals_plain_and_jax(channels, ways, t, policy,
                                           variant):
    d = fold_inputs(channels, ways, t, policy)
    kw = variant_kwargs(variant, d)
    tk = {k: torch.as_tensor(v) for k, v in kw.items()}
    mats, s0 = torch.as_tensor(d["mats"]), torch.as_tensor(d["s0"])
    comp, ok = compact.compact(mats, tk.get("gvec"), tk.get("wvec"))
    assert ok and int(comp.count.max()) <= compact.MAX_ROWS
    got = compact.fold_compact_ref(
        comp, s0, t_steps=t,
        **{k: v for k, v in tk.items() if k not in ("gvec", "wvec")})
    plain = maxplus_fold_ref(mats, s0, t_steps=t, **tk)
    jax_out = j_kernel.maxplus_fold_kernel(d["mats"], d["s0"], t_steps=t,
                                           interpret=True, **kw)
    for g, p, j in zip(as_tuple(got), as_tuple(plain), as_tuple(jax_out)):
        assert bit_equal(g, p) and bit_equal(g, j)


def many_inputs(channels, ways, policy, seed=3):
    """A fleet's union dictionary with the identity pad combo appended, its
    side rows, and seeded per-lane sequences padded with the pad combo."""
    rng = np.random.default_rng(seed)
    b, t = len(MANY_LENGTHS), max(MANY_LENGTHS)
    tr = trace.mixed_trace(300, channels, ways, 0.6, seed=seed)
    layout = mf.StateLayout(channels, ways)
    combos, _ = mf.trace_combos(tr)
    table = trace.op_class_table(sim.SSDConfig(channels=channels, ways=ways))
    m, n = len(combos), layout.n_state
    mats = np.concatenate([mf.combo_matrices(table, combos, layout, policy),
                           mf.maxplus_eye(n)[None]])
    gvec = np.concatenate([
        mf.combo_arrival_offsets(table, combos, layout, policy),
        np.full((1, n), mf.NEG, np.float32)])
    wvec = np.concatenate([mf.combo_written_rows(combos, layout),
                           np.zeros((1, n), np.float32)])
    idx = np.full((b, t), m, np.int32)
    arr = np.zeros((b, t), np.float32)
    ext = np.zeros((b, t), np.float32)
    for lane, ln in enumerate(MANY_LENGTHS):
        idx[lane, :ln] = rng.integers(0, m, ln)
        arr[lane, :ln] = np.cumsum(rng.exponential(9.0, ln))
        ext[lane, :ln] = np.where(rng.random(ln) < 0.15,
                                  rng.uniform(30, 120, ln), 0.0)
    return dict(mats=mats, gvec=gvec, wvec=wvec, idx=idx, arrivals=arr,
                extras=ext, s0=mf.init_state(layout),
                lengths=np.asarray(MANY_LENGTHS, np.int32))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("with_arrivals", (False, True))
@pytest.mark.parametrize("with_faults", (False, True))
def test_compact_many_equals_plain_and_jax(with_faults, with_arrivals,
                                           policy):
    d = many_inputs(4, 8, policy)
    td = {k: torch.as_tensor(v) for k, v in d.items()}
    comp, ok = compact.compact(td["mats"],
                               td["gvec"] if with_arrivals else None,
                               td["wvec"] if with_faults else None)
    assert ok
    pad = d["mats"].shape[0] - 1
    assert int(comp.count[pad]) == 0           # the identity pad writes nothing
    got = compact.fold_many_compact_ref(
        comp, td["idx"], td["arrivals"] if with_arrivals else None,
        td["extras"] if with_faults else None, td["s0"], td["lengths"])
    side = dict(extras=td["extras"], wvec=td["wvec"]) if with_faults else {}
    plain = maxplus_fold_many_ref(
        *(td[k] for k in ("mats", "gvec", "idx", "arrivals", "s0",
                          "lengths")), with_arrivals=with_arrivals, **side)
    jside = ({k: jnp.asarray(d[k]) for k in ("extras", "wvec")}
             if with_faults else {})
    want = j_kernel.maxplus_fold_many_kernel(
        *(jnp.asarray(d[k]) for k in ("mats", "gvec", "idx", "arrivals",
                                      "s0", "lengths")),
        with_arrivals=with_arrivals, block_lanes=4, interpret=True, **jside)
    assert bit_equal(got.numpy(), plain.numpy())
    assert bit_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got[MANY_LENGTHS.index(0)], td["s0"])


# --- the precondition ----------------------------------------------------


def small_dictionary(policy="eager", channels=2, ways=4):
    d = fold_inputs(channels, ways, 40, policy, b=1)
    return {k: torch.as_tensor(v) for k, v in d.items() if k != "t"}


def accepted(d, **over):
    d = {**d, **over}
    _, flag = maxplus_compact_kernel(d["mats"], d.get("gvec"), d.get("wvec"),
                                     s0=d["s0"], arrivals=d.get("arrivals"),
                                     extras=d.get("extras"))
    return int(flag) == 0


def test_precondition_accepts_the_dictionaries_op_matrix_builds():
    for policy in POLICIES:
        assert accepted(small_dictionary(policy))


def refused_inputs(name, d):
    mats = d["mats"].clone()
    if name == "random dense dictionary":
        rng = np.random.default_rng(0)
        mats = torch.as_tensor(rng.uniform(0, 50, tuple(mats.shape))
                               .astype(np.float32))
        return dict(mats=mats)
    if name == "one negative entry":
        mats[0, 0, 0, 0] = -1.0
        return dict(mats=mats)
    if name == "a row with five finite entries":
        row = d["wvec"][0, 0].argmax()               # combo 0's chip row
        finite = (mats[0, 0, row] > mf.NEG).nonzero().flatten()
        assert len(finite) == compact.MAX_ENTRIES
        spare = [c for c in range(mats.shape[-1]) if c not in finite][0]
        mats[0, 0, row, spare] = 3.0
        return dict(mats=mats)
    if name == "an inf in extras":
        extras = d["extras"].clone()
        extras[5] = float("inf")
        return dict(extras=extras)
    raise KeyError(name)


@pytest.mark.parametrize("name", ("random dense dictionary",
                                  "one negative entry",
                                  "a row with five finite entries",
                                  "an inf in extras"))
def test_precondition_refuses(name):
    d = small_dictionary()
    assert accepted(d)
    assert not accepted(d, **refused_inputs(name, d))


@pytest.mark.parametrize("name,fn", [
    ("-0.0 in s0", lambda d: dict(s0=d["s0"].index_fill(1, torch.tensor([0]),
                                                         -0.0))),
    ("NaN in arrivals", lambda d: dict(arrivals=d["arrivals"].index_fill(
        0, torch.tensor([3]), float("nan")))),
    ("a state beyond the limit", lambda d: dict(s0=d["s0"] + 2.0 ** 61)),
    ("a written-rows weight of 2", lambda d: dict(wvec=d["wvec"] * 2.0)),
    ("a negative arrival offset", lambda d: dict(gvec=torch.where(
        d["gvec"] > mf.NEG, -d["gvec"] - 1.0, d["gvec"]))),
])
def test_precondition_refuses_what_breaks_the_argument(name, fn):
    d = small_dictionary()
    assert not accepted(d, **fn(d))


def test_entries_at_or_below_neg_are_dropped():
    """NEG and -inf entries are dropped alike; a row that is the identity
    except for -inf in place of NEG is kept, with its diagonal only, and
    folds to the same bits."""
    d = small_dictionary()
    mats = d["mats"].clone()
    mats[0, 0, -1, 0] = float("-inf")             # origin row: was NEG
    comp, ok = compact.compact(mats, d["gvec"], d["wvec"])
    assert ok
    base, _ = compact.compact(d["mats"], d["gvec"], d["wvec"])
    assert int(comp.count[0]) == int(base.count[0]) + 1
    origin = mats.shape[-1] - 1
    j = int((comp.rows[0, :comp.count[0]] == origin).nonzero())
    assert comp.cols[0, j].tolist() == [origin] * compact.MAX_ENTRIES
    assert comp.vals[0, j].tolist() == [0.0] * compact.MAX_ENTRIES
    got = compact.fold_compact_ref(comp, d["s0"] + 1.0, t_steps=40,
                                   idx=d["idx"])
    assert torch.equal(got, maxplus_fold_ref(mats, d["s0"] + 1.0,
                                             t_steps=40, idx=d["idx"]))


def test_batched_way0_round_start_row_is_padded_with_its_entry():
    layout = mf.StateLayout(2, 4)
    tab = trace.op_class_table(sim.SSDConfig(channels=2, ways=4))
    combos = [(0, 1, 0, 0), (0, 1, 2, 1)]           # way 0 and way 2
    mats = torch.as_tensor(mf.combo_matrices(tab, combos, layout, "batched"))
    comp, ok = compact.compact(mats)
    assert ok
    assert comp.count.tolist() == [4, 3]            # + round_start at way 0
    rs = layout.rs(1)
    j = int((comp.rows[0] == rs).nonzero())
    assert comp.cols[0, j].tolist() == [layout.bus(1)] * compact.MAX_ENTRIES
    assert comp.vals[0, j].tolist() == [0.0] * compact.MAX_ENTRIES
    assert comp.rows[0].tolist() == sorted(comp.rows[0].tolist())


def test_fleet_without_faults_keeps_no_weights():
    d = many_inputs(2, 4, "eager")
    mats, gvec = torch.as_tensor(d["mats"]), torch.as_tensor(d["gvec"])
    comp, ok = compact.compact(mats, gvec, None)
    assert ok and torch.equal(comp.w, torch.zeros_like(comp.w))
    with_w, ok_w = compact.compact(mats, gvec, torch.as_tensor(d["wvec"]))
    assert ok_w and torch.equal(with_w.rows, comp.rows)
    # each combo's chip row carries the weight 1, no other row does
    assert torch.equal(with_w.w.sum(-1)[:-1], torch.ones(mats.shape[0] - 1))


def test_pack_lays_out_the_kernels_record():
    d = small_dictionary()
    comp, _ = compact.compact(d["mats"], d["gvec"], d["wvec"])
    words = compact.pack(comp)
    assert words.shape == (comp.count.shape[0], compact.WORDS)
    assert words.dtype == torch.int32
    c = 0
    as_f = words[c].view(torch.float32)
    assert torch.equal(as_f[:16], comp.vals[c].flatten())
    assert torch.equal(as_f[16:20], comp.g[c])
    assert torch.equal(as_f[20:24], comp.w[c])
    raw = words[c].numpy().view(np.uint8)
    assert raw[24 * 4:28 * 4].tolist() == comp.cols[c].flatten().tolist()
    nr = int(comp.count[c])
    assert raw[28 * 4:28 * 4 + nr].tolist() == comp.rows[c, :nr].tolist()
    assert int(words[c, 29]) == nr and words[c, 30:].tolist() == [0, 0]


def test_prepass_wrapper_checks_arrivals_only_within_lengths():
    d = many_inputs(2, 4, "eager")
    td = {k: torch.as_tensor(v) for k, v in d.items()}
    arr = td["arrivals"].clone()
    lane = MANY_LENGTHS.index(5)
    arr[lane, 5:] = float("nan")                      # past the lane's end

    def flag(a, lengths):
        _, f = maxplus_compact_kernel(td["mats"], td["gvec"], td["wvec"],
                                      s0=td["s0"], arrivals=a,
                                      extras=td["extras"], lengths=lengths)
        return int(f)
    assert flag(arr, td["lengths"]) == 0
    assert flag(arr, None) == 1
    arr[lane, 4] = -1.0                               # inside it
    assert flag(arr, td["lengths"]) == 1
