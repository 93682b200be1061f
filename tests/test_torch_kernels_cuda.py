"""The hand-written CUDA (max,+) kernels (the per-design-point fold and
the many-trace fold) against their plain versions, on the card.  This
file imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode."""

import numpy as np
import pytest
import torch

from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace
from repro_torch.kernels.maxplus import ops
from repro_torch.kernels.maxplus.kernel import (LAUNCHES, maxplus_fold_kernel,
                                                maxplus_fold_many_kernel)
from repro_torch.kernels.maxplus.ref import (maxplus_fold_many_ref,
                                             maxplus_fold_ref)

pytestmark = pytest.mark.gpu

VARIANTS = ("periodic", "periodic+energy", "indexed",
            "indexed+arrivals+extras", "indexed+energy+arrivals+extras")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def inputs(card, seed=7, b=4, channels=4, ways=8, t=256):
    """A real combo dictionary under ``b`` scaled tables, with seeded
    arrivals, extras and energies, on the card."""
    rng = np.random.default_rng(seed)
    tr = trace.mixed_trace(t, channels, ways, 0.6, seed=seed)
    layout = mf.StateLayout(channels, ways)
    combos, idx = mf.trace_combos(tr)
    base = trace.op_class_table(sim.SSDConfig(channels=channels, ways=ways))
    tabs = [trace.from_reference_table({
        **{f: getattr(base, f) * np.float32(rng.uniform(0.8, 1.2))
           for f in ("cmd_us", "pre_us", "slot_us", "post_lo_us",
                     "post_hi_us", "ctrl_us", "arb_us")},
        "data_bytes": base.data_bytes}) for _ in range(b)]
    mats = np.stack([mf.combo_matrices(x, combos, layout) for x in tabs])
    m, n = mats.shape[1], mats.shape[2]
    d = dict(
        mats=mats, s0=np.zeros((b, n), np.float32), idx=idx,
        arrivals=np.cumsum(rng.exponential(20.0, t)).astype(np.float32),
        extras=np.where(rng.random(t) < 0.2, rng.uniform(1, 40, t),
                        0.0).astype(np.float32),
        gvec=np.stack([mf.combo_arrival_offsets(x, combos, layout)
                       for x in tabs]),
        wvec=np.broadcast_to(mf.combo_written_rows(combos, layout),
                             (b, m, n)).copy(),
        energy=rng.uniform(0, 3, (b, m, 5)).astype(np.float32))
    return {k: torch.as_tensor(v, device=card) for k, v in d.items()}, t


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_bit_equal_to_plain(card, variant):
    d, t = inputs(card)
    kw = {}
    if "indexed" in variant:
        kw["idx"] = d["idx"]
    if "energy" in variant:
        kw["energy"] = d["energy"]
    if "arrivals" in variant:
        kw.update({k: d[k] for k in ("arrivals", "gvec", "extras", "wvec")})
    got = maxplus_fold_kernel(d["mats"], d["s0"], t_steps=t, **kw)
    want = maxplus_fold_ref(d["mats"], d["s0"], t_steps=t, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def test_kernel_rejects_what_it_does_not_take(card):
    d, t = inputs(card, b=2, t=32)
    mats, s0, idx = d["mats"], d["s0"], d["idx"]
    with pytest.raises(TypeError, match="float32"):
        maxplus_fold_kernel(mats.double(), s0, t_steps=t)
    with pytest.raises(TypeError, match="int32"):
        maxplus_fold_kernel(mats, s0, t_steps=t, idx=idx.long())
    with pytest.raises(ValueError, match="shape"):
        maxplus_fold_kernel(mats, s0[:1], t_steps=t)
    with pytest.raises(ValueError, match="contiguous"):
        maxplus_fold_kernel(mats, s0.t().contiguous().t(), t_steps=t)
    with pytest.raises(ValueError, match="is on cpu"):
        maxplus_fold_kernel(mats, s0.cpu(), t_steps=t)
    with pytest.raises(ValueError, match="out of range"):
        maxplus_fold_kernel(mats, s0, t_steps=t, idx=idx + mats.shape[1])


# lengths 1 and 203 (not a multiple of 4), 0 (an empty lane), unsorted
MANY_LENGTHS = (130, 1, 203, 64, 0, 77, 5, 130, 3)


def many_inputs(card, seed=3, channels=4, ways=8):
    """A fleet's union dictionary (plus the identity pad row) with
    seeded per-lane sequences, arrivals and extras, on the card."""
    rng = np.random.default_rng(seed)
    b, t = len(MANY_LENGTHS), max(MANY_LENGTHS)
    tr = trace.mixed_trace(400, channels, ways, 0.6, seed=seed)
    layout = mf.StateLayout(channels, ways)
    combos, _ = mf.trace_combos(tr)
    table = trace.op_class_table(sim.SSDConfig(channels=channels, ways=ways))
    m, n = len(combos), layout.n_state
    mats = np.concatenate([mf.combo_matrices(table, combos, layout),
                           mf.maxplus_eye(n)[None]])
    gvec = np.concatenate([mf.combo_arrival_offsets(table, combos, layout),
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
    d = dict(mats=mats, gvec=gvec, wvec=wvec, idx=idx, arrivals=arr,
             extras=ext, s0=mf.init_state(layout),
             lengths=np.asarray(MANY_LENGTHS, np.int32))
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=card)
            for k, v in d.items()}


@pytest.mark.parametrize("with_arrivals", (False, True))
@pytest.mark.parametrize("with_faults", (False, True))
def test_many_kernel_bit_equal_to_plain(card, with_arrivals, with_faults):
    d = many_inputs(card)
    args = [d[k] for k in ("mats", "gvec", "idx", "arrivals", "s0",
                           "lengths")]
    side = dict(extras=d["extras"], wvec=d["wvec"]) if with_faults else {}
    before = LAUNCHES["many"]
    got = maxplus_fold_many_kernel(*args, with_arrivals=with_arrivals,
                                   **side)
    want = maxplus_fold_many_ref(*args, with_arrivals=with_arrivals, **side)
    torch.cuda.synchronize()
    assert LAUNCHES["many"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got[MANY_LENGTHS.index(0)], d["s0"])


def test_many_kernel_rejects_what_it_does_not_take(card):
    d = many_inputs(card)
    args = [d[k] for k in ("mats", "gvec", "idx", "arrivals", "s0",
                           "lengths")]

    def call(i, x):
        a = list(args)
        a[i] = x
        return maxplus_fold_many_kernel(*a)

    with pytest.raises(TypeError, match="float32"):
        call(0, args[0].double())
    with pytest.raises(TypeError, match="int32"):
        call(2, args[2].long())
    with pytest.raises(ValueError, match="shape"):
        call(3, args[3][:, :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(3, args[3].t().contiguous().t())
    with pytest.raises(ValueError, match="is on cpu"):
        call(4, args[4].cpu())
    with pytest.raises(ValueError, match="lengths out of range"):
        call(5, args[5] + args[2].shape[1])
    with pytest.raises(ValueError, match="idx out of range"):
        call(2, args[2] + args[0].shape[0])
    with pytest.raises(ValueError, match="together"):
        maxplus_fold_many_kernel(*args, extras=d["extras"])


def test_run_many_one_launch_equals_per_trace(card):
    fleet = [trace.mixed_trace(n, 4, 8, 0.7, seed=n) for n in (300, 77, 5)]
    table = trace.op_class_table(sim.SSDConfig(channels=4, ways=8))
    before = LAUNCHES["many"]
    got = ops.run_many_end_time_maxplus(table, fleet, device=card)
    assert LAUNCHES["many"] == before + 1
    want = [ops.trace_end_time_maxplus(table, t, device=card)
            for t in fleet]
    assert np.array_equal(got, np.asarray(want, np.float64))
