"""The hand-written CUDA kernels against their plain versions, on the
card: the (max,+) kernels (the per-design-point fold and the many-trace
fold), flash attention and the RG-LRU scan, and the LM serving path that
runs the last two.  This file imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace
from repro_torch.kernels.maxplus import compact, ops
from repro_torch.kernels.maxplus.kernel import (LAUNCHES,
                                                maxplus_compact_kernel,
                                                maxplus_fold_kernel,
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



# --- the two routes of the (max,+) kernels ----------------------------------
# A real dictionary meets the compact route's precondition; the same
# operands with -0.0 in s0's origin row (sign bit set) do not, so they take
# the dense route.  Each route must give the plain version's bits.

ROUTE_INPUTS = ("compact", "dense")


def refused_s0(s0):
    s0 = s0.clone()
    s0[..., -1] = -0.0
    return s0


def route_delta(before, branch):
    return {r: LAUNCHES[f"{branch}/{r}"] - before[f"{branch}/{r}"]
            for r in ROUTE_INPUTS}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("route", ROUTE_INPUTS)
def test_kernel_routes_bit_equal_to_plain(card, route, variant):
    d, t = inputs(card, seed=8)
    kw = {}
    if "indexed" in variant:
        kw["idx"] = d["idx"]
    if "energy" in variant:
        kw["energy"] = d["energy"]
    if "arrivals" in variant:
        kw.update({k: d[k] for k in ("arrivals", "gvec", "extras", "wvec")})
    s0 = d["s0"] + 1.5 if route == "compact" else refused_s0(d["s0"])
    branch = "indexed" if "indexed" in variant else "periodic"
    before = dict(LAUNCHES)
    got = maxplus_fold_kernel(d["mats"], s0, t_steps=t, **kw)
    want = maxplus_fold_ref(d["mats"], s0, t_steps=t, **kw)
    torch.cuda.synchronize()
    assert route_delta(before, branch) == {
        r: int(r == route) for r in ROUTE_INPUTS}
    assert LAUNCHES["prepass"] == before["prepass"] + 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("with_arrivals", (False, True))
@pytest.mark.parametrize("with_faults", (False, True))
@pytest.mark.parametrize("route", ROUTE_INPUTS)
def test_many_kernel_routes_bit_equal_to_plain(card, route, with_arrivals,
                                               with_faults):
    d = many_inputs(card, seed=4)
    if route == "dense":
        d["s0"] = refused_s0(d["s0"])
    args = [d[k] for k in ("mats", "gvec", "idx", "arrivals", "s0",
                           "lengths")]
    side = dict(extras=d["extras"], wvec=d["wvec"]) if with_faults else {}
    before = dict(LAUNCHES)
    got = maxplus_fold_many_kernel(*args, with_arrivals=with_arrivals,
                                   **side)
    want = maxplus_fold_many_ref(*args, with_arrivals=with_arrivals, **side)
    torch.cuda.synchronize()
    assert route_delta(before, "many") == {
        r: int(r == route) for r in ROUTE_INPUTS}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[MANY_LENGTHS.index(0)], d["s0"])


def test_many_compact_with_several_lanes_a_block(card):
    """More lanes than SMs: a block of the compact many-trace fold then
    holds several lanes (warps) sharing one copy of the dictionary."""
    rng = np.random.default_rng(9)
    d = many_inputs(card)
    m1, t = d["mats"].shape[0], 40
    b = 3 * torch.cuda.get_device_properties(card).multi_processor_count + 7
    lengths = rng.integers(0, t + 1, b).astype(np.int32)
    idx = np.full((b, t), m1 - 1, np.int32)
    for lane, ln in enumerate(lengths):
        idx[lane, :ln] = rng.integers(0, m1 - 1, ln)
    arr = np.cumsum(rng.exponential(9.0, (b, t)), axis=1).astype(np.float32)
    args = dict(mats=d["mats"], gvec=d["gvec"],
                idx=torch.as_tensor(idx, device=card),
                arrivals=torch.as_tensor(arr, device=card), s0=d["s0"],
                lengths=torch.as_tensor(lengths, device=card))
    before = LAUNCHES["many/compact"]
    got = maxplus_fold_many_kernel(**args)
    want = maxplus_fold_many_ref(**args)
    torch.cuda.synchronize()
    assert LAUNCHES["many/compact"] == before + 1
    assert torch.equal(got, want)


def test_energy_with_more_than_32_phases_takes_the_dense_route(card):
    d, t = inputs(card, b=2, t=64)
    energy = torch.rand((2, d["mats"].shape[1], 40), device=card)
    before = dict(LAUNCHES)
    got = maxplus_fold_kernel(d["mats"], d["s0"], t_steps=t, idx=d["idx"],
                              energy=energy)
    want = maxplus_fold_ref(d["mats"], d["s0"], t_steps=t, idx=d["idx"],
                            energy=energy)
    torch.cuda.synchronize()
    assert route_delta(before, "indexed") == {"compact": 0, "dense": 1}
    assert LAUNCHES["prepass"] == before["prepass"]      # ruled out by shape
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("what", ("fold", "many"))
def test_prepass_equals_twin(card, what):
    if what == "fold":
        d, t = inputs(card)
        sides = dict(gvec=d["gvec"], wvec=d["wvec"])
        checks = dict(s0=d["s0"], arrivals=d["arrivals"],
                      extras=d["extras"])
    else:
        d = many_inputs(card)
        sides = dict(gvec=d["gvec"], wvec=d["wvec"])
        checks = dict(s0=d["s0"], arrivals=d["arrivals"],
                      extras=d["extras"], lengths=d["lengths"])
    before = LAUNCHES["prepass"]
    rec, flag = maxplus_compact_kernel(d["mats"], **sides, **checks)
    torch.cuda.synchronize()
    assert LAUNCHES["prepass"] == before + 1
    twin, ok = compact.compact(d["mats"].cpu(), *(sides[k].cpu()
                                                  for k in ("gvec", "wvec")))
    assert ok and int(flag) == 0
    assert torch.equal(rec.cpu(), compact.pack(twin))


@pytest.mark.parametrize("name", ("random dense dictionary",
                                  "one negative entry",
                                  "a row with five finite entries",
                                  "an inf in extras", "-0.0 in s0",
                                  "NaN in an arrival past a lane's end"))
def test_prepass_refuses_what_the_twin_refuses(card, name):
    d, t = inputs(card, b=1, t=40)
    mats, extras, s0 = d["mats"].clone(), d["extras"].clone(), d["s0"]
    lengths = arrivals = None
    if name == "random dense dictionary":
        mats = torch.rand_like(mats) * 50
    elif name == "one negative entry":
        mats[0, 0, 0, 0] = -1.0
    elif name == "a row with five finite entries":
        row = int(d["wvec"][0, 0].argmax())
        spare = int((mats[0, 0, row] <= mf.NEG).nonzero()[0])
        mats[0, 0, row, spare] = 3.0
    elif name == "an inf in extras":
        extras[5] = float("inf")
    elif name == "-0.0 in s0":
        s0 = refused_s0(s0)
    else:                              # accepted: checked within lengths
        m = many_inputs(card)
        arrivals = m["arrivals"].clone()
        lane = MANY_LENGTHS.index(5)
        arrivals[lane, 5:] = float("nan")
        mats, lengths = m["mats"], m["lengths"]
        extras, s0 = m["extras"], m["s0"]
    _, flag = maxplus_compact_kernel(
        mats, d["gvec"] if lengths is None else None, None, s0=s0,
        arrivals=d["arrivals"] if lengths is None else arrivals,
        extras=extras, lengths=lengths)
    _, twin_flag = maxplus_compact_kernel(
        mats.cpu(), d["gvec"].cpu() if lengths is None else None, None,
        s0=s0.cpu(), arrivals=(d["arrivals"] if lengths is None
                               else arrivals).cpu(),
        extras=extras.cpu(), lengths=None if lengths is None
        else lengths.cpu())
    torch.cuda.synchronize()
    assert int(flag) == int(twin_flag) == (0 if lengths is not None else 1)

# --- flash attention and the RG-LRU scan ------------------------------------

# b, h, kvh, sq, sk, d, causal, window, dtype: tests/test_kernels.py's
# FLASH_CASES, then ragged lengths, RecurrentGemma's D = 256 with MQA and
# S > window, and a window with q_offset
FLASH_GPU_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, torch.float32),
    (1, 4, 1, 256, 256, 64, True, 64, torch.float32),
    (2, 2, 2, 128, 128, 32, False, None, torch.bfloat16),
    (1, 6, 2, 128, 256, 64, True, None, torch.float32),
    (1, 8, 8, 64, 64, 128, True, None, torch.float32),
    (1, 2, 1, 64, 64, 16, True, 16, torch.bfloat16),
    (2, 4, 1, 100, 100, 64, True, 37, torch.float32),
    (1, 3, 3, 1000, 1000, 128, True, None, torch.bfloat16),
    (2, 16, 1, 300, 300, 256, True, 128, torch.bfloat16),
    (1, 16, 1, 257, 257, 256, True, 64, torch.float32),
    (1, 4, 2, 70, 200, 64, True, 50, torch.float32),
    (1, 2, 1, 96, 96, 64, False, 20, torch.float32),
]
# float32: sums in another order; bfloat16: outputs rounded to bf16 (an
# ulp is 2^-7 of the magnitude) after sums in another order
FLASH_TOL = {torch.float32: 5e-5, torch.bfloat16: 2.5e-2}


def flash_inputs(card, case, seed=0):
    b, h, kvh, sq, sk, d, _, _, dtype = case
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card).to(dtype)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


@pytest.mark.parametrize("case", FLASH_GPU_CASES,
                         ids=[str(i) for i in range(len(FLASH_GPU_CASES))])
def test_flash_kernel_matches_plain(card, case):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference

    *_, causal, window, dtype = case
    q, k, v = flash_inputs(card, case)
    off = k.shape[2] - q.shape[2]
    before = dict(FK.LAUNCHES)
    got = FK.flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                  q_offset=off)
    want = attention_reference(q, k, v, causal=causal, window=window,
                               q_offset=off)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {**before, FK.route(dtype):
                           before[FK.route(dtype)] + 1}
    assert got.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    assert err <= FLASH_TOL[dtype] * scale, err


def test_flash_kernel_rows_without_a_valid_key(card):
    """Queries past every key and its window: the reference averages v
    uniformly over all keys, so the kernel visits every tile there."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro_torch.kernels.flash_attention.ref import attention_reference

    q, k, v = flash_inputs(card, (1, 2, 1, 80, 100, 64, True, 5,
                                  torch.float32))
    got = flash_attention_bhsd(q, k, v, window=5, q_offset=60)
    want = attention_reference(q, k, v, window=5, q_offset=60)
    assert float((got - want).abs().max()) <= FLASH_TOL[torch.float32]


def test_flash_kernel_reads_the_grouped_layout_in_place(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=card).manual_seed(1)
    b, s, kvh, grp, d = 2, 190, 2, 3, 64
    q = torch.randn((b, s, kvh, grp, d), generator=g, device=card)
    k = torch.randn((b, s, kvh, d), generator=g, device=card)
    v = torch.randn((b, s, kvh, d), generator=g, device=card)
    got = flash_attention(q, k, v, causal=True, window=70)
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True, window=70)
    assert got.shape == q.shape
    assert float((got.cpu() - want).abs().max()) <= FLASH_TOL[torch.float32]


def test_flash_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd

    q, k, v = flash_inputs(card, (1, 2, 1, 64, 64, 64, True, None,
                                  torch.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bhsd(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_bhsd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bhsd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_bhsd(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="window"):
        flash_attention_bhsd(q, k, v, window=0)
    with pytest.raises(ValueError, match="contiguous head"):
        flash_attention_bhsd(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="is on cpu"):
        flash_attention_bhsd(q, k.cpu(), v)


# --- the tensor-core route (bfloat16) ---------------------------------------

def tc_check(q, k, v, **kw):
    """The bf16 kernel against attention_reference within the bf16 bar,
    asserting one launch of the tensor-core route and none of the other."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference

    assert q.dtype == torch.bfloat16
    before = dict(FK.LAUNCHES)
    got = FK.flash_attention_bhsd(q, k, v, **kw)
    want = attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {**before, FK.TC: before[FK.TC] + 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    assert err <= FLASH_TOL[torch.bfloat16] * scale, err


TILE_EDGES = (1, 63, 64, 65, 127, 129, 1000)


@pytest.mark.parametrize("sk", TILE_EDGES)
@pytest.mark.parametrize("sq", TILE_EDGES)
def test_flash_tc_at_tile_edges(card, sq, sk):
    """Ragged Sq and Sk around the 64-row and 64-key tiles; queries end at
    the last key (q_offset = Sk - Sq) or, for Sq > Sk, start at 0."""
    q, k, v = flash_inputs(card, (1, 4, 2, sq, sk, 64, True, None,
                                  torch.bfloat16), seed=sq * 7 + sk)
    tc_check(q, k, v, causal=True, q_offset=max(sk - sq, 0))


@pytest.mark.parametrize("d", (64, 128, 256))
@pytest.mark.parametrize("window", (37, 2047))
@pytest.mark.parametrize("kvh", (1, 2), ids=("mqa", "gqa"))
def test_flash_tc_windows_not_aligned_to_a_tile(card, d, window, kvh):
    q, k, v = flash_inputs(card, (2, 4, kvh, 2100, 2100, d, True, window,
                                  torch.bfloat16), seed=d + window)
    tc_check(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("sq,sk,window", [(1, 1000, None), (1, 1000, 37),
                                          (17, 300, 64), (200, 700, None),
                                          (129, 4100, 2047)])
@pytest.mark.parametrize("d", (64, 128, 256))
def test_flash_tc_query_offset(card, sq, sk, window, d):
    """Decode-style Sq < Sk: the queries are the last Sq positions."""
    q, k, v = flash_inputs(card, (2, 8, 2, sq, sk, d, True, window,
                                  torch.bfloat16), seed=sq + sk + d)
    tc_check(q, k, v, causal=True, window=window, q_offset=sk - sq)


@pytest.mark.parametrize("d", (64, 256))
def test_flash_tc_rows_without_a_valid_key(card, d):
    """Queries past every key and its window, in bf16: such blocks visit
    every tile and average v uniformly, as the reference does."""
    q, k, v = flash_inputs(card, (1, 2, 1, 80, 100, d, True, 5,
                                  torch.bfloat16), seed=3)
    tc_check(q, k, v, window=5, q_offset=60)
    tc_check(q, k, v, causal=False, window=5, q_offset=300)


@pytest.mark.parametrize("d", (64, 128, 256))
def test_flash_tc_reads_the_grouped_layout_in_place(card, d):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=card).manual_seed(d)
    b, s, kvh, grp = 2, 300, 2, 3
    q, k, v = (torch.randn(shape, generator=g, device=card).bfloat16()
               for shape in ((b, s, kvh, grp, d), (b, s, kvh, d),
                             (b, s, kvh, d)))
    before = FK.LAUNCHES[FK.TC]
    got = flash_attention(q, k, v, causal=True, window=70)
    want = flash_attention(q.cpu().float(), k.cpu().float(), v.cpu().float(),
                           causal=True, window=70)
    assert FK.LAUNCHES[FK.TC] == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    err = float((got.cpu().float() - want).abs().max())
    assert err <= FLASH_TOL[torch.bfloat16] * max(1.0, float(want.abs().max()))


def test_flash_f32_takes_the_cuda_core_route(card):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference

    q, k, v = flash_inputs(card, (1, 4, 1, 300, 300, 256, True, 128,
                                  torch.float32))
    before = dict(FK.LAUNCHES)
    got = FK.flash_attention_bhsd(q, k, v, window=128)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {**before, FK.F32: before[FK.F32] + 1}
    want = attention_reference(q, k, v, window=128)
    assert float((got - want).abs().max()) <= FLASH_TOL[torch.float32] * max(
        1.0, float(want.abs().max()))


def test_flash_tc_rejects_strides_tma_cannot_take(card):
    """TMA needs 16-byte strides: a sequence stride of 68 bf16 values (136
    bytes) is refused before launch, never sent elsewhere."""
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v = flash_inputs(card, (1, 2, 1, 64, 64, 64, True, None,
                                  torch.bfloat16))
    wide = torch.zeros((1, 2, 64, 68), device=card, dtype=torch.bfloat16)
    wide[..., :64] = q
    before = dict(FK.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        FK.flash_attention_bhsd(wide[..., :64], k, v)
    assert FK.LAUNCHES == before


def _rglru_ring_edges():
    """(b, s, r, dtype) at the ring route's edges: S = 1, Tc - 1, Tc,
    Tc + 1 and 5 stages plus a ragged tail, for a channel tile C of 128,
    64 and 32 in each dtype, R a multiple of C or not, B > 1."""
    from repro_torch.kernels.rglru import plan as rglru_plan
    cases = []
    for b, r, dtype in ((4, 4096, torch.float32), (2, 4040, torch.float32),
                        (1, 4096, torch.float32), (40, 520, torch.float32),
                        (4, 4096, torch.bfloat16), (2, 4040, torch.bfloat16),
                        (3, 200, torch.bfloat16)):
        tc = rglru_plan.ring_plan(b, 1, r, dtype.itemsize).steps
        cases += [(b, s, r, dtype) for s in (1, tc - 1, tc, tc + 1,
                                             5 * tc + 7)]
    return cases


# b, s, r, dtype: ragged S, R not a multiple of 128, f32 and bf16, and the
# ring's edges; R = 37 in f32 and R = 100 in bf16 (row pitches of 148 and
# 200 bytes) take the simple route, every other case the ring
RGLRU_GPU_CASES = [(2, 512, 128, torch.float32), (3, 37, 100, torch.float32),
                   (2, 129, 200, torch.bfloat16), (1, 4096, 64, torch.float32),
                   (4, 1, 4096, torch.bfloat16), (2, 77, 37, torch.float32),
                   (2, 300, 100, torch.bfloat16), *_rglru_ring_edges()]


def _rglru_inputs(card, b, s, r, dtype, offset=0):
    g = torch.Generator(device=card).manual_seed(s + r)
    a = (0.85 + 0.149 * torch.rand((b, s, r), generator=g,
                                   device=card)).to(dtype)
    x = torch.randn((b, s, r), generator=g, device=card).to(dtype)
    if offset:      # views ``offset`` elements into their storage
        a, x = (torch.empty(t.numel() + offset, dtype=dtype, device=card)
                [offset:].view(b, s, r).copy_(t) for t in (a, x))
    return a, x


@pytest.mark.parametrize("b,s,r,dtype", RGLRU_GPU_CASES)
def test_rglru_kernel_bit_equal_to_plain(card, b, s, r, dtype):
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as rglru_plan
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    a, x = _rglru_inputs(card, b, s, r, dtype)
    route = (rglru_plan.RING if r * dtype.itemsize % 16 == 0
             else rglru_plan.SIMPLE)
    before = dict(RK.LAUNCHES)
    got = RK.rglru_scan_kernel(a, x)
    want = rglru_scan_ref(a, x)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["rglru_scan"] == before["rglru_scan"] + 1
    key = RK.ROUTE_KEYS[route]
    assert RK.LAUNCHES[key] == before[key] + 1
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_rglru_view_at_storage_offset_takes_the_simple_route(card, dtype):
    """A contiguous view one element into its storage has a base TMA
    cannot read: the data sends it to the simple kernel, bit-equal."""
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    a, x = _rglru_inputs(card, 2, 129, 4096, dtype, offset=1)
    assert a.data_ptr() % 16 and a.is_contiguous()
    before = dict(RK.LAUNCHES)
    got = RK.rglru_scan_kernel(a, x)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["rglru_scan/simple"] == before["rglru_scan/simple"] + 1
    assert RK.LAUNCHES["rglru_scan/ring"] == before["rglru_scan/ring"]
    assert torch.equal(got, rglru_scan_ref(a, x))


def test_rglru_ring_raises_on_a_plan_it_does_not_have(card, monkeypatch):
    """A ring plan the kernel was not built for (another Tc, shared memory
    or grid) is refused and raises; nothing falls back to the simple
    route, and no launch is counted."""
    import dataclasses

    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as rglru_plan

    a, x = _rglru_inputs(card, 2, 100, 4096, torch.float32)
    p = rglru_plan.ring_plan(2, 100, 4096, 4)
    before = dict(RK.LAUNCHES)
    for bad in (dataclasses.replace(p, steps=p.steps // 2),
                dataclasses.replace(p, smem_bytes=p.smem_bytes + 16),
                dataclasses.replace(p, grid=(p.grid[0] + 1, p.grid[1])),
                dataclasses.replace(p, stages=p.stages + 1)):
        with pytest.raises(RuntimeError, match="plan matches no"):
            RK.launch(a, x, torch.empty_like(a), bad)
    # through the public wrapper: a planner that disagrees with the kernel
    wrong = dataclasses.replace(p, steps=p.steps * 2)
    monkeypatch.setattr(rglru_plan, "plan", lambda *args: wrong)
    with pytest.raises(RuntimeError, match="ring kernel launch failed"):
        RK.rglru_scan_kernel(a, x)
    torch.cuda.synchronize()
    assert RK.LAUNCHES == before


def test_rglru_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rglru.kernel import rglru_scan_kernel

    a = torch.rand((2, 8, 16), device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan_kernel(a, a.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        rglru_scan_kernel(a, a[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_kernel(a.transpose(0, 1), a.transpose(0, 1))
    with pytest.raises(ValueError, match="is on cpu"):
        rglru_scan_kernel(a, a.cpu())


def test_smoke_model_on_the_card_runs_the_kernels(card):
    """RecurrentGemma SMOKE at float32 compute: the card's prefill (one
    attention and four RG-LRU layers, all through the kernels) and
    decode against the CPU's plain path on the same parameters (bar 1e-4
    of the largest logit: f32 sums in another order), and the card's
    attention on shifted positions and with a soft cap (K4's EXT
    instantiation) against the CPU's."""
    import dataclasses

    from repro_torch.configs.recurrentgemma_9b import SMOKE
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.models import attention, transformer

    cfg = dataclasses.replace(SMOKE, compute_dtype="f32")
    cpu_p = transformer.init_params(cfg, 0, device="cpu")
    card_p = _to(cpu_p, card)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32))
    fk, rk = FK.LAUNCHES[FK.F32], RK.LAUNCHES["rglru_scan"]
    with torch.inference_mode():
        got, gc = transformer.prefill(cfg, card_p, toks.to(card), max_seq=30)
        assert FK.LAUNCHES[FK.F32] == fk + 1     # f32 compute: CUDA cores
        assert RK.LAUNCHES["rglru_scan"] == rk + 4
        want, wc = transformer.prefill(cfg, cpu_p, toks, max_seq=30)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        for pos in range(21, 25):
            tok = want.argmax(-1).to(torch.int32)
            got, gc = transformer.decode_step(cfg, card_p, gc, tok.to(card),
                                              pos)
            want, wc = transformer.decode_step(cfg, cpu_p, wc, tok, pos)
            assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        spec = cfg.attn_spec(8)
        x = torch.randn((1, 6, cfg.d_model), device=card)
        p = _unit(card_p["unit"]["layer2"]["mixer"], 0)
        cpu_attn = _unit(cpu_p["unit"]["layer2"]["mixer"], 0)
        shifted = torch.arange(6, device=card, dtype=torch.int32)[None] + 2
        for sp, pos in ((spec, shifted),
                        (dataclasses.replace(spec, softcap=5.0),
                         shifted - 2)):
            before = dict(FK.EXT_LAUNCHES)
            got = attention.attn_full(p, sp, x, pos,
                                      compute_dtype=torch.float32)
            want = attention.attn_full(cpu_attn, sp, x.cpu(), pos.cpu(),
                                       compute_dtype=torch.float32)
            key = FK.EXT_KEYS[FK.F32]
            assert FK.EXT_LAUNCHES == {**before, key: before[key] + 1}
            assert float((got.cpu() - want).abs().max()) <= 1e-4 * max(
                1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", [(2, 8, 2, 100, 100, True, None),
                                  (1, 4, 1, 300, 300, True, 37),
                                  (1, 2, 2, 70, 200, True, None)])
def test_flash_head_dim_8_is_padded_and_launched(card, case, dtype):
    """D = 8 (granite-3-2b SMOKE): zero-padded to 16 and launched there
    with the scale of D = 8, one counted launch of the dtype's route."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference

    b, h, kvh, sq, sk, causal, window = case
    q, k, v = flash_inputs(card, (b, h, kvh, sq, sk, 8, causal, window,
                                  dtype), seed=sq + sk)
    before = dict(FK.LAUNCHES)
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    got = FK.flash_attention_bhsd(q, k, v, **kw)
    want = attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {**before, FK.route(dtype):
                           before[FK.route(dtype)] + 1}
    assert got.shape == q.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * max(1.0, float(want.float().abs().max()))


SLICE_H_SMOKES = ("qwen2-0.5b", "minicpm-2b", "granite-3-2b",
                  "starcoder2-3b", "llama4-maverick-400b-a17b",
                  "granite-moe-3b-a800m", "musicgen-medium", "qwen2-vl-2b",
                  "xlstm-350m")


def _near_ties(logits, k, rel=1e-5):
    top = torch.sort(logits, dim=-1, descending=True).values
    return top[..., k - 1] - top[..., k] <= rel * logits.abs().max()


def _placements(src, wtab, t):
    """[G, T, E] slot + 1 and weight of each token at each expert."""
    g, e, c = src.shape
    slot = torch.zeros((g, t + 1, e), dtype=torch.int64)
    w = torch.zeros((g, t + 1, e))
    gi, ei, ci = torch.meshgrid(torch.arange(g), torch.arange(e),
                                torch.arange(c), indexing="ij")
    slot[gi, src, ei] = ci + 1
    w[gi, src, ei] = wtab
    return slot[:, :t], w[:, :t]


def _hold_routes(card_calls, cpu_calls):
    """The margin rule on each MoE call's routing tables, card against
    CPU: on tokens whose k-th and (k+1)-th router logits differ by more
    than 1e-5 of the largest |logit|, the same experts and slots and
    weights within 2^-18; near-tie tokens under 1 %."""
    from repro_torch.models import moe

    assert len(card_calls) == len(cpu_calls) > 0
    for (*_, csrc, cw), (k, router, x, src, w) in zip(card_calls,
                                                       cpu_calls):
        logits = moe.router_logits(router, x)
        ties = _near_ties(logits, k)
        cs, cwt = _placements(csrc.cpu(), cw.cpu(), x.shape[1])
        ps, pwt = _placements(src, w, x.shape[1])
        assert torch.equal(cs[~ties], ps[~ties])
        assert float((cwt - pwt)[~ties].abs().max()) <= 2.0 ** -18
        assert int(ties.sum()) < 0.01 * ties.numel()


def _record_routes(monkeypatch):
    """Wraps ``apply_moe`` and ``_routing_tables``: per call, top_k, the
    router, the layer's input as grouped, and the tables."""
    from repro_torch.models import moe

    calls = []
    real_apply, real_tables = moe.apply_moe, moe._routing_tables

    def apply(p, spec, x, **kw):
        b, s, d = x.shape
        calls.append([spec.top_k, p["router"].cpu(),
                      (x if s > 1 else x.reshape(1, b, d)).float().cpu()])
        return real_apply(p, spec, x, **kw)

    def tables(ids, weights, spec, cap):
        out = real_tables(ids, weights, spec, cap)
        calls[-1] += list(out)
        return out

    monkeypatch.setattr(moe, "apply_moe", apply)
    monkeypatch.setattr(moe, "_routing_tables", tables)
    return calls


@pytest.mark.parametrize("arch", SLICE_H_SMOKES)
def test_slice_h_smoke_models_on_the_card_match_the_cpu(card, arch,
                                                        monkeypatch):
    """Each SMOKE model at float32 compute, the same parameters on both
    devices: prefill then four decode steps within 1e-4 of the largest
    logit of the CPU's plain path, greedy tokens identical; one launch of
    K4's CUDA-core route per attention layer of the prefill (granite-3-2b
    at D = 8, padded), none of K5; the MoE routing tables under the
    margin rule; qwen2-vl-2b with non-text M-RoPE ids."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch(arch).smoke, compute_dtype="f32")
    cpu_p = transformer.init_params(cfg, 0, device="cpu")
    card_p = _to(cpu_p, card)
    rng = np.random.default_rng(1)
    b, s = 2, 21
    if cfg.input_mode == "embeddings":
        x = torch.as_tensor(rng.standard_normal(
            (b, s + 4, cfg.d_model)).astype(np.float32))
    else:
        x = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (b, s)).astype(np.int32))
    ids = None
    if cfg.rope_kind == "mrope":    # 5 text tokens, a 4 x 4 patch grid
        text = torch.arange(5)
        rows, cols = torch.arange(16) // 4, torch.arange(16) % 4
        grid = torch.stack([torch.full((16,), 5), 5 + rows, 5 + cols])
        ids = torch.cat([torch.stack([text] * 3), grid],
                        dim=1).to(torch.int32)[:, None].expand(3, b, s)
    n_attn = cfg.num_units * sum(sp.mixer == "attn" for sp in cfg.pattern)
    calls = _record_routes(monkeypatch)
    with torch.inference_mode():
        fk, rk = dict(FK.LAUNCHES), dict(RK.LAUNCHES)
        got, gc = transformer.prefill(
            cfg, card_p, x[:, :s].to(card), max_seq=s + 4,
            position_ids=None if ids is None else ids.to(card))
        assert FK.LAUNCHES == {**fk, FK.F32: fk[FK.F32] + n_attn}
        assert RK.LAUNCHES == rk
        card_calls, calls[:] = list(calls), []
        want, wc = transformer.prefill(cfg, cpu_p, x[:, :s], max_seq=s + 4,
                                       position_ids=ids)
        if cfg.moe is not None:
            _hold_routes(card_calls, calls)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        top = int(ids.max()) + 1 if ids is not None else s
        for pos in range(s, s + 4):
            if cfg.input_mode == "embeddings":
                nxt = x[:, pos:pos + 1]
            else:
                tok = want[:, -1, :cfg.vocab_size].argmax(-1)
                assert torch.equal(
                    got[:, -1, :cfg.vocab_size].argmax(-1).cpu(), tok)
                nxt = tok[:, None].to(torch.int32)
            step_ids = (None if ids is None else torch.full(
                (3, b, 1), top + pos - s, dtype=torch.int32))
            got, gc = transformer.decode_step(
                cfg, card_p, gc, nxt.to(card), pos,
                position_ids=None if ids is None else step_ids.to(card))
            want, wc = transformer.decode_step(cfg, cpu_p, wc, nxt, pos,
                                               position_ids=step_ids)
            assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _unit(tree, u):
    return {k: _unit(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


# --- the request layer on the card -------------------------------------------
# The dispatch and completion folds are torch step loops on the session's
# device: on the card each must give the CPU's bits.  K1 prices the
# fault-extended arrival traces that a RequestStream lowers to.


def _faulty_ops(n_requests=1024, channels=8, ways=16, seed=1):
    from repro_torch.core import faults, workload
    load = workload.poisson_stream(n_requests, 3.0, read_fraction=0.7,
                                   pages_per_request=2, seed=seed)
    cls, arr, _, _ = workload.request_ops(load)
    table = trace.op_class_table(sim.SSDConfig(channels=channels, ways=ways))
    sampler = faults.FaultSampler(faults.FaultSpec(
        wear=1.0, rber_worn=3e-5, max_retries=4,
        retry_step_us=(500.0, 1000.0, 2000.0, 4000.0), jitter_us=1.0,
        erase_fail_prob=0.1, seed=7), channels, ways, table)
    ext, _, _ = sampler.sample(cls)
    assert sampler.retired.any() and len(cls) == 2048
    return table, cls, arr, ext, sampler.retired


@pytest.mark.parametrize("rule", sim.DISPATCH_RULES)
def test_dispatch_and_completions_on_the_card_equal_the_cpu(card, rule):
    table, cls, arr, ext, retired = _faulty_ops()
    cols = [np.asarray(getattr(table, f)) for f in (
        "cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
        "ctrl_us", "arb_us")]
    outs = []
    for dev in (card, torch.device("cpu")):
        outs.append(sim.dispatch_trace(
            *(torch.as_tensor(c, device=dev) for c in cols), cls, arr,
            n_channels=8, n_ways=16, rule=rule, extra_us=ext,
            retired=retired))
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)
    end, comp, chan, way, par = (x.cpu().numpy() for x in outs[0])
    assert not retired[chan, way].any()
    comps = []
    for dev in (card, torch.device("cpu")):
        comps.append(sim.trace_completions(
            *(torch.as_tensor(c, device=dev) for c in cols), cls, chan, way,
            par, arr, ext, n_channels=8, batched=False))
    assert torch.equal(comps[0][0].cpu(), comps[1][0])
    assert torch.equal(comps[0][1].cpu(), comps[1][1])
    # the replay folds the dispatched placement: the same completions
    assert np.array_equal(comps[1][1].numpy(), comp)


def test_k1_on_a_fault_extended_arrival_trace(card):
    """A RequestStream lowered by the stripe scheduler, with faults,
    hedges and remaps applied: K1 on its dictionary, arrivals and
    surcharges takes the compact route and gives the plain version's
    bits, end time and energy."""
    from repro_torch.core import faults, sched, workload
    cfg = sim.SSDConfig(channels=8, ways=16)
    table = trace.op_class_table(cfg)
    spec = faults.FaultSpec(wear=0.95, jitter_us=2.0, prog_fail_prob=0.02,
                            hedge_fraction=0.1, seed=17)
    load = workload.with_hedges(workload.poisson_stream(
        512, 1.5, read_fraction=0.7, pages_per_request=4, seed=0), 0.1,
        seed=17)
    low = sched.lower_static(load, 8, 16)
    t, _, sampler = sched.apply_faults(low.trace, spec, table)
    assert t.arrival_us is not None and t.extra_us is not None
    assert sampler.n_remap_ops > 0
    _, combos, idx, mats, s0, arrivals, gvec, extras, wvec = \
        ops._combo_setup([table], t, "eager", card)
    e = torch.as_tensor(np.stack([ops.combo_energy_uj(table, combos,
                                                      "proposed")]),
                        device=card)
    kw = dict(t_steps=t.n_ops, idx=idx, arrivals=arrivals, gvec=gvec,
              extras=extras, wvec=wvec)
    before = dict(LAUNCHES)
    got = maxplus_fold_kernel(mats, s0, **kw)
    got_e = maxplus_fold_kernel(mats, s0, energy=e, **kw)
    assert LAUNCHES["indexed/compact"] == before["indexed/compact"] + 2
    assert torch.equal(got, maxplus_fold_ref(mats, s0, **kw))
    for a, b in zip(got_e, maxplus_fold_ref(mats, s0, energy=e, **kw)):
        assert torch.equal(a, b)


# --- the log-depth engines on the card (plain torch, no kernel) -------------


def _prefix_inputs():
    """A 4 x 8 mixed trace with arrivals and surcharges, and 6 tables."""
    rng = np.random.default_rng(12)
    t = trace.mixed_trace(3000, 4, 8, 0.6, seed=12)
    t = trace.OpTrace(
        cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
        channels=4, ways=8,
        arrival_us=np.cumsum(rng.exponential(3.0, t.n_ops)).astype(
            np.float32),
        extra_us=np.where(rng.random(t.n_ops) < 0.1, rng.uniform(
            5, 60, t.n_ops), 0.0).astype(np.float32))
    tables = [trace.op_class_table(sim.SSDConfig(
        interface=k, cell=c, channels=4, ways=8))
        for c in ("slc", "mlc") for k in ("conv", "sync_only", "proposed")]
    return t, tables


@pytest.mark.parametrize("combine", ("chain", "assoc"))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_prefix_on_the_card_equals_the_cpu(card, combine, policy):
    """End times bit-equal to the CPU (the same float32 adds, an exact
    max), energies within 1e-6 (float32 sums in another order)."""
    from repro_torch import api
    t, tables = _prefix_inputs()
    ends = [api.sweep_tables(tables, t, policy=policy, combine=combine,
                             device=dev) for dev in (card, "cpu")]
    assert np.array_equal(*ends)
    res = [api.Simulator(sim.SSDConfig(cell="mlc", channels=4, ways=8,
                                       policy=policy), device=dev).run(
        t, engine="prefix", objective="all", segment_len=32)
        for dev in (card, "cpu")]
    assert res[0].end_us == res[1].end_us
    for f in ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j"):
        a, b = getattr(res[0].energy, f), getattr(res[1].energy, f)
        assert abs(a - b) <= 1e-6 * abs(b), f


def test_maxplus_matmul_routes_on_the_card(card, monkeypatch):
    """The running-max route (products too large for one sum tensor)
    equals the one-piece route and the CPU."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor((rng.random((64, 40, 40)) * 9).astype(np.float32))
    b = torch.as_tensor((rng.random((64, 40, 40)) * 9).astype(np.float32))
    cube = mf.maxplus_matmul(a.to(card), b.to(card))
    monkeypatch.setattr(mf, "MATMUL_CUBE_ELEMS", 0)
    loop = mf.maxplus_matmul(a.to(card), b.to(card))
    assert torch.equal(cube, loop)
    assert torch.equal(loop.cpu(), mf.maxplus_matmul(a, b))


@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_squaring_on_the_card_equals_the_cpu(card, policy):
    from repro_torch import api
    from repro_torch.core.interface import make_interface
    from repro_torch.core.nand import chip
    grid = [sim.page_op_params(make_interface(k), chip(c), m, w)
            for c in ("slc", "mlc") for k in ("conv", "proposed")
            for m in ("read", "write") for w in (1, 2, 4, 8, 16)]
    ways = np.asarray([1, 2, 4, 8, 16] * 8, np.int32)
    args = tuple(np.asarray([getattr(op, f) for op in grid]) for f in (
        "cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
        "ctrl_us", "data_bytes"))
    bw = [api.sweep_steady_bandwidth_mb_s(
        *args, ways, n_pages=1000, batched=policy == "batched",
        engine="squaring", device=dev) for dev in (card, "cpu")]
    assert np.array_equal(*bw)
    res = [api.Simulator(sim.SSDConfig(cell="mlc", channels=1, ways=8,
                                       policy=policy), device=dev).run(
        trace.steady_trace(777, 1, 8), engine="squaring", objective="all")
        for dev in (card, "cpu")]
    assert res[0].end_us == res[1].end_us
    assert res[0].energy.total_j == res[1].energy.total_j


# --- the FTL stage on the card ------------------------------------------------


def test_ftl_translation_on_the_card_equals_the_cpu(card):
    """The translation machine on the card (eager warm-up, then replays
    of the captured graph chunk) op-for-op equal to the CPU's machine and
    to the numpy host translator, stats and final drive state included."""
    from repro_torch.core import ftl, ftl_scan, workload
    for policy in ftl.GC_POLICIES:
        spec = ftl.FTLSpec(blocks=64, pages_per_block=16, overprovision=0.25,
                           gc_policy=policy, precondition=True)
        load = workload.aging_stream(1500, 600, read_fraction=0.3,
                                     mean_interarrival_us=2.0, seed=11)
        got = ftl_scan.translate_scan(load, spec, device=card)
        cpu = ftl_scan.translate_scan(load, spec, device="cpu")
        host = ftl.translate(load, spec)
        for want in (cpu, host):
            for f in ("op_cls", "arrival_us", "payload", "request_id", "gc"):
                assert np.array_equal(getattr(got, f), getattr(want, f)), f
            assert got.stats == want.stats
            for f in ("l2p", "p2l", "valid_count", "full", "fill_seq",
                      "erase_count"):
                assert np.array_equal(getattr(got.state, f),
                                      getattr(want.state, f)), f
            assert list(got.state.free) == list(want.state.free)


def test_k1_on_an_ftl_trace(card, monkeypatch):
    """An FTL query on ``engine="cuda"``: K1 prices the 7-class
    GC-translated trace; its first launch gives the plain version's bits,
    and the query answers as a CPU session does."""
    from repro_torch import api
    from repro_torch.core import ftl, workload
    calls = []
    real = ops.maxplus_fold_kernel

    def record(mats, s0, **kw):
        calls.append((mats.clone(), s0.clone(),
                      {k: v for k, v in kw.items() if k != "out"}))
        return real(mats, s0, **kw)
    monkeypatch.setattr(ops, "maxplus_fold_kernel", record)
    spec = ftl.FTLSpec(blocks=64, pages_per_block=32, overprovision=0.25,
                       precondition=True)
    load = workload.overwrite_stream(1200, 900, read_fraction=0.3, seed=7)
    cfg = sim.SSDConfig(channels=8, ways=16)
    got = api.Simulator(cfg, device=card).run(load, ftl=spec, engine="cuda",
                                              objective="all")
    want = api.Simulator(cfg, device="cpu").run(load, ftl=spec,
                                                engine="cuda",
                                                objective="all")
    assert got.gc_op_count > 0 and got.fresh_mb_s is not None
    assert (got.end_us, got.waf, got.fresh_mb_s) == (want.end_us, want.waf,
                                                     want.fresh_mb_s)
    mats, s0, kw = calls[0]
    assert mats.device.type == "cuda" and mats.shape[1] > 1
    assert torch.equal(real(mats, s0, **kw), maxplus_fold_ref(mats, s0, **kw))


def test_ftl_sweep_on_the_card_equals_the_cpu(card):
    from repro_torch import api
    from repro_torch.core import ftl, workload
    specs = [ftl.FTLSpec(blocks=64, pages_per_block=16, overprovision=op,
                         gc_policy=g, precondition=True)
             for op in (0.15, 0.3) for g in ftl.GC_POLICIES]
    load = workload.overwrite_stream(500, 300, read_fraction=0.2, seed=5)
    cfg = sim.SSDConfig(cell="mlc", channels=2, ways=4)
    ends = [api.Simulator(cfg, device=dev).sweep(None, load, ftl=specs)
            for dev in (card, "cpu")]
    assert np.array_equal(*ends)


# --- the storage tier on the card --------------------------------------------


def test_storage_estimates_on_the_card_equal_the_cpu(card):
    """``estimate_trace`` prices through the scan engine, so a card
    session answers with the CPU session's bits, every field."""
    from repro_torch.storage import ssd_model
    cfg = sim.SSDConfig(cell="mlc", channels=2, ways=8)
    t = trace.datapipe_trace(1 << 30, cfg, hedge_fraction=0.05)
    got, want = (ssd_model.estimate_trace(t, cfg, total_bytes=1 << 30,
                                          device=dev)
                 for dev in (card, "cpu"))
    assert got == want
    io = [ssd_model.compare_interfaces(5 << 30, "write", channels=2, ways=8,
                                       device=dev) for dev in (card, "cpu")]
    assert io[0] == io[1]


def test_checkpoint_of_card_tensors_restores_bit_equal(card, tmp_path):
    from repro_torch.storage import checkpoint
    gen = torch.Generator(device=card).manual_seed(3)
    state = {"w": torch.randn(300, 70, device=card, generator=gen),
             "h": torch.randn(5000, device=card, generator=gen).to(
                 torch.bfloat16),
             "layers": [{"k": torch.randn(8, 4, device=card, generator=gen
                                          ).to(torch.bfloat16)},
                        (torch.arange(7, dtype=torch.int32, device=card),)]}
    eng = checkpoint.CheckpointEngine(tmp_path, channels=3, ways=2,
                                      device=card)
    saved_w = state["w"].clone()
    eng.save(7, state)
    state["w"].add_(1.0)            # after the snapshot: not written
    res = eng.wait()
    assert res.step == 7
    step, host, _ = eng.restore(template=state)
    placed = checkpoint.place_on_device(host, card)
    want = checkpoint._flatten(state)
    want["w"] = saved_w
    raw = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
           torch.int32: torch.int32}
    for k, v in checkpoint._flatten(placed).items():
        assert v.device.type == "cuda" and v.dtype == want[k].dtype
        assert torch.equal(v.view(raw[v.dtype]),
                           want[k].view(raw[v.dtype])), k
    cpu = checkpoint.CheckpointEngine(tmp_path / "cpu", channels=3, ways=2,
                                      device="cpu")
    cpu.save(7, host, blocking=True)
    assert cpu.wait().modeled == res.modeled


def test_k1_prices_a_storage_trace_within_drift_of_scan(card):
    from repro_torch import api
    cfg = sim.SSDConfig(cell="mlc", channels=4, ways=8)
    t = trace.checkpoint_trace(3 << 30, cfg)
    s = api.Simulator(cfg, device=card)
    before = dict(LAUNCHES)
    got = s.run(t, engine="cuda", objective="all")
    assert LAUNCHES["indexed/compact"] > before["indexed/compact"]
    assert LAUNCHES["indexed/dense"] == before["indexed/dense"]
    want = s.run(t, objective="all")
    bar = t.n_ops * 2.0 ** -24
    assert abs(got.end_us - want.end_us) <= bar * want.end_us
    for f in ("cmd_j", "io_j", "ecc_j", "ctrl_j", "array_j"):
        a, b = getattr(got.energy, f), getattr(want.energy, f)
        assert abs(a - b) <= bar * abs(b), f


# --- the gradients: K4's backward kernels, K5 run backwards ------------------

# b, h, kvh, s, d, causal, window, dtype: the small cases of 8a's kind and
# the slice's shape classes (D 8 -> 16, 64, 128, 256; no window and windows
# within S; groups 1, 7, 12, 16; ragged S 100 and 1000), then bf16 cases of
# the tensor-core route at every head dim: causal and not, windows that
# bite, ragged S, S = 1, groups 1-16, B = 2
FLASH_BWD_CASES = [
    (2, 4, 2, 128, 64, True, None, torch.float32),
    (1, 4, 1, 256, 64, True, 64, torch.float32),
    (2, 2, 2, 128, 32, True, None, torch.bfloat16),
    (1, 8, 8, 64, 128, True, None, torch.float32),
    (1, 2, 1, 64, 16, True, 16, torch.bfloat16),
    (2, 4, 1, 100, 8, True, 37, torch.float32),
    (1, 14, 2, 1000, 64, True, None, torch.bfloat16),
    (1, 14, 2, 1000, 64, True, None, torch.float32),
    (1, 12, 1, 100, 128, True, None, torch.bfloat16),
    (1, 16, 1, 1000, 256, True, 300, torch.bfloat16),
    (1, 16, 1, 100, 256, True, None, torch.float32),
    (2, 4, 4, 200, 16, False, None, torch.bfloat16),
    (1, 8, 2, 130, 32, True, 50, torch.bfloat16),
    (1, 4, 1, 96, 32, False, 20, torch.bfloat16),
    (2, 14, 2, 1000, 64, True, 300, torch.bfloat16),
    (1, 16, 1, 333, 64, True, None, torch.bfloat16),
    (1, 1, 1, 1, 64, True, None, torch.bfloat16),
    (1, 6, 3, 257, 128, True, 100, torch.bfloat16),
    (1, 2, 2, 300, 128, False, None, torch.bfloat16),
    (1, 4, 1, 65, 256, True, None, torch.bfloat16),
    (2, 2, 1, 200, 256, False, 64, torch.bfloat16),
    # query chunks (a ninth field: Sq rows at q_offset, s the keys Sk), the
    # sequence-sharded attention's: both dtypes, D 64 and 256, causal and
    # window, GQA; the last chunk of four, a middle one whose later keys
    # no row sees, the first, and ragged chunks
    (1, 14, 2, 1024, 64, True, None, torch.bfloat16, (256, 768)),
    (1, 14, 2, 1024, 64, True, None, torch.bfloat16, (256, 256)),
    (1, 14, 2, 1024, 64, True, None, torch.float32, (256, 512)),
    (2, 4, 2, 300, 64, True, 50, torch.bfloat16, (100, 137)),
    (1, 6, 3, 257, 64, True, 37, torch.float32, (65, 0)),
    (1, 16, 1, 1024, 256, True, 300, torch.bfloat16, (256, 512)),
    (1, 16, 1, 512, 256, True, None, torch.float32, (128, 128)),
    (1, 4, 1, 200, 256, False, 64, torch.bfloat16, (50, 150)),
    (1, 8, 2, 130, 64, False, None, torch.float32, (33, 90)),
]
# relative to each output's largest magnitude.  float32: sums in another
# order; bfloat16: every output rounded to bf16 (half an ulp is 2^-9 of an
# element), after the forward's bf16 output and lse
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def flash_bwd_inputs(card, case, seed=0):
    """q, k, v, do of a case; a chunk case's q and do hold its Sq rows."""
    b, h, kvh, s, d, *_, dtype = case[:8]
    sq = case[8][0] if len(case) > 8 else s
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=card).to(dtype)
                   for shape in ((b, h, sq, d), (b, kvh, s, d),
                                 (b, kvh, s, d), (b, h, sq, d)))
    return q, k, v, do


def flash_bwd_kw(case) -> dict:
    """The mask arguments of a case: causal, window and q_offset."""
    return dict(causal=case[5], window=case[6],
                q_offset=case[8][1] if len(case) > 8 else 0)


def unseen_keys(case) -> torch.Tensor:
    """[Sk] bool: the keys no query row of the case keeps."""
    kw = flash_bwd_kw(case)
    sq, sk = q_rows(case), case[3]
    qp = kw["q_offset"] + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None]
    ok = torch.ones((sq, sk), dtype=torch.bool)
    if kw["causal"]:
        ok &= qp >= kp
    if kw["window"] is not None:
        ok &= qp - kp < kw["window"]
    return ~ok.any(0)


def q_rows(case) -> int:
    return case[8][0] if len(case) > 8 else case[3]


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=[str(i) for i in range(len(FLASH_BWD_CASES))])
def test_flash_backward_matches_plain(card, case):
    """lse and dq, dk, dv of the backward kernels against the plain
    versions (lse from q and k alone), two calls bit-equal, each through
    the dtype's route; a query chunk's keys that no row sees get dk and
    dv exactly 0."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference)

    dtype = case[7]
    kw = flash_bwd_kw(case)
    q, k, v, do = flash_bwd_inputs(card, case)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    assert torch.equal(o, FK.flash_attention_bhsd(q, k, v, **kw))
    assert rel_err(lse, attention_lse_reference(q, k, **kw)) < 1e-5
    before = dict(FK.BACKWARD_LAUNCHES)
    got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    again = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want = attention_backward_reference(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    key = FK.BWD_ROUTES[FK.route(dtype)]
    assert FK.BACKWARD_LAUNCHES == {**before, FK.BWD: before[FK.BWD] + 2,
                                    key: before[key] + 2}
    for name, x, y, z in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == dtype and x.shape == z.shape
        assert torch.equal(x, y), name
        assert rel_err(x, z) < FLASH_BWD_TOL[dtype], (name, rel_err(x, z))
    unseen = unseen_keys(case).to(card)
    if len(case) > 8 and case[8][1] + case[8][0] < case[3] and kw["causal"]:
        assert bool(unseen.any())        # the chunk leaves keys unseen
    for x in got[1:]:
        assert not bool(x[:, :, unseen].any())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_gradient_through_the_grouped_layout(card, dtype):
    """``ops.flash_attention`` with autograd on the model's grouped layout:
    the Function's gradients on the card against the CPU's plain ones."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=card).to(dtype)
               for shape in ((2, 150, 2, 3, 64), (2, 150, 2, 64),
                             (2, 150, 2, 64)))
    do = torch.randn(q.shape, generator=g, device=card).to(dtype)
    before = FK.BACKWARD_LAUNCHES[FK.BWD]
    grads = []
    for xs in ((q, k, v), tuple(x.cpu().float() for x in (q, k, v))):
        xs = [x.clone().requires_grad_(True) for x in xs]
        out = flash_attention(*xs, window=70)
        grads.append(torch.autograd.grad(out, xs, do.to(out)))
    torch.cuda.synchronize()
    for x, y in zip(*grads):
        assert x.shape == y.shape
        assert rel_err(x.cpu(), y) < FLASH_BWD_TOL[dtype]
    assert FK.BACKWARD_LAUNCHES[FK.BWD] == before + 1


def test_flash_backward_route_by_dtype(card):
    """bfloat16 goes through the tensor-core backward, float32 through the
    CUDA-core one, as the per-route counts show; the twin's shared memory
    is the kernels' own."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import tiles

    for dtype, name in ((torch.bfloat16, FK.TC), (torch.float32, FK.F32)):
        q, k, v, do = flash_bwd_inputs(card, (1, 4, 2, 150, 64, True, 40,
                                              dtype))
        o, lse = FK.flash_attention_bhsd(q, k, v, window=40, with_lse=True)
        before = dict(FK.BACKWARD_LAUNCHES)
        FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, window=40)
        torch.cuda.synchronize()
        other = FK.BWD_ROUTES[FK.F32 if name == FK.TC else FK.TC]
        assert FK.BACKWARD_LAUNCHES[FK.BWD_ROUTES[name]] == (
            before[FK.BWD_ROUTES[name]] + 1)
        assert FK.BACKWARD_LAUNCHES[other] == before[other]
        assert FK.BACKWARD_LAUNCHES[FK.BWD] == before[FK.BWD] + 1
    for d in FK.HEAD_DIMS:
        assert FK.bwd_smem_bytes(d) == tiles.tc_bwd_smem_bytes(d)


def test_flash_backward_tc_rejects_strides_tma_cannot_take(card):
    """A bf16 do whose sequence stride is 68 values (136 bytes) cannot be
    read by TMA: the backward raises before any launch, never sending it
    to the CUDA-core kernels."""
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, do = flash_bwd_inputs(card, (1, 2, 1, 64, 64, True, None,
                                          torch.bfloat16))
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True)
    wide = torch.zeros((1, 2, 64, 68), device=card, dtype=torch.bfloat16)
    wide[..., :64] = do
    before = dict(FK.BACKWARD_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        FK.flash_attention_bwd_bhsd(q, k, v, o, wide[..., :64], lse)
    assert FK.BACKWARD_LAUNCHES == before


def test_flash_backward_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention import kernel as FK

    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)

    q, k, v, do = flash_bwd_inputs(card, (1, 2, 1, 64, 64, True, None,
                                          torch.float32))
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True)
    # Sq < Sk is a query chunk: at q_offset 32 it matches the plain version
    args = (q[:, :, :32], k, v)
    oc, lc = FK.flash_attention_bhsd(*args, q_offset=32, with_lse=True)
    got = FK.flash_attention_bwd_bhsd(*args, oc, do[:, :, :32], lc,
                                      q_offset=32)
    want = attention_backward_reference(*args, oc, do[:, :, :32],
                                        q_offset=32)
    for x, z in zip(got, want):
        assert rel_err(x, z) < FLASH_BWD_TOL[torch.float32]
    for off in (33, -1):                   # past the keys, or before them
        with pytest.raises(ValueError, match="q_offset"):
            FK.flash_attention_bwd_bhsd(*args, oc, do[:, :, :32], lc,
                                        q_offset=off)
    with pytest.raises(ValueError, match="q_offset"):   # Sq > Sk
        FK.flash_attention_bwd_bhsd(q, k[:, :, :32], v[:, :, :32], o, do,
                                    lse)
    with pytest.raises(TypeError, match="is torch.bfloat16"):
        FK.flash_attention_bwd_bhsd(q, k, v, o, do.bfloat16(), lse)
    with pytest.raises(ValueError, match="lse"):
        FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse.double())


@pytest.mark.parametrize("b,s,r,dtype", RGLRU_GPU_CASES[:8])
def test_rglru_backward_bit_equal_to_plain(card, b, s, r, dtype):
    """K5's reverse mode, one launch of the route the data picks (R = 37
    f32 and R = 100 bf16 take the simple one), bit-equal to the plain
    backward."""
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as rglru_plan
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref

    a, x = _rglru_inputs(card, b, s, r, dtype)
    h = RK.rglru_scan_kernel(a, x)
    dh = torch.randn(a.shape, device=card).to(dtype)
    route = (rglru_plan.RING if r * dtype.itemsize % 16 == 0
             else rglru_plan.SIMPLE)
    before = dict(RK.LAUNCHES)
    bwd = RK.BACKWARD_LAUNCHES[RK.BWD]
    da, db = RK.rglru_scan_backward(a, h, dh)
    want_da, want_db = rglru_scan_backward_ref(a, h, dh)
    torch.cuda.synchronize()
    key = RK.ROUTE_KEYS[route]
    assert RK.LAUNCHES == {**before, key: before[key] + 1,
                           RK.TOTAL: before[RK.TOTAL] + 1}
    assert RK.BACKWARD_LAUNCHES[RK.BWD] == bwd + 1
    assert torch.equal(da, want_da) and torch.equal(db, want_db)


def _rglru_reverse_ring_edges():
    """(b, s, r, dtype) at the reverse ring's edges: S = 1, Tc - 1, Tc,
    Tc + 1 and 5 stages plus a ragged tail for its own Tc (a stage of
    three boxes), the forward edges' (b, r, dtype)."""
    from repro_torch.kernels.rglru import plan as rglru_plan
    cases = []
    for b, r, dtype in ((4, 4096, torch.float32), (2, 4040, torch.float32),
                        (1, 4096, torch.float32), (40, 520, torch.float32),
                        (4, 4096, torch.bfloat16), (2, 4040, torch.bfloat16),
                        (3, 200, torch.bfloat16)):
        tc = rglru_plan.ring_bwd_plan(b, 1, r, dtype.itemsize).steps
        cases += [(b, s, r, dtype) for s in (1, tc - 1, tc, tc + 1,
                                             5 * tc + 7)]
    return cases


@pytest.mark.parametrize("b,s,r,dtype", _rglru_reverse_ring_edges())
def test_rglru_backward_at_the_reverse_ring_edges(card, b, s, r, dtype):
    """The reverse ring (boxes from the last tile down, zero-filled rows
    past S and below 0) bit-equal to the plain backward at its edges."""
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref

    a, x = _rglru_inputs(card, b, s, r, dtype)
    h = RK.rglru_scan_kernel(a, x)
    dh = torch.randn(a.shape, device=card).to(dtype)
    ring = RK.LAUNCHES["rglru_scan/ring"]
    da, db = RK.rglru_scan_backward(a, h, dh)
    want_da, want_db = rglru_scan_backward_ref(a, h, dh)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["rglru_scan/ring"] == ring + 1
    assert torch.equal(da, want_da) and torch.equal(db, want_db)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_rglru_backward_view_at_storage_offset_takes_the_simple_route(
        card, dtype):
    """dh one element into its storage: TMA cannot read it, so the
    reverse mode takes the simple kernel, bit-equal all the same."""
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref

    a, x = _rglru_inputs(card, 2, 129, 4096, dtype)
    h = RK.rglru_scan_kernel(a, x)
    dh = torch.empty(a.numel() + 1, dtype=dtype, device=card)[1:].view(
        a.shape).copy_(torch.randn(a.shape, device=card))
    before = dict(RK.LAUNCHES)
    da, db = RK.rglru_scan_backward(a, h, dh)
    want_da, want_db = rglru_scan_backward_ref(a, h, dh)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["rglru_scan/simple"] == before["rglru_scan/simple"] + 1
    assert RK.LAUNCHES["rglru_scan/ring"] == before["rglru_scan/ring"]
    assert torch.equal(da, want_da) and torch.equal(db, want_db)


def test_rglru_gradient_through_the_op(card):
    """``ops.rglru_linear_scan`` with autograd: the card's gradients
    bit-equal to the CPU's plain ones."""
    from repro_torch.kernels.rglru.ops import rglru_linear_scan

    a, x = _rglru_inputs(card, 2, 300, 256, torch.float32)
    dh = torch.randn(a.shape, device=card)
    grads = []
    for aa, xx, gg in ((a, x, dh), (a.cpu(), x.cpu(), dh.cpu())):
        aa, xx = aa.clone().requires_grad_(True), xx.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(rglru_linear_scan(aa, xx), (aa, xx),
                                         gg))
    for got, want in zip(*grads):
        assert torch.equal(got.cpu(), want)


class _Allocs(TorchDispatchMode):
    """(shape, dtype) of every fresh allocation (``empty*``) made."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.empty.memory_format,
                    torch.ops.aten.empty_like.default,
                    torch.ops.aten.empty_strided.default):
            self.made.append((tuple(out.shape), out.dtype))
        return out


@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_meta_twins_allocate_what_the_card_allocates(card, case):
    """The K4 and K5 wrappers on meta tensors (the dry run's plan) make
    the allocations they make on the card — K4's output and lse, the
    backward's gradients and its delta / lse / split-sum scratch, K5's h
    and da / db — in shapes, dtypes and order."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK

    b, h, kvh, s, d, causal, window, dtype = case[:8]
    kw = flash_bwd_kw(case)
    q, k, v, do = flash_bwd_inputs(card, case)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    a = torch.rand((b, s, 4 * d), device=card).to(dtype)
    hs = RK.rglru_scan_kernel(a, a)
    made = {}
    for dev in (card, torch.device("meta")):
        args = [x.to(dev) for x in (q, k, v, o, do, lse, a, hs)]
        with _Allocs() as allocs:
            out = FK.flash_attention_bhsd(*args[:3], with_lse=True, **kw)
            grads = FK.flash_attention_bwd_bhsd(*args[:6], **kw)
            scan = RK.rglru_scan_kernel(args[6], args[6])
            dscan = RK.rglru_scan_backward(args[6], args[7], args[7])
        made[dev.type] = allocs.made
        outs = [(tuple(x.shape), x.dtype) for x in (*out, *grads, scan,
                                                    *dscan)]
        made[dev.type + "/outs"] = outs
    torch.cuda.synchronize()
    assert made["meta"] == made["cuda"]
    assert made["meta/outs"] == made["cuda/outs"]


# --- K4 with caller positions and the soft cap (the EXT instantiations) ----

def packed(b, s, seed, lo=30, hi=200, device="cuda"):
    """[b, s] int32 positions of documents of lo..hi tokens, restarting at
    0 in each (the last one cut)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        j = 0
        while j < s:
            n = int(rng.integers(lo, hi + 1))
            out[i, j:j + n] = np.arange(min(n, s - j))
            j += n
    return torch.as_tensor(out, device=device)


EXT_CASES = [(dt, d, g, window, cap)
             for dt in (torch.float32, torch.bfloat16)
             for d in (16, 64, 128, 256) for g in (1, 7)
             for window, cap in ((None, None), (90, 2.0), (None, 50.0))]


@pytest.mark.parametrize("case", EXT_CASES, ids=[
    f"{str(c[0])[6:]}-d{c[1]}-g{c[2]}-w{c[3]}-cap{c[4]}" for c in EXT_CASES])
def test_flash_positions_and_softcap_match_plain(card, case):
    """Packed documents (positions restarting, so queries keep keys of
    later index) with and without a window and a soft cap: the forward,
    its lse and the backward of the dtype's route against the plain
    versions, each call counted on the route and as EXT."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference,
        attention_reference)

    dtype, d, g, window, cap = case
    kvh = 2 if g == 1 else 1
    q, k, v, do = flash_bwd_inputs(card, (2, kvh * g, kvh, 333, d, True,
                                          window, dtype), seed=d + g)
    pos = packed(2, 333, seed=d)
    kw = dict(causal=True, window=window, q_pos=pos, k_pos=pos, softcap=cap)
    name = FK.route(dtype)
    before = dict(FK.EXT_LAUNCHES)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    again = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want = attention_reference(q, k, v, **kw)
    want_lse = attention_lse_reference(q, k, **kw)
    want_g = attention_backward_reference(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    fwd, bwd = FK.EXT_KEYS[name], FK.EXT_KEYS[FK.BWD_ROUTES[name]]
    assert FK.EXT_LAUNCHES == {**before, fwd: before[fwd] + 1,
                               bwd: before[bwd] + 2}
    err = float((o.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    assert rel_err(lse, want_lse) < 1e-5
    for x, y, z in zip(got, again, want_g):
        assert torch.equal(x, y)
        assert rel_err(x, z) < FLASH_BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_rows_without_a_kept_key_under_positions(card, dtype):
    """Keys shifted 40 positions past some queries: those rows keep no key
    and average v over every key (their block visits every tile); their
    lse lies below -5e29 (the backward's test for such a row: P = 1 / S,
    dS = 0), the other rows' within 1e-5."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference,
        attention_reference)

    q, k, v, do = flash_bwd_inputs(card, (2, 4, 2, 300, 64, True, 50,
                                          dtype))
    k_pos = torch.arange(300, device=card, dtype=torch.int32)[None].expand(
        2, 300) + 7
    q_pos = k_pos - 40 * (torch.arange(300, device=card) % 5 == 0)
    kw = dict(window=50, q_pos=q_pos, k_pos=k_pos, softcap=3.0)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    want_lse = attention_lse_reference(q, k, **kw)
    keyless = want_lse < -1e29
    assert bool(keyless.any())
    want = attention_reference(q, k, v, **kw)
    got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want_g = attention_backward_reference(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    err = float((o.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    assert bool((lse[keyless] < -5e29).all())
    assert rel_err(lse[~keyless], want_lse[~keyless]) < 1e-5
    for x, z in zip(got, want_g):
        assert rel_err(x, z) < FLASH_BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_softcap_alone_and_arange_positions(card, dtype):
    """A cap alone runs the EXT instantiation on positions ``q_offset +
    arange`` / ``arange`` built on the card (with and without an offset);
    positions ``arange`` without a cap give the index path's output (f32:
    equal up to the sums' order)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference

    q, k, v = flash_inputs(card, (2, 6, 2, 200, 200, 64, True, 30, dtype))
    before = FK.EXT_LAUNCHES[FK.EXT_KEYS[FK.route(dtype)]]
    for off in (0, 50):
        kw = dict(window=30, softcap=4.0, q_offset=off)
        got = FK.flash_attention_bhsd(q[:, :, off:], k, v, **kw)
        want = attention_reference(q[:, :, off:], k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= FLASH_TOL[dtype] * max(1.0,
                                             float(want.float().abs().max()))
    ar = torch.arange(200, device=card, dtype=torch.int64)[None].expand(2, 200)
    by_pos = FK.flash_attention_bhsd(q, k, v, window=30, q_pos=ar, k_pos=ar)
    index = FK.flash_attention_bhsd(q, k, v, window=30)
    torch.cuda.synchronize()
    assert FK.EXT_LAUNCHES[FK.EXT_KEYS[FK.route(dtype)]] == before + 3
    err = float((by_pos.float() - index.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * max(1.0, float(index.float().abs().max()))


def test_flash_positions_at_the_windowed_training_shape(card):
    """Phase 14d's shape (q [1, 16, 4096, 256] bf16, one kv head, window
    2048) on packed documents, where the window and the positions
    interact: forward, lse and backward against the plain versions."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference,
        attention_reference)

    q, k, v, do = flash_bwd_inputs(card, (1, 16, 1, 4096, 256, True, 2048,
                                          torch.bfloat16), seed=14)
    pos = packed(1, 4096, seed=4, lo=256, hi=2048)
    kw = dict(window=2048, q_pos=pos, k_pos=pos)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    want = attention_reference(q, k, v, **kw)
    err = float((o.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[torch.bfloat16] * max(
        1.0, float(want.float().abs().max()))
    del want
    assert rel_err(lse, attention_lse_reference(q, k, **kw)) < 1e-5
    got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want_g = attention_backward_reference(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for x, z in zip(got, want_g):
        assert rel_err(x, z) < FLASH_BWD_TOL[torch.bfloat16]


def test_flash_pos_scratch_size_is_the_kernels(card):
    """The plan's band the wrapper allocates (``tiles.pos_scratch_ints``)
    is the size the C side lays out."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import tiles

    lib = FK._ext_library()
    for b, sq, sk in ((1, 1, 1), (2, 100, 300), (3, 4096, 4096),
                      (1, 129, 65)):
        assert lib.flash_attention_pos_scratch_ints(b, sq, sk) == \
            tiles.pos_scratch_ints(b, sq, sk)


PLAN_CASES = [(kind, causal, window) for kind in ("packed", "ties", "random")
              for causal, window in ((True, None), (True, 5), (False, 40))]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=["-".join(map(str, c)) for c in PLAN_CASES])
def test_flash_pos_band_matches_its_twin(card, case):
    """The pre-pass ``flash_pos_band`` on the card against ``tiles.
    pos_band`` (searchsorted on the CPU): every row's and key's band and
    the hull, for each batch entry; made once a (plan, causal, window)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import tiles
    from repro_torch.kernels.flash_attention.plan import PosPlan

    kind, causal, window = case
    b, sq, sk = 3, 300, 250
    g = torch.Generator().manual_seed(len(kind) + sq)
    if kind == "packed":
        q_pos = packed(b, sq, seed=3, lo=10, hi=90)
        k_pos = packed(b, sk, seed=4, lo=10, hi=90)
    else:
        span = 4 if kind == "ties" else 400
        q_pos, k_pos = (torch.randint(-span // 2, span, (b, n), generator=g)
                        .int().to(card) for n in (sq, sk))
    plan = PosPlan.build(q_pos, k_pos, sk=sk)
    before = FK.PREP_LAUNCHES[FK.BAND]
    band = FK.pos_band(plan, causal, window)
    assert FK.pos_band(plan, causal, window) is band
    assert FK.PREP_LAUNCHES[FK.BAND] == before + 1
    rows = band.view(b, -1).cpu()
    sqp, skp = tiles.pos_pad(sq), tiles.pos_pad(sk)
    for i in range(b):
        want = tiles.pos_band(q_pos[i].cpu(), k_pos[i].cpu(), causal=causal,
                              window=window)
        got = rows[i]
        assert got[:sq].tolist() == list(want.lo)
        assert got[sqp:sqp + sq].tolist() == list(want.hi)
        assert got[2 * sqp:2 * sqp + sk].tolist() == list(want.qlo)
        assert got[2 * sqp + skp:2 * sqp + skp + sk].tolist() == \
            list(want.qhi)
        first, last = got[2 * sqp + 2 * skp:][:2].tolist()
        assert (sq - first, last - 1) == want.hull   # kept as Sq - first,
        #                                              last + 1


TIE_CASES = [(dt, kind, window, cap) for dt in (torch.float32, torch.bfloat16)
             for kind in ("ties", "permuted")
             for window, cap in ((None, None), (60, 3.0), (None, 50.0))]


@pytest.mark.parametrize("case", TIE_CASES, ids=[
    f"{str(c[0])[6:]}-{c[1]}-w{c[2]}-cap{c[3]}" for c in TIE_CASES])
def test_flash_positions_with_ties_and_a_permutation(card, case):
    """Positions with heavy ties (a few distinct values, so the sorted
    band's edges fall inside runs of equal positions) and a random
    permutation of arange (the sorted order far from the index order):
    the EXT forward, its lse and backward against the plain versions, the
    backward deterministic."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference,
        attention_reference)

    dtype, kind, window, cap = case
    b, s = 2, 301
    q, k, v, do = flash_bwd_inputs(card, (b, 6, 2, s, 64, True, window,
                                          dtype), seed=7)
    g = torch.Generator().manual_seed(11)
    if kind == "ties":
        pos = torch.randint(0, 6, (b, s), generator=g)
    else:
        pos = torch.stack([torch.randperm(s, generator=g) for _ in range(b)])
    pos = pos.int().to(card)
    kw = dict(window=window, q_pos=pos, k_pos=pos, softcap=cap)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    again = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    want = attention_reference(q, k, v, **kw)
    want_g = attention_backward_reference(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    err = float((o.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    assert rel_err(lse, attention_lse_reference(q, k, **kw)) < 1e-5
    for x, y, z in zip(got, again, want_g):
        assert torch.equal(x, y)
        assert rel_err(x, z) < FLASH_BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("window", (None, 40))
def test_flash_positions_with_their_own_key_positions(card, dtype, window):
    """Queries and keys with positions of their own (Sq 150, Sk 260, each
    unsorted with ties, two sorts) and only keys given (queries at
    ``arange``): the EXT forward and its lse against the plain versions,
    rows without a kept key included."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_reference, attention_reference)

    q, k, v = flash_inputs(card, (2, 6, 2, 150, 260, 64, True, window,
                                  dtype))
    g = torch.Generator().manual_seed(21)
    q_pos = torch.randint(0, 200, (2, 150), generator=g).int().to(card)
    k_pos = torch.randint(-20, 220, (2, 260), generator=g).int().to(card)
    for kw in (dict(q_pos=q_pos, k_pos=k_pos), dict(k_pos=k_pos)):
        kw.update(window=window, softcap=4.0)
        o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
        want = attention_reference(q, k, v, **kw)
        want_lse = attention_lse_reference(q, k, **kw)
        torch.cuda.synchronize()
        err = float((o.float() - want.float()).abs().max())
        assert err <= FLASH_TOL[dtype] * max(
            1.0, float(want.float().abs().max()))
        kept = want_lse > -1e29
        assert rel_err(lse[kept], want_lse[kept]) < 1e-5
        assert bool((lse[~kept] < -5e29).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("window", (None, 40))
def test_flash_backward_with_their_own_key_positions(card, dtype, window):
    """The EXT backward on a plan with Sq != Sk: queries and keys with
    positions of their own (Sq 150, Sk 260, unsorted with ties, rows
    without a kept key included), and a query chunk of packed documents
    (the sequence-sharded attention's rows 64..127 of 256 at their own
    positions against every key), against the plain backward."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)

    g = torch.Generator().manual_seed(23)
    q, k, v = flash_inputs(card, (2, 6, 2, 150, 260, 64, True, window,
                                  dtype))
    own = dict(q_pos=torch.randint(0, 200, (2, 150), generator=g),
               k_pos=torch.randint(-20, 220, (2, 260), generator=g))
    docs = torch.cat([torch.arange(n) for n in (90, 120, 46)])[None]
    docs = docs.expand(2, 256)
    cq, ck, cv = flash_inputs(card, (2, 6, 2, 64, 256, 64, True, window,
                                     dtype))
    chunk = dict(q_pos=docs[:, 64:128], k_pos=docs)
    for (qq, kk, vv), pos in (((q, k, v), own), ((cq, ck, cv), chunk)):
        kw = dict(window=window, softcap=4.0,
                  **{name: x.int().to(card) for name, x in pos.items()})
        o, lse = FK.flash_attention_bhsd(qq, kk, vv, with_lse=True, **kw)
        do = torch.randn(o.shape, generator=torch.Generator(
            device=card).manual_seed(5), device=card).to(dtype)
        got = FK.flash_attention_bwd_bhsd(qq, kk, vv, o, do, lse, **kw)
        want = attention_backward_reference(qq, kk, vv, o, do, lse, **kw)
        torch.cuda.synchronize()
        for name, x, z in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == z.shape
            assert rel_err(x, z) < FLASH_BWD_TOL[dtype], (name,
                                                          rel_err(x, z))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_meta_twins_allocate_what_the_card_allocates_with_positions(
        card, dtype):
    """The EXT path on meta tensors makes the card's allocations: the
    plan's sort and band, the sorted copies, the outputs and scratch."""
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, do = flash_bwd_inputs(card, (2, 6, 2, 200, 64, True, None,
                                          dtype))
    pos = packed(2, 200, seed=2, lo=20, hi=80)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, q_pos=pos,
                                     k_pos=pos, softcap=5.0)
    made = {}
    for dev in (card, torch.device("meta")):
        args = [x.to(dev) for x in (q, k, v, o, do, lse, pos)]
        kw = dict(q_pos=args[6], k_pos=args[6], softcap=5.0)
        with _Allocs() as allocs:
            FK.flash_attention_bhsd(*args[:3], with_lse=True, **kw)
            FK.flash_attention_bwd_bhsd(*args[:6], **kw)
        made[dev.type] = allocs.made
    torch.cuda.synchronize()
    assert made["meta"] == made["cuda"]


def test_flash_ext_gradient_through_the_grouped_layout(card):
    """``ops.flash_attention`` with autograd, positions and a cap on the
    model's grouped layout: the Function's gradients on the card against
    the CPU's plain ones."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=card).bfloat16()
               for shape in ((2, 150, 2, 3, 64), (2, 150, 2, 64),
                             (2, 150, 2, 64)))
    do = torch.randn(q.shape, generator=g, device=card).bfloat16()
    pos = packed(2, 150, seed=9, lo=20, hi=60)
    grads = []
    for xs, ps in (((q, k, v), pos),
                   (tuple(x.cpu().float() for x in (q, k, v)), pos.cpu())):
        xs = [x.clone().requires_grad_(True) for x in xs]
        out = flash_attention(*xs, window=70, q_pos=ps, k_pos=ps,
                              softcap=5.0)
        grads.append(torch.autograd.grad(out, xs, do.to(out)))
    torch.cuda.synchronize()
    for x, y in zip(*grads):
        assert rel_err(x.cpu(), y) < FLASH_BWD_TOL[torch.bfloat16]
