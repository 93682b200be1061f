"""The (max,+) fold of the port against the JAX Pallas kernel.

On the CPU the port's ``maxplus_fold_kernel`` runs its plain version; it
must be bit-equal to the JAX ``maxplus_fold_kernel`` (interpret mode) in
all five variants, state and energy accumulator alike.  The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py``, which imports no JAX."""

import numpy as np
import pytest
import torch

from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.core.maxplus_form import NEG
from repro.kernels.maxplus import ops as j_ops
from repro.kernels.maxplus.kernel import maxplus_fold_kernel as j_kernel
from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace
from repro_torch.kernels.maxplus import ops
from repro_torch.kernels.maxplus.kernel import maxplus_fold_kernel

VARIANTS = ("periodic", "periodic+energy", "indexed",
            "indexed+arrivals+extras", "indexed+energy+arrivals+extras")


def dictionary_inputs(seed, b=3, channels=2, ways=4, t=200):
    """A real combo dictionary of a mixed trace under ``b`` seeded
    design-point tables, plus seeded arrivals, extras and energies."""
    rng = np.random.default_rng(seed)
    tr = trace.mixed_trace(t, channels, ways, 0.6, seed=seed)
    layout = mf.StateLayout(channels, ways)
    combos, idx = mf.trace_combos(tr)
    base = trace.op_class_table(sim.SSDConfig(channels=channels, ways=ways))
    mats, gvec = [], []
    for _ in range(b):
        f = rng.uniform(0.8, 1.2, 7).astype(np.float32)
        tab = trace.from_reference_table({
            "cmd_us": base.cmd_us * f[0], "pre_us": base.pre_us * f[1],
            "slot_us": base.slot_us * f[2],
            "post_lo_us": base.post_lo_us * f[3],
            "post_hi_us": base.post_hi_us * f[4],
            "ctrl_us": base.ctrl_us * f[5], "arb_us": base.arb_us * f[6],
            "data_bytes": base.data_bytes})
        mats.append(mf.combo_matrices(tab, combos, layout))
        gvec.append(mf.combo_arrival_offsets(tab, combos, layout))
    mats = np.stack(mats)
    m, n = mats.shape[1], mats.shape[2]
    return dict(
        mats=mats, s0=np.zeros((b, n), np.float32), idx=idx,
        arrivals=np.cumsum(rng.exponential(20.0, t)).astype(np.float32),
        extras=np.where(rng.random(t) < 0.2, rng.uniform(1, 40, t),
                        0.0).astype(np.float32),
        gvec=np.stack(gvec),
        wvec=np.broadcast_to(mf.combo_written_rows(combos, layout),
                             (b, m, n)).copy(),
        energy=rng.uniform(0, 3, (b, m, 5)).astype(np.float32), t=t)


def random_inputs(seed, b=2, m=5, n=13, t=96):
    """Random dictionaries with NEG holes and a nonzero initial state."""
    rng = np.random.default_rng(seed)
    mats = np.where(rng.random((b, m, n, n)) < 0.35,
                    rng.uniform(0, 50, (b, m, n, n)), NEG).astype(np.float32)
    mats[:, :, np.arange(n), np.arange(n)] = 0.0
    return dict(
        mats=mats, s0=rng.uniform(0, 5, (b, n)).astype(np.float32),
        idx=rng.integers(0, m, t).astype(np.int32),
        arrivals=np.cumsum(rng.exponential(5.0, t)).astype(np.float32),
        extras=rng.uniform(0, 9, t).astype(np.float32),
        gvec=np.where(rng.random((b, m, n)) < 0.3,
                      rng.uniform(0, 20, (b, m, n)), NEG).astype(np.float32),
        wvec=(rng.random((b, m, n)) < 0.2).astype(np.float32),
        energy=rng.uniform(0, 3, (b, m, 4)).astype(np.float32), t=t)


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


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("inputs", ("dictionary", "random"))
def test_cpu_fold_bit_equal_to_jax_kernel(variant, inputs):
    d = dictionary_inputs(5) if inputs == "dictionary" else random_inputs(6)
    kw = variant_kwargs(variant, d)
    got = maxplus_fold_kernel(
        torch.as_tensor(d["mats"]), torch.as_tensor(d["s0"]), t_steps=d["t"],
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = j_kernel(d["mats"], d["s0"], t_steps=d["t"], interpret=True,
                    **kw)
    for g, w in zip(as_tuple(got), as_tuple(want)):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("channels,ways", [(1, 4), (2, 8), (4, 2)])
@pytest.mark.parametrize("side", ("plain", "arrivals+extras"))
def test_trace_ops_bit_equal_to_jax(channels, ways, side):
    cfg = dict(interface="sync_only", cell="mlc", channels=channels,
               ways=ways)
    tables = [trace.op_class_table(sim.SSDConfig(**cfg)),
              trace.op_class_table(sim.SSDConfig(
                  **{**cfg, "interface": "conv"}))]
    jtables = [j_trace.op_class_table(j_sim.SSDConfig(**cfg)),
               j_trace.op_class_table(j_sim.SSDConfig(
                   **{**cfg, "interface": "conv"}))]
    t = trace.mixed_trace(192, channels, ways, 0.5, seed=ways)
    jt = j_trace.mixed_trace(192, channels, ways, 0.5, seed=ways)
    if side != "plain":
        rng = np.random.default_rng(channels)
        arr = np.cumsum(rng.exponential(15.0, t.n_ops)).astype(np.float32)
        ext = np.where(rng.random(t.n_ops) < 0.2, 7.5, 0.0
                       ).astype(np.float32)
        t = trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                          parity=t.parity, channels=channels, ways=ways,
                          arrival_us=arr, extra_us=ext)
        jt = j_trace.OpTrace(cls=jt.cls, channel=jt.channel, way=jt.way,
                             parity=jt.parity, channels=channels, ways=ways,
                             arrival_us=arr, extra_us=ext)
    end = ops.trace_end_time_maxplus(tables, t, device="cpu")
    jend = j_ops.trace_end_time_maxplus(jtables, jt, interpret=True)
    assert np.array_equal(end, np.asarray(jend))
    kinds = ["sync_only", "conv"]
    end_e, acc = ops.trace_energy_maxplus(tables, t, kinds, device="cpu")
    jend_e, jacc = j_ops.trace_energy_maxplus(jtables, jt, kinds,
                                              interpret=True)
    assert np.array_equal(end_e, np.asarray(jend_e))
    assert np.array_equal(acc, np.asarray(jacc))
    bw = ops.trace_bandwidth_maxplus_mb_s(tables, t, device="cpu")
    jbw = j_ops.trace_bandwidth_maxplus_mb_s(jtables, jt, interpret=True)
    assert np.array_equal(bw, np.asarray(jbw))


@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_periodic_channel_ops_bit_equal_to_jax(policy):
    from repro.core.interface import make_interface as j_iface
    from repro.core.nand import chip as j_chip
    from repro_torch.core.interface import make_interface
    from repro_torch.core.nand import chip
    grid = [(c, k, mode, w) for c in ("slc", "mlc")
            for k in ("conv", "proposed") for mode in ("read", "write")
            for w in (1, 4, 16)]
    op = [sim.page_op_params(make_interface(k), chip(c), mode, w)
          for c, k, mode, w in grid]
    jop = [j_sim.page_op_params(j_iface(k), j_chip(c), mode, w)
           for c, k, mode, w in grid]
    ways = [w for *_, w in grid]
    got = ops.bandwidth_maxplus_mb_s(op, ways, n_pages=96, policy=policy,
                                     device="cpu")
    want = j_ops.bandwidth_maxplus_mb_s(jop, ways, n_pages=96,
                                        policy=policy, interpret=True)
    assert np.array_equal(got, np.asarray(want))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    d = random_inputs(1)
    mats, s0 = torch.as_tensor(d["mats"]), torch.as_tensor(d["s0"])
    with pytest.raises(ValueError, match="trace-indexed"):
        maxplus_fold_kernel(mats, s0, t_steps=4,
                            arrivals=torch.zeros(4))
    with pytest.raises(ValueError, match="periodic"):
        ops.maxplus_fold(mats, s0, t_steps=4, strategy="squaring",
                         idx=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="trace-indexed"):
        ops.maxplus_fold(mats, s0, t_steps=4, strategy="segmented",
                         extras=torch.zeros(4))
    with pytest.raises(ValueError, match="unknown strategy"):
        ops.maxplus_fold(mats, s0, t_steps=4, strategy="sideways")
    with pytest.raises(ValueError, match="cuda or cpu"):
        maxplus_fold_kernel(mats.to("meta"), s0.to("meta"), t_steps=4)
    # t_steps = 0 returns the initial state, not an alias of it
    out = maxplus_fold_kernel(mats, s0, t_steps=0)
    assert torch.equal(out, s0) and out.data_ptr() != s0.data_ptr()


def test_fold_meets_oracle_where_float32_sums_are_exact():
    """On timing quantised to 0.25 us every float32 sum below 2**22 us is
    exact, so the (max,+) fold and the event-loop oracle must agree
    exactly; on the raw timing both drift from the float64 oracle by
    float32 rounding only (at most T * 2**-24 relative)."""
    import dataclasses
    from repro_torch.core.sim_ref import simulate_trace_ref
    cols = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
            "ctrl_us", "arb_us")
    t = trace.mixed_trace(2048, 8, 16, 0.7, seed=0)
    for cell in ("slc", "mlc"):
        base = trace.op_class_table(sim.SSDConfig(interface="proposed",
                                                  cell=cell, channels=8,
                                                  ways=16))
        exact = dataclasses.replace(base, **{
            c: (np.round(getattr(base, c) / 0.25) * 0.25).astype(np.float32)
            for c in cols})
        got = ops.trace_end_time_maxplus(exact, t, device="cpu")
        assert float(got) == simulate_trace_ref(exact, t)
        f64 = dataclasses.replace(base, **{
            c: getattr(base, c).astype(np.float64) for c in cols})
        ref64 = simulate_trace_ref(f64, t)
        got = float(ops.trace_end_time_maxplus(base, t, device="cpu"))
        assert abs(got - ref64) <= t.n_ops * 2.0 ** -24 * ref64
