"""The port's many-trace (max,+) fold (TPU kernel K3) against the JAX
package's, on the CPU.

The port's plain version ``maxplus_fold_many_ref`` (what the CUDA
kernel's wrapper runs for CPU tensors) is held bit-equal to JAX's
``maxplus_fold_many_kernel`` run in interpret mode (its gather branch),
and the host side ``run_many_end_time_maxplus`` bit-equal to JAX's: every
step is one float32 add per element and an exact max, so the same
operations give the same bits.  The JAX kernel folds the identity op past
a lane's length; the port stops there, which is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.kernels.maxplus import kernel as j_kernel
from repro.kernels.maxplus import ops as j_ops
from repro_torch.core import sim, trace
from repro_torch.core.maxplus_form import NEG
from repro_torch.kernels.maxplus import ops
from repro_torch.kernels.maxplus.kernel import maxplus_fold_many_kernel
from repro_torch.kernels.maxplus.ref import maxplus_fold_many_ref

# lengths 1 and 203 (not a multiple of 4), 0 (an empty lane), unsorted
LENGTHS = (130, 1, 203, 64, 0, 77, 5, 130, 3)


def fleet_inputs(seed=3, m=11, n=29, lengths=LENGTHS):
    """A random dictionary with the identity appended at index m, a NEG
    origin template and a zero written-rows row there, and per-lane
    sequences padded with the identity op past each lane's length."""
    rng = np.random.default_rng(seed)
    b, t = len(lengths), max(lengths)
    mats = np.where(rng.random((m, n, n)) < 0.3,
                    rng.uniform(0.0, 40.0, (m, n, n)), NEG)
    mats[:, np.arange(n), np.arange(n)] = 0.0
    eye = np.full((n, n), NEG)
    eye[np.arange(n), np.arange(n)] = 0.0
    mats = np.concatenate([mats, eye[None]]).astype(np.float32)
    gvec = np.concatenate([
        np.where(rng.random((m, n)) < 0.2, rng.uniform(0, 30, (m, n)), NEG),
        np.full((1, n), NEG)]).astype(np.float32)
    wvec = np.concatenate([(rng.random((m, n)) < 0.1),
                           np.zeros((1, n))]).astype(np.float32)
    idx = np.full((b, t), m, np.int32)
    arr = np.zeros((b, t), np.float32)
    ext = np.zeros((b, t), np.float32)
    for lane, ln in enumerate(lengths):
        idx[lane, :ln] = rng.integers(0, m, ln)
        arr[lane, :ln] = np.cumsum(rng.exponential(9.0, ln))
        ext[lane, :ln] = np.where(rng.random(ln) < 0.15,
                                  rng.uniform(5, 60, ln), 0.0)
    s0 = rng.uniform(0.0, 5.0, n).astype(np.float32)
    return dict(mats=mats, gvec=gvec, wvec=wvec, idx=idx, arrivals=arr,
                extras=ext, s0=s0,
                lengths=np.asarray(lengths, np.int32))


def run_both(d, with_arrivals, with_faults, block_lanes):
    side = (dict(extras=d["extras"], wvec=d["wvec"]) if with_faults
            else {})
    got = maxplus_fold_many_kernel(
        *(torch.as_tensor(d[k]) for k in ("mats", "gvec", "idx",
                                          "arrivals", "s0", "lengths")),
        with_arrivals=with_arrivals,
        **{k: torch.as_tensor(v) for k, v in side.items()})
    want = j_kernel.maxplus_fold_many_kernel(
        *(jnp.asarray(d[k]) for k in ("mats", "gvec", "idx", "arrivals",
                                      "s0", "lengths")),
        with_arrivals=with_arrivals, block_lanes=block_lanes,
        interpret=True, **{k: jnp.asarray(v) for k, v in side.items()})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("with_arrivals", (False, True))
@pytest.mark.parametrize("with_faults", (False, True))
@pytest.mark.parametrize("block_lanes", (128, 4))
def test_plain_fold_bit_equal_to_jax_kernel(with_arrivals, with_faults,
                                            block_lanes):
    got, want = run_both(fleet_inputs(), with_arrivals, with_faults,
                         block_lanes)
    assert got.shape == want.shape == (len(LENGTHS), 29)
    assert np.array_equal(got, want)


def test_plain_fold_order_and_empty_lanes():
    d = fleet_inputs(seed=5)
    t = lambda k: torch.as_tensor(d[k])  # noqa: E731
    args = [t(k) for k in ("mats", "gvec", "idx", "arrivals", "s0",
                           "lengths")]
    full = maxplus_fold_many_ref(*args, extras=t("extras"), wvec=t("wvec"))
    # an empty lane keeps s0; the same lanes in sorted order give the
    # same states, permuted
    assert torch.equal(full[LENGTHS.index(0)], t("s0"))
    order = np.argsort(-np.asarray(LENGTHS), kind="stable")
    perm = torch.as_tensor(order)
    sorted_args = [x[perm] if x.dim() and x.shape[0] == len(LENGTHS)
                   and k in ("idx", "arrivals", "lengths") else x
                   for k, x in zip(("mats", "gvec", "idx", "arrivals", "s0",
                                    "lengths"), args)]
    again = maxplus_fold_many_ref(*sorted_args, extras=t("extras")[perm],
                                  wvec=t("wvec"))
    assert torch.equal(again, full[perm])
    with pytest.raises(ValueError, match="together"):
        maxplus_fold_many_kernel(*args, extras=t("extras"))


def traces(policy_seed, channels=2, ways=4, lengths=(33, 100, 257, 100,
                                                       64, 12)):
    """Port and JAX traces, mixed lengths, arrivals on even lanes and
    fault surcharges on every third."""
    out, jout = [], []
    for i, n in enumerate(lengths):
        rng = np.random.default_rng(policy_seed * 100 + i)
        t = trace.mixed_trace(n, channels, ways, 0.7, seed=i)
        arr = (np.cumsum(rng.exponential(14.0, n)).astype(np.float32)
               if i % 2 == 0 else None)
        ext = (np.where(rng.random(n) < 0.1, rng.uniform(30, 120, n),
                        0.0).astype(np.float32) if i % 3 == 1 else None)
        kw = dict(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
                  channels=channels, ways=ways, arrival_us=arr, extra_us=ext)
        out.append(trace.OpTrace(**kw))
        jout.append(j_trace.OpTrace(**kw))
    return out, jout


@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("side", ("none", "arrivals", "faults", "both"))
def test_run_many_end_time_bit_equal_to_jax(policy, side):
    pt, jt = traces(3)
    keep = {"none": (False, False), "arrivals": (True, False),
            "faults": (False, True), "both": (True, True)}[side]

    def strip(ts, cls_):
        return [cls_(cls=t.cls, channel=t.channel, way=t.way,
                     parity=t.parity, channels=t.channels, ways=t.ways,
                     arrival_us=t.arrival_us if keep[0] else None,
                     extra_us=t.extra_us if keep[1] else None) for t in ts]

    pt, jt = strip(pt, trace.OpTrace), strip(jt, j_trace.OpTrace)
    cfg = dict(channels=2, ways=4, cell="mlc", interface="proposed")
    got = ops.run_many_end_time_maxplus(
        trace.op_class_table(sim.SSDConfig(**cfg)), pt, policy=policy,
        device="cpu")
    want = j_ops.run_many_end_time_maxplus(
        j_trace.op_class_table(j_sim.SSDConfig(**cfg)), jt, policy=policy,
        interpret=True)
    assert got.dtype == np.float64 and np.array_equal(got, want)


def test_run_many_end_time_rejects_mixed_geometry():
    a = trace.mixed_trace(40, 2, 4, 0.7, seed=0)
    b = trace.mixed_trace(40, 2, 2, 0.7, seed=1)
    table = trace.op_class_table(sim.SSDConfig(channels=2, ways=4))
    with pytest.raises(ValueError, match="geometry"):
        ops.run_many_end_time_maxplus(table, [a, b], device="cpu")
    assert ops.run_many_end_time_maxplus(table, [], device="cpu").shape == (0,)
