"""The hand-written CUDA (max,+) kernel against its plain version, on the
card.  This file imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode."""

import numpy as np
import pytest
import torch

from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, trace
from repro_torch.kernels.maxplus.kernel import maxplus_fold_kernel
from repro_torch.kernels.maxplus.ref import maxplus_fold_ref

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
