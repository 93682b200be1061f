"""The engine contracts of the JAX package's analysis layer, held on the
port (the port's counterpart of ``repro.analysis``, which traces jaxprs
the port does not have, so the folds are run instead):

* the AST rules of ``repro.analysis.astlint`` find nothing in
  ``src/repro_torch``, the storage tier included;
* every engine's folds on the canonical request (48 mixed ops on 2 x 4
  MLC, staggered arrivals, a surcharge on every seventh op) return
  float32 results bit-equal under a float64 default dtype and the
  float32 default;
* no torch or numpy RNG is constructed or drawn while a fold runs;
* padding the masked fold to buckets 64 and 128 leaves the end time
  bit-identical.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.astlint import lint_paths
from repro_torch.api import FaultSpec, Simulator
from repro_torch.core import api as core_api
from repro_torch.core import ftl, ftl_scan, maxplus_form, sim, trace
from repro_torch.core import workload
from repro_torch.core.nand import CellType
from repro_torch.kernels.maxplus import kernel as maxplus_kernel

ROOT = Path(__file__).resolve().parents[1]
PORT_SRC = ROOT / "src" / "repro_torch"
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j",
                 "end_us")
ENGINES = ("scan", "prefix", "squaring", "cuda", "oracle", "streaming")


def canonical_trace() -> trace.OpTrace:
    """The JAX package's canonical request (``core/api.py``,
    ``_canonical_trace``): 48 ops on 2 x 4, arrivals on a ramp, a 3 us
    surcharge on every seventh op."""
    t = trace.mixed_trace(48, 2, 4, read_fraction=0.5, seed=7)
    n = t.n_ops
    return dataclasses.replace(
        t, arrival_us=np.linspace(0.0, 40.0, n, dtype=np.float32),
        extra_us=np.where(np.arange(n) % 7 == 0, 3.0, 0.0
                          ).astype(np.float32))


def canonical_sim() -> Simulator:
    return Simulator(sim.SSDConfig(cell=CellType.MLC, channels=2, ways=4),
                     device="cpu")


@functools.cache
def _ftl_inputs():
    spec = ftl.FTLSpec(blocks=8, pages_per_block=8, overprovision=0.5)
    return spec, workload.overwrite_stream(48, 24, seed=3)


def engine_results(engine: str) -> dict:
    """Every number the engine's queries return on the canonical request,
    and the raw tensors its folds return (their dtype is checked)."""
    s = canonical_sim()
    t = canonical_trace()
    arrays = core_api._trace_arrays(t)
    out, tensors = {}, {}

    def record(label, res):
        out[f"{label}/end"] = res.end_us
        out[f"{label}/mb_s"] = res.mb_s
        out[f"{label}/busy"] = res.channel_busy_us.tolist()
        if res.energy is not None:
            for f in ENERGY_FIELDS:
                out[f"{label}/{f}"] = getattr(res.energy, f)
        if res.request_lat_us is not None:
            out[f"{label}/lat"] = res.request_lat_us.tolist()

    if engine == "squaring":
        # periodic domain: one class round-robin on one channel (a
        # dedicated firmware loop, no arbitration), no arrivals
        one = Simulator(sim.SSDConfig(cell=CellType.MLC, channels=1, ways=4),
                        device="cpu")
        record("run", one.run(trace.steady_trace(64, 1, 4), engine=engine,
                              objective="all"))
        tensors["fold"] = sim._squaring_end_time(
            *(x[trace.READ] for x in one._targs[:6]), 4, n_pages=64,
            batched=False)
    elif engine == "streaming":
        record("run", s.run(t, engine=engine, objective="all",
                            segment_len=16))
        record("stream", s.run_stream(trace.iter_trace_chunks(t, 20),
                                      objective="all"))
        acc = sim.trace_chunk_init(2, 5)
        tensors["chunk"] = sim.trace_chunk_fold(
            *s._targs, s._energy_table(s.kind), *arrays,
            *acc[0], acc[1], n_channels=2, batched=False)[1:3]
    else:
        record("run", s.run(t, engine=engine, objective="all"))
        record("batched", s.run(t, engine=engine, objective="all",
                                policy="batched"))
    if engine == "scan":
        stream = workload.poisson_stream(40, 9.0, pages_per_request=2,
                                         seed=5)
        for rule in sim.DISPATCH_RULES:
            record(rule, s.run(stream, sched_policy=rule))
        record("stripe", s.run(stream))
        spec, load = _ftl_inputs()
        res = s.run(load, ftl=spec)
        record("ftl", res)
        out["ftl/waf"] = res.waf
        record("many", s.run_many([t, trace.mixed_trace(30, 2, 4, 0.5,
                                                          seed=2)])[1])
        tensors["energy"] = sim.trace_end_time_energy(
            *s._targs, s._energy_table(s.kind), *arrays, n_channels=2,
            batched=False)
        tensors["completions"] = sim.trace_completions(
            *s._targs, *arrays, n_channels=2, batched=False)
        tensors["masked"] = sim.trace_end_time_masked(
            *s._targs, *core_api._pad_trace_np(t, 64), n_channels=2,
            batched=False)
        tensors["dispatch"] = sim.dispatch_trace(
            *s._targs, t.cls, t.arrival_us, n_channels=2, n_ways=4,
            extra_us=t.extra_us)[:2]
    if engine == "prefix":
        tensors["prefix"] = sim.trace_end_time_prefix_energy(
            *s._targs, s._energy_table(s.kind), *arrays, n_channels=2,
            n_ways=4, batched=False, segment_len=16)
    return out, tensors


def _flat(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _flat(v)
    else:
        yield x


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_folds_are_float32_under_a_float64_default(engine):
    want, want_t = engine_results(engine)
    default = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        got, got_t = engine_results(engine)
    finally:
        torch.set_default_dtype(default)
    assert torch.get_default_dtype() == default
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    for k in want_t:
        for g, w in zip(_flat(got_t[k]), _flat(want_t[k])):
            assert w.dtype in (torch.float32, torch.int32, torch.int64,
                               torch.bool), (k, w.dtype)
            assert g.dtype == w.dtype, (k, g.dtype)
            assert torch.equal(g, w), k


# -- no RNG while a fold runs ------------------------------------------------

#: the port's fold bodies: the scan step loop, the lane-batched masked
#: fold, dynamic dispatch, the prefix and squaring folds, the (max,+)
#: plain folds the cuda engine runs on the CPU, and the FTL translation
#: machine's step loop
FOLDS = ((sim, "_fold"), (sim, "_trace_end_time_masked_impl"),
         (sim, "dispatch_trace"), (sim, "_trace_end_time_prefix_impl"),
         (sim, "_squaring_end_time"),
         (maxplus_form, "structured_segment_products"),
         (maxplus_kernel, "maxplus_fold_ref"),
         (maxplus_kernel, "maxplus_fold_many_ref"),
         (ftl_scan, "_drive"))
NP_BITGENS = ("PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
              "SeedSequence", "RandomState")
NP_GENERATORS = ("default_rng", "Generator")
TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial", "poisson", "manual_seed", "Generator")
TENSOR_DRAWS = ("uniform_", "normal_", "random_", "exponential_",
                "bernoulli_", "geometric_", "log_normal_", "cauchy_")


class RngWatch:
    """Counts RNG constructions and draws, apart for those made while a
    fold runs.  numpy generators come back wrapped, so a draw from one
    made outside a fold still counts when it happens inside."""

    def __init__(self, monkeypatch):
        self.depth = 0
        self.inside, self.outside = [], []
        for mod, name in FOLDS:
            monkeypatch.setattr(mod, name, self._fold(getattr(mod, name)))
        for name in NP_BITGENS:
            monkeypatch.setattr(np.random, name,
                                self._count(getattr(np.random, name), name))
        for name in NP_GENERATORS:
            monkeypatch.setattr(np.random, name,
                                self._wrap_gen(getattr(np.random, name), name))
        for name in TORCH_DRAWS:
            monkeypatch.setattr(torch, name,
                                self._count(getattr(torch, name), name))
        for name in TENSOR_DRAWS:
            monkeypatch.setattr(torch.Tensor, name,
                                self._count(getattr(torch.Tensor, name), name))

    def _note(self, what):
        (self.inside if self.depth else self.outside).append(what)

    def _fold(self, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
        return call

    def _count(self, fn, name):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self._note(name)
            return fn(*args, **kwargs)
        return call

    def _wrap_gen(self, ctor, name):
        watch = self

        class Gen:
            def __init__(self, real):
                self._real = real

            def __getattr__(self, attr):
                value = getattr(self._real, attr)
                if not callable(value):
                    return value

                def draw(*args, **kwargs):
                    watch._note(f"{name}.{attr}")
                    return value(*args, **kwargs)
                return draw

        def make(*args, **kwargs):
            self._note(name)
            return Gen(ctor(*args, **kwargs))
        return make


def test_rng_watch_sees_a_draw_inside_a_fold(monkeypatch):
    def fake_fold():
        return torch.rand(2), np.random.default_rng(0).random()

    watch = RngWatch(monkeypatch)
    rng = np.random.default_rng(1)        # made outside: not a finding
    watch._fold(fake_fold)()
    watch._fold(lambda: rng.integers(3))()
    assert watch.outside == ["default_rng"]
    assert watch.inside == ["rand", "default_rng", "default_rng.random",
                            "default_rng.integers"]


@pytest.mark.parametrize("engine", ENGINES)
def test_no_rng_while_a_fold_runs(monkeypatch, engine):
    watch = RngWatch(monkeypatch)
    engine_results(engine)
    assert watch.inside == []
    if engine == "scan":
        # the fault draws happen, outside the fold
        s = canonical_sim()
        s.run(dataclasses.replace(canonical_trace(), extra_us=None),
              faults=FaultSpec(wear=0.9, jitter_us=1.0, seed=4))
        assert watch.inside == [] and watch.outside


# -- padding identity --------------------------------------------------------

@pytest.mark.parametrize("bucket", (64, 128))
@pytest.mark.parametrize("batched", (False, True))
@pytest.mark.parametrize("garbage", (False, True))
def test_masked_fold_padding_is_bitwise_identity(bucket, batched, garbage):
    s = canonical_sim()
    t = canonical_trace()
    base = sim.trace_end_time(*s._targs, *core_api._trace_arrays(t),
                              n_channels=2, batched=batched)
    cls, ch, way, par, arr, ext, valid = core_api._pad_trace_np(t, bucket)
    if garbage:
        # whatever the padding ops hold, the mask makes them no-ops
        rng = np.random.default_rng(bucket)
        pad = ~valid
        n = int(pad.sum())
        cls[pad] = rng.integers(0, 2, n)
        ch[pad] = rng.integers(0, 2, n)
        way[pad] = rng.integers(0, 4, n)
        par[pad] = rng.integers(0, 2, n)
        arr[pad] = rng.uniform(0, 1e4, n).astype(np.float32)
        ext[pad] = rng.uniform(0, 50, n).astype(np.float32)
    padded = sim.trace_end_time_masked(*s._targs, cls, ch, way, par, arr,
                                       ext, valid, n_channels=2,
                                       batched=batched)
    assert padded.dtype == torch.float32
    assert torch.equal(padded, base)
    end, comp = sim.trace_completions_masked(
        *s._targs, cls, ch, way, par, arr, ext, valid, n_channels=2,
        batched=batched)
    base_end, base_comp = sim.trace_completions(
        *s._targs, *core_api._trace_arrays(t), n_channels=2, batched=batched)
    assert torch.equal(end, base_end)
    assert torch.equal(comp[:t.n_ops], base_comp)


def test_lane_padding_is_bitwise_identity():
    """``run_many``'s lanes of different lengths padded into one bucket
    end where each trace alone ends."""
    s = canonical_sim()
    traces = [canonical_trace(), trace.mixed_trace(17, 2, 4, 0.3, seed=1),
              trace.mixed_trace(100, 2, 4, 0.8, seed=2)]
    alone = [s.run(t).end_us for t in traces]
    for bucket in (128, 256):
        lanes = [core_api._pad_trace_np(t, bucket) for t in traces]
        ends = sim.trace_end_time_masked_many(
            *s._targs, *(np.stack([ln[i] for ln in lanes]) for i in range(7)),
            n_channels=2, batched=False)
        assert ends.tolist() == alone


def test_astlint_finds_nothing_in_the_port():
    findings, n_files = lint_paths([PORT_SRC], ROOT)
    assert n_files == len(list(PORT_SRC.rglob("*.py")))
    assert (PORT_SRC / "storage" / "checkpoint.py").exists()
    assert findings == [], [f"{f.path}:{f.line} {f.rule}" for f in findings]
