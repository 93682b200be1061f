"""The port's SSD cost model and KV-offload planning
(``repro_torch.storage.ssd_model`` / ``kvoffload``) against the JAX
package's, on the CPU.  Both price through the ``scan`` engine, bit-equal
across the packages, and the rest is float64 host arithmetic, so the
tolerance is equality on every ``IOEstimate`` field, the
phase-resolved ``EnergyBreakdown`` and its extrapolation included.  The
planning flows of ``examples/ssd_design_space.py`` (checkpoint-stall,
dataloader refill, interface comparison) run through both packages."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_arch
from repro.core import trace as j_trace
from repro.core.interface import InterfaceKind as JKind
from repro.core.nand import CellType as JCell
from repro.core.sim import SSDConfig as JConfig
from repro.storage import kvoffload as j_kv
from repro.storage import ssd_model as j_ssd
from repro_torch.configs.registry import get_arch as p_get_arch
from repro_torch.core import trace
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.nand import CellType
from repro_torch.core.sim import SSDConfig
from repro_torch.models import transformer as p_tf
from repro_torch.storage import kvoffload, ssd_model

CPU = {"device": "cpu"}
GEOMETRIES = ((1, 1), (2, 8), (8, 16))
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j",
                 "end_us", "payload_bytes", "channels")
ESTIMATE_FIELDS = ("seconds", "bandwidth_mb_s", "energy_joules",
                   "read_bytes", "write_bytes", "n_ops")
TRACE_FIELDS = ("cls", "channel", "way", "parity", "payload", "arrival_us",
                "extra_us")
KV_FIELDS = ("applicable", "state_bytes_per_seq", "hot_bytes_per_seq",
             "cold_bytes_per_seq", "read_mb_per_token", "tokens_per_s",
             "note")


def configs(channels, ways, cell="mlc", kind="proposed", **kw):
    """The same design point in both packages."""
    return (JConfig(interface=JKind(kind), cell=JCell(cell),
                    channels=channels, ways=ways, **kw),
            SSDConfig(interface=InterfaceKind(kind), cell=CellType(cell),
                      channels=channels, ways=ways, **kw))


def assert_same_estimate(got, want):
    if want is None:
        assert got is None
        return
    assert isinstance(got, ssd_model.IOEstimate)
    for f in ESTIMATE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.config.describe() == want.config.describe()
    assert got.config.sata_mb_s == want.config.sata_mb_s
    assert got.describe() == want.describe()
    if want.energy is None:
        assert got.energy is None
        return
    for f in ENERGY_FIELDS:
        assert getattr(got.energy, f) == getattr(want.energy, f), f
    assert got.energy.kind.value == want.energy.kind.value
    assert got.energy.controller_j == want.energy.controller_j


def assert_same_estimates(got, want):
    assert list(got) == list(want)
    for k in want:
        assert_same_estimate(got[k], want[k])


def assert_same_trace(got, want):
    assert (got.channels, got.ways) == (want.channels, want.ways)
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


# one trace builder per workload shape the storage tier prices, the same
# arguments to both packages: (builder, total_bytes); the windows are
# cut to 512 ops and extrapolated by bytes, as the tier's own are
WORKLOADS = {
    "checkpoint": (lambda m, cfg: m.checkpoint_trace(3 << 30, cfg,
                                                     max_ops=512), 3 << 30),
    "datapipe_hedged": (lambda m, cfg: m.datapipe_trace(
        1 << 30, cfg, hedge_fraction=0.1, seed=3, max_ops=512), 1 << 30),
    "mixed": (lambda m, cfg: m.mixed_trace(700, cfg.channels, cfg.ways, 0.7,
                                           seed=5), None),
}


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("cell", ("slc", "mlc"))
@pytest.mark.parametrize("workload", tuple(WORKLOADS))
def test_estimate_trace_matches_jax(channels, ways, cell, workload):
    build, total = WORKLOADS[workload]
    jcfg, cfg = configs(channels, ways, cell)
    jt, t = build(j_trace, jcfg), build(trace, cfg)
    assert_same_trace(t, jt)
    want = j_ssd.estimate_trace(jt, jcfg, total_bytes=total)
    got = ssd_model.estimate_trace(t, cfg, total_bytes=total, **CPU)
    assert_same_estimate(got, want)
    assert got.energy.end_us == pytest.approx(got.seconds * 1e6)


def test_estimate_trace_policy_and_refusals():
    jcfg, cfg = configs(2, 8, "slc", policy="batched")
    jt = j_trace.mixed_trace(300, 2, 8, 0.5, seed=1)
    t = trace.mixed_trace(300, 2, 8, 0.5, seed=1)
    for policy in (None, "eager"):
        assert_same_estimate(
            ssd_model.estimate_trace(t, cfg, policy=policy, **CPU),
            j_ssd.estimate_trace(jt, jcfg, policy=policy))
    with pytest.raises(ValueError, match="geometry"):
        ssd_model.estimate_trace(trace.mixed_trace(8, 1, 2, 0.5), cfg, **CPU)
    hedges = dataclasses.replace(t, payload=np.zeros(t.n_ops, bool))
    with pytest.raises(ValueError, match="no payload bytes"):
        ssd_model.estimate_trace(hedges, cfg, **CPU)


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("cell", ("slc", "mlc"))
@pytest.mark.parametrize("mode", ("read", "write"))
def test_estimate_io_and_compare_interfaces_match_jax(channels, ways, cell,
                                                      mode):
    jcfg, cfg = configs(channels, ways, cell, kind="sync_only")
    assert_same_estimate(ssd_model.estimate_io(5 << 30, cfg, mode, **CPU),
                         j_ssd.estimate_io(5 << 30, jcfg, mode))
    assert_same_estimates(
        ssd_model.compare_interfaces(5 << 30, mode, channels=channels,
                                     ways=ways, cell=CellType(cell), **CPU),
        j_ssd.compare_interfaces(5 << 30, mode, channels=channels,
                                 ways=ways, cell=JCell(cell)))


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
def test_interface_fan_outs_match_jax(channels, ways):
    jcfg, cfg = configs(channels, ways, "mlc", kind="conv")
    jt = j_trace.checkpoint_trace(2 << 30, jcfg)
    t = trace.checkpoint_trace(2 << 30, cfg)
    got = ssd_model.estimate_trace_interfaces(t, cfg, total_bytes=2 << 30,
                                              **CPU)
    assert_same_estimates(got, j_ssd.estimate_trace_interfaces(
        jt, jcfg, total_bytes=2 << 30))
    assert got["proposed"].seconds < got["conv"].seconds
    assert_same_estimates(
        ssd_model.compare_interfaces_trace(t, cell=CellType.SLC, **CPU),
        j_ssd.compare_interfaces_trace(jt, cell=JCell.SLC))


@pytest.mark.parametrize("nbytes,budget,mode,objective", [
    (10 << 30, 60.0, "read", "area"), (10 << 30, 120.0, "write", "area"),
    (10 << 30, 120.0, "write", "energy"), (10 << 40, 0.1, "write", "area")])
def test_plan_geometry_matches_jax(nbytes, budget, mode, objective):
    got = ssd_model.plan_geometry(nbytes, budget, mode, objective=objective,
                                  **CPU)
    assert_same_estimate(got, j_ssd.plan_geometry(nbytes, budget, mode,
                                                  objective=objective))
    if got is not None:
        assert got.seconds <= budget


@pytest.mark.parametrize("objective", ("area", "energy"))
def test_plan_geometry_for_trace_matches_jax(objective):
    def build(m):
        return lambda cfg: m.mixed_trace(256, cfg.channels, cfg.ways, 0.6,
                                         seed=cfg.channels * 17 + cfg.ways)

    kw = dict(budget_s=30.0, total_bytes=4 << 30, objective=objective)
    got = ssd_model.plan_geometry_for_trace(build(trace), cell=CellType.SLC,
                                            **kw, **CPU)
    assert_same_estimate(got, j_ssd.plan_geometry_for_trace(
        build(j_trace), cell=JCell.SLC, **kw))
    assert got is not None and got.seconds <= 30.0
    with pytest.raises(ValueError, match="objective"):
        ssd_model.plan_geometry_for_trace(build(trace), 1.0,
                                          objective="speed", **CPU)


def test_candidates_are_the_jax_order():
    assert ssd_model._CANDIDATES == j_ssd._CANDIDATES


# -- the planning flows of examples/ssd_design_space.py --------------------

CKPT_BYTES = int(2.7e9 * 2 * 3)     # 2.7B params, bf16 + optimizer state
TEN_GIB = 10 << 30


def jax_checkpoint_stall_plan(budget):
    """The example's checkpoint-stall plan on the JAX package: an MLC tier
    first, an SLC tier when contention-limited MLC writes miss the
    budget."""
    for cell in (JCell.MLC, JCell.SLC):
        plan = j_ssd.plan_geometry_for_trace(
            lambda cfg: j_trace.checkpoint_trace(CKPT_BYTES, cfg),
            budget_s=budget, cell=cell, total_bytes=CKPT_BYTES)
        if plan:
            return plan
    return None


@pytest.mark.parametrize("budget", (150.0, 95.0, 30.0))
def test_checkpoint_stall_plans_match_jax(budget):
    got = ssd_model.plan_checkpoint_tier(CKPT_BYTES, budget, **CPU)
    assert_same_estimate(got, jax_checkpoint_stall_plan(budget))


def jax_refill_plans():
    """The example's 10 GiB dataloader refill on the JAX package."""
    def build(cfg):
        return j_trace.datapipe_trace(TEN_GIB, cfg, hedge_fraction=0.05)
    return {"trace": j_ssd.plan_geometry_for_trace(
                build, budget_s=60.0, total_bytes=TEN_GIB),
            "bytes": j_ssd.plan_geometry(TEN_GIB, budget_s=60.0, mode="read"),
            "energy": j_ssd.plan_geometry_for_trace(
                build, budget_s=60.0, total_bytes=TEN_GIB,
                objective="energy"),
            **j_ssd.compare_interfaces(TEN_GIB, "read")}


def test_dataloader_refill_flows_match_jax():
    got = {**ssd_model.plan_refill(TEN_GIB, 60.0, **CPU),
           **ssd_model.compare_interfaces(TEN_GIB, "read", **CPU)}
    assert_same_estimates(got, jax_refill_plans())
    assert got["energy"].energy_joules <= got["trace"].energy_joules


def test_estimates_are_counted():
    _, cfg = configs(2, 8, "mlc")
    t = trace.checkpoint_trace(1 << 30, cfg, max_ops=256)
    ssd_model.reset_estimates()
    assert ssd_model.ESTIMATES == {"calls": 0, "ops": 0, "seconds": 0.0}
    ssd_model.estimate_trace_interfaces(t, cfg, **CPU)
    ssd_model.estimate_io(1 << 30, cfg, "read", **CPU)   # no trace: uncounted
    with pytest.raises(ValueError):
        ssd_model.estimate_trace(trace.mixed_trace(8, 1, 2, 0.5), cfg, **CPU)
    assert ssd_model.ESTIMATES["calls"] == 3
    assert ssd_model.ESTIMATES["ops"] == 3 * t.n_ops
    assert ssd_model.ESTIMATES["seconds"] > 0.0


# -- KV offload -------------------------------------------------------------

def global_attention(cfg_cls, spec_cls, cfg):
    """``cfg`` with every attention window removed."""
    def unwindow(specs):
        return tuple(spec_cls(**{**dataclasses.asdict(s), "window": None})
                     for s in specs)
    return dataclasses.replace(cfg, pattern=unwindow(cfg.pattern),
                               tail=unwindow(cfg.tail))


def assert_same_plan(got, want):
    assert isinstance(got, kvoffload.KVOffloadPlan)
    for f in KV_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert (got.trace is None) == (want.trace is None)
    if want.trace is not None:
        assert_same_trace(got.trace, want.trace)
        for f in ("arrival_us", "op_cls", "n_pages", "stream", "payload"):
            assert np.array_equal(getattr(got.requests, f),
                                  getattr(want.requests, f)), f


@pytest.mark.parametrize("arch,windows", [
    ("qwen2-0.5b", True), ("xlstm-350m", True), ("recurrentgemma-9b", True),
    ("recurrentgemma-9b", False)])
def test_plan_kv_offload_matches_jax(arch, windows):
    jcfg = get_arch(arch).config
    cfg = p_get_arch(arch).config
    if not windows:
        from repro.models import transformer as j_tf
        jcfg = global_attention(j_tf.ModelConfig, j_tf.LayerSpec, jcfg)
        cfg = global_attention(p_tf.ModelConfig, p_tf.LayerSpec, cfg)
    assert kvoffload.kv_bytes_per_token(cfg) == \
        j_kv.kv_bytes_per_token(jcfg)
    got = kvoffload.plan_kv_offload(cfg, 524288, **CPU)
    assert_same_plan(got, j_kv.plan_kv_offload(jcfg, 524288))
    applicable = arch == "qwen2-0.5b" or not windows
    assert got.applicable is applicable
    if applicable:
        assert got.tokens_per_s["proposed"] > got.tokens_per_s["conv"]
    if arch == "recurrentgemma-9b" and not windows:
        # 12 global-attention layers of 1 KV head x 256 dims, bf16 K and V
        assert kvoffload.kv_bytes_per_token(cfg) == (0, 12 * 1024)
        assert got.cold_bytes_per_seq == 12 * 1024 * 524288
