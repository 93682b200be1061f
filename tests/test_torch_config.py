"""The port's configuration layer against the JAX package, and the rules
that keep the port standalone (no JAX, no ``repro`` imports, card by
default)."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import interface as j_interface
from repro.core import nand as j_nand
from repro.core import paper_tables as j_paper
from repro.core import sim as j_sim
from repro.core import timing as j_timing
from repro_torch.core import interface, nand, paper_tables, sim, timing
from repro_torch.device import resolve_device

PORT_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CELLS = ("slc", "mlc")
KINDS = ("conv", "sync_only", "proposed")
WAYS = (1, 2, 4, 8, 16)


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.api, repro_torch.tables\n"
            "import repro_torch.kernels.maxplus.ops\n"
            "import repro_torch.core.calibrate\n"
            "import repro_torch.core.faults, repro_torch.core.workload\n"
            "import repro_torch.core.sched\n"
            "import repro_torch.core.ftl, repro_torch.core.ftl_scan\n"
            "import repro_torch.models.transformer, repro_torch.models.convert\n"
            "import repro_torch.serve, repro_torch.configs.registry\n"
            "import repro_torch.configs.recurrentgemma_9b\n"
            "import repro_torch.models.moe, repro_torch.models.xlstm\n"
            "from repro_torch.configs.registry import all_arches\n"
            "all_arches()\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.rglru.ops\n"
            "import repro_torch.storage, repro_torch.storage.ssd_model\n"
            "import repro_torch.storage.kvoffload\n"
            "import repro_torch.storage.datapipe\n"
            "import repro_torch.storage.checkpoint\n"
            "import repro_torch.train, repro_torch.train.optimizer\n"
            "import repro_torch.train.schedules, repro_torch.train.trainer\n"
            "import repro_torch.launch, repro_torch.launch.steps\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.distributed, repro_torch.distributed.fault\n"
            "import repro_torch.distributed.compression\n"
            "import repro_torch.distributed.partitioning\n"
            "import repro_torch.distributed.ctx, repro_torch.kernels.work\n"
            "import repro_torch.configs.base\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m == 'ml_dtypes')\n"
            "print(','.join(bad))\n")
    src = str(PORT_SRC.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == ""


def test_sharded_paths_load_neither_jax_nor_repro(tmp_path):
    """The multi-device paths too: a sweep sharded over a points mesh of
    two CPU devices, and two data-parallel ZeRO-1 Trainer steps on a
    one-rank gloo group."""
    code = ("import sys, dataclasses\n"
            "import numpy as np, torch.distributed as dist\n"
            "import repro_torch\n"
            "from repro_torch import api\n"
            "from repro_torch.core import sim, trace\n"
            "from repro_torch.launch.mesh import make_data_mesh, "
            "make_points_mesh\n"
            "from repro_torch.configs import registry\n"
            "from repro_torch.storage.datapipe import SyntheticTokens\n"
            "from repro_torch.train.trainer import Trainer, TrainerConfig\n"
            "t = trace.mixed_trace(64, 2, 4, 0.7, seed=1)\n"
            "tables = [trace.op_class_table(sim.SSDConfig(channels=2, "
            "ways=4, cell=c)) for c in ('slc', 'mlc', 'slc')]\n"
            "with api.points_mesh(make_points_mesh(('cpu', 'cpu'))):\n"
            "    ends = api.sweep_tables(tables, t, engine='scan', "
            "device='cpu')\n"
            "assert np.array_equal(ends, api.sweep_tables(tables, t, "
            "engine='scan', device='cpu', shard=False))\n"
            f"dist.init_process_group('gloo', init_method="
            f"'file://{tmp_path}/store', rank=0, world_size=1)\n"
            "cfg = dataclasses.replace(registry.get_arch('qwen2-0.5b')"
            ".smoke, compute_dtype='f32')\n"
            "tr = Trainer(cfg, TrainerConfig(steps=2, ckpt_every=100, "
            f"ckpt_dir='{tmp_path}/ckpt'), SyntheticTokens(cfg.vocab_size, "
            "batch=2, seq=6), mesh=make_data_mesh(device='cpu'))\n"
            "assert tr.run()['final_step'] == 2\n"
            "dist.destroy_process_group()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m == 'ml_dtypes')\n"
            "print(','.join(bad))\n")
    src = str(PORT_SRC.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == ""


IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s)|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.M)


@pytest.mark.parametrize("path", sorted(PORT_SRC.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT_SRC)))
def test_port_source_imports_no_jax_and_no_repro(path):
    assert IMPORT_RE.search(path.read_text()) is None


def test_chip_smoke_imports_no_jax_and_no_repro():
    src = (PORT_SRC.parents[1] / "chip_smoke.py").read_text()
    assert IMPORT_RE.search(src) is None


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ("read", "write"))
def test_page_op_params_equal(cell, kind, mode):
    for ways in WAYS:
        got = sim.page_op_params(interface.make_interface(kind),
                                 nand.chip(cell), mode, ways)
        want = j_sim.page_op_params(j_interface.make_interface(kind),
                                    j_nand.chip(cell), mode, ways)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert sim.steady_state_mb_s(got, ways) == \
            j_sim.steady_state_mb_s(want, ways)
        assert sim.saturation_ways(got) == j_sim.saturation_ways(want)


def test_constants_and_arbitration_equal():
    assert (sim.MAX_WAYS, sim.MAX_CHANNELS) == (j_sim.MAX_WAYS,
                                                j_sim.MAX_CHANNELS)
    assert (sim.CTRL_ARB_SWITCH_FRAC, sim.CTRL_ARB_SCAN_FRAC) == (
        j_sim.CTRL_ARB_SWITCH_FRAC, j_sim.CTRL_ARB_SCAN_FRAC)
    for ctrl in (0.0, 3.26, 7.86, 11.5):
        for channels in range(1, 9):
            assert sim.controller_arb_us(ctrl, channels) == \
                j_sim.controller_arb_us(ctrl, channels)
    assert paper_tables.TABLE3 == j_paper.TABLE3
    assert paper_tables.TABLE4 == j_paper.TABLE4
    assert paper_tables.TABLE5 == j_paper.TABLE5
    assert dataclasses.asdict(timing.derive_paper_clocks()) == \
        dataclasses.asdict(j_timing.derive_paper_clocks())


def test_policy_validation():
    assert sim.policy_is_batched("batched") is True
    assert sim.policy_is_batched("eager") is False
    with pytest.raises(ValueError, match="bathced"):
        sim.policy_is_batched("bathced")
    with pytest.raises(ValueError):
        sim.SSDConfig(policy="bathced")
    cfg = sim.SSDConfig(interface=interface.InterfaceKind.CONV,
                        cell=nand.CellType.MLC, channels=4, ways=4)
    assert cfg.describe() == "conv/mlc 4ch x 4way [eager]"


def test_unported_paths_name_their_slice():
    from repro_torch import api
    from repro_torch.core import trace

    assert not hasattr(api, "UNPORTED_ENGINES")
    s = api.Simulator(sim.SSDConfig(channels=1, ways=2), device="cpu")
    t = trace.steady_trace(8, 1, 2)
    scan = s.run(t).end_us
    for engine in ("prefix", "squaring"):       # slice C runs
        (res,) = s.run_many([t], engine=engine)
        assert res.engine == engine
        assert abs(res.end_us - scan) <= t.n_ops * 2.0 ** -24 * scan
    # slice E runs: the FTL entry points take request streams and specs
    from repro_torch.core import ftl, workload
    spec = ftl.FTLSpec(blocks=16, pages_per_block=8, overprovision=0.3)
    load = workload.overwrite_stream(40, 30, seed=0)
    one = s.run(load, ftl=spec)
    assert one.waf >= 1.0 and one.engine == "scan"
    assert s.run_stream(workload.iter_request_chunks(load, 16),
                        ftl=spec).end_us == one.end_us
    assert s.sweep(None, load, ftl=[spec])[0] == one.end_us


def test_registry_resolves_the_ported_arch_and_names_the_slice():
    """Every id of the JAX package resolves (all ten are ported); an
    unknown id raises naming the available ones."""
    from repro.configs import registry as j_registry
    from repro_torch.configs import registry

    assert registry.ARCH_IDS == j_registry.ARCH_IDS
    assert len(registry.ARCH_IDS) == 10
    for name in registry.ARCH_IDS:
        arch = registry.get_arch(name)
        assert arch.config.name == name
        assert arch.smoke.name.startswith(name.split("-")[0])
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-5")


def test_recurrentgemma_config_reads_as_the_jax_one():
    from repro.configs import recurrentgemma_9b as j_rg
    from repro_torch.configs import recurrentgemma_9b as rg

    for name in ("CONFIG", "SMOKE"):
        got = dataclasses.asdict(getattr(rg, name))
        want = dataclasses.asdict(getattr(j_rg, name))
        assert got == want
    assert rg.ARCH.source == j_rg.ARCH.source
    assert rg.ARCH.notes == j_rg.ARCH.notes
    assert [dataclasses.asdict(s) for s in rg.ARCH.shapes] == \
        [dataclasses.asdict(s) for s in j_rg.ARCH.shapes]
    assert rg.CONFIG.num_units == 12 and rg.CONFIG.padded_vocab == 256000


def _meta_qkv(spec, s):
    q = torch.empty((1, s, spec.n_kv_heads, spec.q_groups, spec.head_dim),
                    device="meta")
    k = torch.empty((1, s, spec.n_kv_heads, spec.head_dim), device="meta")
    return q, k, k


def test_card_attention_path_raises_on_what_the_kernel_lacks():
    """Off the CPU, attention goes to the flash-attention kernel: its index
    path for positions None, its EXT path for caller positions (shifted,
    or non-text M-RoPE ids, which rotate q and k before ``attend``) and
    for the soft cap.  What the kernel lacks raises instead of taking a
    plain branch: positions on another device than q, a cap that is not a
    positive finite float.  (Meta tensors stand in for the card's: the
    checks run before any data; on meta the wrapper then allocates its
    output and reports the launch's work without launching, as the dry
    run plans it.)"""
    from repro_torch.kernels import work
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import attention

    spec = attention.AttnSpec(n_heads=4, n_kv_heads=1, head_dim=16, window=8)
    q, k, v = _meta_qkv(spec, 6)
    shifted = torch.arange(6, dtype=torch.int32)[None] + 3
    with pytest.raises(ValueError, match="is on cpu"):
        attention.attend(spec, q, k, v, shifted)
    text = torch.arange(6, dtype=torch.int32)[None]
    ids = torch.stack([text, text, text + 1])
    mspec = dataclasses.replace(spec, rope_kind="mrope",
                                mrope_sections=(2, 3, 3))
    mq, mk = attention._apply_positional(
        mspec, torch.ones(q.shape), torch.ones(k.shape), text, ids)
    capped = dataclasses.replace(spec, softcap=30.0)
    with work.recording() as log:
        out = attention.attend(mspec, mq.to("meta"), mk.to("meta"), v, None)
        assert out.device.type == "meta" and out.shape == mq.shape
        for sp, pos in ((spec, shifted), (mspec, text), (capped, None)):
            out = attention.attend(sp, q, k, v, None if pos is None
                                   else pos.to("meta"))
            assert out.device.type == "meta" and out.shape == q.shape
    assert log.calls == {flash_kernel.route(mq.dtype): 4}
    with pytest.raises(ValueError, match="softcap"):
        attention.attend(dataclasses.replace(spec, softcap=0.0), q, k, v,
                         None)


def test_lm_entry_points_default_to_the_card():
    from repro_torch.configs.base import smoke_batch
    from repro_torch.configs.recurrentgemma_9b import SMOKE
    from repro_torch.models import transformer
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import ServingEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults resolve to it")
    calls = [lambda: transformer.init_params(SMOKE, 0),
             lambda: transformer.init_cache(SMOKE, 1, 8),
             lambda: smoke_batch(SMOKE),
             lambda: params_from_jax({}),
             lambda: ServingEngine(SMOKE, {}, max_seq=8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_smoke_batch_and_shape_grid():
    from repro.configs import base as j_base
    from repro_torch.configs import base
    from repro_torch.configs.recurrentgemma_9b import ARCH, SMOKE

    batch = base.smoke_batch(SMOKE, batch=3, seq=10, seed=4, device="cpu")
    again = base.smoke_batch(SMOKE, batch=3, seq=10, seed=4, device="cpu")
    assert batch["inputs"].shape == (3, 10)
    assert batch["inputs"].dtype == torch.int32
    assert torch.equal(batch["inputs"], again["inputs"])
    assert int(batch["labels"].max()) < SMOKE.vocab_size
    for long_context in (True, False):
        got = [dataclasses.asdict(s)
               for s in base.lm_shapes(long_context=long_context)]
        want = [dataclasses.asdict(s)
                for s in j_base.lm_shapes(long_context=long_context)]
        assert got == want
    assert ARCH.shape("decode_32k").global_batch == 128
    with pytest.raises(KeyError, match="no shape"):
        ARCH.shape("train_1m")
