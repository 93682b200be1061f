"""The port's dry run (``launch.dryrun``, ``launch.steps.plan_cell``) on
the CPU, where the meta device needs no card:

* every SMOKE config x train / prefill / decode is planned and run on meta
  on the ``card`` mesh; its argument bytes equal those of the same
  arguments made as real CPU tensors;
* the matrix-product flops of the meta run against the JAX package's
  ``hlo_analysis.analyze_module(...).dot_flops`` of the same cell, lowered
  and compiled on a 1 x 1 host mesh (Auto axes), for qwen2-0.5b and
  recurrentgemma-9b SMOKE at B = 2: within 1 % once the terms by which
  the card's path computes more than JAX's plain attention are named and
  taken off (``k4_terms``) — at S = 128 there are none in the forward;
* the K4 / K5 wrappers on meta tensors: shapes and dtypes of the plain
  versions, the card path's allocations, their reported work;
* ``ctx.constrain``: the identity, recording specs inside a context only,
  and the model's results bit-equal inside a context and outside;
* the CLI writes its JSON records, at full size and on a SMOKE config;
* one rank's plan (``plan_cell(rank=)``) on ``(1, 2)`` and ``(2, 2)``:
  every SMOKE cell of qwen2-0.5b (and granite-moe's decode, whose MoE
  gathers the global batch over ``data``) logs the collectives — kind,
  calls, bytes — that four gloo ranks on the CPU issue running the same
  step; the production records of qwen2-0.5b carry the per-device peak,
  flops, traffic and collectives, and llama4's say "not planned (ROADMAP
  item 30)".
"""

import dataclasses
import functools
import json
import math
import pickle

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.launch import hlo_analysis
from repro.launch import steps as j_steps
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec, smoke_batch
from repro_torch.distributed import ctx
from repro_torch.distributed import partitioning as part
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import tiles
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_lse_reference,
    attention_reference)
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.kernels.rglru.ref import (rglru_scan_backward_ref,
                                           rglru_scan_ref)
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (H100_TOTAL_MEMORY, MeshSpec,
                                     make_card_mesh, make_data_mesh)
from repro_torch.storage.checkpoint import place_on_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.train.optimizer import OptConfig, tree_paths

ARCHS = registry.ARCH_IDS
KINDS = ("train", "prefill", "decode")
CARD = make_card_mesh("meta")
B, S = 2, 64
FLOPS_TOL = 0.01


def smoke_shape(kind: str, seq: int = S) -> ShapeSpec:
    return ShapeSpec(f"smoke_{kind}", kind, seq, B)


def nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_paths(tree)
               if isinstance(x, torch.Tensor))


def real_args(cfg, kind: str) -> int:
    """Bytes of the cell's arguments made as real CPU tensors."""
    batch = smoke_batch(cfg, batch=B, seq=S, device="cpu")
    if kind == "train":
        state = steps.init_train_state(cfg, dryrun.opt_config_for(cfg), 0,
                                       device="cpu")
        return nbytes(state) + nbytes(batch)
    params = init_params(cfg, 0, device="cpu")
    if kind == "prefill":
        return nbytes(params) + nbytes({k: v for k, v in batch.items()
                                        if k != "labels"})
    inputs = {k: v[:, :1] if k == "inputs" else v[:, :, :1]
              for k, v in batch.items() if k != "labels"}
    return (nbytes(params) + nbytes(init_cache(cfg, B, S, device="cpu"))
            + nbytes(inputs))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_plan_and_run_on_meta(arch, kind):
    cfg = registry.get_arch(arch).smoke
    plan = steps.plan_cell(cfg, smoke_shape(kind), CARD,
                           ocfg=dryrun.opt_config_for(cfg))
    assert all(x.device.type == "meta"
               for x in torch.utils._pytree.tree_leaves(plan.args)
               if isinstance(x, torch.Tensor))
    args = dryrun.arg_bytes(plan, CARD)
    assert args["total"] == real_args(cfg, kind)
    assert set(args) == {"params", "batch", "total"} | (
        {"opt"} if kind == "train" else {"cache"} if kind == "decode"
        else set())
    m = dryrun.run_meta(plan, CARD)
    assert m.dot_flops > 0 and m.traffic_bytes > 0 and m.peak_bytes > 0
    assert m.peak_alloc_bytes >= m.peak_bytes
    n_attn = sum(sp.mixer == "attn" for sp in cfg.pattern) * cfg.num_units \
        + sum(sp.mixer == "attn" for sp in cfg.tail)
    n_rglru = sum(sp.mixer == "rglru" for sp in cfg.pattern) \
        * cfg.num_units + sum(sp.mixer == "rglru" for sp in cfg.tail)
    calls = {k: v["calls"] for k, v in m.kernels.items()}
    want = {}
    if kind != "decode":            # decode attends against the cache
        want.update({FK.TC: n_attn, RK.TOTAL: n_rglru})
    if kind == "train":             # SMOKE configs take remat "none"
        want.update({FK.BWD_ROUTES[FK.TC]: n_attn, RK.BWD: n_rglru})
    assert calls == {k: v for k, v in want.items() if v}
    if kind == "train" and n_attn:  # attn_full constrains q and positions
        assert {tuple(c["dims"]) for c in m.constraints} >= {
            ("batch", "seq", None, None, None), ("batch", "seq")}


# -- dot flops against JAX's hlo_analysis ----------------------------------


@functools.cache
def jax_dot_flops(arch: str, kind: str, seq: int) -> float:
    cfg = j_registry.get_arch(arch).smoke
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    lowered, _ = j_steps.lower_cell(
        cfg, j_base.ShapeSpec(f"smoke_{kind}", kind, seq, B), mesh,
        ocfg=JOptConfig())
    return hlo_analysis.analyze_module(lowered.compile().as_text()).dot_flops


def k4_terms(cfg, kind: str, seq: int) -> dict[str, float]:
    """The flops by which the card's path differs from JAX's plain
    attention, which computes every (query, key) pair of the S x S square
    (4 S² D a head forward, 8 S² D backward):

    * ``k4_tile_padding``: K4's forward counts every visited kv tile whole
      (``tiles.computed_flops``); at S = 64 a bf16 block's 128 query rows
      hold 64 real ones, so it counts twice the square;
    * ``k4_bwd_recompute``: K4's backward recomputes q·kᵀ, 10 D a pair of
      its visited tiles (``kernel.bwd_flops``) against JAX's 8 D."""
    n_attn = sum(sp.mixer == "attn" for sp in cfg.pattern) * cfg.num_units
    h, d = cfg.n_heads, cfg.hd
    square = B * h * seq * seq * d
    terms = {"k4_tile_padding": 0.0, "k4_bwd_recompute": 0.0}
    if kind == "decode":
        return terms
    for sp in cfg.pattern:
        if sp.mixer != "attn":
            continue
        bq, bk = FK.tile(FK.TC, d)
        computed = tiles.computed_flops(B, h, d, sq=seq, sk=seq, causal=True,
                                        window=sp.window, q_offset=0, bq=bq,
                                        bk=bk)
        terms["k4_tile_padding"] += cfg.num_units * (computed - 4 * square)
        if kind == "train":
            terms["k4_bwd_recompute"] += cfg.num_units * (
                FK.bwd_flops(B, h, seq, d, True, sp.window, True)
                - 8 * square)
    assert n_attn and cfg.cdtype == torch.bfloat16
    return terms


CASES = [(a, k, S) for a in ("qwen2-0.5b", "recurrentgemma-9b")
         for k in KINDS] + [(a, "prefill", 128)
                            for a in ("qwen2-0.5b", "recurrentgemma-9b")]


@pytest.mark.parametrize("arch,kind,seq", CASES)
def test_dot_flops_match_jax_hlo_analysis(arch, kind, seq):
    cfg = registry.get_arch(arch).smoke
    plan = steps.plan_cell(cfg, smoke_shape(kind, seq), CARD,
                           ocfg=OptConfig())
    got = dryrun.run_meta(plan, CARD).dot_flops
    want = jax_dot_flops(arch, kind, seq)
    terms = k4_terms(cfg, kind, seq)
    if seq == 128:                  # full tiles: the forward's square
        assert terms["k4_tile_padding"] == 0
    if kind == "decode":
        assert sum(terms.values()) == 0
    assert abs(got - sum(terms.values()) - want) <= FLOPS_TOL * want, \
        (got, want, terms)


# -- the kernels' meta twins ------------------------------------------------


class Allocs(TorchDispatchMode):
    """The shapes and dtypes of every fresh allocation (``empty*``)."""

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


FLASH_CASES = [  # (B, H, KVH, S, D, dtype, window)
    (1, 4, 2, 64, 16, torch.bfloat16, None),
    (2, 14, 2, 300, 64, torch.bfloat16, None),
    (1, 16, 1, 256, 256, torch.bfloat16, 32),
    (2, 4, 4, 100, 8, torch.bfloat16, None),
    (1, 8, 2, 128, 64, torch.float32, 16),
]


def _qkv(b, h, kvh, s, d, dtype, device):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g).to(dtype).to(device)
            for shape in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_meta_twin_forward(case):
    b, h, kvh, s, d, dtype, window = case
    cpu = _qkv(*case[:6], "cpu")
    meta = [x.to("meta") for x in cpu]
    name = FK.route(dtype)
    for with_lse in (False, True):
        want = FK.flash_attention_bhsd(*cpu, window=window,
                                       with_lse=with_lse)
        before = dict(FK.LAUNCHES)
        with work.recording() as log, Allocs() as allocs:
            got = FK.flash_attention_bhsd(*meta, window=window,
                                          with_lse=with_lse)
        assert FK.LAUNCHES == before            # no launch counted
        for g, w in zip(got if with_lse else (got,),
                        want if with_lse else (want,)):
            assert g.device.type == "meta"
            assert (g.shape, g.dtype) == (w.shape, w.dtype)
        # the card path's allocations: the output, lse when asked, and
        # q, k, v and the output padded to D = 16 below it
        out = [((b, h, s, d), dtype)] + ([((b, h, s), torch.float32)]
                                         if with_lse else [])
        padded = [((b, h, s, 16), dtype)] if d < 16 else []
        assert sorted(map(str, allocs.made)) == sorted(map(str, out
                                                           + padded))
        dl = max(d, 16)
        bq, bk = FK.tile(name, dl)
        assert log.calls == {name: 1}
        assert log.flops[name] == tiles.computed_flops(
            b, h, dl, sq=s, sk=s, causal=True, window=window, q_offset=0,
            bq=bq, bk=bk)
    ref = attention_reference(*cpu, window=window)
    assert want[0].shape == ref.shape
    assert attention_lse_reference(*cpu[:2], window=window).shape == \
        want[1].shape


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_meta_twin_backward(case):
    b, h, kvh, s, d, dtype, window = case
    q, k, v = _qkv(*case[:6], "cpu")
    o, lse = FK.flash_attention_bhsd(q, k, v, window=window, with_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1)
                     ).to(dtype)
    want = attention_backward_reference(q, k, v, o, do, lse, window=window)
    meta = [x.to("meta") for x in (q, k, v, o, do, lse)]
    before = dict(FK.BACKWARD_LAUNCHES)
    with work.recording() as log, Allocs() as allocs:
        got = FK.flash_attention_bwd_bhsd(*meta, window=window)
    assert FK.BACKWARD_LAUNCHES == before
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    tc = dtype == torch.bfloat16
    dl = max(d, 16)
    s_pad = tiles.bwd_pad_rows(s) if tc else s
    splits = tiles.dkdv_splits(b, kvh, s, h // kvh) if tc else 1
    n = (2 if tc else 1) * b * h * s_pad + (
        splits * 2 * b * kvh * s * dl if splits > 1 else 0)
    made = [((b, h, s, d), dtype), ((b, kvh, s, d), dtype),
            ((b, kvh, s, d), dtype), ((n,), torch.float32)]
    if d < 16:      # the padded copies' outputs (the pads are F.pad's)
        made += [((b, h, s, dl), dtype), ((b, kvh, s, dl), dtype),
                 ((b, kvh, s, dl), dtype)]
    assert sorted(map(str, allocs.made)) == sorted(map(str, made))
    route = FK.BWD_ROUTES[FK.route(dtype)]
    assert log.calls == {route: 1}
    assert log.flops[route] == FK.bwd_flops(b, h, s, dl, True, window, tc)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("rank", range(4))
def test_flash_meta_twin_backward_of_a_query_chunk(rank, dtype):
    """A query chunk (the sequence-sharded attention's rank ``rank`` of
    four: Sq = S / 4 at q_offset rank S / 4) on meta: gradients of q's and
    k's shapes, the scratch sized by Sq rows and Sk keys, and the work of
    the chunk's own schedule reported (no launch counted)."""
    b, h, kvh, s, d = 1, 6, 2, 256, 64
    n, off = s // 4, rank * s // 4
    q, k, v = _qkv(b, h, kvh, s, d, dtype, "cpu")
    q = q[:, :, :n].contiguous()
    o, lse = FK.flash_attention_bhsd(q, k, v, q_offset=off, with_lse=True)
    meta = [x.to("meta") for x in (q, k, v, o, o, lse)]
    before = dict(FK.CHUNK_LAUNCHES)
    with work.recording() as log, Allocs() as allocs:
        dq, dk, dv = FK.flash_attention_bwd_bhsd(*meta, q_offset=off)
    assert FK.CHUNK_LAUNCHES == before
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    tc = dtype == torch.bfloat16
    s_pad = tiles.bwd_pad_rows(n) if tc else n
    splits = tiles.dkdv_splits(b, kvh, s, h // kvh) if tc else 1
    scratch = (2 if tc else 1) * b * h * s_pad + (
        splits * 2 * b * kvh * s * d if splits > 1 else 0)
    assert ((scratch,), torch.float32) in allocs.made
    route = FK.BWD_ROUTES[FK.route(dtype)]
    assert log.flops[route] == FK.bwd_flops(b, h, n, d, True, None, tc,
                                            sk=s, q_offset=off)
    # the later chunks see more keys: their work grows with the offset
    assert log.flops[route] <= FK.bwd_flops(b, h, s, d, True, None, tc)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ((1, 7, 3), (2, 130, 256)))
def test_rglru_meta_twin(shape, dtype):
    g = torch.Generator().manual_seed(2)
    a = torch.rand(shape, generator=g).to(dtype)
    x = torch.randn(shape, generator=g).to(dtype)
    h = rglru_scan_ref(a, x)
    dh = torch.randn(shape, generator=g).to(dtype)
    da, db = rglru_scan_backward_ref(a, h, dh)
    before = dict(RK.LAUNCHES)
    with work.recording() as log, Allocs() as allocs:
        hm = RK.rglru_scan_kernel(a.to("meta"), x.to("meta"))
        dam, dbm = RK.rglru_scan_backward(a.to("meta"), h.to("meta"),
                                          dh.to("meta"))
    assert RK.LAUNCHES == before
    for got, want in ((hm, h), (dam, da), (dbm, db)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert allocs.made == [(shape, dtype)] * 3
    item = math.prod(shape) * a.element_size()
    assert log.nbytes == {RK.TOTAL: 3 * item, RK.BWD: 5 * item}
    assert log.flops == {RK.TOTAL: 0.0, RK.BWD: 0.0}


def test_meta_twins_report_nothing_outside_recording():
    q, k, v = (x.to("meta") for x in _qkv(1, 2, 2, 32, 16, torch.bfloat16,
                                          "cpu"))
    FK.flash_attention_bhsd(q, k, v)       # no WorkLog installed: dropped
    with work.recording() as log:
        pass
    assert log.calls == {}


# -- the meta run's peak ----------------------------------------------------


def test_meta_run_peak_hand_checked():
    """Arguments are not counted, a view adds nothing, a temporary counts
    while it lives, a tensor autograd saved lives until the backward has
    used it; 1000 floats take 4000 bytes, charged as 4096, a scalar 4
    (charged 512)."""
    x = torch.empty(1000, device="meta", requires_grad=True)
    with dryrun.MetaRun((x,)) as run, run.saved_tensors():
        y = x * 2                        # 4000
        y[:10].view(2, 5)                # a view: nothing
        z = (y + 1).exp()                # y, y + 1 and z: 12000
        del y                            # y + 1 died already; z is saved
        loss = z.sum()                   # 4
        # the backward: its seed (4), exp's gradient (4000) beside z,
        # then x.grad (4000): 12008 at most
        loss.backward()
    assert run.peak_bytes == 3 * 4000 + 2 * 4
    assert run.peak_alloc_bytes == 3 * 4096 + 2 * 512
    with dryrun.MetaRun() as run:
        a = torch.empty(1000, device="meta")
        for _ in range(5):
            a = a + 1                    # one temporary at a time
    assert run.peak_bytes == 8000


class _Triple(torch.autograd.Function):
    """x * 3, with a backward that may sum its gradient and read it on."""

    @staticmethod
    def forward(ctx, x, read_on):
        ctx.read_on = read_on
        return x * 3

    @staticmethod
    def backward(ctx, g):
        t = g * 2                        # a storage the backward made
        s = t + t
        return (s * t if ctx.read_on else s), None


def _backward_peak(forward) -> tuple[int, int]:
    x = torch.empty(1000, device="meta", requires_grad=True)
    with dryrun.MetaRun((x,)) as run, run.saved_tensors():
        forward(x).backward()
    return run.peak_bytes, run.peak_alloc_bytes


def test_meta_run_counts_a_gradient_sum_in_place():
    """Two gradients into u meet in autograd's buffer, which the card
    sums in place: 2 x 4000 bytes at most (and the loss and the seed),
    not the 3 x 4000 of a functional sum; the forward also peaks at
    u, one output of _Triple and the two sums."""
    def forward(x):
        u = x * 1
        return (_Triple.apply(u, False).sum()
                + _Triple.apply(u, False).sum())
    assert _backward_peak(forward) == (2 * 4000 + 2 * 4,
                                       2 * 4096 + 2 * 512)


def test_meta_run_counts_a_sum_whose_operand_is_read_on():
    """A backward that reads ``t`` after ``t + t`` holds t, s and s * t
    at once (3 x 4000 beside the loss and the seed); the same backward
    returning the sum frees t with it: 4000 beside them once the sum is
    counted in place."""
    peak = _backward_peak(lambda x: _Triple.apply(x, True).sum())
    assert peak == (3 * 4000 + 2 * 4, 3 * 4096 + 2 * 512)
    peak = _backward_peak(lambda x: _Triple.apply(x, False).sum())
    assert peak == (4000 + 2 * 4, 4096 + 2 * 512)


# -- ctx.constrain ----------------------------------------------------------


def test_constrain_is_the_identity():
    x = torch.randn(4, 6)
    assert ctx.constrain(x, ("batch", "seq")) is x
    rules = {"batch": ("data",), "seq": "model", "moe_cap": None}
    with ctx.activation_sharding(
            dataclasses.replace(CARD, sizes=(2, 3)), rules) as shard:
        assert ctx.constrain(x, ("batch", "seq")) is x
        y = torch.randn(3, 4)           # 3 % 2, 4 % 3: neither divides
        assert ctx.constrain(y, ("batch", "seq")) is y
    assert ctx.constrain(x, ("batch", None)) is x
    assert shard.records == [(("batch", "seq"), ("data", "model")),
                             (("batch", "seq"), (None, None))]


def test_model_results_bit_equal_inside_a_context():
    cfg = registry.get_arch("granite-moe-3b-a800m").smoke
    params = init_params(cfg, 0, device="cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    lay = {k: v[0] for k, v in params["unit"]["layer0"]["ffn"].items()}
    aspec = cfg.attn_spec(None)
    attn_p = {k: v[0] for k, v in params["unit"]["layer0"]["mixer"].items()}
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)

    def run():
        return (moe_mod.apply_moe(lay, cfg.moe, x),
                attn_mod.attn_full(attn_p, aspec, x, pos))

    outside = run()
    rules = {"batch": ("data",), "seq": "model", "moe_cap": "model"}
    with ctx.activation_sharding(
            dataclasses.replace(CARD, sizes=(2, 2)), rules) as shard:
        inside = run()
    for a, b in zip(outside, inside):
        assert torch.equal(a, b)
    assert len(shard.records) == 6      # 4 in apply_moe, 2 in attn_full


# -- the CLI ----------------------------------------------------------------


def test_cli_writes_records(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh",
                 "all", "--outdir", str(tmp_path)])
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--outdir",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "dry-run: ok=3 skipped=0 error=0" in out
    assert "dry-run: ok=0 skipped=1 error=0" in out
    recs = {p.stem: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert set(recs) == {f"qwen2-0.5b__decode_32k__{m}"
                         for m in ("card", "single", "multi")} | {
        "qwen2-0.5b__long_500k__card"}
    card = recs["qwen2-0.5b__decode_32k__card"]
    assert card["status"] == "ok" and card["collective_bytes_per_device"] == 0
    assert card["device_memory"] == H100_TOTAL_MEMORY
    assert card["fits"] == (card["arg_bytes_per_device"]["total"]
                            + card["peak_alloc_bytes"] <= H100_TOTAL_MEMORY)
    for key in ("dot_flops_per_device", "traffic_bytes_per_device",
                "peak_bytes", "model_flops_global", "useful_flops_ratio"):
        assert card[key] > 0, key
    single = recs["qwen2-0.5b__decode_32k__single"]
    for key in ("peak_bytes", "peak_alloc_bytes", "dot_flops_per_device",
                "traffic_bytes_per_device", "collective_bytes_per_device"):
        assert single[key] > 0, key
    assert "fits" not in single and "activation_peak" not in single
    assert single["collective_counts"]["all_reduce"] > 0
    assert single["chips"] == 256
    assert single["arg_bytes_per_device"]["total"] < \
        card["arg_bytes_per_device"]["total"] / 16
    assert recs["qwen2-0.5b__long_500k__card"]["status"] == "skipped"


def test_cli_on_a_smoke_cell(tmp_path, monkeypatch):
    arch = registry.get_arch("recurrentgemma-9b")
    monkeypatch.setattr(dryrun, "get_arch", lambda name: dataclasses.replace(
        arch, config=arch.smoke))
    dryrun.main(["--arch", "recurrentgemma-9b", "--shape", "train_4k",
                 "--outdir", str(tmp_path), "--tag", "_smoke"])
    rec = json.loads((tmp_path / "recurrentgemma-9b__train_4k__card_smoke"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["fits"] is True
    assert rec["kernels"]["rglru_scan"]["calls"] == 4
    assert rec["arg_bytes_per_device"]["batch"] == 2 * 256 * 4096 * 4


# -- one rank's plan against gloo ranks --------------------------------------

#: (arch, kind) of the cells held on each mesh; B and S of them
RANK_CELLS = [("qwen2-0.5b", k) for k in KINDS] + [
    ("granite-moe-3b-a800m", "decode")]
RANK_B, RANK_S = 4, 8


def rank_shape(kind: str) -> ShapeSpec:
    return ShapeSpec(f"smoke_{kind}", kind, RANK_S, RANK_B)


class Collectives:
    """Counts this process's collectives by the kinds ``ctx.PlanGroup``
    logs (calls, and the bytes of the tensor an all-reduce reduces, an
    all-gather sends, a reduce-scatter's and an all-to-all's whole
    input), by wrapping ``torch.distributed``'s functions, which
    ``distributed.ctx`` looks up at each call."""
    KINDS = {"all_reduce": "all_reduce", "all_gather": "all_gather",
             "reduce_scatter": "reduce_scatter",
             "all_to_all_single": "all_to_all"}

    def __init__(self):
        self.real = {k: getattr(dist, k) for k in self.KINDS}
        self.log = {}

        def wrap(name):
            def call(x, *args, **kwargs):
                t = x if name == "all_reduce" else args[0]
                e = self.log.setdefault(self.KINDS[name],
                                        {"calls": 0, "bytes": 0})
                e["calls"] += 1
                e["bytes"] += sum(y.numel() * y.element_size() for y in
                                  (t if isinstance(t, list) else [t]))
                return self.real[name](x, *args, **kwargs)
            return call
        for k in self.real:
            setattr(dist, k, wrap(k))

    def restore(self) -> dict:
        for k, fn in self.real.items():
            setattr(dist, k, fn)
        return self.log


def run_rank_cell(arch: str, kind: str, mesh, position: int) -> dict:
    """The cell's step on this rank's real CPU slices, its collectives
    counted."""
    cfg = registry.get_arch(arch).smoke
    ocfg = dryrun.opt_config_for(cfg)
    batch = smoke_batch(cfg, batch=RANK_B, seq=RANK_S, device="cpu")
    groups = {"group": mesh.data_group, "model_group": mesh.model_group}
    if kind == "train":
        state = steps.init_train_state(cfg, ocfg, 0, device="cpu")
        specs = steps.train_state_pspecs(cfg, ocfg, mesh,
                                         steps.abstract_train_state(cfg,
                                                                    ocfg))
        args = (place_on_mesh(state, part.shardings(mesh, specs), position),
                batch)
        step = steps.mesh_train_step(cfg, ocfg, mesh, position)[0]
    else:
        params = steps.serve_params(cfg, mesh, init_params(cfg, 0,
                                                           device="cpu"),
                                    position)
        if kind == "prefill":
            step = steps.make_serve_prefill(cfg, RANK_S, **groups)
            args = (params, batch["inputs"])
        else:
            step = steps.make_serve_decode(cfg, RANK_S, **groups)
            args = (params, steps.serve_cache(cfg, mesh, RANK_B, RANK_S,
                                              "cpu"),
                    batch["inputs"][:, :1], RANK_S - 1)
    log = Collectives()
    try:
        with torch.inference_mode(kind != "train"):
            step(*args)
    finally:
        got = log.restore()
    return got


def _rank_cells(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 4),
                            rank=rank, world_size=4)
    try:
        wide = make_data_mesh(model=2, device="cpu")
        alone = [dist.new_group([r]) for r in range(4)]
        pair = MeshSpec(("data", "model"), (1, 2), devices=wide.devices[:2],
                        data_group=alone[rank],
                        model_group=wide.model_group)
        out = {}
        for label, mesh, pos in (("1x2", pair, rank % 2),
                                 ("2x2", wide, rank)):
            for arch, kind in RANK_CELLS:
                out[(label, arch, kind)] = run_rank_cell(arch, kind, mesh,
                                                         pos)
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rank_plans")
    mp.start_processes(_rank_cells, args=(str(tmp),), nprocs=4, join=True,
                       start_method="spawn")
    out = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("label", ("1x2", "2x2"))
@pytest.mark.parametrize("arch,kind", RANK_CELLS)
def test_rank_plan_logs_the_collectives_of_gloo_ranks(gloo_collectives,
                                                      label, arch, kind):
    """``plan_cell(rank=)``'s meta run logs, on its stand-in groups,
    exactly the collectives (kind, calls, bytes) each gloo rank issues
    running the same step on its real slices."""
    cfg = registry.get_arch(arch).smoke
    data = 2 if label == "2x2" else 1
    mesh = MeshSpec(("data", "model"), (data, 2))
    for r, got in enumerate(gloo_collectives[:2 * data]):
        plan = steps.plan_cell(cfg, rank_shape(kind), mesh,
                               ocfg=dryrun.opt_config_for(cfg), rank=r)
        assert plan.rank == r and plan.collectives is not None
        m = dryrun.run_meta(plan, mesh)
        assert m.collectives == got[(label, arch, kind)], (r, m.collectives)
        assert m.collectives["all_reduce"]["calls"] > 0
    if arch.startswith("granite") and data == 2:   # the decode MoE gather
        assert got[(label, arch, kind)]["all_gather"]["calls"] > 0


def test_rank_plan_meta_arguments_are_the_slices():
    """A rank's plan holds that rank's slices: every state leaf of a
    (2, 2) train cell has ``local_shape`` of its spec, and decode's cache
    the shapes the serving steps allocate there."""
    cfg = registry.get_arch("qwen2-0.5b").smoke
    mesh = MeshSpec(("data", "model"), (2, 2))
    plan = steps.plan_cell(cfg, rank_shape("train"), mesh, rank=3)
    state, specs = plan.args[0], steps.train_state_pspecs(
        cfg, OptConfig(), mesh, steps.abstract_train_state(cfg, OptConfig()))
    spec_of = dict(tree_paths(specs))
    whole = dict(tree_paths(steps.abstract_train_state(cfg, OptConfig())))
    for p, x in tree_paths(state):
        assert tuple(x.shape) == part.local_shape(whole[p].shape,
                                                  spec_of[p], mesh), p
    plan = steps.plan_cell(cfg, rank_shape("decode"), mesh, rank=1)
    with ctx.model_parallel(ctx.PlanGroup(1, 2)):
        want = init_cache(cfg, RANK_B // 2, RANK_S, device="meta")
    assert {p: tuple(x.shape) for p, x in tree_paths(plan.args[1])} == {
        p: tuple(x.shape) for p, x in tree_paths(want)}


@pytest.mark.parametrize("rank", (0, 7))
def test_multi_pod_rank_plan_keeps_each_leaf_its_slice(rank):
    """On a (pod, data, model) mesh the gradients sum over pod x data
    while ZeRO-1 splits the moments over ``data`` alone: the train step a
    rank plan runs returns a state of the rank's slices' shapes (its
    ZeRO-1 all-gathers span its pod's data ranks), and its data sums
    span both pods."""
    cfg = registry.get_arch("qwen2-0.5b").smoke
    mesh = MeshSpec(("pod", "data", "model"), (2, 2, 2))
    plan = steps.plan_cell(cfg, rank_shape("train"), mesh, rank=rank)
    new_state, _ = plan.run()
    got = {p: tuple(x.shape) for p, x in tree_paths(new_state)}
    assert got == {p: tuple(x.shape) for p, x in tree_paths(plan.args[0])}
    m = dryrun.run_meta(plan, mesh)
    assert m.collectives["all_gather"]["calls"] > 0


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
def test_production_record_carries_the_rank_plan(tmp_path, shape):
    """qwen2-0.5b's cells on the 16 x 16 mesh: the larger planned rank's
    peak, dot flops, traffic and collectives by kind; no ``fits``.  Its
    2 kv heads and groups of 7 do not divide 16, so train and prefill run
    the sequence-sharded attention, and the last model rank is planned
    too: its query chunk does the most attention work."""
    rec = dryrun.run_cell("qwen2-0.5b", shape, "single", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    for key in ("peak_bytes", "peak_alloc_bytes", "dot_flops_per_device",
                "traffic_bytes_per_device", "collective_bytes_per_device"):
        assert rec[key] > 0, key
    assert rec["collective_bytes_per_device"] == sum(
        rec["collective_bytes_by_kind"].values())
    assert set(rec["collective_counts"]) == set(rec["collective_bytes_by_kind"])
    assert "fits" not in rec and rec["useful_flops_ratio"] > 0
    ranks = [0, 15] if shape != "decode_32k" else [0]
    assert rec["planned_ranks"] == ranks
    if len(ranks) == 2:
        flops = [rec["ranks"][str(r)]["kernels"][FK.TC]["flops"]
                 for r in ranks]
        assert flops[1] > flops[0]


@pytest.mark.parametrize("shape", ("train_4k", "decode_32k"))
@pytest.mark.parametrize("mesh", ("single", "multi"))
def test_llama4_production_cells_are_not_planned(tmp_path, shape, mesh):
    """llama4's ``fsdp_units`` over more than one data rank is planned
    now (it was refused by name): the record carries the rank's peak, its
    dot flops and its collective bytes by kind, every unit's parameters
    gathered over ``data`` (train: twice, the remat's backward again, and
    each unit's gradients reduce-scattered once), and no "not planned"."""
    rec = dryrun.run_cell("llama4-maverick-400b-a17b", shape, mesh, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["arg_bytes_per_device"]["total"] > 0
    for key in ("activation_peak", "peak_bytes",
                "collective_bytes_per_device"):
        assert "not planned" not in str(rec.get(key)), key
    assert rec["peak_alloc_bytes"] > 0 and rec["dot_flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] == sum(
        rec["collective_bytes_by_kind"].values()) > 0
    units = registry.get_arch("llama4-maverick-400b-a17b").config.num_units
    counts = rec["collective_counts"]
    if shape == "train_4k":
        assert counts["reduce_scatter"] == units + 1     # and the final norm
        assert counts["all_gather"] >= 2 * units + 1
    else:
        assert "reduce_scatter" not in counts
        assert counts["all_gather"] >= units + 1
