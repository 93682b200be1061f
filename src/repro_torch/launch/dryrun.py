"""Dry run: plan every (architecture x input shape x mesh) cell without
running it on a device.

The port of the JAX package's ``repro.launch.dryrun``.  JAX lowers and
compiles each cell against placeholder devices and reads XLA's memory and
cost analyses and the optimized HLO (``repro.launch.hlo_analysis``).  The
port emits no HLO, so that parser is not ported; instead the cell's step
(``launch.steps.plan_cell``) runs eagerly on the meta device — shapes and
dtypes, no data — through the same code the card runs, the hand-written
kernels' wrappers included (on meta they allocate what they allocate on
the card and report their work to ``kernels.work``), under three
counters:

* ``FlopCounterMode`` plus the kernels' reports give
  ``dot_flops_per_device``: matrix products only (mm, bmm, addmm, baddbmm
  and the kernels' own), as ``hlo_analysis``' dot count.  Eager torch runs
  every unit and microbatch, so there are no loop trip counts to recover;
* a ``TorchDispatchMode`` (``MetaRun``) sums operand + result bytes of
  every aten op that moves data (views and ``empty`` excluded) plus the
  kernels' bytes into ``traffic_bytes_per_device``, eager torch's
  counterpart of "fusions touch memory once";
* the same mode follows the storages the step creates (``StorageWeakRef``)
  and records ``peak_bytes``, the step's own rise above its arguments —
  the counterpart of ``memory_analysis()`` — both as raw storage bytes and
  rounded as the CUDA caching allocator charges a block (512 B).  Under a
  dispatch mode the backward takes the functional op for two sums it does
  in place on the card (a second gradient into its buffer, ``gather``'s
  scatter into zeros); the mode counts each in its first operand's bytes
  (``MetaRun._in_place_on_card``).

On the ``card`` mesh (one H100) a record also says whether the cell
``fits``: its arguments plus the peak within the card's memory.  On the
production meshes (``single``, ``multi``) a record holds the per-device
argument bytes from the partition specs (``distributed.partitioning``;
every sharded dim must divide) and the same counts of one rank's
program: ``plan_cell(rank=)`` gives the rank its slices of the state,
the parameters and the cache and the step the port runs there (the
``Trainer``'s step, or the serving steps inside ``ctx.model_parallel``),
whose groups are stand-ins (``launch.mesh.plan_mesh``) that move no data
and log each collective, so the record adds ``collective_bytes_per_device``
and the bytes and calls by kind.  Rank 0 is planned, and the last
``model`` rank too where the programs differ (``planned_ranks``); the
larger peak is the record's.  No device memory is named for those
meshes, so they say nothing of ``fits``.  llama4's ``fsdp_units``
(ZeRO-3) plans its rank with its blocks of the parameters along
``data``, one unit gathered at a time (the gathers and the gradients'
reduce-scatters among its collectives).  A cell whose rules the port
refuses by name (an RG-LRU's gate heads straddling ``model`` ranks)
keeps its argument bytes and says ``"not planned (ROADMAP item N)"``; a
split that does not divide (``--moe-mode e_data_f_model`` with 40
experts over 16 data ranks) is an error naming the leaf.
``collective_bytes_per_device`` is 0 on one card.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh card
    python -m repro_torch.launch.dryrun --arch llama4-maverick-400b-a17b --mesh all
    python -m repro_torch.launch.dryrun --all [--mesh all] [--force] [--jobs N]

Records go to ``build/dryrun/<arch>__<shape>__<mesh><tag>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import re
import time
import traceback
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.distributed import ctx
from repro_torch.distributed import partitioning as part
from repro_torch.kernels import work
from repro_torch.launch.mesh import MESH_NAMES, make_mesh, mesh_chip_count
from repro_torch.launch.steps import CellPlan, plan_cell
from repro_torch.models.transformer import ModelConfig, init_params
from repro_torch.train.optimizer import OptConfig, tree_paths

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: the CUDA caching allocator's block granularity: a request is charged
#: in multiples of 512 bytes (``memory_allocated`` counts the blocks)
ALLOC_ROUND = 512
#: the products ``dot_flops_per_device`` counts
DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")
#: the backward's functional sums that the card runs in place
_IN_PLACE_ON_CARD = frozenset({torch.ops.aten.add.Tensor,
                               torch.ops.aten.scatter_add.default})
#: ops that allocate without reading or writing data
_NO_TRAFFIC = frozenset({torch.ops.aten.empty.memory_format,
                         torch.ops.aten.empty_strided.default,
                         torch.ops.aten.empty_like.default})


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    # 8-bit moments for the configs sharded by unit (llama4's 400 B)
    return OptConfig(moment_dtype="int8" if cfg.fsdp_units else "f32")


def active_param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total_params, active_non_embedding_params) from meta shapes."""
    shapes = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    total = active = 0
    moe_frac = (cfg.moe.top_k / cfg.moe.n_experts) if cfg.moe else 1.0
    for key_path, leaf in tree_paths(shapes):
        path = "/".join(key_path)
        n = leaf.numel()
        total += n
        if path.startswith("embed/"):
            continue
        if "/ffn/" in path and re.search(r"/ffn/(wi|wg|wo)$", path) \
                and cfg.moe and leaf.dim() == 4:  # stacked [U, E, ...] experts
            active += int(n * moe_frac)
            continue
        active += n
    return int(total), int(active)


def model_flops(cfg: ModelConfig, kind: str, seq: int, batch: int) -> float:
    _, n_active = active_param_count(cfg)
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# the meta run
# ---------------------------------------------------------------------------


def _alloc_bytes(n: int) -> int:
    """What the caching allocator charges for an ``n``-byte storage."""
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class MetaRun(TorchDispatchMode):
    """Traffic and peak of the storages created while it is active.

    A composite op is run as its parts (``OpOverload.decompose``), as the
    card's backend runs it.  Storages of ``held`` (the step's arguments)
    are not counted.  A storage is live while a tensor seen on it is
    (a weak reference to each tensor reports its death); once the last
    one has died the storage becomes a suspect, which is looked at
    (``StorageWeakRef.expired``) only when the live sum would raise a
    peak, so the peaks are exact.  Inside ``saved_tensors()`` autograd
    keeps a ``detach()`` of each tensor it saves, so that the tensors it
    holds are seen too.  A sum of the backward that the card may do in
    place (``_in_place_on_card``) is charged without its left operand,
    and charged whole at the next op (or the end) if the operand is
    still held then: the card's autograd adds in place only into a
    gradient nothing else holds."""

    def __init__(self, held=()):
        super().__init__()
        self._held = {StorageWeakRef(t.untyped_storage())
                      for t in _tensors(held)}
        self._size: dict[StorageWeakRef, tuple[int, int]] = {}
        self._tensors: dict[StorageWeakRef, int] = {}  # live tensors seen
        self._watch: dict[int, tuple] = {}     # id(weakref) -> (it, id, ref)
        self._seen: set[int] = set()           # ids of live tensors seen
        self._suspects: set[StorageWeakRef] = set()
        self._made_in_backward: set[StorageWeakRef] = set()
        # left operands of in-place sums, with the live sums beside them
        self._pending: list[tuple[StorageWeakRef, int, int]] = []
        self._raw = self._alloc = 0
        self.peak_bytes = self.peak_alloc_bytes = 0
        self.traffic_bytes = 0
        self.ops = 0

    def saved_tensors(self):
        """Autograd saves a seen ``detach()`` of each tensor."""
        return torch.autograd.graph.saved_tensors_hooks(
            lambda t: t.detach(), lambda t: t)

    def _died(self, wr) -> None:
        _, tid, ref = self._watch.pop(id(wr))
        self._seen.discard(tid)
        self._tensors[ref] -= 1
        if not self._tensors[ref]:
            self._suspects.add(ref)

    def _sweep(self) -> None:
        # a copy: a death reported while this runs adds a suspect
        for ref in list(self._suspects):
            if self._tensors[ref]:            # a tensor seen on it again
                self._suspects.discard(ref)
            elif ref.expired():
                self._suspects.discard(ref)
                raw, alloc = self._size.pop(ref)
                del self._tensors[ref]
                self._made_in_backward.discard(ref)
                self._raw -= raw
                self._alloc -= alloc

    def _track(self, t: torch.Tensor) -> bool:
        """Follow ``t`` and its storage; True for a new storage."""
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref in self._held:
            return False
        new = ref not in self._size
        if new:
            n = st.nbytes()
            self._size[ref] = (n, _alloc_bytes(n))
            if _in_backward():
                self._made_in_backward.add(ref)
            self._tensors[ref] = 0
            self._raw += n
            self._alloc += _alloc_bytes(n)
        if id(t) not in self._seen:
            self._seen.add(id(t))
            self._tensors[ref] += 1
            wr = weakref.ref(t, self._died)
            self._watch[id(wr)] = (wr, id(t), ref)
        return new

    def _in_place_on_card(self, func, args, kwargs) -> bool:
        """Whether ``func`` is one of the backward's sums that the card
        does in place and a dispatch mode does not: the autograd engine
        adding a second gradient into a buffer it owns (``InputBuffer``),
        and ``gather``'s backward scattering into its fresh zeros — C++
        takes the functional op wherever a tensor may be a subclass, which
        every tensor under a dispatch mode may be.  The first argument
        must be a dense tensor, the whole of a storage the backward made."""
        if func not in _IN_PLACE_ON_CARD or not _in_backward():
            return False
        a = args[0]
        if func is torch.ops.aten.add.Tensor:
            b = args[1] if len(args) > 1 else None
            if not (isinstance(b, torch.Tensor) and not kwargs
                    and a.shape == b.shape and a.dtype == b.dtype):
                return False
        return (a.is_contiguous() and StorageWeakRef(a.untyped_storage())
                in self._made_in_backward
                and a.untyped_storage().nbytes()
                == a.numel() * a.element_size())

    def _settle(self) -> None:
        """Charge whole each pending sum whose left operand is still held:
        it was not summed in place."""
        for ref, raw, alloc in self._pending:
            if not ref.expired():
                self.peak_bytes = max(self.peak_bytes, raw)
                self.peak_alloc_bytes = max(self.peak_alloc_bytes, alloc)
        self._pending.clear()

    def __exit__(self, *exc):
        self._settle()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._settle()
        # a composite op (einsum, matmul, reshape under inference_mode) runs
        # as its parts, whose intermediates the card's backend allocates too
        if _composite(func):
            with self:
                parts = func.decompose(*args, **kwargs)
            if parts is not NotImplemented:
                return parts
        out = func(*args, **kwargs)
        self.ops += 1
        outs = _tensors(out)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.traffic_bytes += work.tensor_bytes(
                *_tensors((args, kwargs)), *outs)
        grew = False
        for t in outs:
            grew |= self._track(t)
        if grew and (self._raw > self.peak_bytes
                     or self._alloc > self.peak_alloc_bytes):
            self._sweep()
            raw, alloc = 0, 0           # the left operand, if in place
            if self._in_place_on_card(func, args, kwargs):
                ref = StorageWeakRef(args[0].untyped_storage())
                raw, alloc = self._size[ref]
                self._pending.append((ref, self._raw, self._alloc))
            self.peak_bytes = max(self.peak_bytes, self._raw - raw)
            self.peak_alloc_bytes = max(self.peak_alloc_bytes,
                                        self._alloc - alloc)
        return out


def _in_backward() -> bool:
    """Whether the autograd engine is running a backward now (with the
    gradient off: not remat's recomputation)."""
    return (torch._C._current_graph_task_id() != -1
            and not torch.is_grad_enabled())


@functools.cache
def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


@dataclasses.dataclass
class MetaCounts:
    dot_flops: float
    traffic_bytes: float
    peak_bytes: int
    peak_alloc_bytes: int
    ops: int
    kernels: dict
    constraints: list
    seconds: float
    #: a rank's plan: its collectives by kind, {"calls", "bytes"}
    collectives: dict = dataclasses.field(default_factory=dict)


def run_meta(plan: CellPlan, mesh) -> MetaCounts:
    """Run ``plan``'s step on its meta arguments under the counters."""
    t0 = time.perf_counter()
    with ctx.activation_sharding(mesh, plan.rules) as shard, \
            work.recording() as log, \
            FlopCounterMode(display=False) as flops, \
            MetaRun(plan.args) as run, run.saved_tensors():
        result = plan.run()
        del result
    counts = flops.get_flop_counts().get("Global", {})
    dots = sum(n for op, n in counts.items()
               if getattr(op, "__name__", str(op)).split(".")[-1] in DOT_OPS)
    seen = {}
    for dims, spec in shard.records:
        seen[(dims, tuple(spec))] = seen.get((dims, tuple(spec)), 0) + 1
    return MetaCounts(
        dot_flops=float(dots + log.total_flops),
        traffic_bytes=float(run.traffic_bytes + log.total_bytes),
        peak_bytes=run.peak_bytes, peak_alloc_bytes=run.peak_alloc_bytes,
        ops=run.ops,
        kernels={k: {"calls": log.calls[k], "flops": log.flops[k],
                     "bytes": log.nbytes[k]} for k in log.calls},
        constraints=[{"dims": list(d), "spec": list(s), "calls": n}
                     for (d, s), n in seen.items()],
        seconds=time.perf_counter() - t0,
        collectives={k: dict(v) for k, v in (plan.collectives or {}).items()})


def arg_bytes(plan: CellPlan, mesh) -> dict[str, int]:
    """Per-device bytes of the cell's arguments, by group, from their
    specs (``local_nbytes``; a sharded dim that does not divide raises)."""
    out = {name: part.tree_local_nbytes(tree, specs, mesh)
           for name, (tree, specs) in plan.groups.items()}
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# one rank's program on a production mesh
# ---------------------------------------------------------------------------


def planned_ranks(cfg: ModelConfig, shape, mesh) -> tuple[int, ...]:
    """The mesh positions whose programs the dry run plans: rank 0, and
    the last ``model`` rank where the ranks' programs differ — the
    sequence-sharded attention of a train or prefill cell, whose last
    query chunk does the most work.  Elsewhere every model rank runs the
    same shapes on its own slices, and rank 0 stands for them all."""
    tp = part.axis_size(mesh, part.MODEL_AXIS)
    layers = cfg.pattern + cfg.tail
    seq = (tp > 1 and shape.kind != "decode" and shape.seq_len % tp == 0
           and any(sp.mixer == "attn" for sp in layers)
           and part.attn_mode(cfg.n_heads, cfg.n_kv_heads, tp) == "seq")
    return (0, tp - 1) if seq else (0,)


def plan_ranks(cfg: ModelConfig, shape, mesh, **kw) -> dict:
    """The record of a cell on a production mesh from the meta runs of
    its ``planned_ranks``' programs (``plan_cell(rank=)``): per device,
    the larger rank's peak and its dot flops, traffic and collectives
    (calls and bytes by kind), each rank's beside.  A cell whose rules the
    port refuses by name (``partitioning.tp_plan``) records
    ``"not planned (ROADMAP item N)"`` instead."""
    try:
        part.tp_plan(cfg, mesh)
    except NotImplementedError as e:
        item = re.search(r"ROADMAP item \d+", str(e))
        why = f"not planned ({item.group(0) if item else e})"
        return {"activation_peak": why, "peak_bytes": why,
                "dot_flops_per_device": why, "traffic_bytes_per_device": why,
                "collective_bytes_per_device": why, "refused": str(e)}
    runs = {r: run_meta(plan_cell(cfg, shape, mesh, rank=r, **kw), mesh)
            for r in planned_ranks(cfg, shape, mesh)}
    top = max(runs, key=lambda r: (runs[r].peak_alloc_bytes, r))
    m = runs[top]
    return {
        "planned_ranks": list(runs), "peak_rank": top,
        "meta_run_s": sum(x.seconds for x in runs.values()),
        "aten_ops": m.ops,
        "dot_flops_per_device": max(x.dot_flops for x in runs.values()),
        "traffic_bytes_per_device": max(x.traffic_bytes
                                        for x in runs.values()),
        "peak_bytes": m.peak_bytes, "peak_alloc_bytes": m.peak_alloc_bytes,
        "collective_bytes_per_device": sum(
            v["bytes"] for v in m.collectives.values()),
        "collective_bytes_by_kind": {k: v["bytes"]
                                     for k, v in m.collectives.items()},
        "collective_counts": {k: v["calls"]
                              for k, v in m.collectives.items()},
        "kernels": m.kernels, "activation_constraints": m.constraints,
        "ranks": {str(r): {"dot_flops": x.dot_flops,
                           "traffic_bytes": x.traffic_bytes,
                           "peak_bytes": x.peak_bytes,
                           "peak_alloc_bytes": x.peak_alloc_bytes,
                           "collectives": x.collectives,
                           "kernels": x.kernels, "meta_run_s": x.seconds}
                  for r, x in runs.items()}}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def run_cell(arch_name: str, shape_name: str, mesh_name: str,
             outdir: pathlib.Path, force: bool = False,
             grad_accum: int = 1, remat: str | None = None,
             moe_mode: str | None = None, tag: str = "") -> dict:
    """Plan one cell on ``mesh_name`` (``card``, ``single`` or ``multi``)
    and write its record to ``outdir``; an existing record is returned
    unless ``force``."""
    cell_id = f"{arch_name}__{shape_name}__{mesh_name}{tag}"
    outfile = pathlib.Path(outdir) / f"{cell_id}.json"
    if outfile.exists() and not force:
        return json.loads(outfile.read_text())

    arch = get_arch(arch_name)
    cfg, shape = arch.config, arch.shape(shape_name)
    kw = {}
    if remat is not None:
        kw["remat"] = remat
    if moe_mode is not None:
        kw["moe_shard_mode"] = moe_mode
    if kw:
        cfg = dataclasses.replace(cfg, **kw)
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                 "kind": shape.kind, "seq_len": shape.seq_len,
                 "global_batch": shape.global_batch,
                 "grad_accum": grad_accum, "remat": cfg.remat}
    if shape.skip:
        rec.update(status="skipped", reason=shape.skip)
        outfile.write_text(json.dumps(rec, indent=1))
        return rec

    try:
        mesh = make_mesh(mesh_name)
        chips = mesh_chip_count(mesh)
        total, active = active_param_count(cfg)
        rec.update(chips=chips, params_total=total, params_active=active,
                   model_flops_global=model_flops(
                       cfg, shape.kind, shape.seq_len, shape.global_batch))
        t0 = time.perf_counter()
        plan = plan_cell(cfg, shape, mesh, ocfg=opt_config_for(cfg),
                         grad_accum=grad_accum)
        args = arg_bytes(plan, mesh)
        rec.update(plan_s=time.perf_counter() - t0,
                   arg_bytes_per_device=args,
                   activation_rules={k: v for k, v in plan.rules.items()})
        if mesh_name != "card":
            rec.update(status="ok", **plan_ranks(
                cfg, shape, mesh, ocfg=opt_config_for(cfg),
                grad_accum=grad_accum), useful_flops_ratio=None)
            if isinstance(rec["dot_flops_per_device"], float):
                rec["useful_flops_ratio"] = rec["model_flops_global"] / max(
                    rec["dot_flops_per_device"] * chips, 1.0)
        else:
            m = run_meta(plan, mesh)
            rec.update(
                status="ok", meta_run_s=m.seconds, aten_ops=m.ops,
                dot_flops_per_device=m.dot_flops,
                traffic_bytes_per_device=m.traffic_bytes,
                collective_bytes_per_device=0,
                peak_bytes=m.peak_bytes,
                peak_alloc_bytes=m.peak_alloc_bytes,
                kernels=m.kernels, activation_constraints=m.constraints,
                device_memory=mesh.device_memory,
                device_memory_source=mesh.memory_source,
                fits=args["total"] + m.peak_alloc_bytes
                <= mesh.device_memory,
                useful_flops_ratio=rec["model_flops_global"]
                / max(m.dot_flops * chips, 1.0))
    except Exception as e:  # a failed cell is a bug — record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    outfile.write_text(json.dumps(rec, indent=1))
    return rec


def _line(rec: dict) -> str:
    msg = (f"[{rec['status']:7s}] {rec['arch']:28s} {rec['shape']:12s} "
           f"{rec['mesh']:6s}")
    if rec["status"] == "ok":
        msg += f" args={rec['arg_bytes_per_device']['total'] / 2**30:8.2f}GiB"
        if isinstance(rec.get("peak_alloc_bytes"), int):
            msg += (f" peak={rec['peak_alloc_bytes'] / 2**30:8.2f}GiB "
                    f"fits={str(rec.get('fits', '-')):5s} "
                    f"coll={rec['collective_bytes_per_device'] / 2**30:8.3f}"
                    f"GiB useful={rec['useful_flops_ratio']:5.2f} "
                    f"meta={rec['meta_run_s']:7.1f}s")
        elif "activation_peak" in rec:
            msg += " " + rec["activation_peak"]
    elif rec["status"] == "error":
        msg += " " + rec["error"][:120]
    return msg


def _run_job(job) -> dict:
    arch, shape, mesh, outdir, force, accum, remat, moe_mode, tag = job
    return run_cell(arch, shape, mesh, outdir, force=force, grad_accum=accum,
                    remat=remat, moe_mode=moe_mode, tag=tag)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESH_NAMES + ("all",), default="card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--outdir", default=str(RESULTS_DIR))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default=None, choices=("none", "full", "dots"))
    ap.add_argument("--moe-mode", default=None,
                    choices=("auto", "e_data_f_model", "f_model"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells planned at once, one process each")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = MESH_NAMES if args.mesh == "all" else (args.mesh,)

    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in get_arch(a).shapes]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s.name) for s in get_arch(args.arch).shapes]
    else:
        ap.error("give --arch (and --shape), or --all")

    n = {"ok": 0, "skipped": 0, "error": 0}
    jobs = [(a, s, m, outdir, args.force, args.grad_accum, args.remat,
             args.moe_mode, args.tag) for a, s in cells for m in meshes]
    t0 = time.perf_counter()
    if args.jobs > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.imap(_run_job, jobs)
            for rec in recs:
                n[rec["status"]] += 1
                print(_line(rec), flush=True)
    else:
        for job in jobs:
            rec = _run_job(job)
            n[rec["status"]] += 1
            print(_line(rec), flush=True)
    print(f"dry-run: {len(jobs)} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"dry-run: ok={n['ok']} skipped={n['skipped']} "
          f"error={n['error']}", flush=True)
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
