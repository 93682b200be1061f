"""Fault-tolerant training loop (the end-to-end driver).

The port of the JAX package's ``repro.train.trainer``: the train step
(``repro_torch.launch.steps``), a deterministic data pipeline, async
SSD-priced checkpointing, the straggler watchdog, failure-injection
drills and checkpoint-restart recovery.  The data cursor rides in the
checkpoint manifest, as in JAX.

Without a mesh the state lives on one device (``device``, ``None`` = the
card), ``place_on_device`` restores it, and batches go to the state's
device.  With a ``(data, model)`` mesh (``launch.mesh.make_data_mesh``:
one rank a process, over an initialised ``torch.distributed`` group)
every rank draws the same global batches; each data row runs its rows of
them and the gradients are summed over the data group (``launch.steps``),
and along ``model`` each rank holds its slices of the state
(``train_state_pspecs``) and runs its part of the tensor-parallel model
over its model group, as JAX's jit over the mesh does.  With
``TrainerConfig.zero1`` each rank keeps its slice of the moments and the
master weights over ``data`` too.  A fresh state is drawn whole from
``seed`` on every rank, the state a mesh-less run draws, and each rank
keeps its slices; a restore goes through ``place_on_mesh``; a save
gathers the slices (``gather_from_mesh``) and rank 0 writes the files a
one-device save writes.  A failure on any rank restarts every rank (one
all-reduce MAX over the world).  After ``run()``, ``state`` is this
rank's share of the final state.
"""

from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import partitioning as part
from repro_torch.distributed.fault import (FailureInjector,
                                           RestartableFailure, StepWatchdog)
from repro_torch.launch.steps import (abstract_train_state, init_train_state,
                                      make_train_step, mesh_train_step,
                                      to_device, train_state_pspecs)
from repro_torch.models.transformer import ModelConfig
from repro_torch.storage.checkpoint import (CheckpointEngine,
                                            gather_from_mesh, place_on_device,
                                            place_on_mesh)
from repro_torch.storage.datapipe import PipeState
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.schedules import constant

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None     # None: a new directory under TMPDIR
    grad_accum: int = 1
    zero1: bool = True              # with a mesh: moments sharded on data
    max_restarts: int = 3
    seed: int = 0


class Trainer:
    """A run resumes from the latest checkpoint under ``tcfg.ckpt_dir``
    (one converted from a JAX state, say) or starts from a fresh state
    drawn from ``tcfg.seed``.  ``mesh``: a ``("data", "model")`` mesh over
    the initialised default process group
    (``launch.mesh.make_data_mesh``, whose groups the step runs over),
    this process at position ``dist.get_rank()`` on
    ``mesh.devices[rank]``.  A rule the multi-device step does not port
    raises ``NotImplementedError`` naming its ROADMAP item
    (``partitioning.tp_plan``)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, data, *,
                 ocfg: OptConfig | None = None,
                 schedule: Callable | None = None,
                 injector: FailureInjector | None = None,
                 watchdog: StepWatchdog | None = None, device=None,
                 mesh=None):
        self.cfg, self.tcfg, self.data, self.mesh = cfg, tcfg, data, mesh
        self.ocfg = ocfg or OptConfig()
        self.schedule = schedule or constant(3e-4)
        self.injector = injector or FailureInjector()
        self.watchdog = watchdog or StepWatchdog()
        self.restarts = 0
        self.metrics_history: list[dict] = []
        self.rank, self.group, self.shard = 0, None, None
        self.data_group = None
        if mesh is None:
            self.device = resolve_device(device)
            self._step = make_train_step(cfg, self.ocfg, self.schedule,
                                         grad_accum=tcfg.grad_accum)
        else:
            self._join_mesh(mesh, device)
            self.state_specs = train_state_pspecs(
                cfg, self.ocfg, mesh, abstract_train_state(cfg, self.ocfg),
                zero1=tcfg.zero1)
            self.state_shardings = part.shardings(mesh, self.state_specs)
            # self.shard: this rank's ZeRO-1 share, or None
            self._step, self.shard = mesh_train_step(
                cfg, self.ocfg, mesh, self.rank, self.schedule,
                grad_accum=tcfg.grad_accum, zero1=tcfg.zero1)
        ckpt_dir = tcfg.ckpt_dir
        if ckpt_dir is None:
            if mesh is not None and mesh.size > 1:
                raise ValueError("a data-parallel Trainer needs "
                                 "tcfg.ckpt_dir, one directory its ranks "
                                 "share")
            ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        self.ckpt = CheckpointEngine(ckpt_dir, device=self.device)

    def _join_mesh(self, mesh, device) -> None:
        part.tp_plan(self.cfg, mesh)      # the rules it does not port raise
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a Trainer on a mesh needs an initialised "
                               "torch.distributed process group "
                               "(launch.mesh.make_data_mesh)")
        if dist.get_world_size() != mesh.size or mesh.devices is None:
            raise ValueError(f"the mesh {mesh.shape} over "
                             f"{mesh.devices} does not match the "
                             f"{dist.get_world_size()} ranks of the group")
        tp = mesh.shape[part.MODEL_AXIS]
        if mesh.data_group is None or (tp > 1 and mesh.model_group is None):
            raise ValueError("the mesh has no process groups "
                             "(launch.mesh.make_data_mesh makes them)")
        self.rank = dist.get_rank()
        self.group = dist.group.WORLD
        self.data_group = mesh.data_group
        self.device = mesh.devices[self.rank]
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"device {device} is not this rank's mesh "
                             f"device {self.device}")

    # -- state lifecycle -----------------------------------------------------

    def _fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        state = init_train_state(self.cfg, self.ocfg, gen, device=self.device)
        if self.mesh is None:
            return state
        return place_on_mesh(state, self.state_shardings, self.rank)

    def _resume_or_init(self):
        self.ckpt.wait()      # a save still being written is the latest
        if self.group is not None:
            dist.barrier(group=self.group)    # rank 0's save is on disk
        step = self.ckpt.latest_step()
        if step is None:
            return 0, self._fresh_state()
        shape = abstract_train_state(self.cfg, self.ocfg)
        step, host_state, extra = self.ckpt.restore(step, template=shape)
        if self.mesh is None:
            state = place_on_device(host_state, self.device)
        else:
            state = place_on_mesh(host_state, self.state_shardings, self.rank)
        if "pipe_cursor" in extra and hasattr(self.data, "restore"):
            self.data.restore(PipeState(extra["pipe_cursor"]))
        log.info("resumed from step %d", step)
        return step, state

    def _on_every_rank(self, fn, step: int):
        """``fn()``; on a mesh a ``RestartableFailure`` that any rank's
        ``fn`` raises is raised on every rank (one all-reduce MAX)."""
        err = None
        try:
            out = fn()
        except RestartableFailure as e:
            err, out = e, None
        if self.group is not None:
            flag = torch.tensor(int(err is not None), device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
            if int(flag) and err is None:
                err = RestartableFailure(f"another rank failed at step "
                                         f"{step}")
        if err is not None:
            raise err
        return out

    # -- main loop -------------------------------------------------------------

    def run(self) -> dict[str, Any]:
        while True:
            try:
                return self._run_once()
            except RestartableFailure as e:
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                log.warning("restart %d/%d after: %s",
                            self.restarts, self.tcfg.max_restarts, e)

    def _run_once(self) -> dict[str, Any]:
        step, state = self._resume_or_init()
        it = iter(self.data)
        t_start = time.time()
        last = {}
        while step < self.tcfg.steps:
            batch = to_device(next(it), self.device)
            self._on_every_rank(lambda: self.injector.maybe_fail(step), step)
            self.watchdog.start()
            state, metrics = self._step(state, batch)
            float(metrics["loss"])        # waits for the step's device work
            self._on_every_rank(lambda: self.watchdog.stop(step), step)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                last = {k: float(v) for k, v in metrics.items()}
                last["step"] = step
                self.metrics_history.append(last)
                log.info("step %d loss %.4f lr %.2e gnorm %.2f", step,
                         last["loss"], last["lr"], last["grad_norm"])
            if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                cursor = (self.data.state().cursor
                          if hasattr(self.data, "state") else 0)
                whole = (state if self.mesh is None else gather_from_mesh(
                    state, self.state_shardings, self.group))
                if self.rank == 0:
                    self.ckpt.save(step, whole, extra={"pipe_cursor": cursor})
                del whole
        self.state = state        # this rank's share of the final state
        save = self.ckpt.wait()
        return {
            "final_step": step,
            "final_metrics": last,
            "wall_s": time.time() - t_start,
            "restarts": self.restarts,
            "straggler_events": len(self.watchdog.events),
            "last_ckpt": dataclasses.asdict(save) if save else None,
            "history": self.metrics_history,
        }
