"""Fault-tolerant training loop (the end-to-end driver).

The port of the JAX package's ``repro.train.trainer`` for one device:
the train step (``repro_torch.launch.steps``), a deterministic data
pipeline, async SSD-priced checkpointing, the straggler watchdog,
failure-injection drills and checkpoint-restart recovery.  There is no
mesh: the state lives on one device (``device``, ``None`` = the card),
``place_on_device`` takes ``place_on_mesh``'s place on restore, and
batches go to the state's device.  The data cursor rides in the
checkpoint manifest, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.fault import (FailureInjector,
                                           RestartableFailure, StepWatchdog)
from repro_torch.launch.steps import (abstract_train_state, init_train_state,
                                      make_train_step, to_device)
from repro_torch.models.transformer import ModelConfig
from repro_torch.storage.checkpoint import CheckpointEngine, place_on_device
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
    max_restarts: int = 3
    seed: int = 0


class Trainer:
    """A run resumes from the latest checkpoint under ``tcfg.ckpt_dir``
    (one converted from a JAX state, say) or starts from a fresh state
    drawn from ``tcfg.seed``."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, data, *,
                 ocfg: OptConfig | None = None,
                 schedule: Callable | None = None,
                 injector: FailureInjector | None = None,
                 watchdog: StepWatchdog | None = None, device=None):
        self.cfg, self.tcfg, self.data = cfg, tcfg, data
        self.device = resolve_device(device)
        self.ocfg = ocfg or OptConfig()
        self.schedule = schedule or constant(3e-4)
        self.injector = injector or FailureInjector()
        self.watchdog = watchdog or StepWatchdog()
        ckpt_dir = tcfg.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        self.ckpt = CheckpointEngine(ckpt_dir, device=self.device)
        self.restarts = 0
        self.metrics_history: list[dict] = []
        self._step = make_train_step(cfg, self.ocfg, self.schedule,
                                     grad_accum=tcfg.grad_accum)

    # -- state lifecycle -----------------------------------------------------

    def _fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return init_train_state(self.cfg, self.ocfg, gen, device=self.device)

    def _resume_or_init(self):
        self.ckpt.wait()      # a save still being written is the latest
        step = self.ckpt.latest_step()
        if step is None:
            return 0, self._fresh_state()
        shape = abstract_train_state(self.cfg, self.ocfg)
        step, host_state, extra = self.ckpt.restore(step, template=shape)
        state = place_on_device(host_state, self.device)
        if "pipe_cursor" in extra and hasattr(self.data, "restore"):
            self.data.restore(PipeState(extra["pipe_cursor"]))
        log.info("resumed from step %d", step)
        return step, state

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
            self.injector.maybe_fail(step)
            self.watchdog.start()
            state, metrics = self._step(state, batch)
            float(metrics["loss"])        # waits for the step's device work
            self.watchdog.stop(step)
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
                self.ckpt.save(step, state, extra={"pipe_cursor": cursor})
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
