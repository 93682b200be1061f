"""Fault tolerance: restartable failures and the straggler watchdog.

The port of the JAX package's ``repro.distributed.fault`` (pure Python,
the same classes and behaviour):

* any step may die (preemption, a link flap, host OOM) — the trainer
  catches :class:`RestartableFailure`, restores the latest checkpoint
  and replays the data cursor (deterministic pipeline state rides in
  the checkpoint manifest);
* slow steps are detected by :class:`StepWatchdog` (EMA + multiplicative
  threshold; clock injectable for unit tests).  The shipped mitigation
  policy is *skip-and-redistribute*: the event is recorded, the step
  budget extended once, and a persistent straggler escalates to a
  restartable failure so the scheduler can replace the node;
* :class:`FailureInjector` fires a failure once at each scheduled step
  (chaos drills and tests).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


class RestartableFailure(RuntimeError):
    """A failure the trainer should recover from via checkpoint restart."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    ema_s: float
    action: str


class StepWatchdog:
    """Flags steps slower than ``factor × EMA``; escalates after ``patience``."""

    def __init__(self, *, factor: float = 3.0, patience: int = 3,
                 ema_alpha: float = 0.1, clock: Callable[[], float] = time.monotonic):
        self.factor, self.patience, self.alpha = factor, patience, ema_alpha
        self.clock = clock
        self.ema: float | None = None
        self.strikes = 0
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> StragglerEvent | None:
        assert self._t0 is not None
        dt = self.clock() - self._t0
        self._t0 = None
        if self.ema is None:
            self.ema = dt
            return None
        slow = dt > self.factor * self.ema
        # slow steps don't poison the baseline estimate
        if not slow:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
            self.strikes = 0
            return None
        self.strikes += 1
        action = "skip-and-redistribute" if self.strikes < self.patience \
            else "escalate-restart"
        ev = StragglerEvent(step, dt, self.ema, action)
        self.events.append(ev)
        if action == "escalate-restart":
            self.strikes = 0
            raise RestartableFailure(
                f"persistent straggler at step {step}: {dt:.2f}s vs EMA {self.ema:.2f}s")
        return ev


class FailureInjector:
    """Deterministic failure schedule for integration tests / chaos drills."""

    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RestartableFailure(f"injected failure at step {step}")
