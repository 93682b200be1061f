"""The work the hand-written kernels would do, reported from the meta
device.

On meta tensors the K4 and K5 wrappers check their arguments and make the
allocations they make on the card, then skip the launch (meta has no data
to compute) and ``report`` the launch's matrix-product flops and the bytes
it reads and writes.  The dry run (``launch.dryrun``) installs a
``WorkLog`` with ``recording()`` and adds the reports to what its
dispatch-level counters see, since a launch runs no aten op.  Outside a
``recording()`` context a report is dropped.  K4's reports count the
tiles of its index schedule even where the call has caller positions
(its EXT path): meta positions have no values to walk.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass
class WorkLog:
    """Per kernel name: launches, matrix-product flops, bytes moved."""
    calls: dict = dataclasses.field(default_factory=dict)
    flops: dict = dataclasses.field(default_factory=dict)
    nbytes: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: int) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0.0) + flops
        self.nbytes[name] = self.nbytes.get(name, 0) + nbytes

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes.values())


_LOG: contextvars.ContextVar[WorkLog | None] = contextvars.ContextVar(
    "kernel_work", default=None)


@contextlib.contextmanager
def recording():
    """Collect the kernels' reports in a fresh ``WorkLog`` (yielded)."""
    log = WorkLog()
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors' elements (each read or written once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def report(name: str, flops: float, nbytes: int) -> None:
    """One skipped launch of kernel ``name`` on meta tensors."""
    log = _LOG.get()
    if log is not None:
        log.add(name, flops, nbytes)
