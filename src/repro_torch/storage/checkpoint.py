"""Sharded checkpointing with the paper's I/O principles.

The port's copy of the JAX package's ``repro.storage.checkpoint``, with
the same on-disk format byte for byte, so a checkpoint either package
writes restores in the other:

    <dir>/step_<N>/MANIFEST.json                 tree structure + meta
    <dir>/step_<N>/ch<k>/<leaf>__c<j>.npy        chunked leaf data

The writer applies the paper's three levers directly:

* **channel striping** — leaf chunks round-robin across ``channels``
  directories (independent files ≈ independent NAND channels);
* **way interleaving** — ``channels * ways`` writer threads keep chunks
  in flight, so serialisation overlaps the write of other chunks;
* **DDR pacing** — ``save`` snapshots to host memory and returns; the
  write runs on a background thread, and the projected stall on a
  production SSD tier is priced by the paper's model
  (``repro_torch.storage.ssd_model``).  The stall depends only on the
  byte count and the tier, so it is priced once per (bytes, tier,
  device) and reused by every later save of that size.

Trees are nested dicts, lists and tuples of tensors (or numpy arrays);
``None`` is no leaf.  Leaves are visited in the JAX package's order
(dict keys sorted, sequence entries by index), which fixes the chunk ->
channel striping.  bfloat16 has no numpy type here: it is written as its
16-bit pattern under the ``.npy`` descr ``'<V2'`` that numpy gives an
``ml_dtypes`` bfloat16 array, with the manifest dtype ``"bfloat16"``.
Restore returns CPU tensors; :func:`place_on_device` moves them to one
device, :func:`place_on_mesh` gives each rank of a mesh its slice of
them, and :func:`gather_from_mesh` puts a sharded state (ZeRO-1
moments) back together before a save, so its files and manifest are the
ones a one-device save of the same state writes.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import json
import math
import pathlib
import re
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sched import lower_static
from repro_torch.core.sim import SSDConfig
from repro_torch.core.workload import checkpoint_requests
from repro_torch.device import resolve_device
from repro_torch.storage.ssd_model import estimate_trace_interfaces

CHUNK_BYTES = 16 << 20
_BF16 = "bfloat16"
_BF16_DESCR = "<V2"     # numpy's descr of an ml_dtypes bfloat16 array


def _visit(tree: Any, prefix: tuple, out: dict) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _visit(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _visit(v, prefix + (str(i),), out)
    else:
        out["/".join(prefix)] = tree


def _flatten(tree: Any) -> dict[str, Any]:
    """{path: leaf} in the JAX package's leaf order: dict keys sorted,
    list / tuple entries named by index, ``None`` skipped."""
    out: dict[str, Any] = {}
    _visit(tree, (), out)
    return out


def _unflatten(template: Any, flat: dict[str, Any], prefix: tuple = ()):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    return flat["/".join(prefix)]


def _safe(name: str) -> str:
    return re.sub(r"[^\w\.]", "_", name)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """(a numpy copy of the leaf on the host, its numpy dtype name);
    bfloat16 travels as its int16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = _BF16_DESCR
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        arr.tofile(f)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says {dtype}")
    return torch.from_numpy(arr)


@functools.lru_cache(maxsize=64)
def _stall_seconds(nbytes: int, ssd: SSDConfig,
                   device: torch.device) -> tuple[tuple[str, float], ...]:
    """The projected write stall of ``nbytes`` on ``ssd``, per interface:
    a zero-arrival write burst lowered by the static stripe scheduler
    onto the tier's geometry and priced on ``device``."""
    requests = checkpoint_requests(nbytes, ssd)
    tr = lower_static(requests, ssd.channels, ssd.ways).trace
    return tuple((kind, est.seconds) for kind, est in
                 estimate_trace_interfaces(tr, ssd, total_bytes=nbytes,
                                           device=device).items())


@dataclasses.dataclass
class SaveResult:
    step: int
    nbytes: int
    wall_s: float
    modeled: dict[str, float]    # interface -> projected SSD write seconds


class CheckpointEngine:
    """Checkpoints under ``directory``; ``device`` is where the stall
    pricing runs (``None``: the card)."""

    def __init__(self, directory: str | pathlib.Path, *, channels: int = 4,
                 ways: int = 4, ssd: SSDConfig | None = None,
                 keep: int = 2, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.channels = channels
        self.ways = ways
        self.ssd = ssd or SSDConfig()
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._last: SaveResult | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write asynchronously."""
        host = {k: _host(v) for k, v in _flatten(state).items()}
        self.wait()
        t = threading.Thread(target=self._write, args=(step, host, extra or {}),
                             daemon=True)
        self._pending = t
        t.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict[str, tuple[np.ndarray, str]],
               extra: dict):
        t0 = time.time()
        out = self.dir / f"step_{step:08d}.tmp"
        out.mkdir(parents=True, exist_ok=True)
        chunks: list[tuple[pathlib.Path, np.ndarray, str]] = []
        manifest: dict[str, Any] = {"step": step, "extra": extra, "leaves": {}}
        for path, (arr, dtype) in host.items():
            flat = arr.reshape(-1)
            n_chunks = max(1, -(-arr.nbytes // CHUNK_BYTES))
            per = -(-flat.size // n_chunks)
            manifest["leaves"][path] = {
                "shape": list(arr.shape), "dtype": dtype,
                "chunks": n_chunks}
            for j in range(n_chunks):
                ch = (len(chunks)) % self.channels   # channel striping
                d = out / f"ch{ch}"
                d.mkdir(exist_ok=True)
                chunks.append((d / f"{_safe(path)}__c{j}.npy",
                               flat[j * per:(j + 1) * per], dtype))
        nbytes = sum(int(c.nbytes) for _, c, _ in chunks)
        # ways = outstanding buffers per channel writer
        with cf.ThreadPoolExecutor(max_workers=self.channels * self.ways) as ex:
            list(ex.map(lambda fc: _save_npy(*fc), chunks))
        (out / "MANIFEST.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:08d}"
        out.rename(final)
        wall = time.time() - t0
        modeled = dict(_stall_seconds(nbytes, self.ssd, self.device))
        self._last = SaveResult(step, nbytes, wall, modeled)
        self._gc()

    def _gc(self):
        steps = sorted(self.dir.glob("step_????????"))
        for old in steps[:-self.keep]:
            for f in sorted(old.rglob("*"), reverse=True):
                f.unlink() if f.is_file() else f.rmdir()
            old.rmdir()

    def writing(self) -> bool:
        """Whether a save's write (or its pricing) is still running."""
        return self._pending is not None and self._pending.is_alive()

    def wait(self) -> SaveResult | None:
        """Join the pending write; the last finished save's result (as in
        the JAX package, a write that raised leaves the previous one)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        return self._last

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = sorted(self.dir.glob("step_????????"))
        return int(steps[-1].name.split("_")[1]) if steps else None

    def restore(self, step: int | None = None,
                template: Any = None) -> tuple[int, Any, dict]:
        """Returns (step, state of CPU tensors, extra).

        ``template`` (any tree with the same structure, e.g. the live
        state) rebuilds the tree; pass None to get the flat
        {path: tensor} dict.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        src = self.dir / f"step_{step:08d}"
        manifest = json.loads((src / "MANIFEST.json").read_text())
        flat: dict[str, torch.Tensor] = {}
        idx = 0
        for path, meta in manifest["leaves"].items():
            parts = []
            for j in range(meta["chunks"]):
                ch = idx % self.channels
                f = src / f"ch{ch}" / f"{_safe(path)}__c{j}.npy"
                if not f.exists():   # channel count may differ across jobs
                    hits = list(src.glob(f"ch*/{_safe(path)}__c{j}.npy"))
                    f = hits[0]
                parts.append(np.load(f))
                idx += 1
            arr = np.concatenate(parts) if len(parts) > 1 else parts[0]
            flat[path] = _tensor(arr, meta["dtype"]).reshape(meta["shape"])
        if template is None:
            return step, flat, manifest["extra"]
        return step, _unflatten(template, flat), manifest["extra"]


def place_on_device(host_state: Any,
                    device: torch.device | str | None = None) -> Any:
    """Move a restored tree onto one device (``None``: the card) — the
    one-device counterpart of the JAX package's ``place_on_mesh``."""
    dev = resolve_device(device)
    if host_state is None:
        return None
    if isinstance(host_state, dict):
        return {k: place_on_device(v, dev) for k, v in host_state.items()}
    if isinstance(host_state, (list, tuple)):
        return type(host_state)(place_on_device(v, dev) for v in host_state)
    return torch.as_tensor(host_state).to(dev)


def _map_leaves(fn, tree: Any, shardings: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, s)
                          for v, s in zip(tree, shardings))
    return None if tree is None else fn(tree, shardings)


def _this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def place_on_mesh(host_state: Any, shardings: Any,
                  position: int | None = None) -> Any:
    """Elastic re-placement: mesh position ``position`` (this process's
    rank by default) takes its slice of each whole leaf of ``host_state``
    under the matching ``distributed.partitioning.NamedSharding`` of
    ``shardings``, copied onto the position's device.  Any mesh shape or
    sharding: ZeRO-1 moments split over ``data``, replicated parameters
    whole."""
    pos = _this_rank() if position is None else position

    def one(x, sh):
        return sh.shard(torch.as_tensor(x), pos).to(sh.device(pos),
                                                    copy=True)
    return _map_leaves(one, host_state, shardings)


def gather_from_mesh(state: Any, shardings: Any, group=None) -> Any:
    """The whole tree from every rank's slices (each rank of the mesh
    calls it; ``group``: the mesh's process group, the default one if
    None): a leaf that a mesh axis of more than one device splits is
    all-gathered and each rank's slice put back in its place; the others
    are returned as they are."""
    def one(x, sh):
        blocks = sh.blocks
        if math.prod(blocks) == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(sh.mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        shape = tuple(n * (blocks[d] if d < len(blocks) else 1)
                      for d, n in enumerate(x.shape))
        whole = x.new_empty(shape)
        for r, piece in enumerate(parts):
            whole[sh.index(shape, r)] = piece
        return whole
    return _map_leaves(one, state, shardings)

