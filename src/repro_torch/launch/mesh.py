"""Device meshes: the production meshes, the host's cards, one H100, the
sweeps' points mesh and a data-parallel mesh over a process group.

The port's counterpart of the JAX package's ``repro.launch.mesh``.  A
``MeshSpec`` names the mesh's axes and their sizes, and, where known, the
memory of one of its devices and the devices along its axes (in mesh
order); it stands in for ``jax.sharding.Mesh`` / ``AbstractMesh`` in the
partition rules (``distributed.partitioning``) and the dry run
(``launch.dryrun``).  A plan needs no process group: it is made without
the devices it describes.

* ``make_production_mesh``: the 16 x 16 ``("data", "model")`` pod, or
  2 x 16 x 16 ``("pod", "data", "model")``;
* ``make_host_mesh``: ``(cards // model, model)`` over this host's cards;
* ``make_points_mesh``: the 1-D ``("points",)`` sweep mesh, over every
  card (``None`` with fewer than two: the sweeps then stay on their
  one-device path) or over the devices the caller names, such as three
  CPU "devices" or two shards of ``cuda:0`` (the counterpart of JAX's
  ``--xla_force_host_platform_device_count``);
* ``make_data_mesh``: ``(world // model, model)`` over an initialised
  ``torch.distributed`` process group, one device a rank, with this
  rank's data group (the ranks of its model index) and, for
  ``model > 1``, its model group (the ranks of its data row);
* ``make_card_mesh``: one card, 1 x 1, with its memory;
* ``plan_mesh``: a mesh as one of its positions sees it in the dry
  run's plan, with stand-in groups that log their collectives.

Nothing here touches the card when the module is imported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

#: ``torch.cuda.get_device_properties(0).total_memory`` of the card the
#: plans are checked on, "NVIDIA H100 80GB HBM3, 700.00 W" (``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader``), as read by
#: ``chip_smoke.py``'s phase 15; ``make_card_mesh`` uses it where no card
#: is present.
H100_TOTAL_MEMORY = 85_017_493_504
H100_NAME = "NVIDIA H100 80GB HBM3, 700.00 W"

MESH_NAMES = ("card", "single", "multi")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named device mesh: axis names, their sizes, and the memory of one
    device where it is known (``None`` for the production meshes, whose
    devices the port does not model)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device_memory: int | None = None
    memory_source: str = ""
    #: the device of each mesh position, row-major over ``sizes`` (a data
    #: mesh: rank r's device at r); ``None`` for a mesh only planned on
    devices: tuple[torch.device, ...] | None = None
    #: a data mesh's process groups of this rank: the ranks sharing its
    #: ``model`` coordinate (the default group for ``model = 1``) and the
    #: ranks of its data row (None for ``model = 1``)
    data_group: object = dataclasses.field(default=None, compare=False)
    model_group: object = dataclasses.field(default=None, compare=False)
    #: with a ``pod`` axis, the ranks of this rank's pod and model
    #: coordinates, which ZeRO-1's (and ZeRO-3's) ``data`` split spans (the
    #: data group without one), and the ranks of its data and model
    #: coordinates, one a pod, which hold the same ``data`` blocks
    zero1_group: object = dataclasses.field(default=None, compare=False)
    pod_group: object = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    def coords(self, index: int) -> dict[str, int]:
        """Axis name -> coordinate of mesh position ``index`` (a rank),
        row-major over the axes as ``jax.make_mesh`` lays devices out."""
        if not 0 <= index < self.size:
            raise ValueError(f"position {index} outside a mesh of "
                             f"{self.size}")
        out = {}
        for name, n in reversed(tuple(zip(self.axis_names, self.sizes))):
            index, out[name] = divmod(index, n)
        return {name: out[name] for name in self.axis_names}

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, device=None) -> MeshSpec:
    """``(cards // model, model)`` over ``("data", "model")``: 1 x 1 on a
    one-card machine.  Raises where no card is present unless the caller
    asks for the CPU (``device="cpu"``: one device)."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return MeshSpec(("data", "model"), (n // model, model))


def make_points_mesh(devices=None) -> MeshSpec | None:
    """1-D ``("points",)`` mesh, the design-point axis of the simulator
    sweeps.  With no argument it spans every card, and is ``None`` with
    fewer than two, so that the sweeps keep their one-device path.  Given
    ``devices`` (names or ``torch.device``s, repeats allowed: ``("cpu",)
    * 3``, ``("cuda:0", "cuda:0")``) it spans those, one shard each."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 2:
            return None
        devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a points mesh needs at least one device")
    for d in devs:
        resolve_device(d)       # raises on a card that is not there
    return MeshSpec(("points",), (len(devs),), devices=devs)


def make_data_mesh(model: int = 1, device=None) -> MeshSpec:
    """``(world // model, model)`` over ``("data", "model")`` on the
    initialised default process group, rank r at mesh position r: each
    rank on ``cuda:{local rank}`` (``LOCAL_RANK``, else the rank modulo
    the host's cards; made the rank's current card), on the card the
    caller names (``device="cuda:0"``: ranks sharing one card), or every
    rank on the CPU when the caller asks for it (``device="cpu"``).
    For ``model > 1`` every rank makes the mesh's data groups (one a
    model index) and model groups (one a data row) with
    ``dist.new_group``, in that order, and keeps its own two.  Raises
    without a process group."""
    import os

    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a data mesh needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks do not split into model={model}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None else
                               dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        devs = [None] * world
        dist.all_gather_object(devs, str(dev))
    elif dev.type == "cpu":
        devs = ["cpu"] * world
    else:
        raise ValueError(f"a data mesh runs on cuda or cpu, not {dev}")
    rows, rank = world // model, dist.get_rank()
    data_group, model_group = dist.group.WORLD, None
    if model > 1:
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(rows)])
            if rank % model == j:
                data_group = g
        for i in range(rows):
            g = dist.new_group([i * model + j for j in range(model)])
            if rank // model == i:
                model_group = g
    return MeshSpec(("data", "model"), (rows, model),
                    devices=tuple(torch.device(d) for d in devs),
                    data_group=data_group, model_group=model_group)


def plan_mesh(mesh: MeshSpec, position: int,
              log: dict | None = None) -> MeshSpec:
    """``mesh`` as its position ``position`` runs on it in a plan, with
    ``distributed.ctx.PlanGroup`` stand-ins for that rank's groups, which
    move no data and log their collectives into ``log`` (shared): its
    data group, the ranks of its ``model`` coordinate (the other axes,
    ``pod`` and ``data``, joined row-major, as ``dp_axes`` joins them),
    and, for ``model > 1``, its model group (the ranks of its data row);
    with a ``pod`` axis also its ZeRO-1 group (the ranks of its pod and
    model coordinates: ``zero1_spec`` and ``fsdp_units`` split over
    ``data`` alone, so the pods hold the same moments and parameter
    blocks) and its pod group (the ranks of its data and model
    coordinates, which sum those blocks' gradients).  ``model`` is the
    last axis of every mesh here."""
    from repro_torch.distributed.ctx import PlanGroup
    tp = mesh.shape.get("model", 1)
    if mesh.axis_names[-1] != "model" and tp > 1:
        raise ValueError(f"model is not the last axis of {mesh.axis_names}")
    coords = mesh.coords(position)       # raises outside the mesh
    log = {} if log is None else log
    zero1 = pod = None
    if "pod" in mesh.shape:
        zero1 = PlanGroup(coords["data"], mesh.shape["data"], log)
        pod = PlanGroup(coords["pod"], mesh.shape["pod"], log)
    return dataclasses.replace(
        mesh, data_group=PlanGroup(position // tp, mesh.size // tp, log),
        model_group=(PlanGroup(coords["model"], tp, log) if tp > 1
                     else None), zero1_group=zero1, pod_group=pod)


def make_card_mesh(device=None) -> MeshSpec:
    """One card, 1 x 1 ``("data", "model")``, with its memory: read from the
    card on ``cuda`` (``device=None``), else ``H100_TOTAL_MEMORY``
    (``device="cpu"`` or ``"meta"``: planning without a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else 0
        return MeshSpec(("data", "model"), (1, 1),
                        torch.cuda.get_device_properties(index).total_memory,
                        torch.cuda.get_device_name(index))
    return MeshSpec(("data", "model"), (1, 1), H100_TOTAL_MEMORY, H100_NAME)


def make_mesh(name: str) -> MeshSpec:
    """The dry run's ``--mesh``: ``"single"`` or ``"multi"``, or ``"card"``
    planned with the card's own memory where a card is present, else with
    ``H100_TOTAL_MEMORY``."""
    if name == "card":
        return make_card_mesh("cuda" if torch.cuda.is_available() else "meta")
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi")
    raise ValueError(f"unknown mesh {name!r} (one of {MESH_NAMES})")


def mesh_chip_count(mesh: MeshSpec) -> int:
    return mesh.size
