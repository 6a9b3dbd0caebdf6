"""Device meshes.  Counterpart of ``repro.launch.mesh``.

The production layouts are pure values (nothing touches a device or a
process group when this module is imported or they are built):
16 × 16 ``("data", "model")`` for one pod of 256 chips and 2 × 16 × 16
``("pod", "data", "model")`` for two.  :func:`make_mesh` builds the mesh of
the ``torch.distributed`` world this process belongs to, one rank a device,
with a process group for each axis (``init_device_mesh``);
:func:`make_dry_mesh` the same mesh as one rank of it sees it, on the meta
device, its groups stand-ins that communicate nothing
(``sharding.collectives.DryGroup``): the dry run's counterpart of the
reference's ``--xla_force_host_platform_device_count``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import collectives as C

AXES_BY_NDIM = {1: ("data",), 2: ("data", "model"),
                3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names, as a value."""

    dims: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_test_mesh(n: int = 8, *, multi_pod: bool = False) -> MeshLayout:
    """Small mesh for CI-scale distribution tests."""
    if multi_pod:
        assert n % 2 == 0
        return MeshLayout((2, n // 4, 2), ("pod", "data", "model"))
    return MeshLayout((n // 2, 2), ("data", "model"))


@dataclasses.dataclass
class ProcessMesh:
    """The mesh of this process's world: its layout, this rank's
    coordinates and a process group for each axis, and three groups across
    axes (``groups`` keys): ``batch`` spans ``pod`` × ``data`` at this
    rank's ``model`` index (the ranks holding other rows of the same
    sequence tile), ``matrix`` spans ``data`` × ``model`` in this rank's pod
    (the ranks holding the blocks of one 2-D ZeRO-3 shard) and ``world``
    every rank.  ``device`` is this rank's device."""

    layout: MeshLayout
    device: torch.device
    backend: str
    device_mesh: object
    rank: int
    coords: dict
    groups: dict

    @property
    def axis_names(self) -> tuple:
        return self.layout.axis_names

    @property
    def shape(self) -> dict:
        return self.layout.shape

    @property
    def world(self) -> int:
        return self.layout.size

    def size(self, axis: str) -> int:
        return self.layout.shape.get(axis, 1)

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def batch_group(self):
        return self.groups["batch"]

    @property
    def batch_index(self) -> int:
        """This rank's place along the batch axes, pod-major."""
        return (self.coords.get("pod", 0) * self.size("data")
                + self.coords.get("data", 0))

    @property
    def batch_size(self) -> int:
        return self.size("pod") * self.size("data")

    @property
    def tile_index(self) -> int:
        """This rank's sequence tile along ``model``."""
        return self.coords.get("model", 0)


def _coords(dims: tuple, r: int) -> list:
    """Rank ``r``'s index along each axis of ``dims``, row-major."""
    return [(r // math.prod(dims[a + 1:])) % dims[a]
            for a in range(len(dims))]


def _peers(dims: tuple, keep: tuple, rank: int) -> list:
    """The ranks that differ from ``rank`` only along the axes ``keep``
    (indices into ``dims``), in row-major rank order."""
    mine = _coords(dims, rank)
    return [r for r in range(math.prod(dims))
            if all(c == mine[a] for a, c in enumerate(_coords(dims, r))
                   if a not in keep)]


def _subgroups(dims: tuple, keep: tuple):
    """This rank's group of the ranks that differ from it only along the
    axes ``keep`` (indices into ``dims``), each group in row-major rank
    order.  Every rank makes every group, in the same order, as
    ``new_subgroups_by_enumeration`` requires."""
    n = math.prod(dims)
    coords = [_coords(dims, r) for r in range(n)]
    found = {}
    for r in range(n):
        key = tuple(c for a, c in enumerate(coords[r]) if a not in keep)
        found.setdefault(key, []).append(r)
    group, _ = dist.new_subgroups_by_enumeration(list(found.values()))
    return group


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(shape, device="cuda", *, backend: Optional[str] = None
              ) -> ProcessMesh:
    """The mesh ``shape`` (1-D ``(data,)``, 2-D ``(data, model)``, 3-D
    ``(pod, data, model)``) over this process's ``torch.distributed``
    world, one rank a mesh position in row-major order.

    A one-position mesh with no world yet gets a world of one process (on
    a store in memory).  Raises ``ValueError`` when the world has another
    size than ``prod(shape)``."""
    shape = tuple(int(n) for n in shape)
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"mesh shape must have 1-3 dims, got {shape}")
    layout = MeshLayout(shape, AXES_BY_NDIM[len(shape)])
    device = torch.device(device)
    need = layout.size
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"mesh shape {shape} needs {need} processes and this process "
                f"is in no torch.distributed world (start with "
                f"--virtual-devices {need} --device cpu, or {need} processes "
                f"under torchrun, or shrink spec.mesh.shape)")
        dist.init_process_group(backend or _default_backend(device),
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"mesh shape {shape} needs {need} processes, the world has "
            f"{world} (start with --virtual-devices {need} --device cpu, or "
            f"{need} processes under torchrun, or shrink spec.mesh.shape)")
    backend = dist.get_backend()
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=layout.axis_names)
    rank = dist.get_rank()
    coords = {a: dm.get_local_rank(a) for a in layout.axis_names}
    groups = {a: dm.get_group(a) for a in layout.axis_names}
    names = layout.axis_names
    groups["world"] = dist.group.WORLD
    if layout.shape.get("model", 1) == 1:
        groups["batch"] = dist.group.WORLD
    elif "pod" not in names:
        groups["batch"] = groups["data"]
    else:
        groups["batch"] = _subgroups(shape, (0, 1))
    if "pod" not in names or layout.shape["pod"] == 1:
        groups["matrix"] = dist.group.WORLD
    else:
        groups["matrix"] = _subgroups(shape, (1, 2))
    for role, axes in _group_axes(layout).items():
        C.name_group(groups[role], axes)
    return ProcessMesh(layout=layout, device=device, backend=backend,
                       device_mesh=dm, rank=rank, coords=coords,
                       groups=groups)


def _group_axes(layout: MeshLayout) -> dict:
    """The mesh axes of more than one position each of a mesh's groups
    spans, by its role in ``ProcessMesh.groups`` (the collectives' log
    names a group so: two roles that share a group span the same
    ranks)."""
    names = layout.axis_names
    out = {a: (a,) for a in names}
    out["world"] = names
    if layout.shape.get("model", 1) == 1:
        out["batch"] = names
    else:
        out["batch"] = tuple(a for a in names if a != "model")
    out["matrix"] = (names if "pod" not in names
                     or layout.shape["pod"] == 1 else ("data", "model"))
    return {role: tuple(a for a in axes if layout.shape[a] > 1)
            for role, axes in out.items()}


def make_dry_mesh(shape, rank: int = 0) -> ProcessMesh:
    """The mesh ``shape`` (1-, 2- or 3-D, as :func:`make_mesh` takes it,
    the production layouts included) as rank ``rank`` of it sees it, with
    no world: on ``torch.device("meta")``, ``backend="dry"``, and a
    ``DryGroup`` for every axis and for ``batch``, ``matrix`` and
    ``world``, shared between roles as :func:`make_mesh` shares its
    groups."""
    shape = tuple(int(n) for n in shape)
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"mesh shape must have 1-3 dims, got {shape}")
    layout = MeshLayout(shape, AXES_BY_NDIM[len(shape)])
    if not 0 <= rank < layout.size:
        raise ValueError(f"rank {rank} is not in a mesh of {layout.size}")
    names = layout.axis_names
    axes = _group_axes(layout)

    def group(role, keep):
        return C.DryGroup(_peers(shape, keep, rank), rank, axes[role])

    groups = {a: group(a, (i,)) for i, a in enumerate(names)}
    groups["world"] = group("world", tuple(range(len(shape))))
    if layout.shape.get("model", 1) == 1:
        groups["batch"] = groups["world"]
    elif "pod" not in names:
        groups["batch"] = groups["data"]
    else:
        groups["batch"] = group("batch", (0, 1))
    if "pod" not in names or layout.shape["pod"] == 1:
        groups["matrix"] = groups["world"]
    else:
        groups["matrix"] = group("matrix", (1, 2))
    coords = dict(zip(names, _coords(shape, rank)))
    return ProcessMesh(layout=layout, device=torch.device("meta"),
                       backend="dry", device_mesh=None, rank=rank,
                       coords=coords, groups=groups)
