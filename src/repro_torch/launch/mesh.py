"""Device meshes. Port of repro.launch.mesh (and of the JAX train CLI's
make_local_mesh).

A Mesh here is a plain description — axis names and a shape — so the
sharding rules (parallel/sharding.py) plan for any mesh without a process,
as the JAX rules plan for a mesh of fake devices. It becomes a
torch.distributed DeviceMesh, whose per-axis process groups carry the
collectives, only when a process group is up (`device_mesh`). Functions,
not module constants: importing this module touches no device and no
process group.

Production meshes (as the JAX package's, sized for v5e pods): single-pod
16 x 16 = 256 ranks ("data", "model"); multi-pod 2 x 16 x 16 ("pod",
"data", "model"), the pods doing data parallelism over the slow links.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

AXES = ("pod", "data", "model")


class Mesh(NamedTuple):
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(world: Optional[int] = None) -> Mesh:
    """(world, 1) ("data", "model"): every rank a data-parallel replica
    (FSDP over "data"). `world` defaults to the process group's size, 1
    when no group is up."""
    if world is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh(("data", "model"), (world, 1))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pods do DP over DCI)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def axis_size(mesh: Mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def device_mesh(mesh: Mesh, device_type: str):
    """The torch.distributed DeviceMesh of `mesh` over the ranks of the
    default process group (rank r at mesh coordinate r in row-major
    order); raises when the group's size is not the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs a process group: "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {axis_sizes(mesh)} needs {mesh.size} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, mesh.shape,
                            mesh_dim_names=mesh.axis_names)


class MeshGroups(NamedTuple):
    """This rank's place on a mesh and its process groups: "model" (the
    ranks that share its (pod, data)), "data" (those that share its (pod,
    model)), "pod" (those that share its (data, model)) and "dp" (the
    data-parallel ranks, those that share its model index, pod-major).
    An axis the mesh lacks has size 1 and groups of one rank."""
    coords: Dict[str, int]
    sizes: Dict[str, int]
    groups: Dict[str, object]

    def dp_rank(self) -> int:
        return self.coords["pod"] * self.sizes["data"] + self.coords["data"]

    def dp_size(self) -> int:
        return self.sizes["pod"] * self.sizes["data"]


def process_groups(mesh: Mesh) -> MeshGroups:
    """The groups of `mesh` over the default process group, rank r at mesh
    coordinate r in row-major order. Every rank makes every group, in the
    same order (torch.distributed.new_group's contract); raises when the
    group's size is not the mesh's."""
    import itertools

    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("process_groups needs a process group: "
                           "torch.distributed.init_process_group first")
    if set(mesh.axis_names) - set(AXES):
        raise ValueError(f"mesh axes {mesh.axis_names}: only {AXES}")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {axis_sizes(mesh)} needs {mesh.size} ranks; "
                         f"the process group has {world}")
    sizes = {a: axis_size(mesh, a) for a in AXES}
    shape = [sizes[a] for a in AXES]

    def rank_of(c):
        return (c[0] * shape[1] + c[1]) * shape[2] + c[2]

    me = dist.get_rank()
    coords = dict(zip(AXES, (me // (shape[1] * shape[2]),
                             me // shape[2] % shape[1], me % shape[2])))
    groups = {}
    for name, varied in (("model", (2,)), ("data", (1,)), ("pod", (0,)),
                         ("dp", (0, 1))):
        fixed = [i for i in range(3) if i not in varied]
        for key in itertools.product(*(range(shape[i]) for i in fixed)):
            ranks = []
            for free in itertools.product(*(range(shape[i])
                                            for i in varied)):
                c = [0, 0, 0]
                for i, v in zip(fixed, key):
                    c[i] = v
                for i, v in zip(varied, free):
                    c[i] = v
                ranks.append(rank_of(c))
            g = dist.new_group(sorted(ranks))
            if me in ranks:
                groups[name] = g
    return MeshGroups(coords, sizes, groups)
