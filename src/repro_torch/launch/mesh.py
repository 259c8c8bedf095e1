"""Device meshes of the port.

The counterpart of ``repro.launch.mesh``.  The sharding rules
(``repro_torch.distributed.sharding``) read a mesh's ``axis_names`` and
``shape`` (axis name -> size).  The stream server's slot mesh
(``SlotMesh``) is a plain list of ``torch.device``s, one per contiguous
block of slots.  The LM's meshes (``LMMesh``) wrap a ``torch.distributed``
``DeviceMesh`` over the ranks of the default process group: the 16x16 (or
2x16x16) production mesh, and the host mesh of a ``torchrun`` job; a host
mesh with no process group up is one device (a ``SlotMesh``), on which
every placement is whole.  A FUNCTION builds each, so importing this
module never touches a device or a process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """A device mesh (the serving slot mesh, or the LM's host mesh):
    ``axis_names`` (``("slot",)``, ``("slot", "member")`` or ``("data",
    "model")``), their ``sizes``, and ``devices``, the flat row-major list
    of one device per entry.  An entry may repeat a device: several slot
    blocks then share one card (or the CPU)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_slot_mesh(n_slot: Optional[int] = None, member: int = 1,
                   devices: Optional[Sequence] = None) -> SlotMesh:
    """Serving mesh for the slot-sharded stream server.

    A 1-D ``("slot",)`` mesh of ``n_slot`` entries, or a 2-D ``("slot",
    "member")`` mesh when ``member > 1``.  By default the entries are the
    first ``n_slot * member`` CUDA devices (``n_slot`` defaults to all of
    them over ``member``), and asking for more than exist raises.  An
    explicit ``devices`` list (names or ``torch.device``s, ``n_slot *
    member`` long) may repeat a device: the port's counterpart of the
    reference's forced host-device split, which the CPU tests use with
    ``["cpu"] * n`` and a one-card run with ``["cuda:0"] * n``.
    """
    if devices is None:
        avail = torch.cuda.device_count()
        if n_slot is None:
            n_slot = avail // member
        need = n_slot * member
        if need > avail or need < 1:
            raise ValueError(
                f"make_slot_mesh: {n_slot} slot x {member} member devices "
                f"requested but only {avail} available")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = tuple(torch.device(d) for d in devices)
    if n_slot is None:
        n_slot = len(devices) // member
    if n_slot < 1 or member < 1 or len(devices) != n_slot * member:
        raise ValueError(
            f"make_slot_mesh: {n_slot} slot x {member} member entries need "
            f"{n_slot * member} devices, got {len(devices)}")
    if member > 1:
        return SlotMesh(("slot", "member"), (n_slot, member), devices)
    return SlotMesh(("slot",), (n_slot,), devices)


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """The LM's mesh: a ``DeviceMesh`` over the default process group's
    ranks, with ``axis_names`` and ``shape`` (axis name -> size) as the
    reference's ``jax.sharding.Mesh`` has them."""

    device_mesh: DeviceMesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.device_mesh.shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return self.device_mesh.size()


def _device_type() -> str:
    """The device type of the default group's backend: 'cuda' for NCCL,
    else 'cpu' (gloo, and the shape-only 'fake' group of the dry run)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _lm_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]) -> LMMesh:
    from torch.distributed.device_mesh import init_device_mesh

    return LMMesh(init_device_mesh(_device_type(), shape,
                                   mesh_dim_names=names))


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """16x16 ``("data", "model")`` (256 ranks), or 2x16x16 ``("pod",
    "data", "model")`` (512), over the default process group, which must
    have exactly that many ranks (``ValueError`` otherwise, naming the
    world size).  The dry run builds it over a shape-only 'fake' group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"make_production_mesh: the "
                         f"{'x'.join(map(str, shape))} mesh needs {need} "
                         f"ranks, the world size is {world}")
    return _lm_mesh(shape, names)


def make_host_mesh(data: Optional[int] = None, model: int = 1, device=None):
    """The LM's ``("data", "model")`` mesh over the ranks of the default
    process group (a ``torchrun`` job), ``data`` defaulting to world //
    model; ``data * model`` must be the world size.  With no process group
    up: one device (a ``SlotMesh`` on ``device``, the CUDA device unless the
    caller names another), and data and model must be 1."""
    if not dist.is_initialized():
        data = 1 if data is None else data
        if data != 1 or model != 1:
            raise ValueError(
                f"make_host_mesh(data={data}, model={model}) spans "
                f"{data * model} devices: start a process group of that many "
                f"ranks (torchrun) first")
        return SlotMesh(("data", "model"), (1, 1),
                        (resolve_device(device, "make_host_mesh"),))
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"make_host_mesh: data {data} x model {model} != "
                         f"world size {world}")
    return _lm_mesh((data, model), ("data", "model"))
