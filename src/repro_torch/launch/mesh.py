"""Device meshes of the port.

The counterpart of ``repro.launch.mesh``.  A mesh is a plain list of
``torch.device``s with axis names and sizes for the sharding rules
(``repro_torch.distributed.sharding``): the stream server's slot mesh one
device per contiguous block of slots, the LM trainer's host mesh one
device.  A FUNCTION builds each, so importing this module never touches a
device.  The LM's multi-device meshes (the 16x16 production mesh, a host
mesh over several devices) wait for ROADMAP.md, Queue 1, 'LM sharding and
dry run'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.types import resolve_device, unported

LM_SHARDING = "LM sharding and dry run"


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


def make_production_mesh(*, multi_pod: bool = False):
    """The LM's 16x16 (or 2x16x16) production mesh: not ported."""
    raise unported("make_production_mesh", LM_SHARDING)


def make_host_mesh(data: Optional[int] = None, model: int = 1,
                   device=None) -> SlotMesh:
    """The LM trainer's ``("data", "model")`` mesh over one device: data 1
    and model 1 on ``device`` (the CUDA device unless the caller names
    another).  A mesh over more than one device on either axis raises."""
    data = 1 if data is None else data
    if data != 1 or model != 1:
        raise unported(f"make_host_mesh(data={data}, model={model}) over "
                       f"more than one device", LM_SHARDING)
    return SlotMesh(("data", "model"), (1, 1),
                    (resolve_device(device, "make_host_mesh"),))
