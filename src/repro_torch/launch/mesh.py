"""Device meshes of the port.

The counterpart of ``repro.launch.mesh``.  The stream server's slot mesh is
a plain list of ``torch.device``s, one per contiguous block of slots, with
axis names and sizes for the sharding rules
(``repro_torch.distributed.sharding``).  A FUNCTION builds it, so importing
this module never touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.types import unported

LM_LAUNCH = "LM optimizers, Trainer and launch"


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """A serving mesh: ``axis_names`` (``("slot",)`` or ``("slot",
    "member")``), their ``sizes``, and ``devices``, the flat row-major list
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
    raise unported("make_production_mesh", LM_LAUNCH)


def make_host_mesh(data: Optional[int] = None, model: int = 1):
    """The LM's (data, model) host mesh: not ported."""
    raise unported("make_host_mesh", LM_LAUNCH)
