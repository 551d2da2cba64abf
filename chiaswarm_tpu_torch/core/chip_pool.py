"""Device slots, counterpart of ``chiaswarm_tpu/core/chip_pool.py``
(``MeshSlot``/``ChipPool``, :45-169).

As in the JAX package, each slot is a schedulable executor over a device
mesh (``core/mesh.py``). The slot's lead device, its mesh's first, is where
the pipeline's modules live; a mesh with ``seq > 1`` rings the large
self-attentions over its devices. The slot keeps the reference's call
contract:

- non-blocking busy check (a busy slot raises :class:`SlotBusy`),
- ``model_name`` popped from the kwargs and passed positionally,
- a seed drawn when the job does not pin one and recorded into the result
  config, so any image is reproducible.

Callbacks keep the uniform signature
``callback(slot, model_name, **kwargs) -> (artifacts, config)``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

import torch

from chiaswarm_tpu_torch.core.device import resolve_device
from chiaswarm_tpu_torch.core.mesh import (
    DeviceMesh,
    MeshSpec,
    build_mesh,
    single_device_mesh,
)
from chiaswarm_tpu_torch.core.rng import draw_seed


class SlotBusy(RuntimeError):
    """A job was dispatched to a slot that is already running one."""


@dataclasses.dataclass
class DeviceSlot:
    """One schedulable executor: a device mesh plus per-job seed handling.
    ``DeviceSlot(index, device=...)`` is the one-device mesh. One job at a
    time: PyTorch runs eagerly, so there is no dispatched program to
    overlap a second job with."""

    index: int
    device: torch.device | None = None
    mesh: DeviceMesh | None = None

    def __post_init__(self) -> None:
        if self.mesh is None:
            self.mesh = single_device_mesh(self.device)
        self.device = self.mesh.lead
        self._busy = threading.Lock()

    @property
    def identifier(self) -> str:
        return f"{self.device.type}-slot:{self.index}"

    def descriptor(self) -> dict[str, Any]:
        devices = self.mesh.device_list
        if self.device.type == "cuda":
            kind = torch.cuda.get_device_name(self.device)
        else:
            kind = "cpu"
        return {
            "slot": self.index,
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "device_kind": kind,
            "chips": len({str(d) for d in devices}),
            "device": str(self.device),
            "mesh_shape": self.mesh.shape,
            "mesh_devices": [str(d) for d in devices],
            "repeated_device": self.mesh.repeats_devices,
        }

    def __call__(self, callback: Callable[..., tuple[dict, dict]], **kwargs):
        """Run ``callback`` on this slot, injecting the seed."""
        if not self._busy.acquire(blocking=False):
            raise SlotBusy(f"{self.identifier} is busy")
        try:
            model_name = kwargs.pop("model_name", None)
            seed = kwargs.pop("seed", None)
            if seed is None:
                seed = draw_seed()
            seed = int(seed)
            artifacts, config = callback(self, model_name, seed=seed, **kwargs)
            config = dict(config)
            config["seed"] = seed
            return artifacts, config
        finally:
            self._busy.release()


class ChipPool:
    """Partition devices into mesh slots.

    - ``ChipPool(device=d)``: one slot on the one device ``d`` (``"cpu"``
      for the CPU).
    - ``ChipPool(n_slots, mesh_spec, devices)``, as in the JAX package:
      ``devices`` (default: every visible CUDA card) split into ``n_slots``
      contiguous slots, each a mesh shaped by ``mesh_spec``. ``devices`` may
      name one device several times, for a ring on one card. With neither
      ``n_slots`` nor ``mesh_spec``, each device is its own slot.
    """

    def __init__(self, n_slots: int | None = None,
                 mesh_spec: MeshSpec | None = None,
                 devices: Sequence[str | torch.device] | None = None, *,
                 device: str | torch.device | None = None) -> None:
        if device is not None:
            if devices is not None:
                raise ValueError("pass device= or devices=, not both")
            devices = [device]
        elif devices is None:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d) for d in devices]
        if n_slots is None:
            n_slots = 1 if mesh_spec is not None else len(devices)
        if n_slots < 1 or len(devices) % n_slots:
            raise ValueError(
                f"cannot split {len(devices)} devices into {n_slots} slots")
        per_slot = len(devices) // n_slots
        self.slots = [
            DeviceSlot(index=i, mesh=build_mesh(
                mesh_spec or MeshSpec(),
                devices[i * per_slot:(i + 1) * per_slot]))
            for i in range(n_slots)
        ]
