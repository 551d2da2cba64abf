"""Device slots, counterpart of ``chiaswarm_tpu/core/chip_pool.py``
(``MeshSlot``/``ChipPool``, :45-169).

As in the JAX package, each slot is a schedulable executor over a device
mesh (``core/mesh.py``). The slot's lead device, its mesh's first, is where
the pipeline's modules live; a mesh with ``seq > 1`` rings the large
self-attentions over its devices. The slot keeps the reference's call
contract:

- non-blocking busy check: a call beyond the slot's ``depth`` of jobs in
  flight raises :class:`SlotBusy`,
- ``model_name`` popped from the kwargs and passed positionally,
- a seed drawn when the job does not pin one and recorded into the result
  config, so any image is reproducible.

Callbacks keep the uniform signature
``callback(slot, model_name, **kwargs) -> (artifacts, config)``.

**Depth.** The worker (``node/worker.py``) keeps up to ``slot.depth``
bursts in flight on a slot, as the JAX worker does with ``MeshSlot.depth``
(2 in ``ChipPool``). Here the two in-flight bursts cannot share the card
the way two dispatched XLA programs do: PyTorch runs eagerly. So
``depth`` only admits; a call within it that runs a callback (the solo
path) waits for the slot's execution lock, and solo jobs run on a card
one at a time. A burst that rides the lanes never calls the slot: it
submits its rows to the lane thread and waits on tickets, so a second
burst splices into the first burst's running lane while the first still
waits. A bare :class:`DeviceSlot` keeps depth 1, the reference's hard
mutex.
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


# bursts a pool slot admits at once (the JAX ``MeshSlot.depth``)
POOL_DEPTH = 2


class SlotBusy(RuntimeError):
    """A job was dispatched to a slot that is already running one."""


@dataclasses.dataclass
class DeviceSlot:
    """One schedulable executor: a device mesh plus per-job seed handling.
    ``DeviceSlot(index, device=...)`` is the one-device mesh. ``depth``
    jobs may be admitted at once; their callbacks run one at a time (the
    module docstring)."""

    index: int
    device: torch.device | None = None
    mesh: DeviceMesh | None = None
    depth: int = 1

    def __post_init__(self) -> None:
        if self.mesh is None:
            self.mesh = single_device_mesh(self.device)
        self.device = self.mesh.lead
        self._admitted = threading.BoundedSemaphore(max(1, self.depth))
        self._running = threading.Lock()

    @property
    def identifier(self) -> str:
        return f"{self.device.type}-slot:{self.index}"

    @property
    def data_width(self) -> int:
        """Size of the mesh's ``data`` axis: the worker's queue bound and
        burst size read it (``node/worker.py``)."""
        return int(self.mesh.shape.get("data", 1))

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
        """Run ``callback`` on this slot, injecting the seed. Raises
        :class:`SlotBusy` at once when ``depth`` calls are already in;
        otherwise waits for the callbacks admitted before it."""
        if not self._admitted.acquire(blocking=False):
            raise SlotBusy(f"{self.identifier} is busy")
        try:
            model_name = kwargs.pop("model_name", None)
            seed = kwargs.pop("seed", None)
            if seed is None:
                seed = draw_seed()
            seed = int(seed)
            with self._running:
                artifacts, config = callback(self, model_name, seed=seed,
                                             **kwargs)
            config = dict(config)
            config["seed"] = seed
            return artifacts, config
        finally:
            self._admitted.release()

    def call_multi(self, callback: Callable[..., list], **kwargs) -> list:
        """:meth:`__call__` for a coalesced callback that returns a LIST of
        per-job (artifacts, config): the per-job seeds ride inside
        ``kwargs["jobs"]`` and each config records its own (JAX
        :112-125)."""
        if not self._admitted.acquire(blocking=False):
            raise SlotBusy(f"{self.identifier} is busy")
        try:
            model_name = kwargs.pop("model_name", None)
            seed = int(kwargs.pop("seed", 0))
            with self._running:
                outs = callback(self, model_name, seed=seed, **kwargs)
            return [(artifacts, dict(config)) for artifacts, config in outs]
        finally:
            self._admitted.release()


class ChipPool:
    """Partition devices into mesh slots.

    - ``ChipPool(device=d)``: one slot on the one device ``d`` (``"cpu"``
      for the CPU).
    - ``ChipPool(n_slots, mesh_spec, devices)``, as in the JAX package:
      ``devices`` (default: every visible CUDA card) split into ``n_slots``
      contiguous slots, each a mesh shaped by ``mesh_spec``. ``devices`` may
      name one device several times, for a ring on one card. With neither
      ``n_slots`` nor ``mesh_spec``, each device is its own slot.

    Every slot has depth :data:`POOL_DEPTH`, as in the JAX package's
    ``ChipPool``.
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
                devices[i * per_slot:(i + 1) * per_slot]), depth=POOL_DEPTH)
            for i in range(n_slots)
        ]

    def __len__(self) -> int:
        return len(self.slots)

    def __iter__(self):
        return iter(self.slots)
