"""Device meshes, counterpart of ``chiaswarm_tpu/core/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over the chips of a host and
drives all of them from one process. The port mirrors that single-controller
design: a :class:`DeviceMesh` is an array of ``torch.device`` with named
axes, and one process drives every device in it. Ring attention gives
shard i of a sequence to the i-th device along the ``seq`` axis
(``ops/ring_flash_attention.py``).

Copied from the JAX module (names and behaviour kept, pinned by
``tests/test_torch_ring.py``): the axis names (:30-34) and :class:`MeshSpec`
with its ``resolve`` (:37-72). The worker's default-pool policy is copied
too (:79-160): :func:`derive_mesh_spec` with
:func:`resident_param_budget_bytes` (``CHIASWARM_RESIDENCY_BUDGET``) and
:func:`device_hbm_bytes`, which reads a card's total memory from
``torch.cuda.get_device_properties`` and takes the JAX module's default
for a CPU device (pinned by ``tests/test_torch_worker.py``).

A mesh may name one device several times. That is how one card stands in
for a multi-card ring (``DeviceMesh`` over ``[cuda:0] * 4`` is the layout of a
4-card host in latency mode, with every K/V transfer local to the card).

For this slice a mesh may ring only when ``seq`` is its one axis above 1;
:func:`ring_devices` refuses ``data x seq`` and ``model x seq`` meshes.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import numpy as np
import torch

from chiaswarm_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

DEFAULT_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named request for a device mesh.

    ``shape`` maps axis name -> size. Sizes of ``-1`` mean "absorb all
    remaining devices" (at most one axis may be -1). Axes not listed get
    size 1. The product must equal (or, with a -1, divide) the device count.
    """

    shape: dict[str, int] = dataclasses.field(
        default_factory=lambda: {DATA_AXIS: -1}
    )
    axis_order: Sequence[str] = DEFAULT_AXES

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {axis: 1 for axis in self.axis_order}
        for axis, size in self.shape.items():
            if axis not in sizes:
                raise ValueError(f"unknown mesh axis {axis!r}; known: {list(sizes)}")
            sizes[axis] = size
        wildcard = [a for a, s in sizes.items() if s == -1]
        if len(wildcard) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n_devices % fixed:
                raise ValueError(
                    f"cannot factor {n_devices} devices into {sizes} "
                    f"(fixed product {fixed} does not divide)"
                )
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices but {n_devices} are present"
            )
        return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Named axes over an array of ``torch.device`` (C order, as
    ``jax.sharding.Mesh``). The lead device, the first one, is where a
    pipeline's modules live."""

    axis_names: tuple[str, ...]
    devices: np.ndarray  # object array of torch.device, one dim per axis

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> list[torch.device]:
        return list(self.devices.flat)

    @property
    def lead(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def repeats_devices(self) -> bool:
        names = [str(d) for d in self.device_list]
        return len(set(names)) < len(names)


_DEFAULT_HBM_BYTES = 16 * 1024**3  # the JAX module's default chip memory
# params may take at most this fraction of a device; the rest is
# activations, lane rows and headroom (the initial budget before any model
# has loaded; the operator's env override below wins outright)
_PARAM_HBM_FRACTION = 0.35

ENV_RESIDENCY_BUDGET = "CHIASWARM_RESIDENCY_BUDGET"


def resident_param_budget_bytes(hbm_bytes: int | None = None) -> int:
    """Per-device byte budget for resident model params.
    ``CHIASWARM_RESIDENCY_BUDGET`` (bytes) overrides; otherwise a fixed
    fraction of the device's memory."""
    raw = os.environ.get(ENV_RESIDENCY_BUDGET, "").strip()
    if raw:
        try:
            return max(1, int(float(raw)))
        except ValueError:
            pass  # malformed override: fall through to the fraction
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes()
    return int(_PARAM_HBM_FRACTION * hbm_bytes)


def device_hbm_bytes(device: str | torch.device | None = None) -> int:
    """A device's memory: a card's total memory (the first card when
    ``device`` is None), the JAX module's default for a CPU device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        return int(torch.cuda.get_device_properties(index).total_memory)
    return _DEFAULT_HBM_BYTES


def derive_mesh_spec(n_devices: int,
                     heaviest_param_bytes: int | None = None,
                     hbm_bytes: int | None = None,
                     latency: bool = False) -> MeshSpec:
    """Default dp x tp (x sp) policy for a serving pool.

    Everything defaults to ``data``. Tensor parallelism engages only when
    the heaviest catalog family's params would not fit in
    :func:`resident_param_budget_bytes`: tp doubles over power-of-two
    divisors of the device count until the per-device shard fits.
    ``latency=True`` gives the leftover devices to ``seq`` (its largest
    power-of-two factor) instead of ``data``."""
    if n_devices <= 1:
        return MeshSpec({DATA_AXIS: 1})
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes()
    budget = resident_param_budget_bytes(hbm_bytes)
    tp = 1
    if heaviest_param_bytes:
        while (heaviest_param_bytes / tp > budget
               and tp * 2 <= n_devices and n_devices % (tp * 2) == 0):
            tp *= 2
    rest = n_devices // tp
    # seq must divide the power-of-two spatial token counts
    sp = rest & (-rest) if latency else 1
    if sp > 1:
        return MeshSpec({DATA_AXIS: rest // sp, MODEL_AXIS: tp,
                         SEQ_AXIS: sp})
    return MeshSpec({DATA_AXIS: rest, MODEL_AXIS: tp})


def build_mesh(spec: MeshSpec | None = None,
               devices: Sequence[str | torch.device] | None = None
               ) -> DeviceMesh:
    """A :class:`DeviceMesh` over ``devices`` (default: every visible CUDA
    card), shaped by ``spec`` (default: all of them on ``data``)."""
    spec = spec or MeshSpec()
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    sizes = spec.resolve(len(devs))
    axis_names = tuple(spec.axis_order)
    array = np.empty(len(devs), dtype=object)
    array[:] = devs
    return DeviceMesh(axis_names, array.reshape(
        tuple(sizes[a] for a in axis_names)))


def single_device_mesh(device: str | torch.device) -> DeviceMesh:
    """A 1x1x1 mesh for one device."""
    return build_mesh(MeshSpec({DATA_AXIS: 1, MODEL_AXIS: 1, SEQ_AXIS: 1}),
                      devices=[device])


def seq_size(mesh: DeviceMesh | None) -> int:
    return 1 if mesh is None else mesh.shape.get(SEQ_AXIS, 1)


def ring_devices(mesh: DeviceMesh) -> list[torch.device]:
    """The devices along ``seq``, shard i on the i-th. Raises for a mesh
    with another axis above 1 beside ``seq``: rings over ``data x seq`` and
    ``model x seq`` meshes are not ported (ROADMAP queue item 7)."""
    others = {a: s for a, s in mesh.shape.items() if a != SEQ_AXIS and s > 1}
    if others:
        raise NotImplementedError(
            f"sequence-parallel attention over a mesh with {others} beside "
            f"seq={seq_size(mesh)} is not ported yet (ROADMAP queue item 7: "
            "data x seq and model x seq meshes)")
    return mesh.device_list
