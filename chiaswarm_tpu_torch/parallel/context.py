"""The sequence-parallel context, counterpart of
``chiaswarm_tpu/parallel/context.py``.

A pipeline whose slot mesh has a ``seq`` axis above 1 runs its whole
generate call under :func:`sequence_parallel`; ``ops.attention`` reads
:func:`active_seq_mesh` on every call and rings the large self-attentions
over that mesh. The JAX package enters the context around a jitted program
(``seq_parallel_wrap``) and finds the mesh in the params' shardings; the port
runs eagerly and its params live on the mesh's lead device, so the pipeline
enters :func:`sequence_parallel` with its slot's mesh around each call.

A ``contextvars.ContextVar``, not a global, so tests can run pipelines on
different meshes in one process without cross-talk.
"""

from __future__ import annotations

import contextlib
import contextvars

from chiaswarm_tpu_torch.core.mesh import DeviceMesh, ring_devices, seq_size

_seq_mesh: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "chiaswarm_torch_seq_mesh", default=None)
_ring_calls: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "chiaswarm_torch_ring_calls", default=None)


def active_seq_mesh() -> DeviceMesh | None:
    """The mesh whose ``seq`` axis shards attention, or None: None unless
    the context is entered with a mesh whose ``seq`` axis is above 1."""
    mesh = _seq_mesh.get()
    return mesh if seq_size(mesh) > 1 else None


@contextlib.contextmanager
def sequence_parallel(mesh: DeviceMesh | None):
    """Ring qualifying attention over ``mesh``. Entering with None or a
    ``seq = 1`` mesh is a no-op; a mesh that rings over ``seq`` beside
    another axis above 1 raises (``core/mesh.py::ring_devices``)."""
    if seq_size(mesh) > 1:
        ring_devices(mesh)
    token = _seq_mesh.set(mesh)
    try:
        yield
    finally:
        _seq_mesh.reset(token)


@contextlib.contextmanager
def capture_ring_calls():
    """Observe ring attention calls (test instrumentation): yields a list
    that gains ``(kind, q.shape)`` for each call ``ops.attention`` rings,
    ``kind`` being the route, ``"ring_flash"``."""
    calls: list = []
    token = _ring_calls.set(calls)
    try:
        yield calls
    finally:
        _ring_calls.reset(token)


def note_ring_call(kind: str, shape: tuple[int, ...]) -> None:
    calls = _ring_calls.get()
    if calls is not None:
        calls.append((kind, tuple(shape)))
