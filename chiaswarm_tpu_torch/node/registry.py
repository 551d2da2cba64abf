"""Model registry: a plain per-model pipeline cache, counterpart of
``chiaswarm_tpu/node/registry.py``. As there (``pipeline(model_name,
mesh=None)``, :199-), a slot's mesh keys its own entry
(``_mesh_cache_key``).

A hive model name resolves to a family through the catalog entry's
``family`` field or the name hints of ``models.configs.get_family``. This
slice has no checkpoint loading: with ``allow_random=True`` (tests, the
smoke harness, the chip smoke run) a model gets seeded random weights of
its family; otherwise it is not available on this node, which the executor
reports as the non-fatal ``model_unavailable`` kind. The quarantine that
the worker's circuit breakers mirror in is copied from the JAX registry
(:83-112): a quarantined model's pipeline raises, which the executor
reports as ``model_unavailable``. Residency budgets and LoRA/textual-
inversion merges wait for later slices (the diffusion callback refuses
those jobs before they reach the registry).
"""

from __future__ import annotations

import logging
import threading

import torch

from chiaswarm_tpu_torch.core.device import resolve_device
from chiaswarm_tpu_torch.core.mesh import DeviceMesh, seq_size
from chiaswarm_tpu_torch.models.configs import FAMILIES, ModelFamily, get_family
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline

log = logging.getLogger("chiaswarm_torch.registry")


class ModelRegistry:
    def __init__(self, catalog: list[dict] | None = None,
                 allow_random: bool = False,
                 device: str | torch.device | None = None) -> None:
        self._catalog = {m.get("name", m.get("model_name", "")): m
                         for m in (catalog or [])}
        self.allow_random = allow_random
        self.device = resolve_device(device)
        self._pipelines: dict[str, DiffusionPipeline] = {}
        self._lock = threading.Lock()
        self._quarantined: dict[str, str] = {}

    # ---- quarantine (the worker's circuit breakers) ----

    def quarantine(self, model_name: str, reason: str = "") -> None:
        """Refuse to serve ``model_name`` until :meth:`unquarantine`."""
        log.error("quarantining model %s%s", model_name,
                  f": {reason}" if reason else "")
        self._quarantined[model_name] = reason or "circuit breaker open"

    def unquarantine(self, model_name: str) -> None:
        if self._quarantined.pop(model_name, None) is not None:
            log.warning("model %s released from quarantine", model_name)

    def is_quarantined(self, model_name: str) -> bool:
        return model_name in self._quarantined

    def known_models(self) -> list[str]:
        return list(self._catalog)

    def family_for(self, model_name: str) -> ModelFamily:
        fam = self._catalog.get(model_name, {}).get("family")
        if fam and fam in FAMILIES:
            return FAMILIES[fam]
        return get_family(model_name)

    def _load_components(self, model_name: str,
                         device: torch.device) -> Components:
        if not self.allow_random:
            raise ValueError(
                f"model {model_name!r} is not available on this node "
                "(chiaswarm_tpu_torch loads no checkpoints yet)")
        log.warning("no checkpoint for %s; using random weights", model_name)
        return Components.random(self.family_for(model_name), seed=0,
                                 device=device, model_name=model_name)

    def pipeline(self, model_name: str,
                 mesh: DeviceMesh | None = None) -> DiffusionPipeline:
        """The resident pipeline of ``model_name`` for a slot's ``mesh``:
        its modules on the mesh's lead device (the registry's device when
        no mesh is given), ringing its large self-attentions over the
        mesh's ``seq`` axis when that is above 1. One entry per
        (model, :func:`_mesh_cache_key`)."""
        reason = self._quarantined.get(model_name)
        if reason is not None:
            raise ValueError(f"model {model_name!r} is quarantined on this "
                             f"node ({reason})")
        device = self.device if mesh is None else mesh.lead
        key = (model_name, _mesh_cache_key(device, mesh))
        with self._lock:
            pipe = self._pipelines.get(key)
            if pipe is None:
                pipe = DiffusionPipeline(
                    self._load_components(model_name, device),
                    mesh=mesh if seq_size(mesh) > 1 else None)
                self._pipelines[key] = pipe
            return pipe


def _device_key(device: torch.device) -> str:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _mesh_cache_key(device: torch.device, mesh: DeviceMesh | None) -> tuple:
    """Cache identity of a pipeline: where its modules live and, for a
    ``seq`` > 1 mesh, the mesh it rings over. A mesh that does not ring
    shares the entry of its lead device."""
    if seq_size(mesh) <= 1:
        return (_device_key(device),)
    return (_device_key(device), mesh.axis_names,
            tuple(mesh.shape.values()),
            tuple(_device_key(d) for d in mesh.device_list))
