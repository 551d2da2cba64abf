"""Model registry: the hive catalog, checkpoint loading and the residency
ledger, counterpart of ``chiaswarm_tpu/node/registry.py`` (``model_dir``
:34, quarantine :83-112, catalog :116-123, residency :127-174,
``_load_components`` :182-197, ``pipeline`` :199-301).

A hive model name resolves to a family through the catalog entry's
``family`` field or the name hints of ``models.configs.get_family``. Its
weights load from ``<settings root>/models/<name with / -> __>``
(:func:`model_dir`), a diffusers-layout directory
(``Components.from_checkpoint``: ``unet/``, ``vae/``, ``text_encoder/``,
``tokenizer/``). With no directory there, ``allow_random=True`` (tests, the
smoke harness, the chip smoke run's random-weight phases) makes seeded
random weights of the family; otherwise the model is not available on this
node, which the executor reports as the non-fatal ``model_unavailable``
kind. A directory that exists is always loaded, never replaced by random
weights: a broken one raises.

Every pipeline goes through the registry's residency ledger
(``serving/residency.py``), one entry per (model, slot mesh,
:func:`_mesh_cache_key`): measured footprints, priority/LRU eviction (the
victim's lanes retire at drain), load-per-job degradation and the
``ModelUnavailable`` bounce. The registry owns its ledger unless given one
(JAX shares one process-wide ledger between registries). The quarantine
that the worker's circuit breakers mirror in is copied and shared with the
ledger's state enum (:meth:`model_states`).

LoRA and textual-inversion entries wait for their slice: the diffusion
callback refuses those jobs before they reach the registry.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import torch

from chiaswarm_tpu_torch.core.device import resolve_device
from chiaswarm_tpu_torch.core.mesh import DeviceMesh, seq_size
from chiaswarm_tpu_torch.models.configs import FAMILIES, ModelFamily, get_family
from chiaswarm_tpu_torch.node.settings import settings_root
from chiaswarm_tpu_torch.pipelines.components import (
    Components,
    estimate_family_bytes,
)
from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
from chiaswarm_tpu_torch.serving.residency import (
    ResidencyManager,
    default_budget_bytes,
    default_hard_limit_bytes,
)

log = logging.getLogger("chiaswarm_torch.registry")


def model_dir(model_name: str) -> Path:
    return settings_root() / "models" / model_name.replace("/", "__")


class ModelRegistry:
    def __init__(self, catalog: list[dict] | None = None,
                 allow_random: bool = False,
                 device: str | torch.device | None = None,
                 residency: ResidencyManager | None = None) -> None:
        self._catalog = {m.get("name", m.get("model_name", "")): m
                         for m in (catalog or [])}
        self.allow_random = allow_random
        self.device = resolve_device(device)
        self._quarantined: dict[str, str] = {}
        if residency is None:
            budget = default_budget_bytes(self.device)
            residency = ResidencyManager(
                budget, default_hard_limit_bytes(budget, self.device))
        self.residency = residency

    # ---- quarantine (the worker's circuit breakers) ----

    def quarantine(self, model_name: str, reason: str = "") -> None:
        """Refuse to serve ``model_name`` until :meth:`unquarantine`."""
        log.error("quarantining model %s%s", model_name,
                  f": {reason}" if reason else "")
        self._quarantined[model_name] = reason or "circuit breaker open"
        self.residency.note_quarantined(model_name)

    def unquarantine(self, model_name: str) -> None:
        if self._quarantined.pop(model_name, None) is not None:
            log.warning("model %s released from quarantine", model_name)
        self.residency.note_unquarantined(model_name)

    def is_quarantined(self, model_name: str) -> bool:
        return model_name in self._quarantined

    # ---- catalog ----

    def entry(self, model_name: str) -> dict[str, Any]:
        return self._catalog.get(model_name, {})

    def parameters(self, model_name: str) -> dict[str, Any]:
        return dict(self.entry(model_name).get("parameters", {}))

    def known_models(self) -> list[str]:
        return list(self._catalog)

    def family_for(self, model_name: str) -> ModelFamily:
        fam = self.entry(model_name).get("family")
        if fam and fam in FAMILIES:
            return FAMILIES[fam]
        return get_family(model_name)

    # ---- residency (serving/residency.py is the authority) ----

    def model_states(self) -> dict[str, str]:
        """One per-model state: ``cold`` / ``loading`` / ``resident`` /
        ``degraded`` / ``evicted`` / ``unavailable`` / ``quarantined``."""
        states = {name: "cold" for name in self._catalog if name}
        states.update(self.residency.model_states())
        for model in self._quarantined:
            states[model] = "quarantined"
        return states

    def lane_resident_ok(self, model_name: str) -> bool:
        """May this model hold a resident lane? A model degraded to
        load-per-job runs solo (load, run, release): a lane would keep its
        over-budget weights alive between jobs. The executor asks before
        a lane submit pays a transient load."""
        return not self.residency.would_degrade(str(model_name))

    def _priority_for(self, model_name: str) -> int:
        """Catalog-driven eviction priority (higher = evicted later), from
        a ``residency_priority`` entry or parameter field."""
        entry = self.entry(model_name)
        raw = entry.get("residency_priority",
                        (entry.get("parameters") or {}).get(
                            "residency_priority", 0))
        try:
            return int(raw)
        except (TypeError, ValueError):
            return 0

    def _estimate_bytes(self, model_name: str) -> int | None:
        """Pre-load reservation of a model never measured: its family's
        bf16 estimate, or None (load, then measure) for a family whose
        modules the port does not build."""
        try:
            return estimate_family_bytes(self.family_for(model_name))
        except ValueError:  # the port's modules refuse the family
            return None

    def _load_components(self, model_name: str,
                         device: torch.device) -> Components:
        ckpt = model_dir(model_name)
        if ckpt.exists():
            log.info("loading checkpoint %s from %s", model_name, ckpt)
            return Components.from_checkpoint(
                ckpt, model_name, self.family_for(model_name), device=device)
        if self.allow_random:
            log.warning("no checkpoint for %s; using random weights",
                        model_name)
            return Components.random(self.family_for(model_name), seed=0,
                                     device=device, model_name=model_name)
        raise ValueError(f"model {model_name!r} is not available on this "
                         f"node (no checkpoint at {ckpt})")

    def pipeline(self, model_name: str,
                 mesh: DeviceMesh | None = None) -> DiffusionPipeline:
        """The pipeline of ``model_name`` for a slot's ``mesh``: its modules
        on the mesh's lead device (the registry's device when no mesh is
        given), ringing its large self-attentions over the mesh's ``seq``
        axis when that is above 1. One ledger entry per (model,
        :func:`_mesh_cache_key`); a model over the budget comes back
        uncached (load-per-job), one over the hard limit raises
        ``ModelUnavailable``."""
        reason = self._quarantined.get(model_name)
        if reason is not None:
            raise ValueError(f"model {model_name!r} is quarantined on this "
                             f"node ({reason})")
        device = self.device if mesh is None else mesh.lead

        def build() -> DiffusionPipeline:
            return DiffusionPipeline(
                self._load_components(model_name, device),
                mesh=mesh if seq_size(mesh) > 1 else None)

        return self.residency.acquire(
            ("pipeline", model_name, _mesh_cache_key(device, mesh)), build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            estimate=lambda: self._estimate_bytes(model_name),
            priority=self._priority_for(model_name))


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
