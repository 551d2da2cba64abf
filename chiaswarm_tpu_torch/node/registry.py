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

A ControlNet (:meth:`ModelRegistry.controlnet`, JAX :549-600) is a ledger
entry of its own, under ``("controlnet", name, family, quantize, device)``:
JAX's key (``quantize`` is its int8 choice) plus the device the bundle
lives on, since the port's multi-card pools build one slot per card.
Evicting it retires the lanes keyed by it.

int8 weights (``CHIASWARM_WEIGHTS=int8``, ``convert/quantize.py``, JAX
:255-276 and :561-600): a diffusion (``kind == "sd"``) pipeline and a
ControlNet bundle are quantized after the LoRA and textual-inversion
merges (an inversion's rows change its table's absmax) and before they are
handed out; a slot mesh of more than one device declines, with JAX's
warning. The int8 choice joins both ledger keys (a pipeline's as a
trailing ``"int8"``, so a bf16 key is JAX's), so a node that switches
formats never serves the other format's entry, and a model never measured
is planned at ``bytes_per_param()`` (1 under int8, else 2).

:meth:`ModelRegistry.pipeline` selects the pipeline class by the
family's ``kind``, as JAX does (:278-291): ``"upscaler"`` builds the x2
``LatentUpscalePipeline`` and ``"upscaler4"`` the SD x4
``Upscale4xPipeline`` (``pipelines/upscale.py``; on a ``seq`` > 1 slot it
raises, ROADMAP queue item 7d), the rest builds ``DiffusionPipeline``,
which rings over a ``seq`` > 1 slot for SD1.x, SD2.x and SDXL alike. A
textual inversion and a LoRA at a scale key entries of their own, ``("pipeline", name,
textual_inversion, (lora, scale), mesh key)`` as in JAX: each is built
from its own ``Components``, the embedding rows appended to its private
tables (``convert/textual_inversion.py``) and the LoRA merged into its
private UNet (``convert/lora.py``) before the pipeline is handed out. Their
files load from :func:`model_dir` of the adapter's name; a missing one is
"not available on this node", the non-fatal ``model_unavailable`` kind.

:meth:`ModelRegistry.cascade_pipeline` (JAX :306-352) serves the
``DeepFloyd/`` cascade: a directory under :func:`model_dir` with
``text_encoder/`` (T5), ``unet/`` (stage 1) and ``unet_sr/`` (stage 2)
(``convert/checkpoint.py::load_cascade_checkpoint``), seeded random
weights of the family only under ``allow_random``, else not available on
this node; one ledger entry per ``("cascade", name, mesh key)`` sized by
its measured footprint. A ``seq`` > 1 slot raises (ROADMAP queue item 7).

:meth:`ModelRegistry.caption_pipeline` (JAX :493-547),
:meth:`ModelRegistry.audio_pipeline` (JAX :354-389),
:meth:`ModelRegistry.tts_pipeline` (JAX :451-491) and
:meth:`ModelRegistry.video_pipeline` (JAX :392-449) serve img2txt,
txt2audio, txt2vid and img2vid: a BLIP directory in transformers' layout,
an AudioLDM one in diffusers' layout, a Bark one in transformers' layout
and a video one in diffusers' layout under :func:`model_dir`, on the slot
mesh's lead device, keyed ``("caption" | "audio" | "tts" | "video", name,
device)``. An unusable caption, Bark or video directory logs and, like a
missing one, takes seeded weights only under ``allow_random``, as in JAX.
On a ``seq`` > 1 slot caption, audio and video raise (ROADMAP queue item
7; JAX rings the first two and the video clip there); TTS, which JAX never
rings, runs on the slot's lead card. vid2vid runs through
:meth:`ModelRegistry.pipeline`.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import torch

from chiaswarm_tpu_torch.convert.lora import load_lora, merge_lora
from chiaswarm_tpu_torch.convert.quantize import (
    bytes_per_param,
    int8_wanted,
    maybe_quantize_,
)
from chiaswarm_tpu_torch.convert.textual_inversion import (
    apply_textual_inversion,
    load_embeddings,
)
from chiaswarm_tpu_torch.core.device import resolve_device
from chiaswarm_tpu_torch.core.mesh import DeviceMesh, seq_size
from chiaswarm_tpu_torch.models.configs import FAMILIES, ModelFamily, get_family
from chiaswarm_tpu_torch.node.settings import settings_root
from chiaswarm_tpu_torch.pipelines.components import (
    Components,
    ControlNetBundle,
    estimate_family_bytes,
)
from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
from chiaswarm_tpu_torch.pipelines.upscale import (
    LatentUpscalePipeline,
    Upscale4xPipeline,
)
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
        estimate at the serving weight density (``bytes_per_param``), or
        None (load, then measure) for a family whose modules the port does
        not build."""
        try:
            return estimate_family_bytes(self.family_for(model_name),
                                         bytes_per_param())
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
                 textual_inversion: str | None = None,
                 lora: str | None = None, lora_scale: float = 1.0,
                 mesh: DeviceMesh | None = None
                 ) -> (DiffusionPipeline | LatentUpscalePipeline
                       | Upscale4xPipeline):
        """The pipeline of ``model_name`` for a slot's ``mesh``: its modules
        on the mesh's lead device (the registry's device when no mesh is
        given), ringing its large self-attentions over the mesh's ``seq``
        axis when that is above 1; with ``textual_inversion`` and ``lora``
        (at ``lora_scale``) applied to a private copy of the model. One
        ledger entry per (model, inversion, (LoRA, scale),
        :func:`_mesh_cache_key`); a model over the budget comes back
        uncached (load-per-job), one over the hard limit raises
        ``ModelUnavailable``."""
        self._check_quarantine(model_name)
        if self.family_for(model_name).kind == "upscaler4":
            # the cascade's stage 3, which does not run on a seq slot
            self._one_card("x4 upscaler", model_name, mesh)
        device = self.device if mesh is None else mesh.lead

        def build() -> (DiffusionPipeline | LatentUpscalePipeline
                        | Upscale4xPipeline):
            components = self._load_components(model_name, device)
            if textual_inversion is not None:
                apply_textual_inversion(components, load_embeddings(
                    self._adapter_dir("textual inversion",
                                      textual_inversion)))
            if lora is not None:
                n_merged = merge_lora(
                    components.unet,
                    load_lora(self._adapter_dir("LoRA", lora)),
                    scale=float(lora_scale))
                log.info("merged LoRA %s into %s (%d projections, scale "
                         "%.3g)", lora, model_name, n_merged, lora_scale)
            # int8 after the merges, before the pipeline is handed out
            maybe_quantize_(components.modules(), family=components.family,
                            mesh=mesh)
            ring = mesh if seq_size(mesh) > 1 else None
            if components.family.kind == "upscaler":
                return LatentUpscalePipeline(components, mesh=ring)
            if components.family.kind == "upscaler4":
                return Upscale4xPipeline(components)
            return DiffusionPipeline(components, mesh=ring)

        lora_key = (lora, float(lora_scale)) if lora is not None else None
        quantize = int8_wanted(self.family_for(model_name), mesh)
        return self.residency.acquire(
            ("pipeline", model_name, textual_inversion, lora_key,
             _mesh_cache_key(device, mesh)) + (("int8",) if quantize else ()),
            build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            estimate=lambda: self._estimate_bytes(model_name),
            priority=self._priority_for(model_name))

    @staticmethod
    def _adapter_dir(what: str, name: str) -> Path:
        path = model_dir(name)
        if not path.exists():
            raise ValueError(f"{what} {name!r} is not available on this node "
                             f"(no file at {path})")
        return path

    def _check_quarantine(self, model_name: str) -> None:
        reason = self._quarantined.get(model_name)
        if reason is not None:
            raise ValueError(f"model {model_name!r} is quarantined on this "
                             f"node ({reason})")

    def _one_card(self, what: str, model_name: str,
                  mesh: DeviceMesh | None) -> torch.device:
        """The device of a pipeline that does not ring: the slot mesh's lead
        device (the registry's with no mesh). A ``seq`` > 1 slot raises: the
        JAX package rings the caption, audio, video and cascade programs
        there, or pins the captioner to the lead chip (ROADMAP queue item
        7d)."""
        if seq_size(mesh) > 1:
            raise NotImplementedError(
                f"{what} model {model_name!r} on a seq={seq_size(mesh)} "
                "mesh is not served yet (ROADMAP queue item 7: the rings "
                "serve the SD1.x, SD2.x and SDXL pipelines)")
        return self.device if mesh is None else mesh.lead

    def cascade_pipeline(self, model_name: str,
                         mesh: DeviceMesh | None = None):
        """The resident DeepFloyd-class cascade of ``model_name`` (JAX
        :306-352) on the slot mesh's lead device: a directory under
        :func:`model_dir` (``text_encoder/``, ``unet/``, ``unet_sr/``),
        seeded random weights of the family only under ``allow_random``,
        else the model is not available on this node. One ledger entry per
        ``("cascade", name, mesh key)``."""
        from chiaswarm_tpu_torch.convert.checkpoint import (
            load_cascade_checkpoint,
        )
        from chiaswarm_tpu_torch.pipelines.cascade import (
            CascadeComponents,
            CascadePipeline,
            get_cascade_family,
        )

        self._check_quarantine(model_name)
        device = self._one_card("cascade", model_name, mesh)

        def build() -> CascadePipeline:
            ckpt = model_dir(model_name)
            family = get_cascade_family(model_name)
            if ckpt.exists():
                log.info("loading cascade %s from %s", model_name, ckpt)
                return CascadePipeline(load_cascade_checkpoint(
                    ckpt, model_name, family, device=device))
            if self.allow_random:
                log.warning("no checkpoint for cascade %s; using random "
                            "weights", model_name)
                return CascadePipeline(CascadeComponents.random(
                    family, model_name=model_name, device=device))
            raise ValueError(f"cascade model {model_name!r} is not available "
                             f"on this node (no checkpoint at {ckpt})")

        return self.residency.acquire(
            ("cascade", model_name, _mesh_cache_key(device, mesh)), build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            priority=self._priority_for(model_name))

    def caption_pipeline(self, model_name: str,
                         mesh: DeviceMesh | None = None):
        """The resident BLIP captioner of ``model_name`` (JAX :493-547) on
        the slot mesh's lead device: a transformers-layout directory under
        :func:`model_dir`; one that cannot be loaded logs, and like no
        directory at all gives seeded tiny weights under ``allow_random``,
        else the model is not available on this node. One ledger entry per
        ``("caption", name, device)``."""
        from chiaswarm_tpu_torch.pipelines.caption import (
            CaptionComponents,
            CaptionPipeline,
        )

        self._check_quarantine(model_name)
        device = self._one_card("caption", model_name, mesh)

        def build() -> CaptionPipeline:
            ckpt = model_dir(model_name)
            components = None
            if ckpt.exists():
                try:
                    log.info("loading caption model %s from %s", model_name,
                             ckpt)
                    components = CaptionComponents.from_checkpoint(
                        ckpt, model_name, device=device)
                except Exception as exc:
                    log.warning("caption checkpoint at %s unusable (%s: %s)",
                                ckpt, type(exc).__name__, exc)
            if components is None and self.allow_random:
                log.warning("no checkpoint for caption model %s; using "
                            "random tiny weights", model_name)
                components = CaptionComponents.random(
                    "blip_tiny", model_name=model_name, device=device)
            if components is None:
                why = (f"checkpoint at {ckpt} is unusable"
                       if ckpt.exists() else f"no checkpoint at {ckpt}")
                raise ValueError(f"caption model {model_name!r} is not "
                                 f"available on this node ({why})")
            return CaptionPipeline(components)

        return self.residency.acquire(
            ("caption", model_name, _device_key(device)), build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            priority=self._priority_for(model_name))

    def audio_pipeline(self, model_name: str,
                       mesh: DeviceMesh | None = None):
        """The resident AudioLDM-class txt2audio pipeline of ``model_name``
        (JAX :354-389) on the slot mesh's lead device: a diffusers-layout
        directory under :func:`model_dir` (``convert/checkpoint.py::
        load_audio_checkpoint``), seeded random weights of the family only
        under ``allow_random``, else not available on this node. One ledger
        entry per ``("audio", name, device)``."""
        from chiaswarm_tpu_torch.convert.checkpoint import load_audio_checkpoint
        from chiaswarm_tpu_torch.pipelines.audio import (
            AudioComponents,
            AudioPipeline,
            get_audio_family,
        )

        self._check_quarantine(model_name)
        device = self._one_card("audio", model_name, mesh)

        def build() -> AudioPipeline:
            ckpt = model_dir(model_name)
            family = get_audio_family(model_name)
            if ckpt.exists():
                log.info("loading audio model %s from %s", model_name, ckpt)
                return AudioPipeline(load_audio_checkpoint(
                    ckpt, model_name, family, device=device))
            if self.allow_random:
                log.warning("no checkpoint for audio model %s; using random "
                            "weights", model_name)
                return AudioPipeline(AudioComponents.random(
                    family, model_name=model_name, device=device))
            raise ValueError(f"audio model {model_name!r} is not available "
                             f"on this node (no checkpoint at {ckpt})")

        return self.residency.acquire(
            ("audio", model_name, _device_key(device)), build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            priority=self._priority_for(model_name))

    def video_pipeline(self, model_name: str,
                       mesh: DeviceMesh | None = None):
        """The resident video pipeline of ``model_name`` (JAX :392-449):
        ``Img2VidPipeline`` for an SVD-class family, ``VideoPipeline`` for a
        text family (``pipelines/video.py::get_video_family``), on the slot
        mesh's lead device. A diffusers video snapshot under
        :func:`model_dir` (``VideoComponents.from_checkpoint``: strict for
        ModelScope and SVD snapshots, a plain SD one inflated into a text
        family); one that cannot be loaded logs and, like no directory at
        all, gives seeded random weights of the family under
        ``allow_random``, else the model is not available on this node. One
        ledger entry per ``("video", name, device)``, sized by
        ``param_bytes``. A ``seq`` > 1 slot raises (JAX rings the clip
        there, ROADMAP queue item 7)."""
        from chiaswarm_tpu_torch.pipelines.video import (
            Img2VidPipeline,
            VideoComponents,
            VideoPipeline,
            get_video_family,
        )

        self._check_quarantine(model_name)
        device = self._one_card("video", model_name, mesh)

        def build() -> VideoPipeline | Img2VidPipeline:
            family = get_video_family(model_name)
            pipeline_cls = (Img2VidPipeline if family.image_conditioned
                            else VideoPipeline)
            ckpt = model_dir(model_name)
            components = None
            if ckpt.exists():
                try:
                    log.info("loading video model %s from %s (strict "
                             "temporal conversion; 2D snapshots inflate "
                             "for text families only)", model_name, ckpt)
                    components = VideoComponents.from_checkpoint(
                        ckpt, model_name, family, device=device)
                except Exception as exc:
                    log.warning("video checkpoint at %s unusable (%s: %s)",
                                ckpt, type(exc).__name__, exc)
            if components is None and self.allow_random:
                log.warning("video model %s: using random weights",
                            model_name)
                components = VideoComponents.random(
                    family, model_name=model_name, device=device)
            if components is None:
                why = (f"checkpoint at {ckpt} is unusable"
                       if ckpt.exists() else f"no checkpoint at {ckpt}")
                raise ValueError(f"video model {model_name!r} is not "
                                 f"available on this node ({why})")
            return pipeline_cls(components)

        return self.residency.acquire(
            ("video", model_name, _device_key(device)), build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            priority=self._priority_for(model_name))

    def tts_pipeline(self, model_name: str,
                     mesh: DeviceMesh | None = None):
        """The resident bark-class TTS pipeline of ``model_name`` (JAX
        :451-491) on the slot mesh's lead device: a transformers
        ``BarkModel`` directory under :func:`model_dir`
        (``TTSComponents.from_checkpoint``); one that cannot be loaded logs
        and, like no directory at all, gives seeded random weights of the
        family under ``allow_random``, else the model is not available on
        this node. One ledger entry per ``("tts", name, device)``: JAX's key
        plus the device, as every one-card entry of the port."""
        from chiaswarm_tpu_torch.pipelines.tts import (
            TTSComponents,
            TTSPipeline,
            get_tts_family,
        )

        self._check_quarantine(model_name)
        # JAX builds it on the default device whatever the slot: it never
        # rings, so a seq slot serves it on its lead card
        device = self.device if mesh is None else mesh.lead

        def build() -> TTSPipeline:
            family = get_tts_family(model_name)
            ckpt = model_dir(model_name)
            if ckpt.exists():
                try:
                    log.info("loading tts model %s from %s", model_name, ckpt)
                    return TTSPipeline(TTSComponents.from_checkpoint(
                        ckpt, model_name, family, device=device))
                except Exception as exc:
                    log.warning("tts checkpoint at %s unusable (%s: %s)",
                                ckpt, type(exc).__name__, exc)
            if self.allow_random:
                log.warning("tts model %s: using random weights", model_name)
                return TTSPipeline(TTSComponents.random(
                    family, model_name=model_name, device=device))
            raise ValueError(f"tts model {model_name!r} is not available on "
                             f"this node (no checkpoint at {ckpt})")

        return self.residency.acquire(
            ("tts", model_name, _device_key(device)), build,
            model=model_name, size_of=lambda pipe: pipe.c.param_bytes(),
            priority=self._priority_for(model_name))

    def controlnet(self, controlnet_name: str, family: ModelFamily,
                   mesh: DeviceMesh | None = None) -> ControlNetBundle:
        """The resident ControlNet ``controlnet_name`` for ``family``, on the
        slot mesh's lead device (the registry's device when no mesh is
        given). It loads from :func:`model_dir` (a diffusers
        ``ControlNetModel`` directory); with none there, seeded random
        weights only under ``allow_random``, else it is not available on
        this node. Under int8 weights a bundle for a one-device slot is
        quantized as the base pipeline is, and the choice keys its entry."""
        device = self.device if mesh is None else mesh.lead
        quantize = int8_wanted(family, mesh)

        def load() -> ControlNetBundle:
            ckpt = model_dir(controlnet_name)
            if ckpt.exists():
                log.info("loading controlnet %s from %s", controlnet_name,
                         ckpt)
                bundle = ControlNetBundle.from_checkpoint(
                    ckpt, controlnet_name, family, device=device)
            elif self.allow_random:
                log.warning("no checkpoint for controlnet %s; using random "
                            "weights", controlnet_name)
                bundle = ControlNetBundle.random(family, device=device,
                                                 model_name=controlnet_name)
            else:
                raise ValueError(f"controlnet {controlnet_name!r} is not "
                                 f"available on this node (no checkpoint at "
                                 f"{ckpt})")
            if quantize:
                maybe_quantize_(bundle.modules(), family=family)
            return bundle

        return self.residency.acquire(
            ("controlnet", controlnet_name, family.name, quantize,
             _device_key(device)), load,
            model=controlnet_name, size_of=lambda b: b.param_bytes(),
            priority=self._priority_for(controlnet_name))


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
