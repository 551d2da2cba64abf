"""Stable-diffusion workload, txt2img, img2img, inpaint, instruct-pix2pix and
ControlNet, with the x2 upscale pass, LoRA and textual inversion:
counterpart of
``chiaswarm_tpu/workloads/diffusion.py`` (``diffusion_callback`` :27-191, the
lane workload ``stepper_eligible``/``StepperTicket``/``stepper_submit``/
``stepper_finish`` :236-466, ``stepper_submit`` passing a lane checkpoint
through as ``resume`` :376-387, the solo path's phase checkpoints
:134-146).

An ``image`` (the fetched ``start_image_uri``) sets the job's size and makes
it img2img; a ``mask_image`` beside it makes it inpaint (averaged over its
channels, scaled to [0, 1]). On an instruct-pix2pix family the image
conditions every eval at ``image_guidance_scale`` (the job formatter maps
the hive's strength to it, x 5); on any other family an
``image_guidance_scale`` maps to the img2img strength (the hive sends
strength x 5), as in the JAX callback; both run the solo path.

``lora`` (at ``cross_attention_scale``) and ``textual_inversion`` pick the
registry's adapter pipeline (its own ledger entry, the adapter merged into a
private copy of the model) on the solo path and the lanes alike, and the
config carries them. ``upscale`` runs the x2 latent upscaler
(``upscaler_model_name``, default ``stabilityai/sd-x2-latent-upscaler``)
over the generated images with the job's prompt and seed (JAX :149-155);
the config takes its keys, and the safety check and the envelope see the
upscaled images. Such a job runs the solo path.

A ``controlnet_model_name`` makes the fetched ``image`` the job's
conditioning image, not an init image (JAX :73-91): the registry's resident
``ControlNetBundle`` steers every eval at ``controlnet_scale``; a mask beside
it, or an instruct-pix2pix model, is refused as in JAX. With
``save_preprocessed_input`` the conditioning image comes back as a second
artifact, ``preprocessed_input`` (JAX :166-170).

The job binds to the registry's resident pipeline, generates, screens the
decoded images (a poisoned trajectory raises ``InvalidOutput`` instead of
uploading a flat frame), runs the safety checker over them
(``workloads/safety.py::check_images``: ``nsfw`` and ``nsfw_flags``, or
``safety_checker: "unavailable"`` on a node without a checker), builds the
artifact envelope, and returns the same config keys as the JAX callback:
the pipeline's config, the safety fields and the timing keys (and
``residency: per_job`` when the model is degraded to load-per-job). A
``reuse_schedule`` reaches the request, which ignores it while DeepCache is
off (JAX's default) and serves it with feature reuse while
``CHIASWARM_DEEPCACHE`` is on (the config's ``unet_evals``,
``steps_skipped`` and ``reuse_schedule``); one that does not normalize is a
fatal bad request, as in JAX.

The lane workload hands an eligible txt2img, img2img, inpaint or ControlNet
job, with or without an adapter, to the slot's continuous-batching scheduler
(``serving/stepper.py``), whose lanes key by the pipeline object (so an
adapter's rows never share a lane with its base model's), and finishes it
into the JAX lane envelope's config keys, ``stepper`` stamp, adapter stamps
and safety fields included; a ``reuse_schedule`` job rides a DeepCache
lane while DeepCache is on (its lane stamp carries ``unet_evals`` and
``steps_skipped``) and the plain lane while it is off. An upscale job is not
eligible, nor is a job whose model came back degraded to load-per-job. The lane finish echoes ``preprocessed_input`` too, where the
JAX lane finish drops it (``chiaswarm_tpu/workloads/diffusion.py::
stepper_finish``), and renders a ControlNet job at its conditioning image's
size, as the solo path does, where the JAX lane submit takes the family's
default size: a job's artifacts do not depend on its route.

Coalesced bursts (JAX :469-600, keyed by :data:`COALESCE_KEYS` :204-215):
compatible txt2img, img2img and inpaint jobs that do not ride a lane run as
ONE batched program through :func:`diffusion_coalesced_callback`: per-row
prompts and (seed, row) noise streams, and for image jobs per-job init and
mask stacks each encoded with its own job's seed (``GenerateRequest.
init_groups``), so every job's images are its solo run's up to the batch's
numerics. Each job gets its own envelope config, with ``"coalesced": n``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from chiaswarm_tpu_torch.node.output_processor import OutputProcessor
from chiaswarm_tpu_torch.node.resilience import phase_checkpoint
from chiaswarm_tpu_torch.obs.trace import span
from chiaswarm_tpu_torch.pipelines.diffusion import (
    GenerateRequest,
    image_plan,
)
from chiaswarm_tpu_torch.pipelines.upscale import LatentUpscalePipeline
from chiaswarm_tpu_torch.serving.guard import screen_images
from chiaswarm_tpu_torch.serving.residency import is_transient
from chiaswarm_tpu_torch.workloads.safety import check_images

#: the hive's x2 upscaler (swarm/job_arguments.py:104-110)
DEFAULT_UPSCALER = "stabilityai/sd-x2-latent-upscaler"


def diffusion_callback(slot, model_name: str, *, seed: int, registry,
                       prompt: str = "",
                       negative_prompt: str = "",
                       num_inference_steps: int = 30,
                       guidance_scale: float = 7.5,
                       height: int | None = None,
                       width: int | None = None,
                       num_images_per_prompt: int = 1,
                       image: np.ndarray | None = None,
                       mask_image: np.ndarray | None = None,
                       strength: float = 0.75,
                       image_guidance_scale: float | None = None,
                       scheduler_type: str | None = None,
                       content_type: str = "image/png",
                       upscale: bool = False,
                       upscaler_model_name: str = DEFAULT_UPSCALER,
                       controlnet_model_name: str | None = None,
                       controlnet_scale: float = 1.0,
                       save_preprocessed_input: bool = False,
                       textual_inversion: str | None = None,
                       lora: str | None = None,
                       cross_attention_scale: float = 1.0,
                       reuse_schedule: Any = None,
                       **kwargs: Any):
    mesh = getattr(slot, "mesh", None)
    pipe = registry.pipeline(model_name, textual_inversion=textual_inversion,
                             lora=lora, lora_scale=cross_attention_scale,
                             mesh=mesh)
    degraded = is_transient(pipe)  # the load-per-job rung
    fam = pipe.c.family
    if fam.kind != "sd":
        raise ValueError(
            f"model {model_name!r} is a {fam.kind} model, not a generation "
            f"pipeline; upscalers run via the server's 'upscale' parameter")
    if image is not None:
        height, width = image.shape[:2]
    height = int(height or fam.default_size)
    width = int(width or fam.default_size)
    controlnet = _control(registry, slot, fam, controlnet_model_name,
                          mask_image)
    control_image = None
    if controlnet is not None:
        # the fetched input is the conditioning image: it steers the
        # generation instead of seeding its latents
        control_image, image = image, None
    if image_guidance_scale is not None and not fam.image_conditioned:
        # the user's image guidance on a plain checkpoint: honoured as
        # img2img strength (the hive sends strength x 5)
        strength = min(1.0, max(0.05, float(image_guidance_scale) / 5.0))
    req = GenerateRequest(
        prompt=prompt or "",
        negative_prompt=negative_prompt or "",
        steps=int(num_inference_steps),
        guidance_scale=float(guidance_scale),
        height=height,
        width=width,
        batch=max(1, int(num_images_per_prompt)),
        seed=seed,
        scheduler=scheduler_type,
        init_image=image,
        strength=float(strength),
        mask=_mask_01(mask_image),
        tiled_decode=max(height, width) > 1024,
        image_guidance_scale=float(image_guidance_scale
                                   if image_guidance_scale is not None
                                   else 1.5),
        controlnet=controlnet,
        control_image=control_image,
        control_scale=float(controlnet_scale),
        reuse_schedule=reuse_schedule,
    )
    # coarse phase checkpoints (JAX :134-146): the solo loop keeps no step
    # state to resume from, so with heartbeats on the spool records how far
    # the job got: "encoded" once the model is bound and the request built,
    # "denoised" once the generation finished (lanes checkpoint their steps)
    phase_checkpoint("encoded", model=str(model_name))
    t0 = time.perf_counter()
    images, config = pipe(req)
    elapsed = time.perf_counter() - t0
    phase_checkpoint("denoised", model=str(model_name),
                     generation_s=round(elapsed, 3))

    if upscale:
        # the x2 pass, 20 steps at guidance 0, with the job's own prompt
        # and seed (swarm/diffusion/upscale.py:6-32)
        upscaler = registry.pipeline(upscaler_model_name, mesh=mesh)
        if not isinstance(upscaler, LatentUpscalePipeline):
            raise ValueError(f"upscaler {upscaler_model_name!r} is a "
                             f"{upscaler.c.family.kind} model, not an x2 "
                             "latent upscaler")
        images, up_config = upscaler(images, prompt=prompt or "", seed=seed)
        config.update(up_config)

    screen_images(images, context="solo decode")

    with span("artifacts", images=int(images.shape[0])):  # PNG, base64
        proc = OutputProcessor(content_type)
        proc.add_images(np.asarray(images))
        if control_image is not None and save_preprocessed_input:
            proc.add_images(np.asarray(control_image, dtype=np.uint8),
                            key="preprocessed_input")
        artifacts = proc.get_results()

    config.update(_adapter_fields(textual_inversion, lora,
                                  cross_attention_scale))
    _, safety_fields = check_images(images, model_name, pipe.c.device)
    config.update(safety_fields)
    config.update({
        "images_per_sec": round(images.shape[0] / max(elapsed, 1e-9), 4),
        "generation_s": round(elapsed, 3),
        "slot": slot.descriptor() if hasattr(slot, "descriptor") else str(slot),
    })
    if degraded:
        # this result paid a load: the model exceeds the residency budget
        # and serves load -> run -> release
        config["residency"] = "per_job"
    return artifacts, config


def _adapter_fields(textual_inversion: str | None, lora: str | None,
                    cross_attention_scale: float | None) -> dict[str, Any]:
    """The config's adapter stamps, as the JAX callback writes them."""
    fields: dict[str, Any] = {}
    if textual_inversion is not None:
        fields["textual_inversion"] = textual_inversion
    if lora is not None:
        fields["lora"] = lora
        fields["cross_attention_scale"] = float(
            1.0 if cross_attention_scale is None else cross_attention_scale)
    return fields


def _control(registry, slot, fam, controlnet_model_name: str | None,
             mask_image: Any) -> Any:
    """The job's ``ControlNetBundle`` (None without a
    ``controlnet_model_name``), after JAX's refusals: an instruct-pix2pix
    model, or a mask beside the conditioning image."""
    if controlnet_model_name is None:
        return None
    if fam.image_conditioned:
        raise ValueError(
            "instruct-pix2pix models do not support controlnet; the input "
            "image already conditions generation")
    if mask_image is not None:
        raise ValueError(
            "controlnet jobs cannot also carry a mask_image; the input "
            "image is the conditioning image, not an inpainting source")
    return registry.controlnet(controlnet_model_name, fam,
                               mesh=getattr(slot, "mesh", None))


def _mask_01(mask_image: np.ndarray | None) -> np.ndarray | None:
    """An inpaint mask image -> (H, W) float in [0, 1] (1 = regenerate):
    averaged over channels, scaled down from 0-255 when above 1."""
    if mask_image is None:
        return None
    m = np.asarray(mask_image, dtype=np.float32)
    if m.ndim == 3:
        m = m.mean(axis=-1)
    return m / 255.0 if m.max() > 1.0 else m


# ---- continuous step-level batching (serving/stepper.py) ---------------


def stepper_eligible(kwargs: dict[str, Any]) -> bool:
    """Can this (formatted) job ride a lane? A conservative pre-filter:
    ``StepScheduler.submit_request`` is the authority and raises
    ``LaneReject`` for the residue (steps beyond the capacity lattice, rows
    wider than the lane cap, non-sd families)."""
    from chiaswarm_tpu_torch.schedulers.sampling import FEWSTEP_KINDS, SAMPLERS
    from chiaswarm_tpu_torch.serving.stepper import stepper_enabled

    if not stepper_enabled():
        return False
    if kwargs.get("upscale"):
        return False  # the x2 pass chains a second pipeline: solo
    if kwargs.get("image_guidance_scale") is not None:
        return False  # pix2pix guidance or the strength remap: solo
    guidance = kwargs.get("guidance_scale")
    if guidance is not None and float(guidance) <= 1.0:
        # few-step kinds ride lanes without CFG; the rest run the solo path
        if SAMPLERS.get(kwargs.get("scheduler_type") or "") not in \
                FEWSTEP_KINDS:
            return False
    if kwargs.get("mask_image") is not None \
            and kwargs.get("controlnet_model_name") is not None:
        return False  # the solo path raises the user error
    height, width = kwargs.get("height"), kwargs.get("width")
    image = kwargs.get("image")
    if image is not None and getattr(image, "ndim", 0) >= 2:
        height, width = int(image.shape[0]), int(image.shape[1])
    return not ((height and int(height) > 1024)
                or (width and int(width) > 1024))


@dataclasses.dataclass
class StepperTicket:
    """A submitted lane job: ``stepper_finish`` resolves it into the same
    (artifacts, config) contract the solo callback returns."""

    future: Any
    model_name: str
    family: str
    sampler_kind: str
    steps: int
    guidance: float
    req_hw: tuple[int, int]
    compiled_hw: tuple[int, int]
    rows: int
    seed: int
    content_type: str
    slot: Any
    t0: float
    mode: str
    denoise_steps: int
    device: Any = None
    controlnet_name: str | None = None
    controlnet_scale: float = 1.0
    control_image: np.ndarray | None = None
    save_preprocessed_input: bool = False
    adapters: dict[str, Any] = dataclasses.field(default_factory=dict)


def stepper_submit(slot, registry, kwargs: dict[str, Any], seed: int,
                   job_id: Any = None) -> StepperTicket:
    """Hand one formatted txt2img, img2img, inpaint or ControlNet job, with
    its LoRA or textual inversion, to the slot's step scheduler. Raises
    ``LaneReject`` (or anything else) when the job must run through the
    per-job path instead."""
    from chiaswarm_tpu_torch.core.buckets import bucket_image_size
    from chiaswarm_tpu_torch.schedulers import resolve
    from chiaswarm_tpu_torch.serving.stepper import LaneReject, get_stepper

    model_name = kwargs.get("model_name")
    scale = kwargs.get("cross_attention_scale")
    pipe = registry.pipeline(
        model_name, textual_inversion=kwargs.get("textual_inversion"),
        lora=kwargs.get("lora"),
        lora_scale=1.0 if scale is None else float(scale),
        mesh=getattr(slot, "mesh", None))
    if is_transient(pipe):
        # degraded to load-per-job: a lane would hold the over-budget
        # weights between jobs (the executor's lane_resident_ok check
        # makes this a first-ever-load-only cost)
        raise LaneReject(
            f"model {model_name!r} degraded to load-per-job (residency)")
    fam = pipe.c.family
    image = kwargs.get("image")
    # ControlNet: the fetched input is the conditioning image (the solo
    # callback's remap); the bundle keys the lane
    controlnet_name = kwargs.get("controlnet_model_name")
    controlnet = _control(registry, slot, fam, controlnet_name,
                          kwargs.get("mask_image"))
    control_image = None
    if controlnet is not None:
        control_image, image = image, None
    if image is not None:
        height, width = int(image.shape[0]), int(image.shape[1])
    elif control_image is not None:
        height, width = (int(control_image.shape[0]),
                         int(control_image.shape[1]))
    else:
        height = int(kwargs.get("height") or fam.default_size)
        width = int(kwargs.get("width") or fam.default_size)
    steps = max(1, int(kwargs.get("num_inference_steps") or 30))
    guidance = kwargs.get("guidance_scale")
    guidance = 7.5 if guidance is None else float(guidance)
    rows = max(1, int(kwargs.get("num_images_per_prompt") or 1))
    # None-check, not `or`: strength 0.0 (near-identity img2img) is valid
    strength = kwargs.get("strength")
    strength = 0.75 if strength is None else float(strength)
    cscale = kwargs.get("controlnet_scale")
    cscale = 1.0 if cscale is None else float(cscale)
    mask = _mask_01(kwargs.get("mask_image"))
    mode, start_step = image_plan(steps, strength, image is not None,
                                  mask is not None)
    # a lane checkpoint rides in as ``resume`` (the executor's re-admission
    # after a condemned lane): the rows splice in at its step. Anything
    # else under that key carries no lane state to splice.
    resume = kwargs.get("resume")
    if not (isinstance(resume, dict) and resume.get("kind") == "lane"):
        resume = None
    future = get_stepper(slot).submit_request(
        pipe,
        prompt=str(kwargs.get("prompt") or ""),
        negative_prompt=str(kwargs.get("negative_prompt") or ""),
        steps=steps, guidance_scale=guidance, height=height, width=width,
        rows=rows, seed=int(seed), scheduler=kwargs.get("scheduler_type"),
        job_id=job_id, resume=resume, init_image=image, strength=strength,
        mask=mask, controlnet=controlnet, control_image=control_image,
        control_scale=cscale, reuse_schedule=kwargs.get("reuse_schedule"))
    sampler = resolve(kwargs.get("scheduler_type"),
                      prediction_type=fam.prediction_type)
    return StepperTicket(
        future=future, model_name=model_name, family=fam.name,
        sampler_kind=sampler.kind, steps=steps, guidance=guidance,
        req_hw=(height, width), compiled_hw=bucket_image_size(height, width),
        rows=rows, seed=int(seed),
        content_type=kwargs.get("content_type", "image/png"),
        slot=slot, t0=time.perf_counter(), mode=mode,
        denoise_steps=steps - start_step, device=pipe.c.device,
        controlnet_name=controlnet_name, controlnet_scale=cscale,
        control_image=control_image,
        save_preprocessed_input=bool(kwargs.get("save_preprocessed_input")),
        adapters=_adapter_fields(kwargs.get("textual_inversion"),
                                 kwargs.get("lora"), scale))


def stepper_finish(ticket: StepperTicket):
    """Block on the lane rows, then postprocess as the solo callback does
    (un-bucket crop, screen, artifact encode)."""
    # the job's "step" span: admission wait + its rows' residency in the
    # lane's denoise loop (the lane-side timeline rides in as metadata)
    with span("step", steps=ticket.steps, rows=ticket.rows) as step_span:
        pending, lane_info = ticket.future.result()
        step_span.meta.update(lane_info)
    # the lane decodes at the compiled bucket; un-bucket to the request
    pending.requested_hw = ticket.req_hw
    images = pending.wait()
    screen_images(images, context="lane decode")
    elapsed = time.perf_counter() - ticket.t0

    with span("artifacts", images=int(images.shape[0])):  # PNG, base64
        proc = OutputProcessor(ticket.content_type)
        proc.add_images(images)
        if ticket.control_image is not None and \
                ticket.save_preprocessed_input:
            proc.add_images(np.asarray(ticket.control_image, dtype=np.uint8),
                            key="preprocessed_input")
        artifacts = proc.get_results()
    config = {
        "model_name": ticket.model_name,
        "family": ticket.family,
        "scheduler": ticket.sampler_kind,
        "steps": ticket.steps,
        "denoise_steps": ticket.denoise_steps,
        "guidance_scale": ticket.guidance,
        "size": list(ticket.req_hw),
        "compiled_size": list(ticket.compiled_hw),
        "batch": ticket.rows,
        "mode": ticket.mode,
        "seed": ticket.seed,
        "stepper": dict(lane_info),
    }
    if ticket.controlnet_name is not None:
        config["controlnet"] = ticket.controlnet_name
        config["controlnet_scale"] = ticket.controlnet_scale
    config.update(ticket.adapters)
    _, safety_fields = check_images(images, ticket.model_name, ticket.device)
    config.update(safety_fields)
    config.update({
        "images_per_sec": round(images.shape[0] / max(elapsed, 1e-9), 4),
        "generation_s": round(elapsed, 3),
        "slot": (ticket.slot.descriptor()
                 if hasattr(ticket.slot, "descriptor")
                 else str(ticket.slot)),
    })
    return artifacts, config


# ---- coalesced bursts (JAX :196-220, :469-600) -------------------------

#: the fields compatible jobs share, one batched program apart from the
#: per-job prompts, seeds, images and content types
COALESCE_KEYS = ("num_inference_steps", "guidance_scale", "height",
                 "width", "scheduler_type", "textual_inversion", "lora",
                 "cross_attention_scale", "strength", "reuse_schedule")
#: ControlNet conditions on its image, pix2pix carries its image guidance
_UNCOALESCABLE = ("controlnet_model_name", "image_guidance_scale")


def coalescable(kwargs: dict[str, Any]) -> bool:
    """May this formatted diffusion job share a batched program? Not an
    upscale job (its x2 pass runs with the job's own prompt and seed), nor
    a ControlNet or pix2pix one."""
    return (not kwargs.get("upscale")
            and all(kwargs.get(k) is None for k in _UNCOALESCABLE))


def diffusion_coalesced_callback(slot, model_name: str, *, seed: int,
                                 registry, jobs: list[dict[str, Any]],
                                 **shared: Any):
    """Run several compatible jobs as one batched program. ``jobs`` holds
    each job's own fields (prompt, negative_prompt, num_images_per_prompt,
    seed, image, mask_image, content_type); ``shared`` the
    :data:`COALESCE_KEYS` the executor found equal. Returns one
    (artifacts, config) a job, in order."""
    first = jobs[0]
    prompts: list[str] = []
    negs: list[str] = []
    seed_rows: list[tuple[int, int]] = []
    counts: list[int] = []
    for job in jobs:
        n = max(1, int(job.get("num_images_per_prompt", 1)))
        prompts += [str(job.get("prompt") or "")] * n
        negs += [str(job.get("negative_prompt") or "")] * n
        seed_rows += [(int(job["seed"]), r) for r in range(n)]
        counts.append(n)

    def opt(key: str, default):
        value = shared.get(key)  # present but None means the default
        return default if value is None else value

    pipe = registry.pipeline(
        model_name, textual_inversion=shared.get("textual_inversion"),
        lora=shared.get("lora"),
        lora_scale=opt("cross_attention_scale", 1.0),
        mesh=getattr(slot, "mesh", None))
    fam = pipe.c.family
    # img2img and inpaint: per-job init and mask stacks, each job's image
    # encoded with its own seed (the key keeps shapes uniform)
    init_stack = mask_stack = init_groups = None
    if first.get("image") is not None:
        if fam.image_conditioned:
            raise ValueError("image-conditioned (pix2pix) jobs do not "
                             "coalesce")
        init_stack = np.stack([np.asarray(j["image"]) for j in jobs])
        init_groups = tuple((int(j["seed"]), n)
                            for j, n in zip(jobs, counts))
        if first.get("mask_image") is not None:
            mask_stack = np.stack([_mask_01(j["mask_image"]) for j in jobs])
        height, width = init_stack.shape[1:3]
    else:
        height = int(opt("height", fam.default_size))
        width = int(opt("width", fam.default_size))
    reuse = shared.get("reuse_schedule")
    req = GenerateRequest(
        prompt=tuple(prompts),
        negative_prompt=tuple(negs),
        steps=int(opt("num_inference_steps", 30)),
        guidance_scale=float(opt("guidance_scale", 7.5)),
        height=int(height),
        width=int(width),
        batch=len(prompts),
        seed=int(first["seed"]),
        sample_seed_rows=tuple(seed_rows),
        scheduler=shared.get("scheduler_type"),
        init_image=init_stack,
        init_groups=init_groups,
        strength=float(opt("strength", 0.75)),
        mask=mask_stack,
        tiled_decode=max(int(height), int(width)) > 1024,
        # part of the key, so every member shares one schedule
        reuse_schedule=tuple(reuse) if isinstance(reuse, (list, tuple))
        else reuse,
    )
    t0 = time.perf_counter()
    images, base_config = pipe(req)
    elapsed = time.perf_counter() - t0
    # a poisoned frame fails the whole program; the executor then re-runs
    # every member alone, and the poisoned one gets its own envelope
    screen_images(images, context="coalesced decode")

    results = []
    offset = 0
    for job, n in zip(jobs, counts):
        imgs = images[offset:offset + n]
        offset += n
        with span("artifacts", images=n):  # PNG, base64
            proc = OutputProcessor(job.get("content_type", "image/png"))
            proc.add_images(imgs)
            artifacts = proc.get_results()
        config = dict(base_config)
        config["seed"] = int(job["seed"])
        config["batch"] = n
        config.update(_adapter_fields(
            shared.get("textual_inversion"), shared.get("lora"),
            opt("cross_attention_scale", 1.0)))
        _, safety_fields = check_images(imgs, model_name, pipe.c.device)
        config.update(safety_fields)
        config.update({
            "coalesced": len(jobs),
            # this job's images over the program's wall time (solo
            # semantics); the program's own rate beside it
            "images_per_sec": round(n / max(elapsed, 1e-9), 4),
            "batch_images_per_sec": round(
                images.shape[0] / max(elapsed, 1e-9), 4),
            "generation_s": round(elapsed, 3),
            "slot": (slot.descriptor() if hasattr(slot, "descriptor")
                     else str(slot)),
        })
        results.append((artifacts, config))
    return results
