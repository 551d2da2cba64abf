"""Stable-diffusion workload, txt2img path: counterpart of
``chiaswarm_tpu/workloads/diffusion.py`` (``diffusion_callback`` :27-191, the
lane workload ``stepper_eligible``/``StepperTicket``/``stepper_submit``/
``stepper_finish`` :236-466).

The job binds to the registry's resident pipeline, generates, screens the
decoded images (a poisoned trajectory raises ``InvalidOutput`` instead of
uploading a flat frame), builds the artifact envelope, and returns the same
config keys as the JAX callback: the pipeline's config, the safety fields
the JAX callback emits when no safety checker is present, and the timing
keys (and ``residency: per_job`` when the model is degraded to
load-per-job). Inputs this slice does not serve raise ``ValueError`` naming
the later slice, which the executor reports as a fatal bad-request
envelope.

The lane workload hands an eligible txt2img job to the slot's
continuous-batching scheduler (``serving/stepper.py``) and finishes it into
the JAX lane envelope's config keys, ``stepper`` stamp included. A job
carrying anything a later slice serves is not eligible: it takes the solo
path, which refuses it and names that slice. Neither is a job whose model
came back degraded to load-per-job.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from chiaswarm_tpu_torch.node.output_processor import OutputProcessor
from chiaswarm_tpu_torch.obs.trace import span
from chiaswarm_tpu_torch.pipelines.diffusion import GenerateRequest
from chiaswarm_tpu_torch.serving.guard import screen_images
from chiaswarm_tpu_torch.serving.residency import is_transient

#: what the JAX callback reports when no safety checker is installed
#: (chiaswarm_tpu/workloads/safety.py::check_images)
SAFETY_UNAVAILABLE = {"nsfw": False, "safety_checker": "unavailable"}


#: job arguments a later slice serves, and what each asks for
_LATER = {
    "image": "img2img (the img2img/inpaint slice)",
    "mask_image": "inpainting (the img2img/inpaint slice)",
    "controlnet_model_name": "ControlNet",
    "image_guidance_scale": "instruct-pix2pix guidance",
    "upscale": "the latent upscaler",
    "textual_inversion": "textual inversion",
    "lora": "LoRA",
    "reuse_schedule": "DeepCache reuse",
}


def _refuse(kwargs: dict[str, Any]) -> None:
    for key, what in _LATER.items():
        if kwargs.get(key):
            raise ValueError(f"{what} is not served by chiaswarm_tpu_torch "
                             "yet (a later slice of the port)")


def diffusion_callback(slot, model_name: str, *, seed: int, registry,
                       prompt: str = "",
                       negative_prompt: str = "",
                       num_inference_steps: int = 30,
                       guidance_scale: float = 7.5,
                       height: int | None = None,
                       width: int | None = None,
                       num_images_per_prompt: int = 1,
                       scheduler_type: str | None = None,
                       content_type: str = "image/png",
                       **kwargs: Any):
    _refuse(kwargs)
    pipe = registry.pipeline(model_name, mesh=getattr(slot, "mesh", None))
    degraded = is_transient(pipe)  # the load-per-job rung
    fam = pipe.c.family
    if fam.kind != "sd":
        raise ValueError(
            f"model {model_name!r} is a {fam.kind} model, not a generation "
            f"pipeline; upscalers run via the server's 'upscale' parameter")
    height = int(height or fam.default_size)
    width = int(width or fam.default_size)
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
    )
    t0 = time.perf_counter()
    images, config = pipe(req)
    elapsed = time.perf_counter() - t0

    screen_images(images, context="solo decode")

    with span("artifacts", images=int(images.shape[0])):  # PNG, base64
        proc = OutputProcessor(content_type)
        proc.add_images(np.asarray(images))
        artifacts = proc.get_results()

    config.update(SAFETY_UNAVAILABLE)
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
    if any(kwargs.get(key) for key in _LATER):
        return False  # the solo path refuses it, naming its slice
    guidance = kwargs.get("guidance_scale")
    if guidance is not None and float(guidance) <= 1.0:
        # few-step kinds ride lanes without CFG; the rest run the solo path
        if SAMPLERS.get(kwargs.get("scheduler_type") or "") not in \
                FEWSTEP_KINDS:
            return False
    height, width = kwargs.get("height"), kwargs.get("width")
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


def stepper_submit(slot, registry, kwargs: dict[str, Any], seed: int,
                   job_id: Any = None) -> StepperTicket:
    """Hand one formatted txt2img job to the slot's step scheduler. Raises
    ``LaneReject`` (or anything else) when the job must run through the
    per-job path instead."""
    from chiaswarm_tpu_torch.core.buckets import bucket_image_size
    from chiaswarm_tpu_torch.schedulers import resolve
    from chiaswarm_tpu_torch.serving.stepper import LaneReject, get_stepper

    model_name = kwargs.get("model_name")
    pipe = registry.pipeline(model_name, mesh=getattr(slot, "mesh", None))
    if is_transient(pipe):
        # degraded to load-per-job: a lane would hold the over-budget
        # weights between jobs (the executor's lane_resident_ok check
        # makes this a first-ever-load-only cost)
        raise LaneReject(
            f"model {model_name!r} degraded to load-per-job (residency)")
    fam = pipe.c.family
    height = int(kwargs.get("height") or fam.default_size)
    width = int(kwargs.get("width") or fam.default_size)
    steps = max(1, int(kwargs.get("num_inference_steps") or 30))
    guidance = kwargs.get("guidance_scale")
    guidance = 7.5 if guidance is None else float(guidance)
    rows = max(1, int(kwargs.get("num_images_per_prompt") or 1))
    future = get_stepper(slot).submit_request(
        pipe,
        prompt=str(kwargs.get("prompt") or ""),
        negative_prompt=str(kwargs.get("negative_prompt") or ""),
        steps=steps, guidance_scale=guidance, height=height, width=width,
        rows=rows, seed=int(seed), scheduler=kwargs.get("scheduler_type"),
        job_id=job_id)
    sampler = resolve(kwargs.get("scheduler_type"),
                      prediction_type=fam.prediction_type)
    return StepperTicket(
        future=future, model_name=model_name, family=fam.name,
        sampler_kind=sampler.kind, steps=steps, guidance=guidance,
        req_hw=(height, width), compiled_hw=bucket_image_size(height, width),
        rows=rows, seed=int(seed),
        content_type=kwargs.get("content_type", "image/png"),
        slot=slot, t0=time.perf_counter())


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
        artifacts = proc.get_results()
    config = {
        "model_name": ticket.model_name,
        "family": ticket.family,
        "scheduler": ticket.sampler_kind,
        "steps": ticket.steps,
        "denoise_steps": ticket.steps,
        "guidance_scale": ticket.guidance,
        "size": list(ticket.req_hw),
        "compiled_size": list(ticket.compiled_hw),
        "batch": ticket.rows,
        "mode": "txt2img",
        "seed": ticket.seed,
        "stepper": dict(lane_info),
    }
    config.update(SAFETY_UNAVAILABLE)
    config.update({
        "images_per_sec": round(images.shape[0] / max(elapsed, 1e-9), 4),
        "generation_s": round(elapsed, 3),
        "slot": (ticket.slot.descriptor()
                 if hasattr(ticket.slot, "descriptor")
                 else str(ticket.slot)),
    })
    return artifacts, config
