"""Stable-diffusion workload callback, txt2img path: counterpart of
``chiaswarm_tpu/workloads/diffusion.py::diffusion_callback`` (:27-191).

The job binds to the registry's resident pipeline, generates, screens the
decoded images (a poisoned trajectory raises ``InvalidOutput`` instead of
uploading a flat frame), builds the artifact envelope, and returns the same
config keys as the JAX callback: the pipeline's config, the safety fields
the JAX callback emits when no safety checker is present, and the timing
keys. Inputs this slice does not serve raise ``ValueError`` naming the
later slice, which the executor reports as a fatal bad-request envelope.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from chiaswarm_tpu_torch.node.output_processor import OutputProcessor
from chiaswarm_tpu_torch.pipelines.diffusion import GenerateRequest
from chiaswarm_tpu_torch.serving.guard import screen_images

#: what the JAX callback reports when no safety checker is installed
#: (chiaswarm_tpu/workloads/safety.py::check_images)
SAFETY_UNAVAILABLE = {"nsfw": False, "safety_checker": "unavailable"}


def _refuse(kwargs: dict[str, Any]) -> None:
    later = {
        "image": "img2img (the img2img/inpaint slice)",
        "mask_image": "inpainting (the img2img/inpaint slice)",
        "controlnet_model_name": "ControlNet",
        "image_guidance_scale": "instruct-pix2pix guidance",
        "upscale": "the latent upscaler",
        "textual_inversion": "textual inversion",
        "lora": "LoRA",
        "reuse_schedule": "DeepCache reuse",
    }
    for key, what in later.items():
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

    proc = OutputProcessor(content_type)
    proc.add_images(np.asarray(images))
    artifacts = proc.get_results()

    config.update(SAFETY_UNAVAILABLE)
    config.update({
        "images_per_sec": round(images.shape[0] / max(elapsed, 1e-9), 4),
        "generation_s": round(elapsed, 3),
        "slot": slot.descriptor() if hasattr(slot, "descriptor") else str(slot),
    })
    return artifacts, config
