"""The DeepFloyd cascade workload, counterpart of
``chiaswarm_tpu/workloads/cascade.py`` (``cascade_callback`` :25-119).

A ``DeepFloyd/`` model name routes here with the job's arguments as they
are (``node/job_args.py``). The registry's resident cascade
(``pipelines/cascade.py``) runs the 64 px base and the 256 px
super-resolution on one T5 encode; with ``upscale`` (the default) stage 3
runs ``upscaler_model_name`` (the SD x4 upscaler, ``stabilityai/stable-
diffusion-x4-upscaler``, 256 -> 1024 px in one pass; an x2-class name takes
two passes) to ``final_size``. The safety checker sees the final images,
and the config takes the pipeline's keys, the safety fields,
``images_per_sec``, ``generation_s`` and ``slot``, as JAX's.

JAX runs a multi-image job stage-parallel on a slot of two or more cards
(``generate_stage_parallel``: stages 1 and 2 on one half of the mesh, stage
3 on the other). The port's slots hold one card each (ROADMAP queue item 7),
so that branch is never taken here.
"""

from __future__ import annotations

import time
from typing import Any

from chiaswarm_tpu_torch.node.output_processor import OutputProcessor
from chiaswarm_tpu_torch.workloads.safety import check_images

#: the reference's stage 3 (swarm/diffusion/diffusion_func_if.py:31-40)
DEFAULT_UPSCALER = "stabilityai/stable-diffusion-x4-upscaler"


def cascade_callback(slot, model_name: str, *, seed: int,
                     registry,
                     prompt: str = "",
                     negative_prompt: str = "",
                     num_inference_steps: int = 50,
                     sr_steps: int = 30,
                     guidance_scale: float = 7.0,
                     num_images_per_prompt: int = 1,
                     scheduler_type: str | None = None,
                     content_type: str = "image/png",
                     upscale: bool = True,
                     upscaler_model_name: str = DEFAULT_UPSCALER,
                     final_size: int | None = None,
                     **_ignored: Any):
    mesh = getattr(slot, "mesh", None)
    n_images = max(1, int(num_images_per_prompt))
    pipe = registry.cascade_pipeline(model_name, mesh=mesh)
    upscaler = (registry.pipeline(upscaler_model_name, mesh=mesh)
                if upscale else None)

    t0 = time.perf_counter()
    images, config = pipe(
        prompt=prompt or "",
        negative_prompt=negative_prompt or "",
        steps=int(num_inference_steps),
        sr_steps=int(sr_steps),
        guidance_scale=float(guidance_scale),
        batch=n_images,
        seed=seed,
        scheduler=scheduler_type,
        upscaler=upscaler,
        final_size=final_size,
    )
    elapsed = time.perf_counter() - t0

    proc = OutputProcessor(content_type)
    proc.add_images(images)
    artifacts = proc.get_results()

    _, safety_fields = check_images(images, model_name, pipe.c.device)
    config.update(safety_fields)
    config.update({
        "images_per_sec": round(images.shape[0] / max(elapsed, 1e-9), 4),
        "generation_s": round(elapsed, 3),
        "slot": slot.descriptor() if hasattr(slot, "descriptor") else str(slot),
    })
    return artifacts, config
