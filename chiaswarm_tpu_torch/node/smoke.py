"""Smoke harness: one hard-coded job per workflow through the port's real
dispatch and execution stack, no hive. Counterpart of
``chiaswarm_tpu/node/smoke.py`` (``SMOKE_JOBS`` :20-110, :113-176), with
its ten workflows: txt2img, img2img, txt2audio, txt2vid, img2txt, tts,
cascade, img2vid, vid2vid and stitch.

    python -m chiaswarm_tpu_torch.cli smoke                    # sd15, 512 px
    python -m chiaswarm_tpu_torch.cli smoke --model sd15 --size 512
    python -m chiaswarm_tpu_torch.cli smoke --device cpu       # tiny, 64 px
    python -m chiaswarm_tpu_torch.cli smoke --workflow img2img
    python -m chiaswarm_tpu_torch.cli smoke --all --device cpu --random-weights

Every input comes from a seed and is injected into the job, as in the JAX
harness (no network): img2img's, img2txt's and img2vid's image, vid2vid's
frames and stitch's pictures.

Weights are random (seeded) for every model with no local checkpoint
(``--random-weights``, on by default as in the JAX harness). The jobs run
on the GPU unless ``--device`` says otherwise.
The image workflows on an SD pipeline (txt2img, img2img, vid2vid) take
``--model``, ``--size`` and ``--steps``; the model follows the device unless
``--model`` names one: ``sd15`` on the GPU, ``tiny`` on the CPU (on the GPU,
tiny's first UNet level at 256 px would hand kernel B1 head dim 8, which it
does not take). The other workflows run JAX's tiny families; on the GPU
the tiny video and cascade families hand B1 head dims 8 and 16, which it
does not take, so txt2vid, img2vid and cascade serve on the CPU only. Prints
one status JSON line per job and exits non-zero if a job returned an error
envelope.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

#: model -> (catalog family, default steps)
SMOKE_MODELS = {"tiny": ("tiny", 4), "sd15": ("sd15", 20)}

#: the JAX harness's jobs (``chiaswarm_tpu/node/smoke.py:20-110``); the SD
#: workflows' model, size and steps come from :func:`smoke_job`'s arguments
SMOKE_JOBS: dict[str, dict[str, Any]] = {
    "txt2img": {
        "id": "smoke-txt2img",
        "prompt": "a lighthouse on a cliff at golden hour",
        "negative_prompt": "blurry",
        "guidance_scale": 7.5,
        "content_type": "image/png",
    },
    "img2img": {
        "id": "smoke-img2img",
        "prompt": "watercolor style",
        "negative_prompt": "blurry",
        "guidance_scale": 7.5,
        "strength": 0.6,
        "content_type": "image/png",
        "_inject_image": True,
    },
    "txt2audio": {
        "id": "smoke-txt2audio",
        "workflow": "txt2audio",
        "model_name": "random/tiny_audio",
        "prompt": "rain on a tin roof",
        "num_inference_steps": 2,
        "audio_length_in_s": 0.1,
        "content_type": "audio/wav",
    },
    "txt2vid": {
        "id": "smoke-txt2vid",
        "workflow": "txt2vid",
        "model_name": "random/tiny_vid",
        "prompt": "a paper boat drifting",
        "num_frames": 8,
        "num_inference_steps": 2,
        "content_type": "video/mp4",
    },
    "img2txt": {
        "id": "smoke-img2txt",
        "workflow": "img2txt",
        "model_name": "Salesforce/blip-image-captioning-base",
        "content_type": "application/json",
        "_inject_image": True,
    },
    "tts": {
        "id": "smoke-tts",
        "workflow": "txt2audio",
        "model_name": "random/tiny_tts",
        "prompt": "hello from the swarm",
        "audio_length_in_s": 0.3,
        "content_type": "audio/wav",
    },
    "cascade": {
        "id": "smoke-cascade",
        "model_name": "DeepFloyd/tiny_cascade",
        "prompt": "a crystal fox",
        "num_inference_steps": 2,
        "sr_steps": 2,
        "upscale": False,
        "content_type": "image/png",
    },
    "img2vid": {
        "id": "smoke-img2vid",
        "workflow": "img2vid",
        "model_name": "random/tiny_svd",
        "num_frames": 8,
        "num_inference_steps": 2,
        "height": 64, "width": 64,
        "content_type": "video/mp4",
        "_inject_image": True,
    },
    "vid2vid": {
        "id": "smoke-vid2vid",
        "workflow": "vid2vid",
        "prompt": "make it watercolor",
        "num_inference_steps": 2,
        "strength": 0.5,
        "content_type": "video/mp4",
        "_inject_frames": True,
    },
    "stitch": {
        "id": "smoke-stitch",
        "workflow": "stitch",
        "model_name": "stitch",
        "content_type": "image/png",
        "_inject_stitch_images": True,
    },
}

WORKFLOWS = tuple(SMOKE_JOBS)

#: the workflows served by an SD pipeline of ``SMOKE_MODELS``
SD_WORKFLOWS = ("txt2img", "img2img", "vid2vid")


def smoke_job(model: str = "tiny", size: int | None = None,
              steps: int | None = None, seed: int = 1,
              workflow: str = "txt2img") -> dict[str, Any]:
    """``workflow``'s job with its inputs injected; an SD workflow's on
    ``model`` at ``size`` (64 px for tiny, 512 for sd15) for ``steps``."""
    import numpy as np

    job = dict(SMOKE_JOBS[workflow], seed=seed)
    size = size or (64 if model == "tiny" else 512)
    if workflow in SD_WORKFLOWS:
        default_steps = SMOKE_MODELS[model][1]
        job["id"] = f"smoke-{workflow}-{model}-{size}"
        job["model_name"] = model
        job.setdefault("num_inference_steps", default_steps)
        if steps:
            job["num_inference_steps"] = steps
        if workflow != "vid2vid":
            job.update(height=size, width=size)
    rng = np.random.default_rng(0)
    if job.pop("_inject_image", False):
        side = size if workflow == "img2img" else 64
        job["image"] = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    if job.pop("_inject_frames", False):
        side = size if model != "tiny" else 64
        job["frames"] = [np.full((side, side, 3), 30 * i, np.uint8)
                         for i in range(3)]
        job["fps"] = 8.0
    if job.pop("_inject_stitch_images", False):
        from PIL import Image

        job["jobs"] = [{"resultUri": f"smoke://{i}"} for i in range(3)]
        job["images"] = [Image.new("RGB", (64, 64), (40 * i, 20, 20))
                         for i in range(3)]
    return job


def default_model(device) -> str:
    return "tiny" if device.type == "cpu" else "sd15"


def run_smoke(model: str | None = None, size: int | None = None,
              steps: int | None = None, device: str | None = None,
              workflow: str = "txt2img",
              random_weights: bool = True) -> dict[str, Any]:
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry = ModelRegistry(
        catalog=[{"name": m, "family": fam}
                 for m, (fam, _) in SMOKE_MODELS.items()],
        allow_random=random_weights, device=device)
    slot = ChipPool(device=registry.device).slots[0]
    model = model or default_model(registry.device)
    try:
        return synchronous_do_work(
            smoke_job(model, size, steps, workflow=workflow), slot, registry)
    finally:
        get_stepper(slot).shutdown()  # the job's lane, if it rode one


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=sorted(SMOKE_MODELS), default=None,
                        help="the SD workflows' model (default: sd15 on the "
                        "GPU, tiny on the CPU)")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--workflow", choices=WORKFLOWS, default="txt2img")
    parser.add_argument("--all", action="store_true",
                        help="run every workflow's smoke job")
    parser.add_argument("--random-weights", action="store_true",
                        default=True,
                        help="seeded random weights for models with no "
                        "local checkpoint (always on, as in the JAX harness)")
    args = parser.parse_args(argv)

    from chiaswarm_tpu_torch.core.device import resolve_device

    model = args.model or default_model(resolve_device(args.device))
    failures = 0
    for workflow in WORKFLOWS if args.all else (args.workflow,):
        result = run_smoke(model, args.size, args.steps, args.device,
                           workflow=workflow,
                           random_weights=args.random_weights)
        config = result.get("pipeline_config", {})
        status = "error" if "error" in config else "ok"
        line = {
            "workflow": workflow, "status": status,
            "model": (model if workflow in SD_WORKFLOWS
                      else SMOKE_JOBS[workflow]["model_name"]),
            "mode": config.get("mode"),
            "fatal": bool(result.get("fatal_error")),
            "artifacts": sorted(result.get("artifacts", {})),
            "generation_s": config.get("generation_s"),
        }
        if status == "error":
            line["error"] = config["error"]
            failures += 1
        print(json.dumps(line))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
