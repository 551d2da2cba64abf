"""Smoke harness: one hard-coded job per workflow (txt2img, img2img)
through the port's real dispatch and execution stack, no hive. Counterpart
of ``chiaswarm_tpu/node/smoke.py`` (:20-37, :117-172).

    python -m chiaswarm_tpu_torch.node.smoke                  # sd15, 512 px, GPU
    python -m chiaswarm_tpu_torch.node.smoke --model sd15 --size 512
    python -m chiaswarm_tpu_torch.node.smoke --device cpu     # tiny, 64 px
    python -m chiaswarm_tpu_torch.node.smoke --workflow img2img
    python -m chiaswarm_tpu_torch.node.smoke --all            # both

The img2img job's input image is made from a seed and injected into the job
(no network), as in the JAX harness.

Weights are random (seeded). The job runs on the GPU unless ``--device``
says otherwise. The model follows the device unless ``--model`` names one:
``sd15`` on the GPU, ``tiny`` on the CPU. (On the GPU, tiny's first UNet
level has 1024 tokens of head dim 8, which kernel B1 does not take.) Prints
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

WORKFLOWS = ("txt2img", "img2img")


def smoke_job(model: str = "tiny", size: int | None = None,
              steps: int | None = None, seed: int = 1,
              workflow: str = "txt2img") -> dict[str, Any]:
    family, default_steps = SMOKE_MODELS[model]
    size = size or (64 if model == "tiny" else 512)
    job = {
        "id": f"smoke-{workflow}-{model}-{size}",
        "model_name": model,
        "prompt": "a lighthouse on a cliff at golden hour",
        "negative_prompt": "blurry",
        "num_inference_steps": steps or default_steps,
        "guidance_scale": 7.5,
        "height": size, "width": size,
        "seed": seed,
        "content_type": "image/png",
    }
    if workflow == "img2img":
        import numpy as np

        rng = np.random.default_rng(0)
        job.update(prompt="watercolor style", strength=0.6,
                   image=rng.integers(0, 255, (size, size, 3),
                                      dtype=np.uint8))
    return job


def default_model(device) -> str:
    return "tiny" if device.type == "cpu" else "sd15"


def run_smoke(model: str | None = None, size: int | None = None,
              steps: int | None = None, device: str | None = None,
              workflow: str = "txt2img") -> dict[str, Any]:
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry = ModelRegistry(
        catalog=[{"name": m, "family": fam}
                 for m, (fam, _) in SMOKE_MODELS.items()],
        allow_random=True, device=device)
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
                        help="default: sd15 on the GPU, tiny on the CPU")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--workflow", choices=WORKFLOWS, default="txt2img")
    parser.add_argument("--all", action="store_true",
                        help="run every workflow's smoke job")
    args = parser.parse_args(argv)

    from chiaswarm_tpu_torch.core.device import resolve_device

    model = args.model or default_model(resolve_device(args.device))
    failures = 0
    for workflow in WORKFLOWS if args.all else (args.workflow,):
        result = run_smoke(model, args.size, args.steps, args.device,
                           workflow=workflow)
        config = result.get("pipeline_config", {})
        status = "error" if "error" in config else "ok"
        line = {
            "workflow": workflow, "model": model, "status": status,
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
