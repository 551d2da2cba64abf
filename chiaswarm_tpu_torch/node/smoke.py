"""Smoke harness: one hard-coded txt2img job through the port's real
dispatch and execution stack, no hive. Counterpart of
``chiaswarm_tpu/node/smoke.py`` (:117-172).

    python -m chiaswarm_tpu_torch.node.smoke                  # sd15, 512 px, GPU
    python -m chiaswarm_tpu_torch.node.smoke --model sd15 --size 512
    python -m chiaswarm_tpu_torch.node.smoke --device cpu     # tiny, 64 px

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


def smoke_job(model: str = "tiny", size: int | None = None,
              steps: int | None = None, seed: int = 1) -> dict[str, Any]:
    family, default_steps = SMOKE_MODELS[model]
    size = size or (64 if model == "tiny" else 512)
    return {
        "id": f"smoke-txt2img-{model}-{size}",
        "model_name": model,
        "prompt": "a lighthouse on a cliff at golden hour",
        "negative_prompt": "blurry",
        "num_inference_steps": steps or default_steps,
        "guidance_scale": 7.5,
        "height": size, "width": size,
        "seed": seed,
        "content_type": "image/png",
    }


def default_model(device) -> str:
    return "tiny" if device.type == "cpu" else "sd15"


def run_smoke(model: str | None = None, size: int | None = None,
              steps: int | None = None, device: str | None = None
              ) -> dict[str, Any]:
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
        return synchronous_do_work(smoke_job(model, size, steps), slot,
                                   registry)
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
    args = parser.parse_args(argv)

    from chiaswarm_tpu_torch.core.device import resolve_device

    model = args.model or default_model(resolve_device(args.device))
    result = run_smoke(model, args.size, args.steps, args.device)
    config = result.get("pipeline_config", {})
    status = "error" if "error" in config else "ok"
    line = {
        "workflow": "txt2img", "model": model, "status": status,
        "fatal": bool(result.get("fatal_error")),
        "artifacts": sorted(result.get("artifacts", {})),
        "generation_s": config.get("generation_s"),
    }
    if status == "error":
        line["error"] = config["error"]
    print(json.dumps(line))
    return 1 if status == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
