"""The solo sampler step with its scalars on the host, against on the card.

The solo denoise loop (``chiaswarm_tpu_torch/pipelines/diffusion.py``)
calls ``scale_model_input`` and ``sampler_step``
(``chiaswarm_tpu_torch/schedulers/sampling.py``) once a step each. These
now move the step's sigmas (and LCM's timestep) to the sample's card before
they compute (``core/device.py::upload``, two pinned uploads a step), so
that the solo step's last bits are the lane's; an earlier version computed
with host scalars. This script measures what the uploads cost, for SD1.5 at
its published widths with random bf16 weights from seed 0, 512 px, 20
steps of DPM-Solver++(2M) Karras, guidance 7.5, on the solo path
(``CHIASWARM_STEPPER=0``):

1. ``step``: the 20 steps of the two functions alone at the solo sample's
   shape (1, 4, 64, 64) bf16, with a fixed model output per step: the
   host's milliseconds to issue them (``perf_counter``, the card idle
   before) and to finish them (synchronised), median of 20 loops a turn.
2. ``serve``: ``--jobs`` solo jobs (seeds 1, 2, ...) through
   ``synchronous_do_work`` with the pipeline's two functions taken from one
   version or the other: each job's seconds and ``generation_s``.

Both run in turns (before, after, after, before), after one warm-up of
each, so host drift falls on both versions alike; each turn's numbers are
printed, then the medians per version. The version before is a file:

    git show <commit>:chiaswarm_tpu_torch/schedulers/sampling.py \\
        > build/sampling_before.py
    python tools/torch_sampler_ab.py build/sampling_before.py [--jobs 3]

Prints one JSON object, then the ``nvidia-smi`` name and power limit line.
Needs one NVIDIA GPU; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 20
TURNS = ("before", "after", "after", "before")


def load_before(path: str):
    spec = importlib.util.spec_from_file_location("sampling_before", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look themselves up
    spec.loader.exec_module(module)
    return module


def step_times(torch, versions: dict, loops: int = 20) -> dict:
    from chiaswarm_tpu_torch.schedulers import (
        make_noise_schedule,
        make_sampling_schedule,
        resolve,
    )
    from chiaswarm_tpu_torch.schedulers.common import ScheduleConfig

    sampler = resolve("DPMSolverMultistepScheduler")
    sched = make_sampling_schedule(make_noise_schedule(ScheduleConfig()),
                                   STEPS, sampler)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x0 = (torch.randn((1, 4, 64, 64), generator=gen)
          * float(sched.sigmas[0])).to("cuda", torch.bfloat16)
    eps = [torch.randn((1, 4, 64, 64), generator=gen).to("cuda",
                                                         torch.bfloat16)
           for _ in range(STEPS)]

    def loop(mod):
        x = x0
        state = mod.init_sampler_state(x)
        for i in range(STEPS):
            mod.scale_model_input(sched, x, i)  # the UNet's input
            x, state = mod.sampler_step(sampler, sched, i, x, eps[i], state)
        return x

    for mod in versions.values():  # warm-up
        loop(mod)
    torch.cuda.synchronize()
    turns = []
    for name in TURNS:
        issue, done = [], []
        for _ in range(loops):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop(versions[name])
            issue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            done.append((time.perf_counter() - t0) * 1e3)
        turns.append({"version": name,
                      "issue_ms_per_step": statistics.median(issue) / STEPS,
                      "done_ms_per_step": statistics.median(done) / STEPS})
    return {"turns": turns, **{name: {
        key: statistics.median(t[key] for t in turns if t["version"] == name)
        for key in ("issue_ms_per_step", "done_ms_per_step")}
        for name in versions}}


def serve_times(torch, versions: dict, jobs: int) -> dict:
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.pipelines import diffusion

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(device="cuda").slots[0]

    def job(seed: int) -> dict:
        return {"id": f"ab-{seed}", "model_name": "sd15",
                "prompt": "a lighthouse on a cliff at golden hour, oil "
                          "painting",
                "num_inference_steps": STEPS, "guidance_scale": 7.5,
                "height": 512, "width": 512, "seed": seed,
                "content_type": "image/png"}

    def run(name: str, seeds) -> list[dict]:
        diffusion.scale_model_input = versions[name].scale_model_input
        diffusion.sampler_step = versions[name].sampler_step
        out = []
        for seed in seeds:
            t0 = time.perf_counter()
            result = synchronous_do_work(job(seed), slot, registry)
            seconds = time.perf_counter() - t0
            cfg = result["pipeline_config"]
            if "error" in cfg or "stepper" in cfg:
                raise AssertionError(f"{name} job {seed}: {cfg}")
            out.append({"seed": seed, "seconds": seconds,
                        "generation_s": cfg["generation_s"]})
        return out

    for name in versions:  # warm-up
        run(name, [100])
    turns = [{"version": name, "jobs": run(name, range(1, jobs + 1))}
             for name in TURNS]
    return {"turns": turns, **{name: {
        key: statistics.median(j[key] for t in turns
                               if t["version"] == name for j in t["jobs"])
        for key in ("seconds", "generation_s")} for name in versions}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("before", help="sampling.py of the version before")
    parser.add_argument("--jobs", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is "
                         "false")
    os.environ["CHIASWARM_STEPPER"] = "0"
    from chiaswarm_tpu_torch.schedulers import sampling

    versions = {"before": load_before(args.before), "after": sampling}
    with torch.inference_mode():
        step = step_times(torch, versions)
    serve = serve_times(torch, versions, args.jobs)
    print(json.dumps({"step": step, "serve": serve}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
