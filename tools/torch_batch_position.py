"""Does a row's result depend on where it sits in the batch, on the GPU?

A continuous-batching lane (``chiaswarm_tpu_torch/serving/stepper.py``)
gives each job the free slots of its row file, so the same job can ride
slot 0 in one run and slot 5 in the next. This script measures what that
does to the numbers, for SD1.5 at its published widths with random bf16
weights from seed 0 at 512 px (the serve path):

1. ``ops``: each bf16 op of a lane step at a lane of 8's shapes (16 UNet
   rows), run on a batch and on the same batch rolled by 3 rows, the second
   output rolled back: whether each is bit for bit, and the largest
   difference. The ops: a ``Linear`` over 16 x 4096 tokens (320 -> 320), a
   3x3 ``conv2d`` (320 channels, 64x64), ``group_norm`` (32 groups), B1
   (``flash_attention`` at (16,4096,8,40)), the bottom level's 3x3
   ``conv2d`` (1280 channels, 8x8) and GEGLU ``Linear`` (1280 -> 10240),
   the cross-attention scores (``bmm`` against 77 text tokens), and the
   whole UNet forward; then the 1280-channel convolution and the UNet under
   ``torch.backends.cudnn.deterministic``, and the UNet's milliseconds with
   and without it.
2. ``convs``: the UNet's 3x3 convolutions by channels, side and stride,
   rolled the same way, under cuDNN's default, ``benchmark``, channels-last
   tensors and cuDNN off, with their milliseconds; and the text encoder's
   row 0 at batch 1 against batch 2.
3. ``lane``: one job (``lane_burst``'s seed 12: 12 steps, guidance 5.0) in
   a lane pinned at 8 rows, alone (slot 0) and behind 1, 3 and 7 20-step
   filler jobs submitted first (slots 1, 3 and 7): the largest uint8
   difference from the slot-0 image, and the share of values within one
   level.
4. ``pair``: ``serve``'s seed-1 job with two images, on the solo path and
   through a lane pinned at 2 rows: the same UNet batch, text batch and
   noise, so
   only the lane's per-row step arithmetic differs; its images against the
   solo path's.
5. ``step``: one step of 2 rows through the solo functions (the ladder on
   the host, as the solo loop keeps it) and the lane's per-row functions
   (the ladder on the card), DPM-Solver++(2M) and Euler: bit for bit or
   not.

Prints one JSON object, then the ``nvidia-smi`` name and power limit line.

    python tools/torch_batch_position.py

Needs one NVIDIA GPU; it refuses to run without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROLL = 3


def _compare(torch, a, b) -> dict:
    diff = (a.float() - b.float()).abs()
    rows = diff.reshape(diff.shape[0], -1).amax(dim=1)
    return {"bit_equal": bool(torch.equal(a, b)),
            "rows_bit_equal": int((rows == 0).sum()), "rows": len(rows),
            "max_abs": float(diff.max())}


def op_checks(torch, pipe) -> dict:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import flash_attention

    dev, dt = pipe.c.device, pipe.c.dtype
    gen = torch.Generator(device="cpu").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, dt)

    def rolled(fn, *inputs):
        out = fn(*inputs)
        out_r = fn(*(x.roll(ROLL, dims=0) for x in inputs))
        return _compare(torch, out_r.roll(-ROLL, dims=0), out)

    lin = torch.nn.Linear(320, 320).to(dev, dt)
    conv = torch.nn.Conv2d(320, 320, 3, padding=1).to(dev, dt)
    conv_8 = torch.nn.Conv2d(1280, 1280, 3, padding=1).to(dev, dt)
    geglu_8 = torch.nn.Linear(1280, 10240).to(dev, dt)
    x_tok, x_img = randn(16, 4096, 320), randn(16, 320, 64, 64)
    x_tok_8, x_img_8 = randn(16, 64, 1280), randn(16, 1280, 8, 8)
    q_x, k_x = randn(16 * 8, 4096, 40), randn(16 * 8, 77, 40)
    q, k, v = randn(16, 4096, 8, 40), randn(16, 4096, 8, 40), randn(16, 4096, 8, 40)
    lat, t = randn(16, 4, 64, 64), torch.full((16,), 500.0, device=dev)
    ctx = randn(16, 77, 768)
    with torch.inference_mode():
        out = {
            "linear": rolled(lin, x_tok),
            "conv2d": rolled(conv, x_img),
            "linear_1280_to_10240_8x8": rolled(geglu_8, x_tok_8),
            "conv2d_1280_8x8": rolled(conv_8, x_img_8),
            "cross_attention_scores": rolled(
                lambda a, b: torch.bmm(a, b.transpose(1, 2)), q_x, k_x),
            "group_norm": rolled(lambda x: F.group_norm(x, 32), x_img),
            "flash_attention": rolled(flash_attention, q, k, v),
            "unet": rolled(pipe.c.unet, lat, t, ctx),
        }
        # cuDNN's deterministic algorithms, and the UNet's time both ways
        torch.backends.cudnn.deterministic = True
        try:
            out["deterministic_conv2d_1280_8x8"] = rolled(conv_8, x_img_8)
            out["deterministic_unet"] = rolled(pipe.c.unet, lat, t, ctx)
            out["deterministic_unet_ms"] = _time_ms(
                torch, lambda: pipe.c.unet(lat, t, ctx))
        finally:
            torch.backends.cudnn.deterministic = False
        out["unet_ms"] = _time_ms(torch, lambda: pipe.c.unet(lat, t, ctx))
    torch.cuda.synchronize()
    return out


def _time_ms(torch, fn, iters: int = 10) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def conv_checks(torch, pipe) -> dict:
    """The UNet's 3x3 convolutions at a lane of 8's batch (16 rows), by
    (channels, side, stride), rolled as in ``op_checks``, under cuDNN's
    default, ``benchmark``, channels-last tensors, and cuDNN off (PyTorch's
    own kernel), each with its milliseconds; and the text encoder's row 0
    at batch 1 against batch 2."""
    dev, dt = pipe.c.device, pipe.c.dtype
    gen = torch.Generator(device="cpu").manual_seed(5)
    out: dict = {}
    with torch.inference_mode():
        for c, side, stride in ((320, 64, 1), (640, 32, 1), (1280, 16, 1),
                                (1280, 8, 1), (320, 64, 2), (640, 32, 2),
                                (1280, 16, 2)):
            conv = torch.nn.Conv2d(c, c, 3, stride=stride, padding=1).to(
                dev, dt)
            x = torch.randn((16, c, side, side), generator=gen).to(dev, dt)
            row = {}
            for variant in ("default", "benchmark", "channels_last",
                            "cudnn_off"):
                xv, mod = x, conv
                if variant == "channels_last":
                    xv = x.contiguous(memory_format=torch.channels_last)
                    mod = conv.to(memory_format=torch.channels_last)
                with torch.backends.cudnn.flags(
                        enabled=variant != "cudnn_off",
                        benchmark=variant == "benchmark"):
                    ref = mod(xv)
                    got = mod(xv.roll(ROLL, dims=0)).roll(-ROLL, dims=0)
                    ms = _time_ms(torch, lambda: mod(xv))
                row[variant] = {**_compare(torch, got, ref), "ms": ms}
            out[f"{c}@{side}/s{stride}"] = row
        tok = pipe._tokenize(["a lighthouse on a cliff"] * 2)
        one = pipe._encode_text([t[:1] for t in tok])[0]
        two = pipe._encode_text(tok)[0]
        out["text_encoder_row0_batch1_vs_2"] = _compare(torch, one, two[:1])
    return out


def lane_checks(torch, pipe, slot) -> dict:
    import numpy as np

    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    target = dict(prompt="a lighthouse on a cliff at golden hour, oil "
                  "painting", negative_prompt="blurry, low quality",
                  steps=12, guidance_scale=5.0, height=512, width=512,
                  rows=1, seed=12)
    filler = dict(target, negative_prompt="", steps=20, guidance_scale=7.5)
    images = {}
    for position in (0, 1, 3, 7):
        sched = get_stepper(slot)
        # the fillers stay resident (20 steps), so the target takes the
        # slot after theirs
        futures = [sched.submit_request(pipe, **dict(filler, seed=100 + i))
                   for i in range(position)]
        futures.append(sched.submit_request(pipe, **target))
        results = [f.result(timeout=600) for f in futures]
        pending, info = results[-1]
        images[position] = (pending.wait()[0].astype(np.int16), info)
        for pending_i, _ in results[:-1]:
            pending_i.wait()
        sched.shutdown()
    ref = images[0][0]
    return {str(p): {"max": int(np.abs(img - ref).max()),
                     "within_one": float((np.abs(img - ref) <= 1).mean()),
                     "admitted_at_step": info["admitted_at_step"],
                     "lane_width": info["lane_width"]}
            for p, (img, info) in images.items()}


def pair_check(torch, registry, slot) -> dict:
    """``serve``'s seed-1 job with ``num_images_per_prompt=2`` on the solo
    path and through a lane of 2 rows: the same UNet batch (4 CFG rows, the
    two rows in slots 0 and 1), the same text encoder batch and noise, so
    only the lane's per-row step arithmetic can differ."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    job = {"id": "pair", "model_name": "sd15",
           "prompt": "a lighthouse on a cliff at golden hour, oil painting",
           "num_inference_steps": 20, "guidance_scale": 7.5, "height": 512,
           "width": 512, "seed": 1, "num_images_per_prompt": 2,
           "content_type": "image/png"}
    grids = {}
    # pinned: a full lane of 2 would double at its sixth step boundary
    os.environ["CHIASWARM_STEPPER_LANE_WIDTH"] = "2"
    for mode in ("0", "1"):
        os.environ["CHIASWARM_STEPPER"] = mode
        result = synchronous_do_work(dict(job), slot, registry)
        cfg = result["pipeline_config"]
        assert "error" not in cfg and ("stepper" in cfg) == (mode == "1")
        grids[mode] = (np.asarray(Image.open(io.BytesIO(base64.b64decode(
            result["artifacts"]["primary"]["blob"]))).convert("RGB"))
            .astype(np.int16), cfg.get("stepper"))
    get_stepper(slot).shutdown()
    diff = np.abs(grids["1"][0] - grids["0"][0])
    return {"max": int(diff.max()), "within_one": float((diff <= 1).mean()),
            "bit_equal": bool((diff == 0).all()), "stepper": grids["1"][1]}


def step_probe(torch, pipe) -> dict:
    """One step of 2 rows at steps 0, 1, 10 and 19 of a 20-step ladder,
    through the solo functions (``scale_model_input``, ``sampler_step``;
    the ladder on the host, as the solo loop keeps it) and the lane's
    per-row ones (the ladder on the card), for DPM-Solver++(2M) and Euler:
    bit for bit or not, and the largest difference of ``x``."""
    from chiaswarm_tpu_torch.schedulers import (
        SamplerState,
        make_sampling_schedule,
        resolve,
        sampler_step,
        scale_model_input,
    )
    from chiaswarm_tpu_torch.schedulers.sampling import (
        SamplingSchedule,
        sampler_step_rows,
        scale_model_input_rows,
    )

    dev = pipe.c.device
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = (torch.randn((2, 4, 64, 64), generator=gen) * 10).to(dev)
    old = torch.randn((2, 4, 64, 64), generator=gen).to(dev)
    eps = torch.randn((2, 4, 64, 64), generator=gen).to(dev, torch.bfloat16)
    out = {}
    with torch.inference_mode():
        for name in (None, "EulerDiscreteScheduler"):
            sampler = resolve(name)
            host = make_sampling_schedule(pipe.noise_schedule, 20, sampler)
            rows = SamplingSchedule(host.sigmas[None].repeat(2, 1).to(dev),
                                    host.timesteps[None].repeat(2, 1).to(dev))
            for i in (0, 1, 10, 19):
                idx = torch.full((2,), i, device=dev)
                start = torch.zeros(2, dtype=torch.long, device=dev)
                lane_in = scale_model_input_rows(rows, x, idx)
                lane_x, lane_s = sampler_step_rows(
                    sampler, rows, idx, x, eps, SamplerState(old), None,
                    start)
                solo_in = scale_model_input(host, x, i)
                solo_x, solo_s = sampler_step(sampler, host, i, x, eps,
                                              SamplerState(old))
                out[f"{sampler.kind}@{i}"] = {
                    "scale_model_input": bool(torch.equal(solo_in, lane_in)),
                    "x_next": bool(torch.equal(solo_x, lane_x)),
                    "old_denoised": bool(torch.equal(solo_s.old_denoised,
                                                     lane_s.old_denoised)),
                    "x_next_max_abs": float((solo_x - lane_x).abs().max())}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is "
                         "false")
    os.environ["CHIASWARM_STEPPER_LANE_WIDTH"] = "8"
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.registry import ModelRegistry

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(device="cuda").slots[0]
    pipe = registry.pipeline("sd15")
    out = {"roll": ROLL, "ops": op_checks(torch, pipe),
           "convs": conv_checks(torch, pipe),
           "lane": lane_checks(torch, pipe, slot),
           "pair": pair_check(torch, registry, slot),
           "step": step_probe(torch, pipe)}
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
