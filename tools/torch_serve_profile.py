"""Where the time of one txt2img job goes on the GPU, for the PyTorch port.

Runs SD1.5 (random bf16 weights from a seed, published widths) through the
port's ``DiffusionPipeline`` at 512 px, 20 steps, guidance 7.5 (``--model
sdxl``: SDXL at its published widths, 1024 px): one warm-up
job, then one job under ``torch.profiler`` with CPU and CUDA activity. Prints
one JSON object: the job's wall seconds (host clock) and its CUDA-event
span, the summed device time of every
kernel, the device busy share (summed kernel time over the job's wall time;
one stream, so kernels do not overlap), the number of kernel launches, and
the heaviest kernels by total device time with their call counts and
shares; the port's kernels (B1, B2, B3, each with both its routes) are
reported on lines of their own too. ``--seq 4`` serves on a ring of
four shards (four cards when four are visible, else the first card named
four times, where B3 runs each ring attention in one launch);
``CHIASWARM_RING_FLASH=scan`` in the environment makes it the scan drive
over B2. Every profile holds the process-wide profiler lock
(``chiaswarm_tpu_torch/obs/profiling.py::profile``): run in a worker's
process, a ``/debug/profile`` capture meanwhile answers busy, and a profile
asked for during a capture raises ``ProfilerBusy``.

``--controlnet`` profiles the same job twice, as txt2img and as a
ControlNet job at scale 1.0 (a ControlNet of the family's widths, random
from a seed with its zero convs seeded too, on a seeded picture): both
summaries and the control job's extra device ms and launches per eval.

``--upscale`` profiles the job's generation, then the x2 latent upscale
pass over its image (``pipelines/upscale.py::LatentUpscalePipeline``: the
upscaler at the JAX family's widths, random bf16 weights from seed 0, 20
steps; tiled decode above 1024 px): both summaries, B1's device ms and
share of the pass, the pass's peak memory above the weights held, and its
host seconds beside the generation's.

``--audio`` profiles a 10 s txt2audio job instead (AudioLDM at the JAX
family's widths, random weights from seed 0: UNet and VAE bf16, CLAP and
the vocoder float32; 20 steps, guidance 2.5, the default sampler; ``--seconds``
sets the length): the summary with B1's device
ms and share (head dim 32). ``--caption`` profiles BLIP-base (random from
seed 0, its question tower too) on a 512 px picture: a caption, a
conditioned caption and a VQA answer, each summary with its launches.
``--tts`` profiles a 4 s text-to-speech job (Bark at its published widths,
random weights from seed 0: three 24-layer GPTs in bf16, the EnCodec
decoder in float32; ``--seconds`` sets the length) at the default
temperature 0.7 and ``top_k`` 50: the summary (CUDA activity only: a job
launches some half a million kernels), the semantic and coarse decode
steps it took and the launches per step.

``--video txt2vid`` profiles a ModelScope txt2vid job (the family's
published widths, random weights from seed 0: the UNet3D and VAE bf16, the
CLIP-H text tower float32; 25 frames at 256 px, guidance 9.0, ``--steps``
steps); ``--video img2vid`` an SVD img2vid job (the spatio-temporal UNet
and temporal VAE bf16, ViT-H/14 float32; 14 frames at 512 px from a seeded
picture, guidance 1.0 -> 3.0): the summary (CUDA activity only) with B1's
device ms and share and the launches an eval.

``--cascade`` profiles a DeepFloyd cascade job (IF-I-XL's base, IF-II-L's
super-resolution and T5-XXL at their published widths, random bf16 weights
from seed 0; then the SD x4 upscaler, random from seed 0: UNet and VAE bf16,
the CLIP-H tower float32) at the hive's defaults: 50 base steps and 30
super-resolution steps at guidance 7.0, then 75 x4 steps at 9.0, 1024 px
out: the summary (CUDA activity only) with B1's launches, device ms and
share.

``--lanes N`` profiles a burst of N jobs through the continuous-batching
lanes instead (``node/executor.py::synchronous_do_work_batch``, steps 20
and 12 and guidance 7.5 and 5.0 alternating, the lane pinned at
``--width`` rows, N by default): one warm-up burst, then one under the
profiler, with the lane steps it took and the launches per lane step.
``--sweep 1,2,4,8,16`` times that burst, unprofiled, at each pinned lane
width (a warm-up burst first at each) and prints the images/s of each
and every job's ``generation_s``. ``--checker`` times that burst,
unprofiled, without and with a safety checker (ViT-L/14, random from a
seed) in the node's checker directory, A B B A after a warm-up of each:
the lanes' cost of checking each finished job.

    python tools/torch_serve_profile.py [--model sdxl] [--steps 20]
           [--top 25] [--seq 4] [--trace serve_trace.json]
    python tools/torch_serve_profile.py [--model sdxl] --controlnet
    python tools/torch_serve_profile.py [--model sdxl] --upscale
    python tools/torch_serve_profile.py [--model sdxl] --lanes 8 [--width 8]
    python tools/torch_serve_profile.py --lanes 8 --sweep 1,2,4,8,16
    python tools/torch_serve_profile.py --lanes 8 --checker
    python tools/torch_serve_profile.py --audio [--seconds 10]
    python tools/torch_serve_profile.py --caption
    python tools/torch_serve_profile.py --tts [--seconds 4]
    python tools/torch_serve_profile.py --video txt2vid|img2vid [--steps 25]
    python tools/torch_serve_profile.py --cascade

Needs one NVIDIA GPU; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=("sd15", "sdxl"), default="sd15",
                        help="the family, served at its default size")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--seq", type=int, default=1,
                        help="ring shards of a seq mesh (1: no mesh)")
    parser.add_argument("--trace", default=None,
                        help="write a Chrome trace of the profiled job here")
    parser.add_argument("--lanes", type=int, default=0,
                        help="profile a burst of this many jobs on the lanes")
    parser.add_argument("--width", type=int, default=0,
                        help="pinned lane width (default: --lanes)")
    parser.add_argument("--sweep", default="",
                        help="comma-separated lane widths to time the burst at")
    parser.add_argument("--checker", action="store_true",
                        help="with --lanes: time the burst without (A) and "
                             "with (B) a safety checker, A B B A")
    parser.add_argument("--controlnet", action="store_true",
                        help="profile the job as txt2img and as a "
                             "ControlNet job")
    parser.add_argument("--upscale", action="store_true",
                        help="profile the job, then the x2 upscale pass "
                             "over its image")
    parser.add_argument("--audio", action="store_true",
                        help="profile an AudioLDM txt2audio job")
    parser.add_argument("--seconds", type=float, default=None,
                        help="with --audio (10) or --tts (4): the job's "
                             "audio length")
    parser.add_argument("--caption", action="store_true",
                        help="profile BLIP-base captions and a VQA answer")
    parser.add_argument("--tts", action="store_true",
                        help="profile a Bark text-to-speech job")
    parser.add_argument("--video", choices=("txt2vid", "img2vid"),
                        default=None,
                        help="profile a ModelScope txt2vid or an SVD img2vid "
                             "job")
    parser.add_argument("--cascade", action="store_true",
                        help="profile a DeepFloyd cascade job")
    args = parser.parse_args(argv)

    import torch

    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import (
        DiffusionPipeline,
        GenerateRequest,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    if args.lanes:
        return lanes_main(args)
    if args.audio:
        return audio_main(torch, args)
    if args.caption:
        return caption_main(torch, args)
    if args.tts:
        return tts_main(torch, args)
    if args.video:
        return video_main(torch, args)
    if args.cascade:
        return cascade_main(torch, args)
    mesh = None
    if args.seq > 1:
        n_cards = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(args.seq)]
                   if n_cards >= args.seq
                   else [torch.device("cuda", 0)] * args.seq)
        mesh = build_mesh(MeshSpec({"seq": args.seq}), devices=devices)
    pipe = DiffusionPipeline(Components.random(args.model, seed=0,
                                               device="cuda",
                                               dtype=torch.bfloat16),
                             mesh=mesh)
    size = pipe.c.family.default_size
    req = GenerateRequest(prompt="a lighthouse on a cliff at golden hour",
                          negative_prompt="blurry", steps=args.steps,
                          guidance_scale=7.5, height=size, width=size,
                          seed=1)
    head = {"device": torch.cuda.get_device_name(0), "model": args.model,
            "size": size, "steps": args.steps, "seq": args.seq,
            "mesh_devices": None if mesh is None
            else [str(d) for d in mesh.device_list]}
    if args.controlnet:
        import dataclasses

        control = dataclasses.replace(
            req, controlnet=seeded_controlnet(torch, args.model),
            control_image=seeded_picture(size), control_scale=1.0)
        plain, ctrl = profiled(torch, pipe, req), profiled(torch, pipe,
                                                           control)
        evals = args.steps
        print(json.dumps({**head, "txt2img": plain, "controlnet": ctrl,
                          "extra_device_ms_per_eval":
                          (ctrl["device_kernel_ms"]
                           - plain["device_kernel_ms"]) / evals,
                          "extra_launches_per_eval":
                          (ctrl["kernel_launches"]
                           - plain["kernel_launches"]) / evals,
                          "wall_ratio": ctrl["wall_s"] / plain["wall_s"]}))
        return 0
    if args.upscale:
        print(json.dumps({**head, **upscale_profile(torch, pipe, req,
                                                    args.top)}))
        return 0
    summary = profiled(torch, pipe, req, args.trace, args.top)
    print(json.dumps({**head, **summary}))
    return 0


def audio_main(torch, args) -> int:
    """One AudioLDM job profiled after a warm-up (``profiled``)."""
    import functools

    from chiaswarm_tpu_torch.pipelines.audio import (
        AudioComponents,
        AudioPipeline,
    )

    seconds = 10.0 if args.seconds is None else args.seconds
    pipe = AudioPipeline(AudioComponents.random("audioldm", seed=0,
                                                device="cuda"))
    run = functools.partial(pipe, negative_prompt="low quality",
                            steps=args.steps, guidance_scale=2.5,
                            duration_s=seconds, seed=1)
    summary = profiled(torch, run, "rain on a tin roof, distant thunder",
                       args.trace, args.top)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": "audioldm", "seconds": seconds,
                      "guidance": 2.5, "steps": args.steps,
                      "param_bytes": pipe.c.param_bytes(), **summary}))
    return 0


def caption_main(torch, args) -> int:
    """BLIP-base's three modes, each profiled after a warm-up."""
    import functools

    from chiaswarm_tpu_torch.models.tokenizer import WordPieceTokenizer
    from chiaswarm_tpu_torch.pipelines.caption import (
        CaptionComponents,
        CaptionPipeline,
    )

    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    vocab += ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of",
              "what", "color", "is", "the", "sky"]
    vocab += [f"w{i}" for i in range(30522 - len(vocab))]
    pipe = CaptionPipeline(CaptionComponents.random(
        "blip_base", seed=0, device="cuda",
        tokenizer=WordPieceTokenizer({t: i for i, t in enumerate(vocab)})))
    picture = seeded_picture(512)
    out = {"device": torch.cuda.get_device_name(0), "model": "blip_base",
           "param_bytes": pipe.c.param_bytes()}
    for mode, prompt, vqa in (("caption", "", False),
                              ("conditioned", "a photo of", False),
                              ("vqa", "what color is the sky?", True)):
        run = functools.partial(pipe, prompt=prompt, vqa=vqa)
        out[mode] = profiled(torch, run, picture, args.trace, args.top)
    print(json.dumps(out))
    return 0


TTS_TEXT = "Hello, my name is Suno. And, uh, I like pizza."


@contextlib.contextmanager
def counted_decode_steps(pipe):
    """Each ``_stage_decode`` call of ``pipe`` in the block, as (stage,
    max_new)."""
    from chiaswarm_tpu_torch.pipelines import tts

    calls = []
    decode = tts._stage_decode

    def counted(gpt, *args, **kw):
        calls.append(("semantic" if gpt is pipe.c.semantic else "coarse",
                      kw["max_new"]))
        return decode(gpt, *args, **kw)

    tts._stage_decode = counted
    try:
        yield calls
    finally:
        tts._stage_decode = decode


def tts_decode_launches(torch, pipe, steps: tuple[int, int] = (2, 12)
                        ) -> float:
    """Kernel launches of one coarse decode step: two decodes of the coarse
    stage behind one 887-slot prefill, ``steps`` tokens each, under the
    profiler; their difference over the steps' difference."""
    from torch.profiler import ProfilerActivity

    from chiaswarm_tpu_torch.obs.profiling import profile

    from chiaswarm_tpu_torch.pipelines.tts import _stage_decode

    fam = pipe.c.family
    P = fam.coarse_prefill
    prompt = torch.full((1, P), fam.coarse_semantic_pad, dtype=torch.int64,
                        device=pipe.c.device)
    masks = torch.zeros(2, fam.coarse.out_vocab, device=pipe.c.device)
    counts = []
    for n in steps:
        def run(n=n):
            _stage_decode(pipe.c.coarse, prompt, None, P - 40,
                          pipe.generator(0), prefill_len=P, max_new=n,
                          top_k=50, temperature=0.7, step_masks=masks,
                          eos_id=-1, pad_id=0)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        counts.append(sum(n for n, _ in device_kernels(prof).values()))
    return (counts[1] - counts[0]) / (steps[1] - steps[0])


def tts_profile(torch, pipe, seconds: float, top: int = 25,
                warm_up: bool = True) -> dict:
    """One Bark job profiled (CUDA activity only; after a warm-up job
    unless the pipeline is warm), with its decode steps by stage and the
    launches of one decode step."""
    import functools

    run = functools.partial(pipe, duration_s=seconds, seed=1)
    with counted_decode_steps(pipe) as calls:
        summary = profiled(torch, run, TTS_TEXT, top=top, cpu=False,
                           warm_up=warm_up)
    steps = {"semantic": 0, "coarse": 0}
    for stage, n in calls[len(calls) // 2 if warm_up else 0:]:
        steps[stage] += n
    return {**summary, "decode_steps": steps,
            "launches_per_decode_step": tts_decode_launches(torch, pipe)}


def tts_main(torch, args) -> int:
    from chiaswarm_tpu_torch.pipelines.tts import TTSComponents, TTSPipeline

    seconds = 4.0 if args.seconds is None else args.seconds
    pipe = TTSPipeline(TTSComponents.random("bark", seed=0, device="cuda"))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": "bark", "seconds": seconds,
                      "param_bytes": pipe.c.param_bytes(),
                      **tts_profile(torch, pipe, seconds, args.top)}))
    return 0


VIDEO_PROMPT = "a red fox running through fresh snow at dawn, cinematic"


def video_profile(torch, pipe, workflow: str, steps: int = 25,
                  top: int = 25, warm_up: bool = True) -> dict:
    """One video job of ``pipe`` (a ``VideoPipeline`` for ``txt2vid``, an
    ``Img2VidPipeline`` for ``img2vid``) at its family's defaults and
    ``steps`` steps, profiled (CUDA activity only; after a warm-up job
    unless the pipeline is warm): the summary, B1's launches an eval and
    its share of the device time."""
    import functools

    if workflow == "txt2vid":
        run = functools.partial(pipe, steps=steps, guidance_scale=9.0,
                                seed=1)
        arg = VIDEO_PROMPT
    else:
        run = functools.partial(pipe, steps=steps, seed=1)
        arg = seeded_picture(pipe.c.family.default_size)
    summary = profiled(torch, run, arg, top=top, cpu=False, warm_up=warm_up)
    b1 = summary["flash_attention"]
    return {**summary, "steps": steps,
            "b1_launches_per_eval": b1["calls"] / steps,
            "b1_share_of_device": b1["share"]}


def video_main(torch, args) -> int:
    from chiaswarm_tpu_torch.pipelines.video import (
        Img2VidPipeline,
        VideoComponents,
        VideoPipeline,
    )

    family = "modelscope_t2v" if args.video == "txt2vid" else "svd_img2vid"
    components = VideoComponents.random(family, seed=0, device="cuda")
    pipe = (VideoPipeline if args.video == "txt2vid"
            else Img2VidPipeline)(components)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "workflow": args.video, "family": family,
                      "param_bytes": components.param_bytes(),
                      **video_profile(torch, pipe, args.video, args.steps,
                                      args.top)}))
    return 0


CASCADE_PROMPT = "a photo of a red fox in fresh snow, detailed fur, 8k"


def cascade_profile(torch, pipe, upscaler, top: int = 25,
                    warm_up: bool = True) -> dict:
    """One DeepFloyd job of ``pipe`` (a ``CascadePipeline``) at its
    defaults with ``upscaler`` (an ``Upscale4xPipeline``) as its stage 3,
    profiled (CUDA activity only; after a warm-up job unless both are
    warm): the summary and B1's launches and share of the device time."""
    import functools

    run = functools.partial(pipe, negative_prompt="blurry", seed=1,
                            upscaler=upscaler)
    summary = profiled(torch, run, CASCADE_PROMPT, top=top, cpu=False,
                       warm_up=warm_up)
    b1 = summary["flash_attention"]
    return {**summary, "b1_launches": b1["calls"],
            "b1_share_of_device": b1["share"]}


def cascade_main(torch, args) -> int:
    from chiaswarm_tpu_torch.pipelines.cascade import (
        CascadeComponents,
        CascadePipeline,
    )
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.upscale import Upscale4xPipeline

    pipe = CascadePipeline(CascadeComponents.random("if_xl", seed=0,
                                                    device="cuda"))
    upscaler = Upscale4xPipeline(Components.random("upscaler_x4", seed=0,
                                                   device="cuda"))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "family": "if_xl", "upscaler": "upscaler_x4",
                      "param_bytes": pipe.c.param_bytes()
                      + upscaler.c.param_bytes(),
                      **cascade_profile(torch, pipe, upscaler, args.top)}))
    return 0


def upscale_profile(torch, pipe, req, top: int) -> dict:
    """The generation of ``req``, then the x2 pass over its image, each
    profiled after a warm-up."""
    import functools

    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.upscale import LatentUpscalePipeline

    generation = profiled(torch, pipe, req, top=top)
    images, _ = pipe(req)
    upscaler = LatentUpscalePipeline(Components.random(
        "upscaler_x2", seed=0, device="cuda", dtype=torch.bfloat16))
    run = functools.partial(upscaler, prompt=req.prompt, seed=req.seed)
    upscale = profiled(torch, run, images, top=top)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, config = run(images)
    torch.cuda.synchronize()
    return {"generation": generation, "upscale": upscale,
            "upscale_config": config, "output_hw": list(out.shape[1:3]),
            "upscale_peak_bytes": torch.cuda.max_memory_allocated() - held,
            "b1_ms_of_upscale": upscale["flash_attention"]["device_ms"],
            "b1_share_of_upscale_device": upscale["flash_attention"]["share"],
            "b1_share_of_upscale_events": upscale["flash_attention"]
            ["device_ms"] / upscale["event_ms"],
            "upscale_over_generation_wall": upscale["wall_s"]
            / generation["wall_s"]}


def profiled(torch, pipe, req, trace: str | None = None,
             top: int = 25, cpu: bool = True, warm_up: bool = True) -> dict:
    """One warm-up call of ``pipe(req)`` (cuDNN heuristics, allocator,
    kernel library loads; left out for a ``pipe`` already warm), then one
    under the profiler (CPU and CUDA activity, CUDA's alone without
    ``cpu``): its summary and its CUDA-event span. ``pipe`` is any
    callable of ``req``."""
    from torch.profiler import ProfilerActivity

    from chiaswarm_tpu_torch.obs.profiling import profile

    if warm_up:
        pipe(req)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        start.record()
        pipe(req)
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    return {"event_ms": start.elapsed_time(end),
            **kernel_summary(prof, wall_s, top)}


def seeded_controlnet(torch, model: str):
    """A ControlNet of the family's widths on the card, random from seed 0,
    its zero convs drawn too (std 0.01): a fresh one would add zeros."""
    from chiaswarm_tpu_torch.pipelines.components import ControlNetBundle

    bundle = ControlNetBundle.random(model, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        for conv in (bundle.embed.conv_out, bundle.net.controlnet_mid_block,
                     *bundle.net.controlnet_down_blocks):
            for p in (conv.weight, conv.bias):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 0.01)
    return bundle


def seeded_picture(size: int):
    """A smooth uint8 (size, size, 3) picture from seed 3."""
    import numpy as np
    from PIL import Image

    small = np.random.default_rng(3).integers(0, 256, (8, 8, 3),
                                              dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((size, size),
                                                    Image.BICUBIC))


def device_kernels(prof) -> dict:
    """Each device event of a finished ``torch.profiler`` window by name:
    (calls, summed ns). Read straight off the profiler's raw events:
    ``key_averages()`` first builds a Python event tree over the whole
    window, which takes tens of seconds for a job's 10^5 launches."""
    from torch.autograd import DeviceType

    try:
        from torch.autograd.profiler_util import _filter_name, _rewrite_name
    except ImportError:  # the names as the profiler gives them
        def _filter_name(name):
            return False

        def _rewrite_name(name, with_wildcard=False):
            return name
    by_name: dict[str, list[int]] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA or _filter_name(evt.name()):
            continue  # host-side ops and runtime calls
        row = by_name.setdefault(evt.name(), [0, 0])
        row[0] += 1
        row[1] += evt.duration_ns()
    merged: dict[str, tuple[int, int]] = {}
    for name, (calls, ns) in by_name.items():
        key = _rewrite_name(name, with_wildcard=True)
        had = merged.get(key, (0, 0))
        merged[key] = (had[0] + calls, had[1] + ns)
    return merged


def kernel_summary(prof, wall_s: float, top: int) -> dict:
    """Device time, busy share and launches of a profiled window, and the
    port's kernels (each with both its routes) on lines of their own."""
    kernels = [{"name": name[:120], "calls": calls, "device_ms": ns / 1e6}
               for name, (calls, ns) in device_kernels(prof).items()]
    total_ms = sum(k["device_ms"] for k in kernels)
    kernels.sort(key=lambda k: -k["device_ms"])
    for k in kernels:
        k["share"] = k["device_ms"] / total_ms if total_ms else 0.0

    def kernel_line(*symbols: str) -> dict:
        rows = [k for k in kernels if any(s in k["name"] for s in symbols)]
        return {"calls": sum(k["calls"] for k in rows),
                "device_ms": sum(k["device_ms"] for k in rows),
                "share": sum(k["share"] for k in rows)}

    return {
        "wall_s": wall_s,
        "device_kernel_ms": total_ms,
        "device_busy_share": total_ms / 1e3 / wall_s,
        "kernel_launches": sum(k["calls"] for k in kernels),
        # each kernel's CUDA-core sweep and tensor-core route by name
        "flash_attention": kernel_line("flash_fwd_kernel<",
                                       "flash_fwd_tc_kernel<"),
        "ring_flash_hop": kernel_line("ring_hop_kernel<",
                                      "ring_hop_tc_kernel<"),
        "ring_flash_fused": kernel_line("ring_fused_kernel<",
                                        "ring_fused_tc_kernel<"),
        "top": kernels[:top],
    }


def burst_jobs(n: int, steps: int, model: str = "sd15") -> list[dict]:
    """``n`` jobs at the model's size: ``steps`` and 12 steps, guidance 7.5
    and 5.0, alternating (the mix of chip_smoke.py's lane_burst phase)."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES

    size = FAMILIES[model].default_size
    return [{"id": f"burst-{i}", "model_name": model,
             "prompt": "a lighthouse on a cliff at golden hour, oil painting",
             "negative_prompt": "blurry, low quality" if i == 1 else "",
             "num_inference_steps": steps if i % 2 == 0 else 12,
             "guidance_scale": 7.5 if i % 2 == 0 else 5.0,
             "height": size, "width": size, "seed": 11 + i,
             "content_type": "image/png"} for i in range(n)]


def lanes_main(args) -> int:
    import torch
    from torch.profiler import ProfilerActivity

    from chiaswarm_tpu_torch.obs.profiling import profile

    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry = ModelRegistry(catalog=[{"name": args.model,
                                       "family": args.model}],
                             allow_random=True, device="cuda")
    slot = ChipPool(device="cuda").slots[0]
    stepper = get_stepper(slot)
    jobs = burst_jobs(args.lanes, args.steps, args.model)
    os.environ["CHIASWARM_STEPPER"] = "1"

    def burst(width: int) -> tuple[float, int, list[float]]:
        """One burst at a pinned lane width: (wall s, lane steps, each
        job's ``generation_s``)."""
        os.environ["CHIASWARM_STEPPER_LANE_WIDTH"] = str(width)
        before = stepper.stats().get("steps_executed", 0)
        t0 = time.perf_counter()
        results = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                            registry)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        for result in results:
            cfg = result["pipeline_config"]
            if "error" in cfg or "stepper" not in cfg:
                raise SystemExit(f"job {result['id']} was not served by a "
                                 f"lane: {cfg.get('error')}")
        return (wall_s, stepper.stats()["steps_executed"] - before,
                [r["pipeline_config"]["generation_s"] for r in results])

    line = {"device": torch.cuda.get_device_name(0), "model": args.model,
            "jobs": len(jobs),
            "steps": [j["num_inference_steps"] for j in jobs]}
    try:
        if args.sweep:
            sweep = []
            for width in (int(w) for w in args.sweep.split(",")):
                stepper.shutdown()  # a fresh lane at the new width
                burst(width)  # warm-up: cuDNN plans for the new batch
                wall_s, steps, generation_s = burst(width)
                sweep.append({"width": width, "wall_s": wall_s,
                              "lane_steps": steps,
                              "images_per_s": len(jobs) / wall_s,
                              "generation_s": generation_s})
            line["sweep"] = sweep
        elif args.checker:
            line.update(width=args.width or args.lanes,
                        **checker_ab(torch, burst, args.width or args.lanes,
                                     len(jobs)))
        else:
            width = args.width or args.lanes
            burst(width)  # warm-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_s, steps, generation_s = burst(width)
            summary = kernel_summary(prof, wall_s, args.top)
            line.update(width=width, lane_steps=steps,
                        generation_s=generation_s,
                        images_per_s=len(jobs) / wall_s,
                        launches_per_lane_step=summary["kernel_launches"]
                        / max(1, steps), **summary)
    finally:
        stepper.shutdown()
    print(json.dumps(line))
    return 0


def checker_ab(torch, burst, width: int, n_jobs: int) -> dict:
    """The burst at ``width`` without (A) and with (B) a safety checker in
    the node's standalone checker directory (ViT-L/14, random from seed 0,
    written to a temporary settings root): one warm-up of each (the first B
    loads the checker), then A B B A, each burst's images/s and its jobs'
    ``generation_s``. The checker is switched off by renaming its
    directory; it stays loaded in the module cache, as on a node."""
    import tempfile

    from chiaswarm_tpu_torch.node.registry import model_dir
    from chiaswarm_tpu_torch.workloads import safety

    with tempfile.TemporaryDirectory(prefix="checker-ab-") as root:
        os.environ["SWARM_TPU_ROOT"] = root
        on = model_dir(safety.CHECKER_MODEL)
        off = on.with_name(on.name + ".off")
        write_random_checker(torch, on)
        bursts = []
        for label in ("B", "A", "A", "B", "B", "A"):
            if (label == "B") != on.is_dir():
                (off if label == "B" else on).rename(
                    on if label == "B" else off)
            wall_s, steps, generation_s = burst(width)
            bursts.append({"checker": label == "B", "wall_s": wall_s,
                           "lane_steps": steps,
                           "images_per_s": n_jobs / wall_s,
                           "generation_s": generation_s})
            if label == "B":  # the cached checker the burst ran
                checker = safety.get_checker(None, "cuda")
    timed = bursts[2:]  # after a warm-up of each

    def mean(flag: bool) -> float:
        rates = [b["images_per_s"] for b in timed if b["checker"] == flag]
        return sum(rates) / len(rates)

    return {"checker_bytes": checker.param_bytes(), "bursts": timed,
            "warm_up": bursts[:2],
            "images_per_s_without": mean(False),
            "images_per_s_with": mean(True),
            "with_over_without": mean(True) / mean(False)}


def write_random_checker(torch, directory) -> None:
    """A ``StableDiffusionSafetyChecker`` snapshot at the published widths
    (ViT-L/14; no ``config.json``, so the loader's defaults), random from
    seed 0: the tower with Flax's default initialisers, 17 concept and 3
    special-care embeddings with thresholds of 0.5."""
    import numpy as np

    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.models.clip import ClipVisionEncoder, VisionConfig
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init

    tower = ClipVisionEncoder(VisionConfig())
    flax_default_init(tower, torch.Generator().manual_seed(0))
    state = {("vision_model." + k if k.startswith("vision_model.") else k): v
             for k, v in tower.state_dict().items()}
    rng = np.random.default_rng(0)
    for name, rows in (("concept_embeds", 17), ("special_care_embeds", 3)):
        state[name] = torch.from_numpy(rng.standard_normal(
            (rows, tower.config.projection_dim)).astype(np.float32))
        state[name + "_weights"] = torch.full((rows,), 0.5)
    directory.mkdir(parents=True)
    save_file(state, directory / "model.safetensors", {"format": "pt"})


if __name__ == "__main__":
    sys.exit(main())
