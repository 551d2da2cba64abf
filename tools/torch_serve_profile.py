"""Where the time of one txt2img job goes on the GPU, for the PyTorch port.

Runs SD1.5 (random bf16 weights from a seed, published widths) through the
port's ``DiffusionPipeline`` at 512 px, 20 steps, guidance 7.5: one warm-up
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
over B2.

    python tools/torch_serve_profile.py [--steps 20] [--top 25] [--seq 4]
           [--trace serve_trace.json]

Needs one NVIDIA GPU; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--seq", type=int, default=1,
                        help="ring shards of a seq mesh (1: no mesh)")
    parser.add_argument("--trace", default=None,
                        help="write a Chrome trace of the profiled job here")
    args = parser.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import (
        DiffusionPipeline,
        GenerateRequest,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    mesh = None
    if args.seq > 1:
        n_cards = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(args.seq)]
                   if n_cards >= args.seq
                   else [torch.device("cuda", 0)] * args.seq)
        mesh = build_mesh(MeshSpec({"seq": args.seq}), devices=devices)
    pipe = DiffusionPipeline(Components.random("sd15", seed=0, device="cuda",
                                               dtype=torch.bfloat16),
                             mesh=mesh)
    req = GenerateRequest(prompt="a lighthouse on a cliff at golden hour",
                          negative_prompt="blurry", steps=args.steps,
                          guidance_scale=7.5, height=512, width=512, seed=1)
    pipe(req)  # warm-up: cuDNN heuristics, allocator, kernel library loads
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        pipe(req)
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side ops and runtime calls
        kernels.append({"name": evt.key[:120], "calls": evt.count,
                        "device_ms": evt.device_time_total / 1e3})
    total_ms = sum(k["device_ms"] for k in kernels)
    kernels.sort(key=lambda k: -k["device_ms"])
    for k in kernels:
        k["share"] = k["device_ms"] / total_ms if total_ms else 0.0

    def kernel_line(*symbols: str) -> dict:
        rows = [k for k in kernels if any(s in k["name"] for s in symbols)]
        return {"calls": sum(k["calls"] for k in rows),
                "device_ms": sum(k["device_ms"] for k in rows),
                "share": sum(k["share"] for k in rows)}

    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": args.steps,
        "seq": args.seq,
        "mesh_devices": None if mesh is None
        else [str(d) for d in mesh.device_list],
        "wall_s": wall_s, "event_ms": start.elapsed_time(end),
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
        "top": kernels[: args.top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
