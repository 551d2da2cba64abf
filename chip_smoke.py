#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``chiaswarm_tpu_torch``).

    python3 chip_smoke.py            # on a machine with one NVIDIA GPU

Drives the port's main paths on the card and checks them, phase by phase,
each phase printing one JSON line:

1. probe      — CUDA present; card name and power limit (the raw
                ``nvidia-smi --query-gpu=name,power.limit`` line is printed
                on its own too), torch / CUDA / nvcc versions, the PIL and
                aiohttp versions (the worker's hive client is aiohttp's) and
                whether a ``safetensors`` package is installed (the port
                does not use one).
2. build      — builds every CUDA kernel from the checkout's sources, one
                ``nvcc`` per source, all started together, and the host
                artifact codec; prints each kernel's ptxas lines
                (registers, shared memory, spills) and fails on a spill.
3. kernel     — holds kernel B1 (flash attention) against its plain PyTorch
                version at the UNet's shapes for SD1.5 at 512 px in bf16
                (batch 2 for a solo job, 4 for a lone job's lane of 2 rows,
                16 for a lane of 8 rows) (max abs error 4e-3, two bf16 steps
                at the largest outputs, and relative L2 1e-2), at
                lane_check's fp32 shape and at ragged fp32 shapes (2e-4 and
                1e-4, TF32 off); CUDA-event median times of the kernel, the
                plain version and ``scaled_dot_product_attention`` (the
                library yardstick, which the port never calls), with FLOP
                and byte counts and the bound.
4. ring_kernel — holds kernel B2 (one ring hop with carried state) against
                ``ring_flash_hop_plain`` with a non-trivial incoming state,
                on a strided query shard, at the three shapes of the
                sequence-parallel serve path in bf16 (the two at head dims
                40 and 80 on the tensor-core route, the VAE's 512 on the
                sweep), a ragged bf16 shape off the path and a ragged fp32
                one: the normalised output acc / l to B1's bars, m within
                1e-5 and l within a relative 1e-4. Times, FLOPs and bytes
                with the state counted in and out, the bound, and the host
                time to enqueue one hop on an idle card (no single PyTorch
                call computes one hop with carried state, so B2's library
                time is null).
5. fused_kernel — holds kernel B3 (a whole 4-shard ring in one launch)
                against its plain version ``ring_flash_fused_plain`` at the
                ring attentions of the seq slot's serve paths in bf16 (batch
                2 for a solo job, 16 for a lane of 8 rows, 1 for the VAE)
                and a ragged fp32 one (S != L) to B1's bars, and against
                unsharded ``flash_attention_plain`` and the scan drive over
                B2 on the one-card mesh (whether the two agree bit for bit
                is printed). Times of B3, its plain version, the scan
                drive and ``scaled_dot_product_attention`` on the unsharded
                attention (B3's library yardstick), host enqueue times of B3
                and the scan drive, FLOPs, bytes and the bound.
6. check      — the full-width SD1.5 UNet in float32 on a small latent, once
                with the spatial self-attention through B1 and once through
                the plain path: relative L2 difference within 1e-4, and B1
                launched 5 times (the five 1024-token self-attentions); then
                the same UNet in bf16, the serve dtype, at 64x64 latents
                (4096 tokens), B1's tensor-core route against the plain
                ``xla`` route: within the repo's bf16 parity bar, relative
                L2 3e-2, with 10 B1 launches (5 at 4096 tokens, 5 at 1024).
7. ring_check — the same UNet under a ``seq = 4`` mesh against the
                single-device plain route: relative L2 within 1e-4, with
                exactly 5 B3 launches (the five 1024-token self-attentions)
                and, under the scan drive, 80 B2 launches (x 4 shards x 4
                hops); the full-width VAE decode in float32 at a 64x64
                latent, ring against local: within 1e-4, 1 B3 launch and 16
                B2 launches at head dim 512; then the UNet in bf16 at 64x64
                latents under the scan drive (B2's tensor-core route at both
                of its serve shapes) against the single-device plain route:
                relative L2 3e-2, exactly 160 B2 launches and no other
                kernel.
6b. lane_check — the same UNet in float32 on a 32x32 latent: ONE lane step
                (``DiffusionPipeline.stepper_step``) over 4 rows at different
                ladder positions (step counts 20, 12 and 7, guidance 7.5, 5.0
                and 9.0, one inactive row) against each row's solo step (a
                batch-1 CFG UNet call and ``sampler_step``), for
                DPM-Solver++(2M) and Euler: relative L2 1e-4 on x and the
                multistep history, the inactive row bit for bit, 5 B1
                launches for the lane step, all at the fp32 shape phase 3
                holds.
8. serve      — SD1.5 at its published widths, random bf16 weights from a
                seed, three 512x512 txt2img jobs (20 steps, guidance 7.5,
                default scheduler) through the port's executor
                ``synchronous_do_work`` on the solo path
                (``CHIASWARM_STEPPER=0`` for this phase and the next two).
                Every envelope must carry no error and a 512x512 PNG, and
                B1's launch count over the three jobs must be jobs x steps x
                10 (5 self-attentions at 4096 tokens and 5 at 1024 per UNet
                evaluation, CFG batched).
9. seq_serve  — the same three jobs on a slot whose mesh has ``seq = 4``
                over ``cuda:0`` named four times: every envelope error-free
                with a 512x512 PNG, B3 launched jobs x (steps x 10 + 1)
                times, B1 and B2 never. The uint8 difference from the serve
                phase's image of the same seed is printed as information.
10. seq_serve_scan — the same jobs under ``CHIASWARM_RING_FLASH=scan`` on a
                ``seq = 4`` slot (``cuda:0..3`` when four cards are visible,
                else ``cuda:0`` named four times, and the rotation copies
                stay on the card): B2 launched jobs x (steps x 160 + 16)
                times, B1 and B3 never.
11. lane_serve — the serve jobs again, one after another, through the
                continuous-batching lanes (the default engine): each job a
                lane's (a ``stepper`` stamp, no fallback to the per-job
                path), B1 launched 10 times per lane step; the uint8
                difference from the serve phase's image of each seed is
                printed as information.
12. lane_burst — eight jobs at once through ``synchronous_do_work_batch``
                on a lane pinned at 8 rows (steps 20 and 12, guidance 7.5
                and 5.0 alternating) and a ninth through
                ``synchronous_do_work`` from a second thread once the lane
                has stepped 5 times: it splices in mid-flight when the
                12-step rows retire. Every job on one lane, the ninth
                admitted at a step >= 1, B1 launched 10 times per lane step
                and fewer lane steps than half the jobs' summed steps; job
                11 alone in a lane of the same width within one uint8 level
                of its burst image. Images/s, peak memory, resizes and the
                active and padded row steps are printed.
13. lane_seq_serve — four of the burst jobs through the lanes of the
                one-card ``seq = 4`` slot, pinned at 8 rows: B3 launched 10
                times per lane step and once per decode, B1 and B2 never.
14. solo_pair — seed 1 with ``num_images_per_prompt=2`` on the solo path
                (a CFG batch of 4 rows, a lane of 2's UNet batch) and
                through a lane pinned at 2 rows (the same UNet batch, text
                batch and noise): bit for bit, the lane's per-row step held
                to the solo step on the card. The solo pair's first image is
                printed beside the lone job's lane image and the solo
                one-image render.
14b. checkpoint_serve — SD1.5 from disk: the serve phases' seed-0 weights
                written as a diffusers-layout directory of float32
                safetensors (the published snapshot's dtype; bf16 weights
                round-trip it exactly) through the port's own writer, with
                a synthetic 49,408-entry CLIP vocab and its 48,894 merges
                made here, under ``build/chip_smoke_root`` (the run's
                settings root, removed when the run ends; its bytes and the
                free space are printed), synced and advised out of the page
                cache. The files are read once with ``O_DIRECT`` (the disk's
                read time and rate) and the share of their pages the page
                cache still holds is printed (``mincore``); then a
                ``ModelRegistry`` with no random fallback loads it: load
                seconds split into file read and device copy, the load's
                peak ``max_memory_allocated`` against ``param_bytes`` and
                ``estimate_family_bytes("sd15")``, every parameter
                ``torch.equal`` to its source. A second registry loads it
                again while serve's seed-1 job steps in the source model's
                lane on another thread: every parameter equal to its source,
                the lane's image bit for bit lane_serve's, the lane stepping
                during the load. Seeds 1-3 one after another in the lanes,
                each image bit for bit the source modules' with the loaded
                tokenizer swapped in (the same lane composition), B1 = 10 x
                lane steps; each job's spans (text encode, lane wait,
                decode, PNG) beside lane_serve's.
14c. residency_churn — two catalog names over that checkpoint (the second a
                directory of links) under a ledger that holds one model
                (1.5x the measured footprint): A in a lane; B's load evicts
                A and retires A's lane at drain, ``memory_allocated`` back
                within one model (plus 5%) of the level before A, the
                ledger's peak of resident + reserved bytes at most budget +
                one model; A's reload renders its first image bit for bit.
                A budget below one model degrades A to load-per-job (no
                lane, ``residency: per_job``, bit for bit the solo path's
                image); a hard limit below the footprint gives a non-fatal
                ``model_unavailable`` envelope. Prints the evict + load and
                reload seconds and the ledger's ``snapshot()``.
15. worker_serve — the port's hive worker (``node/worker.py``:
                ``Worker.run()``) against a hive served from a thread of
                this script (standard-library ``http.server``: ``/api/work``,
                ``/api/results``, ``/api/models``), on the lanes: serve's
                seed-1 job alone in a fresh lane (bit for bit lane_serve's
                image, a stepper stamp), then twice more in the warm lane,
                each after the same job through ``synchronous_do_work``
                (the worker's cost over the executor's, image for image);
                lane_burst's nine jobs at 8 rows pinned (seeds 11-18 from
                the first poll that returns work, seed 19 from a later one
                once the lane has stepped 5 times), each bit for bit the
                image of a replay that admits the same jobs into the same
                lane slots at the same lane steps (the difference from
                lane_burst's image of each seed is printed: lane_burst fills
                other slots, and cuDNN's convolutions are not
                batch-position invariant, ``tools/torch_batch_position.py``);
                one 503 on an upload (one retry, the result arrives once),
                checkpoint_serve's seed-1 job through a worker whose
                registry loads the checkpoint from disk (bit for bit
                checkpoint_serve's image), then
                ``python -m chiaswarm_tpu_torch.node.worker`` as a
                child process: its registry has no checkpoint, so it
                uploads a non-fatal ``model_unavailable`` envelope, and on
                SIGTERM it drains and exits with 0. B1 = 10 x lane steps.
                Prints each job's seconds (poll receipt to settled upload,
                from the worker's traces and ``chiaswarm_job_seconds``) with
                its spans (format, text encode, lane wait, decode, PNG and
                base64, upload), the worker's host seconds (job seconds
                minus ``generation_s``), the burst's images/s from the first
                poll that returned work to the last upload beside
                lane_burst's, lane steps and occupancy.
16. shapes_held — every shape at which a phase from 8 on launched a kernel
                is one its kernel phase (3-5) held against the plain
                version; each phase's launches by shape.
17. kernels   — one line ``{"kernels": [...]}``: each port kernel, the TPU
                kernel it replaces, its designs (``wgmma+cp.async`` for the
                tensor-core route of B1, B2 and B3 — bf16 and fp16 at head
                dims up to 160 — ``sweep`` for the CUDA-core sweep of fp32
                and head dim 512), its launches on its solo serve phase
                (by shape too), and its numbers from its kernel phase
                averaged over those launches (per-shape numbers, each with
                its design and its factor against the library call, under
                ``shapes``); B1 also under ``lane_serve``, ``lane_burst``,
                ``checkpoint_serve``, ``residency_churn`` and
                ``worker_serve`` and B3 under ``lane_seq_serve``, with
                their launches there and their numbers over those
                launches.

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises,
so the script exits non-zero without that line — also when CUDA is absent
or the package is not next to this file.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SERVE_JOBS = 3
SERVE_STEPS = 20
B1_LAUNCHES_PER_UNET_EVAL = 10
RING_SHARDS = 4
# ten self-attentions per UNet eval ring (five at 4096 tokens, five at
# 1024), each 4 shards x 4 hops; the VAE mid block rings once per job
B2_LAUNCHES_PER_UNET_EVAL = 10 * RING_SHARDS * RING_SHARDS
B2_LAUNCHES_PER_DECODE = RING_SHARDS * RING_SHARDS
# B3 runs each of those ring attentions in one launch
B3_LAUNCHES_PER_UNET_EVAL = 10
B3_LAUNCHES_PER_DECODE = 1


def design(dtype_name: str, d: int) -> str:
    """The route a launch of B1, B2 or B3 takes: bf16 and fp16 at head dims
    up to 160 run on the tensor cores (wgmma, K/V by cp.async); fp32 and the
    VAE's head dim 512 run the CUDA-core sweep."""
    tensor_cores = dtype_name in ("bfloat16", "float16") and d <= 160
    return "wgmma+cp.async" if tensor_cores else "sweep"


def vs_library(ms: float, library_ms: float | None) -> float | None:
    """The kernel's time as a multiple of the library call's."""
    return None if library_ms is None else ms / library_ms


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def probe():
    if not (ROOT / "chiaswarm_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo: "
                         "chiaswarm_tpu_torch/ is not beside it")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no GPU to run on")
    from chiaswarm_tpu_torch.ops.kernels import nvcc_path

    smi = nvidia_smi_line()
    print(smi, flush=True)
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    try:
        import PIL

        pil = PIL.__version__
    except ImportError:
        pil = None
    try:  # the worker's hive client (node/hive.py)
        import aiohttp

        aiohttp_version = aiohttp.__version__
    except ImportError:
        aiohttp_version = None
    try:  # the port reads and writes safetensors without this package
        import safetensors

        safetensors_version = safetensors.__version__
    except ImportError:
        safetensors_version = None
    emit("probe", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1],
         python=sys.version.split()[0], pil=pil, aiohttp=aiohttp_version,
         safetensors=safetensors_version)
    return torch


def build() -> None:
    from chiaswarm_tpu_torch import native
    from chiaswarm_tpu_torch.ops.kernels import KERNELS, build_all

    t0 = time.perf_counter()
    libs = build_all()
    kernel_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    if native.CODEC.load() is None:
        raise RuntimeError("the artifact codec did not build (g++ and zlib)")
    codec_s = time.perf_counter() - t1
    ptxas = {name: [line.split("ptxas info    : ")[-1].strip()
                    for line in k.build_log.splitlines()
                    if "Used" in line or "spill" in line]
             for name, k in KERNELS.items()}
    spills = {name: sum(int(n) for line in k.build_log.splitlines()
                        for n in re.findall(r"(\d+) bytes spill", line))
              for name, k in KERNELS.items()}
    emit("build", kernels={n: str(p.relative_to(ROOT)) for n, p in libs.items()},
         kernel_build_s=round(kernel_s, 3),
         nvcc_s={name: round(k.build_s, 3) for name, k in KERNELS.items()},
         codec_build_s=round(codec_s, 3),
         spill_bytes=spills, ptxas=ptxas)
    if any(spills.values()):
        raise AssertionError(f"a kernel spills registers: {spills}")


# the card sleeps this long before each timed call (about 1 ms at the
# H100's clock), so the host has enqueued the call before the card reaches
# it and the events time the device alone, not the host's launch cost
SLEEP_CYCLES = 2_000_000


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in ms, after ``warmup`` calls, each
    timed call queued behind a device sleep of :data:`SLEEP_CYCLES`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median host time in ms to enqueue ``fn`` on an idle card: the Python
    and launch cost alone, the device's own time excluded."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flops: int, nbytes: int, dtype) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of ``dtype`` and the bytes over the memory rate."""
    op_ms = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes"}


def attention_work(b: int, l: int, s: int, h: int, d: int, dtype) -> dict:
    """FLOPs and bytes one forward attention needs: 2·L·S·D multiply-adds
    for QK^T and again for PV per (batch, head); each input read once and
    the output written once."""
    elem = dtype.itemsize
    return bound(4 * b * h * l * s * d,
                 (2 * b * l * h * d + 2 * b * s * h * d) * elem, dtype)


# With randn q/k/v the outputs have a standard deviation of about
# sqrt(e / S): 0.026 at S = 4096 and 0.05 at S = 1024, peaks near 0.25. Both
# sides round fp32 sums to bf16, and the tensor-core route rounds p to bf16
# for P·V (about 2e-3 relative L2 against the fp32 p of the plain version,
# tests/test_torch_flash.py), so they differ by a step or two (2e-3 at
# 0.25); a kernel off by a few percent everywhere (a wrong scale, a skipped
# KV tile) fails the relative L2 bar.
KERNEL_SHAPES = [
    # (B, L, S, H, D, dtype, max abs error, relative L2, the phases that
    # launch it: the solo serve path (one job, CFG doubles the batch), a lone
    # job's lane of 2 rows in lane_serve (its adaptive lane may narrow to
    # one row, batch 2), a lane of 8 rows in lane_burst, and lane_check's
    # fp32 lane step over 4 rows at a 32x32 latent)
    (2, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("serve",)),
    (2, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("serve",)),
    (4, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("lane_serve",)),
    (4, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("lane_serve",)),
    (16, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("lane_burst",)),
    (16, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("lane_burst",)),
    (8, 1024, 1024, 8, 40, "float32", 2e-4, 1e-4, ("lane_check",)),
    (1, 1000, 1000, 2, 64, "float32", 2e-4, 1e-4, ()),
    (2, 300, 300, 2, 160, "float32", 2e-4, 1e-4, ()),
]


def _held(name: str, shape, out, ref, tol: float, rel_tol: float) -> dict:
    """Hold ``out`` against its plain version ``ref``; raises past a bar."""
    diff = out.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    if not (err <= tol and rel <= rel_tol):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}: max abs error {err} (bar {tol}), "
                             f"relative L2 {rel} (bar {rel_tol})")
    return {"max_abs_err": err, "tolerance": tol, "rel_l2": rel,
            "rel_l2_tolerance": rel_tol,
            "mean_abs_out": ref.float().abs().mean().item()}


def kernel_phase(torch) -> list[dict]:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernel_settings",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for b, l, s, h, d, dtype_name, tol, rel_tol, paths in KERNEL_SHAPES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, l, h, d), generator=gen).to("cuda", dtype)
        k = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
        v = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        shape = [b, l, s, h, d]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "shape": shape, "dtype": dtype_name,
            "design": design(dtype_name, d),
            **_held("B1", shape, out, flash_attention_plain(q, k, v), tol,
                    rel_tol),
            "served": bool(paths), "paths": list(paths),
            "ms": time_ms(torch, lambda: flash_attention(q, k, v)),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(q, k, v)),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **attention_work(b, l, s, h, d, dtype),
        }
        row["vs_library"] = vs_library(row["ms"], row["library_ms"])
        emit("kernel", name="flash_attention", **row)
        rows.append(row)
    return rows


def ring_hop_work(b: int, l: int, s: int, h: int, d: int, dtype) -> dict:
    """FLOPs and bytes one ring hop needs: the attention's 4·B·H·L·S·D,
    q, k and v read once in their type, and the float32 state m, l (B, H, L)
    and acc (B, L, H, D) read once and written once."""
    elem = dtype.itemsize
    return bound(4 * b * h * l * s * d,
                 (b * l * h * d + 2 * b * s * h * d) * elem
                 + 2 * (2 * b * h * l + b * l * h * d) * 4, dtype)


def ring_mesh_devices(torch) -> list:
    """The devices of the seq = 4 mesh: four cards when four are visible,
    else the first card named four times."""
    if torch.cuda.device_count() >= RING_SHARDS:
        return [torch.device("cuda", i) for i in range(RING_SHARDS)]
    return [torch.device("cuda", 0)] * RING_SHARDS


def ring_mesh(torch, devices=None):
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec({"seq": RING_SHARDS}),
                      devices=devices or ring_mesh_devices(torch))


def one_card_devices(torch) -> list:
    """The mesh B3 serves: the first card named once per shard."""
    return [torch.device("cuda", 0)] * RING_SHARDS


@contextlib.contextmanager
def env(**values: str):
    """The environment variables ``values`` set for the block, then
    restored."""
    old = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


# B2 shapes: the query shard, a K/V shard, and the launches per job of the
# sequence-parallel serve path (20 steps x 5 self-attentions x 16 per level,
# 16 for the VAE mid block)
RING_SHAPES = [
    # (B, L, S, H, D, dtype, max abs error, relative L2, launches per job)
    (2, 1024, 1024, 8, 40, "bfloat16", 4e-3, 1e-2, 1600),
    (2, 256, 256, 8, 80, "bfloat16", 4e-3, 1e-2, 1600),
    (1, 1024, 1024, 1, 512, "bfloat16", 4e-3, 1e-2, 16),
    (2, 300, 170, 2, 64, "bfloat16", 4e-3, 1e-2, 0),  # ragged, strided q
    (1, 300, 170, 2, 64, "float32", 2e-4, 1e-4, 0),
]


def ring_kernel_phase(torch) -> list[dict]:
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        ring_flash_hop,
        ring_flash_hop_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(2)
    rows = []
    for b, l, s, h, d, dtype_name, tol, rel_tol, per_job in RING_SHAPES:
        dtype = getattr(torch, dtype_name)

        def randn(*shape):
            return torch.randn(shape, generator=gen).to("cuda", dtype)

        # query shard 1 of 4 of a (B, 4L, H, D) tensor, as the ring hands
        # it to B2 (strided across the batch when B > 1)
        q = randn(b, RING_SHARDS * l, h, d)[:, l:2 * l]
        k0, v0, k, v = (randn(b, s, h, d) for _ in range(4))
        scale = d ** -0.5
        state = ring_flash_hop_plain(
            q, k0, v0, torch.full((b, h, l), -1e30, device="cuda"),
            torch.zeros((b, h, l), device="cuda"),
            torch.zeros((b, l, h, d), device="cuda"), scale=scale)
        m, lsum, acc = (t.clone() for t in state)
        ring_flash_hop(q, k, v, m, lsum, acc)
        torch.cuda.synchronize()
        ref_m, ref_l, ref_acc = ring_flash_hop_plain(q, k, v, *state,
                                                     scale=scale)
        shape = [b, l, s, h, d]
        m_err = (m - ref_m).abs().max().item()
        l_err = ((lsum - ref_l).abs() / ref_l).max().item()
        if not (m_err <= 1e-5 and l_err <= 1e-4):
            raise AssertionError(f"B2 state disagrees with its plain version "
                                 f"at {shape}: m max abs error {m_err} (bar "
                                 f"1e-5), l max relative error {l_err} (bar "
                                 f"1e-4)")
        row = {
            "shape": shape, "dtype": dtype_name,
            "design": design(dtype_name, d),
            "strided_q": not q.is_contiguous(),
            "launches_per_job": per_job, "served": per_job > 0,
            **_held("B2", shape, acc / lsum.transpose(1, 2)[..., None],
                    ref_acc / ref_l.transpose(1, 2)[..., None],
                    tol, rel_tol),
            "m_max_abs_err": m_err, "l_max_rel_err": l_err,
            "ms": time_ms(torch, lambda: ring_flash_hop(q, k, v, m, lsum,
                                                        acc)),
            "host_ms": host_ms(torch, lambda: ring_flash_hop(q, k, v, m, lsum,
                                                             acc)),
            "plain_ms": time_ms(torch, lambda: ring_flash_hop_plain(
                q, k, v, *state, scale=scale)),
            "library_ms": None,
            **ring_hop_work(b, l, s, h, d, dtype),
        }
        if not torch.isfinite(acc).all():
            raise AssertionError(f"B2 state went non-finite at {shape}")
        emit("ring_kernel", name="ring_flash_hop", **row)
        rows.append(row)

    return rows


# B3 shapes: the whole ring attention (q = k/v length) of a solo job on the
# seq slot (5 self-attentions per UNet level a step), of a lane of 8 rows
# there (16 UNet rows with CFG), and of the VAE mid block (one a decode)
FUSED_SHAPES = [
    # (B, L, S, H, D, dtype, max abs error, relative L2, the phases that
    # launch it)
    (2, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("seq_serve",)),
    (2, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("seq_serve",)),
    (16, 4096, 4096, 8, 40, "bfloat16", 4e-3, 1e-2, ("lane_seq_serve",)),
    (16, 1024, 1024, 8, 80, "bfloat16", 4e-3, 1e-2, ("lane_seq_serve",)),
    (1, 4096, 4096, 1, 512, "bfloat16", 4e-3, 1e-2,
     ("seq_serve", "lane_seq_serve")),
    (1, 600, 680, 2, 64, "float32", 2e-4, 1e-4, ()),
]


def fused_kernel_phase(torch) -> list[dict]:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import flash_attention_plain
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        ring_flash_attention,
        ring_flash_fused,
        ring_flash_fused_plain,
    )

    mesh = ring_mesh(torch, one_card_devices(torch))
    gen = torch.Generator(device="cpu").manual_seed(4)
    rows = []
    for b, l, s, h, d, dtype_name, tol, rel_tol, paths in FUSED_SHAPES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, l, h, d), generator=gen).to("cuda", dtype)
        k, v = (torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
                for _ in range(2))
        scale = d ** -0.5
        out = ring_flash_fused(q, k, v, shards=RING_SHARDS)
        with env(CHIASWARM_RING_FLASH="scan"):
            scan = ring_flash_attention(q, k, v, mesh=mesh)
        torch.cuda.synchronize()
        shape = [b, l, s, h, d]
        unsharded = flash_attention_plain(q, k, v)
        _held("B3 against unsharded flash", shape, out, unsharded, tol,
              rel_tol)
        _held("B3 against the B2 scan drive", shape, out, scan, tol, rel_tol)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def scan_ring():
            with env(CHIASWARM_RING_FLASH="scan"):
                ring_flash_attention(q, k, v, mesh=mesh)

        row = {
            "shape": shape, "dtype": dtype_name, "shards": RING_SHARDS,
            "design": design(dtype_name, d),
            "served": bool(paths), "paths": list(paths),
            **_held("B3", shape, out, ring_flash_fused_plain(
                q, k, v, shards=RING_SHARDS, scale=scale), tol, rel_tol),
            "max_abs_err_vs_unsharded": (out.float() - unsharded.float())
            .abs().max().item(),
            "max_abs_err_vs_scan": (out.float() - scan.float())
            .abs().max().item(),
            "bit_equal_vs_scan": bool(torch.equal(out, scan)),
            "ms": time_ms(torch, lambda: ring_flash_fused(
                q, k, v, shards=RING_SHARDS)),
            "host_ms": host_ms(torch, lambda: ring_flash_fused(
                q, k, v, shards=RING_SHARDS)),
            "plain_ms": time_ms(torch, lambda: ring_flash_fused_plain(
                q, k, v, shards=RING_SHARDS, scale=scale)),
            "scan_ms": time_ms(torch, scan_ring),
            "scan_host_ms": host_ms(torch, scan_ring),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **attention_work(b, l, s, h, d, dtype),
        }
        row["vs_library"] = vs_library(row["ms"], row["library_ms"])
        if not torch.isfinite(out).all():
            raise AssertionError(f"B3 output went non-finite at {shape}")
        emit("fused_kernel", name="ring_flash_fused", **row)
        rows.append(row)
    return rows


def check_phase(torch) -> None:
    """Full-width SD1.5 UNet, float32, 32x32 latents (1024 tokens at the
    first level, so B1 runs there): kernel route against the plain route.
    Both runs share every other op; only float32 summation order differs.
    Then the same weights in bf16 at 64x64 latents (B1's tensor-core route
    at both of its serve shapes) against the plain route, within the repo's
    bf16 parity bar."""
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL
    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    fam = FAMILIES["sd15"]
    with torch.device("meta"):
        unet = UNet(fam.unet)
    unet = unet.to_empty(device="cuda").eval().requires_grad_(False)
    flax_default_init(unet, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((2, 4, 32, 32), generator=gen).cuda()
    ctx = torch.randn((2, 77, 768), generator=gen).cuda()
    t = torch.tensor([999.0, 10.5], device="cuda")
    with torch.inference_mode():
        set_attn_impl(unet, "auto")
        before = KERNEL.launches
        out_kernel = unet(x, t, ctx)
        launches = KERNEL.launches - before
        set_attn_impl(unet, "xla")
        out_plain = unet(x, t, ctx)
    torch.cuda.synchronize()
    rel = ((out_kernel - out_plain).norm() / out_plain.norm()).item()
    finite = bool(torch.isfinite(out_kernel).all())
    emit("check", model="sd15 unet fp32", latent=[2, 4, 32, 32],
         b1_launches=launches, rel_l2=rel, finite=finite, tolerance=1e-4)
    # 32x32 latents: 1024 tokens at the first level only, where 2 down and
    # 3 up transformer blocks run their self-attention through B1
    if launches != 5 or not finite or not rel <= 1e-4:
        raise AssertionError(f"UNet kernel route check failed: launches "
                             f"{launches} (want 5), finite {finite}, "
                             f"relative L2 {rel}")
    del out_kernel, out_plain

    # bf16, the serve dtype, at 64x64 latents: B1's tensor-core route (p
    # rounded to bf16 for P·V) against the plain route's fp32 logits
    cast_module(unet, torch.bfloat16)  # as the serve path: norms stay fp32
    x = torch.randn((2, 4, 64, 64), generator=gen).cuda().to(torch.bfloat16)
    ctx = ctx.to(torch.bfloat16)
    with torch.inference_mode():
        set_attn_impl(unet, "auto")
        before = KERNEL.launches
        out_kernel = unet(x, t, ctx).float()
        launches = KERNEL.launches - before
        set_attn_impl(unet, "xla")
        out_plain = unet(x, t, ctx).float()
    torch.cuda.synchronize()
    rel = ((out_kernel - out_plain).norm() / out_plain.norm()).item()
    finite = bool(torch.isfinite(out_kernel).all())
    emit("check", model="sd15 unet bf16", latent=[2, 4, 64, 64],
         b1_launches=launches, rel_l2=rel, finite=finite, tolerance=3e-2,
         design=design("bfloat16", 40))
    # 64x64 latents: 4096 tokens at the first level and 1024 at the second,
    # five self-attentions each through B1
    if launches != 10 or not finite or not rel <= 3e-2:
        raise AssertionError(f"bf16 UNet kernel route check failed: launches "
                             f"{launches} (want 10), finite {finite}, "
                             f"relative L2 {rel} (bar 3e-2)")
    del unet
    torch.cuda.empty_cache()


def ring_check_phase(torch) -> None:
    """Full-width SD1.5 UNet (32x32 latents) and VAE decode (64x64 latent)
    in float32, under the seq = 4 mesh against the single-device plain
    route, once through B3 (the shards share cuda:0) and once through the
    scan drive over B2; only float32 summation order differs."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.models.vae import AutoencoderKL
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )
    from chiaswarm_tpu_torch.ops.ring_flash_attention import KERNEL as B2
    from chiaswarm_tpu_torch.parallel.context import sequence_parallel
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    fam = FAMILIES["sd15"]
    drives = (("fused", "", B3, one_card_devices(torch)),
              ("scan", "scan", B2, ring_mesh_devices(torch)))
    gen = torch.Generator(device="cpu").manual_seed(3)
    results = {}
    # five 1024-token self-attentions in the UNet, one in the VAE mid block
    for name, ctor, cfg, rings in (("unet", UNet, fam.unet, 5),
                                   ("vae", AutoencoderKL, fam.vae, 1)):
        with torch.device("meta"):
            module = ctor(cfg)
        module = module.to_empty(device="cuda").eval().requires_grad_(False)
        flax_default_init(module, torch.Generator(device="cuda").manual_seed(0))
        if name == "unet":
            args = (torch.randn((2, 4, 32, 32), generator=gen).cuda(),
                    torch.tensor([999.0, 10.5], device="cuda"),
                    torch.randn((2, 77, 768), generator=gen).cuda())
            fn = module
        else:
            args = (torch.randn((1, 4, 64, 64), generator=gen).cuda(),)
            fn = module.decode
        with torch.inference_mode():
            if name == "unet":
                set_attn_impl(module, "xla")
            out_local = fn(*args)
            if name == "unet":
                set_attn_impl(module, "auto")
            for drive, mode, kernel, devices in drives:
                mesh = ring_mesh(torch, devices)
                want = rings * (1 if kernel is B3 else RING_SHARDS ** 2)
                kernels.reset_launches()
                with env(CHIASWARM_RING_FLASH=mode), sequence_parallel(mesh):
                    out_ring = fn(*args)
                launches = {n: k.launches for n, k in kernels.KERNELS.items()}
                torch.cuda.synchronize()
                rel = ((out_ring - out_local).norm() / out_local.norm()).item()
                finite = bool(torch.isfinite(out_ring).all())
                results[f"{name}_{drive}"] = {
                    "shape": list(args[0].shape), "launches": launches,
                    "rel_l2": rel, "finite": finite,
                    "mesh_devices": [str(dv) for dv in mesh.device_list]}
                if (launches[kernel.name] != want
                        or sum(launches.values()) != want
                        or not finite or not rel <= 1e-4):
                    raise AssertionError(
                        f"ring check of the sd15 {name} ({drive}) failed: "
                        f"launches {launches} (want {want} of {kernel.name} "
                        f"and no other), finite {finite}, relative L2 {rel} "
                        "(bar 1e-4)")
                del out_ring
        if name == "unet":
            results["unet_bf16_scan"] = ring_check_unet_bf16(torch, module,
                                                             gen)
        del module, out_local
        torch.cuda.empty_cache()
    emit("ring_check", model="sd15 unet + vae fp32, unet bf16",
         tolerance=1e-4, bf16_tolerance=3e-2, **results)


def ring_check_unet_bf16(torch, unet, gen) -> dict:
    """The UNet in bf16, the serve dtype, at 64x64 latents (4096 tokens at
    the first level, 1024 at the second) under the scan drive on the seq = 4
    mesh: B2's tensor-core route at both of its serve shapes, against the
    single-device plain route, within the repo's bf16 parity bar."""
    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import KERNEL as B2
    from chiaswarm_tpu_torch.parallel.context import sequence_parallel
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    cast_module(unet, torch.bfloat16)  # as the serve path: norms stay fp32
    x = torch.randn((2, 4, 64, 64), generator=gen).cuda().to(torch.bfloat16)
    ctx = torch.randn((2, 77, 768), generator=gen).cuda().to(torch.bfloat16)
    t = torch.tensor([999.0, 10.5], device="cuda")
    mesh = ring_mesh(torch)
    with torch.inference_mode():
        set_attn_impl(unet, "xla")
        out_local = unet(x, t, ctx).float()
        set_attn_impl(unet, "auto")
        kernels.reset_launches()
        with env(CHIASWARM_RING_FLASH="scan"), sequence_parallel(mesh):
            out_ring = unet(x, t, ctx).float()
        launches = {n: k.launches for n, k in kernels.KERNELS.items()}
    torch.cuda.synchronize()
    rel = ((out_ring - out_local).norm() / out_local.norm()).item()
    finite = bool(torch.isfinite(out_ring).all())
    want = B2_LAUNCHES_PER_UNET_EVAL
    if (launches[B2.name] != want or sum(launches.values()) != want
            or not finite or not rel <= 3e-2):
        raise AssertionError(
            f"bf16 ring check of the sd15 unet (scan) failed: launches "
            f"{launches} (want {want} of {B2.name} and no other), finite "
            f"{finite}, relative L2 {rel} (bar 3e-2)")
    return {"shape": list(x.shape), "launches": launches, "rel_l2": rel,
            "finite": finite, "design": design("bfloat16", 40),
            "mesh_devices": [str(dv) for dv in mesh.device_list]}


def png_hw(blob_b64: str) -> tuple[int, int]:
    blob = base64.b64decode(blob_b64)
    if blob[:8] != b"\x89PNG\r\n\x1a\n" or blob[12:16] != b"IHDR":
        raise AssertionError("artifact blob is not a PNG")
    width, height = struct.unpack(">II", blob[16:24])
    return height, width


JOBS = [{"id": f"smoke-sd15-{seed}", "model_name": "sd15",
         "prompt": "a lighthouse on a cliff at golden hour, oil painting",
         "negative_prompt": "blurry, low quality" if seed == 2 else "",
         "num_inference_steps": SERVE_STEPS, "guidance_scale": 7.5,
         "height": 512, "width": 512, "seed": seed,
         "content_type": "image/png"} for seed in (1, 2, 3)][:SERVE_JOBS]


def check_envelope(phase: str, job: dict, result: dict, lanes: bool) -> str:
    """Raises on an error envelope, a PNG that is not 512x512, or (with
    ``lanes``) a job a lane did not serve. Returns the PNG blob."""
    cfg = result["pipeline_config"]
    if "error" in cfg:
        raise AssertionError(f"{phase} job {job['id']} failed: "
                             f"{cfg['error']}")
    if lanes and "stepper" not in cfg:
        raise AssertionError(f"{phase} job {job['id']} fell back to the "
                             "per-job path: no stepper stamp")
    if not lanes and "stepper" in cfg:
        raise AssertionError(f"{phase} job {job['id']} rode a lane on the "
                             "solo path")
    blob = result["artifacts"]["primary"]["blob"]
    hw = png_hw(blob)
    if hw != (512, 512):
        raise AssertionError(f"{phase} job {job['id']} PNG is {hw}, "
                             "not 512x512")
    return blob


def run_jobs(torch, phase: str, slot, registry, lanes: bool = False,
             jobs=None, spans: list | None = None) -> tuple[list, dict]:
    """The serve jobs (or ``jobs``) through ``synchronous_do_work`` on
    ``slot``, one after another, with every launch count set to 0 just
    before, each under a trace of its own (its executor spans: format, text
    encode, lane wait or steps, decode, PNG and base64; appended to
    ``spans``). Returns the job seconds and each job's PNG blob by seed;
    raises on an error envelope, a wrong PNG, or a job on the wrong path
    (``lanes``)."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.obs import trace as obs_trace
    from chiaswarm_tpu_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    seconds, blobs = [], {}
    for job in JOBS if jobs is None else jobs:
        job = dict(job)
        trace = obs_trace.JobTrace(id=job["id"])
        obs_trace.attach(job, trace)
        trace.phase("execute")
        t1 = time.perf_counter()
        result = synchronous_do_work(job, slot, registry)
        seconds.append(time.perf_counter() - t1)
        trace.finish(obs_trace.TraceRing())
        rows = span_rows(trace)
        if spans is not None:
            spans.append(rows)
        cfg = result["pipeline_config"]
        blobs[job["seed"]] = check_envelope(phase, job, result, lanes)
        emit(f"{phase}_job", id=job["id"], seed=cfg["seed"],
             seconds=seconds[-1], generation_s=cfg["generation_s"],
             scheduler=cfg["scheduler"], png_hw=[512, 512],
             mesh_shape=cfg["slot"]["mesh_shape"],
             stepper=cfg.get("stepper"), spans=rows)
    return seconds, blobs


def load_pipeline(torch, phase: str, registry, mesh=None) -> None:
    t0 = time.perf_counter()
    # Components.random(sd15, seed 0, the slot's lead card, the family's bf16)
    pipe = registry.pipeline("sd15", mesh=mesh)
    torch.cuda.synchronize()
    emit(f"{phase}_load", model="sd15", load_s=round(time.perf_counter() - t0, 3),
         param_bytes=pipe.c.param_bytes(), dtype=str(pipe.c.dtype))


def launched() -> dict:
    """Every kernel's launches since the counts were last set to 0, in all
    and by shape (B, L, S, H, D, dtype)."""
    from chiaswarm_tpu_torch.ops import kernels

    return {name: {"launches": k.launches, "shapes": dict(k.shapes)}
            for name, k in kernels.KERNELS.items()}


def shape_key(row: dict) -> tuple:
    return (*row["shape"], row["dtype"])


def check_held(runs: dict, tables: dict) -> None:
    """Every shape at which a served phase launched a kernel is one that
    its kernel phase held against the plain version; prints each phase's
    launches by shape."""
    for phase, run in runs.items():
        for name, rows in tables.items():
            held = {shape_key(r) for r in rows}
            unheld = sorted(k for k in run[name]["shapes"] if k not in held)
            if unheld:
                raise AssertionError(
                    f"{phase} launched {name} at {unheld}: no kernel phase "
                    "held it against its plain version at those shapes")
    emit("shapes_held", **{phase: {
        name: [[*key, n] for key, n in run[name]["shapes"].items()]
        for name in tables} for phase, run in runs.items()})


def serve_phase(torch, registry, slot) -> tuple[dict, dict]:
    from chiaswarm_tpu_torch.ops import kernels

    load_pipeline(torch, "serve", registry)
    seconds, blobs = run_jobs(torch, "serve", slot, registry)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    want = len(JOBS) * SERVE_STEPS * B1_LAUNCHES_PER_UNET_EVAL
    emit("serve", jobs=len(JOBS), steps=SERVE_STEPS, job_seconds=seconds,
         images_per_s=len(JOBS) / sum(seconds),
         images_per_s_after_first=(len(JOBS) - 1) / sum(seconds[1:]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_flash_launches=want)
    if launches["flash_attention"] != want:
        raise AssertionError(f"B1 launched {launches['flash_attention']} "
                             f"times in the serve phase, expected {want}")
    return launched(), blobs


def decode_png(blob_b64: str):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(blob_b64)))
                      .convert("RGB")).astype("int16")


def seq_serve_phase(torch, phase: str, solo_blobs: dict) -> dict:
    """The serve jobs on a seq = 4 slot: ``seq_serve`` through B3 on the
    one-card mesh, ``seq_serve_scan`` through the scan drive over B2."""
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.mesh import MeshSpec
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )
    from chiaswarm_tpu_torch.ops.ring_flash_attention import KERNEL as B2

    if phase == "seq_serve":
        mode, kernel, devices = "", B3, one_card_devices(torch)
        per_eval, per_decode = B3_LAUNCHES_PER_UNET_EVAL, B3_LAUNCHES_PER_DECODE
    else:
        mode, kernel, devices = "scan", B2, ring_mesh_devices(torch)
        per_eval, per_decode = B2_LAUNCHES_PER_UNET_EVAL, B2_LAUNCHES_PER_DECODE
    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(mesh_spec=MeshSpec({"seq": RING_SHARDS}),
                    devices=devices).slots[0]
    with env(CHIASWARM_RING_FLASH=mode):
        load_pipeline(torch, phase, registry, mesh=slot.mesh)
        seconds, blobs = run_jobs(torch, phase, slot, registry)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    want = len(JOBS) * (SERVE_STEPS * per_eval + per_decode)
    diffs = {}
    for seed, blob in blobs.items():
        diffs[seed] = int(abs(decode_png(blob)
                              - decode_png(solo_blobs[seed])).max())
    desc = slot.descriptor()
    emit(phase, jobs=len(JOBS), steps=SERVE_STEPS,
         ring_flash_mode=mode or "default", kernel=kernel.name,
         mesh_shape=desc["mesh_shape"], mesh_devices=desc["mesh_devices"],
         repeated_device=desc["repeated_device"],
         job_seconds=seconds, images_per_s=len(JOBS) / sum(seconds),
         images_per_s_after_first=(len(JOBS) - 1) / sum(seconds[1:]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_ring_launches=want,
         max_uint8_diff_vs_serve=diffs)
    if launches[kernel.name] != want or sum(launches.values()) != want:
        raise AssertionError(f"{phase} launched {launches}, expected "
                             f"{want} of {kernel.name} and no other")
    return launched()


# ---------------------------------------------------------------------------
# the continuous-batching lanes (serving/stepper.py), the default engine


def lane_check_phase(torch) -> None:
    """The full-width SD1.5 UNet in float32 (TF32 off) on a 32x32 latent:
    ONE lane step over 4 rows (step counts 20, 12 and 7 at different ladder
    positions, guidance 7.5, 5.0 and 9.0, one inactive row) against each
    row's solo step (a batch-1 CFG UNet call and ``sampler_step``), for
    DPM-Solver++(2M) and Euler. Relative L2 1e-4 on x and the multistep
    history, the inactive row bit for bit, and the lane step itself
    launching B1 5 times (the 1024-token level, whatever the width)."""
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from chiaswarm_tpu_torch.schedulers import (
        SamplerState,
        make_sampling_schedule,
        resolve,
        sampler_step,
        scale_model_input,
    )

    pipe = DiffusionPipeline(Components.random("sd15", seed=0, device="cuda",
                                               dtype=torch.float32))
    steps, idx = (20, 12, 7, 20), (0, 5, 6, 3)
    guidance = torch.tensor([7.5, 5.0, 9.0, 7.5])
    active = torch.tensor([True, True, True, False])
    gen = torch.Generator(device="cpu").manual_seed(6)
    x, old = (torch.randn((4, 4, 32, 32), generator=gen).cuda()
              for _ in range(2))
    ctx_u, ctx_c = (torch.randn((4, 77, 768), generator=gen).cuda()
                    for _ in range(2))
    results = {}
    for name in (None, "EulerDiscreteScheduler"):
        sampler = resolve(name)
        scheds = [make_sampling_schedule(pipe.noise_schedule, n, sampler)
                  for n in steps]
        sig = torch.zeros((4, 33))
        ts = torch.zeros((4, 32))
        for b, sched in enumerate(scheds):
            sig[b, :steps[b] + 1] = sched.sigmas
            ts[b, :steps[b]] = sched.timesteps
        before = KERNEL.launches
        shapes_before = dict(KERNEL.shapes)
        x_l, idx_l, old_l = pipe.stepper_step(
            sampler=sampler, ctx_u=ctx_u, ctx_c=ctx_c, x=x,
            idx=torch.tensor(idx, device="cuda"),
            start_idx=torch.zeros(4, dtype=torch.long, device="cuda"),
            sigmas=sig.cuda(), timesteps=ts.cuda(), guidance=guidance.cuda(),
            old_denoised=old, active=active.cuda(), generators=[None] * 4)
        torch.cuda.synchronize()
        launches = KERNEL.launches - before
        shapes = {key: n - shapes_before.get(key, 0)
                  for key, n in KERNEL.shapes.items()
                  if n != shapes_before.get(key, 0)}
        rels = []
        with torch.inference_mode():
            for b in range(3):
                one = slice(b, b + 1)
                inp = scale_model_input(scheds[b], x[one], idx[b])
                t = scheds[b].timesteps[idx[b]].cuda().expand(2)
                eps_u, eps_c = pipe.c.unet(
                    torch.cat([inp, inp]), t,
                    torch.cat([ctx_u[one], ctx_c[one]])).chunk(2)
                eps = eps_u + float(guidance[b]) * (eps_c - eps_u)
                x_s, state = sampler_step(sampler, scheds[b], idx[b], x[one],
                                          eps, SamplerState(old[one]))
                rels.append([((got - ref).norm() / ref.norm()).item()
                             for got, ref in ((x_l[one], x_s),
                                              (old_l[one],
                                               state.old_denoised))])
        frozen = bool(torch.equal(x_l[3], x[3]) and torch.equal(old_l[3],
                                                                old[3]))
        kind = sampler.kind
        results[kind] = {"b1_launches": launches,
                         "b1_shapes": [[*k, n] for k, n in shapes.items()],
                         "rel_l2_x_old": rels,
                         "inactive_row_bit_equal": frozen,
                         "idx_next": idx_l.tolist()}
        worst = max(max(r) for r in rels)
        # the 1024-token level, 8 UNet rows: a shape the kernel phase holds
        if (shapes != {(8, 1024, 1024, 8, 40, "float32"): 5}
                or launches != 5 or not frozen or not worst <= 1e-4
                or idx_l.tolist() != [1, 6, 7, 3]):
            raise AssertionError(f"lane check ({kind}) failed: {results[kind]}")
    emit("lane_check", model="sd15 unet fp32", latent=[4, 4, 32, 32],
         width=4, steps=list(steps), idx=list(idx),
         guidance=guidance.tolist(), active=active.tolist(), tolerance=1e-4,
         **results)
    del pipe
    torch.cuda.empty_cache()


def stepper_stats(slot) -> dict:
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    return get_stepper(slot).stats()


def delta(after: dict, before: dict, key: str) -> int:
    return after.get(key, 0) - before.get(key, 0)


def lane_serve_phase(torch, registry, slot, solo_blobs: dict) -> tuple:
    """The serve jobs one after another through ``synchronous_do_work`` with
    the lanes on, on the solo slot: each job alone in a lane (adaptive
    width). Every job a lane's; B1 launched 10 times per lane step. Returns
    the launches, the blobs by seed and the jobs' span rows."""
    from chiaswarm_tpu_torch.ops import kernels

    before = stepper_stats(slot)
    spans: list = []
    seconds, blobs = run_jobs(torch, "lane_serve", slot, registry, lanes=True,
                              spans=spans)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    after = stepper_stats(slot)
    steps = delta(after, before, "steps_executed")
    want = steps * B1_LAUNCHES_PER_UNET_EVAL
    emit("lane_serve", jobs=len(JOBS), steps=SERVE_STEPS,
         job_seconds=seconds, images_per_s=len(JOBS) / sum(seconds),
         images_per_s_after_first=(len(JOBS) - 1) / sum(seconds[1:]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         steps_executed=steps, launches=launches,
         expected_flash_launches=want,
         vs_serve=image_diffs(blobs, solo_blobs))
    if launches["flash_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"lane_serve launched {launches}, expected "
                             f"{want} of flash_attention and no other")
    return launched(), blobs, spans


def image_diffs(blobs: dict, ref_blobs: dict) -> dict:
    """Per seed: the largest uint8 difference and the share of values within
    one level, against the reference's image of the same seed."""
    diffs = {}
    for seed, blob in blobs.items():
        diff = abs(decode_png(blob) - decode_png(ref_blobs[seed]))
        diffs[seed] = {"max": int(diff.max()),
                       "within_one": float((diff <= 1).mean()),
                       "bit_equal": bool((diff == 0).all())}
    return diffs


LANE_WIDTH = 8
BURST_JOBS = [{"id": f"burst-sd15-{seed}", "model_name": "sd15",
               "prompt": "a lighthouse on a cliff at golden hour, oil painting",
               "negative_prompt": "blurry, low quality" if seed == 12 else "",
               "num_inference_steps": 20 if seed % 2 else 12,
               "guidance_scale": 7.5 if seed % 2 else 5.0,
               "height": 512, "width": 512, "seed": seed,
               "content_type": "image/png"} for seed in range(11, 19)]
LATE_JOB = dict(BURST_JOBS[0], id="burst-sd15-19", seed=19)


def lane_burst_phase(torch, registry, slot) -> dict:
    """Eight jobs at once through ``synchronous_do_work_batch`` at a pinned
    lane width of 8 (steps 20 and 12, guidance 7.5 and 5.0 alternating),
    and a ninth through ``synchronous_do_work`` from a second thread once
    the lane has executed 5 steps: it waits for the 12-step rows to retire
    and splices in mid-flight. Every job on one lane; B1 launched 10 times
    per lane step, and fewer lane steps than half the jobs' summed steps.
    Then job 11 alone in a lane of the same width: its image within one
    uint8 level of the burst's (the per-row plumbing at one batch shape).
    Returns the burst's launches (``launched``)."""
    import threading

    from chiaswarm_tpu_torch.node.executor import (
        synchronous_do_work,
        synchronous_do_work_batch,
    )
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    get_stepper(slot).shutdown()  # lanes of another width policy
    jobs = BURST_JOBS + [LATE_JOB]
    with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)):
        before = stepper_stats(slot)
        late: dict = {}

        def submit_late():
            # at least 5 lane steps in, from a thread of its own
            while (delta(stepper_stats(slot), before, "steps_executed") < 5
                   and time.perf_counter() - t0 < 600):
                time.sleep(0.002)
            late["submitted_at"] = delta(stepper_stats(slot), before,
                                         "steps_executed")
            late["result"] = synchronous_do_work(dict(LATE_JOB), slot,
                                                 registry)
            late["done_s"] = time.perf_counter() - t0

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        thread = threading.Thread(target=submit_late, name="late-job")
        thread.start()
        results = synchronous_do_work_batch([dict(j) for j in BURST_JOBS],
                                            slot, registry)
        burst_s = time.perf_counter() - t0
        thread.join(timeout=900)
        wall_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        run = launched()
        after = stepper_stats(slot)
        peak = torch.cuda.max_memory_allocated()
        if "result" not in late:
            raise AssertionError("the ninth job never returned")
        results.append(late["result"])
        blobs, infos = {}, {}
        for job, result in zip(jobs, results):
            blobs[job["seed"]] = check_envelope("lane_burst", job, result,
                                                lanes=True)
            infos[job["seed"]] = result["pipeline_config"]["stepper"]
        # job 11 alone in a lane of the same width
        alone = synchronous_do_work(dict(BURST_JOBS[0]), slot, registry)
        alone_blob = check_envelope("lane_burst", BURST_JOBS[0], alone,
                                    lanes=True)
    get_stepper(slot).shutdown()
    steps = delta(after, before, "steps_executed")
    summed = sum(j["num_inference_steps"] for j in jobs)
    want = steps * B1_LAUNCHES_PER_UNET_EVAL
    isolation = image_diffs({11: blobs[11]}, {11: alone_blob})[11]
    lanes_used = {info["lane"] for info in infos.values()}
    row_active = delta(after, before, "row_steps_active")
    row_padded = delta(after, before, "row_steps_padded")
    emit("lane_burst", jobs=len(jobs), lane_width=LANE_WIDTH,
         burst_s=burst_s, wall_s=wall_s, images_per_s=len(jobs) / wall_s,
         late_submitted_at_step=late["submitted_at"],
         late_admitted_at_step=infos[19]["admitted_at_step"],
         steps_executed=steps, summed_job_steps=summed,
         launches=launches, expected_flash_launches=want,
         lane_resizes=delta(after, before, "lane_resizes"),
         row_steps_active=row_active, row_steps_padded=row_padded,
         occupancy=row_active / max(1, row_active + row_padded),
         step_seconds_ewma=after.get("step_seconds_ewma"),
         max_memory_allocated=peak, lanes=sorted(lanes_used),
         stepper={seed: infos[seed] for seed in sorted(infos)},
         isolation_job_11=isolation)
    if (launches["flash_attention"] != want or sum(launches.values()) != want
            or len(lanes_used) != 1 or infos[19]["admitted_at_step"] < 1
            or not steps < summed / 2 or isolation["max"] > 1):
        raise AssertionError(
            f"lane_burst failed: launches {launches} (want {want} of "
            f"flash_attention), lanes {lanes_used}, ninth job admitted at "
            f"step {infos[19]['admitted_at_step']}, steps {steps} (bar < "
            f"{summed / 2}), isolation {isolation}")
    return run, blobs, len(jobs) / wall_s


def lane_seq_serve_phase(torch) -> dict:
    """Four of the burst jobs through the lanes of the one-card ``seq = 4``
    slot, at a pinned lane width of 8 as in ``lane_burst``: every large
    self-attention of every lane step and every lane decode one B3 launch;
    B1 and B2 never. Returns its launches (``launched``)."""
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.mesh import MeshSpec
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        FUSED_KERNEL as B3,
    )
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"}],
                             allow_random=True, device="cuda")
    slot = ChipPool(mesh_spec=MeshSpec({"seq": RING_SHARDS}),
                    devices=one_card_devices(torch)).slots[0]
    jobs = BURST_JOBS[:4]
    with env(CHIASWARM_RING_FLASH="",
             CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)):
        load_pipeline(torch, "lane_seq_serve", registry, mesh=slot.mesh)
        before = stepper_stats(slot)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                            registry)
        wall_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
        run = launched()
        after = stepper_stats(slot)
    get_stepper(slot).shutdown()
    for job, result in zip(jobs, results):
        check_envelope("lane_seq_serve", job, result, lanes=True)
    steps = delta(after, before, "steps_executed")
    decodes = delta(after, before, "rows_completed")  # one row a job
    want = steps * B3_LAUNCHES_PER_UNET_EVAL + decodes * B3_LAUNCHES_PER_DECODE
    desc = slot.descriptor()
    emit("lane_seq_serve", jobs=len(jobs), wall_s=wall_s,
         images_per_s=len(jobs) / wall_s, mesh_shape=desc["mesh_shape"],
         mesh_devices=desc["mesh_devices"], steps_executed=steps,
         decodes=decodes, launches=launches, expected_ring_launches=want,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         stepper=[r["pipeline_config"]["stepper"] for r in results])
    if launches[B3.name] != want or sum(launches.values()) != want:
        raise AssertionError(f"lane_seq_serve launched {launches}, expected "
                             f"{want} of {B3.name} and no other")
    return run


# ---------------------------------------------------------------------------
# checkpoints on disk (convert/, models/tokenizer.py) and the residency
# ledger (serving/residency.py)

CKPT_MODEL = "chip-smoke/sd15"
CKPT_MODEL_B = "chip-smoke/sd15-b"  # a directory of links to CKPT_MODEL's
CKPT_JOBS = [dict(job, id=f"ckpt-sd15-{job['seed']}", model_name=CKPT_MODEL)
             for job in JOBS]
CLIP_VOCAB = 49408
# beyond its modules' bytes, a served model holds its pipeline's small
# device tensors, and the allocator rounds each block up: 5% of the model
MEMORY_SLACK = 0.05


def settings_root_dir() -> Path:
    """The settings root of this run (checkpoints, residency.json, spools):
    under the git-ignored ``build/``, removed when the run ends."""
    return ROOT / "build" / "chip_smoke_root"


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-character table, the alphabet
    CLIP's vocab is built on."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def synthetic_clip_vocab(seed: int = 0) -> tuple[dict, list]:
    """A CLIP-format vocab made here (nothing is downloaded): the 256 byte
    symbols and their word-final ``</w>`` forms, the left-to-right merges
    that spell the serve jobs' words, then random merges of a piece and a
    letter until the table holds 49,406 pieces (48,894 merges, as the
    published CLIP tokenizer), ``<|startoftext|>`` at 49406 and
    ``<|endoftext|>`` at 49407."""
    import random

    from chiaswarm_tpu_torch.models.tokenizer import _basic_tokens

    rng = random.Random(seed)
    base = list(bytes_to_unicode().values())
    vocab = {piece: i for i, piece in
             enumerate(base + [b + "</w>" for b in base])}
    merges: list[tuple[str, str]] = []
    stems = list(base)

    def merge(a: str, b: str) -> None:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
            merges.append((a, b))
            if not b.endswith("</w>"):
                stems.append(a + b)

    text = " ".join(f"{j['prompt']} {j['negative_prompt']}" for j in JOBS)
    for word in _basic_tokens(text):
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        left = pieces[0]
        for right in pieces[1:]:
            merge(left, right)
            left += right
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    letters += [c + "</w>" for c in letters]
    while len(vocab) < CLIP_VOCAB - 2:
        merge(rng.choice(stems), rng.choice(letters))
    vocab["<|startoftext|>"] = CLIP_VOCAB - 2
    vocab["<|endoftext|>"] = CLIP_VOCAB - 1
    return vocab, merges


def write_checkpoint(torch, components, path: Path) -> dict:
    """``components`` as a diffusers-layout snapshot at ``path``: ``unet/``,
    ``vae/`` and ``text_encoder/`` as float32 safetensors through the
    port's own writer (the dtype of the published SD1.5 snapshot; bf16
    weights round-trip it exactly), ``tokenizer/`` from
    ``synthetic_clip_vocab``. The files are synced and advised out of the
    page cache (``posix_fadvise``), which a filesystem may ignore:
    ``page_cache_share`` reads what it kept."""
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file

    modules = {"unet": components.unet, "vae": components.vae,
               "text_encoder": components.text_encoders[0]}
    files = []
    for sub, module in modules.items():
        (path / sub).mkdir(parents=True, exist_ok=True)
        name = ("model.safetensors" if sub == "text_encoder"
                else "diffusion_pytorch_model.safetensors")
        save_file({k: v.detach().float().cpu()
                   for k, v in module.state_dict().items()},
                  path / sub / name, {"format": "pt"})
        files.append(path / sub / name)
    vocab, merges = synthetic_clip_vocab()
    (path / "tokenizer").mkdir(parents=True, exist_ok=True)
    (path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab),
                                                    encoding="utf-8")
    (path / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    for file in files:
        fd = os.open(file, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return {"files": {str(f.relative_to(path)): f.stat().st_size
                      for f in files},
            "bytes": sum(f.stat().st_size for f in files),
            "vocab": len(vocab), "merges": len(merges)}


def page_cache_share(paths: list[str]) -> float:
    """The share of the files' pages that the page cache holds now
    (``mincore(2)`` over a private mapping of each file, nothing read)."""
    import ctypes
    import mmap

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_ubyte)]
    held = total = 0
    for path in paths:
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        pages = -(-len(mm) // mmap.PAGESIZE)
        vec = (ctypes.c_ubyte * pages)()
        anchor = ctypes.c_char.from_buffer(mm)
        rc = libc.mincore(ctypes.addressof(anchor), len(mm), vec)
        del anchor
        mm.close()
        if rc != 0:
            raise OSError(ctypes.get_errno(), f"mincore on {path}")
        held += sum(v & 1 for v in vec)
        total += pages
    return held / total


def direct_read(paths: list[str], chunk: int = 64 << 20) -> dict:
    """Every byte of the files read with ``O_DIRECT`` (past the page cache,
    from the disk) into one page-aligned buffer: the read a load pays when
    the cache does not hold its files. ``{"error": ...}`` where the
    filesystem refuses ``O_DIRECT``."""
    import mmap

    buf = mmap.mmap(-1, chunk)
    nbytes = 0
    t0 = time.perf_counter()
    try:
        for path in paths:
            fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
            try:
                while (n := os.readv(fd, [buf])) > 0:
                    nbytes += n
            finally:
                os.close(fd)
    except OSError as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    finally:
        buf.close()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "bytes": nbytes,
            "gb_per_s": nbytes / seconds / 1e9}


def module_states(components) -> dict:
    named = {f"text_encoder_{i}": te
             for i, te in enumerate(components.text_encoders)}
    named.update(unet=components.unet, vae=components.vae)
    return {name: dict(m.named_parameters()) for name, m in named.items()}


class OnePipeline:
    """A registry that serves one pipeline under every name: the reference
    side of an image comparison, on the executor's own path."""

    def __init__(self, pipe) -> None:
        self.pipe = pipe

    def pipeline(self, model_name: str, mesh=None):
        return self.pipe


def checkpoint_serve_phase(torch, src_registry, slot, lane_blobs: dict,
                           lane_spans: list) -> tuple[dict, dict]:
    """SD1.5 from a diffusers-layout directory on disk, through a
    ``ModelRegistry`` with no random fallback: the serve phases' seed-0
    weights written as float32 safetensors with a synthetic CLIP vocab
    (``write_checkpoint``), the files read once with ``O_DIRECT`` (the disk's
    read, ``direct_read``), the share of their pages the page cache holds
    (``page_cache_share``), the first load (file read and device copy timed
    apart, the peak of ``max_memory_allocated`` against ``param_bytes`` and
    ``estimate_family_bytes``), every tensor ``torch.equal`` to its source.
    Then a second registry loads the checkpoint while the source model's
    lane steps on another thread: its tensors equal to the source, the lane
    job's image bit for bit lane_serve's seed 1. Then seeds 1-3 one after
    another in the lanes, each image bit for bit the source modules' with
    the loaded tokenizer swapped in at the same lane composition, B1 at 10
    launches a lane step, and each job's spans beside lane_serve's. Returns
    the launches (``launched``) and what later phases need."""
    import dataclasses
    import gc
    import shutil
    import threading

    from chiaswarm_tpu_torch.models.tokenizer import ClipBpeTokenizer
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.pipelines.components import (
        estimate_family_bytes,
    )
    from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    src = src_registry.pipeline("sd15").c
    source = module_states(src)
    path = model_dir(CKPT_MODEL)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    written = write_checkpoint(torch, src, path)
    write_s = time.perf_counter() - t0
    disk = shutil.disk_usage(path)
    paths = [str(path / name) for name in written["files"]]
    direct = direct_read(paths)

    def unequal_to_source(components) -> list[str]:
        loaded = module_states(components)
        return [f"{m}.{k}" for m, params in source.items()
                for k, p in params.items()
                if loaded[m][k].dtype != p.dtype
                or not torch.equal(loaded[m][k], p)]

    registry = ModelRegistry(catalog=[{"name": CKPT_MODEL,
                                       "family": "sd15"}], device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cached = page_cache_share(paths)
    t0 = time.perf_counter()
    pipe = registry.pipeline(CKPT_MODEL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    unequal = unequal_to_source(pipe.c)
    tokenizer = pipe.c.tokenizers[0]
    ids = tokenizer.encode(JOBS[0]["prompt"])
    footprint = pipe.c.param_bytes()
    out = {
        "model": CKPT_MODEL, "files": written, "write_s": write_s,
        "disk_free_bytes": disk.free, "disk_total_bytes": disk.total,
        "direct_read": direct, "page_cache_share_at_load": cached,
        "cold_load_s": load_s, "load_stats": pipe.c.load_stats,
        "load_other_s": load_s - pipe.c.load_stats["read_s"]
        - pipe.c.load_stats["copy_s"],
        "load_peak_bytes": peak, "param_bytes": footprint,
        "estimate_family_bytes": estimate_family_bytes("sd15"),
        "tensors_checked": sum(len(v) for v in source.values()),
        "tensors_unequal": unequal[:8], "tokenizer": type(tokenizer).__name__,
        "prompt_ids": ids[:ids.index(tokenizer.eos_id) + 1],
        "residency": registry.residency.snapshot()}
    ref_pipe = DiffusionPipeline(dataclasses.replace(
        src, tokenizers=pipe.c.tokenizers))
    del pipe

    # a load while another model's lane steps on the card's one stream
    sched = get_stepper(slot)
    sched.shutdown()
    lane_job = dict(JOBS[0], id="under-load-sd15-1")
    done: dict = {}
    runner = threading.Thread(target=lambda: done.update(
        result=synchronous_do_work(dict(lane_job), slot, src_registry)))
    start = stepper_stats(slot).get("steps_executed", 0)
    runner.start()
    while (stepper_stats(slot).get("steps_executed", 0) - start < 3
           and runner.is_alive()):
        time.sleep(0.001)
    at_load = stepper_stats(slot).get("steps_executed", 0) - start
    second = ModelRegistry(catalog=[{"name": CKPT_MODEL, "family": "sd15"}],
                           device="cuda")
    t0 = time.perf_counter()
    pipe2 = second.pipeline(CKPT_MODEL)
    torch.cuda.synchronize()
    under_s = time.perf_counter() - t0
    after_load = stepper_stats(slot).get("steps_executed", 0) - start
    runner.join()
    sched.shutdown()
    under_blob = check_envelope("checkpoint_serve", lane_job, done["result"],
                                lanes=True)
    out["load_under_lane"] = {
        "load_s": under_s, "load_stats": pipe2.c.load_stats,
        "lane_steps_before_load": at_load, "lane_steps_after_load": after_load,
        "tensors_unequal": unequal_to_source(pipe2.c)[:8],
        "vs_lane_serve": image_diffs({1: under_blob}, {1: lane_blobs[1]})[1]}
    del pipe2, second
    gc.collect()

    before_stats = stepper_stats(slot)
    spans: list = []
    seconds, blobs = run_jobs(torch, "checkpoint_serve", slot, registry,
                              lanes=True, jobs=CKPT_JOBS, spans=spans)
    run = launched()  # run_jobs set every count to 0 first
    steps = delta(stepper_stats(slot), before_stats, "steps_executed")
    b1 = run["flash_attention"]["launches"]
    sched.shutdown()
    ref_spans: list = []
    ref_seconds, ref_blobs = run_jobs(torch, "checkpoint_serve_reference",
                                      slot, OnePipeline(ref_pipe),
                                      lanes=True, jobs=CKPT_JOBS,
                                      spans=ref_spans)
    sched.shutdown()
    diffs = image_diffs(blobs, ref_blobs)
    keys = sorted({k for row in spans + lane_spans for k in row})
    out.update({"job_seconds": seconds, "reference_job_seconds": ref_seconds,
                "spans": spans, "reference_spans": ref_spans,
                "lane_serve_spans": lane_spans,
                "minus_lane_serve_s": {
                    k: [a.get(k, 0.0) - b.get(k, 0.0)
                        for a, b in zip(spans, lane_spans)] for k in keys},
                "steps_executed": steps, "b1_launches": b1,
                "vs_source_modules": diffs})
    emit("checkpoint_serve", **out)
    under = out["load_under_lane"]
    if (unequal or not isinstance(tokenizer, ClipBpeTokenizer)
            or b1 != steps * B1_LAUNCHES_PER_UNET_EVAL
            or not all(d["bit_equal"] for d in diffs.values())
            or under["tensors_unequal"]
            or not under["vs_lane_serve"]["bit_equal"]
            or not at_load < under["lane_steps_after_load"]):
        raise AssertionError(f"checkpoint_serve: {out}")
    return run, {"registry": registry, "blobs": blobs,
                 "footprint": footprint}


def residency_churn_phase(torch, slot, ckpt: dict) -> dict:
    """Two catalog names over the one checkpoint (``CKPT_MODEL_B`` is a
    directory of links) under a ledger that holds one model (budget 1.5x
    the measured footprint): A served in a lane; B's load evicts A and
    retires A's lane at drain, ``memory_allocated`` back within one model
    (and ``MEMORY_SLACK``) of the level before A, the ledger's peak of
    resident + reserved bytes at most budget + one model; B served; A
    reloaded renders its first image bit for bit. Then the rungs: a budget
    below one model degrades A to load-per-job (``lane_resident_ok`` false,
    the job solo, ``residency: per_job``, the image bit for bit the solo
    path's on the checkpoint registry); a hard limit below the footprint
    gives a non-fatal ``model_unavailable`` envelope."""
    import gc

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.residency import (
        ResidencyManager,
        default_hard_limit_bytes,
    )
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    footprint = ckpt["footprint"]
    link = model_dir(CKPT_MODEL_B)
    link.mkdir(parents=True, exist_ok=True)
    for sub in model_dir(CKPT_MODEL).iterdir():
        if not (link / sub.name).exists():
            (link / sub.name).symlink_to(sub.resolve(),
                                         target_is_directory=True)
    budget = int(1.5 * footprint)
    ledger = ResidencyManager(
        budget, default_hard_limit_bytes(budget, "cuda"),
        persist_path=settings_root_dir() / "residency-churn.json",
        prefetch=False)
    registry = ModelRegistry(
        catalog=[{"name": CKPT_MODEL, "family": "sd15"},
                 {"name": CKPT_MODEL_B, "family": "sd15"}],
        device="cuda", residency=ledger)
    sched = get_stepper(slot)
    sched.shutdown()
    kernels.reset_launches()
    job_a = dict(CKPT_JOBS[0], id="churn-a-1")
    out: dict = {"budget_bytes": budget, "footprint": footprint}

    def serve(job, lanes=True) -> tuple[str, dict]:
        t0 = time.perf_counter()
        result = synchronous_do_work(dict(job), slot, registry)
        seconds = time.perf_counter() - t0
        cfg = result["pipeline_config"]
        return check_envelope("residency_churn", job, result, lanes), {
            "seconds": seconds, "generation_s": cfg.get("generation_s"),
            "stepper": cfg.get("stepper"), "residency": cfg.get("residency")}

    def timed_load(model: str) -> float:
        t0 = time.perf_counter()
        registry.pipeline(model)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def owners() -> set:
        return {id(key[0].c) for key in list(sched._lanes)}

    gc.collect()
    torch.cuda.synchronize()
    level0 = torch.cuda.memory_allocated()
    out["load_a_s"] = timed_load(CKPT_MODEL)
    owner_a = id(registry.pipeline(CKPT_MODEL).c)
    blob_a1, out["a_first"] = serve(job_a)
    level_a = torch.cuda.memory_allocated()
    ledger.reset_peak()

    t0 = time.perf_counter()
    registry.pipeline(CKPT_MODEL_B)
    torch.cuda.synchronize()
    out["evict_and_load_b_s"] = time.perf_counter() - t0
    while owner_a in owners() and time.perf_counter() - t0 < 60:
        time.sleep(0.01)
    out["a_lane_retired_after_s"] = time.perf_counter() - t0
    out["a_lane_retired"] = owner_a not in owners()
    gc.collect()
    torch.cuda.synchronize()
    level_b = torch.cuda.memory_allocated()
    out.update({"level_before_a": level0, "level_a_resident": level_a,
                "level_after_eviction": level_b,
                "above_level_before_a": level_b - level0,
                "memory_reserved": torch.cuda.memory_reserved(),
                "ledger_peak_bytes": ledger.peak_bytes,
                "states_after_b": registry.model_states()})
    blob_b, out["b"] = serve(dict(CKPT_JOBS[0], id="churn-b-1",
                                  model_name=CKPT_MODEL_B))
    out["reload_a_s"] = timed_load(CKPT_MODEL)
    blob_a2, out["a_again"] = serve(dict(job_a, id="churn-a-1-again"))
    out["a_again_bit_equal"] = blob_a2 == blob_a1
    out["b_bit_equal_a"] = blob_b == blob_a1
    sched.shutdown()
    snap = ledger.snapshot()
    failed = []
    if (snap["evictions"] != 2 or not out["a_lane_retired"]
            or level_b - level0 > footprint * (1 + MEMORY_SLACK)
            or out["ledger_peak_bytes"] > budget + footprint
            or out["states_after_b"] != {CKPT_MODEL: "evicted",
                                         CKPT_MODEL_B: "resident"}
            or not out["a_again_bit_equal"]):
        failed.append("eviction")

    # rung 1: a budget below one model degrades A to load-per-job
    ledger.set_budget(footprint // 2)
    out["lane_resident_ok_degraded"] = registry.lane_resident_ok(CKPT_MODEL)
    blob_deg, out["degraded"] = serve(dict(job_a, id="churn-a-1-degraded"),
                                      lanes=False)
    with env(CHIASWARM_STEPPER="0"):
        solo = synchronous_do_work(dict(job_a, id="churn-a-1-solo"), slot,
                                   ckpt["registry"])
    blob_solo = check_envelope("residency_churn", job_a, solo, lanes=False)
    out["degraded_bit_equal_solo"] = blob_deg == blob_solo
    gc.collect()
    out["reserved_after_degraded_job"] = ledger.reserved_bytes
    if (out["lane_resident_ok_degraded"] or not out["degraded_bit_equal_solo"]
            or out["degraded"]["residency"] != "per_job"
            or out["reserved_after_degraded_job"] != 0):
        failed.append("degrade")

    # rung 2: a hard limit below the footprint bounces the job
    ledger.set_budget(footprint // 4, footprint // 2)
    bounced = synchronous_do_work(dict(job_a, id="churn-a-2-bounce", seed=2),
                                  slot, registry)
    cfg = bounced["pipeline_config"]
    out["bounce"] = {"error_kind": cfg.get("error_kind"),
                     "fatal_error": bool(bounced.get("fatal_error")),
                     "error": cfg.get("error")}
    if cfg.get("error_kind") != "model_unavailable" or "fatal_error" in bounced:
        failed.append("bounce")
    run = launched()
    out["snapshot"] = ledger.snapshot()
    out["states"] = registry.model_states()
    sched.shutdown()
    emit("residency_churn", **out)
    if failed:
        raise AssertionError(f"residency_churn ({', '.join(failed)}): {out}")
    return run


# ---------------------------------------------------------------------------
# the hive worker (node/worker.py): poll -> lanes -> upload


class LocalHive:
    """The hive protocol's three endpoints (``GET /api/work``, ``POST
    /api/results``, ``GET /api/models``) on ``127.0.0.1``, served from a
    thread of this script by the standard library's ``http.server``. Every
    poll hands out every queued job (the reference hive's semantics).
    ``faults`` maps a job id to the HTTP statuses its first uploads get."""

    def __init__(self) -> None:
        import http.server
        import threading

        self.cond = threading.Condition()
        self.queued: list[dict] = []
        self.results: list[dict] = []
        self.result_t: list[float] = []
        self.faults: dict[str, list[int]] = {}
        self.work_t: list[float] = []  # when each poll that handed out work
        self.posts = 0
        hive = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass

            def _reply(self, status: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path = self.path.split("?")[0]
                if path == "/api/models":
                    return self._reply(200, {"models": []})
                if path != "/api/work":
                    return self._reply(404, {"message": "no such endpoint"})
                with hive.cond:
                    jobs, hive.queued = hive.queued, []
                    if jobs:
                        hive.work_t.append(time.perf_counter())
                self._reply(200, {"jobs": jobs})

            def do_POST(self) -> None:
                body = self.rfile.read(int(self.headers["Content-Length"]))
                result = json.loads(body)
                with hive.cond:
                    hive.posts += 1
                    statuses = hive.faults.get(str(result.get("id")))
                    status = statuses.pop(0) if statuses else 200
                    if status == 200:
                        hive.results.append(result)
                        hive.result_t.append(time.perf_counter())
                        hive.cond.notify_all()
                if status != 200:
                    return self._reply(status, {"message": "unavailable"})
                self._reply(200, {"status": "ok"})

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="local-hive", daemon=True)

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def submit(self, *jobs: dict) -> None:
        with self.cond:
            self.queued.extend(dict(job) for job in jobs)

    def __enter__(self) -> "LocalHive":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def serve_through_worker(hive: LocalHive, pool, registry, jobs: list[dict],
                         late=None, timeout_s: float = 600.0):
    """Queue ``jobs`` on ``hive``, run the port's ``Worker`` (its default
    settings but the hive address) until a result per job (and per job
    ``late`` submits) has arrived, then stop it. ``late(hive, t0)`` is
    awaited beside the worker. Returns the worker."""
    import asyncio

    from chiaswarm_tpu_torch.node.settings import Settings
    from chiaswarm_tpu_torch.node.worker import Worker

    hive.submit(*jobs)
    want = len(hive.results) + len(jobs) + (1 if late else 0)
    worker = Worker(Settings(hive_uri=hive.uri, hive_token="chip-smoke",
                             worker_name="chip-smoke"),
                    pool=pool, registry=registry)

    async def drive():
        task = asyncio.create_task(worker.run())
        extra = asyncio.create_task(late(hive)) if late else None
        t0 = time.perf_counter()
        try:
            while len(hive.results) < want:
                if task.done():
                    task.result()  # the worker died: raise its error
                    raise AssertionError("the worker stopped early")
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(
                        f"{len(hive.results)} of {want} results after "
                        f"{timeout_s} s")
                await asyncio.sleep(0.005)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=120)
            if extra is not None:
                await extra

    asyncio.run(drive())
    return worker


def trace_rows(worker) -> dict:
    """Per job id: its seconds from poll receipt to settled upload, its
    phases (poll = queue wait, execute, upload) and the spans under each
    (``execute.encode_s`` and so on; a span that repeats, such as an
    upload's attempts, sums), from the worker's trace ring."""
    return {trace.meta["id"]: span_rows(trace)
            for trace in worker.traces.traces()}


def span_rows(trace) -> dict:
    row = {"seconds": trace.root.duration_s}
    for phase in trace.root.children:
        row[f"{phase.name}_s"] = phase.duration_s
        for span in phase.children:
            key = f"{phase.name}.{span.name}_s"
            row[key] = row.get(key, 0.0) + span.duration_s
    return row


def host_breakdown(row: dict, generation_s: float) -> dict:
    """The worker's host seconds of one job (job seconds minus the
    executor's ``generation_s``, which runs from the lane submission's end
    to the decoded image) and the spans that make them up; ``other`` is
    what no span covers (thread hops, the executor around the spans)."""
    parts = {"poll": row.get("poll_s", 0.0),
             "format": row.get("execute.format_s", 0.0),
             "text_encode": row.get("execute.encode_s", 0.0),
             "png_base64": row.get("execute.artifacts_s", 0.0),
             "upload": row.get("upload_s", 0.0)}
    host_s = row["seconds"] - generation_s
    return {"host_s": host_s, **parts, "other": host_s - sum(parts.values())}


@contextlib.contextmanager
def lane_admissions(record: dict | None = None, hold: dict | None = None):
    """Watch or steer the lanes' admissions (``serving/stepper.py``,
    ``Lane._admit_locked``) while the block runs:

    - ``record`` fills with job id -> (lane id, lane step, slots) as each
      job is admitted;
    - ``hold`` maps job id -> lane step: nothing is admitted until every
      job it names has been submitted, and each is then held until its
      lane has executed that many steps. Jobs released at one step are
      admitted in their submission order, into the lowest free slots,
      as the lane always admits."""
    from chiaswarm_tpu_torch.serving.stepper import Lane

    admit = Lane._admit_locked
    submitted: set = set()

    def steered(lane) -> None:
        held: list = []
        if hold:
            submitted.update(job.job_id for job in lane._pending)
            if set(hold) - submitted:
                return  # a job of the schedule is still being submitted
            held = [job for job in lane._pending
                    if hold.get(job.job_id, 0) > lane.steps_executed]
            lane._pending = collections.deque(
                job for job in lane._pending
                if not any(job is h for h in held))
        admit(lane)
        lane._pending.extend(held)
        if record is not None:
            for job in lane._rows:
                if job is not None and job.job_id not in record:
                    record[job.job_id] = (lane.lane_id, job.admitted_at_step,
                                          list(job.slots))

    Lane._admit_locked = steered
    try:
        yield
    finally:
        Lane._admit_locked = admit


def replay_burst(registry, slot, jobs: list[dict], admissions: dict) -> dict:
    """``jobs`` through ``synchronous_do_work_batch`` on a fresh lane of
    ``LANE_WIDTH`` rows, each admitted at the lane step at which
    ``admissions`` (from ``lane_admissions``) says it was: the same jobs
    in the same slots beside the same rows at every step. Returns the
    envelope by job id, the replay's admissions, its lane steps and its B1
    launches (0 on the CPU)."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL as B1
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    get_stepper(slot).shutdown()
    order = sorted(jobs, key=lambda j: admissions[j["id"]][1:])
    replayed: dict = {}
    with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)), lane_admissions(
            record=replayed,
            hold={j["id"]: admissions[j["id"]][1] for j in order}):
        before, b1_before = stepper_stats(slot), B1.launches
        results = synchronous_do_work_batch([dict(j) for j in order], slot,
                                            registry)
        steps = delta(stepper_stats(slot), before, "steps_executed")
        b1 = B1.launches - b1_before
    get_stepper(slot).shutdown()
    return {"results": {job["id"]: result
                        for job, result in zip(order, results)},
            "admissions": replayed, "steps": steps, "b1_launches": b1}


def worker_child(hive: LocalHive, root: Path) -> dict:
    """``python -m chiaswarm_tpu_torch.node.worker`` as a child process
    pointed at ``hive`` by ``SDAAS_URI``/``SDAAS_TOKEN``: its registry holds
    no checkpoint and no random fallback, so one ``sd15`` job must come back
    as a non-fatal ``model_unavailable`` envelope; then SIGTERM, and the
    child drains and exits with 0."""
    import signal

    job = dict(JOBS[0], id="worker-child-1")
    hive.submit(job)
    log_path = root / "child.log"
    child_env = dict(os.environ, SDAAS_URI=hive.uri, SDAAS_TOKEN="chip-smoke",
                     SDAAS_WORKERNAME="chip-smoke-child",
                     SWARM_TPU_ROOT=str(root / "child"))
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        child = subprocess.Popen(
            [sys.executable, "-m", "chiaswarm_tpu_torch.node.worker"],
            cwd=ROOT, env=child_env, stdout=log_file,
            stderr=subprocess.STDOUT)
        try:
            with hive.cond:
                if not hive.cond.wait_for(
                        lambda: any(r["id"] == job["id"]
                                    for r in hive.results), timeout=300):
                    raise AssertionError("the child worker uploaded nothing")
            result_s = time.perf_counter() - t0
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    text = log_path.read_text()
    startup = [line for line in text.splitlines()
               if "card(s)" in line or "derived default mesh" in line]
    [result] = [r for r in hive.results if r["id"] == job["id"]]
    cfg = result["pipeline_config"]
    out = {"rc": rc, "error_kind": cfg.get("error_kind"),
           "fatal_error": bool(result.get("fatal_error")),
           "result_after_s": result_s, "startup": startup,
           "log_tail": text.splitlines()[-5:]}
    if (rc != 0 or cfg.get("error_kind") != "model_unavailable"
            or result.get("fatal_error") or not startup):
        raise AssertionError(f"the child worker failed: {out}")
    return out


def worker_serve_phase(torch, registry, pool, lane_blobs: dict,
                       burst_blobs: dict, burst_ips: float,
                       ckpt: dict) -> dict:
    """The port's ``Worker.run()`` against a hive served from this script
    (``LocalHive``), on the lanes, on the serve phases' ``ChipPool``:

    - the lone job: ``serve``'s seed-1 job in a fresh lane at the lanes'
      default width; error-free with a 512x512 PNG and a ``stepper``
      stamp, and bit for bit ``lane_serve``'s seed-1 image (the same lane
      of 2 rows). Then, in the warm lane, twice: the same job through
      ``synchronous_do_work`` (with a trace of its own), then through the
      worker; each pair bit for bit, and their seconds side by side;
    - the burst: ``lane_burst``'s jobs at its pinned width of 8, seeds
      11-18 handed out by the first poll that returns work and seed 19 by a
      later one once the lane has stepped 5 times; all nine arrive once,
      each bit for bit the image of ``replay_burst`` (the same jobs in the
      same slots at the same lane steps), which runs last; the difference
      from ``lane_burst``'s image of each seed is printed;
    - one upload fault: the first POST of a re-run of the lone job gets a
      503; ``upload_retries`` rises by 1 and the result arrives once, with
      the lone job's image;
    - the checkpoint model: ``CKPT_MODEL``'s seed-1 job, served by a worker
      whose registry has no random fallback and loads the model from disk
      (the settings root of ``checkpoint_serve``): an error-free PNG, bit
      for bit ``checkpoint_serve``'s seed-1 image (a fresh lane both times);
    - the entry point: ``python -m chiaswarm_tpu_torch.node.worker`` as a
      child process (``worker_child``).

    B1 launches 10 times per lane step, at held shapes. Prints each job's
    seconds (poll receipt to settled upload, from the worker's traces and
    its ``chiaswarm_job_seconds`` histogram) and spans, the worker's host
    seconds (``host_breakdown``), the burst's images/s from the first poll
    that returned work to the last upload beside ``lane_burst``'s, and the
    lane steps and occupancy. Returns the launches of the worker's runs
    (``launched``), the replay's excluded."""
    import tempfile

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.obs import trace as obs_trace
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops.flash_attention import KERNEL as B1
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    slot = pool.slots[0]
    get_stepper(slot).shutdown()
    out: dict = {}
    failed: list[str] = []  # checked after every sub-run has run
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="worker-serve-") as tmp, \
            env(SWARM_TPU_ROOT=tmp), LocalHive() as hive:
        # the lone job, in a fresh lane
        before, b1_before = stepper_stats(slot), B1.launches
        lone_job = dict(JOBS[0], id="worker-sd15-1")
        worker = serve_through_worker(hive, pool, registry, [lone_job])
        [lone] = [r for r in hive.results if r["id"] == lone_job["id"]]
        lone_blob = check_envelope("worker_serve", lone_job, lone, lanes=True)
        steps = delta(stepper_stats(slot), before, "steps_executed")
        rows = trace_rows(worker)[lone_job["id"]]
        gen_s = lone["pipeline_config"]["generation_s"]
        out["lone"] = {
            **rows, "generation_s": gen_s,
            **host_breakdown(rows, gen_s),
            "histogram_count": worker._job_seconds.count(),
            "histogram_sum_s": worker._job_seconds.sum(),
            "steps_executed": steps,
            "b1_launches": B1.launches - b1_before,
            "stepper": lone["pipeline_config"]["stepper"],
            "vs_lane_serve": image_diffs({1: lone_blob},
                                         {1: lane_blobs[1]})[1]}
        emit("worker_serve_lone", **out["lone"])
        if (B1.launches - b1_before != steps * B1_LAUNCHES_PER_UNET_EVAL
                or not out["lone"]["vs_lane_serve"]["bit_equal"]):
            raise AssertionError(f"worker_serve lone job: {out['lone']}")

        # the same job in the warm lane: the executor alone, then the worker
        warm = []
        for turn in range(2):
            direct_job = dict(JOBS[0], id=f"direct-sd15-1-{turn}")
            trace = obs_trace.JobTrace(id=direct_job["id"])
            obs_trace.attach(direct_job, trace)
            trace.phase("execute")
            direct = synchronous_do_work(direct_job, slot, registry)
            trace.finish(obs_trace.TraceRing())
            direct_blob = check_envelope("worker_serve", direct_job, direct,
                                         lanes=True)
            job = dict(JOBS[0], id=f"worker-sd15-1-{turn}")
            worker = serve_through_worker(hive, pool, registry, [job])
            [result] = [r for r in hive.results if r["id"] == job["id"]]
            blob = check_envelope("worker_serve", job, result, lanes=True)
            rows = trace_rows(worker)[job["id"]]
            d_rows = span_rows(trace)
            gen_s = result["pipeline_config"]["generation_s"]
            d_gen_s = direct["pipeline_config"]["generation_s"]
            warm.append({
                "direct": {**d_rows, "generation_s": d_gen_s,
                           **host_breakdown(d_rows, d_gen_s)},
                "worker": {**rows, "generation_s": gen_s,
                           **host_breakdown(rows, gen_s)},
                "worker_minus_direct_s": rows["seconds"] - d_rows["seconds"],
                "lane_widths": [direct["pipeline_config"]["stepper"]
                                ["lane_width"],
                                result["pipeline_config"]["stepper"]
                                ["lane_width"]],
                "bit_equal": blob == direct_blob})
        get_stepper(slot).shutdown()
        out["warm"] = warm
        emit("worker_serve_warm", turns=warm,
             mean_worker_minus_direct_s=statistics.mean(
                 t["worker_minus_direct_s"] for t in warm))
        if not all(t["bit_equal"] for t in warm):
            failed.append(f"worker_serve warm lone jobs: {warm}")

        # the burst, at lane_burst's pinned width
        admissions: dict = {}
        with env(CHIASWARM_STEPPER_LANE_WIDTH=str(LANE_WIDTH)), \
                lane_admissions(record=admissions):
            before, b1_before = stepper_stats(slot), B1.launches
            late_at: dict = {}

            async def late(hive_):
                import asyncio

                while (delta(stepper_stats(slot), before, "steps_executed")
                       < 5):
                    await asyncio.sleep(0.002)
                late_at["step"] = delta(stepper_stats(slot), before,
                                        "steps_executed")
                late_at["polls_with_work"] = len(hive_.work_t)
                hive_.submit(LATE_JOB)

            first_poll = len(hive.work_t)
            first_result = len(hive.results)
            worker = serve_through_worker(hive, pool, registry,
                                          BURST_JOBS, late=late)
            after = stepper_stats(slot)
            get_stepper(slot).shutdown()
        results = hive.results[first_result:]
        t_first_work = hive.work_t[first_poll]
        t_last = hive.result_t[-1]
        ids = [r["id"] for r in results]
        jobs = BURST_JOBS + [LATE_JOB]
        if sorted(ids) != sorted(j["id"] for j in jobs):
            raise AssertionError(f"worker_serve burst results: {ids}")
        by_id = {r["id"]: r for r in results}
        blobs, infos, host = {}, {}, []
        traces = trace_rows(worker)
        for job in jobs:
            result = by_id[job["id"]]
            blobs[job["seed"]] = check_envelope("worker_serve", job, result,
                                                lanes=True)
            infos[job["seed"]] = result["pipeline_config"]["stepper"]
            host.append(host_breakdown(
                traces[job["id"]], result["pipeline_config"]["generation_s"]))
        steps = delta(after, before, "steps_executed")
        row_active = delta(after, before, "row_steps_active")
        row_padded = delta(after, before, "row_steps_padded")
        diffs = image_diffs(blobs, burst_blobs)
        wall_s = t_last - t_first_work
        out["burst"] = {
            "jobs": len(jobs), "lane_width": LANE_WIDTH,
            "wall_s": wall_s, "images_per_s": len(jobs) / wall_s,
            "lane_burst_images_per_s": burst_ips,
            "vs_lane_burst_images_per_s": len(jobs) / wall_s / burst_ips,
            "late_submitted_at_step": late_at.get("step"),
            "late_polls_with_work_before": late_at.get("polls_with_work"),
            "polls_with_work": len(hive.work_t) - first_poll,
            "late_admitted_at_step": infos[19]["admitted_at_step"],
            "steps_executed": steps,
            "row_steps_active": row_active, "row_steps_padded": row_padded,
            "occupancy": row_active / max(1, row_active + row_padded),
            "b1_launches": B1.launches - b1_before,
            "job_seconds": {j["id"]: traces[j["id"]] for j in jobs},
            "host_per_job": host,
            "mean_host_s": statistics.mean(h["host_s"] for h in host),
            "histogram_count": worker._job_seconds.count(),
            "histogram_sum_s": worker._job_seconds.sum(),
            "lanes": sorted({info["lane"] for info in infos.values()}),
            "admissions": {j["seed"]: admissions.get(j["id"]) for j in jobs},
            "vs_lane_burst": diffs,
            "bit_equal_vs_lane_burst": sum(d["bit_equal"]
                                           for d in diffs.values()),
            "within_one_level_of_lane_burst": sum(
                d["max"] <= 1 for d in diffs.values())}
        emit("worker_serve_burst", **out["burst"])
        if (B1.launches - b1_before != steps * B1_LAUNCHES_PER_UNET_EVAL
                or len(out["burst"]["lanes"]) != 1
                or any(j["id"] not in admissions for j in jobs)):
            failed.append(f"worker_serve burst: {out['burst']}")

        # one upload fault on a re-run of the lone job
        retry_job = dict(JOBS[0], id="worker-sd15-retry-1")
        hive.faults[retry_job["id"]] = [503]
        posts_before = hive.posts
        worker = serve_through_worker(hive, pool, registry, [retry_job])
        get_stepper(slot).shutdown()
        arrived = [r for r in hive.results if r["id"] == retry_job["id"]]
        retry_blob = check_envelope("worker_serve", retry_job, arrived[0],
                                    lanes=True)
        out["upload_fault"] = {
            "upload_retries": worker.stats.upload_retries,
            "posts": hive.posts - posts_before, "arrived": len(arrived),
            "seconds": trace_rows(worker)[retry_job["id"]],
            "bit_equal_to_lone": retry_blob == lone_blob}
        emit("worker_serve_upload_fault", **out["upload_fault"])
        if (worker.stats.upload_retries != 1 or len(arrived) != 1
                or hive.posts - posts_before != 2 or retry_blob != lone_blob):
            failed.append(f"worker_serve upload fault: "
                          f"{out['upload_fault']}")

        # the checkpoint model, loaded from disk by the worker's registry
        ck_job = dict(CKPT_JOBS[0], id="worker-ckpt-sd15-1")
        with env(SWARM_TPU_ROOT=str(settings_root_dir())):
            ck_registry = ModelRegistry(
                catalog=[{"name": CKPT_MODEL, "family": "sd15"}],
                device="cuda")
            before, b1_before = stepper_stats(slot), B1.launches
            worker = serve_through_worker(hive, pool, ck_registry, [ck_job])
            ck_steps = delta(stepper_stats(slot), before, "steps_executed")
            get_stepper(slot).shutdown()
        [ck_result] = [r for r in hive.results if r["id"] == ck_job["id"]]
        ck_blob = check_envelope("worker_serve", ck_job, ck_result, lanes=True)
        out["checkpoint"] = {
            "seconds": trace_rows(worker)[ck_job["id"]],
            "generation_s": ck_result["pipeline_config"]["generation_s"],
            "steps_executed": ck_steps,
            "b1_launches": B1.launches - b1_before,
            "residency": ck_registry.residency.snapshot(),
            "vs_checkpoint_serve": image_diffs(
                {1: ck_blob}, {1: ckpt["blobs"][1]})[1]}
        del ck_registry
        emit("worker_serve_checkpoint", **out["checkpoint"])
        if (out["checkpoint"]["b1_launches"]
                != ck_steps * B1_LAUNCHES_PER_UNET_EVAL
                or not out["checkpoint"]["vs_checkpoint_serve"]["bit_equal"]):
            failed.append(f"worker_serve checkpoint job: {out['checkpoint']}")

        # the entry point, as a node operator starts it
        out["child"] = worker_child(hive, Path(tmp))
        emit("worker_serve_child", **out["child"])
    run = launched()

    # the burst's batch composition again, outside the worker: each image
    # bit for bit the worker's
    if not failed:
        replay = replay_burst(registry, slot, jobs, admissions)
        exact = image_diffs(blobs, {
            job["seed"]: check_envelope("worker_serve", job,
                                        replay["results"][job["id"]],
                                        lanes=True) for job in jobs})
        out["replay"] = {
            "steps_executed": replay["steps"],
            "b1_launches": replay["b1_launches"],
            # (lane step, slots) of each job; the lane is a fresh one
            "same_admissions": {k: v[1:] for k, v in
                                replay["admissions"].items()}
            == {k: v[1:] for k, v in admissions.items()},
            "bit_equal": sum(d["bit_equal"] for d in exact.values()),
            "vs_worker": exact}
        emit("worker_serve_replay", **out["replay"])
        if (not out["replay"]["same_admissions"]
                or out["replay"]["bit_equal"] != len(jobs)
                or replay["steps"] != steps
                or replay["b1_launches"]
                != steps * B1_LAUNCHES_PER_UNET_EVAL):
            failed.append(f"worker_serve replay: {out['replay']} "
                          f"(worker admissions {admissions})")
    emit("worker_serve", lone_seconds=out["lone"]["seconds"],
         lone_host_s=out["lone"]["host_s"],
         warm_worker_minus_direct_s=[t["worker_minus_direct_s"]
                                     for t in out["warm"]],
         burst_images_per_s=out["burst"]["images_per_s"],
         lane_burst_images_per_s=burst_ips,
         burst_mean_host_s=out["burst"]["mean_host_s"],
         burst_bit_equal_vs_replay=out.get("replay", {}).get("bit_equal"),
         burst_within_one_level_of_lane_burst=out["burst"][
             "within_one_level_of_lane_burst"],
         checkpoint_job_bit_equal=out["checkpoint"]["vs_checkpoint_serve"][
             "bit_equal"],
         b1_launches=run["flash_attention"]["launches"])
    if failed:
        raise AssertionError("; ".join(failed))
    return run


def solo_pair_phase(torch, registry, slot, lane_blob: str,
                    solo_blob: str) -> dict:
    """Seed 1 with ``num_images_per_prompt=2`` on the solo path (a CFG
    batch of 4 rows, the UNet batch of a lane of 2) and through a lane
    pinned at 2 rows (the same UNet batch, text batch and noise): the two
    grids bit for bit, which holds the lane's per-row step to the solo
    step on the card. The solo pair's first image (the left half of its
    1x2 grid) is also set beside the lone job's lane image (a lane of 2
    with a padding row; its text encoded alone) and beside the solo path's
    one-image render (a CFG batch of 2)."""
    import numpy as np

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    kernels.reset_launches()
    job = dict(JOBS[0], id="solo-pair-1", num_images_per_prompt=2)
    grids = {}
    for mode in ("0", "1"):
        with env(CHIASWARM_STEPPER=mode, CHIASWARM_STEPPER_LANE_WIDTH="2"):
            result = synchronous_do_work(dict(job), slot, registry)
        cfg = result["pipeline_config"]
        if "error" in cfg or ("stepper" in cfg) != (mode == "1"):
            raise AssertionError(f"solo_pair ({mode}): {cfg}")
        grids[mode] = decode_png(result["artifacts"]["primary"]["blob"])
        if grids[mode].shape != (512, 1024, 3):
            raise AssertionError(f"solo_pair grid is {grids[mode].shape}")
    get_stepper(slot).shutdown()
    row0 = grids["0"][:, :512]

    def diff(a, b):
        d = np.abs(a - b)
        return {"max": int(d.max()), "within_one": float((d <= 1).mean()),
                "bit_equal": bool((d == 0).all())}

    run = launched()
    pair = diff(grids["1"], grids["0"])
    emit("solo_pair", lane_pair_vs_solo_pair=pair,
         solo_pair_row_0_vs_lone_lane_job=diff(row0, decode_png(lane_blob)),
         solo_pair_row_0_vs_solo_1=diff(row0, decode_png(solo_blob)),
         b1_shapes=[[*k, n] for k, n in run["flash_attention"]["shapes"]
                    .items()])
    if not pair["bit_equal"]:
        raise AssertionError(f"solo_pair: the lane's pair is not the solo "
                             f"pair bit for bit: {pair}")
    return run


def kernel_entry(name: str, rows: list[dict], run: dict, **extra) -> dict:
    """One kernel of the kernels line: its launches in a served phase
    (``run``, from ``launched``) and its per-launch numbers from its kernel
    phase averaged over that phase's launches by shape."""
    from chiaswarm_tpu_torch.ops.kernels import KERNELS

    k = KERNELS[name]
    weights = [run[name]["shapes"].get(shape_key(r), 0) for r in rows]

    def mix(key):
        values = [r[key] for r in rows]
        if any(v is None for v in values):
            return None
        return sum(w * v for w, v in zip(weights, values)) / sum(weights)

    op_ms = sum(w * r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3
                for w, r in zip(weights, rows))
    byte_ms = sum(w * r["bytes"] / PEAK_BYTES_PER_S * 1e3
                  for w, r in zip(weights, rows))
    served = [r["design"] for r, w in zip(rows, weights) if w]
    return {
        "name": name, "route": "cuda",
        "source": str(k.source.relative_to(ROOT)),
        "replaces": k.replaces,
        "design": ", ".join(dict.fromkeys(served)) if served else None,
        "launches": run[name]["launches"],
        "launches_by_shape": weights,
        "checked_against_plain": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mix("ms"), "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound_ms"),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": mix("library_ms"),
        "vs_library": vs_library(mix("ms"), mix("library_ms")),
        **extra,
    }


def kernels_line(runs: dict, tables: dict) -> None:
    """Each kernel on its solo serve phase, with the lane phases that
    launch it beside (their launches and numbers over their shapes); the
    per-shape numbers under ``shapes``, in the order of
    ``launches_by_shape``."""
    def entry(name, phase, lanes=(), **extra):
        for lane in lanes:
            extra[lane] = kernel_entry(name, tables[name], runs[lane])
            for key in ("name", "route", "source", "replaces",
                        "checked_against_plain", "max_abs_err"):
                del extra[lane][key]
        return {**kernel_entry(name, tables[name], runs[phase], **extra),
                "shapes": tables[name]}

    entries = [
        entry("flash_attention", "serve", ("lane_serve", "lane_burst",
                                           "checkpoint_serve",
                                           "residency_churn",
                                           "worker_serve")),
        entry("ring_flash_hop", "seq_serve_scan",
              library_note="no single PyTorch call computes one ring hop "
                           "with carried state; the whole ring, scan drive "
                           "included, is timed beside "
                           "scaled_dot_product_attention under "
                           "ring_flash_fused"),
        entry("ring_flash_fused", "seq_serve", ("lane_seq_serve",),
              library_note="scaled_dot_product_attention on the unsharded "
                           "attention"),
    ]
    print(json.dumps({"kernels": entries}), flush=True)


def main() -> int:
    import shutil

    torch = probe()
    # everything this run writes (checkpoints, residency.json, spools)
    # stays under the checkout and is removed when the run ends
    root = settings_root_dir()
    shutil.rmtree(root, ignore_errors=True)
    os.environ["SWARM_TPU_ROOT"] = str(root)
    try:
        return run_phases(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_phases(torch) -> int:
    build()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    b1_rows = kernel_phase(torch)
    b2_rows = ring_kernel_phase(torch)
    b3_rows = fused_kernel_phase(torch)
    check_phase(torch)
    lane_check_phase(torch)
    ring_check_phase(torch)
    # serve with PyTorch's defaults, as a worker would
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.node.registry import ModelRegistry

    registry = ModelRegistry(catalog=[{"name": "sd15", "family": "sd15"}],
                             allow_random=True, device="cuda")
    pool = ChipPool(device="cuda")
    slot = pool.slots[0]
    runs = {}
    with env(CHIASWARM_STEPPER="0"):  # the solo path
        runs["serve"], solo_blobs = serve_phase(torch, registry, slot)
        runs["seq_serve"] = seq_serve_phase(torch, "seq_serve", solo_blobs)
        runs["seq_serve_scan"] = seq_serve_phase(torch, "seq_serve_scan",
                                                 solo_blobs)
    with env(CHIASWARM_STEPPER="1"):  # the lanes, the default engine
        runs["lane_serve"], lane_blobs, lane_spans = lane_serve_phase(
            torch, registry, slot, solo_blobs)
        runs["lane_burst"], burst_blobs, burst_ips = lane_burst_phase(
            torch, registry, slot)
        runs["lane_seq_serve"] = lane_seq_serve_phase(torch)
        runs["solo_pair"] = solo_pair_phase(torch, registry, slot,
                                            lane_blobs[1], solo_blobs[1])
        runs["checkpoint_serve"], ckpt = checkpoint_serve_phase(
            torch, registry, slot, lane_blobs, lane_spans)
        runs["residency_churn"] = residency_churn_phase(torch, slot, ckpt)
        runs["worker_serve"] = worker_serve_phase(
            torch, registry, pool, lane_blobs, burst_blobs, burst_ips, ckpt)
    tables = {"flash_attention": b1_rows, "ring_flash_hop": b2_rows,
              "ring_flash_fused": b3_rows}
    check_held(runs, tables)
    kernels_line(runs, tables)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
