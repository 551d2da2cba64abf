"""The video workloads, a copy of ``chiaswarm_tpu/workloads/video.py``:
vid2vid (per-frame img2img on an SD family), txt2vid (ModelScope) and
img2vid (SVD).

vid2vid (the reference's swarm/video/pix2pix.py): the clip is fetched
through the port's guarded ``urllib`` fetch (``node/job_args.py``, http and
https only) under a 30 MiB cap, with JAX's "Input video too large"
refusals; decoded with OpenCV, subsampled by a stride above 30 fps,
resized to 512 px height (``INTER_AREA``, even width) and turned RGB, at
most 100 frames; diffused in chunks of 8 frames, each chunk one solo
``DiffusionPipeline`` call with the frames on the batch axis (one init
image per row, ``seed + start`` per chunk, ``image_guidance_scale / 5`` as
the strength, clipped to [0.05, 1]); reassembled. The envelope's safety
flag is the OR over the frames, and ``compute_cost`` is the reference's
512·512·steps·frames.

txt2vid and img2vid run ``pipelines/video.py`` through the registry's
``video_pipeline``; each refuses the other family with JAX's
``ValueError``. Every video result is the encoded container (mp4v, or VP90
for webm) with the frame-0 thumbnail, and a JPEG of frame 0. OpenCV is
imported when a clip is read or written; a node whose OpenCV cannot encode
the container raises JAX's ``ValueError`` ("cannot encode ... on this
node"), never a silent fallback.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any

import numpy as np

from chiaswarm_tpu_torch.node.output_processor import (
    encode_image,
    make_result,
    thumbnail,
)

MAX_VIDEO_BYTES = 30 * 1048576  # pix2pix.py:100-104
MAX_FRAMES = 100                # pix2pix.py:53
FRAME_HEIGHT = 512              # pix2pix.py:154-170
MAX_FPS = 30.0
FRAME_CHUNK = 8                 # frames per pipeline call


def _download_video(uri: str) -> str:
    """The clip behind ``uri`` in a temporary file: a HEAD whose
    Content-Length must be within :data:`MAX_VIDEO_BYTES`, then a GET
    streamed and cut off past the cap."""
    from chiaswarm_tpu_torch.node.job_args import (
        HEAD_READ_TIMEOUT_S,
        READ_TIMEOUT_S,
        _open,
    )

    with _open(uri, "HEAD", HEAD_READ_TIMEOUT_S) as head:
        length = int(head.headers.get("Content-Length", 0) or 0)
    if length > MAX_VIDEO_BYTES:
        raise ValueError(
            f"Input video too large. Max size is {MAX_VIDEO_BYTES} bytes; "
            f"video was {length}.")
    chunks, total = [], 0
    with _open(uri, "GET", READ_TIMEOUT_S) as response:
        while chunk := response.read(1 << 20):
            total += len(chunk)
            if total > MAX_VIDEO_BYTES:
                raise ValueError("Input video too large.")
            chunks.append(chunk)
    fd, path = tempfile.mkstemp(suffix=".mp4")
    with os.fdopen(fd, "wb") as fh:
        fh.write(b"".join(chunks))
    return path


def _read_frames(path: str) -> tuple[list[np.ndarray], float]:
    """Decode, downscale to 512 px height (even width), cap the fps by
    subsampling every k-th frame, and cap the count."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError("could not decode input video")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or MAX_FPS
    stride = max(1, int(np.ceil(src_fps / MAX_FPS)))
    fps = src_fps / stride
    frames: list[np.ndarray] = []
    index = 0
    while len(frames) < MAX_FRAMES:
        ok, frame = cap.read()
        if not ok:
            break
        if index % stride:
            index += 1
            continue
        index += 1
        h, w = frame.shape[:2]
        if h > FRAME_HEIGHT:
            new_w = int(w * FRAME_HEIGHT / h) // 2 * 2
            frame = cv2.resize(frame, (new_w, FRAME_HEIGHT),
                               interpolation=cv2.INTER_AREA)
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError("input video contained no frames")
    return frames, float(fps)


def _write_video(frames: list[np.ndarray], fps: float,
                 content_type: str) -> bytes:
    import cv2

    suffix, fourcc = ((".webm", "VP90") if "webm" in content_type
                      else (".mp4", "mp4v"))
    fd, path = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc),
                                 fps, (w, h))
        if not writer.isOpened():
            raise ValueError(f"cannot encode {content_type} on this node")
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        with open(path, "rb") as fh:
            return fh.read()
    finally:
        os.unlink(path)


def _video_artifacts(frames: list[np.ndarray], fps: float,
                     content_type: str) -> dict:
    """The encoded container with the frame-0 thumbnail, and frame 0 as a
    JPEG."""
    from PIL import Image

    blob = _write_video(frames, fps, content_type)
    frame0 = Image.fromarray(frames[0])
    thumb_bytes = thumbnail(frame0)
    return {
        "primary": make_result(blob, content_type, thumb_bytes),
        "thumbnail": make_result(encode_image(frame0, "image/jpeg"),
                                 "image/jpeg", thumb_bytes),
    }


def vid2vid_callback(slot, model_name: str, *, seed: int, registry,
                     video_uri: str = "",
                     prompt: str = "",
                     negative_prompt: str = "",
                     num_inference_steps: int = 25,
                     guidance_scale: float = 7.5,
                     strength: float = 0.6,
                     image_guidance_scale: float | None = None,
                     content_type: str = "video/mp4",
                     frames: list[np.ndarray] | None = None,
                     fps: float | None = None,
                     **_ignored: Any):
    """``frames``/``fps`` inject the clip directly (tests)."""
    from chiaswarm_tpu_torch.pipelines.diffusion import GenerateRequest
    from chiaswarm_tpu_torch.workloads.safety import check_images

    if frames is None:
        if not video_uri:
            raise ValueError("vid2vid requires video_uri")
        path = _download_video(video_uri)
        try:
            frames, fps = _read_frames(path)
        finally:
            os.unlink(path)
    fps = float(fps or 8.0)

    pipe = registry.pipeline(model_name, mesh=getattr(slot, "mesh", None))
    h, w = frames[0].shape[:2]
    if image_guidance_scale is not None:
        # the hive's remap arrives as image_guidance_scale = strength * 5
        strength = min(1.0, max(0.05, image_guidance_scale / 5.0))

    out_frames: list[np.ndarray] = []
    for start in range(0, len(frames), FRAME_CHUNK):
        chunk = frames[start:start + FRAME_CHUNK]
        req = GenerateRequest(
            prompt=prompt, negative_prompt=negative_prompt,
            steps=int(num_inference_steps),
            guidance_scale=float(guidance_scale),
            height=h, width=w, batch=len(chunk), seed=seed + start,
            init_image=np.stack(chunk), strength=float(strength))
        images, _ = pipe(req)
        out_frames.extend(images)

    artifacts = _video_artifacts(out_frames, fps, content_type)
    # the OR over the frames, the reference's vid2vid semantics
    _, safety_fields = check_images(np.stack(out_frames), model_name,
                                    pipe.c.device)
    config = {
        **safety_fields,
        "model_name": model_name,
        "frames": len(out_frames),
        "fps": fps,
        # the reference's cost model, pix2pix.py:85
        "compute_cost": 512 * 512 * int(num_inference_steps) * len(out_frames),
    }
    return artifacts, config


def _video_result(slot, pipe, model_name: str, frames: np.ndarray,
                  config: dict, elapsed: float, fps: float,
                  content_type: str) -> tuple[dict, dict]:
    from chiaswarm_tpu_torch.workloads.safety import check_images

    artifacts = _video_artifacts(list(frames), fps, content_type)
    _, safety_fields = check_images(frames, model_name, pipe.c.device)
    config.update(safety_fields)
    config.update({
        "generation_s": round(elapsed, 3),
        "frames_per_sec": round(frames.shape[0] / max(elapsed, 1e-9), 4),
        "slot": (slot.descriptor() if hasattr(slot, "descriptor")
                 else str(slot)),
    })
    return artifacts, config


def txt2vid_callback(slot, model_name: str, *, seed: int, registry,
                     prompt: str = "",
                     negative_prompt: str = "",
                     num_frames: int = 25,
                     num_inference_steps: int = 25,
                     guidance_scale: float = 9.0,
                     height: int | None = None,
                     width: int | None = None,
                     fps: float = 8.0,
                     content_type: str = "video/mp4",
                     scheduler_type: str | None = None,
                     **_ignored: Any):
    """Text-to-video (swarm/video/tx2vid.py: 25 frames, 8 fps, the
    thumbnail from frame 0)."""
    from chiaswarm_tpu_torch.pipelines.video import get_video_family

    if get_video_family(model_name).image_conditioned:
        raise ValueError(
            f"model {model_name!r} is image-conditioned (SVD-class) and "
            f"cannot serve txt2vid; send an img2vid job with a start image")
    pipe = registry.video_pipeline(model_name,
                                   mesh=getattr(slot, "mesh", None))
    t0 = time.perf_counter()
    frames, config = pipe(
        prompt or "",
        negative_prompt=negative_prompt or "",
        num_frames=int(num_frames),
        steps=int(num_inference_steps),
        guidance_scale=float(guidance_scale),
        height=height, width=width,
        seed=seed,
        scheduler=scheduler_type,
    )
    elapsed = time.perf_counter() - t0
    config["fps"] = float(fps)
    return _video_result(slot, pipe, model_name, frames, config, elapsed,
                         float(fps), content_type)


def img2vid_callback(slot, model_name: str, *, seed: int, registry,
                     image: np.ndarray,
                     num_frames: int | None = None,
                     num_inference_steps: int = 25,
                     fps: float = 7.0,
                     motion_bucket_id: int = 127,
                     noise_aug_strength: float = 0.02,
                     min_guidance_scale: float = 1.0,
                     max_guidance_scale: float = 3.0,
                     height: int | None = None,
                     width: int | None = None,
                     content_type: str = "video/mp4",
                     scheduler_type: str | None = None,
                     **_ignored: Any):
    """Image-to-video (SVD-class): the start image conditions the clip
    through the image tower's embedding and the channel-concatenated
    latents."""
    from chiaswarm_tpu_torch.pipelines.video import get_video_family

    if not get_video_family(model_name).image_conditioned:
        raise ValueError(
            f"model {model_name!r} is a text-to-video family and cannot "
            f"serve img2vid; name an SVD-class model (svd_img2vid)")
    pipe = registry.video_pipeline(model_name,
                                   mesh=getattr(slot, "mesh", None))
    t0 = time.perf_counter()
    frames, config = pipe(
        np.asarray(image),
        num_frames=num_frames,
        steps=int(num_inference_steps),
        fps=int(fps),
        motion_bucket_id=int(motion_bucket_id),
        noise_aug_strength=float(noise_aug_strength),
        min_guidance_scale=float(min_guidance_scale),
        max_guidance_scale=float(max_guidance_scale),
        height=height, width=width,
        seed=seed,
        scheduler=scheduler_type,
    )
    elapsed = time.perf_counter() - t0
    return _video_result(slot, pipe, model_name, frames, config, elapsed,
                         float(fps), content_type)
