"""The stitch workload: a collage of earlier jobs' result images with an
HTML image map, a copy of ``chiaswarm_tpu/workloads/stitch.py`` (no device
work).

Each job's ``resultUri`` is fetched through the guarded
``node/job_args.py::download_image`` with a cap of :data:`MAX_RESULT_BYTES`
(the inputs are the system's own results, and an upscaled 2048 px PNG
legitimately passes the 3 MiB input cap; the decoded-dimension guard still
applies), thumbnailed to :data:`THUMB` px (LANCZOS) with its 1-based index
drawn at (10, 10), and pasted onto a square grid. The result is one JPEG
artifact with its thumbnail, and ``image_map`` in the config: one ``rect``
per cell, linking back to the source job.
"""

from __future__ import annotations

import math
from typing import Any

from PIL import Image, ImageDraw

from chiaswarm_tpu_torch.node.output_processor import (
    encode_image,
    make_result,
    thumbnail,
)

THUMB = 144

#: the byte cap of a fetched RESULT image
MAX_RESULT_BYTES = 32 * 1048576


def _fetch_image(url: str) -> Image.Image:
    from chiaswarm_tpu_torch.node.job_args import download_image

    return download_image(url, max_bytes=MAX_RESULT_BYTES)


def _thumb_with_label(image: Image.Image, index: int) -> Image.Image:
    img = image.copy()
    img.thumbnail((THUMB, THUMB), Image.Resampling.LANCZOS)
    draw = ImageDraw.Draw(img)
    draw.text((10, 10), str(index + 1), fill=(255, 255, 255))
    return img


def stitch_callback(slot, model_name: str, *, seed: int,
                    jobs: list[dict] | None = None,
                    images: list[Image.Image] | None = None,
                    **_ignored: Any):
    """``jobs`` carry ``resultUri`` links (the hive's schema); ``images``
    injects the pictures directly (tests)."""
    jobs = jobs or []
    if images is None:
        images = [_fetch_image(job["resultUri"]) for job in jobs]
    thumbs = [_thumb_with_label(img, i) for i, img in enumerate(images)]

    per_row = max(1, math.ceil(math.sqrt(len(thumbs))))
    canvas = Image.new("RGB", (per_row * THUMB, per_row * THUMB))
    image_map: list[dict[str, Any]] = []
    for i, img in enumerate(thumbs):
        x, y = (i % per_row) * THUMB, (i // per_row) * THUMB
        canvas.paste(img, (x, y))
        job = jobs[i] if i < len(jobs) else {}
        href = job.get("resultUri", "")
        image_map.append({
            "shape": "rect",
            "coords": f"{x},{y},{x + THUMB},{y + THUMB}",
            "href": href,
            "alt": job.get("model_name", f"Image {i + 1}"),
            "filename": job.get("fileName", href),
        })

    blob = encode_image(canvas, "image/jpeg")
    artifacts = {"primary": make_result(blob, "image/jpeg", thumbnail(canvas))}
    return artifacts, {"model_name": model_name, "image_map": image_map}
