"""ControlNet input preprocessing on the host, counterpart of
``chiaswarm_tpu/workloads/controlnet.py`` (``preprocess_image`` :347-366 and
the model-free modes ``canny`` :50-62, ``tile`` :118-127, ``pix2pix``
:130-132, ``shuffle`` :135-149).

Preprocessing is off unless the job's ``controlnet`` block sets
``preprocess``: an annotated conditioning image passes through untouched.
With it on, ``type`` picks the mode (``canny`` by default):

- ``canny``: ``cv2.Canny`` with the job's ``low_threshold`` and
  ``high_threshold`` (100 and 200 by default), three channels. ``cv2`` is
  imported when the mode runs, as in JAX; the card's machine has it.
- ``tile``: the short side scaled to 1024, each side rounded to a multiple
  of 64 (at least 64), LANCZOS.
- ``pix2pix``: the image itself.
- ``shuffle``: a fixed permutation (seed 0) of the 32-pixel blocks.

The learned detectors (scribble, softedge, depth, normal, normalbae, seg,
mlsd, lineart, openpose) and their cv2 stand-ins wait for ROADMAP queue item
6; such a mode raises ``ValueError`` naming it, which the executor reports
as a fatal bad-request envelope.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
from PIL import Image

#: the JAX package's learned modes, ported with ROADMAP queue item 6
LATER_MODES = ("scribble", "softedge", "depth", "normal", "normalbae",
               "seg", "mlsd", "lineart", "openpose")


def image_to_canny(image: Image.Image,
                   controlnet: dict | None = None) -> Image.Image:
    """Canny edges at the job's thresholds, as three equal channels."""
    import cv2

    controlnet = controlnet or {}
    edges = cv2.Canny(np.asarray(image),
                      int(controlnet.get("low_threshold", 100)),
                      int(controlnet.get("high_threshold", 200)))
    return Image.fromarray(np.stack([edges] * 3, axis=-1))


def image_to_tile(image: Image.Image, resolution: int = 1024) -> Image.Image:
    """The short side scaled to ``resolution`` (small inputs grow: tile
    conditioning wants detail at the output's scale), each side rounded to
    the nearest multiple of 64."""
    w, h = image.size
    k = float(resolution) / min(h, w)
    w = max(64, int(round(w * k / 64.0)) * 64)
    h = max(64, int(round(h * k / 64.0)) * 64)
    return image.resize((w, h), Image.Resampling.LANCZOS)


def image_passthrough(image: Image.Image) -> Image.Image:
    return image


def image_shuffle(image: Image.Image) -> Image.Image:
    """Content shuffle: the 32-pixel blocks permuted (seed 0)."""
    rng = np.random.default_rng(0)
    arr = np.asarray(image).copy()
    h, w = arr.shape[:2]
    bs = 32
    blocks = [(y, x) for y in range(0, h - bs + 1, bs)
              for x in range(0, w - bs + 1, bs)]
    perm = rng.permutation(len(blocks))
    out = arr.copy()
    for (y, x), p in zip(blocks, perm):
        sy, sx = blocks[p]
        out[y:y + bs, x:x + bs] = arr[sy:sy + bs, sx:sx + bs]
    return Image.fromarray(out)


_PREPROCESSORS: dict[str, Callable[..., Image.Image]] = {
    "canny": lambda image, controlnet: image_to_canny(image, controlnet),
    "tile": lambda image, controlnet: image_to_tile(image),
    "pix2pix": lambda image, controlnet: image_passthrough(image),
    "shuffle": lambda image, controlnet: image_shuffle(image),
}


def preprocess_image(image: Image.Image,
                     controlnet: dict[str, Any]) -> Image.Image:
    """The conditioning image for a job's ``controlnet`` block: ``image``
    itself unless ``preprocess`` is set, else its ``type``'s mode."""
    kind = str(controlnet.get("type", "canny")).lower()
    if not controlnet.get("preprocess", False):
        return image
    fn = _PREPROCESSORS.get(kind)
    if fn is None:
        if kind in LATER_MODES:
            raise ValueError(
                f"controlnet preprocessor {kind!r} is not served by "
                "chiaswarm_tpu_torch yet (ROADMAP queue item 6, a later "
                "slice of the port)")
        raise ValueError(
            f"controlnet preprocessor {kind!r} is not supported "
            f"(available: {sorted(_PREPROCESSORS)})")
    return fn(image, controlnet)
