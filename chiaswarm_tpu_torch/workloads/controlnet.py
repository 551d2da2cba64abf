"""ControlNet input preprocessing, counterpart of
``chiaswarm_tpu/workloads/controlnet.py`` (``preprocess_image`` :347-366,
the model-free modes :50-62 and :118-149, the detector modes and their
stand-ins :66-344).

Preprocessing is off unless the job's ``controlnet`` block sets
``preprocess``: an annotated conditioning image passes through untouched.
With it on, ``type`` picks the mode (``canny`` by default); an unknown one
raises ``ValueError``, which the executor reports as a fatal bad-request
envelope. The modes:

- ``canny``: ``cv2.Canny`` at the job's ``low_threshold`` and
  ``high_threshold`` (100 and 200 by default), three channels;
- ``tile``: the short side scaled to 1024, each side rounded to a multiple
  of 64 (at least 64), LANCZOS;
- ``pix2pix``: the image itself;
- ``shuffle``: a fixed permutation (seed 0) of the 32-pixel blocks;
- ``scribble`` and ``softedge``: HED (``models/hed.py``);
- ``mlsd``: M-LSD's wireframe (``models/mlsd.py``);
- ``lineart``: the informative-drawings generator (``models/lineart.py``);
- ``depth``: DPT's depth min-max scaled (``models/dpt.py``), and ``normal``
  and ``normalbae``: Sobel normals on that depth;
- ``seg``: UperNet's ADE20K-coloured classes (``models/upernet.py``);
- ``openpose``: the CMU body-pose skeletons (``models/openpose.py``).

A detector loads its published weights from ``model_dir(<name>)`` (``hed``,
``mlsd``, ``lineart``, ``dpt``, ``upernet``, ``openpose``) on first use and
runs on the device the job's slot serves on (``device``, ``cuda`` unless the
caller asks for the CPU). Detectors are cached per (name, device) under a
lock, since the port's multi-card pools build one slot per card; they stay
outside the residency ledger, as JAX's singletons do. With no directory,
every learned mode but openpose serves its model-free cv2 stand-in (blurred
Scharr, Hough segments, a dodge sketch, a position-prior pseudo-depth,
mean-shift posterised onto the ADE palette), logged once and cached, as in
JAX; openpose raises ``ValueError`` naming the directory. A load that raises
raises: the stand-in is served only where the directory is absent, and a
detector that fails on the card fails the job. :func:`clear_detectors`
empties the cache.
"""

from __future__ import annotations

import importlib
import logging
import threading
from typing import Any, Callable

import numpy as np
import torch
from PIL import Image

from chiaswarm_tpu_torch.workloads.ade_palette import ADE20K_PALETTE

log = logging.getLogger("chiaswarm_torch.preprocess")

#: (detector name, device) -> the loaded detector, or None for "no weights"
_DETECTORS: dict[tuple[str, str], Any] = {}
_DETECTORS_LOCK = threading.Lock()


def clear_detectors() -> None:
    """Forget every cached detector and every cached "no weights"."""
    with _DETECTORS_LOCK:
        _DETECTORS.clear()


#: detector name -> (module, class) of its ``from_checkpoint``
_DETECTOR_CLASSES = {
    "hed": ("chiaswarm_tpu_torch.models.hed", "HEDDetector"),
    "mlsd": ("chiaswarm_tpu_torch.models.mlsd", "MLSDDetector"),
    "lineart": ("chiaswarm_tpu_torch.models.lineart", "LineartDetector"),
    "dpt": ("chiaswarm_tpu_torch.models.dpt", "DPTDetector"),
    "upernet": ("chiaswarm_tpu_torch.models.upernet", "UperNetDetector"),
    "openpose": ("chiaswarm_tpu_torch.models.openpose", "OpenposeDetector"),
}


def get_detector(name: str, device: str | torch.device | None = None,
                 fallback_msg: str | None = None):
    """The detector ``name`` on ``device`` from ``model_dir(name)``, loaded
    once. With no directory: None (cached, logged once with
    ``fallback_msg``), or, with no ``fallback_msg``, ``ValueError`` naming
    the directory. A load that raises is not cached."""
    from chiaswarm_tpu_torch.core.device import resolve_device
    from chiaswarm_tpu_torch.node.registry import model_dir

    key = (name, str(torch.device("cuda" if device is None else device)))
    with _DETECTORS_LOCK:
        if key in _DETECTORS:
            return _DETECTORS[key]
        ckpt = model_dir(name)
        if ckpt.exists():
            module, cls = _DETECTOR_CLASSES[name]
            det = getattr(importlib.import_module(module),
                          cls).from_checkpoint(ckpt, resolve_device(device))
            log.info("%s detector loaded from %s on %s", name, ckpt, key[1])
        elif fallback_msg is None:
            raise ValueError(
                f"{name} preprocessing needs its published weights at "
                f"{ckpt}; no model-free stand-in serves this mode")
        else:
            log.info("no %s weights at %s; %s", name, ckpt, fallback_msg)
            det = None
        _DETECTORS[key] = det
        return det


def _gray3(channel: np.ndarray) -> Image.Image:
    return Image.fromarray(np.stack([channel] * 3, axis=-1))


def image_to_canny(image: Image.Image,
                   controlnet: dict | None = None) -> Image.Image:
    """Canny edges at the job's thresholds, as three equal channels."""
    import cv2

    controlnet = controlnet or {}
    edges = cv2.Canny(np.asarray(image),
                      int(controlnet.get("low_threshold", 100)),
                      int(controlnet.get("high_threshold", 200)))
    return _gray3(edges)


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


# ------------------------------------------------------- the stand-ins

def soft_edges_standin(arr: np.ndarray) -> np.ndarray:
    """Blurred Scharr gradient magnitude, max-scaled to uint8."""
    import cv2

    gray = cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY)
    gray = cv2.GaussianBlur(gray, (5, 5), 0)
    gx = cv2.Scharr(gray, cv2.CV_32F, 1, 0)
    gy = cv2.Scharr(gray, cv2.CV_32F, 0, 1)
    mag = np.sqrt(gx ** 2 + gy ** 2)
    return (255.0 * mag / max(float(mag.max()), 1e-6)).astype(np.uint8)


def line_segments_standin(arr: np.ndarray) -> np.ndarray:
    """Probabilistic Hough segments of the Canny edges, white on black."""
    import cv2

    gray = cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, 50, 150)
    lines = cv2.HoughLinesP(edges, 1, np.pi / 180, threshold=40,
                            minLineLength=24, maxLineGap=4)
    out = np.zeros_like(arr)
    if lines is not None:
        for x1, y1, x2, y2 in np.asarray(lines).reshape(-1, 4):
            cv2.line(out, (x1, y1), (x2, y2), (255, 255, 255), 2)
    return out


def lineart_standin(arr: np.ndarray) -> np.ndarray:
    """Dodge-blend sketch, inverted to bright lines, min-max stretched."""
    import cv2

    gray = cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY)
    blur = cv2.GaussianBlur(gray, (21, 21), 0)
    sketch = cv2.divide(gray, np.maximum(blur, 1), scale=256)
    lines = 255 - sketch  # dark strokes -> bright lines
    lines = cv2.normalize(lines, None, 0, 255, cv2.NORM_MINMAX)
    return lines.astype(np.uint8)


def pseudo_depth(arr: np.ndarray) -> np.ndarray:
    """Model-free MiDaS stand-in: vertical position prior (lower in frame ~
    nearer) blended with local sharpness (in focus ~ nearer). float [0, 1],
    1 = near."""
    import cv2

    gray = cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
    h, w = gray.shape
    position = np.linspace(0.0, 1.0, h)[:, None].repeat(w, axis=1)
    lap = np.abs(cv2.Laplacian(gray, cv2.CV_32F, ksize=5))
    sharp = cv2.GaussianBlur(lap, (0, 0), sigmaX=max(h, w) / 32.0)
    sharp = sharp / max(float(sharp.max()), 1e-6)
    depth = (0.6 * position + 0.4 * sharp).astype(np.float32)
    return cv2.GaussianBlur(depth, (0, 0), sigmaX=3.0)


def segments_standin(arr: np.ndarray) -> np.ndarray:
    """Mean-shift posterisation, each colour snapped to the nearest ADE20K
    palette row."""
    import cv2

    arr = cv2.pyrMeanShiftFiltering(cv2.cvtColor(arr, cv2.COLOR_RGB2BGR),
                                    12, 24)
    arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    flat = arr.reshape(-1, 3).astype(np.float32)
    pal = ADE20K_PALETTE.astype(np.float32)
    # ||a-b||^2 = ||a||^2 - 2 a.b + ||b||^2: (N, 151) floats, not an
    # (N, 151, 3) difference tensor
    dists = ((flat ** 2).sum(1, keepdims=True)
             - 2.0 * flat @ pal.T + (pal ** 2).sum(1)[None])
    return ADE20K_PALETTE[np.argmin(dists, axis=1)].reshape(arr.shape)


# ------------------------------------------------------ the detector modes

def image_to_soft_edges(image: Image.Image, device=None) -> Image.Image:
    """HED's soft edges (scribble, softedge), else the Scharr stand-in."""
    det = get_detector("hed", device,
                       "scribble/softedge use the gradient stand-in")
    if det is not None:
        return _gray3(det(np.asarray(image.convert("RGB"))))
    return _gray3(soft_edges_standin(np.asarray(image)))


def image_to_line_segments(image: Image.Image, device=None) -> Image.Image:
    """M-LSD's wireframe, else the Hough stand-in."""
    det = get_detector("mlsd", device, "mlsd uses the Hough-segments stand-in")
    arr = np.asarray(image)
    if det is not None:
        return _gray3(det(arr))
    return Image.fromarray(line_segments_standin(arr))


def image_to_lineart(image: Image.Image, device=None) -> Image.Image:
    """The informative-drawings line map, else the dodge-sketch stand-in."""
    det = get_detector("lineart", device,
                       "lineart uses the dodge-sketch stand-in")
    if det is not None:
        return _gray3(det(np.asarray(image.convert("RGB"))))
    return _gray3(lineart_standin(np.asarray(image)))


def depth_map(arr: np.ndarray, device=None) -> np.ndarray:
    """float depth in [0, 1] (1 = near): DPT's, min-max scaled, else the
    pseudo-depth."""
    det = get_detector("dpt", device,
                       "depth/normal use the position-prior stand-in")
    if det is not None:
        return scale_depth(det.depth(arr))
    return pseudo_depth(arr)


def scale_depth(d: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] float32."""
    lo, hi = float(d.min()), float(d.max())
    return ((d - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def depth_to_image(depth: np.ndarray) -> Image.Image:
    return _gray3((depth * 255.0).clip(0, 255).astype(np.uint8))


def normals_to_image(depth: np.ndarray) -> Image.Image:
    """Surface normals from the depth by Sobel gradients, RGB = (x, y, z) *
    0.5 + 0.5."""
    import cv2

    dx = cv2.Sobel(depth, cv2.CV_32F, 1, 0, ksize=5)
    dy = cv2.Sobel(depth, cv2.CV_32F, 0, 1, ksize=5)
    z = np.full_like(depth, 0.1)
    norm = np.sqrt(dx * dx + dy * dy + z * z)
    n = np.stack([-dx / norm, -dy / norm, z / norm], axis=-1)
    return Image.fromarray(((n * 0.5 + 0.5) * 255).clip(0, 255)
                           .astype(np.uint8))


def image_to_depth(image: Image.Image, device=None) -> Image.Image:
    return depth_to_image(depth_map(np.asarray(image), device))


def image_to_normal(image: Image.Image, device=None) -> Image.Image:
    return normals_to_image(depth_map(np.asarray(image), device))


def image_to_segments(image: Image.Image, device=None) -> Image.Image:
    """UperNet's ADE20K-coloured classes, else the posterisation stand-in."""
    det = get_detector("upernet", device,
                       "seg uses the posterization stand-in")
    if det is not None:
        return Image.fromarray(det(np.asarray(image.convert("RGB"))))
    return Image.fromarray(segments_standin(np.asarray(image)))


def image_to_openpose(image: Image.Image, device=None) -> Image.Image:
    """The CMU body-pose skeletons; no stand-in."""
    det = get_detector("openpose", device)
    return Image.fromarray(det(np.asarray(image.convert("RGB"))))


# modes that take the image alone, and modes that run a detector on a device
_MODEL_FREE: dict[str, Callable[[Image.Image], Image.Image]] = {
    "tile": image_to_tile, "pix2pix": image_passthrough,
    "shuffle": image_shuffle}
_DETECTOR_MODES: dict[str, Callable[..., Image.Image]] = {
    "scribble": image_to_soft_edges, "softedge": image_to_soft_edges,
    "mlsd": image_to_line_segments, "lineart": image_to_lineart,
    "depth": image_to_depth, "normal": image_to_normal,
    "normalbae": image_to_normal, "seg": image_to_segments,
    "openpose": image_to_openpose}
#: every ``controlnet.type`` served
MODES = ("canny", *_MODEL_FREE, *_DETECTOR_MODES)


def preprocess_image(image: Image.Image, controlnet: dict[str, Any],
                     device: str | torch.device | None = None) -> Image.Image:
    """The conditioning image for a job's ``controlnet`` block: ``image``
    itself unless ``preprocess`` is set, else its ``type``'s mode, any
    detector on ``device``."""
    kind = str(controlnet.get("type", "canny")).lower()
    if not controlnet.get("preprocess", False):
        return image
    if kind == "canny":
        return image_to_canny(image, controlnet)
    if kind in _MODEL_FREE:
        return _MODEL_FREE[kind](image)
    if kind in _DETECTOR_MODES:
        return _DETECTOR_MODES[kind](image, device)
    raise ValueError(f"controlnet preprocessor {kind!r} is not supported "
                     f"(available: {sorted(MODES)})")
