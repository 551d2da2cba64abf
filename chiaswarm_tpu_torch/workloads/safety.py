"""NSFW safety checker, counterpart of ``chiaswarm_tpu/workloads/safety.py``
(``_find_checker_dir``, ``_clip_preprocess``, ``_vision_config``,
``SafetyChecker``, ``get_checker``, ``check_images`` :39-178).

Any flagged image marks the whole result ``nsfw: True``; the envelope also
carries the per-image ``nsfw_flags``. The checker is the standard CLIP
vision tower (``models/clip.py::ClipVisionEncoder``, float32 on the slot's
device) and the concept-embedding cosine head, which stays on the host in
numpy exactly as in JAX, special-care adjustment of 0.01 included. It loads
from ``<model dir>/safety_checker`` or, failing that, from
``<root>/models/CompVis__stable-diffusion-safety-checker``, a
``StableDiffusionSafetyChecker`` snapshot (``convert/checkpoint.py::
split_safety_checker``) with its ``config.json``. With no checker on the node
the result says ``nsfw: False`` and ``safety_checker: "unavailable"``, as JAX
says.

Checkers are cached in a module dict by directory (and device: the port's
multi-card pools build one slot per card), as JAX caches them: they are not
in the residency ledger, as JAX's are not. A load that raises caches None,
as in JAX, so the node answers "unavailable" for that checker from then on;
a failure once the checker is loaded (a launch on the card) raises.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

import numpy as np
import torch

from chiaswarm_tpu_torch.models.clip import ClipVisionEncoder, VisionConfig

log = logging.getLogger("chiaswarm_torch.safety")

_CACHE: dict[tuple[str, str], "SafetyChecker | None"] = {}
_CACHE_LOCK = threading.Lock()

# CLIP preprocessing constants (openai/clip-vit-large-patch14)
_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

#: the standalone checker's model name (its directory under ``models/``)
CHECKER_MODEL = "CompVis/stable-diffusion-safety-checker"


def _find_checker_dir(model_name: str | None = None) -> Path | None:
    from chiaswarm_tpu_torch.node.registry import model_dir

    candidates = []
    if model_name:
        candidates.append(model_dir(model_name) / "safety_checker")
    candidates.append(model_dir(CHECKER_MODEL))
    for cand in candidates:
        if cand.is_dir():
            return cand
    return None


def _clip_preprocess(frame: np.ndarray, size: int = 224) -> np.ndarray:
    """CLIP's shortest-edge bicubic resize and centre crop (not a squash:
    an anisotropic resize shifts cosine scores near the thresholds on
    non-square frames), normalised; (size, size, 3) float32."""
    from PIL import Image

    img = Image.fromarray(frame)
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, round(w * scale)),
                      max(size, round(h * scale))), Image.BICUBIC)
    left = (img.width - size) // 2
    top = (img.height - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - _MEAN) / _STD


def _vision_config(checker_dir: Path) -> VisionConfig:
    """``VisionConfig`` from the snapshot's own ``config.json`` (an HF
    ``CLIPConfig`` with a vision section); the ViT-L/14 defaults where it
    is absent or unreadable."""
    base = VisionConfig()
    cfg_file = checker_dir / "config.json"
    if not cfg_file.is_file():
        return base
    try:
        raw = json.loads(cfg_file.read_text())
    except (OSError, ValueError):
        return base
    vis = raw.get("vision_config") or raw.get("vision_config_dict") or {}
    return VisionConfig(
        hidden_size=int(vis.get("hidden_size", base.hidden_size)),
        intermediate_size=int(vis.get("intermediate_size",
                                      base.intermediate_size)),
        num_layers=int(vis.get("num_hidden_layers", base.num_layers)),
        num_heads=int(vis.get("num_attention_heads", base.num_heads)),
        image_size=int(vis.get("image_size", base.image_size)),
        patch_size=int(vis.get("patch_size", base.patch_size)),
        projection_dim=int(vis.get("projection_dim", base.projection_dim)),
    )


def _host(t: torch.Tensor) -> np.ndarray:
    """A buffer as numpy in its file's dtype (bf16, which numpy lacks, as
    float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class SafetyChecker:
    """The vision tower, float32 on ``device``, and the concept buffers on
    the host, read from the checker directory in one pass."""

    def __init__(self, checker_dir: str | Path,
                 device: str | torch.device | None = None) -> None:
        from chiaswarm_tpu_torch.convert.checkpoint import (
            TensorLander,
            fill_module,
            read_weights,
            split_safety_checker,
        )
        from chiaswarm_tpu_torch.core.device import resolve_device

        checker_dir = Path(checker_dir)
        self.device = resolve_device(device)
        tower_state, buffers = split_safety_checker(read_weights(checker_dir))
        self.concept_embeds = _host(buffers["concept_embeds"])
        self.concept_thresholds = _host(buffers["concept_embeds_weights"])
        self.special_embeds = _host(buffers["special_care_embeds"])
        self.special_thresholds = _host(buffers["special_care_embeds_weights"])
        self.config = _vision_config(checker_dir)
        with torch.device("meta"):
            tower = ClipVisionEncoder(self.config)
        self.tower = tower.to_empty(device=self.device)
        lander = TensorLander(self.device)
        fill_module(self.tower, "safety_checker", tower_state, lander,
                    checker_dir)
        lander.finish()
        self.tower.eval().requires_grad_(False)

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.tower.parameters())

    def preprocess(self, images: np.ndarray) -> np.ndarray:
        """uint8 (B, H, W, 3) -> (B, size, size, 3) float32 on the host."""
        return np.stack([_clip_preprocess(f, size=self.config.image_size)
                         for f in images])

    @torch.inference_mode()
    def embed(self, pixel_values: np.ndarray) -> np.ndarray:
        """Preprocessed (B, H, W, 3) pixels -> (B, projection_dim) float32
        image embeddings, computed on the checker's device."""
        from chiaswarm_tpu_torch.core.device import upload

        x = upload(torch.from_numpy(np.ascontiguousarray(pixel_values))
                   .permute(0, 3, 1, 2).contiguous(), self.device)
        return self.tower(x).cpu().numpy()

    def __call__(self, images: np.ndarray) -> list[bool]:
        """uint8 (B, H, W, 3) -> per-image nsfw flags."""
        embeds = self.embed(self.preprocess(np.asarray(images)))
        embeds = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)

        def cos(a, b):
            bn = b / np.linalg.norm(b, axis=-1, keepdims=True)
            return a @ bn.T

        special = cos(embeds, self.special_embeds)       # (B, n_special)
        concepts = cos(embeds, self.concept_embeds)      # (B, n_concepts)
        flags = []
        for i in range(embeds.shape[0]):
            # a special-care hit lowers every concept threshold
            adjustment = 0.01 if np.any(
                special[i] > self.special_thresholds) else 0.0
            flags.append(bool(np.any(
                concepts[i] > self.concept_thresholds - adjustment)))
        return flags


def get_checker(model_name: str | None = None,
                device: str | torch.device | None = None
                ) -> SafetyChecker | None:
    """The resident checker for ``model_name`` on ``device``, or None when
    no checker directory exists on this node (or its load raised)."""
    from chiaswarm_tpu_torch.core.device import resolve_device

    checker_dir = _find_checker_dir(model_name)
    if checker_dir is None:
        return None
    device = resolve_device(device)  # no card raises: it is not a load
    key = (str(checker_dir), str(device))
    with _CACHE_LOCK:
        if key not in _CACHE:
            try:
                _CACHE[key] = SafetyChecker(checker_dir, device)
                log.info("safety checker loaded from %s", checker_dir)
            except Exception as exc:  # JAX caches the failed load as None
                log.warning("safety checker at %s failed to load: %s",
                            checker_dir, exc)
                _CACHE[key] = None
        return _CACHE[key]


def check_images(images: np.ndarray, model_name: str | None = None,
                 device: str | torch.device | None = None
                 ) -> tuple[bool, dict]:
    """The OR of the per-image flags and the envelope's safety fields."""
    checker = get_checker(model_name, device)
    if checker is None:
        return False, {"nsfw": False, "safety_checker": "unavailable"}
    flags = checker(np.asarray(images))
    return any(flags), {"nsfw": any(flags), "nsfw_flags": flags}
