"""HED soft edges, the scribble and softedge detector, counterpart of
``chiaswarm_tpu/models/hed.py`` (``_BLOCKS`` :24, ``HEDBlock`` :27-40,
``HEDNetwork`` :43-60, ``HEDDetector`` :63-118).

The network is controlnet_aux's ``ControlNetHED_Apache2``: the learned
per-channel ``norm`` subtracted from 0-255 RGB, five VGG blocks of 3x3 convs
(ReLU after each; a 2x2 max pool before every block but the first) and a
1x1 side projection per block. Parameter names are the published
``ControlNetHED.pth``'s (``norm``, ``block{b}.convs.{i}``,
``block{b}.projection``), so the file loads as it is. The wrapper fits the
image onto a fixed square canvas (``models/annotator.py::fit_canvas``),
crops the pad off each side map, resizes it to the image and fuses the five
by the sigmoid of their mean, on the host as in JAX.

Float32; on a card the convolutions run in TF32 (``models/annotator.py``):
14 convolutions deep.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.annotator import (
    Detector,
    download,
    fit_canvas,
    upload_nhwc,
)

# (out_channels, n_convs) per block: the fixed ControlNetHED graph
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

#: convolutions on the longest path (the TF32 bar's depth)
CONV_DEPTH = sum(n for _, n in _BLOCKS) + 1


class DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_convs: int) -> None:
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1)
            for i in range(n_convs))
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class HEDNetwork(nn.Module):
    """(B, 3, H, W) raw RGB (0-255 floats) -> five side maps at strides 1,
    2, 4, 8 and 16, (B, 1, h, w) pre-sigmoid logits each."""

    def __init__(self) -> None:
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        cin = 3
        for b, (ch, n) in enumerate(_BLOCKS):
            setattr(self, f"block{b + 1}", DoubleConvBlock(cin, ch, n))
            cin = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x - self.norm
        sides = []
        for b in range(len(_BLOCKS)):
            if b > 0:
                x = F.max_pool2d(x, 2, 2)
            x, side = getattr(self, f"block{b + 1}")(x)
            sides.append(side)
        return sides


class HEDDetector(Detector):
    """uint8 RGB -> uint8 single-channel edge map (the sigmoid of the mean
    of the five side maps)."""

    what = "ControlNetHED"

    def __init__(self, net: nn.Module, canvas: int = 512) -> None:
        super().__init__(net)
        self.canvas = canvas

    @classmethod
    def network(cls, canvas: int = 512) -> nn.Module:
        return HEDNetwork()

    def prepare(self, image: np.ndarray):
        padded, nh, nw, _ = fit_canvas(image, self.canvas)
        return padded.astype(np.float32)[None], (image.shape[:2], nh, nw)

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> list[np.ndarray]:
        """(1, canvas, canvas, 3) -> the five side maps, (h, w) each."""
        sides = self.net(upload_nhwc(x, self.device))
        return [s[0, 0] for s in download(*sides)]

    def finish(self, sides: list[np.ndarray], ctx) -> np.ndarray:
        import cv2

        (h, w), nh, nw = ctx
        maps = []
        for m in sides:
            # crop the pad at map scale, then resize to the image
            sy = m.shape[0] / self.canvas
            sx = m.shape[1] / self.canvas
            m = m[: max(1, round(nh * sy)), : max(1, round(nw * sx))]
            maps.append(cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR))
        # the fuse: the sigmoid of the maps' mean, times 255
        fused = 1.0 / (1.0 + np.exp(-np.mean(np.stack(maps), axis=0)))
        return (fused * 255.0).clip(0, 255).astype(np.uint8)
