"""Line drawing, the lineart detector, counterpart of
``chiaswarm_tpu/models/lineart.py`` (``instance_norm`` :31-35,
``ReflectConv`` :42-53, ``TorchConvTranspose`` :56-80, ``ResidualBlock``
:83-92, ``LineartGenerator`` :95-114, ``LineartDetector`` :117-171).

The network is informative-drawings' ``Generator(3, 1, n_blocks)``, the one
controlnet_aux's ``LineartDetector`` wraps: a reflection-padded 7x7 stem, two
stride-2 downsamples, ``n_blocks`` residual blocks at 256 channels, two
transposed-conv upsamples and a 7x7 sigmoid head; affine-free instance norm
(eps 1e-5) and ReLU between. Parameter names are the published
``sk_model.pth``'s (``model0.1``, ``model1.{0,3}``,
``model2.{i}.conv_block.{1,5}``, ``model3.{0,3}``, ``model4.1``).

The upsamples are ``nn.ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``
on the checkpoint's (in, out, kh, kw) kernels as they are. The JAX package
runs them as input-dilated convs on kernels its converter stores flipped;
``convert/from_jax.py::lineart_state_from_flax`` undoes the flip, so both
compute the same function from JAX's params.

The wrapper fits the image onto the canvas (``models/annotator.py``),
crops and resizes the drawing back and inverts it: the generator draws dark
strokes on white, the conditioning wants white lines on black. Float32; on
a card the convolutions run in TF32: 6 + 2 x ``n_blocks`` convolutions deep.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.models.annotator import (
    Detector,
    download,
    fit_canvas,
    upload_nhwc,
)


def conv_depth(n_blocks: int) -> int:
    """Convolutions on the longest path (the TF32 bar's depth)."""
    return 6 + 2 * n_blocks


class ResidualBlock(nn.Module):
    def __init__(self, ch: int) -> None:
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(ch, ch, 3), nn.InstanceNorm2d(ch),
            nn.ReLU(), nn.ReflectionPad2d(1), nn.Conv2d(ch, ch, 3),
            nn.InstanceNorm2d(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class LineartGenerator(nn.Module):
    """(B, 3, H, W) in [0, 1] -> (B, 1, H, W) drawing in [0, 1]."""

    def __init__(self, n_blocks: int = 3) -> None:
        super().__init__()
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, 64, 7),
                                    nn.InstanceNorm2d(64), nn.ReLU())
        down = []
        for cin, cout in ((64, 128), (128, 256)):
            down += [nn.Conv2d(cin, cout, 3, stride=2, padding=1),
                     nn.InstanceNorm2d(cout), nn.ReLU()]
        self.model1 = nn.Sequential(*down)
        self.model2 = nn.Sequential(*(ResidualBlock(256)
                                      for _ in range(n_blocks)))
        up = []
        for cin, cout in ((256, 128), (128, 64)):
            up += [nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                      output_padding=1),
                   nn.InstanceNorm2d(cout), nn.ReLU()]
        self.model3 = nn.Sequential(*up)
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(64, 1, 7),
                                    nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for part in (self.model0, self.model1, self.model2, self.model3,
                     self.model4):
            x = part(x)
        return x


def n_blocks_of(state) -> int:
    """The residual blocks of a Generator state dict."""
    return sum(1 for k in state if k.endswith("conv_block.1.weight"))


class LineartDetector(Detector):
    """uint8 RGB -> uint8 white-on-black line map."""

    what = "informative-drawings Generator"

    def __init__(self, net: nn.Module, n_blocks: int = 3,
                 canvas: int = 512) -> None:
        super().__init__(net)
        self.n_blocks = n_blocks
        self.canvas = canvas

    @classmethod
    def network(cls, n_blocks: int = 3, canvas: int = 512) -> nn.Module:
        return LineartGenerator(n_blocks)

    @classmethod
    def from_state(cls, state, device=None, path="", **options):
        """The residual blocks counted from ``state`` unless given."""
        options.setdefault("n_blocks", n_blocks_of(state))
        return super().from_state(state, device, path, **options)

    def prepare(self, image: np.ndarray):
        padded, nh, nw, _ = fit_canvas(image, self.canvas)
        x = padded.astype(np.float32) / 255.0
        return x[None], (image.shape[:2], nh, nw)

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> np.ndarray:
        """(1, canvas, canvas, 3) -> the (canvas, canvas) drawing."""
        [drawing] = download(self.net(upload_nhwc(x, self.device)))
        return drawing[0, 0]

    def finish(self, drawing: np.ndarray, ctx) -> np.ndarray:
        import cv2

        (h, w), nh, nw = ctx
        drawing = cv2.resize(drawing[:nh, :nw], (w, h),
                             interpolation=cv2.INTER_LINEAR)
        # dark strokes on white -> white lines on black
        return 255 - (drawing * 255.0).clip(0, 255).astype(np.uint8)
