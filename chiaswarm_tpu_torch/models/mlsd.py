"""M-LSD line segments, the mlsd detector, counterpart of
``chiaswarm_tpu/models/mlsd.py`` (``_MBV2_PLAN`` :35-37, ``BatchNorm``
:40-54, ``ConvBN`` :57-86, ``InvertedResidual`` :89-104,
``_align_corners_up2`` :107-127, blocks A-C :130-172, ``MLSDNetwork``
:175-200, ``decode_lines`` :203-240, ``MLSDDetector`` :243-302).

The network is mlsd_pytorch's ``MobileV2_MLSD_Large`` as the JAX package
runs it: a 4-channel MobileNetV2 trunk (stem and inverted residuals up to
the 96-channel stage; stride-2 convs pad 1 on every side), tapped at
features 1, 3, 6, 10 and 13, and a decoder of type A (1x1 merge, bilinear
x2 with ``align_corners=True``), type B (residual 3x3; no ReLU after its
second conv) and type C (dilated 3x3 head) blocks; the last 9 of its 16 maps
at half resolution are the TP map. BatchNorm applies its running statistics
folded into one affine, ``x * inv + (bias - mean * inv)`` with ``inv =
weight / sqrt(var + 1e-5)``, as JAX does. Parameter names are the published
``mlsd_large_512_fp32.pth``'s (``backbone.features.{i}``, ``block15`` to
``block23``; BatchNorm's ``num_batches_tracked`` counters are read by
nothing).

The wrapper fits the image onto the canvas (``models/annotator.py``) with
M-LSD's fourth input channel (ones before the ``/127.5 - 1`` normalisation),
decodes the segments on the host (:func:`decode_lines`, a copy of JAX's),
draws them at canvas scale and resizes the drawing back (INTER_NEAREST).
Float32; on a card the convolutions run in TF32: 54 convolutions deep.
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

# MobileNetV2 inverted-residual plan (t, c, n, s): mlsd_pytorch's subset
_MBV2_PLAN = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1)]
_FPN_TAPS = (1, 3, 6, 10, 13)  # feature indices -> c1..c5

#: convolutions on the longest path (the TF32 bar's depth): the stem, the
#: 13 inverted residuals (2 in the first, 3 in each other), the decoder's 15
CONV_DEPTH = 1 + 2 + 12 * 3 + 15


class FoldedBatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm as one affine from the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class ReLU6(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, 0.0, 6.0)


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1,
            dilation: int = 1, groups: int = 1, act: nn.Module | None = None,
            bias: bool = False) -> nn.Sequential:
    """conv (index 0), BatchNorm (1), activation (2): ReLU6 unless given."""
    pad = (kernel - 1) // 2 * dilation
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride, pad, dilation=dilation,
                  groups=groups, bias=bias),
        FoldedBatchNorm(cout), ReLU6() if act is None else act)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int) -> None:
        super().__init__()
        hidden = cin * expand
        layers = []
        if expand != 1:
            layers.append(conv_bn(cin, hidden, kernel=1))
        layers += [conv_bn(hidden, hidden, stride=stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False),
                   FoldedBatchNorm(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return x + h if self.residual else h


class MobileNetV2(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        features: list[nn.Module] = [conv_bn(4, 32, stride=2)]
        cin = 32
        for t, c, n, s in _MBV2_PLAN:
            for j in range(n):
                features.append(InvertedResidual(cin, c, s if j == 0 else 1, t))
                cin = c
        self.features = nn.ModuleList(features)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in _FPN_TAPS:
                taps.append(x)
        return taps


def up2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with ``align_corners=True`` (JAX's
    ``_align_corners_up2`` matrices; the tests hold the two equal)."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


class BlockTypeA(nn.Module):
    def __init__(self, in_c1: int, in_c2: int, out_c1: int, out_c2: int,
                 upscale: bool = True) -> None:
        super().__init__()
        self.conv1 = conv_bn(in_c2, out_c2, kernel=1, act=nn.ReLU(), bias=True)
        self.conv2 = conv_bn(in_c1, out_c1, kernel=1, act=nn.ReLU(), bias=True)
        self.upscale = upscale

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            b = up2_align_corners(b)
        return torch.cat([a, b], dim=1)


class BlockTypeB(nn.Module):
    def __init__(self, in_c: int, out_c: int) -> None:
        super().__init__()
        self.conv1 = conv_bn(in_c, in_c, act=nn.ReLU(), bias=True)
        self.conv2 = conv_bn(in_c, out_c, act=nn.Identity(), bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x) + x)


class BlockTypeC(nn.Module):
    def __init__(self, in_c: int, out_c: int) -> None:
        super().__init__()
        self.conv1 = conv_bn(in_c, in_c, dilation=5, act=nn.ReLU(), bias=True)
        self.conv2 = conv_bn(in_c, in_c, act=nn.ReLU(), bias=True)
        self.conv3 = nn.Conv2d(in_c, out_c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(self.conv2(self.conv1(x)))


class MLSDNetwork(nn.Module):
    """(B, 4, H, W) normalised input -> (B, 9, H/2, W/2) TP map."""

    def __init__(self) -> None:
        super().__init__()
        self.backbone = MobileNetV2()
        self.block15 = BlockTypeA(64, 96, 64, 64, upscale=False)
        self.block16 = BlockTypeB(128, 64)
        self.block17 = BlockTypeA(32, 64, 64, 64)
        self.block18 = BlockTypeB(128, 64)
        self.block19 = BlockTypeA(24, 64, 64, 64)
        self.block20 = BlockTypeB(128, 64)
        self.block21 = BlockTypeA(16, 64, 64, 64)
        self.block22 = BlockTypeB(128, 64)
        self.block23 = BlockTypeC(64, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3, c4, c5 = self.backbone(x)
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[:, 7:]


def decode_lines(tp_map: np.ndarray, *, score_thr: float = 0.1,
                 dist_thr: float = 0.1, top_k: int = 200) -> np.ndarray:
    """controlnet_aux's ``pred_lines`` decode of the (H/2, W/2, 9) TP map:
    sigmoid centre heat, 3x3 local-max NMS, the top-K peaks, endpoints =
    peak +- displacement, kept if the score exceeds ``score_thr`` and the
    map-space length ``dist_thr``. (N, 4) [x1, y1, x2, y2] at full (2x map)
    resolution."""
    center = tp_map[:, :, 0]
    disp = tp_map[:, :, 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    # 3x3 max filter (numpy sliding max via padded shifts)
    p = np.pad(heat, 1, mode="constant", constant_values=-np.inf)
    hmax = heat.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            hmax = np.maximum(
                hmax, p[1 + dy: 1 + dy + heat.shape[0],
                        1 + dx: 1 + dx + heat.shape[1]])
    nms = np.where(hmax == heat, heat, 0.0)
    flat = nms.reshape(-1)
    k = min(top_k, flat.size)
    top = np.argpartition(-flat, k - 1)[:k]
    top = top[np.argsort(-flat[top])]
    yy, xx = np.unravel_index(top, nms.shape)

    lines = []
    for y, x in zip(yy, xx):
        if nms[y, x] <= score_thr:
            continue
        dxs, dys, dxe, dye = disp[y, x]
        x1, y1 = x + dxs, y + dys
        x2, y2 = x + dxe, y + dye
        if np.hypot(x2 - x1, y2 - y1) > dist_thr:
            lines.append((x1 * 2, y1 * 2, x2 * 2, y2 * 2))
    return np.asarray(lines, np.float32).reshape(-1, 4)


class MLSDDetector(Detector):
    """uint8 RGB -> uint8 white-on-black wireframe."""

    what = "MobileV2_MLSD_Large"

    def __init__(self, net: nn.Module, canvas: int = 512) -> None:
        super().__init__(net)
        self.canvas = canvas

    @classmethod
    def network(cls, canvas: int = 512) -> nn.Module:
        return MLSDNetwork()

    def prepare(self, image: np.ndarray):
        padded, nh, nw, scale = fit_canvas(image, self.canvas)
        # pred_lines' input: ones (1.0, not 255) joined BEFORE the /127.5 - 1
        # normalisation, so the trained 4th channel is 1/127.5 - 1
        x = np.concatenate(
            [padded.astype(np.float32),
             np.ones(padded.shape[:2] + (1,), np.float32)],
            axis=-1) / 127.5 - 1.0
        return x[None], (image.shape[:2], nh, nw, scale)

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> np.ndarray:
        """(1, canvas, canvas, 4) -> the (canvas/2, canvas/2, 9) TP map."""
        tp = self.net(upload_nhwc(x, self.device))
        [tp] = download(tp[0].permute(1, 2, 0))
        return tp

    def finish(self, tp: np.ndarray, ctx) -> np.ndarray:
        import cv2

        (h, w), nh, nw, scale = ctx
        lines = decode_lines(tp)
        # drawn at canvas scale, thick enough to survive the downscale
        out = np.zeros((self.canvas, self.canvas), np.uint8)
        thickness = max(1, int(round(1.0 / max(scale, 1e-6))))
        for x1, y1, x2, y2 in lines:
            cv2.line(out, (int(round(x1)), int(round(y1))),
                     (int(round(x2)), int(round(y2))), 255, thickness)
        return cv2.resize(out[:nh, :nw], (w, h),
                          interpolation=cv2.INTER_NEAREST)
