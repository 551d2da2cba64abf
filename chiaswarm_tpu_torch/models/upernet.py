"""UperNet with a ConvNeXt backbone, the seg detector, counterpart of
``chiaswarm_tpu/models/upernet.py`` (``UperNetConfig``,
``UPERNET_CONVNEXT_SMALL``, ``UPERNET_TINY`` :30-51, ``_resize_matrix``
:54-65, ``_adaptive_pool_matrix`` :68-76, ``ConvNextLayer`` :98-120,
``BNConv`` :123-146, ``UperNetSeg`` :149-209, ``UperNetDetector`` :212-268).

The network is transformers' ``UperNetForSemanticSegmentation`` over a
ConvNeXt backbone (``openmmlab/upernet-convnext-small``: depths 3, 3, 27, 3,
widths 96 to 768, 150 ADE20K labels): the 4x4 patch stem, four stages of
ConvNeXt layers (7x7 depthwise conv, LayerNorm, MLP x4 with exact GELU,
layer scale, residual), each stage's output normalised; the PSP module over
the last stage (adaptive average pools 1, 2, 3 and 6, 1x1 conv modules,
bilinear back); the FPN top-down path; the fused 3x3 bottleneck and the 1x1
classifier, whose logits are resized to the INPUT size (HF's order) before
the argmax. A conv module is conv (no bias), inference BatchNorm from its
running statistics (eps 1e-5, in JAX's order) and ReLU. Parameter names are
transformers' (``backbone.*``, ``decode_head.*``); the ``auxiliary_head.*``
keys are dropped as JAX's converter drops them (:meth:`UperNetDetector.skip`).

Resizes are ``F.interpolate(mode="bilinear", align_corners=False)`` and the
pools ``F.adaptive_avg_pool2d``: the tests hold both to JAX's half-pixel and
window matrices. Float32; on a card the linears run in full float32 and the
convolutions in TF32 (``models/annotator.py``): 45 convolutions deep at the
published depths.

The wrapper resizes the image to the square canvas (INTER_CUBIC) with
ImageNet normalisation; the argmax runs on the device, and the uint8 class
map comes back to be resized (INTER_NEAREST) and coloured through the ADE20K
palette (row k for class k, row 0 black, as the reference maps it).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.annotator import (
    Detector,
    download,
    upload_nhwc,
)


@dataclasses.dataclass(frozen=True)
class UperNetConfig:
    # ConvNeXt backbone (openmmlab/upernet-convnext-small defaults)
    depths: Sequence[int] = (3, 3, 27, 3)
    hidden_sizes: Sequence[int] = (96, 192, 384, 768)
    layer_scale: bool = True
    # decode head
    channels: int = 512
    pool_scales: Sequence[int] = (1, 2, 3, 6)
    num_labels: int = 150
    image_size: int = 512
    dtype: str = "float32"


UPERNET_CONVNEXT_SMALL = UperNetConfig()

UPERNET_TINY = UperNetConfig(depths=(1, 1, 1, 1),
                             hidden_sizes=(8, 16, 24, 32), channels=16,
                             num_labels=10, image_size=64)

_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def conv_depth(config: UperNetConfig) -> int:
    """Convolutions on the longest path (the TF32 bar's depth): the stem,
    each ConvNeXt layer's depthwise conv, three downsamples, the PSP module,
    bottleneck, FPN conv, fused bottleneck and classifier."""
    return 1 + sum(config.depths) + 3 + 5


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Half-pixel bilinear (``align_corners=False``), the identity at the
    same size (JAX's ``resize_bilinear``)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class ChannelsFirstLayerNorm(nn.Module):
    """LayerNorm over dim 1 of NCHW (ConvNeXt's ``channels_first``)."""

    def __init__(self, ch: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class ConvNextLayer(nn.Module):
    def __init__(self, dim: int, layer_scale: bool) -> None:
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.layernorm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        if layer_scale:
            self.layer_scale_parameter = nn.Parameter(torch.ones(dim))
        else:
            self.layer_scale_parameter = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x).permute(0, 2, 3, 1)
        h = self.pwconv2(F.gelu(self.pwconv1(self.layernorm(h))))
        if self.layer_scale_parameter is not None:
            h = h * self.layer_scale_parameter
        return x + h.permute(0, 3, 1, 2)


class _Embeddings(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.patch_embeddings = nn.Conv2d(3, dim, 4, stride=4)
        self.layernorm = ChannelsFirstLayerNorm(dim)


class _Stage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, layer_scale: bool,
                 first: bool) -> None:
        super().__init__()
        self.downsampling_layer = nn.Identity() if first else nn.Sequential(
            ChannelsFirstLayerNorm(cin), nn.Conv2d(cin, dim, 2, stride=2))
        self.layers = nn.ModuleList(ConvNextLayer(dim, layer_scale)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.downsampling_layer(x)
        for layer in self.layers:
            x = layer(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: UperNetConfig) -> None:
        super().__init__()
        dims = cfg.hidden_sizes
        self.stages = nn.ModuleList(
            _Stage(dims[max(s - 1, 0)], dims[s], cfg.depths[s],
                   cfg.layer_scale, s == 0) for s in range(len(dims)))


class _Backbone(nn.Module):
    def __init__(self, cfg: UperNetConfig) -> None:
        super().__init__()
        self.embeddings = _Embeddings(cfg.hidden_sizes[0])
        self.encoder = _Encoder(cfg)
        self.hidden_states_norms = nn.ModuleDict(
            {f"stage{s + 1}": ChannelsFirstLayerNorm(dim)
             for s, dim in enumerate(cfg.hidden_sizes)})

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.embeddings.layernorm(self.embeddings.patch_embeddings(x))
        features = []
        for s, stage in enumerate(self.encoder.stages):
            x = stage(x)
            features.append(self.hidden_states_norms[f"stage{s + 1}"](x))
        return features


class ConvModule(nn.Module):
    """conv (no bias), inference BatchNorm (eps 1e-5), ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2,
                              bias=False)
        self.batch_norm = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.batch_norm
        h = self.conv(x)
        h = (h - bn.running_mean[:, None, None]) * torch.rsqrt(
            bn.running_var[:, None, None] + bn.eps)
        return F.relu(h * bn.weight[:, None, None] + bn.bias[:, None, None])


class _PoolingBlock(nn.Sequential):
    def __init__(self, scale: int, cin: int, ch: int) -> None:
        super().__init__(nn.AdaptiveAvgPool2d(scale), ConvModule(cin, ch, 1))


class _DecodeHead(nn.Module):
    def __init__(self, cfg: UperNetConfig) -> None:
        super().__init__()
        ch, dims = cfg.channels, cfg.hidden_sizes
        self.psp_modules = nn.ModuleList(_PoolingBlock(s, dims[-1], ch)
                                         for s in cfg.pool_scales)
        self.bottleneck = ConvModule(dims[-1] + len(cfg.pool_scales) * ch, ch,
                                     3)
        self.lateral_convs = nn.ModuleList(ConvModule(d, ch, 1)
                                           for d in dims[:-1])
        self.fpn_convs = nn.ModuleList(ConvModule(ch, ch, 3)
                                       for _ in dims[:-1])
        self.fpn_bottleneck = ConvModule(len(dims) * ch, ch, 3)
        self.classifier = nn.Conv2d(ch, cfg.num_labels, 1)

    def forward(self, features: list[torch.Tensor]) -> torch.Tensor:
        last = features[-1]
        psp = [last] + [resize_bilinear(block(last), last.shape[2:])
                        for block in self.psp_modules]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, features)]
        laterals.append(self.bottleneck(torch.cat(psp, dim=1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        outs = [resize_bilinear(o, outs[0].shape[2:]) for o in outs]
        return self.classifier(self.fpn_bottleneck(torch.cat(outs, dim=1)))


class UperNetSeg(nn.Module):
    """(B, 3, S, S) normalised pixels -> (B, num_labels, S, S) logits."""

    def __init__(self, cfg: UperNetConfig = UPERNET_CONVNEXT_SMALL) -> None:
        super().__init__()
        self.backbone = _Backbone(cfg)
        self.decode_head = _DecodeHead(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        logits = self.decode_head(self.backbone(pixel_values))
        # HF upsamples the logits to the input size, not a fixed canvas
        return resize_bilinear(logits, pixel_values.shape[2:])


def palette_map(classes: np.ndarray) -> np.ndarray:
    """uint8 class ids -> the ADE20K-coloured RGB map: class k is palette
    row k (row 0 black), ids past the table take its last row."""
    from chiaswarm_tpu_torch.workloads.ade_palette import ADE20K_PALETTE

    idx = np.minimum(classes.astype(np.int32), len(ADE20K_PALETTE) - 1)
    return ADE20K_PALETTE[idx]


class UperNetDetector(Detector):
    """uint8 RGB -> uint8 RGB ADE20K-coloured segmentation map."""

    what = "UperNetForSemanticSegmentation"

    def __init__(self, net: nn.Module,
                 config: UperNetConfig = UPERNET_CONVNEXT_SMALL) -> None:
        super().__init__(net)
        self.config = config

    @classmethod
    def network(cls, config: UperNetConfig = UPERNET_CONVNEXT_SMALL
                ) -> nn.Module:
        return UperNetSeg(config)

    @staticmethod
    def skip(key: str) -> bool:
        return key.startswith("auxiliary_head.")

    def prepare(self, image: np.ndarray):
        import cv2

        s = self.config.image_size
        resized = cv2.resize(image, (s, s), interpolation=cv2.INTER_CUBIC)
        arr = (resized.astype(np.float32) / 255.0 - _MEAN) / _STD
        return arr[None], image.shape[:2]

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> np.ndarray:
        """(1, S, S, 3) -> the (S, S) uint8 class map (the argmax on the
        device: the logits never leave it)."""
        logits = self.net(upload_nhwc(x, self.device))
        [classes] = download(logits[0].argmax(dim=0).to(torch.uint8))
        return classes

    def finish(self, classes: np.ndarray, ctx) -> np.ndarray:
        import cv2

        h, w = ctx
        return palette_map(cv2.resize(classes, (w, h),
                                      interpolation=cv2.INTER_NEAREST))
