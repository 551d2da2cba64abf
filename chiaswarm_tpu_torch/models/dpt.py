"""DPT monocular depth, the depth, normal and normalbae detector, counterpart
of ``chiaswarm_tpu/models/dpt.py`` (``DPTConfig``, ``DPT_LARGE``, ``DPT_TINY``
:30-56, ``_upsample2x`` :76-82, ``DPTViTLayer`` :85-119, ``DPTDepth``
:122-225, ``DPTDetector`` :228-272).

The network is transformers' ``DPTForDepthEstimation`` with a plain ViT
backbone (``Intel/dpt-large``: ViT-L/16 at 384 px, 577 tokens, 16 heads of
64, 24 layers): the ViT tapped at four layers; the reassemble stage (the
readout projection of each token joined with the class token, a 1x1
projection, then a transposed conv up x4 or x2, nothing, or a stride-2 conv
down); 3x3 neck convs; the fusion stage from the coarsest map (pre-activation
residual units, bilinear x2 with ``align_corners=True``, a 1x1 projection);
the head (3x3 conv, x2, 3x3 conv and ReLU, 1x1 conv and ReLU). Parameter
names are transformers' (``dpt.embeddings``, ``dpt.encoder.layer.{i}``,
``neck.*``, ``head.head.{0,2,4}``); a snapshot's ``dpt.layernorm`` and the
first fusion layer's ``residual_layer1`` are read by nothing (the fusion
stage calls its first layer without a residual) and are dropped as JAX's
converter drops them (:meth:`DPTDetector.skip`).

Attention is the plain matmul and softmax with float32 scores, as JAX's
einsum (:100-106) runs outside any Pallas kernel; at 577 tokens it is below
``ops/attention.py::FLASH_MIN_TOKENS`` anyway. Float32; on a card the
linears run in full float32 and the convolutions in TF32
(``models/annotator.py``): 19 convolutions deep.

The wrapper resizes the image to the square ViT canvas (INTER_CUBIC),
normalises with mean and std 0.5, and resizes the depth back (INTER_CUBIC);
``__call__`` min-max scales it to uint8.
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
class DPTConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 16
    backbone_out_indices: Sequence[int] = (5, 11, 17, 23)
    neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024)
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


# Intel/dpt-large
DPT_LARGE = DPTConfig()

DPT_TINY = DPTConfig(hidden_size=32, intermediate_size=64, num_layers=4,
                     num_heads=4, image_size=32, patch_size=8,
                     backbone_out_indices=(0, 1, 2, 3),
                     neck_hidden_sizes=(16, 16, 24, 24),
                     fusion_hidden_size=16)

#: convolutions on the longest path (the TF32 bar's depth): the patch
#: embedding, the coarsest map's projection, resize and neck conv, three a
#: fusion layer (a residual unit's two and the projection), the head's three
CONV_DEPTH = 4 + 4 * 3 + 3


def up2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with ``align_corners=True`` (JAX's ``_upsample2x``
    matrices; the tests hold the two equal)."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True) -> None:
        super().__init__()
        self.dense = nn.Linear(cin, cout, bias=bias)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        d = cfg.hidden_size
        self.query = nn.Linear(d, d, bias=cfg.qkv_bias)
        self.key = nn.Linear(d, d, bias=cfg.qkv_bias)
        self.value = nn.Linear(d, d, bias=cfg.qkv_bias)


class _Attention(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        self.attention = _SelfAttention(cfg)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size)


class DPTViTLayer(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(d, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, d)
        self.layernorm_before = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.heads
        h = self.layernorm_before(x)
        sa = self.attention.attention

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q, k, v = split(sa.query(h)), split(sa.key(h)), split(sa.value(h))
        scores = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        out = torch.matmul(scores.softmax(dim=-1), v)
        out = out.transpose(1, 2).reshape(b, n, d)
        x = x + self.attention.output.dense(out)
        h = self.layernorm_after(x)
        h = F.gelu(self.intermediate.dense(h))
        return x + self.output.dense(h)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        grid = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid + 1, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        self.layer = nn.ModuleList(DPTViTLayer(cfg)
                                   for _ in range(cfg.num_layers))


class _ViT(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)


class _Reassemble(nn.Module):
    def __init__(self, cfg: DPTConfig, i: int) -> None:
        super().__init__()
        ch, factor = cfg.neck_hidden_sizes[i], cfg.reassemble_factors[i]
        self.projection = nn.Conv2d(cfg.hidden_size, ch, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(ch, ch, int(factor),
                                             stride=int(factor))
        elif factor < 1:
            self.resize = nn.Conv2d(ch, ch, 3, stride=2, padding=1)
        else:
            self.resize = nn.Identity()


class _ReassembleStage(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        n = len(cfg.backbone_out_indices)
        self.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * cfg.hidden_size, cfg.hidden_size),
                          nn.GELU()) for _ in range(n))
        self.layers = nn.ModuleList(_Reassemble(cfg, i) for i in range(n))


class _ResidualUnit(nn.Module):
    """Pre-activation: ReLU, 3x3 conv, ReLU, 3x3 conv, plus the input."""

    def __init__(self, ch: int) -> None:
        super().__init__()
        self.convolution1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.convolution2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convolution1(F.relu(x))
        return x + self.convolution2(F.relu(h))


class _FusionLayer(nn.Module):
    def __init__(self, ch: int, first: bool) -> None:
        super().__init__()
        self.projection = nn.Conv2d(ch, ch, 1)
        if not first:
            self.residual_layer1 = _ResidualUnit(ch)
        self.residual_layer2 = _ResidualUnit(ch)

    def forward(self, fused: torch.Tensor | None, m: torch.Tensor
                ) -> torch.Tensor:
        fused = m if fused is None else fused + self.residual_layer1(m)
        fused = up2_align_corners(self.residual_layer2(fused))
        return self.projection(fused)


class _FusionStage(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            _FusionLayer(cfg.fusion_hidden_size, i == 0)
            for i in range(len(cfg.neck_hidden_sizes)))


class _Neck(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        self.reassemble_stage = _ReassembleStage(cfg)
        self.convs = nn.ModuleList(
            nn.Conv2d(ch, cfg.fusion_hidden_size, 3, padding=1, bias=False)
            for ch in cfg.neck_hidden_sizes)
        self.fusion_stage = _FusionStage(cfg)


class _Up2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return up2_align_corners(x)


class _Head(nn.Module):
    def __init__(self, cfg: DPTConfig) -> None:
        super().__init__()
        f = cfg.fusion_hidden_size
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), _Up2(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)


class DPTDepth(nn.Module):
    """(B, 3, S, S) normalised pixels (S = ``image_size``) -> (B, 16 S /
    patch, 16 S / patch) relative inverse depth (patch-16 checkpoints give
    (B, S, S))."""

    def __init__(self, cfg: DPTConfig = DPT_LARGE) -> None:
        super().__init__()
        self.cfg = cfg
        self.dpt = _ViT(cfg)
        self.neck = _Neck(cfg)
        self.head = _Head(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = pixel_values.shape[0]
        grid = cfg.image_size // cfg.patch_size
        emb = self.dpt.embeddings
        x = emb.patch_embeddings.projection(pixel_values)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([emb.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + emb.position_embeddings

        taps = []
        want = set(cfg.backbone_out_indices)
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in want:
                taps.append(x)

        stage = self.neck.reassemble_stage
        maps = []
        for i, state in enumerate(taps):
            cls_tok, tokens = state[:, :1], state[:, 1:]
            tokens = stage.readout_projects[i](
                torch.cat([tokens, cls_tok.expand_as(tokens)], dim=-1))
            m = tokens.transpose(1, 2).reshape(b, cfg.hidden_size, grid, grid)
            m = stage.layers[i].resize(stage.layers[i].projection(m))
            maps.append(self.neck.convs[i](m))

        fused = None
        for layer, m in zip(self.neck.fusion_stage.layers, reversed(maps)):
            fused = layer(fused, m)
        return self.head(fused)[:, 0]


class DPTDetector(Detector):
    """uint8 RGB -> relative inverse depth at the image's size
    (:meth:`depth`), or its min-max uint8 map (``__call__``)."""

    what = "DPTForDepthEstimation"

    def __init__(self, net: nn.Module, config: DPTConfig = DPT_LARGE) -> None:
        super().__init__(net)
        self.config = config

    @classmethod
    def network(cls, config: DPTConfig = DPT_LARGE) -> nn.Module:
        return DPTDepth(config)

    @staticmethod
    def skip(key: str) -> bool:
        return key.startswith(("dpt.layernorm.",
                               "neck.fusion_stage.layers.0.residual_layer1."))

    def prepare(self, image: np.ndarray):
        import cv2

        s = self.config.image_size
        resized = cv2.resize(image, (s, s), interpolation=cv2.INTER_CUBIC)
        arr = resized.astype(np.float32) / 255.0
        arr = (arr - 0.5) / 0.5  # DPT's image processor: mean .5, std .5
        return arr[None], image.shape[:2]

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> np.ndarray:
        """(1, S, S, 3) -> the (S', S') inverse depth."""
        [out] = download(self.net(upload_nhwc(x, self.device))[0])
        return out

    def finish_depth(self, out: np.ndarray, ctx) -> np.ndarray:
        """The network's depth resized to the image (INTER_CUBIC)."""
        import cv2

        h, w = ctx
        return cv2.resize(out, (w, h), interpolation=cv2.INTER_CUBIC)

    def depth(self, image: np.ndarray) -> np.ndarray:
        """uint8 RGB (H, W, 3) -> float32 relative inverse depth (H, W),
        larger = nearer."""
        x, ctx = self.prepare(image)
        return self.finish_depth(self.forward(x), ctx)

    def finish(self, out: np.ndarray, ctx) -> np.ndarray:
        d = self.finish_depth(out, ctx)
        lo, hi = float(d.min()), float(d.max())
        return ((d - lo) / max(hi - lo, 1e-6) * 255.0).astype(np.uint8)
