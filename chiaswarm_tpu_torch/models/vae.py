"""AutoencoderKL, counterpart of ``chiaswarm_tpu/models/vae.py``
(``AutoencoderKL`` encode/decode :250-281, ``tiled_decode`` :282-342).

NCHW inside; diffusers' ``AutoencoderKL`` parameter names
(``encoder.down_blocks.{i}.resnets.{j}``, ``decoder.mid_block.attentions.0.
to_out.0``, top-level ``quant_conv``/``post_quant_conv``). The mid-block
attention stays on the plain ``"xla"`` path, as in the reference.
:func:`tiled_decode` decodes outputs above 1024 px tile by tile.

``encode`` takes images (B, 3, H, W) in [-1, 1] and returns scaled latents;
``decode`` takes scaled latents and returns images in [-1, 1], float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.common import (
    Conv2d32,
    GroupNorm32,
    param_dtype,
    upsample2x_nearest,
)
from chiaswarm_tpu_torch.models.configs import VAEConfig
from chiaswarm_tpu_torch.ops.attention import attention


class VaeResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(dtype))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head spatial attention in the VAE mid block."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.group_norm = GroupNorm32(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).to(self.to_q.weight.dtype)
        x = x.flatten(2).transpose(1, 2)                       # (B, HW, C)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        out = attention(q[:, :, None, :], k[:, :, None, :], v[:, :, None, :],
                        impl="xla")[:, :, 0, :]
        out = self.to_out[0](out)
        return out.transpose(1, 2).reshape(b, c, h, w) + residual


class _Block(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.resnets = nn.ModuleList()


class VaeMid(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([VaeResnetBlock(channels, channels),
                                      VaeResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([VaeAttention(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        chans = list(config.block_out_channels)
        self.conv_in = nn.Conv2d(config.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for level, ch in enumerate(chans):
            block = _Block()
            for _ in range(config.layers_per_block):
                block.resnets.append(VaeResnetBlock(prev, ch))
                prev = ch
            if level < len(chans) - 1:
                # asymmetric (0, 1) padding, applied in forward
                block.downsamplers = nn.ModuleList([_Downsample(ch)])
            self.down_blocks.append(block)
        self.mid_block = VaeMid(chans[-1])
        self.conv_norm_out = GroupNorm32(chans[-1], eps=1e-6)
        self.conv_out = Conv2d32(chans[-1], 2 * config.latent_channels, 3,
                                 padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        x = self.conv_in(x.to(dtype))
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = self.mid_block(x)
        x = F.silu(self.conv_norm_out(x)).to(dtype)
        return self.conv_out(x)


class _Downsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Upsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x_nearest(x))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        chans = list(config.block_out_channels)
        self.conv_in = nn.Conv2d(config.latent_channels, chans[-1], 3,
                                 padding=1)
        self.mid_block = VaeMid(chans[-1])
        self.up_blocks = nn.ModuleList()
        prev = chans[-1]
        for level in range(len(chans) - 1, -1, -1):
            ch = chans[level]
            block = _Block()
            for _ in range(config.layers_per_block + 1):
                block.resnets.append(VaeResnetBlock(prev, ch))
                prev = ch
            if level > 0:
                block.upsamplers = nn.ModuleList([_Upsample(ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm32(chans[0], eps=1e-6)
        self.conv_out = Conv2d32(chans[0], config.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        x = self.conv_in(z)
        x = self.mid_block(x)
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = F.silu(self.conv_norm_out(x)).to(dtype)
        return self.conv_out(x)


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2d32(2 * config.latent_channels,
                                   2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """Images -> scaled latents; with ``noise`` (standard normal, the
        latent shape) the posterior is sampled, else its mean is taken."""
        mean, logvar = self.encode_moments(x)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return mean * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dtype = param_dtype(self.decoder)
        z = self.post_quant_conv((z / self.config.scaling_factor).to(dtype))
        return self.decoder(z)


def tiled_decode(vae: AutoencoderKL, z: torch.Tensor, *, tile: int = 64,
                 overlap: int = 8) -> torch.Tensor:
    """Memory-bounded decode of scaled latents ``z`` (B, C, h, w): latent
    tiles of ``tile`` with ``overlap`` latents shared between neighbours,
    decoded one after another (the peak is one tile's activations), each
    weighted by the strictly positive ramp ``min((i + 1) / (ov + 1), 1)``
    from both edges (``ov`` the overlap in pixels), summed, and divided by
    the summed weight. Returns float32 images in [-1, 1]. A latent that one
    tile covers is the plain decode: its weight divides out."""
    b, _, h, w = z.shape
    if h <= tile and w <= tile:
        return vae.decode(z).float()
    stride = tile - overlap
    f = vae.config.downscale
    rows = max(1, -(-(h - overlap) // stride))
    cols = max(1, -(-(w - overlap) // stride))
    canvas = torch.zeros((b, vae.config.in_channels, h * f, w * f),
                         dtype=torch.float32, device=z.device)
    weight = torch.zeros((1, 1, h * f, w * f), dtype=torch.float32,
                         device=z.device)
    ov = max(overlap * f, 1)
    idx = torch.arange(tile * f, dtype=torch.float32, device=z.device)
    ramp = torch.clamp((idx + 1.0) / (ov + 1.0), max=1.0)
    edge = torch.minimum(ramp, ramp.flip(0))
    tile_w = edge[:, None] * edge[None, :]
    for i in range(rows):
        for j in range(cols):
            y0 = min(i * stride, max(h - tile, 0))
            x0 = min(j * stride, max(w - tile, 0))
            img = vae.decode(z[:, :, y0:y0 + tile, x0:x0 + tile]).float()
            th, tw = img.shape[2:]
            wt = tile_w[:th, :tw]
            ys, xs = slice(y0 * f, y0 * f + th), slice(x0 * f, x0 * f + tw)
            canvas[:, :, ys, xs] += img * wt
            weight[:, :, ys, xs] += wt
    return canvas / torch.clamp(weight, min=1e-8)


# ------------------------------------------- SVD's temporal-decoder VAE


class Conv3d32(nn.Conv3d):
    """A frame-axis conv the JAX module runs in float32."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class VaeSpatioTemporalResBlock(nn.Module):
    """The temb-free ``SpatioTemporalResBlock`` of diffusers'
    ``TemporalDecoder`` (JAX ``models/vae.py:134-160``): the spatial resnet
    at eps 1e-6, the temporal one at 1e-5 over (F, H, W), and the SWITCHED
    blend (1 - a)·spatial + a·temporal, ``mix_factor`` initialised at 0."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        from chiaswarm_tpu_torch.models.video_unet import (
            AlphaBlender,
            TemporalResnetBlock,
        )

        self.spatial_res_block = VaeResnetBlock(in_channels, out_channels)
        self.temporal_res_block = TemporalResnetBlock(out_channels, None,
                                                      1e-5)
        self.time_mixer = AlphaBlender(0.0)

    def forward(self, x: torch.Tensor, f: int) -> torch.Tensor:
        s = self.spatial_res_block(x)
        bf, c, hh, ww = s.shape
        s = s.reshape(bf // f, f, c, hh, ww).permute(0, 2, 1, 3, 4)
        t = self.temporal_res_block(s)
        a = self.time_mixer.alpha(s.dtype)
        out = (1.0 - a) * s + a * t
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class _TemporalMid(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([
            VaeSpatioTemporalResBlock(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VaeAttention(channels)])


class TemporalDecoder(nn.Module):
    """diffusers ``TemporalDecoder`` (JAX ``TemporalVaeDecoder``
    :163-221): no ``post_quant_conv``; the mid block is two spatio-temporal
    resnets around one attention, pinned to the plain path as the 2D VAE's
    is; every up resnet is spatio-temporal; ``time_conv_out``, a float32
    (3, 1, 1) conv, runs on the decoded RGB. Takes unscaled latents
    (B, F, C, h, w) and returns (B, F, 3, H, W) float32 in [-1, 1]."""

    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        if config.layers_per_block != 2:
            raise ValueError("TemporalDecoder requires layers_per_block=2 "
                             "(the published layout)")
        chans = list(config.block_out_channels)
        self.conv_in = nn.Conv2d(config.latent_channels, chans[-1], 3,
                                 padding=1)
        self.mid_block = _TemporalMid(chans[-1])
        self.up_blocks = nn.ModuleList()
        prev = chans[-1]
        for level in range(len(chans) - 1, -1, -1):
            ch = chans[level]
            block = _Block()
            for _ in range(config.layers_per_block + 1):
                block.resnets.append(VaeSpatioTemporalResBlock(prev, ch))
                prev = ch
            if level > 0:
                block.upsamplers = nn.ModuleList([_Upsample(ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm32(chans[0], eps=1e-6)
        self.conv_out = Conv2d32(chans[0], config.in_channels, 3, padding=1)
        self.time_conv_out = Conv3d32(config.in_channels, config.in_channels,
                                      (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b, f = z.shape[:2]
        dtype = self.conv_in.weight.dtype
        x = self.conv_in(z.reshape(b * f, *z.shape[2:]).to(dtype))
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, f)), f)
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x, f)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)).to(dtype))
        x = x.reshape(b, f, *x.shape[1:]).permute(0, 2, 1, 3, 4)
        return self.time_conv_out(x).permute(0, 2, 1, 3, 4)


class AutoencoderKLTemporalDecoder(nn.Module):
    """SVD's VAE (JAX :224-247): the standard encoder with its top-level
    ``quant_conv`` and the temporal decoder. ``encode_moments`` takes
    images (B, 3, H, W) and returns (mean, clipped logvar); ``decode``
    takes scaled latents (B, F, C, h, w) and returns (B, F, 3, H, W)."""

    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = TemporalDecoder(config)
        self.quant_conv = Conv2d32(2 * config.latent_channels,
                                   2 * config.latent_channels, 1)

    encode_moments = AutoencoderKL.encode_moments

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z / self.config.scaling_factor)
