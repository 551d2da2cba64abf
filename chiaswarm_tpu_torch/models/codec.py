"""The EnCodec decoder (RVQ codes -> waveform), the last stage of
bark-class text to speech, counterpart of ``chiaswarm_tpu/models/codec.py``
(``CodecConfig`` :26-50, ``_causal_pad`` :53-64, the convs :67-101,
``ResnetUnit`` :104-128, ``ResidualLSTM`` :131-161, ``CodecDecoder``
:164-213).

The quantized latent is the sum of one embedding per codebook; the SEANet
decoder runs a causal conv, a residual LSTM (``nn.LSTM``: torch's gate
order i, f, g, o), then per upsampling ratio an ELU, a transposed conv and
residual units, and a final ELU and causal conv. Causal convs pad on the
left by reflection, with EnCodec's zero extension when the input is no
longer than the pad (:func:`causal_pad`); transposed convs trim
``kernel - stride`` samples on the right. Layout is NCL.

Parameter names are transformers' ``EncodecModel`` decoder's, positional
(``layers.{i}``, the ELUs holding their slots as in the checkpoint's
``ModuleList``): ``layers.{i}.conv`` (plain and transposed convs),
``layers.1.lstm.weight_ih_l{n}``, ``layers.{i}.block.{1,3}.conv``,
``layers.{i}.shortcut.conv``; the codebooks are ``codebooks.{k}`` (the
checkpoint's ``quantizer.layers.{k}.codebook.embed``). The transposed convs
take the checkpoint's kernels as they are, so ``nn.ConvTranspose1d``
computes EnCodec's own upsampling; the JAX converter carries those kernels
into a Flax ``ConvTranspose`` unflipped (``convert/from_jax.py`` flips them
on the way here, so both packages compute the same function from JAX's
params). The decoder computes in float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    n_codebooks: int = 8
    codebook_size: int = 1024
    codebook_dim: int = 128
    num_filters: int = 32
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    num_lstm_layers: int = 2
    use_conv_shortcut: bool = True
    sampling_rate: int = 24000
    dtype: str = "float32"

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.upsampling_ratios:
            hop *= r
        return hop


def causal_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Left reflect-pad along time (the last axis), zero-extending the right
    first when the input is no longer than ``pad`` (EnCodec's small-input
    rule), then cutting that extension off again."""
    if pad == 0:
        return x
    t = x.shape[-1]
    if t <= pad:
        extra = pad - t + 1
        x = F.pad(F.pad(x, (0, extra)), (pad, 0), mode="reflect")
        return x[..., :x.shape[-1] - extra]
    return F.pad(x, (pad, 0), mode="reflect")


class CausalConv1d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 dilation: int = 1) -> None:
        super().__init__()
        self.pad = (kernel - 1) * dilation
        self.conv = nn.Conv1d(in_ch, out_ch, kernel, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(causal_pad(x, self.pad))


class CausalConvTranspose1d(nn.Module):
    """A stride-``stride`` transposed conv trimmed by ``kernel - stride``
    on the right (EnCodec's causal ``trim_right_ratio`` 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int) -> None:
        super().__init__()
        self.trim = kernel - stride
        self.conv = nn.ConvTranspose1d(in_ch, out_ch, kernel, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y[..., :y.shape[-1] - self.trim] if self.trim else y


class ResnetUnit(nn.Module):
    """ELU, conv(k, dilation) to ``channels // compress``, ELU, conv(1),
    added to a 1x1-conv shortcut (or the input)."""

    def __init__(self, channels: int, kernel: int, dilation: int,
                 compress: int, use_conv_shortcut: bool) -> None:
        super().__init__()
        hidden = channels // compress
        self.block = nn.ModuleList([
            nn.ELU(), CausalConv1d(channels, hidden, kernel, dilation),
            nn.ELU(), CausalConv1d(hidden, channels, 1)])
        self.shortcut = (CausalConv1d(channels, channels, 1)
                         if use_conv_shortcut else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.block:
            h = layer(h)
        return self.shortcut(x) + h


class ResidualLSTM(nn.Module):
    """``num_layers`` LSTM layers over time, added to their input."""

    def __init__(self, channels: int, num_layers: int) -> None:
        super().__init__()
        self.lstm = nn.LSTM(channels, channels, num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.permute(2, 0, 1)  # (T, B, C)
        out, _ = self.lstm(seq)
        return (out + seq).permute(1, 2, 0)


class CodecDecoder(nn.Module):
    """(B, n_codebooks, T) int codes -> (B, T * hop_length) float32."""

    def __init__(self, config: CodecConfig) -> None:
        super().__init__()
        cfg = config
        self.config = config
        self.codebooks = nn.ModuleList(
            nn.Embedding(cfg.codebook_size, cfg.codebook_dim)
            for _ in range(cfg.n_codebooks))
        ch = 2 ** len(cfg.upsampling_ratios) * cfg.num_filters
        layers: list[nn.Module] = [
            CausalConv1d(cfg.codebook_dim, ch, cfg.kernel_size),
            ResidualLSTM(ch, cfg.num_lstm_layers)]
        for ratio in cfg.upsampling_ratios:
            layers += [nn.ELU(),
                       CausalConvTranspose1d(ch, ch // 2, 2 * ratio, ratio)]
            ch //= 2
            layers += [ResnetUnit(ch, cfg.residual_kernel_size,
                                  cfg.dilation_growth_rate ** j, cfg.compress,
                                  cfg.use_conv_shortcut)
                       for j in range(cfg.num_residual_layers)]
        layers += [nn.ELU(), CausalConv1d(ch, 1, cfg.last_kernel_size)]
        self.layers = nn.ModuleList(layers)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        x = self.codebooks[0](codes[:, 0])
        for k in range(1, self.config.n_codebooks):
            x = x + self.codebooks[k](codes[:, k])
        x = x.float().transpose(1, 2)  # (B, D, T)
        for layer in self.layers:
            x = layer(x)
        return x[:, 0].float()


def transpose_slots(config: CodecConfig) -> set[int]:
    """The ``layers`` indices of the transposed convs (after the conv and
    the LSTM, each ratio holds an ELU, the transposed conv and its
    residual units)."""
    per = 2 + config.num_residual_layers
    return {2 + r * per + 1 for r in range(len(config.upsampling_ratios))}
