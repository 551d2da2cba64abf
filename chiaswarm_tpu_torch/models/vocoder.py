"""The HiFiGAN vocoder (mel spectrogram -> waveform), counterpart of
``chiaswarm_tpu/models/vocoder.py``, the last stage of txt2audio.

transformers' ``SpeechT5HifiGan`` layout: ``conv_pre`` (kernel 7) ->
per upsampling stage a leaky ReLU (slope 0.1), a transposed conv, and the
average of ``len(resblock_kernel_sizes)`` multi-receptive-field residual
blocks (each dilation: leaky ReLU, dilated conv, leaky ReLU, conv, residual
add) -> leaky ReLU -> ``conv_post`` (kernel 7) -> tanh. It computes in
float32. Weight norm is folded into the kernels at conversion. The convs
are ``SAME``-padded as in Flax; the transposed conv takes the checkpoint's
kernel as it is, with the padding that makes PyTorch's transposed conv (the
gradient of a conv, a flipped kernel) equal Flax's ``ConvTranspose``
(``padding="SAME"``, a correlation over the dilated input whose kernel the
JAX converter flips), so the output is ``T x rate`` long.

Parameter names follow the checkpoint: ``conv_pre``, ``upsampler.{i}``,
``resblocks.{i * K + j}.convs1.{d}``/``convs2.{d}`` (K kernel sizes),
``conv_post``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    model_in_dim: int = 64              # mel bins
    upsample_initial_channel: int = 512
    upsample_rates: tuple[int, ...] = (4, 4, 4, 4)
    upsample_kernel_sizes: tuple[int, ...] = (8, 8, 8, 8)
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    sampling_rate: int = 16000
    leaky_relu_slope: float = 0.1
    dtype: str = "float32"

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_rates)


def transpose_padding(kernel: int, rate: int) -> int:
    """The ``padding`` of ``nn.ConvTranspose1d(kernel, stride=rate)`` that
    equals Flax's ``SAME`` transposed conv on the flipped kernel:
    ``kernel - 1 - pad_a`` with Flax's leading pad ``pad_a``. Only
    ``kernel + rate`` even and ``rate < kernel`` give a ``T x rate`` output
    both ways (every published vocoder's)."""
    if rate >= kernel or (kernel + rate) % 2:
        raise ValueError(f"a transposed conv of kernel {kernel} at rate {rate}"
                         " has no SAME equivalent here")
    return kernel - 1 - (kernel + rate - 2) // 2


def _same(kernel: int, dilation: int = 1) -> int:
    return dilation * (kernel - 1) // 2


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations: tuple[int, ...],
                 slope: float) -> None:
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel, dilation=d,
                      padding=_same(kernel, d)) for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel, padding=_same(kernel))
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c1(F.leaky_relu(x, self.slope))
            x = x + c2(F.leaky_relu(h, self.slope))
        return x


class HifiGan(nn.Module):
    """(B, T, mel_bins) -> (B, T * hop_length) float32 waveform in [-1, 1]."""

    def __init__(self, config: HifiGanConfig) -> None:
        super().__init__()
        cfg = config
        if any(k % 2 == 0 for k in cfg.resblock_kernel_sizes):
            raise ValueError("resblock kernels must be odd for SAME padding")
        self.config = config
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.model_in_dim, ch0, 7, padding=3)
        self.upsampler = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates,
                                               cfg.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.upsampler.append(nn.ConvTranspose1d(
                ch0 // (2 ** i), ch, kernel, stride=rate,
                padding=transpose_padding(kernel, rate)))
            for ks, dil in zip(cfg.resblock_kernel_sizes,
                               cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, ks, tuple(dil),
                                               cfg.leaky_relu_slope))
        self.conv_post = nn.Conv1d(ch0 // (2 ** len(cfg.upsample_rates)), 1,
                                   7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        slope = cfg.leaky_relu_slope
        k = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.float().transpose(1, 2))
        for i, up in enumerate(self.upsampler):
            x = up(F.leaky_relu(x, slope))
            acc = self.resblocks[i * k](x)
            for j in range(1, k):
                acc = acc + self.resblocks[i * k + j](x)
            x = acc / k
        x = self.conv_post(F.leaky_relu(x, slope))
        return torch.tanh(x)[:, 0].float()
