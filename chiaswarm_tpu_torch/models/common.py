"""Shared building blocks, counterpart of ``chiaswarm_tpu/models/common.py``.

The JAX modules compute their norms in float32 whatever the model dtype
(``dtype=jnp.float32`` on every GroupNorm/LayerNorm) and run a few convs in
float32 (the UNet's and VAE's ``conv_out``). The port keeps those modules'
parameters in float32 when a model is cast to bf16 (:func:`cast_module`
skips any module marked ``keep_fp32``) and computes them in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

#: the additive mask value of the JAX attention modules
NEG_INF = -1e9


def mask_bias(ok: torch.Tensor) -> torch.Tensor:
    """A visibility mask -> the additive float32 bias (0 or ``NEG_INF``)."""
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def num_groups(channels: int) -> int:
    """32 GroupNorm groups when divisible (the SD standard); largest divisor
    <= 32 otherwise (tiny test widths)."""
    g = min(32, channels)
    while channels % g:
        g -= 1
    return g


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over channel dim 1, computed and returned in float32."""

    keep_fp32 = True

    def __init__(self, channels: int, eps: float) -> None:
        super().__init__(num_groups(channels), channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last dim, computed and returned in float32."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Conv2d32(nn.Conv2d):
    """A conv the JAX modules run in float32 (``dtype=jnp.float32``): its
    input is cast up and its output is float32."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to ``dtype`` except those of modules marked
    ``keep_fp32``. Returns the module."""
    for m in module.modules():
        if getattr(m, "keep_fp32", False):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def param_dtype(module: nn.Module) -> torch.dtype:
    """The compute dtype of a module: its first non-float32-pinned
    parameter's dtype (an int8 leaf's, ``convert/quantize.py``, is the
    dtype it dequantizes into)."""
    for m in module.modules():
        if getattr(m, "keep_fp32", False):
            continue
        plists = getattr(m, "parametrizations", None)
        if plists is not None:  # a quantized leaf's codes and scales
            for plist in plists.values():
                return plist[0].dtype
        if isinstance(m, parametrize.ParametrizationList):
            continue
        for p in m.parameters(recurse=False):
            return p.dtype
    return torch.float32
