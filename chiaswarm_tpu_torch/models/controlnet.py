"""ControlNet, counterpart of ``chiaswarm_tpu/models/controlnet.py``
(``ControlCondEmbedding``, ``ControlNet``).

NCHW, with diffusers ``ControlNetModel`` names, so a published checkpoint
loads with no renaming: the hint encoder ``controlnet_cond_embedding.
{conv_in, blocks.{i}, conv_out}``, the UNet's own ``conv_in``,
``time_embedding`` (``add_embedding`` for SDXL), ``down_blocks`` and
``mid_block`` (built by ``models/unet.py::UNetTrunk``, not duplicated), and
the 1x1 zero convs ``controlnet_down_blocks.{i}`` and
``controlnet_mid_block``.

The hint encoder does not depend on the timestep, so the pipeline embeds a
job's conditioning image once, outside the step loop, as JAX hoists it out
of its scan. The branch's residuals are its zero-conv outputs times
``conditioning_scale``, a float or a per-row (B, 1, 1, 1) tensor (the
lanes' rows each carry their scale), computed in float32 as JAX computes
them; they feed the UNet's ``down_residuals``/``mid_residual``. Its
spatial self-attention goes through ``ops.attention`` as the UNet's does,
so on the card the >=1024-token levels take kernel B1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.common import param_dtype
from chiaswarm_tpu_torch.models.configs import UNetConfig
from chiaswarm_tpu_torch.models.unet import UNetTrunk


def hint_channels(downscale: int) -> tuple[int, ...]:
    """The hint encoder's stage widths for a pixel-to-latent factor: one
    stride-2 stage per factor of 2 (16, 32, 96, 256 at 8)."""
    stages = max(downscale.bit_length() - 1, 0)  # log2(downscale)
    return (16, 32, 96, 256)[: stages + 1]


class ControlCondEmbedding(nn.Module):
    """Conditioning image (B, 3, H, W) in [0, 1] -> (B, C0, H/f, W/f): a
    conv, then per stage a conv and a stride-2 conv, each followed by SiLU,
    then ``conv_out``, zero-initialised in a fresh ControlNet so an
    untrained one is a no-op. Runs in its parameters' dtype (float32 in
    ``ControlNetBundle``, as the JAX module's default)."""

    def __init__(self, out_channels: int, downscale: int = 8) -> None:
        super().__init__()
        ch = hint_channels(downscale)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for i in range(len(ch) - 1):
            self.blocks.append(nn.Conv2d(ch[i], ch[i], 3, padding=1))
            self.blocks.append(nn.Conv2d(ch[i], ch[i + 1], 3, padding=1,
                                         stride=2))
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond.to(self.conv_in.weight.dtype)))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNet(UNetTrunk):
    """The control branch: the UNet's down and mid trunk from ``conv_in``
    plus the pre-embedded hint, then one zero conv per down skip and one on
    the mid output. Returns ``(down_residuals, mid_residual)``, float32."""

    def __init__(self, config: UNetConfig) -> None:
        super().__init__(config)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(ch, ch, 1) for ch in self.skip_channels)
        mid_ch = config.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid_ch, mid_ch, 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor | None,
                cond_emb: torch.Tensor,
                added_cond: dict[str, torch.Tensor] | None = None,
                conditioning_scale: float | torch.Tensor = 1.0
                ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
        dtype = param_dtype(self)
        temb = self.time_conditioning(timesteps, added_cond, dtype)
        context = (None if encoder_hidden_states is None
                   else encoder_hidden_states.to(dtype))
        x = self.conv_in(sample.to(dtype)) + cond_emb.to(dtype)
        x, skips = self.down_trunk(x, temb, context)
        x = self.mid_trunk(x, temb, context)
        # float32 times the scale (a float32 tensor or a Python float,
        # which never crosses to the card as a tensor)
        scale = conditioning_scale
        down = tuple(conv(s).float() * scale for conv, s in
                     zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(x).float() * scale
