"""The two video diffusion UNets, counterpart of
``chiaswarm_tpu/models/video_unet.py``.

:class:`UNet3D` is diffusers' ``UNet3DConditionModel`` (ModelScope
text-to-video, JAX :138-262) and :class:`UNetSpatioTemporal` diffusers'
``UNetSpatioTemporalConditionModel`` (SVD img2vid, JAX :408-522), with
diffusers' parameter names (``temp_convs``, ``temp_attentions``,
``transformer_in``, ``spatial_res_block``, ``temporal_res_block``,
``time_mixer.mix_factor``, ``temporal_transformer_blocks``,
``time_pos_embed``), so a published snapshot loads by name.

Layout: both take the clip as (B, F, C, H, W) and return the prediction in
the same layout, float32. Between blocks the activations stay folded,
(B·F, C, H, W) b-major, so the spatial modules of ``models/unet.py``
(``ResnetBlock``, ``SpatialTransformer``, ``Downsample``, ``Upsample``) run on
the frames as a batch; the text or image context rides ``CrossAttention``'s
divisible-batch expansion un-broadcast. The temporal modules take the frame
count and unfold: the (3, 1, 1) convs and the temporal GroupNorms run on the
(B, C, F, H, W) view, so their statistics span (F, H, W) per group; the
frame attention folds the sites into the batch, (B·H·W, F, C), and stays on
the plain ``"xla"`` path (``pinned``), as JAX pins it (:130-132, :357-368).
The spatial self-attentions keep the config's ``attn_impl``: on the card the
levels of 1,024 tokens or more take kernel B1.

Three GroupNorm scopes: over (F, H, W) in :class:`TemporalConvLayer`,
:class:`TemporalTransformer` and :class:`TemporalResnetBlock`; per frame in
:class:`TransformerSpatioTemporal` and the spatial blocks. Two blend
directions: the UNet's :class:`SpatioTemporalResBlock` and the
transformer mix a·spatial + (1 - a)·temporal, a = sigmoid(``mix_factor``),
initialised at 0.5; the temporal VAE decoder (``models/vae.py``) switches
them, initialised at 0.0. ``image_only_indicator`` is zero in serving, so
the blend is the sigmoid alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.common import (
    Conv2d32,
    GroupNorm32,
    LayerNorm32,
    param_dtype,
)
from chiaswarm_tpu_torch.models.configs import UNetConfig
from chiaswarm_tpu_torch.models.unet import (
    CrossAttention,
    Downsample,
    FeedForward,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedding,
    TransformerBlock,
    UNetTrunk,
    Upsample,
    timestep_embedding,
)


def frame_conv(channels: int) -> nn.Conv3d:
    """A (3, 1, 1) convolution over the frame axis of (B, C, F, H, W)."""
    return nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))


def _frames_first(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B·F, C, H, W) -> the (B, C, F, H, W) view."""
    return x.reshape(-1, f, *x.shape[1:]).permute(0, 2, 1, 3, 4)


def _frames_folded(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) -> (B·F, C, H, W)."""
    return x.permute(0, 2, 1, 3, 4).reshape(-1, x.shape[1], *x.shape[3:])


class AlphaBlender(nn.Module):
    """diffusers' learned ``AlphaBlender``: the one ``mix_factor``, kept in
    float32 (its sigmoid is cast to the activations' type)."""

    keep_fp32 = True

    def __init__(self, init: float) -> None:
        super().__init__()
        self.init = init
        self.mix_factor = nn.Parameter(torch.full((1,), init))

    def alpha(self, dtype: torch.dtype) -> torch.Tensor:
        return torch.sigmoid(self.mix_factor.float()).to(dtype)


@torch.no_grad()
def init_video_extras(module: nn.Module) -> None:
    """The published inits Flax's defaults do not give: every
    ``AlphaBlender`` at its constant and ``TemporalConvLayer.conv4`` zero
    (an untrained layer is identity)."""
    for m in module.modules():
        if isinstance(m, AlphaBlender):
            m.mix_factor.fill_(m.init)
        elif isinstance(m, TemporalConvLayer):
            m.conv4[-1].weight.zero_()
            m.conv4[-1].bias.zero_()


# --------------------------------------------------- ModelScope modules


class TemporalConvLayer(nn.Module):
    """diffusers ``TemporalConvLayer``: four (GroupNorm over (F, H, W),
    SiLU, (3, 1, 1) conv) stages and a residual; keys ``conv1.{0,2}`` and
    ``conv2..4.{0,3}`` (a Dropout sits before the conv of the last three)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv1 = nn.Sequential(GroupNorm32(channels, 1e-5), nn.SiLU(),
                                   frame_conv(channels))
        for name in ("conv2", "conv3", "conv4"):
            setattr(self, name, nn.Sequential(
                GroupNorm32(channels, 1e-5), nn.SiLU(), nn.Dropout(0.0),
                frame_conv(channels)))

    def forward(self, x: torch.Tensor, f: int) -> torch.Tensor:
        dtype = self.conv1[-1].weight.dtype
        identity = _frames_first(x, f)
        h = identity
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            h = stage[-1](F.silu(stage[0](h)).to(dtype))
        return _frames_folded(identity + h)


class TemporalTransformer(nn.Module):
    """diffusers ``TransformerTemporalModel`` (``double_self_attention``):
    GroupNorm over (F, H, W), the sites folded to (B·H·W, F, C), ONE
    transformer block whose attn1 and attn2 are both frame self-attention
    (``context=None`` falls back to the block's input), no position
    embedding, then ``proj_out`` and the residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm32(channels, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(
            inner, num_heads, head_dim, inner, "xla", pinned=True)])
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, f: int) -> torch.Tensor:
        bf, c, hh, ww = x.shape
        b = bf // f
        h = self.norm(_frames_first(x, f))                 # (B, C, F, H, W)
        h = h.permute(0, 3, 4, 2, 1).reshape(b * hh * ww, f, c).to(x.dtype)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, None)
        h = self.proj_out(h)
        h = h.reshape(b, hh, ww, f, c).permute(0, 3, 4, 1, 2)
        return x + h.reshape(bf, c, hh, ww)


class _VideoBlock(nn.Module):
    """A down/up/mid block with diffusers' lists: ``resnets``,
    ``attentions`` and, for the ModelScope layout, ``temp_convs`` and
    ``temp_attentions``."""

    def __init__(self) -> None:
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


def _skip_channels(channels: list[int], layers: int) -> list[int]:
    """The channels of the down path's skips, in order."""
    skips = [channels[0]]
    for level, ch in enumerate(channels):
        skips += [ch] * layers
        if level < len(channels) - 1:
            skips.append(ch)
    return skips


class _VideoUNet(nn.Module):
    """What both layouts share: ``conv_in``, the time conditioning of
    ``models/unet.py`` (and SVD's three-id ``add_embedding``), the output
    head, and the walk over the down, mid and up blocks."""

    time_conditioning = UNetTrunk.time_conditioning
    _added_embedding = UNetTrunk._added_embedding

    def __init__(self, config: UNetConfig) -> None:
        super().__init__()
        self.config = cfg = config
        channels = list(cfg.block_out_channels)
        self.temb_dim = channels[0] * 4
        self.conv_in = nn.Conv2d(cfg.sample_channels, channels[0], 3,
                                 padding=1)
        self.time_embedding = TimestepEmbedding(channels[0], self.temb_dim)
        if cfg.addition_embed_dim is not None:
            self.add_embedding = TimestepEmbedding(
                3 * cfg.addition_embed_dim, self.temb_dim)

    def _head(self) -> None:
        ch0 = self.config.block_out_channels[0]
        self.conv_norm_out = GroupNorm32(ch0, eps=1e-5)
        self.conv_out = Conv2d32(ch0, self.config.out_channels, 3, padding=1)

    def _levels(self, make_block) -> None:
        """Down and up blocks: ``make_block(in_ch, out_ch, level)`` appends
        one layer (resnet and whatever rides beside it) to a block."""
        cfg = self.config
        channels = list(cfg.block_out_channels)
        n = len(channels)
        self.down_blocks = nn.ModuleList()
        prev = channels[0]
        for level, ch in enumerate(channels):
            block = _VideoBlock()
            for _ in range(cfg.layers_per_block):
                make_block(block, prev, ch, level)
                prev = ch
            if level < n - 1:
                block.downsamplers = nn.ModuleList([Downsample(ch)])
            self.down_blocks.append(block)
        skips = _skip_channels(channels, cfg.layers_per_block)
        self.up_blocks = nn.ModuleList()
        for level in range(n - 1, -1, -1):
            ch = channels[level]
            block = _VideoBlock()
            for _ in range(cfg.layers_per_block + 1):
                make_block(block, prev + skips.pop(), ch, level)
                prev = ch
            if level > 0:
                block.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(block)

    def _layer(self, block: _VideoBlock, j: int, x: torch.Tensor,
               temb_f: torch.Tensor, ctx: torch.Tensor, f: int
               ) -> torch.Tensor:
        raise NotImplementedError

    def _mid(self, x: torch.Tensor, temb_f: torch.Tensor, ctx: torch.Tensor,
             f: int) -> torch.Tensor:
        raise NotImplementedError

    def _stem(self, x: torch.Tensor, f: int) -> torch.Tensor:
        return x

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_cond: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """``sample`` (B, F, C, H, W), ``timesteps`` (B,) float (continuous
        allowed), ``encoder_hidden_states`` (B, S, cross_dim) -> the
        prediction (B, F, out, H, W) float32."""
        b, f = sample.shape[:2]
        dtype = param_dtype(self)
        temb = self.time_conditioning(timesteps, added_cond, dtype)
        temb_f = temb.repeat_interleave(f, dim=0)            # (B·F, D)
        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.reshape(b * f, *sample.shape[2:]).to(dtype))
        x = self._stem(x, f)
        skips = [x]
        for block in self.down_blocks:
            for j in range(len(block.resnets)):
                x = self._layer(block, j, x, temb_f, ctx, f)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        x = self._mid(x, temb_f, ctx, f)
        for block in self.up_blocks:
            for j in range(len(block.resnets)):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self._layer(block, j, x, temb_f, ctx, f)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)).to(dtype))
        return x.reshape(b, f, *x.shape[1:])


class UNet3D(_VideoUNet):
    """ModelScope-class text-to-video UNet. Per level: resnet -> temp_conv
    -> spatial attention -> temporal attention (the attention-free level
    runs resnet -> temp_conv); ``transformer_in`` (8 heads at the stem's
    head dim, so a 512-wide inner projection at a 320-channel stem) runs
    after ``conv_in``; the mid block is resnet, temp_conv, attention,
    temporal attention, resnet, temp_conv, at depth ``max(depth) or 1``."""

    def __init__(self, config: UNetConfig) -> None:
        super().__init__(config)
        cfg = config
        channels = list(cfg.block_out_channels)
        head_dim0 = cfg.heads_for(channels[0], 0)[1]
        self.transformer_in = TemporalTransformer(channels[0], 8, head_dim0)

        def make_block(block, in_ch, ch, level):
            if not hasattr(block, "temp_convs"):
                block.temp_convs = nn.ModuleList()
                block.temp_attentions = nn.ModuleList()
            block.resnets.append(ResnetBlock(in_ch, ch, self.temb_dim))
            block.temp_convs.append(TemporalConvLayer(ch))
            depth = cfg.transformer_depth[level]
            if depth > 0:
                block.attentions.append(self._spatial(ch, level, depth))
                block.temp_attentions.append(TemporalTransformer(
                    ch, *cfg.heads_for(ch, level)))

        self._levels(make_block)
        mid_ch = channels[-1]
        mid = self.mid_block = _VideoBlock()
        mid.resnets.extend([ResnetBlock(mid_ch, mid_ch, self.temb_dim),
                            ResnetBlock(mid_ch, mid_ch, self.temb_dim)])
        mid.temp_convs = nn.ModuleList([TemporalConvLayer(mid_ch),
                                        TemporalConvLayer(mid_ch)])
        n = len(channels)
        mid.attentions.append(self._spatial(
            mid_ch, n - 1, max(cfg.transformer_depth) or 1))
        mid.temp_attentions = nn.ModuleList([TemporalTransformer(
            mid_ch, *cfg.heads_for(mid_ch, n - 1))])
        self._head()

    def _spatial(self, ch: int, level: int, depth: int) -> SpatialTransformer:
        cfg = self.config
        heads, head_dim = cfg.heads_for(ch, level)
        return SpatialTransformer(ch, depth, heads, head_dim,
                                  cfg.cross_attention_dim,
                                  cfg.use_linear_projection, cfg.attn_impl)

    def _stem(self, x, f):
        return self.transformer_in(x, f)

    def _layer(self, block, j, x, temb_f, ctx, f):
        x = block.temp_convs[j](block.resnets[j](x, temb_f), f)
        if len(block.attentions):
            x = block.attentions[j](x, ctx)
            x = block.temp_attentions[j](x, f)
        return x

    def _mid(self, x, temb_f, ctx, f):
        m = self.mid_block
        x = m.temp_convs[0](m.resnets[0](x, temb_f), f)
        x = m.temp_attentions[0](m.attentions[0](x, ctx), f)
        return m.temp_convs[1](m.resnets[1](x, temb_f), f)


# ---------------------------------------------------------- SVD modules


class TemporalResnetBlock(nn.Module):
    """diffusers ``TemporalResnetBlock``: GroupNorms over (F, H, W), (3, 1,
    1) convs and a per-frame ``time_emb_proj`` on (B, C, F, H, W); with no
    ``temb_dim`` (the temporal VAE decoder's variant) it has no projection.
    In and out channels are equal in every published layout."""

    def __init__(self, channels: int, temb_dim: int | None,
                 eps: float) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(channels, eps)
        self.conv1 = frame_conv(channels)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, channels)
        self.norm2 = GroupNorm32(channels, eps)
        self.conv2 = frame_conv(channels)

    def forward(self, x: torch.Tensor,
                temb_bf: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` (B, C, F, H, W); ``temb_bf`` (B, F, D) or None."""
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        if temb_bf is not None:
            t = self.time_emb_proj(F.silu(temb_bf))             # (B, F, C)
            h = h + t.permute(0, 2, 1)[:, :, :, None, None].to(h.dtype)
        h = self.conv2(F.silu(self.norm2(h)).to(dtype))
        return x + h


class SpatioTemporalResBlock(nn.Module):
    """diffusers ``SpatioTemporalResBlock``: the spatial resnet, the
    temporal one on its output, a·spatial + (1 - a)·temporal."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 eps: float) -> None:
        super().__init__()
        self.spatial_res_block = ResnetBlock(in_channels, out_channels,
                                             temb_dim, eps)
        self.temporal_res_block = TemporalResnetBlock(out_channels, temb_dim,
                                                      eps)
        self.time_mixer = AlphaBlender(0.5)

    def forward(self, x: torch.Tensor, temb_f: torch.Tensor,
                f: int) -> torch.Tensor:
        s = _frames_first(self.spatial_res_block(x, temb_f), f)
        t = self.temporal_res_block(s, temb_f.reshape(s.shape[0], f, -1))
        a = self.time_mixer.alpha(s.dtype)
        return _frames_folded(a * s + (1.0 - a) * t)


class TemporalBasicBlock(nn.Module):
    """diffusers ``TemporalBasicTransformerBlock`` on (B·S, F, C):
    ``norm_in`` + ``ff_in`` with a residual, frame self-attention,
    cross-attention to the one image token (``CrossAttention``'s
    one-key shortcut, the context un-broadcast over the sites), the FF."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int) -> None:
        super().__init__()
        self.norm_in = LayerNorm32(dim, eps=1e-5)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, "xla")
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim,
                                    "xla")
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, b: int,
                f: int) -> torch.Tensor:
        """``x`` (B·F, S, C) b-major; ``ctx`` (B, S_ctx, D)."""
        bf, s, c = x.shape
        dtype = x.dtype
        h = x.reshape(b, f, s, c).permute(0, 2, 1, 3).reshape(b * s, f, c)
        h = self.ff_in(self.norm_in(h).to(dtype)) + h
        h = self.attn1(self.norm1(h).to(dtype), None) + h
        h = self.attn2(self.norm2(h).to(dtype), ctx) + h
        h = self.ff(self.norm3(h).to(dtype)) + h
        return h.reshape(b, s, f, c).permute(0, 2, 1, 3).reshape(bf, s, c)


class TransformerSpatioTemporal(nn.Module):
    """diffusers ``TransformerSpatioTemporalModel``: a per-frame GroupNorm,
    ``proj_in``; per depth step the spatial block, then the temporal block
    on its output plus the frame-position embedding (``time_pos_embed``
    over ``timestep_embedding(arange(F), C)`` at the default flip and shift,
    tiled b-major), blended a·spatial + (1 - a)·temporal; ``proj_out`` and
    the residual."""

    def __init__(self, channels: int, depth: int, num_heads: int,
                 head_dim: int, context_dim: int, attn_impl: str) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm32(channels, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(inner, num_heads, head_dim, context_dim,
                             attn_impl) for _ in range(depth))
        self.temporal_transformer_blocks = nn.ModuleList(
            TemporalBasicBlock(inner, num_heads, head_dim, context_dim)
            for _ in range(depth))
        self.time_pos_embed = TimestepEmbedding(channels, channels,
                                                hidden_dim=channels * 4)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                f: int) -> torch.Tensor:
        bf, c, hh, ww = x.shape
        b = bf // f
        dtype = x.dtype
        seq = self.norm(x).permute(0, 2, 3, 1).reshape(bf, hh * ww, c)
        seq = self.proj_in(seq.to(dtype))
        frames = torch.arange(f, dtype=torch.float32, device=x.device)
        femb = self.time_pos_embed(timestep_embedding(frames, c).to(dtype))
        femb = femb.repeat(b, 1)[:, None, :]                  # (B·F, 1, C)
        a = self.time_mixer.alpha(dtype)
        for spatial, temporal in zip(self.transformer_blocks,
                                     self.temporal_transformer_blocks):
            s = spatial(seq, ctx)
            t = temporal(s + femb, ctx, b, f)
            seq = a * s + (1.0 - a) * t
        seq = self.proj_out(seq)
        return x + seq.reshape(bf, hh, ww, c).permute(0, 3, 1, 2)


class UNetSpatioTemporal(_VideoUNet):
    """SVD-class image-to-video UNet: (B, F, 8, H, W) noise latents and
    conditioning latents -> the prediction, conditioned on one image token
    and the (fps, motion bucket, noise-aug) ids through ``add_embedding``.
    Every resnet is a :class:`SpatioTemporalResBlock`, every attention a
    :class:`TransformerSpatioTemporal`; the resnets' GroupNorm eps is 1e-6
    at levels with attention and 1e-5 at the attention-free level and in
    the mid block, as published."""

    def __init__(self, config: UNetConfig) -> None:
        super().__init__(config)
        cfg = config
        channels = list(cfg.block_out_channels)

        def make_block(block, in_ch, ch, level):
            depth = cfg.transformer_depth[level]
            block.resnets.append(SpatioTemporalResBlock(
                in_ch, ch, self.temb_dim, 1e-6 if depth > 0 else 1e-5))
            if depth > 0:
                block.attentions.append(self._spatio_temporal(ch, level,
                                                              depth))

        self._levels(make_block)
        mid_ch = channels[-1]
        mid = self.mid_block = _VideoBlock()
        mid.resnets.extend(
            SpatioTemporalResBlock(mid_ch, mid_ch, self.temb_dim, 1e-5)
            for _ in range(2))
        mid.attentions.append(self._spatio_temporal(
            mid_ch, len(channels) - 1, max(cfg.transformer_depth) or 1))
        self._head()

    def _spatio_temporal(self, ch: int, level: int,
                         depth: int) -> TransformerSpatioTemporal:
        cfg = self.config
        heads, head_dim = cfg.heads_for(ch, level)
        return TransformerSpatioTemporal(ch, depth, heads, head_dim,
                                         cfg.cross_attention_dim,
                                         cfg.attn_impl)

    def _layer(self, block, j, x, temb_f, ctx, f):
        x = block.resnets[j](x, temb_f, f)
        if len(block.attentions):
            x = block.attentions[j](x, ctx, f)
        return x

    def _mid(self, x, temb_f, ctx, f):
        m = self.mid_block
        x = m.attentions[0](m.resnets[0](x, temb_f, f), ctx, f)
        return m.resnets[1](x, temb_f, f)
