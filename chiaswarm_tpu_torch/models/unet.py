"""Conditional diffusion UNet, counterpart of ``chiaswarm_tpu/models/unet.py``
(``UNet`` :34-492), SD1.x/SD2.x and SDXL paths.

NCHW inside (the JAX module is NHWC; the tests transpose at the seam).
Parameter names are diffusers' ``UNet2DConditionModel`` names
(``down_blocks.{i}.resnets.{j}.conv1``, ``...attentions.{j}.transformer_blocks.
{k}.attn1.to_out.0``, ``up_blocks.{i}.upsamplers.0.conv`` ...), so a published
checkpoint loads with no renaming. Numerics follow the JAX module: norms in
float32 then cast to the model dtype, ``conv_out`` in float32, exact-erf
GEGLU, the one-key cross-attention shortcut and the context un-broadcast.

Spatial self-attention goes through ``ops.attention`` with the config's
``attn_impl``, so on the GPU the >=1024-token levels take kernel B1; text
cross-attention is pinned to the plain ``"xla"`` path, as in the reference.

SDXL's added conditioning (``time_conditioning`` :289-310) is the
``add_embedding`` MLP over concat(pooled text, sinusoidal time ids), added
to the time embedding; the SVD-class variant without a pooled branch comes
with it.

The time conditioning, the down trunk and the mid block (JAX
``time_conditioning``/``down_trunk``/``mid_trunk`` :251-353) live in
:class:`UNetTrunk`, which the ControlNet (``models/controlnet.py``) shares,
so both keep diffusers' names. ControlNet residuals (``down_residuals``,
``mid_residual``, JAX :359, :396-457) are added to the skips and to the mid
block's output; each sum is cast back to the model dtype, as diffusers adds
them (JAX keeps a bf16 model's sums in float32 from there on; in float32 the
two are the same). The 8-channel input of instruct-pix2pix and the x2
latent upscaler is the config's ``sample_channels``.

AudioLDM's UNet (JAX ``time_conditioning`` :275-288, ``TransformerBlock``
:170-190): ``class_proj_dim`` adds ``class_embedding``, a Linear over float
class labels (the L2-normalised CLAP text embedding, diffusers'
``simple_projection``); with ``class_embeddings_concat`` it is concatenated
after the time embedding, so every resnet's ``time_emb_proj`` takes twice
the time embedding's width, else added to it. ``cross_attention_dim=None``
gives transformer blocks with no ``norm2``/``attn2`` (self-attention and
feed-forward only).

The SD x4 upscaler's noise level (JAX :266-274): ``num_class_embeds`` adds
``class_embedding``, an ``nn.Embedding(num_class_embeds, time_dim)`` whose
row at each integer class label is added to the time embedding; such a
family raises without labels, as in JAX. Not ported: the DeepCache seam.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.common import (
    Conv2d32,
    GroupNorm32,
    LayerNorm32,
    param_dtype,
    upsample2x_nearest,
)
from chiaswarm_tpu_torch.models.configs import UNetConfig
from chiaswarm_tpu_torch.ops.attention import attention


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, (B,) -> (B, dim), float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = (torch.cat([cos, sin], dim=-1) if flip_sin_to_cos
           else torch.cat([sin, cos], dim=-1))
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer MLP; ``hidden_dim`` is diffusers' ``out_dim`` variant (SVD's
    ``time_pos_embed``: C -> 4C -> C), None keeps both layers at
    ``out_dim``."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dim: int | None = None) -> None:
        super().__init__()
        hidden = hidden_dim or out_dim
        self.linear_1 = nn.Linear(in_dim, hidden)
        self.linear_2 = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm32(out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = F.silu(self.norm1(x)).to(dtype)
        h = self.conv1(h)
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = F.silu(self.norm2(h)).to(dtype)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int) -> None:
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        # exact (erf) gelu, as diffusers' GEGLU
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.0.proj`` / ``net.2`` as in diffusers."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        inner = dim * 4
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class CrossAttention(nn.Module):
    """Attention with to_q/to_k/to_v/to_out heads.

    Context-batch contract (as the JAX module's): ``context.shape[0]`` equals
    the query batch or divides it, query rows ordered context-major.
    """

    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int, attn_impl: str = "auto") -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.attn_impl = attn_impl
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None) -> torch.Tensor:
        context = x if context is None else context
        inner = self.num_heads * self.head_dim
        b, l, _ = x.shape
        bc, s = context.shape[:2]
        v = self.to_v(context)
        if s == 1:
            # softmax over a single key is identically 1: the attended value
            # is the value row itself, broadcast over every query position
            out = self.to_out[0](v)
            out = out.reshape(bc, 1, 1, inner).expand(bc, b // bc, l, inner)
            return out.reshape(b, l, inner)
        q = self.to_q(x)
        k = self.to_k(context)
        if bc != b:
            # un-broadcast per-sample context: expand k/v after projection
            k = k[:, None].expand(bc, b // bc, s, inner).reshape(b, s, inner)
            v = v[:, None].expand(bc, b // bc, s, inner).reshape(b, s, inner)
        q = q.reshape(b, l, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.num_heads, self.head_dim)
        v = v.reshape(b, s, self.num_heads, self.head_dim)
        out = attention(q, k, v, impl=self.attn_impl).reshape(b, l, inner)
        return self.to_out[0](out)


class TransformerBlock(nn.Module):
    """Self-attention, cross-attention and GEGLU feed-forward. A ``pinned``
    block (the video UNets' frame attention) keeps its ``attn_impl`` when
    ``set_attn_impl`` steers the spatial ones."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int | None, attn_impl: str,
                 pinned: bool = False) -> None:
        super().__init__()
        self.pinned = pinned
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, attn_impl)
        self.has_cross_attn = context_dim is not None
        if self.has_cross_attn:
            self.norm2 = LayerNorm32(dim, eps=1e-5)
            # text cross-attention (77 keys) stays on the plain path
            self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim,
                                        "xla")
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None) -> torch.Tensor:
        dtype = x.dtype
        x = x + self.attn1(self.norm1(x).to(dtype), None)
        if self.has_cross_attn:
            x = x + self.attn2(self.norm2(x).to(dtype), context)
        return x + self.ff(self.norm3(x).to(dtype))


class SpatialTransformer(nn.Module):
    """GroupNorm -> project -> depth x TransformerBlock -> project + residual."""

    def __init__(self, channels: int, depth: int, num_heads: int,
                 head_dim: int, context_dim: int | None,
                 use_linear_projection: bool, attn_impl: str) -> None:
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm32(channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(channels, num_heads, head_dim, context_dim,
                             attn_impl)
            for _ in range(depth))

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).to(residual.dtype)
        if self.use_linear_projection:
            x = self.proj_in(x.flatten(2).transpose(1, 2))
        else:
            x = self.proj_in(x).flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).transpose(1, 2).reshape(b, c, h, w)
        else:
            x = self.proj_out(x.transpose(1, 2).reshape(b, c, h, w))
        return x + residual


class Downsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x_nearest(x))


class _Block(nn.Module):
    """A down/up/mid block: the diffusers container with ``resnets``,
    ``attentions`` and ``downsamplers``/``upsamplers`` lists."""

    def __init__(self) -> None:
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNetTrunk(nn.Module):
    """The part of the UNet a ControlNet shares: ``conv_in``, the time
    embedding (and SDXL's ``add_embedding``), the down blocks and the mid
    block, with diffusers' names. ``skip_channels`` lists the channels of
    the down trunk's skips, in order."""

    def __init__(self, config: UNetConfig) -> None:
        super().__init__()
        self.config = config
        cfg = config
        channels = list(cfg.block_out_channels)
        n = len(channels)
        time_dim = channels[0] * 4
        self.conv_in = nn.Conv2d(cfg.sample_channels, channels[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(channels[0], time_dim)
        if cfg.num_class_embeds is not None:
            self.class_embedding = nn.Embedding(cfg.num_class_embeds,
                                                time_dim)
        if cfg.class_proj_dim is not None:
            self.class_embedding = nn.Linear(cfg.class_proj_dim, time_dim)
        # the width of the embedding every resnet projects
        self.temb_dim = temb_dim = time_dim * (
            2 if cfg.class_proj_dim is not None
            and cfg.class_embeddings_concat else 1)
        if cfg.addition_embed_dim is not None:
            n_ids = 6 if cfg.addition_pooled_dim is not None else 3
            add_in = n_ids * cfg.addition_embed_dim + (
                cfg.addition_pooled_dim or 0)
            self.add_embedding = TimestepEmbedding(add_in, time_dim)

        self.down_blocks = nn.ModuleList()
        self.skip_channels = [channels[0]]
        prev = channels[0]
        for level, ch in enumerate(channels):
            block = _Block()
            depth = cfg.transformer_depth[level]
            for _ in range(cfg.layers_per_block):
                block.resnets.append(ResnetBlock(prev, ch, temb_dim))
                if depth > 0:
                    block.attentions.append(
                        self._transformer(ch, level, depth))
                prev = ch
                self.skip_channels.append(ch)
            if level < n - 1:
                block.downsamplers = nn.ModuleList([Downsample(ch)])
                self.skip_channels.append(ch)
            self.down_blocks.append(block)

        mid_ch = channels[-1]
        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock(mid_ch, mid_ch, temb_dim))
        self.mid_block.attentions.append(
            self._transformer(mid_ch, n - 1, max(cfg.transformer_depth) or 1))
        self.mid_block.resnets.append(ResnetBlock(mid_ch, mid_ch, temb_dim))

    def _transformer(self, ch: int, level: int,
                     depth: int) -> SpatialTransformer:
        cfg = self.config
        heads, head_dim = cfg.heads_for(ch, level)
        return SpatialTransformer(ch, depth, heads, head_dim,
                                  cfg.cross_attention_dim,
                                  cfg.use_linear_projection, cfg.attn_impl)

    def time_conditioning(self, timesteps: torch.Tensor,
                          added_cond: dict[str, torch.Tensor] | None,
                          dtype: torch.dtype,
                          class_labels: torch.Tensor | None = None
                          ) -> torch.Tensor:
        """The time embedding, with the x4 upscaler's table row of the
        integer ``class_labels`` (B,), AudioLDM's class embedding of the
        float ``class_labels`` (B, class_proj_dim) and SDXL's added
        conditioning."""
        cfg = self.config
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))
        if cfg.num_class_embeds is not None:
            if class_labels is None:
                raise ValueError("this family requires class_labels "
                                 "(e.g. the x4-upscaler noise level)")
            temb = temb + self.class_embedding(class_labels.long()).to(dtype)
        if cfg.class_proj_dim is not None:
            if class_labels is None:
                raise ValueError("this family requires float class_labels "
                                 "(e.g. AudioLDM's projected text embedding)")
            class_emb = self.class_embedding(class_labels.to(dtype))
            temb = (torch.cat([temb, class_emb], dim=-1)
                    if cfg.class_embeddings_concat else temb + class_emb)
        if cfg.addition_embed_dim is not None:
            temb = temb + self._added_embedding(added_cond, dtype)
        return temb

    def down_trunk(self, x: torch.Tensor, temb: torch.Tensor,
                   context: torch.Tensor | None
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """From the post-``conv_in`` activation: (x, skips)."""
        skips = [x]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        return x, skips

    def mid_trunk(self, x: torch.Tensor, temb: torch.Tensor,
                  context: torch.Tensor | None) -> torch.Tensor:
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        return self.mid_block.resnets[1](x, temb)

    def _added_embedding(self, added_cond: dict[str, torch.Tensor] | None,
                         dtype: torch.dtype) -> torch.Tensor:
        """``add_embedding`` over the micro-conditioning: ``time_ids`` (B, K)
        sin-embedded in float32 at ``addition_embed_dim`` each (SDXL: 6
        ids, the pooled ``text_embeds`` (B, P) before them; SVD-class: 3
        ids alone), concatenated in float32, cast to the model dtype."""
        cfg = self.config
        if added_cond is None:
            raise ValueError("this family requires added_cond "
                             "(time_ids [+ text_embeds])")
        time_ids = added_cond["time_ids"]
        b = time_ids.shape[0]
        ids_emb = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_embed_dim,
            cfg.flip_sin_to_cos, cfg.freq_shift).reshape(b, -1)
        if cfg.addition_pooled_dim is not None:
            add = torch.cat([added_cond["text_embeds"].float(), ids_emb],
                            dim=-1)
        else:
            add = ids_emb
        return self.add_embedding(add.to(dtype))


class UNet(UNetTrunk):
    """Returns the model prediction (epsilon/v per family), float32, for
    NCHW latents ``sample`` (B, C, H, W), ``timesteps`` (B,) float (fractional
    allowed) and ``encoder_hidden_states`` (B|divisor, S, cross_dim; None
    for a family without cross-attention). ``down_residuals``/
    ``mid_residual`` take a ControlNet's residuals; ``class_labels`` the
    x4 upscaler's integer noise levels (B,) or AudioLDM's float
    conditioning (B, class_proj_dim).

    The DeepCache seam (JAX ``models/unet.py`` :360-491): ``return_deep``
    runs the full network and also returns the activation entering the
    level-0 up block (the level-1 upsample's output, (B, C1, h, w) with
    C1 = ``block_out_channels[1]``), the cache-refresh eval; ``cached_deep``
    (that activation) runs the shallow replay: ``conv_in`` and the level-0
    down blocks (they feed the level-0 skips), then the cache in place of
    every deeper level, the mid block and the deeper up path, then the
    level-0 up blocks. A ControlNet's residuals reach only the level-0 skips
    there."""

    def __init__(self, config: UNetConfig) -> None:
        super().__init__(config)
        cfg = config
        channels = list(cfg.block_out_channels)
        n = len(channels)
        temb_dim = self.temb_dim
        skip_channels = list(self.skip_channels)
        prev = channels[-1]
        self.up_blocks = nn.ModuleList()
        for level in range(n - 1, -1, -1):
            ch = channels[level]
            block = _Block()
            depth = cfg.transformer_depth[level]
            for _ in range(cfg.layers_per_block + 1):
                skip = skip_channels.pop()
                block.resnets.append(ResnetBlock(prev + skip, ch, temb_dim))
                if depth > 0:
                    block.attentions.append(
                        self._transformer(ch, level, depth))
                prev = ch
            if level > 0:
                block.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNorm32(channels[0], eps=1e-5)
        self.conv_out = Conv2d32(channels[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor | None,
                added_cond: dict[str, torch.Tensor] | None = None,
                down_residuals: tuple[torch.Tensor, ...] | None = None,
                mid_residual: torch.Tensor | None = None,
                class_labels: torch.Tensor | None = None,
                cached_deep: torch.Tensor | None = None,
                return_deep: bool = False
                ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        if (cached_deep is not None or return_deep) and \
                len(self.config.block_out_channels) < 2:
            raise ValueError(
                "DeepCache needs a deep/shallow split: this UNet has a "
                "single resolution level")
        if cached_deep is not None and return_deep:
            raise ValueError("shallow replay already carries the cache; "
                             "return_deep only applies to full passes")
        dtype = param_dtype(self)
        temb = self.time_conditioning(timesteps, added_cond, dtype,
                                      class_labels)
        context = (None if encoder_hidden_states is None
                   else encoder_hidden_states.to(dtype))

        x = self.conv_in(sample.to(dtype))
        if cached_deep is not None:
            # the shallow replay: the level-0 down blocks feed the level-0
            # skips, the cache stands in for everything deeper
            skips = [x]
            block = self.down_blocks[0]
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
                skips.append(x)
            if down_residuals is not None:
                skips = [(s + r).to(dtype)
                         for s, r in zip(skips, down_residuals)]
            x = cached_deep.to(dtype)
            up_blocks = self.up_blocks[-1:]
        else:
            x, skips = self.down_trunk(x, temb, context)
            if down_residuals is not None:
                skips = [(s + r).to(dtype)
                         for s, r in zip(skips, down_residuals)]
            x = self.mid_trunk(x, temb, context)
            if mid_residual is not None:
                x = (x + mid_residual).to(dtype)
            up_blocks = self.up_blocks

        deep = None
        for n, block in enumerate(up_blocks):
            if return_deep and n == len(up_blocks) - 1:
                deep = x  # what the shallow replay splices back in
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        x = F.silu(self.conv_norm_out(x)).to(dtype)
        out = self.conv_out(x)
        return (out, deep) if return_deep else out
