"""CLIP towers, counterpart of ``chiaswarm_tpu/models/clip.py``: the text
encoder (``ClipTextEncoder`` :133-185, layers and activations :25-78) and the
safety checker's vision tower (``VisionConfig``/``ClipVisionEncoder``
:79-131).

Parameter names are HF ``CLIPTextModel``'s (``text_model.embeddings...``,
``text_model.encoder.layers.{i}.self_attn.q_proj`` ...), plus
``text_projection`` when the config has a projection, so a later slice can
load the published safetensors with no renaming. The JAX package runs its
text towers in float32 whatever the family's dtype; so does this one.

The vision tower carries HF ``CLIPVisionModelWithProjection`` names
(``vision_model.embeddings.patch_embedding``, ``vision_model.pre_layrnorm``,
``vision_model.encoder.layers.{i}...``, ``visual_projection``) and runs in
float32. Its 257 tokens stay on the plain attention path, as in JAX (the
text tower's ``ClipLayer`` with a zero mask).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

import dataclasses

from chiaswarm_tpu_torch.models.configs import TextEncoderConfig


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x)  # exact erf GELU, as HF's ACT2FN["gelu"]
    raise ValueError(f"unknown activation {name!r}")


class ClipAttention(nn.Module):
    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        width = config.hidden_size
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, l, self.num_heads, self.head_dim)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        # causal mask as an additive bias on fp32 logits; the 77-token
        # sequence stays on the plain path
        logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
        logits = logits * self.head_dim ** -0.5 + mask
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhls,bshd->blhd", weights, v).reshape(b, l, -1)
        return self.out_proj(out)


class ClipMLP(nn.Module):
    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size)
        self.act = _act(config.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ClipLayer(nn.Module):
    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=1e-5)
        self.self_attn = ClipAttention(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=1e-5)
        self.mlp = ClipMLP(config)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class ClipEmbeddings(nn.Module):
    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class ClipEncoder(nn.Module):
    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.layers = nn.ModuleList(ClipLayer(config)
                                    for _ in range(config.num_layers))


class ClipTextModel(nn.Module):
    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.embeddings = ClipEmbeddings(config)
        self.encoder = ClipEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=1e-5)


class ClipTextEncoder(nn.Module):
    """``input_ids`` (B, L) int -> (sequence_embeddings, pooled_embedding).

    ``sequence_embeddings`` honours ``config.output_layer`` (clip skip) and
    ``config.final_layer_norm``; ``pooled_embedding`` is the final-LN state
    at the first EOS token, through ``text_projection`` when configured.
    """

    def __init__(self, config: TextEncoderConfig) -> None:
        super().__init__()
        self.config = config
        self.text_model = ClipTextModel(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size,
                                             config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        tm = self.text_model
        input_ids = input_ids.long()
        x = tm.embeddings(input_ids)
        l = input_ids.shape[1]
        mask = torch.triu(torch.full((l, l), -1e9, dtype=torch.float32,
                                     device=x.device), diagonal=1)[None, None]
        hidden_states = []
        for layer in tm.encoder.layers:
            hidden_states.append(x)
            x = layer(x, mask)
        hidden_states.append(x)  # index -1 == final layer output

        final = tm.final_layer_norm(x)
        readout = x if cfg.output_layer == -1 else hidden_states[cfg.output_layer]
        seq = tm.final_layer_norm(readout) if cfg.final_layer_norm else readout

        eos_idx = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eos_idx]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return seq, pooled


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP vision tower (ViT-L/14 defaults, the safety checker's trunk).
    Field names match ``TextEncoderConfig`` so ``ClipLayer`` serves both."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    hidden_act: str = "quick_gelu"
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768


class ClipVisionEmbeddings(nn.Module):
    def __init__(self, config: VisionConfig) -> None:
        super().__init__()
        self.patch_size = config.patch_size
        self.class_embedding = nn.Parameter(torch.empty(config.hidden_size))
        self.patch_embedding = nn.Conv2d(3, config.hidden_size,
                                         config.patch_size,
                                         stride=config.patch_size, bias=False)
        n_pos = (config.image_size // config.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, config.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 1 + patches, hidden). The patch conv (stride
        = kernel) is computed as one GEMM over the unfolded patches: cuDNN
        would run a float32 conv in TF32 under PyTorch's default
        ``torch.backends.cudnn.allow_tf32``, and flipping that process-wide
        flag here would race with a lane's float32 convs on another thread;
        ``torch.matmul`` in float32 stays in full precision under the
        default ``torch.backends.cuda.matmul.allow_tf32 = False``."""
        b, c, h, w = pixel_values.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = (pixel_values[:, :, :gh * p, :gw * p]
                   .reshape(b, c, gh, p, gw, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p))
        weight = self.patch_embedding.weight.reshape(
            self.patch_embedding.out_channels, -1)
        x = torch.matmul(patches, weight.t())
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None]


class ClipVisionTransformer(nn.Module):
    def __init__(self, config: VisionConfig) -> None:
        super().__init__()
        self.embeddings = ClipVisionEmbeddings(config)
        self.pre_layrnorm = nn.LayerNorm(config.hidden_size, eps=1e-5)
        self.encoder = ClipEncoder(config)
        self.post_layernorm = nn.LayerNorm(config.hidden_size, eps=1e-5)


class ClipVisionEncoder(nn.Module):
    """(B, 3, H, W) preprocessed pixels, NCHW float32 -> (B, projection_dim)
    image embeddings: patch GEMM + CLS token + position embedding ->
    ``pre_layrnorm`` -> the text tower's ``ClipLayer`` stack with a zero
    (non-causal) mask -> ``post_layernorm`` on token 0 ->
    ``visual_projection``."""

    def __init__(self, config: VisionConfig) -> None:
        super().__init__()
        self.config = config
        self.vision_model = ClipVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values.float()))
        mask = torch.zeros((1, 1, x.shape[1], x.shape[1]),
                           dtype=torch.float32, device=x.device)
        for layer in vm.encoder.layers:
            x = layer(x, mask)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
