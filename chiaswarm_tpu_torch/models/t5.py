"""T5 text encoder, counterpart of ``chiaswarm_tpu/models/t5.py``: the
T5-v1.1 tower DeepFloyd-IF-class cascades condition on (prompt embeddings
computed once and shared by the cascade's stages).

Parameter names are transformers' ``T5EncoderModel``'s (``shared``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}``,
``encoder.block.0.layer.0.SelfAttention.relative_attention_bias``,
``encoder.block.{i}.layer.{0,1}.layer_norm``,
``encoder.block.{i}.layer.1.DenseReluDense.{wi_0,wi_1,wo}``,
``encoder.final_layer_norm``), so a checkpoint loads with no renaming.

Numerics follow the JAX module:

- RMSNorm (:class:`T5LayerNorm`) in float32, no mean subtraction and no
  bias, its scale kept in float32, the output cast back to the model dtype;
- attention without 1/sqrt(d) scaling, scores and softmax in float32, the
  weights cast to the model dtype before the V product;
- a relative position bias (bucketed, bidirectional, built on the host once
  per length by :func:`relative_position_buckets`) owned by block 0, kept
  in float32 and shared by every layer; the padding mask folds into it once
  as ``finfo(float32).min``, as transformers merges its attention mask;
- the gated-GELU feed-forward of v1.1 (``wi_0`` through tanh-approximate
  GELU, times ``wi_1``);
- the output in float32.

The 77-token sequence stays on the plain path: no kernel runs here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096        # T5-v1.1-XXL (IF's encoder)
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    max_length: int = 77
    layer_norm_epsilon: float = 1e-6
    eos_token_id: int = 1
    pad_token_id: int = 0      # T5 pads with id 0 and prepends no BOS
    dtype: str = "bfloat16"


def relative_position_buckets(length: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket table, (length, length) int32."""
    context = np.arange(length)[:, None]
    memory = np.arange(length)[None, :]
    relative = memory - context
    half = num_buckets // 2
    bucket = np.where(relative > 0, half, 0)
    rel = np.abs(relative)
    max_exact = half // 2
    is_small = rel < max_exact
    log_ratio = np.log(np.maximum(rel, 1) / max_exact) / np.log(
        max_distance / max_exact)
    large = max_exact + (log_ratio * (half - max_exact)).astype(np.int64)
    large = np.minimum(large, half - 1)
    bucket = bucket + np.where(is_small, rel, large)
    return bucket.astype(np.int32)


class T5LayerNorm(nn.Module):
    """T5's RMSNorm: float32, no mean subtraction, no bias."""

    keep_fp32 = True

    def __init__(self, width: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        rsqrt = 1.0 / torch.sqrt(var + self.eps)
        return (x32 * rsqrt * self.weight).to(x.dtype)


class RelativeBias(nn.Embedding):
    """Block 0's (buckets, heads) table, kept in float32."""

    keep_fp32 = True


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool) -> None:
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False)
        self.k = nn.Linear(config.d_model, inner, bias=False)
        self.v = nn.Linear(config.d_model, inner, bias=False)
        self.o = nn.Linear(inner, config.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = RelativeBias(
                config.relative_attention_num_buckets, config.num_heads)

    def position_bias(self, length: int,
                      mask_bias: torch.Tensor | None) -> torch.Tensor:
        """(1|B, H, L, L) float32: the bucketed table, plus the mask bias."""
        cfg = self.config
        buckets = torch.from_numpy(relative_position_buckets(
            length, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)).long()
        table = self.relative_attention_bias.weight
        bias = table[buckets.to(table.device)].permute(2, 0, 1)[None]
        return bias if mask_bias is None else bias + mask_bias

    def forward(self, x: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, l, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, l, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        # T5: no 1/sqrt(d) scaling
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        weights = torch.softmax(scores + position_bias, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        return self.o(out.transpose(1, 2).reshape(b, l, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool) -> None:
        super().__init__()
        self.SelfAttention = T5Attention(config, has_relative_bias)
        self.layer_norm = T5LayerNorm(config.d_model,
                                      config.layer_norm_epsilon)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, config: T5Config) -> None:
        super().__init__()
        self.wi_0 = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wi_1 = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = F.gelu(self.wi_0(x), approximate="tanh")
        return self.wo(gate * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, config: T5Config) -> None:
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(config)
        self.layer_norm = T5LayerNorm(config.d_model,
                                      config.layer_norm_epsilon)


class T5Block(nn.Module):
    """Pre-norm self-attention and gated feed-forward, each residual."""

    def __init__(self, config: T5Config, has_relative_bias: bool) -> None:
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(config, has_relative_bias),
            T5LayerFF(config)])

    def forward(self, x: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, config: T5Config) -> None:
        super().__init__()
        self.block = nn.ModuleList(T5Block(config, i == 0)
                                   for i in range(config.num_layers))
        self.final_layer_norm = T5LayerNorm(config.d_model,
                                            config.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """(B, L) int token ids and an optional (B, L) 1/0 attention mask ->
    (B, L, d_model) float32. The cascade hands it the tokenizer's padding
    mask (``ids != pad``); None attends everywhere."""

    def __init__(self, config: T5Config) -> None:
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.shared(input_ids.long())
        mask_bias = None
        if attention_mask is not None:
            mask_bias = torch.where(
                attention_mask[:, None, None, :] > 0, 0.0,
                torch.finfo(torch.float32).min).to(torch.float32)
        blocks = self.encoder.block
        position_bias = blocks[0].layer[0].SelfAttention.position_bias(
            input_ids.shape[1], mask_bias)
        for block in blocks:
            x = block(x, position_bias)
        return self.encoder.final_layer_norm(x).float()

