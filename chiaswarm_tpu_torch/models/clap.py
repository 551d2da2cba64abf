"""The CLAP text tower, AudioLDM's conditioning encoder: counterpart of
``chiaswarm_tpu/models/clap.py``.

transformers' ``ClapTextModelWithProjection``: a RoBERTa language model
(post-LayerNorm residual blocks, learned absolute positions offset by the
pad id, token-type row 0, eps 1e-12, exact-erf GELU) with a tanh CLS pooler
and a two-layer ReLU projection head. The input is padded to
``max_length`` (512, the RobertaTokenizer's model length) and its padding
masked: the attention mask is ``input_ids != pad_token_id`` unless given,
and the position ids follow RoBERTa's pad-offset rule (pad rows at the pad
id, real tokens counted from pad id + 1). Scores are float32 with the
mask's float32 minimum added.

Parameter names are transformers' (``text_model.embeddings.word_embeddings``,
``text_model.encoder.layer.{i}.attention.self.query``,
``text_model.pooler.dense``, ``text_projection.linear1``), so a checkpoint
loads by name. A 512-token tower stays on the plain attention path, as in
JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.blip import BlipAttentionBlock, BlipDenseLn


@dataclasses.dataclass(frozen=True)
class ClapTextConfig:
    """transformers' ``ClapTextConfig`` defaults, the laion/clap-htsat
    tower AudioLDM ships."""

    vocab_size: int = 50265
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    projection_dim: int = 512
    max_length: int = 512
    dtype: str = "float32"


class ClapTextLayer(nn.Module):
    """One post-LN (BERT-style) encoder layer: ``attention`` (``self`` q/k/v,
    ``output`` dense + LayerNorm), ``intermediate``, ``output``."""

    def __init__(self, cfg: ClapTextConfig) -> None:
        super().__init__()
        self.num_heads = cfg.num_heads
        eps = cfg.layer_norm_eps
        self.attention = BlipAttentionBlock(cfg.hidden_size, cfg.hidden_size,
                                            eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output = BlipDenseLn(cfg.intermediate_size, cfg.hidden_size, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        heads = (b, l, self.num_heads, d // self.num_heads)
        att = self.attention
        q = att.self.query(x).reshape(heads).transpose(1, 2)
        k = att.self.key(x).reshape(heads).transpose(1, 2)
        v = att.self.value(x).reshape(heads).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        scores = scores / torch.sqrt(torch.tensor(float(heads[-1]))) + bias
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, l, d)
        x = att.output.LayerNorm(x + att.output.dense(out))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class ClapTextTransformer(nn.Module):
    def __init__(self, cfg: ClapTextConfig) -> None:
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size,
                                                       cfg.hidden_size)
        self.embeddings.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.embeddings.token_type_embeddings = nn.Embedding(1,
                                                             cfg.hidden_size)
        self.embeddings.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                                 eps=cfg.layer_norm_eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(ClapTextLayer(cfg)
                                           for _ in range(cfg.num_layers))
        self.pooler = nn.Module()
        self.pooler.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class ClapTextEncoder(nn.Module):
    """(B, L) ids -> (sequence (B, L, hidden), text_embeds (B,
    projection_dim)), both float32. AudioLDM conditions on ``text_embeds``
    (the caller L2-normalises them)."""

    def __init__(self, config: ClapTextConfig) -> None:
        super().__init__()
        self.config = config
        self.text_model = ClapTextTransformer(config)
        self.text_projection = nn.Module()
        self.text_projection.linear1 = nn.Linear(config.hidden_size,
                                                 config.projection_dim)
        self.text_projection.linear2 = nn.Linear(config.projection_dim,
                                                 config.projection_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        tm = self.text_model
        if attention_mask is None:
            attention_mask = input_ids != cfg.pad_token_id
        mask = attention_mask.to(torch.int64)
        # RoBERTa's position ids: pad rows pinned at the pad id, real tokens
        # counted from pad id + 1
        positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        emb = tm.embeddings
        x = (emb.word_embeddings(input_ids)
             + emb.position_embeddings(positions)
             + emb.token_type_embeddings.weight[0])
        x = emb.LayerNorm(x)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min).to(torch.float32)
        for layer in tm.encoder.layer:
            x = layer(x, bias)
        pooled = torch.tanh(tm.pooler.dense(x[:, 0]))
        proj = self.text_projection.linear1(pooled)
        proj = self.text_projection.linear2(F.relu(proj))
        return x.float(), proj.float()
