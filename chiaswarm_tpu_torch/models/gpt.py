"""The causal GPT with a KV ring, and the non-causal fine GPT: the three
stages of bark-class text to speech, counterpart of
``chiaswarm_tpu/models/gpt.py`` (``GPTConfig`` :33-45, ``Block`` :48-101,
``GPT`` :104-153, ``init_caches`` :156-161, ``FineBlock``/``FineGPT``
:205-283).

- :class:`GPT`: token embeddings (or ``embeds`` given directly: bark's
  semantic prefill sums two lookups), learned positions, ``n_layer``
  pre-LN blocks and the LM head over the output vocab. The blocks write
  this call's keys and values into per-layer (B, ring, H, D) caches at
  ``index`` and attend the whole ring, under the additive ``ring_bias``
  when given, else the default causal ring mask (key j visible to query i
  iff j <= index + i and j < ``valid_len``). ``pos_index`` overrides the
  position-embedding row of ``ids[:, 0]`` (a padded prefill's decode steps
  sit at ring slot ``prefill_len + t`` but at logical position
  ``actual_len + t``).
- :class:`FineGPT`: ``n_codes_total`` embedding tables summed over the
  codebooks up to ``codebook_idx``, full-window non-causal blocks, one LM
  head per predicted codebook.

Numerics are JAX's: LayerNorms in float32, cast back to the model dtype;
scores in float32 from the model dtype, divided by sqrt(D), the softmax
weights cast back before P.V; exact-erf GELU; the final LayerNorm and the
LM heads in float32. The products are plain ``torch`` matmuls: the JAX
stages compute them outside any Pallas kernel, and a decode step's one
query over at most 1,024 keys is far below the flash kernel's range.

Parameter names are transformers' ``BarkCausalModel``/``BarkFineModel``
(``input_embeds_layer``, ``position_embeds_layer``,
``layers.{i}.attn.att_proj``, ``layers.{i}.mlp.in_proj``,
``layernorm_final``, ``lm_head``; ``input_embeds_layers.{k}``,
``lm_heads.{k}``), so a checkpoint loads by name
(``convert/checkpoint.py::convert_bark``). Bark's LayerNorms have no bias;
these carry one (zeros from a checkpoint), as the Flax modules do.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.common import (
    LayerNorm32,
    mask_bias,
    param_dtype,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 129600          # bark text stage input vocab
    output_vocab_size: int | None = None  # None -> same as vocab_size
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024            # max sequence length (cache size)
    dtype: str = "float32"

    @property
    def out_vocab(self) -> int:
        return self.output_vocab_size or self.vocab_size


class Linear32(nn.Linear):
    """A Linear the JAX modules run in float32 (the LM heads)."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight)


class BarkAttention(nn.Module):
    def __init__(self, cfg: GPTConfig) -> None:
        super().__init__()
        self.n_head = cfg.n_head
        self.att_proj = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, bias=False)
        self.out_proj = nn.Linear(cfg.n_embd, cfg.n_embd, bias=False)

    def forward(self, h: torch.Tensor, bias: torch.Tensor | None,
                cache: tuple[torch.Tensor, torch.Tensor] | None,
                index: int) -> torch.Tensor:
        b, t, c = h.shape
        q, k, v = (p.reshape(b, t, self.n_head, c // self.n_head)
                   for p in self.att_proj(h).chunk(3, dim=-1))
        if cache is not None:
            ck, cv = cache
            ck[:, index:index + t] = k
            cv[:, index:index + t] = v
            k, v = ck, cv
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(c // self.n_head)
        if bias is not None:
            scores = scores + bias
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out_proj(out.reshape(b, t, c))


class BarkMLP(nn.Module):
    def __init__(self, cfg: GPTConfig) -> None:
        super().__init__()
        self.in_proj = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, bias=False)
        self.out_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.out_proj(F.gelu(self.in_proj(h)))


class Block(nn.Module):
    """One pre-LN block; a cached step when ``cache`` is given (the causal
    stages), a full-window one otherwise (the fine stage, ``bias`` None:
    every key visible)."""

    def __init__(self, cfg: GPTConfig) -> None:
        super().__init__()
        self.layernorm_1 = LayerNorm32(cfg.n_embd, eps=1e-5)
        self.attn = BarkAttention(cfg)
        self.layernorm_2 = LayerNorm32(cfg.n_embd, eps=1e-5)
        self.mlp = BarkMLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None = None,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                index: int = 0) -> torch.Tensor:
        x = x + self.attn(self.layernorm_1(x).to(x.dtype), bias, cache, index)
        return x + self.mlp(self.layernorm_2(x).to(x.dtype))


def init_caches(cfg: GPTConfig, batch: int, device: torch.device | str,
                dtype: torch.dtype, length: int | None = None
                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer zero (k, v) rings of ``length`` slots (``block_size`` by
    default, JAX's; a decode that knows its ring may allocate less)."""
    shape = (batch, length or cfg.block_size, cfg.n_head,
             cfg.n_embd // cfg.n_head)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layer)]


class GPT(nn.Module):
    """Forward over new tokens given the KV rings; returns the float32
    logits over the output vocab and the (updated in place) caches."""

    def __init__(self, config: GPTConfig) -> None:
        super().__init__()
        cfg = config
        self.config = config
        self.input_embeds_layer = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.position_embeds_layer = nn.Embedding(cfg.block_size, cfg.n_embd)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.layernorm_final = LayerNorm32(cfg.n_embd, eps=1e-5)
        self.lm_head = Linear32(cfg.n_embd, cfg.out_vocab, bias=False)

    def forward(self, ids: torch.Tensor | None, caches: list, index: int,
                valid_len: int | None = None, *,
                embeds: torch.Tensor | None = None,
                ring_bias: torch.Tensor | None = None,
                pos_index: int | None = None
                ) -> tuple[torch.Tensor, list]:
        """``ids`` (B, T) (or ``embeds`` (B, T, C)) at ring slots
        [index, index + T); ``valid_len``: the count of valid ring slots
        after this call, read by the default mask only; ``ring_bias``
        broadcastable to (B, H, T, ring)."""
        dtype = param_dtype(self)
        tok = (self.input_embeds_layer(ids) if embeds is None
               else embeds.to(dtype))
        t = tok.shape[1]
        start = index if pos_index is None else pos_index
        pos = self.position_embeds_layer.weight[start:start + t]
        x = tok + pos[None].to(dtype)
        bias = ring_bias
        if bias is None:
            ring = caches[0][0].shape[1]
            kpos = torch.arange(ring, device=x.device)
            qpos = index + torch.arange(t, device=x.device)
            ok = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < valid_len)
            bias = mask_bias(ok)[None, None]
        for layer, cache in zip(self.layers, caches):
            x = layer(x, bias, cache, index)
        return self.lm_head(self.layernorm_final(x)), caches


class FineGPT(nn.Module):
    """Bark's fine acoustics model: ``forward(codes, codebook_idx)``, codes
    (B, T, n_codes_total) int, returns the float32 logits (B, T, out_vocab)
    for codebook ``codebook_idx`` from the embeddings of codebooks
    [0, codebook_idx] summed."""

    def __init__(self, config: GPTConfig, n_codes_total: int = 8,
                 n_codes_given: int = 1) -> None:
        super().__init__()
        cfg = config
        self.config = config
        self.n_codes_total = n_codes_total
        self.n_codes_given = n_codes_given
        self.input_embeds_layers = nn.ModuleList(
            nn.Embedding(cfg.vocab_size, cfg.n_embd)
            for _ in range(n_codes_total))
        self.position_embeds_layer = nn.Embedding(cfg.block_size, cfg.n_embd)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.layernorm_final = LayerNorm32(cfg.n_embd, eps=1e-5)
        self.lm_heads = nn.ModuleList(
            Linear32(cfg.n_embd, cfg.out_vocab, bias=False)
            for _ in range(n_codes_total - n_codes_given))

    def forward(self, codes: torch.Tensor, codebook_idx: int) -> torch.Tensor:
        dtype = param_dtype(self)
        t = codes.shape[1]
        x = self.input_embeds_layers[0](codes[:, :, 0])
        for k in range(1, codebook_idx + 1):
            x = x + self.input_embeds_layers[k](codes[:, :, k])
        x = x + self.position_embeds_layer.weight[None, :t].to(dtype)
        for layer in self.layers:
            x = layer(x)
        return self.lm_heads[codebook_idx - self.n_codes_given](
            self.layernorm_final(x))
