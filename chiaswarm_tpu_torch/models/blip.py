"""BLIP captioning and VQA model, counterpart of
``chiaswarm_tpu/models/blip.py`` (configs :30-86, ``BlipVisionEncoder``
:89-152, ``BlipTextLayer``/``BlipTextModel`` :155-330, ``generate_text``
:343-407).

- :class:`BlipVisionEncoder`: a pre-LN ViT over (B, 3, H, W) normalized
  pixels, NCHW (the JAX module takes NHWC), 577 tokens at 384 px for
  ViT-B/16; the patch conv (stride = kernel) is one GEMM over the unfolded
  patches, so a float32 tower never runs a cuDNN convolution in TF32.
- :class:`BlipTextModel`: the BERT-layout post-LN transformer whose layers
  cross-attend the image (or the question, for VQA's answer decoder). One
  module is the question tower (bidirectional, ``with_lm_head=False``) and
  the causal decoder with its LM head.
- :func:`generate_text`: the greedy decode as a plain PyTorch loop over a
  preallocated KV ring, with JAX's semantics exactly: the prompt padded to
  its static bucket with ``actual_len`` real tokens, pad slots masked for
  every later query, the first token from the logits at ``actual_len - 1``,
  decode steps at logical positions ``actual_len + t``, and every position
  after SEP repeating SEP. The cross-attention K/V over the image are
  computed once per call.

Parameter names are transformers' (``embeddings.class_embedding``,
``encoder.layers.{i}.self_attn.qkv``, ``encoder.layer.{i}.crossattention.
self.query``, ``cls.predictions.decoder``), so a
``BlipForConditionalGeneration``/``BlipForQuestionAnswering`` state dict
loads by stripping its prefixes (``convert/checkpoint.py``). Attention
here is plain: 577 vision tokens and at most 41 text tokens stay below the
flash kernel's 1,024, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chiaswarm_tpu_torch.models.common import NEG_INF, mask_bias


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 384
    patch_size: int = 16
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524           # BERT vocab + [DEC]/[ENC]
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 512
    encoder_hidden_size: int = 768    # the width cross-attended to
    layer_norm_eps: float = 1e-12
    bos_token_id: int = 30522         # [DEC]
    sep_token_id: int = 102           # [SEP], the stop token
    pad_token_id: int = 0
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    name: str = "blip_base"
    vision: BlipVisionConfig = BlipVisionConfig()
    text: BlipTextConfig = BlipTextConfig()
    # image preprocessing (host side): CLIP's mean and std
    pixel_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073)
    pixel_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711)


BLIP_BASE = BlipConfig()

BLIP_TINY = BlipConfig(
    name="blip_tiny",
    vision=BlipVisionConfig(hidden_size=32, intermediate_size=64,
                            num_layers=2, num_heads=4, image_size=32,
                            patch_size=8),
    text=BlipTextConfig(vocab_size=1000, hidden_size=32,
                        intermediate_size=64, num_layers=2, num_heads=4,
                        max_position_embeddings=64, encoder_hidden_size=32,
                        bos_token_id=998, sep_token_id=999),
)

BLIP_CONFIGS = {c.name: c for c in (BLIP_BASE, BLIP_TINY)}


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor | None) -> torch.Tensor:
    """(B, L, H, D) queries over (B, S, H, D) keys: float32 scores times
    D^-0.5 plus ``bias`` (broadcast to (B, H, L, S)), softmax, weights in
    v's type; (B, L, H * D)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (q.shape[-1] ** -0.5)
    if bias is not None:
        scores = scores + bias
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


# ---------------------------------------------------------------- vision

class BlipAttention(nn.Module):
    def __init__(self, hidden: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.projection = nn.Linear(hidden, hidden)


class BlipMlp(nn.Module):
    def __init__(self, hidden: int, intermediate: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)


class BlipVisionLayer(nn.Module):
    def __init__(self, cfg: BlipVisionConfig) -> None:
        super().__init__()
        self.num_heads = cfg.num_heads
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = BlipAttention(cfg.hidden_size)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = BlipMlp(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        h = self.layer_norm1(x)
        q, k, v = self.self_attn.qkv(h).chunk(3, dim=-1)
        heads = (b, l, self.num_heads, c // self.num_heads)
        out = _attend(q.reshape(heads), k.reshape(heads), v.reshape(heads),
                      None)
        x = x + self.self_attn.projection(out)
        h = F.gelu(self.mlp.fc1(self.layer_norm2(x)))
        return x + self.mlp.fc2(h)


class BlipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: BlipVisionConfig) -> None:
        super().__init__()
        self.patch_size = cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_tokens, cfg.hidden_size))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b, c, h, w = pixel_values.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = (pixel_values[:, :, :gh * p, :gw * p]
                   .reshape(b, c, gh, p, gw, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p))
        conv = self.patch_embedding
        x = torch.matmul(patches, conv.weight.reshape(conv.out_channels, -1).t())
        x = x + conv.bias
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding[None, :x.shape[1]]


class BlipVisionEncoderStack(nn.Module):
    def __init__(self, cfg: BlipVisionConfig) -> None:
        super().__init__()
        self.layers = nn.ModuleList(BlipVisionLayer(cfg)
                                    for _ in range(cfg.num_layers))


class BlipVisionEncoder(nn.Module):
    """(B, 3, H, W) normalized pixels -> (B, tokens, hidden) patch states,
    float32 out."""

    def __init__(self, config: BlipVisionConfig) -> None:
        super().__init__()
        self.config = config
        self.embeddings = BlipVisionEmbeddings(config)
        self.encoder = BlipVisionEncoderStack(config)
        self.post_layernorm = nn.LayerNorm(config.hidden_size,
                                           eps=config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        dtype = self.embeddings.position_embedding.dtype
        x = self.embeddings(pixel_values.to(dtype))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x).float()


# ------------------------------------------------------------------ text

class BlipSelfAttention(nn.Module):
    def __init__(self, hidden: int, kv_width: int) -> None:
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(kv_width, hidden)
        self.value = nn.Linear(kv_width, hidden)


class BlipDenseLn(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float) -> None:
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class BlipAttentionBlock(nn.Module):
    """``self`` (query/key/value) and ``output`` (dense + LayerNorm), as
    transformers names a BERT attention."""

    def __init__(self, hidden: int, kv_width: int, eps: float) -> None:
        super().__init__()
        self.self = BlipSelfAttention(hidden, kv_width)
        self.output = BlipDenseLn(hidden, hidden, eps)


class BlipIntermediate(nn.Module):
    def __init__(self, hidden: int, intermediate: int) -> None:
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate)


class BlipTextLayer(nn.Module):
    """BERT-style post-LN block: self-attention, cross-attention onto the
    encoder states, feed-forward."""

    def __init__(self, cfg: BlipTextConfig) -> None:
        super().__init__()
        self.num_heads = cfg.num_heads
        eps = cfg.layer_norm_eps
        self.attention = BlipAttentionBlock(cfg.hidden_size, cfg.hidden_size,
                                            eps)
        self.crossattention = BlipAttentionBlock(
            cfg.hidden_size, cfg.encoder_hidden_size, eps)
        self.intermediate = BlipIntermediate(cfg.hidden_size,
                                             cfg.intermediate_size)
        self.output = BlipDenseLn(cfg.intermediate_size, cfg.hidden_size, eps)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, l, c = t.shape
        return t.reshape(b, l, self.num_heads, c // self.num_heads)

    def cross_kv(self, enc_states: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        att = self.crossattention.self
        return self._heads(att.key(enc_states)), self._heads(att.value(enc_states))

    def forward(self, x: torch.Tensor, *, self_bias: torch.Tensor | None,
                cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                cross_bias: torch.Tensor | None = None,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                index: int = 0) -> torch.Tensor:
        """A full forward (``cache`` None) or a cached step: this call's
        keys and values are written into the (B, ring, H, D) ``cache`` at
        ``index`` and the queries attend the whole ring."""
        att = self.attention
        q = self._heads(att.self.query(x))
        k = self._heads(att.self.key(x))
        v = self._heads(att.self.value(x))
        if cache is not None:
            ck, cv = cache
            ck[:, index:index + k.shape[1]] = k
            cv[:, index:index + v.shape[1]] = v
            k, v = ck, cv
        out = _attend(q, k, v, self_bias)
        x = att.output.LayerNorm(x + att.output.dense(out))
        if cross_kv is not None:
            cross = self.crossattention
            cq = self._heads(cross.self.query(x))
            out = _attend(cq, cross_kv[0], cross_kv[1], cross_bias)
            x = cross.output.LayerNorm(x + cross.output.dense(out))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class BlipTextEmbeddings(nn.Module):
    def __init__(self, cfg: BlipTextConfig) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BlipTextEncoderStack(nn.Module):
    def __init__(self, cfg: BlipTextConfig) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BlipTextLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BlipPredictionTransform(nn.Module):
    def __init__(self, cfg: BlipTextConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BlipPredictions(nn.Module):
    def __init__(self, cfg: BlipTextConfig) -> None:
        super().__init__()
        self.transform = BlipPredictionTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)


class BlipLmHead(nn.Module):
    def __init__(self, cfg: BlipTextConfig) -> None:
        super().__init__()
        self.predictions = BlipPredictions(cfg)


class BlipTextModel(nn.Module):
    """Embeddings + N :class:`BlipTextLayer` (+ the LM head ``cls``)."""

    def __init__(self, config: BlipTextConfig,
                 with_lm_head: bool = True) -> None:
        super().__init__()
        self.config = config
        self.with_lm_head = with_lm_head
        self.embeddings = BlipTextEmbeddings(config)
        self.encoder = BlipTextEncoderStack(config)
        if with_lm_head:
            self.cls = BlipLmHead(config)

    def _embed(self, ids: torch.Tensor, position: int) -> torch.Tensor:
        emb = self.embeddings
        pos = emb.position_embeddings.weight[position:position + ids.shape[1]]
        return emb.LayerNorm(emb.word_embeddings(ids) + pos[None])

    def cross_kvs(self, enc_states: torch.Tensor) -> list:
        return [layer.cross_kv(enc_states) for layer in self.encoder.layer]

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        pred = self.cls.predictions
        h = F.gelu(pred.transform.dense(x))
        return pred.decoder(pred.transform.LayerNorm(h)).float()

    def forward(self, ids: torch.Tensor, *, causal: bool,
                attn_mask: torch.Tensor | None = None,
                cross_kvs: list | None = None,
                cross_bias: torch.Tensor | None = None,
                caches: list | None = None, index: int = 0,
                pos_index: int | None = None,
                ring_bias: torch.Tensor | None = None,
                logits: bool = True) -> torch.Tensor:
        """A full forward (``caches`` None) over (B, T) ``ids``, causal or
        bidirectional, ``attn_mask`` (B, T) 1/0 key validity; or a cached
        step whose keys and values land in the per-layer (k, v) rings at
        ``index``, attending them under ``ring_bias`` (1|B, 1, T, ring).
        ``pos_index`` is the logical position of ``ids[:, 0]`` when it
        differs from its ring slot (a padded prefill's decode steps).
        Returns the LM logits (float32) or the hidden states."""
        t = ids.shape[1]
        x = self._embed(ids, index if pos_index is None else pos_index)
        if caches is None:
            bias = torch.zeros((1, 1, t, t), dtype=torch.float32,
                               device=ids.device)
            if causal:
                bias = bias + torch.triu(torch.full_like(bias[0, 0], NEG_INF),
                                         diagonal=1)
            if attn_mask is not None:
                bias = bias + torch.where(attn_mask[:, None, None, :] > 0,
                                          0.0, NEG_INF)
        else:
            bias = ring_bias
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, self_bias=bias,
                      cross_kv=None if cross_kvs is None else cross_kvs[i],
                      cross_bias=cross_bias,
                      cache=None if caches is None else caches[i],
                      index=index)
        if logits and self.with_lm_head:
            return self.lm_logits(x)
        return x


@torch.inference_mode()
def generate_text(model: BlipTextModel, prompt_ids: torch.Tensor,
                  enc_states: torch.Tensor, enc_mask: torch.Tensor | None, *,
                  prompt_len: int, max_new: int,
                  actual_len: int | None = None) -> torch.Tensor:
    """Greedy cross-attending decode: prefill ``prompt_ids`` (B, prompt_len;
    [DEC] + optional conditioning text, padded to the bucket with anything),
    then ``max_new - 1`` single-token steps. Returns (B, max_new) int64;
    the positions after SEP repeat SEP. ``actual_len`` (default
    ``prompt_len``) real tokens: the pad ring slots stay masked for every
    later query, the first token reads the logits at ``actual_len - 1`` and
    decode steps take logical positions ``actual_len + t``, so a padded
    prefill decodes as an unpadded one."""
    cfg = model.config
    device = prompt_ids.device
    b = prompt_ids.shape[0]
    ring = prompt_len + max_new
    eos = cfg.sep_token_id
    alen = prompt_len if actual_len is None else int(actual_len)

    cross_bias = None
    if enc_mask is not None:
        cross_bias = torch.where(enc_mask[:, None, None, :] > 0, 0.0,
                                 NEG_INF).to(torch.float32)
    cross_kvs = model.cross_kvs(enc_states)
    dtype = model.embeddings.word_embeddings.weight.dtype
    head_dim = cfg.hidden_size // cfg.num_heads
    shape = (b, ring, cfg.num_heads, head_dim)
    caches = [(torch.zeros(shape, dtype=dtype, device=device),
               torch.zeros(shape, dtype=dtype, device=device))
              for _ in range(cfg.num_layers)]
    kpos = torch.arange(ring, device=device)

    # prefill: query i sees the real prompt keys j <= i only
    qpos = torch.arange(prompt_len, device=device)
    ok = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < alen)
    logits = model(prompt_ids, causal=True, cross_kvs=cross_kvs,
                   cross_bias=cross_bias, caches=caches, index=0,
                   ring_bias=mask_bias(ok)[None, None])
    tok = logits[:, alen - 1].argmax(dim=-1)
    done = tok == eos
    out = [tok]
    for t in range(max_new - 1):
        idx = prompt_len + t  # the ring slot; the logical position is alen + t
        ok = (kpos < alen) | ((kpos >= prompt_len) & (kpos <= idx))
        logits = model(tok[:, None], causal=True, cross_kvs=cross_kvs,
                       cross_bias=cross_bias, caches=caches, index=idx,
                       pos_index=alen + t,
                       ring_bias=mask_bias(ok)[None, None, None])
        nxt = logits[:, 0].argmax(dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        done = done | (nxt == eos)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
