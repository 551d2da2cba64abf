"""Bark-class text to speech: three GPT stages and the EnCodec decode,
counterpart of ``chiaswarm_tpu/pipelines/tts.py`` (the families :48-138,
``is_tts_model`` :141-152, ``TTSComponents`` :157-245, ``_stage_decode``
:255-315, ``encode_semantic_text`` :318-335, ``TTSPipeline`` :338-565), the
reference's ``suno-bark`` ``generate_audio`` (swarm/audio/bark.py:11-38).

- **semantic**: the text's raw token ids plus ``text_encoding_offset``,
  padded with ``text_pad_token`` to ``max_input_semantic_length``; their
  embeddings summed with the semantic history's (in float32, then cast),
  the infer token appended, and the semantic tokens decoded with every
  logit outside [0, ``semantic_vocab``] suppressed (EOS is
  ``semantic_vocab``; after it the stage emits that id as padding).
- **coarse**: sliding windows of ``sliding_window_len`` tokens, each behind
  a prompt [semantic window ; infer token ; coarse history] padded to one
  ``coarse_prefill`` bucket, the tokens alternating between the two
  codebooks' ranges.
- **fine**: the non-causal model fills codebooks ``n_coarse`` ..
  ``n_fine - 1`` over ``fine_input_length``-frame windows that advance by
  ``fine_history_length``; argmax at temperature <= 1e-4.
- **codec**: the EnCodec decoder on the codes padded to a 64-frame bucket,
  the waveform trimmed to ``frames x hop``.

:func:`_stage_decode` is JAX's decode as a plain PyTorch loop: the padded
prefill (real tokens left-aligned, ``actual_len`` of them), the first token
from the logits at ``actual_len - 1``, decode step t written at ring slot
``prefill_len + t`` but embedded at logical position ``actual_len + t``
under the mask ``(kpos < actual_len) | (prefill_len <= kpos <= slot)``,
the step masks alternating ``step_masks[(t + 1) % 2]``, the temperature
floored at 1e-5 and top-k by the k-th value (ties kept). The KV rings hold
``prefill_len + max_new`` slots, the ones JAX's 1,024-slot rings leave
unmasked. Sampling is Gumbel-max over one generator per job on the
modules' device, seeded from the job's seed (``core/rng.py::row_seed``),
so the decode never reads a token back to the host within a stage's
window, and the same job twice gives the same waveform on one card. JAX's
threefry bits are not reproduced: the same seed samples other tokens than
JAX's (at ``top_k = 1`` and temperature 0 the two agree token for token).

The GPTs compute in the family's dtype (bf16 for ``BARK``; their
LayerNorms and LM heads in float32), the codec in float32.
:class:`TTSComponents` builds them from a seed (:meth:`random`), from the
JAX package's params (:meth:`from_jax`) or from a transformers
``BarkModel`` directory (:meth:`from_checkpoint`). Voice presets (bark's
speaker histories) ride as ``history`` arrays {semantic_prompt,
coarse_prompt, fine_prompt}.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.core.device import resolve_device, upload
from chiaswarm_tpu_torch.core.rng import row_seed
from chiaswarm_tpu_torch.models.codec import CodecConfig, CodecDecoder
from chiaswarm_tpu_torch.models.common import NEG_INF, mask_bias, param_dtype
from chiaswarm_tpu_torch.models.gpt import GPT, FineGPT, GPTConfig, init_caches
from chiaswarm_tpu_torch.models.tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
)
from chiaswarm_tpu_torch.pipelines.components import (
    build_modules,
    flax_default_init,
)

log = logging.getLogger("chiaswarm_torch.tts")


@dataclasses.dataclass(frozen=True)
class TTSFamily:
    name: str
    semantic: GPTConfig
    coarse: GPTConfig
    fine: GPTConfig
    codec: CodecConfig
    # ---- bark protocol constants (HF generation_configuration_bark) ----
    text_encoding_offset: int = 10_048
    text_pad_token: int = 129_595
    semantic_infer_token: int = 129_599
    semantic_vocab: int = 10_000          # eos == pad == this id
    max_input_semantic_length: int = 256
    semantic_rate_hz: float = 49.9
    max_semantic_tokens: int = 768
    coarse_rate_hz: float = 75.0
    n_coarse: int = 2
    coarse_semantic_pad: int = 12_048
    coarse_infer_token: int = 12_050
    max_coarse_input_length: int = 256
    max_coarse_history: int = 630
    sliding_window_len: int = 60
    n_fine: int = 8
    fine_history_length: int = 512
    fine_input_length: int = 1024
    codebook_size: int = 1024

    @property
    def coarse_prefill(self) -> int:
        # [semantic window ; infer ; coarse history] padded to one bucket
        return self.max_coarse_input_length + 1 + self.max_coarse_history


BARK = TTSFamily(
    name="bark",
    semantic=GPTConfig(vocab_size=129_600, output_vocab_size=10_048,
                       n_layer=24, n_head=16, n_embd=1024,
                       block_size=1024, dtype="bfloat16"),
    coarse=GPTConfig(vocab_size=12_096, output_vocab_size=12_096,
                     n_layer=24, n_head=16, n_embd=1024,
                     block_size=1024, dtype="bfloat16"),
    fine=GPTConfig(vocab_size=1056, output_vocab_size=1056,
                   n_layer=24, n_head=16, n_embd=1024,
                   block_size=1024, dtype="bfloat16"),
    codec=CodecConfig(),
)

TINY_TTS = TTSFamily(
    name="tiny_tts",
    semantic=GPTConfig(vocab_size=256, output_vocab_size=64, n_layer=2,
                       n_head=2, n_embd=32, block_size=128),
    coarse=GPTConfig(vocab_size=96, output_vocab_size=96, n_layer=2,
                     n_head=2, n_embd=32, block_size=96),
    fine=GPTConfig(vocab_size=24, output_vocab_size=24, n_layer=2,
                   n_head=2, n_embd=32, block_size=32),
    codec=CodecConfig(n_codebooks=4, codebook_size=16, codebook_dim=8,
                      num_filters=4, upsampling_ratios=(4, 2),
                      num_lstm_layers=1, sampling_rate=16000),
    text_encoding_offset=52,
    text_pad_token=200,
    semantic_infer_token=255,
    semantic_vocab=50,
    max_input_semantic_length=16,
    semantic_rate_hz=50.0,
    max_semantic_tokens=32,
    coarse_rate_hz=50.0,
    n_coarse=2,
    coarse_semantic_pad=90,
    coarse_infer_token=91,
    max_coarse_input_length=16,
    max_coarse_history=12,
    sliding_window_len=8,
    n_fine=4,
    fine_history_length=16,
    fine_input_length=32,
    codebook_size=16,
)

TTS_FAMILIES = {f.name: f for f in (BARK, TINY_TTS)}


def get_tts_family(model_name: str) -> TTSFamily:
    """A family by name or by the name's last path part; bark otherwise."""
    low = (model_name or "").lower()
    tail = low.rsplit("/", 1)[-1]
    if low in TTS_FAMILIES:
        return TTS_FAMILIES[low]
    if tail in TTS_FAMILIES:
        return TTS_FAMILIES[tail]
    return TTS_FAMILIES["bark"]


def is_tts_model(model_name: str) -> bool:
    """The one bark/TTS routing gate (``node/job_args.py`` reads it): a
    bark-family TAIL of the model name ("suno/bark", "bark-small", the tiny
    family), not a substring, so "acme/embark-audioldm" stays on the
    AudioLDM path (the reference's gate, swarm/job_arguments.py:22-23)."""
    tail = (model_name or "").lower().rsplit("/", 1)[-1]
    return tail.startswith("bark") or tail in TTS_FAMILIES


# ------------------------------------------------------------ components

#: the modules of a family, in the order their random seeds are derived
MODULES = ("semantic", "coarse", "fine", "codec")


def _ctor(family: TTSFamily, name: str) -> tuple[Any, Any, str]:
    if name == "fine":
        return (functools.partial(FineGPT, n_codes_total=family.n_fine,
                                  n_codes_given=1), family.fine,
                family.fine.dtype)
    if name == "codec":
        return CodecDecoder, family.codec, family.codec.dtype
    cfg = getattr(family, name)
    return GPT, cfg, cfg.dtype


def hash_tokenizer(family: TTSFamily) -> HashTokenizer:
    """The vocab-file-free tokenizer: ids below the text offset's pad."""
    return HashTokenizer(family.text_encoding_offset - 2,
                         family.max_input_semantic_length)


@torch.no_grad()
def _random_fill(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default distributions, the learned positions N(0, 0.02) and
    the LSTM's weights N(0, 0.02) with zero biases, as the JAX modules
    initialise them."""
    flax_default_init(module, generator)
    for m in module.modules():
        if isinstance(m, (GPT, FineGPT)):
            m.position_embeds_layer.weight.normal_(0.0, 0.02,
                                                   generator=generator)
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("weight"):
                    p.normal_(0.0, 0.02, generator=generator)
                else:
                    p.zero_()


@dataclasses.dataclass
class TTSComponents:
    family: TTSFamily
    model_name: str
    tokenizer: Any
    semantic: GPT
    coarse: GPT
    fine: FineGPT
    codec: CodecDecoder
    device: torch.device

    @classmethod
    def build(cls, family: TTSFamily | str, model_name: str | None,
              device: str | torch.device | None, fill, tokenizer=None,
              precast: bool = False) -> "TTSComponents":
        """The four modules with storage on ``device``, each filled by
        ``fill(index, name, module)`` and cast to its config's dtype (before
        the fill with ``precast``); LayerNorms and LM heads stay float32."""
        if isinstance(family, str):
            family = TTS_FAMILIES[family]
        dev = resolve_device(device)
        modules = build_modules([(name, *_ctor(family, name))
                                 for name in MODULES], dev, fill, precast)
        return cls(family=family,
                   model_name=model_name or f"random/{family.name}",
                   tokenizer=tokenizer or hash_tokenizer(family),
                   device=dev, **modules)

    @classmethod
    def random(cls, family: TTSFamily | str, seed: int = 0,
               model_name: str | None = None,
               device: str | torch.device | None = None) -> "TTSComponents":
        """Seeded weights on ``device`` (default ``cuda``)."""

        def fill(index: int, name: str, module: nn.Module) -> None:
            dev = next(module.parameters()).device
            _random_fill(module, torch.Generator(device=dev).manual_seed(
                row_seed(seed, index)))

        return cls.build(family, model_name, device, fill)

    @classmethod
    def from_jax(cls, params: dict[str, Any], family: TTSFamily | str,
                 device: str | torch.device | None = None,
                 model_name: str | None = None) -> "TTSComponents":
        """The JAX package's ``TTSComponents.params``."""
        from chiaswarm_tpu_torch.convert.from_jax import tts_state_from_flax

        if isinstance(family, str):
            family = TTS_FAMILIES[family]
        state = tts_state_from_flax(params, family)

        def fill(index: int, name: str, module: nn.Module) -> None:
            module.load_state_dict(state[name], strict=True)

        return cls.build(family, model_name, device, fill)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str | Path, model_name: str,
                        family: TTSFamily | str | None = None,
                        device: str | torch.device | None = None
                        ) -> "TTSComponents":
        """A transformers ``BarkModel`` directory (``semantic.``,
        ``coarse_acoustics.``, ``fine_acoustics.``, ``codec_model.`` in its
        weight files, through ``convert/checkpoint.py::convert_bark``) and
        its ``vocab.txt`` (WordPiece) if there is one, else the hash
        tokenizer. A missing parameter or a wrong shape raises
        ``CheckpointError``."""
        from chiaswarm_tpu_torch.convert.checkpoint import (
            TensorLander,
            convert_bark,
            fill_module,
            read_weights,
        )

        if isinstance(family, str):
            family = TTS_FAMILIES[family]
        family = family or BARK
        root = Path(checkpoint_dir)
        parts = convert_bark(read_weights(root), family)
        vocab = root / "vocab.txt"
        tokenizer = (WordPieceTokenizer.from_vocab_file(
            vocab, family.max_input_semantic_length) if vocab.exists()
            else hash_tokenizer(family))
        lander = TensorLander(resolve_device(device))

        def fill(index: int, name: str, module: nn.Module) -> None:
            fill_module(module, f"bark_{name}", parts[name], lander, root)

        components = cls.build(family, model_name, device, fill, tokenizer,
                               precast=True)
        lander.finish()
        return components

    def modules(self) -> list[nn.Module]:
        return [getattr(self, name) for name in MODULES]

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())


# --------------------------------------------------------- stage decode

def _categorical(logits: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """One draw per row from softmax(``logits``), Gumbel-max (as
    ``jax.random.categorical``) on the logits' device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.inference_mode()
def _stage_decode(gpt: GPT, prompt_ids: torch.Tensor | None,
                  embeds: torch.Tensor | None, actual_len: int,
                  generator: torch.Generator, *, prefill_len: int,
                  max_new: int, top_k: int, temperature: float,
                  step_masks: torch.Tensor, eos_id: int,
                  pad_id: int) -> torch.Tensor:
    """The semantic and coarse decoder: a padded prefill of ``prompt_ids``
    (B, prefill_len) or ``embeds`` (B, prefill_len, C) with ``actual_len``
    real tokens left-aligned, then ``max_new - 1`` single-token steps.
    ``step_masks`` (2, V) float32 is added to the logits, row
    ``step % 2``; ``eos_id`` < 0 never stops. Returns (B, max_new) int64
    on the model's device."""
    cfg = gpt.config
    src = prompt_ids if embeds is None else embeds
    b, device = src.shape[0], src.device
    ring = prefill_len + max_new
    if ring > cfg.block_size:
        raise ValueError(f"a ring of {ring} exceeds block_size "
                         f"{cfg.block_size}")
    alen = int(actual_len)
    caches = init_caches(cfg, b, device, param_dtype(gpt), length=ring)
    kpos = torch.arange(ring, device=device)
    qpos = torch.arange(prefill_len, device=device)
    ok = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < alen)
    logits, _ = gpt(prompt_ids, caches, 0, embeds=embeds,
                    ring_bias=mask_bias(ok)[None, None])
    last = logits[:, alen - 1]
    # step t's row: the real prompt and the ring slots written so far
    slot = prefill_len + torch.arange(max(max_new - 1, 0),
                                      device=device)[:, None]
    step_bias = mask_bias((kpos[None, :] < alen)
                          | ((kpos[None, :] >= prefill_len)
                             & (kpos[None, :] <= slot)))
    temp = max(float(np.float32(temperature)), 1e-5)

    def pick(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        scaled = (logits + mask) / temp
        if 0 < top_k < scaled.shape[-1]:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, NEG_INF, scaled)
        return _categorical(scaled, generator)

    tok = pick(last, step_masks[0])
    done = tok == eos_id
    out = [tok]
    for t in range(max_new - 1):
        logits, _ = gpt(tok[:, None], caches, prefill_len + t,
                        ring_bias=step_bias[t][None, None, None],
                        pos_index=alen + t)
        nxt = pick(logits[:, 0], step_masks[(t + 1) % 2])
        nxt = torch.where(done, pad_id, nxt)
        done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def encode_semantic_text(tokenizer, text: str, fam: TTSFamily,
                         vocab_size: int) -> np.ndarray:
    """Text ids for the semantic stage, bark's protocol: the tokenizer's
    RAW ids (``tokenize()``: no [CLS]/[SEP], no [PAD]) plus
    ``text_encoding_offset``, clipped to the vocab and padded with
    ``text_pad_token`` to the fixed window (HF modeling_bark.py:635)."""
    L = fam.max_input_semantic_length
    ids = tokenizer.tokenize(text)[:L]
    ids = np.asarray(ids, np.int64) + fam.text_encoding_offset
    text_ids = np.full((1, L), fam.text_pad_token, np.int32)
    text_ids[0, : len(ids)] = np.minimum(ids, vocab_size - 1)
    return text_ids


def _round_semantic(duration_s: float, fam: TTSFamily) -> int:
    """The semantic tokens decoded for ``duration_s``: rounded up to a
    multiple of 32 (at least 8), capped by the stage's context."""
    n_sem = int(min(duration_s * fam.semantic_rate_hz,
                    fam.max_semantic_tokens))
    n_sem = max(8, (n_sem + 31) // 32 * 32)
    return min(n_sem, fam.max_semantic_tokens,
               fam.semantic.block_size - fam.max_input_semantic_length - 2)


class TTSPipeline:
    """The resident bark-protocol executor: ``__call__`` -> (waveform
    float32 (1, samples), sample rate, config)."""

    CODEC_BUCKET = 64

    def __init__(self, components: TTSComponents) -> None:
        self.c = components

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return upload(torch.from_numpy(np.ascontiguousarray(array)),
                      self.c.device)

    # ---- stage 1: text -> semantic tokens ----
    @torch.inference_mode()
    def semantic_embeds(self, text: str, history: np.ndarray | None
                        ) -> torch.Tensor:
        """The semantic prefill (1, L + 1, C): the text's and the history's
        embeddings summed in float32 before the cast (JAX :361-366), then
        the infer token's."""
        fam = self.c.family
        L = fam.max_input_semantic_length
        text_ids = encode_semantic_text(self.c.tokenizer, text, fam,
                                        fam.semantic.vocab_size)
        hist = np.full((1, L), fam.semantic_vocab, np.int32)  # semantic pad
        if history is not None:
            h = np.asarray(history, np.int32).reshape(-1)[-L:]
            hist[0, : len(h)] = h
        ids = self._upload(np.concatenate(
            [text_ids, hist, [[fam.semantic_infer_token]]], axis=1)
            .astype(np.int64))
        table = self.c.semantic.input_embeds_layer.weight
        dtype = param_dtype(self.c.semantic)
        emb = (table[ids[:, :L]].float() + table[ids[:, L:2 * L]].float())
        return torch.cat([emb.to(dtype), table[ids[:, 2 * L:]].to(dtype)],
                         dim=1)

    @torch.inference_mode()
    def _semantic(self, text: str, generator: torch.Generator,
                  temperature: float, top_k: int, max_new: int,
                  history: np.ndarray | None) -> np.ndarray:
        fam = self.c.family
        cfg = fam.semantic
        L = fam.max_input_semantic_length
        embeds = self.semantic_embeds(text, history)
        # suppress everything outside [0, semantic_vocab] (eos == vocab)
        mask = np.full(cfg.out_vocab, NEG_INF, np.float32)
        mask[: fam.semantic_vocab + 1] = 0.0
        masks = self._upload(np.stack([mask, mask]))
        out = _stage_decode(
            self.c.semantic, None, embeds, L + 1, generator,
            prefill_len=L + 1, max_new=max_new, top_k=top_k,
            temperature=temperature, step_masks=masks,
            eos_id=fam.semantic_vocab, pad_id=fam.semantic_vocab)
        sem = out[0].cpu().numpy()
        ends = np.nonzero(sem == fam.semantic_vocab)[0]
        return sem[: int(ends[0])] if len(ends) else sem

    # ---- stage 2: semantic -> coarse codes (sliding windows) ----
    def _coarse_history(self, history, ratio: float, max_sem_hist: int
                        ) -> tuple[np.ndarray, list[int]]:
        """Bark's preprocess_histories: each coarse codebook row offset
        into the shared vocab, flattened time-major, both histories
        aligned and trimmed (with bark's ``[:-2]``)."""
        fam = self.c.family
        if history is None or "coarse_prompt" not in history \
                or "semantic_prompt" not in history:
            return np.zeros(0, np.int32), []
        sem_h = np.asarray(history["semantic_prompt"], np.int32).reshape(-1)
        coarse_h = np.array(history["coarse_prompt"], np.int64)
        coarse_h = coarse_h.reshape(-1, coarse_h.shape[-1])[: fam.n_coarse]
        for n in range(1, coarse_h.shape[0]):
            coarse_h[n] += fam.codebook_size * n
        flat = coarse_h.T.reshape(-1) + fam.semantic_vocab
        n_sem = min(max_sem_hist, len(sem_h) - len(sem_h) % 2,
                    int(np.floor(len(flat) / ratio)))
        n_coarse_h = int(round(n_sem * ratio))
        sem_h = sem_h[len(sem_h) - n_sem:] if n_sem else sem_h[:0]
        flat = flat[len(flat) - n_coarse_h:][:-2]  # bark's alignment trim
        return sem_h.astype(np.int32), flat.astype(np.int32).tolist()

    @torch.inference_mode()
    def _coarse(self, semantic: np.ndarray, generator: torch.Generator,
                temperature: float, top_k: int, history=None) -> np.ndarray:
        fam = self.c.family
        ratio = fam.coarse_rate_hz / fam.semantic_rate_hz * fam.n_coarse
        max_sem_hist = int(np.floor(fam.max_coarse_history / ratio))
        n_total = int(round(int(np.floor(
            len(semantic) * ratio / fam.n_coarse)) * fam.n_coarse))
        n_total = max(fam.n_coarse, n_total)
        sw = fam.sliding_window_len
        P = fam.coarse_prefill

        sem_hist, x_coarse = self._coarse_history(history, ratio,
                                                  max_sem_hist)
        len_history = len(x_coarse)
        base_sem_idx = len(sem_hist)
        sem = np.concatenate([sem_hist, semantic.astype(np.int32)])
        masks = np.full((2, fam.coarse.out_vocab), NEG_INF, np.float32)
        lo = fam.semantic_vocab
        masks[0, lo: lo + fam.codebook_size] = 0.0
        masks[1, lo + fam.codebook_size: lo + 2 * fam.codebook_size] = 0.0
        masks = self._upload(masks)

        for _ in range(int(np.ceil(n_total / sw))):
            generated = len(x_coarse) - len_history
            sem_idx = base_sem_idx + int(round(generated / ratio))
            window = sem[max(0, sem_idx - max_sem_hist):]
            window = window[: fam.max_coarse_input_length]
            inp = np.full(fam.max_coarse_input_length,
                          fam.coarse_semantic_pad, np.int32)
            inp[: len(window)] = window
            hist = np.asarray(x_coarse[-fam.max_coarse_history:], np.int32)
            prompt = np.concatenate(
                [inp, [fam.coarse_infer_token], hist]).astype(np.int64)
            actual = len(prompt)
            prompt = np.pad(prompt, (0, P - actual))[None]
            out = _stage_decode(
                self.c.coarse, self._upload(prompt), None, actual, generator,
                prefill_len=P, max_new=sw, top_k=top_k,
                temperature=temperature, step_masks=masks, eos_id=-1,
                pad_id=0)
            take = min(sw, n_total - (len(x_coarse) - len_history))
            x_coarse.extend(out[0, :take].cpu().tolist())
        return np.asarray(x_coarse[len_history:], np.int32)

    # ---- stage 3: coarse -> all fine codebooks (window fills) ----
    @torch.inference_mode()
    def _fine(self, coarse: np.ndarray, generator: torch.Generator,
              temperature: float | None, history=None) -> np.ndarray:
        fam = self.c.family
        cbs = fam.codebook_size
        frames = len(coarse) // fam.n_coarse
        codes = (coarse[: frames * fam.n_coarse].reshape(frames,
                                                         fam.n_coarse)
                 - fam.semantic_vocab) % cbs
        buf = np.full((frames, fam.n_fine), cbs, np.int64)  # pad token
        buf[:, : fam.n_coarse] = codes

        W, H = fam.fine_input_length, fam.fine_history_length
        n_history = 0
        if history is not None and "fine_prompt" in history:
            fh = np.asarray(history["fine_prompt"],
                            np.int64).reshape(fam.n_fine, -1).T % cbs
            fh = fh[-H:]
            n_history = len(fh)
            buf = np.concatenate([fh, buf], axis=0)
        n_remove = max(0, W - buf.shape[0])
        if n_remove:
            buf = np.pad(buf, ((0, n_remove), (0, 0)), constant_values=cbs)
        n_loops = max(0, int(np.ceil((frames - (W - n_history)) / H))) + 1
        total = buf.shape[0]
        dev_buf = self._upload(buf)
        for n in range(n_loops):
            start = min(n * H, total - W)
            fill_start = min(n_history + n * H, total - H)
            rel = fill_start - start
            window = dev_buf[None, start: start + W].clone()
            for ci in range(fam.n_coarse, fam.n_fine):
                rel_logits = self.c.fine(window, ci)[0, :, :cbs]
                if temperature is None or temperature <= 1e-4:
                    preds = rel_logits.argmax(dim=-1)
                else:
                    preds = _categorical(rel_logits / temperature, generator)
                window[0, rel:, ci] = preds[rel:]
            dev_buf[start: start + W] = window[0]
        buf = dev_buf.cpu().numpy()
        if n_remove:
            buf = buf[:-n_remove]
        return (buf[n_history:].T % cbs).astype(np.int32)  # (n_fine, frames)

    # ---- stage 4: codes -> waveform ----
    @torch.inference_mode()
    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """(books, frames) codes -> (1, frames x hop) float32: the codec on
        a static frame bucket (right-padded with code 0), trimmed (causal
        decode keeps the kept samples exact)."""
        frames = codes.shape[1]
        q = self.CODEC_BUCKET
        bucket = max(q, (frames + q - 1) // q * q)
        padded = np.pad(codes, ((0, 0), (0, bucket - frames)))
        wav = self.c.codec(self._upload(padded[None].astype(np.int64)))
        return wav.cpu().numpy()[:, : frames * self.c.family.codec.hop_length]

    def generator(self, seed: int) -> torch.Generator:
        """The job's one sampling stream, on the modules' device."""
        return torch.Generator(device=self.c.device).manual_seed(
            row_seed(seed, 0))

    def __call__(self, text: str, duration_s: float = 4.0, seed: int = 0,
                 temperature: float = 0.7, top_k: int = 50,
                 voice_preset_tokens: list[int] | None = None,
                 history: dict[str, np.ndarray] | None = None,
                 ) -> tuple[np.ndarray, int, dict]:
        fam = self.c.family
        gen = self.generator(seed)
        n_sem = _round_semantic(duration_s, fam)
        if history is None and voice_preset_tokens:
            history = {"semantic_prompt": np.asarray(voice_preset_tokens)}
        sem_hist = None
        if history is not None and "semantic_prompt" in history:
            sem_hist = history["semantic_prompt"]
        max_possible = fam.max_semantic_tokens / fam.semantic_rate_hz
        if duration_s > max_possible + 0.25:
            log.warning(
                "tts request for %.1f s truncated to %.2f s by the semantic "
                "stage context (max %d tokens @ %.1f Hz)", duration_s,
                max_possible, fam.max_semantic_tokens, fam.semantic_rate_hz)
        semantic = self._semantic(text, gen, temperature, top_k, n_sem,
                                  sem_hist)
        if len(semantic) == 0:
            semantic = np.zeros(8, np.int32)
        coarse = self._coarse(semantic, gen, temperature, top_k,
                              history=history)
        fine = self._fine(coarse, gen,
                          temperature if fam.n_fine > fam.n_coarse
                          else None, history=history)
        frames = fine.shape[1]
        books = min(fam.codec.n_codebooks, fine.shape[0])
        wav = self.decode_codes(fine[:books])
        sr = fam.codec.sampling_rate
        config = {
            "model_name": self.c.model_name,
            "family": fam.name,
            "mode": "tts",
            "semantic_tokens": int(len(semantic)),
            "frames": int(frames),
            "requested_duration_s": float(duration_s),
            "duration_s": round(wav.shape[1] / sr, 3),
            "sample_rate": sr,
        }
        return wav, sr, config
