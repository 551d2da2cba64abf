"""The captioning and VQA pipeline (img2txt), counterpart of
``chiaswarm_tpu/pipelines/caption.py``.

- caption: the vision encode, then the greedy cross-attending decode over
  the image states (``models/blip.py::generate_text``). A prompt conditions
  the caption: [DEC] + its first 16 WordPiece tokens, padded to the static
  bucket :data:`CaptionPipeline.PROMPT_BUCKET` with ``actual_len``, and the
  text comes back with the head that conditioned it (the prompt itself, or
  the decoded tokens that fit the bucket when it overflows).
- VQA (the hive's ``*QuestionAnswering`` model type): the question,
  [CLS] + tokens + [SEP] padded to 32, through the question tower
  (bidirectional, cross-attending the image), then the answer decoder from
  [DEC] over the question states, the question's pad mask as its cross
  bias.

The host resizes the image (bicubic, to ``image_size``), normalizes it by
CLIP's mean and std and decodes the WordPiece ids. The modules live on one
device (``cuda`` unless the caller passes another) in the config's dtype
(float32 for BLIP).

:class:`CaptionComponents` builds them from a seed (:meth:`random`, Flax's
default distributions; class and position embeddings N(0, 0.02)), from the
JAX package's params (:meth:`from_jax`, the parity tests) or from a
transformers-layout directory (:meth:`from_checkpoint`: ``model.safetensors``
or torch files of ``BlipForConditionalGeneration`` /
``BlipForQuestionAnswering`` and a ``vocab.txt``; a ``text_encoder.`` key
means a question tower). :func:`transformers_state` writes the layout back.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.core.device import resolve_device, upload
from chiaswarm_tpu_torch.core.rng import row_seed
from chiaswarm_tpu_torch.models.blip import (
    BLIP_CONFIGS,
    BlipConfig,
    BlipTextModel,
    BlipVisionEncoder,
    generate_text,
)
from chiaswarm_tpu_torch.models.tokenizer import WordPieceTokenizer
from chiaswarm_tpu_torch.pipelines.components import _DTYPES, flax_default_init


def _tiny_vocab() -> dict[str, int]:
    """The JAX package's synthetic WordPiece vocab of tiny BLIP (ids <
    1000)."""
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 999,
             "[DEC]": 998}
    i = 1
    while len(vocab) < 990:
        if i not in (100, 101, 998, 999):
            vocab[f"tok{i}"] = i
        i += 1
    return vocab


def _modules(config: BlipConfig, vqa: bool, device: torch.device
             ) -> tuple[BlipVisionEncoder, BlipTextModel, BlipTextModel | None]:
    """The towers with uninitialized storage on ``device``."""
    with torch.device("meta"):
        vision = BlipVisionEncoder(config.vision)
        decoder = BlipTextModel(config.text)
        encoder = (BlipTextModel(config.text, with_lm_head=False)
                   if vqa else None)
    return tuple(None if m is None else m.to_empty(device=device)
                 for m in (vision, decoder, encoder))


@dataclasses.dataclass
class CaptionComponents:
    config: BlipConfig
    model_name: str
    tokenizer: WordPieceTokenizer
    vision: BlipVisionEncoder
    decoder: BlipTextModel
    encoder: BlipTextModel | None  # VQA's question tower (None: caption only)
    device: torch.device

    @classmethod
    def _build(cls, config: BlipConfig | str, model_name: str,
               tokenizer: WordPieceTokenizer, vqa: bool,
               device: str | torch.device | None, fill) -> "CaptionComponents":
        if isinstance(config, str):
            config = BLIP_CONFIGS[config]
        dev = resolve_device(device)
        vision, decoder, encoder = _modules(config, vqa, dev)
        named = [("vision", vision), ("decoder", decoder)]
        if encoder is not None:
            named.append(("encoder", encoder))
        dtype = _DTYPES[config.vision.dtype]
        for index, (name, module) in enumerate(named):
            fill(index, name, module)
            module.to(dtype).eval().requires_grad_(False)
        return cls(config=config, model_name=model_name, tokenizer=tokenizer,
                   vision=vision, decoder=decoder, encoder=encoder, device=dev)

    @classmethod
    def random(cls, config: BlipConfig | str = "blip_tiny", seed: int = 0,
               model_name: str | None = None, vqa: bool = True,
               device: str | torch.device | None = None,
               tokenizer: WordPieceTokenizer | None = None
               ) -> "CaptionComponents":
        """Seeded weights with Flax's default distributions. A tiny config
        takes the JAX package's synthetic vocab; a real vocab's config
        needs its ``tokenizer`` (JAX refuses it, having no vocab file)."""
        if isinstance(config, str):
            config = BLIP_CONFIGS[config]
        if tokenizer is None:
            if config.text.vocab_size >= 30000:
                raise ValueError("random() is for tiny configs; real vocabs "
                                 "need a checkpoint (from_checkpoint) or a "
                                 "tokenizer")
            tokenizer = WordPieceTokenizer(_tiny_vocab())

        @torch.no_grad()
        def fill(index: int, name: str, module: nn.Module) -> None:
            gen = torch.Generator(device=next(module.parameters()).device)
            gen.manual_seed(row_seed(seed, index))
            flax_default_init(module, gen)
            if isinstance(module, BlipVisionEncoder):
                emb = module.embeddings
                emb.class_embedding.normal_(0.0, 0.02, generator=gen)
                emb.position_embedding.normal_(0.0, 0.02, generator=gen)

        return cls._build(config, model_name or f"random/{config.name}",
                          tokenizer, vqa, device, fill)

    @classmethod
    def from_jax(cls, params: dict[str, Any], config: BlipConfig | str,
                 model_name: str = "", device: str | torch.device | None = None
                 ) -> "CaptionComponents":
        """The JAX package's ``CaptionComponents.params`` (``vision``,
        ``decoder`` and, for VQA, ``encoder``), the synthetic tiny vocab."""
        from chiaswarm_tpu_torch.convert.from_jax import blip_state_from_flax

        state = {name: blip_state_from_flax(tree, name)
                 for name, tree in params.items()}

        def fill(index: int, name: str, module: nn.Module) -> None:
            module.load_state_dict(state[name], strict=True)

        return cls._build(config, model_name, WordPieceTokenizer(_tiny_vocab()),
                          "encoder" in params, device, fill)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str | Path, model_name: str,
                        config: BlipConfig | str = "blip_base",
                        device: str | torch.device | None = None
                        ) -> "CaptionComponents":
        """A transformers-layout BLIP directory: its weight files (read by
        ``convert/checkpoint.py::read_weights``) and ``vocab.txt``. A
        missing parameter or a wrong shape raises ``CheckpointError``."""
        from chiaswarm_tpu_torch.convert.checkpoint import (
            TensorLander,
            convert_blip_text,
            convert_blip_vision,
            fill_module,
            read_weights,
        )

        checkpoint_dir = Path(checkpoint_dir)
        vocab = checkpoint_dir / "vocab.txt"
        if not vocab.exists():
            raise FileNotFoundError(f"no vocab.txt under {checkpoint_dir}")
        state = read_weights(checkpoint_dir)
        parts = {"vision": convert_blip_vision(state),
                 "decoder": convert_blip_text(state, "text_decoder.")}
        vqa = any(k.startswith("text_encoder.") for k in state)
        if vqa:
            parts["encoder"] = convert_blip_text(state, "text_encoder.",
                                                 with_lm_head=False)
        lander = TensorLander(resolve_device(device))

        def fill(index: int, name: str, module: nn.Module) -> None:
            fill_module(module, f"blip_{name}", parts[name], lander,
                        checkpoint_dir)

        components = cls._build(config, model_name,
                                WordPieceTokenizer.from_vocab_file(vocab), vqa,
                                device, fill)
        lander.finish()
        return components

    def modules(self) -> list[nn.Module]:
        return [m for m in (self.vision, self.decoder, self.encoder)
                if m is not None]

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())


def transformers_state(c: CaptionComponents) -> dict[str, torch.Tensor]:
    """The components' weights in the transformers layout
    ``from_checkpoint`` reads (``BlipForQuestionAnswering`` when there is a
    question tower, else ``BlipForConditionalGeneration``)."""
    out = {}
    for key, value in c.vision.state_dict().items():
        if key == "embeddings.class_embedding":
            value = value.reshape(1, 1, -1)
        elif key == "embeddings.position_embedding":
            value = value[None]
        out["vision_model." + key] = value
    for key, value in c.decoder.state_dict().items():
        out["text_decoder." + ("" if key.startswith("cls.") else "bert.")
            + key] = value
    # transformers stores the LM head's bias twice (tied to the decoder's)
    out["text_decoder.cls.predictions.bias"] = \
        c.decoder.cls.predictions.decoder.bias
    if c.encoder is not None:
        out.update(("text_encoder." + k, v)
                   for k, v in c.encoder.state_dict().items())
    return out


class CaptionPipeline:
    """``__call__(image, prompt, vqa=...) -> text``. The hive's model type,
    not the checkpoint, picks the mode: ``vqa=True`` answers the prompt
    through the question tower; otherwise a prompt conditions the
    caption."""

    # conditioning prompts pad to one static bucket ([DEC] + 16 tokens)
    PROMPT_BUCKET = 17
    QUESTION_LEN = 32

    def __init__(self, components: CaptionComponents,
                 max_new_tokens: int = 24) -> None:
        self.c = components
        self.max_new = max_new_tokens

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 -> (1, 3, S, S) float32 on the device: bicubic
        resize to the tower's ``image_size``, CLIP's mean and std."""
        from PIL import Image

        size = self.c.config.vision.image_size
        pil = Image.fromarray(np.asarray(image).astype(np.uint8)).convert("RGB")
        pil = pil.resize((size, size), Image.BICUBIC)
        arr = np.asarray(pil, np.float32) / 255.0
        mean = np.asarray(self.c.config.pixel_mean, np.float32)
        std = np.asarray(self.c.config.pixel_std, np.float32)
        pixels = torch.from_numpy((arr - mean) / std).permute(2, 0, 1)[None]
        return upload(pixels.contiguous(), self.c.device)

    def _ids(self, ids: list[int]) -> torch.Tensor:
        return upload(torch.tensor([ids], dtype=torch.int64), self.c.device)

    @torch.inference_mode()
    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        return self.c.vision(self.preprocess(image))

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, prompt: str = "",
                 vqa: bool | None = None) -> str:
        c = self.c
        vqa = bool(vqa)
        if vqa and c.encoder is None:
            raise ValueError(
                f"{c.model_name!r} has no question tower (VQA requested)")
        enc_states = self.encode_image(image)
        bos = c.config.text.bos_token_id

        if vqa and prompt:
            q_ids = self._ids(c.tokenizer.encode(prompt, self.QUESTION_LEN))
            q_mask = (q_ids != c.tokenizer.pad_id).to(torch.int32)
            q_states = c.encoder(q_ids, causal=False, attn_mask=q_mask,
                                 cross_kvs=c.encoder.cross_kvs(enc_states),
                                 logits=False)
            ids = generate_text(c.decoder, self._ids([bos]), q_states, q_mask,
                                prompt_len=1, max_new=self.max_new)
            return c.tokenizer.decode(ids[0].cpu().tolist())

        cond_tokens = c.tokenizer.tokenize(prompt) if prompt else []
        used = cond_tokens[: self.PROMPT_BUCKET - 1]
        prefix = [bos] + used
        actual = len(prefix)
        if prompt:
            bucket = self.PROMPT_BUCKET
            prefix = prefix + [c.tokenizer.pad_id] * (bucket - actual)
        else:
            bucket = 1
        ids = generate_text(c.decoder, self._ids(prefix), enc_states, None,
                            prompt_len=bucket, max_new=self.max_new,
                            actual_len=actual)
        text = c.tokenizer.decode(ids[0].cpu().tolist())
        if prompt:
            # echo only what conditioned the decode: an overflowing prompt's
            # full text would claim a prefix the model never saw
            head = (prompt.strip() if len(used) == len(cond_tokens)
                    else c.tokenizer.decode(used))
            text = f"{head} {text}".strip()
        return text
