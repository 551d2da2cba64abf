"""Diffusers-layout checkpoint directories -> the port's modules, the
counterpart of ``chiaswarm_tpu/convert/torch_to_flax.py``:
``read_torch_weights`` (:38-68), ``load_checkpoint`` (:939-958) and the
name rules of ``convert_vae`` (:448-508), ``convert_text_encoder``
(:579-614), ``convert_controlnet`` (:403-440) and ``convert_safety_checker``
(:877-926).

A snapshot holds one subdirectory per module (``unet/``, ``vae/``,
``text_encoder/``, ``text_encoder_2/`` for a second tower), each with
``*.safetensors`` files (read through ``convert/safetensors_io.py``, no
``safetensors`` package) or ``*.bin``/``*.pt``/``*.pth``/``*.ckpt`` files
(``torch.load(weights_only=True)``, a ``"state_dict"`` unwrapped). Where a
directory holds safetensors files the others are not read: published
snapshots carry the same weights in both formats (the JAX reader reads
both; the later file's keys win there as here). A key found in several
files takes the later file's value, in name order.

The port's modules carry diffusers/transformers names already, so loading
is a name check plus the aliases the JAX converters accept:

- the old VAE attention names ``query``/``key``/``value``/``proj_attn``
  -> ``to_q``/``to_k``/``to_v``/``to_out.0``, their ``(O, I, 1, 1)``
  projections squeezed to ``(O, I)``;
- ``to_out.<leaf>`` -> ``to_out.0.<leaf>`` (the JAX converters accept both);
- a text tower's keys without the ``text_model.`` prefix; its
  ``position_ids`` buffer (older CLIP checkpoints) is skipped.

A ControlNet directory (diffusers ``ControlNetModel``) loads by the UNet's
rules: its trunk has the UNet's names, beside ``controlnet_cond_embedding.*``,
``controlnet_down_blocks.{i}`` and ``controlnet_mid_block``. A safety checker
(``StableDiffusionSafetyChecker``) splits into its vision tower, nested under
``vision_model.vision_model.`` beside ``visual_projection.weight``, and the
four concept buffers (:func:`split_safety_checker`); a missing buffer
raises, as in JAX.

A DeepFloyd-class cascade snapshot (:func:`load_cascade_checkpoint`, JAX
:699-727) holds ``text_encoder/`` (a transformers ``T5EncoderModel``:
``shared.weight``, or its tied alias ``encoder.embed_tokens.weight``, and
``encoder.*``; JAX's names :665-697), ``unet/`` (stage 1) and ``unet_sr/``
(stage 2), with a ``tokenizer.json`` or none. The x4 upscaler loads as any
diffusers snapshot (``Components.from_checkpoint``): its UNet's
``class_embedding.weight`` table, the three-level f = 4 VAE and the ViT-H
text tower by their names.

A video snapshot (:func:`load_video_checkpoint`) holds ``unet/``, ``vae/``
and ``text_encoder/`` or ``image_encoder/``: a ModelScope or SVD UNet and
SVD's temporal VAE load strictly (:func:`check_strict`: a missing, extra or
misshapen key raises ``ValueError`` in JAX's words), and a plain SD UNet
inflates into a text family (:func:`inflate_2d`).

Keys with no parameter in the port are skipped with a debug log, as JAX
skips them. A parameter the checkpoint lacks, a shape that does not match,
a directory without weight files or a malformed file raises
:class:`CheckpointError`: nothing is filled in at random.

:class:`TensorLander` puts each tensor in its parameter as it is read, so
a load holds the modules at their serving dtypes plus one tensor in
flight. On a card it copies through a pinned staging buffer on a stream of
its own, timing the file read (the mapped pages faulted into the staging
buffer) apart from the device copy. Once a module's parameters are
allocated, that stream waits for the work queued so far on the current
stream: the caching allocator may hand a parameter a block that kernels
queued there (a lane's step on another thread) still read or write. It
synchronises after each copy, so a pipeline loaded on a background thread
is complete when it is handed over.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import torch
from torch import nn

from chiaswarm_tpu_torch.convert.safetensors_io import (
    SafetensorsError,
    SafetensorsFile,
)

log = logging.getLogger("chiaswarm_torch.convert")

#: module -> its subdirectory in a snapshot (JAX ``_SUBDIR_CANDIDATES``)
SUBDIRS = {"unet": "unet", "vae": "vae", "text_encoder_0": "text_encoder",
           "text_encoder_1": "text_encoder_2"}

_OTHER_PATTERNS = ("*.bin", "*.pt", "*.pth", "*.ckpt")

_VAE_ATTN_ALIASES = {"query": "to_q", "key": "to_k", "value": "to_v",
                     "proj_attn": "to_out.0"}


#: the safety checker's concept buffers, each required
SAFETY_BUFFERS = ("concept_embeds", "concept_embeds_weights",
                  "special_care_embeds", "special_care_embeds_weights")

_CHECKER_TRUNK = "vision_model.vision_model."


class CheckpointError(RuntimeError):
    """A checkpoint directory that cannot fill the model: no weight
    files, a malformed file, a missing parameter or a wrong shape."""


def weight_files(path: str | Path) -> list[Path]:
    """The weight files of one module directory: its safetensors files,
    else its torch pickles."""
    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        for pattern in _OTHER_PATTERNS:
            files.extend(sorted(path.glob(pattern)))
    if not files:
        raise CheckpointError(f"no weight files under {path}")
    return files


def read_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor under ``path``, on the host: safetensors tensors share
    their file's mapping, pickled ones are loaded. Non-tensor entries of a
    pickle are dropped."""
    state: dict[str, torch.Tensor] = {}
    for file in weight_files(path):
        if file.suffix == ".safetensors":
            try:
                st = SafetensorsFile(file)
            except SafetensorsError as exc:
                raise CheckpointError(str(exc)) from exc
            state.update(st.tensors())
            continue
        raw = torch.load(str(file), map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        if not isinstance(raw, dict):
            raise CheckpointError(f"{file} holds a {type(raw).__name__}, "
                                  "not a state dict")
        state.update((k, v) for k, v in raw.items()
                     if isinstance(v, torch.Tensor))
    return state


def canonical_name(module: str, key: str) -> str | None:
    """The port's parameter name for checkpoint key ``key`` of ``module``
    (``unet``/``vae``/``text_encoder_{i}``), or None for a key the JAX
    converters skip by rule."""
    parts = key.split(".")
    if module.startswith("text_encoder"):
        if parts[-1] == "position_ids":
            return None
        if parts[0] not in ("text_model", "text_projection"):
            parts.insert(0, "text_model")
        return ".".join(parts)
    if module == "vae" and len(parts) >= 2 and parts[-2] in _VAE_ATTN_ALIASES:
        parts[-2] = _VAE_ATTN_ALIASES[parts[-2]]
    elif len(parts) >= 2 and parts[-2] == "to_out":
        parts.insert(-1, "0")
    return ".".join(parts)


class TensorLander:
    """Copies host tensors into parameters one at a time. On a card:
    through a pinned staging buffer, on a stream of its own, synchronised
    after each tensor, so ``read_s`` (into the staging buffer) and
    ``copy_s`` (to the card) split the load. :meth:`after_allocation`
    orders the copies after the kernels already queued on the device's
    current stream. :meth:`finish` leaves nothing in flight."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.read_s = 0.0
        self.copy_s = 0.0
        self.bytes = 0
        self.tensors = 0
        self._staging: torch.Tensor | None = None
        self._stream = None
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)

    def after_allocation(self) -> None:
        """Make the copies that follow wait for the work queued so far on
        the current stream. Call it once the parameters they fill are
        allocated: a block freed there is handed out again at once, while
        kernels queued before the free (another thread's) may still use
        it."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _buffer(self, nbytes: int) -> torch.Tensor:
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                        pin_memory=True)
        return self._staging[:nbytes]

    @torch.no_grad()
    def land(self, param: torch.Tensor, src: torch.Tensor) -> None:
        t0 = time.perf_counter()
        src = src.contiguous()
        nbytes = src.numel() * src.element_size()
        if self._stream is None:
            t1 = time.perf_counter()
            param.copy_(src)
        else:
            staging = self._buffer(nbytes)
            if nbytes:
                staging.copy_(src.reshape(-1).view(torch.uint8))
            host = staging.view(src.dtype).view(src.shape)
            t1 = time.perf_counter()
            with torch.cuda.stream(self._stream):
                param.copy_(host, non_blocking=True)
            self._stream.synchronize()
        self.read_s += t1 - t0
        self.copy_s += time.perf_counter() - t1
        self.bytes += nbytes
        self.tensors += 1

    def finish(self) -> dict:
        if self._stream is not None:
            self._stream.synchronize()
        self._staging = None
        return {"read_s": self.read_s, "copy_s": self.copy_s,
                "bytes_read": self.bytes, "tensors": self.tensors}


def split_safety_checker(state: dict[str, torch.Tensor]
                         ) -> tuple[dict[str, torch.Tensor],
                                    dict[str, torch.Tensor]]:
    """A safety checker's state dict -> (vision tower state in the port's
    ``ClipVisionEncoder`` names, the four concept buffers), by JAX's
    ``convert_safety_checker`` rules: the trunk under
    ``vision_model.vision_model.`` loses its outer ``vision_model.``,
    ``visual_projection.weight`` stays, anything else is skipped. Raises
    :class:`CheckpointError` when a buffer is missing."""
    tower: dict[str, torch.Tensor] = {}
    buffers: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key in SAFETY_BUFFERS:
            buffers[key] = value
        elif key == "visual_projection.weight":
            tower[key] = value
        elif key.startswith(_CHECKER_TRUNK):
            tower[key[len("vision_model."):]] = value
        else:
            log.debug("safety checker conversion skipped %s", key)
    missing = [k for k in SAFETY_BUFFERS if k not in buffers]
    if missing:
        raise CheckpointError(f"safety checker state is missing {missing}")
    return tower, buffers


def load_module(module: nn.Module, name: str, path: str | Path,
                lander: TensorLander) -> list[str]:
    """Fill every parameter of ``module`` (the port's ``name`` module,
    storage already on its device at its serving dtypes) from the weight
    files under ``path``. Returns the checkpoint keys skipped."""
    return fill_module(module, name, read_weights(path), lander, path)


def fill_module(module: nn.Module, name: str,
                state: dict[str, torch.Tensor], lander: TensorLander,
                path: str | Path) -> list[str]:
    """:func:`load_module` on a state dict already read from ``path``."""
    params = dict(module.named_parameters())
    source: dict[str, str] = {}
    skipped: list[str] = []
    for key in state:
        target = canonical_name(name, key)
        if target is None or target not in params:
            skipped.append(key)
        else:
            source[target] = key
    missing = sorted(set(params) - set(source))
    if missing:
        raise CheckpointError(
            f"{name} checkpoint at {path} lacks {len(missing)} parameter(s): "
            f"{', '.join(missing[:8])}{' ...' if len(missing) > 8 else ''}")
    lander.after_allocation()
    for target, param in params.items():
        value = state[source[target]]
        if (name == "vae" and param.dim() == 2 and value.dim() == 4
                and tuple(value.shape[2:]) == (1, 1)):
            value = value[:, :, 0, 0]
        if tuple(value.shape) != tuple(param.shape):
            raise CheckpointError(
                f"{name} checkpoint key {source[target]!r} has shape "
                f"{tuple(value.shape)}; the port's {target} is "
                f"{tuple(param.shape)}")
        lander.land(param, value)
    if skipped:
        log.debug("%s: skipped %d checkpoint key(s) with no counterpart "
                  "(e.g. %s)", name, len(skipped), skipped[0])
    return skipped



# ------------------------------------------------------------------ BLIP

def _strip(state: dict[str, torch.Tensor], prefix: str
           ) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def convert_blip_vision(state: dict[str, torch.Tensor],
                        prefix: str = "vision_model."
                        ) -> dict[str, torch.Tensor]:
    """A transformers ``BlipVisionModel`` state (under ``prefix``) -> the
    port's ``models/blip.py::BlipVisionEncoder`` names, by JAX's
    ``convert_blip_vision`` (``torch_to_flax.py:975-1000``): the class and
    position embeddings lose their leading unit axes; the rest keeps its
    names (the port's modules carry transformers' names)."""
    s = _strip(state, prefix)
    out = {}
    for key, value in s.items():
        if key == "embeddings.class_embedding":
            value = value.reshape(-1)
        elif key == "embeddings.position_embedding":
            value = value.reshape(value.shape[-2:])
        elif key.endswith("position_ids"):
            continue
        out[key] = value
    return out


def convert_blip_text(state: dict[str, torch.Tensor], prefix: str,
                      with_lm_head: bool = True) -> dict[str, torch.Tensor]:
    """A transformers ``BlipTextModel``/``BlipTextLMHeadModel`` state under
    ``prefix`` (``text_decoder.``: the caption and answer head;
    ``text_encoder.``: VQA's question tower, ``with_lm_head=False``) -> the
    port's ``BlipTextModel`` names, by JAX's ``convert_blip_text``
    (``torch_to_flax.py:1003-1057``): an LM-head model's trunk nests under
    ``bert.``; the decoder's weight may be tied to the word embeddings and
    absent, and its bias may be stored as ``cls.predictions.bias``."""
    s = _strip(state, prefix)
    if any(k.startswith("bert.") for k in s):
        trunk = _strip(s, "bert.")
    else:
        trunk = s
    out = {k: v for k, v in trunk.items()
           if k.startswith(("embeddings.", "encoder."))
           and not k.endswith("position_ids")}
    if with_lm_head:
        head = "cls.predictions."
        out.update((k, v) for k, v in s.items()
                   if k.startswith(head + "transform."))
        out[head + "decoder.weight"] = s.get(
            head + "decoder.weight",
            trunk["embeddings.word_embeddings.weight"])
        bias = s.get(head + "decoder.bias", s.get(head + "bias"))
        if bias is not None:  # else fill_module names the missing bias
            out[head + "decoder.bias"] = bias
    return out


# --------------------------------------------------------------- AudioLDM

#: an AudioLDM snapshot's module subdirectories
AUDIO_SUBDIRS = {"text_encoder": "text_encoder", "unet": "unet", "vae": "vae",
                 "vocoder": "vocoder"}


def convert_clap_text(state: dict[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """A transformers ``ClapTextModelWithProjection`` state -> the port's
    ``models/clap.py`` names, by JAX's ``convert_clap_text``
    (``torch_to_flax.py:617-654``): the trunk with or without its
    ``text_model.`` prefix, ``text_projection.linear1``/``linear2``; the
    embeddings' ``position_ids``/``token_type_ids`` buffers are skipped."""
    out = {}
    for key, value in state.items():
        k = key.removeprefix("text_model.")
        if k.startswith("embeddings.") and k.count(".") == 1:
            continue  # non-parameter buffers
        out[k if k.startswith("text_projection.") else "text_model." + k] = value
    return out


def fold_weight_norm(state: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """Weight-norm pairs folded into plain ``weight`` tensors, w = g v /
    ||v|| (the norm over every axis but 0, torch's default), for both
    spellings JAX folds (``torch_to_flax.py:733-755``, :1085-1090):
    ``weight_g``/``weight_v`` and ``parametrizations.weight.original0``/
    ``original1``."""
    spellings = ((".weight_v", ".weight_g"),
                 (".parametrizations.weight.original1",
                  ".parametrizations.weight.original0"))
    for v_suffix, g_suffix in spellings:
        folded = {}
        for key, value in state.items():
            if key.endswith(v_suffix):
                base = key[: -len(v_suffix)]
                g, v = state[base + g_suffix].float(), value.float()
                norm = v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                    keepdim=True).sqrt()
                folded[base + ".weight"] = g * v / norm.clamp_min(1e-12)
            elif not key.endswith(g_suffix):
                folded[key] = value
        state = folded
    return state


def load_audio_checkpoint(checkpoint_dir: str | Path, model_name: str,
                          family, device: str | torch.device | None = None):
    """An AudioLDM-class diffusers snapshot -> ``AudioComponents`` on
    ``device`` (JAX ``torch_to_flax.py:795-831``): ``text_encoder/``
    (CLAP, :func:`convert_clap_text`), ``unet/`` (the UNet's rules, its
    ``class_embedding`` Linear by name), ``vae/`` (the 1-channel mel VAE),
    ``vocoder/`` (SpeechT5HifiGan, weight norm folded; its ``mean``/``scale``
    buffers skipped), the tokenizer through ``load_tokenizer`` (the CLAP
    tower's byte-level BPE in ``tokenizer/``). The modules are allocated at
    their serving dtypes before the tensors land."""
    from chiaswarm_tpu_torch.core.device import resolve_device
    from chiaswarm_tpu_torch.models.tokenizer import load_tokenizer
    from chiaswarm_tpu_torch.pipelines.audio import AudioComponents

    checkpoint_dir = Path(checkpoint_dir)
    text = family.text_encoder
    tokenizer = load_tokenizer(checkpoint_dir, text.vocab_size,
                               text.eos_token_id, text.max_length,
                               bos_id=text.bos_token_id,
                               pad_id=text.pad_token_id)
    lander = TensorLander(resolve_device(device))

    def fill(index: int, name: str, module: nn.Module) -> None:
        path = checkpoint_dir / AUDIO_SUBDIRS[name]
        state = read_weights(path)
        if name == "text_encoder":
            state = convert_clap_text(state)
        elif name == "vocoder":
            state = fold_weight_norm(state)
        fill_module(module, "clap" if name == "text_encoder" else name,
                    state, lander, path)

    components = AudioComponents.build(family, model_name, device, fill,
                                       tokenizer, precast=True)
    lander.finish()
    return components


# ---------------------------------------------------------------- cascade

#: a cascade module -> its subdirectory in a snapshot
CASCADE_SUBDIRS = {"t5": "text_encoder", "unet1": "unet", "unet2": "unet_sr"}


def load_cascade_checkpoint(checkpoint_dir: str | Path, model_name: str,
                            family, device: str | torch.device | None = None):
    """A DeepFloyd-class snapshot -> ``CascadeComponents`` on ``device``,
    the modules allocated at their serving dtypes before the tensors land;
    the tokenizer through ``load_tokenizer`` with T5's convention (no BOS,
    padding with id 0)."""
    from chiaswarm_tpu_torch.core.device import resolve_device
    from chiaswarm_tpu_torch.models.tokenizer import load_tokenizer
    from chiaswarm_tpu_torch.pipelines.cascade import CascadeComponents

    checkpoint_dir = Path(checkpoint_dir)
    t5 = family.t5
    tokenizer = load_tokenizer(checkpoint_dir, t5.vocab_size, t5.eos_token_id,
                               t5.max_length, pad_id=t5.pad_token_id,
                               add_bos=False)
    lander = TensorLander(resolve_device(device))

    def fill(index: int, name: str, module: nn.Module) -> None:
        path = checkpoint_dir / CASCADE_SUBDIRS[name]
        state = read_weights(path)
        if name == "t5" and "shared.weight" not in state \
                and "encoder.embed_tokens.weight" in state:
            state["shared.weight"] = state.pop("encoder.embed_tokens.weight")
        fill_module(module, name, state, lander, path)

    components = CascadeComponents.build(family, model_name, device, fill,
                                         tokenizer, precast=True)
    lander.finish()
    return components


# ------------------------------------------------------------------ video

def _slots(module: nn.Module, name: str, state: dict[str, torch.Tensor]
           ) -> tuple[dict[str, str], list[str]]:
    """{the port's parameter name: checkpoint key} and the keys with no
    slot (a text tower's ``position_ids`` buffer aside)."""
    params = dict(module.named_parameters())
    source, extra = {}, []
    for key in state:
        target = canonical_name(name, key)
        if target in params:
            source[target] = key
        elif key.rsplit(".", 1)[-1] != "position_ids":
            extra.append(key)
    return source, extra


def check_strict(module: nn.Module, name: str,
                 state: dict[str, torch.Tensor], model_name: str) -> None:
    """JAX's ``_strict_match`` (``pipelines/video.py:435-459``): every
    parameter comes from the snapshot and every snapshot key has a slot,
    at the module's shape, so a video family's trained temporal weights are
    never silently replaced. Raises ``ValueError`` in JAX's words."""
    params = dict(module.named_parameters())
    source, extra = _slots(module, name, state)
    missing = sorted(set(params) - set(source))
    if missing or extra:
        raise ValueError(
            f"{model_name}: video UNet snapshot does not convert "
            f"completely — {len(missing)} module leaves missing from the "
            f"checkpoint (e.g. {missing[:3]}), {len(extra)} checkpoint "
            f"keys with no module slot (e.g. {sorted(extra)[:3]})")
    bad = [t for t, k in source.items()
           if tuple(state[k].shape) != tuple(params[t].shape)
           and not (name == "vae" and state[k].dim() == 4
                    and params[t].dim() == 2)]
    if bad:
        raise ValueError(
            f"{model_name}: converted leaf shapes disagree with the family "
            f"config at {bad[:3]} (checkpoint "
            f"{[tuple(state[source[t]].shape) for t in bad[:3]]} vs config "
            f"{[tuple(params[t].shape) for t in bad[:3]]})")


_TEMPORAL_TAGS = ("temp_convs", "temp_attentions", "transformer_in")
_ZERO_OUTPUTS = ("to_out", "conv4", "proj_out")


@torch.no_grad()
def inflate_2d(unet: nn.Module, state: dict[str, torch.Tensor],
               lander: TensorLander) -> None:
    """JAX's ``_inflate_2d`` (``pipelines/video.py:462-501``) for a text
    family fed a plain SD snapshot: the spatial parameters land from it
    (a missing one raises); the temporal modules start at identity: norms
    one, biases and the output projections (``conv4``, ``proj_out``,
    ``to_out``) zero, the rest N(0, 0.02) from a CPU generator seeded 0."""
    source, _ = _slots(unet, "unet", state)
    gen = torch.Generator(device="cpu").manual_seed(0)
    lander.after_allocation()
    for target, param in unet.named_parameters():
        if target in source:
            value = state[source[target]]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"2D inflation: {target} is "
                                 f"{tuple(value.shape)} in the checkpoint, "
                                 f"{tuple(param.shape)} in the family")
            lander.land(param, value)
            continue
        if not any(tag in target for tag in _TEMPORAL_TAGS):
            raise ValueError(
                f"2D inflation: spatial UNet leaf {target!r} missing from "
                f"the converted checkpoint (converter/key mismatch for "
                f"this architecture variant)")
        mod_name, leaf = target.rsplit(".", 1)
        norm = isinstance(unet.get_submodule(mod_name),
                          (nn.GroupNorm, nn.LayerNorm))
        if norm and leaf == "weight":
            param.fill_(1.0)
        elif leaf == "bias" or any(t in target for t in _ZERO_OUTPUTS):
            param.zero_()
        else:
            lander.land(param, torch.randn(param.shape, generator=gen) * 0.02)


def load_video_checkpoint(checkpoint_dir: str | Path, model_name: str,
                          family, device: str | torch.device | None = None):
    """A diffusers video snapshot -> ``VideoComponents`` on ``device``
    (JAX ``VideoComponents.from_checkpoint``, ``pipelines/video.py:313-
    423``): ``unet/``, ``vae/`` and ``text_encoder/`` with its BPE
    ``tokenizer/`` (text families), or ``image_encoder/`` (a
    ``CLIPVisionModelWithProjection``, the port's ``ClipVisionEncoder``
    names). A ModelScope or SVD UNet and SVD's temporal VAE load strictly
    (:func:`check_strict`); a plain SD UNet (no ``temp_convs`` or
    ``transformer_in`` keys) inflates into a text family
    (:func:`inflate_2d`); an SVD-class family refuses a 2D snapshot before
    any module is built. The modules are allocated at their serving dtypes
    before the tensors land."""
    from chiaswarm_tpu_torch.core.device import resolve_device
    from chiaswarm_tpu_torch.models.tokenizer import load_tokenizer
    from chiaswarm_tpu_torch.pipelines.video import VideoComponents

    root = Path(checkpoint_dir)
    unet_state = read_weights(root / "unet")
    if family.image_conditioned and not any(
            ".spatial_res_block." in k for k in unet_state):
        raise ValueError(
            f"{model_name}: not an SVD-class spatio-temporal UNet snapshot "
            f"(no spatial_res_block keys). Image-conditioned families cannot "
            f"be 2D-inflated — the published UNetSpatioTemporalConditionModel"
            f" layout is required.")
    native = family.image_conditioned or any(
        ".temp_convs." in k or k.startswith("transformer_in.")
        for k in unet_state)
    cond = "image_encoder" if family.image_conditioned else "text_encoder"
    states = {cond: read_weights(root / cond), "unet": unet_state,
              "vae": read_weights(root / "vae")}
    tokenizer = None
    if not family.image_conditioned:
        te = family.text_encoder
        tokenizer = load_tokenizer(root, te.vocab_size, te.eos_token_id,
                                   te.max_position_embeddings)
    lander = TensorLander(resolve_device(device))

    def fill(index: int, name: str, module: nn.Module) -> None:
        state = states[name]
        if name == "unet" and not native:
            inflate_2d(module, state, lander)
            return
        if name == "unet":
            check_strict(module, name, state, model_name)
        elif name == "vae" and family.image_conditioned:
            check_strict(module, name, state, f"{model_name} (vae)")
        fill_module(module, name, state, lander, root / name)

    components = VideoComponents.build(family, model_name, device, fill,
                                       tokenizer, precast=True)
    components.load_stats = lander.finish()
    return components


# ------------------------------------------------------------------- Bark

def _bark_stage(s: dict[str, torch.Tensor], fine_heads: int = 0
                ) -> dict[str, torch.Tensor]:
    """One transformers Bark stage (``BarkCausalModel`` or, with
    ``fine_heads`` LM heads, ``BarkFineModel``) -> the port's
    ``models/gpt.py`` names, by JAX's ``_bark_layer_map``
    (``torch_to_flax.py:1093-1148``): the attention submodule named ``attn``
    or ``attention`` (its causal-mask buffer ``bias`` skipped), absent
    LayerNorm biases as zeros (Bark's LayerNorms have none), an absent fine
    head tied to ``input_embeds_layers[k + 1]``."""
    out = {}
    for key, value in s.items():
        parts = key.split(".")
        if len(parts) > 2 and parts[2] in ("attn", "attention"):
            if parts[-1] == "bias" and len(parts) == 4:
                continue  # the causal-mask buffer
            parts[2] = "attn"
        out[".".join(parts)] = value
    norms = [k[: -len(".weight")] for k in out
             if k.endswith(".weight") and ("layernorm" in k)]
    for norm in norms:
        if norm + ".bias" not in out:
            out[norm + ".bias"] = torch.zeros_like(out[norm + ".weight"])
    for k in range(fine_heads):
        head = f"lm_heads.{k}.weight"
        if head not in out and f"input_embeds_layers.{k + 1}.weight" in out:
            out[head] = out[f"input_embeds_layers.{k + 1}.weight"]
    return out


def _encodec_decoder(s: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A transformers ``EncodecModel`` state (weight norm folded) -> the
    port's ``models/codec.py`` names, by JAX's ``convert_encodec_decoder``
    (``torch_to_flax.py:1151-1195``): the quantizer's
    ``layers.{k}.codebook.embed`` as ``codebooks.{k}.weight``, the decoder's
    keys under ``decoder.`` as they are (the port keeps its positional
    ``layers.{i}``); the encoder's keys are skipped by the load."""
    out = {}
    for key, value in s.items():
        parts = key.split(".")
        if parts[0] == "quantizer":
            if parts[-1] == "embed":
                out[f"codebooks.{parts[2]}.weight"] = value
        elif parts[0] == "decoder":
            out[".".join(parts[1:])] = value
        else:
            out[key] = value
    return out


def convert_bark(state: dict[str, torch.Tensor], family
                 ) -> dict[str, dict[str, torch.Tensor]]:
    """A transformers ``BarkModel`` state dict -> the port's ``semantic``,
    ``coarse``, ``fine`` and ``codec`` state dicts (JAX ``convert_bark``,
    ``torch_to_flax.py:1198-1216``), weight norm folded first
    (:func:`fold_weight_norm`, both spellings)."""
    state = fold_weight_norm(state)
    return {
        "semantic": _bark_stage(_strip(state, "semantic.")),
        "coarse": _bark_stage(_strip(state, "coarse_acoustics.")),
        "fine": _bark_stage(_strip(state, "fine_acoustics."),
                            fine_heads=family.n_fine - 1),
        "codec": _encodec_decoder(_strip(state, "codec_model.")),
    }
