"""JAX/Flax param trees -> the port's state dicts.

``params_from_flax(tree, family)`` takes the JAX package's parameters (nested
dicts of arrays keyed ``text_encoder_{i}``/``unet``/``vae``, each a Flax
``{"params": ...}`` tree, as ``Components.random`` there produces) and
returns ``{"text_encoder_{i}": state_dict, "unet": ..., "vae": ...}`` in the
port's (diffusers) names:

- Dense kernels ``(in, out)`` -> Linear weights ``(out, in)``;
- conv kernels HWIO -> OIHW, and the video families' (3, 1, 1, I, O) frame
  convs -> (O, I, 3, 1, 1);
- norm ``scale`` -> ``weight``; ``embedding`` -> ``weight``.

The map runs from the port's side: each module is instantiated on the
``meta`` device, and every one of its parameter names is translated to the
Flax path it comes from, so a missing or extra parameter on either side
raises instead of passing silently. The test suite cross-checks the result
against an exporter written in the other direction.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.models.clip import ClipTextEncoder
from chiaswarm_tpu_torch.models.configs import FAMILIES, ModelFamily
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.models.vae import AutoencoderKL


def _attn_path(rest: str) -> str:
    """Inside a SpatialTransformer: torch suffix -> Flax path."""
    m = re.fullmatch(r"transformer_blocks\.(\d+)\.(.+)", rest)
    if not m:
        return rest  # norm / proj_in / proj_out
    k, inner = m.groups()
    inner = (inner.replace("ff.net.0.proj", "ff/proj_in")
             .replace("ff.net.2", "ff/proj_out")
             .replace("to_out.0", "to_out")
             .replace(".", "/"))
    return f"transformer_blocks_{k}/{inner}"


def _unet_path(module: str, n_levels: int) -> str:
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.+)",
                     module)
    if m:
        side, idx, kind, j, rest = m.groups()
        level = int(idx) if side == "down" else n_levels - 1 - int(idx)
        head = f"{side}_{level}_{kind}_{j}"
        if kind == "resnets":
            return f"{head}/{rest}"
        return f"{head}/{_attn_path(rest)}"
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.conv", module)
    if m:
        side, idx, kind = m.groups()[0], m.group(2), m.group(3)
        level = int(idx) if side == "down" else n_levels - 1 - int(idx)
        return f"{side}_{level}_{kind}sample/conv"
    m = re.fullmatch(r"mid_block\.resnets\.(\d+)\.(.+)", module)
    if m:
        return f"mid_resnets_{m.group(1)}/{m.group(2)}"
    m = re.fullmatch(r"mid_block\.attentions\.0\.(.+)", module)
    if m:
        return f"mid_attention/{_attn_path(m.group(1))}"
    return module.replace(".", "/")  # conv_in, time_embedding.linear_1, ...


def _vae_path(module: str, n_levels: int) -> str:
    if module == "quant_conv":
        return "encoder/quant_conv"
    if module == "post_quant_conv":
        return "decoder/post_quant_conv"
    side, rest = module.split(".", 1)
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", rest)
    if m:
        d, idx, j, leaf = m.groups()
        level = int(idx) if d == "down" else n_levels - 1 - int(idx)
        return f"{side}/{d}_{level}_resnets_{j}/{leaf}"
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.conv", rest)
    if m:
        d, idx, kind = m.groups()
        level = int(idx) if d == "down" else n_levels - 1 - int(idx)
        return f"{side}/{d}_{level}_{kind}sample"
    m = re.fullmatch(r"mid_block\.resnets\.(\d+)\.(.+)", rest)
    if m:
        return f"{side}/mid/resnets_{m.group(1)}/{m.group(2)}"
    m = re.fullmatch(r"mid_block\.attentions\.0\.(.+)", rest)
    if m:
        return f"{side}/mid/attentions_0/{m.group(1).replace('to_out.0', 'to_out')}"
    return f"{side}/{rest}"  # conv_in / conv_norm_out / conv_out


def _text_path(module: str, n_levels: int) -> str:
    if module == "text_projection":
        return "text_projection"
    rest = module.removeprefix("text_model.")
    if rest.startswith("embeddings."):
        return rest.removeprefix("embeddings.")
    if rest == "final_layer_norm":
        return rest
    m = re.fullmatch(r"encoder\.layers\.(\d+)\.(.+)", rest)
    if not m:
        raise KeyError(module)
    i, sub = m.groups()
    sub = sub.replace("mlp.", "").replace(".", "/")
    return f"layers_{i}/{sub}"


def _lookup(tree: dict, path: str) -> dict:
    node = tree
    for part in filter(None, path.split("/")):
        if part not in node:
            raise KeyError(f"Flax tree has no {path!r} (missing {part!r})")
        node = node[part]
    return node


def _convert(module: nn.Module, flax_tree: dict,
             path_of: Callable[[str, int], str], n_levels: int
             ) -> dict[str, torch.Tensor]:
    params = flax_tree["params"]
    used: set[tuple[str, str]] = set()
    out: dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        fpath = path_of(mod_name, n_levels)
        node = _lookup(params, fpath)
        if leaf == "weight":
            key = next((k for k in ("kernel", "scale", "embedding")
                        if k in node), None)
            if key is None:
                raise KeyError(f"{fpath!r} has no kernel/scale/embedding")
        else:
            key = leaf
        value = np.asarray(node[key], dtype=np.float32)
        if key == "kernel":
            # (kT, kH, kW, I, O) / HWIO / (in, out) -> torch's (O, I, ...)
            value = (value.transpose(4, 3, 0, 1, 2) if value.ndim == 5
                     else value.transpose(3, 2, 0, 1) if value.ndim == 4
                     else value.T)
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: Flax {fpath}/{key} has shape "
                             f"{value.shape}, the port expects {tuple(p.shape)}")
        out[name] = torch.tensor(value)  # a copy: the Flax leaf may be read-only
        used.add((fpath, key))
    flax_leaves = set(_leaves(params))
    unused = flax_leaves - used
    if unused:
        raise ValueError(f"Flax params with no counterpart in the port: "
                         f"{sorted(unused)[:8]}")
    return out


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield prefix, key


def params_from_flax(tree: dict[str, Any], family: ModelFamily | str
                     ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's params -> the port's float32 state dicts."""
    if isinstance(family, str):
        family = FAMILIES[family]
    out: dict[str, dict[str, torch.Tensor]] = {}
    for i, cfg in enumerate(family.text_encoders):
        out[f"text_encoder_{i}"] = _convert(
            _skeleton(ClipTextEncoder, cfg), tree[f"text_encoder_{i}"],
            _text_path, 0)
    out["unet"] = _convert(_skeleton(UNet, family.unet), tree["unet"],
                           _unet_path, len(family.unet.block_out_channels))
    out["vae"] = _convert(_skeleton(AutoencoderKL, family.vae), tree["vae"],
                          _vae_path, len(family.vae.block_out_channels))
    return out


def _skeleton(ctor: Callable[[Any], nn.Module], config: Any) -> nn.Module:
    """The module's parameter names and shapes, with no storage."""
    with torch.device("meta"):
        return ctor(config)


# ------------------------------------------------------------- cascade

def t5_state_from_flax(tree: dict, config) -> dict[str, torch.Tensor]:
    """The JAX package's ``T5Encoder`` params (a Flax ``{"params": ...}``
    tree) -> the port's ``models/t5.py`` state dict (transformers'
    ``T5EncoderModel`` names). Every Flax leaf is used once, or this
    raises."""
    params = tree["params"]
    flat: dict[str, np.ndarray] = {
        "shared.weight": params["token_embedding"]["embedding"],
        "encoder.final_layer_norm.weight": params["final_layer_norm"]["scale"],
    }
    for i in range(config.num_layers):
        node, t = params[f"block_{i}"], f"encoder.block.{i}.layer"
        attn = node["attention"]
        for proj in "qkvo":
            flat[f"{t}.0.SelfAttention.{proj}.weight"] = np.asarray(
                attn[proj]["kernel"]).T
        if i == 0:
            flat[f"{t}.0.SelfAttention.relative_attention_bias.weight"] = \
                attn["relative_attention_bias"]
        flat[f"{t}.0.layer_norm.weight"] = node["attn_norm"]["scale"]
        for proj in ("wi_0", "wi_1", "wo"):
            flat[f"{t}.1.DenseReluDense.{proj}.weight"] = np.asarray(
                node[proj]["kernel"]).T
        flat[f"{t}.1.layer_norm.weight"] = node["ff_norm"]["scale"]
    n_leaves = len(list(_leaves(params)))
    if n_leaves != len(flat):
        raise ValueError(f"T5 params: {n_leaves} Flax leaves, {len(flat)} "
                         "carried across")
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in flat.items()}


def cascade_state_from_flax(params: dict[str, Any], family
                            ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's ``CascadeComponents.params`` (``t5``, ``unet1``,
    ``unet2``) -> the port's float32 state dicts under the same keys."""
    out = {"t5": t5_state_from_flax(params["t5"], family.t5)}
    for name, cfg in (("unet1", family.stage1), ("unet2", family.stage2)):
        out[name] = _convert(_skeleton(UNet, cfg), params[name], _unet_path,
                             len(cfg.block_out_channels))
    return out


# ------------------------------------------------------------------ BLIP

def _dense(flat: dict, node: dict, name: str) -> None:
    flat[f"{name}.weight"] = np.asarray(node["kernel"], np.float32).T
    flat[f"{name}.bias"] = np.asarray(node["bias"], np.float32)


def _norm(flat: dict, node: dict, name: str) -> None:
    flat[f"{name}.weight"] = np.asarray(node["scale"], np.float32)
    flat[f"{name}.bias"] = np.asarray(node["bias"], np.float32)


_BLIP_TEXT_LAYER = {
    "self_query": "attention.self.query", "self_key": "attention.self.key",
    "self_value": "attention.self.value", "self_out": "attention.output.dense",
    "cross_query": "crossattention.self.query",
    "cross_key": "crossattention.self.key",
    "cross_value": "crossattention.self.value",
    "cross_out": "crossattention.output.dense",
    "intermediate": "intermediate.dense", "output": "output.dense",
}
_BLIP_TEXT_NORMS = {"self_ln": "attention.output.LayerNorm",
                    "cross_ln": "crossattention.output.LayerNorm",
                    "output_ln": "output.LayerNorm"}


def blip_state_from_flax(tree: dict, part: str) -> dict[str, torch.Tensor]:
    """One tower of the JAX package's BLIP params (``part``: ``vision``,
    ``decoder`` or ``encoder``; a Flax ``{"params": ...}`` tree) -> the
    port's ``models/blip.py`` state dict. Every Flax leaf is used once, or
    this raises; the port's strict ``load_state_dict`` checks the other
    side."""
    params = tree["params"]
    flat: dict[str, np.ndarray] = {}
    if part == "vision":
        kernel = np.asarray(params["patch_embedding"]["kernel"], np.float32)
        flat["embeddings.patch_embedding.weight"] = kernel.transpose(3, 2, 0, 1)
        flat["embeddings.patch_embedding.bias"] = np.asarray(
            params["patch_embedding"]["bias"], np.float32)
        flat["embeddings.class_embedding"] = np.asarray(
            params["class_embedding"], np.float32)
        flat["embeddings.position_embedding"] = np.asarray(
            params["position_embedding"], np.float32)
        n = 2 + 2
        for i in range(len([k for k in params if k.startswith("layers_")])):
            node, t = params[f"layers_{i}"], f"encoder.layers.{i}"
            _norm(flat, node["layer_norm1"], f"{t}.layer_norm1")
            _norm(flat, node["layer_norm2"], f"{t}.layer_norm2")
            _dense(flat, node["qkv"], f"{t}.self_attn.qkv")
            _dense(flat, node["projection"], f"{t}.self_attn.projection")
            _dense(flat, node["fc1"], f"{t}.mlp.fc1")
            _dense(flat, node["fc2"], f"{t}.mlp.fc2")
            n += 12
        _norm(flat, params["post_layernorm"], "post_layernorm")
        n += 2
    else:
        flat["embeddings.word_embeddings.weight"] = np.asarray(
            params["word_embeddings"]["embedding"], np.float32)
        flat["embeddings.position_embeddings.weight"] = np.asarray(
            params["position_embeddings"], np.float32)
        _norm(flat, params["embed_ln"], "embeddings.LayerNorm")
        n = 4
        for i in range(len([k for k in params if k.startswith("layer_")])):
            node, t = params[f"layer_{i}"], f"encoder.layer.{i}"
            for src, dst in _BLIP_TEXT_LAYER.items():
                _dense(flat, node[src], f"{t}.{dst}")
            for src, dst in _BLIP_TEXT_NORMS.items():
                _norm(flat, node[src], f"{t}.{dst}")
            n += 2 * (len(_BLIP_TEXT_LAYER) + len(_BLIP_TEXT_NORMS))
        if "decoder" in params:
            head = "cls.predictions."
            _dense(flat, params["head_transform"], head + "transform.dense")
            _norm(flat, params["head_ln"], head + "transform.LayerNorm")
            _dense(flat, params["decoder"], head + "decoder")
            n += 6
    if n != len(list(_leaves(params))):
        raise ValueError(f"BLIP {part}: {len(list(_leaves(params)))} Flax "
                         f"params, {n} carried across")
    return {k: torch.tensor(v) for k, v in flat.items()}


# -------------------------------------------------------------- AudioLDM

_CLAP_LAYER = {"query": "attention.self.query", "key": "attention.self.key",
               "value": "attention.self.value",
               "attn_out": "attention.output.dense",
               "intermediate": "intermediate.dense", "output": "output.dense"}
_CLAP_NORMS = {"attn_norm": "attention.output.LayerNorm",
               "out_norm": "output.LayerNorm"}


def _clap_state(params: dict) -> tuple[dict[str, np.ndarray], int]:
    flat: dict[str, np.ndarray] = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        flat[f"text_model.embeddings.{name}.weight"] = np.asarray(
            params[name]["embedding"], np.float32)
    _norm(flat, params["embed_norm"], "text_model.embeddings.LayerNorm")
    n = 5
    for i in range(len([k for k in params if k.startswith("layer_")])):
        node, t = params[f"layer_{i}"], f"text_model.encoder.layer.{i}"
        for src, dst in _CLAP_LAYER.items():
            _dense(flat, node[src], f"{t}.{dst}")
        for src, dst in _CLAP_NORMS.items():
            _norm(flat, node[src], f"{t}.{dst}")
        n += 2 * (len(_CLAP_LAYER) + len(_CLAP_NORMS))
    _dense(flat, params["pooler"], "text_model.pooler.dense")
    _dense(flat, params["proj1"], "text_projection.linear1")
    _dense(flat, params["proj2"], "text_projection.linear2")
    return flat, n + 6


def _hifigan_state(params: dict, num_kernels: int
                   ) -> tuple[dict[str, np.ndarray], int]:
    """Flax kernels (K, I, O) -> Conv1d (O, I, K); the transposed convs'
    flipped (K, I, O) kernels -> ConvTranspose1d (I, O, K) unflipped (the
    JAX converter flips the checkpoint's kernel on the way in)."""
    flat: dict[str, np.ndarray] = {}
    n = 0
    for path, node in params.items():
        kernel = np.asarray(node.get("kernel"), np.float32) \
            if "kernel" in node else None
        if path.startswith("upsampler_"):
            name = f"upsampler.{path.split('_')[1]}"
            flat[f"{name}.weight"] = kernel[::-1].transpose(1, 2, 0).copy()
            flat[f"{name}.bias"] = np.asarray(node["bias"], np.float32)
            n += 2
            continue
        if path.startswith("resblocks_"):
            _, up, kern = path.split("_")
            base = f"resblocks.{int(up) * num_kernels + int(kern)}"
            for conv, sub in node.items():
                which, d = conv.rsplit("_", 1)
                name = f"{base}.{which}.{d}"
                flat[f"{name}.weight"] = np.asarray(
                    sub["kernel"], np.float32).transpose(2, 1, 0).copy()
                flat[f"{name}.bias"] = np.asarray(sub["bias"], np.float32)
                n += 2
            continue
        flat[f"{path}.weight"] = kernel.transpose(2, 1, 0).copy()
        flat[f"{path}.bias"] = np.asarray(node["bias"], np.float32)
        n += 2
    return flat, n


def audio_state_from_flax(tree: dict[str, Any], family
                          ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's ``AudioComponents.params`` -> the port's float32
    state dicts of ``text_encoder``, ``unet``, ``vae`` and ``vocoder``."""
    out = {}
    for name, (flat, n) in (
            ("text_encoder", _clap_state(tree["text_encoder"]["params"])),
            ("vocoder", _hifigan_state(
                tree["vocoder"]["params"],
                len(family.vocoder.resblock_kernel_sizes)))):
        leaves = len(list(_leaves(tree[name]["params"])))
        if n != leaves:
            raise ValueError(f"{name}: {leaves} Flax params, {n} carried "
                             "across")
        out[name] = {k: torch.tensor(v) for k, v in flat.items()}
    out["unet"] = _convert(_skeleton(UNet, family.unet), tree["unet"],
                           _unet_path, len(family.unet.block_out_channels))
    out["vae"] = _convert(_skeleton(AutoencoderKL, family.vae), tree["vae"],
                          _vae_path, len(family.vae.block_out_channels))
    return out


# ------------------------------------------------------------------- TTS

_BARK_BLOCK = {"attn_qkv": "attn.att_proj", "attn_proj": "attn.out_proj",
               "mlp_fc": "mlp.in_proj", "mlp_proj": "mlp.out_proj"}
_BARK_NORMS = {"ln_1": "layernorm_1", "ln_2": "layernorm_2"}


def _bark_gpt_state(params: dict) -> dict[str, np.ndarray]:
    """A ``models/gpt.py`` GPT or FineGPT tree -> the port's (transformers')
    names: Dense kernels transposed, ``wpe`` the position table."""
    flat: dict[str, np.ndarray] = {}
    for path, node in params.items():
        if path == "wpe":
            flat["position_embeds_layer.weight"] = np.asarray(node, np.float32)
        elif path == "wte":
            flat["input_embeds_layer.weight"] = np.asarray(
                node["embedding"], np.float32)
        elif path.startswith("wte_"):
            flat[f"input_embeds_layers.{path[4:]}.weight"] = np.asarray(
                node["embedding"], np.float32)
        elif path == "ln_f":
            _norm(flat, node, "layernorm_final")
        elif path == "lm_head":
            flat["lm_head.weight"] = np.asarray(node["kernel"], np.float32).T
        elif path.startswith("lm_head_"):
            flat[f"lm_heads.{path[8:]}.weight"] = np.asarray(
                node["kernel"], np.float32).T
        else:
            t = f"layers.{path[2:]}"  # h_{i}
            for src, dst in _BARK_BLOCK.items():
                flat[f"{t}.{dst}.weight"] = np.asarray(
                    node[src]["kernel"], np.float32).T
            for src, dst in _BARK_NORMS.items():
                _norm(flat, node[src], f"{t}.{dst}")
    return flat


def _codec_state(params: dict, transposed: set[int]
                 ) -> dict[str, np.ndarray]:
    """A ``models/codec.py`` CodecDecoder tree -> the port's names: conv
    kernels (K, I, O) -> (O, I, K); the transposed convs' (K, I, O) ->
    (I, O, K) flipped along K (a Flax ``ConvTranspose`` correlates the
    dilated input with its kernel, PyTorch's convolves); the LSTM's
    torch-layout leaves as they are."""
    flat: dict[str, np.ndarray] = {}

    def conv(node: dict, name: str, transpose: bool = False) -> None:
        kernel = np.asarray(node["kernel"], np.float32)
        flat[f"{name}.weight"] = (kernel[::-1].transpose(1, 2, 0).copy()
                                  if transpose else
                                  kernel.transpose(2, 1, 0).copy())
        flat[f"{name}.bias"] = np.asarray(node["bias"], np.float32)

    for path, node in params.items():
        if path.startswith("codebook_"):
            flat[f"codebooks.{path[9:]}.weight"] = np.asarray(
                node["embedding"], np.float32)
            continue
        idx = int(path.split("_")[1])
        base = f"layers.{idx}"
        if "conv" in node:
            conv(node["conv"], f"{base}.conv", idx in transposed)
        elif "block_1" in node:
            for sub, name in (("block_1", "block.1"), ("block_3", "block.3"),
                              ("shortcut", "shortcut")):
                if sub in node:
                    conv(node[sub]["conv"], f"{base}.{name}.conv")
        else:
            for leaf, value in node.items():
                flat[f"{base}.lstm.{leaf}"] = np.asarray(value, np.float32)
    return flat


def tts_state_from_flax(tree: dict[str, Any], family
                        ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's ``TTSComponents.params`` -> the port's float32
    state dicts of ``semantic``, ``coarse``, ``fine`` and ``codec``. Every
    Flax leaf is carried across exactly once."""
    from chiaswarm_tpu_torch.models.codec import transpose_slots

    out = {}
    for name in ("semantic", "coarse", "fine", "codec"):
        params = tree[name]["params"]
        flat = (_codec_state(params, transpose_slots(family.codec))
                if name == "codec" else _bark_gpt_state(params))
        leaves = len(list(_leaves(params)))
        if len(flat) != leaves:
            raise ValueError(f"{name}: {leaves} Flax params, {len(flat)} "
                             "carried across")
        out[name] = {k: torch.tensor(v) for k, v in flat.items()}
    return out


# ----------------------------------------------------------------- video

def _video_inner(rest: str) -> str:
    """Inside a video block (after its ``{side}_{level}_{kind}_{j}``
    root): the inverse of JAX's ``_temp_conv_inner``,
    ``_temporal_block_inner`` and ``_st_attention_inner``
    (``convert/torch_to_flax.py:226-401``). ``""`` is the root itself (the
    ``time_mixer``'s ``mix_factor`` sits there)."""
    if rest == "time_mixer":
        return ""
    m = re.fullmatch(r"conv([1-4])\.(\d)", rest)
    if m:  # TemporalConvLayer: index 0 the GroupNorm, the last the conv
        k, idx = m.groups()
        return f"norm{k}" if idx == "0" else f"conv{k}"
    m = re.fullmatch(r"(spatial|temporal)_res_block\.(.+)", rest)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    m = re.fullmatch(r"temporal_transformer_blocks\.(\d+)\.(.+)", rest)
    if m:
        inner = (m.group(2).replace("ff_in.net.0.proj", "ff_in/proj_in")
                 .replace("ff_in.net.2", "ff_in/proj_out"))
        inner = _attn_path(f"transformer_blocks.0.{inner}")
        return inner.replace("transformer_blocks_0/",
                             f"temporal_blocks_{m.group(1)}/", 1)
    if rest.startswith("time_pos_embed."):
        return rest.replace(".", "/")
    return _attn_path(rest)


def _join(root: str, inner: str) -> str:
    return f"{root}/{inner}" if inner else root


def _video_unet_path(module: str, n_levels: int) -> str:
    """The port's ``UNet3D``/``UNetSpatioTemporal`` names -> JAX's
    ``models/video_unet.py`` paths."""
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(resnets|attentions|temp_convs"
                     r"|temp_attentions)\.(\d+)(?:\.(.+))?", module)
    if m:
        side, idx, kind, j, rest = m.groups()
        level = int(idx) if side == "down" else n_levels - 1 - int(idx)
        kind = {"temp_convs": "tconvs", "temp_attentions": "tattns"}.get(
            kind, kind)
        return _join(f"{side}_{level}_{kind}_{j}", _video_inner(rest or ""))
    m = re.fullmatch(r"mid_block\.(resnets|attentions|temp_convs|"
                     r"temp_attentions)\.(\d+)(?:\.(.+))?", module)
    if m:
        kind, j, rest = m.groups()
        root = {"resnets": f"mid_resnets_{j}", "attentions": "mid_attention",
                "temp_convs": f"mid_tconvs_{j}",
                "temp_attentions": "mid_tattn"}[kind]
        return _join(root, _video_inner(rest or ""))
    if module.startswith("transformer_in."):
        return "transformer_in/" + _attn_path(module.split(".", 1)[1])
    return _unet_path(module, n_levels)


def _temporal_vae_path(module: str, n_levels: int) -> str:
    """The port's ``AutoencoderKLTemporalDecoder`` names -> JAX's."""
    if not module.startswith("decoder."):
        return _vae_path(module, n_levels)
    rest = module.removeprefix("decoder.")
    m = re.fullmatch(r"mid_block\.resnets\.(\d+)(?:\.(.+))?", rest)
    if m:
        return _join(f"decoder/mid_resnets_{m.group(1)}",
                     _video_inner(m.group(2) or ""))
    m = re.fullmatch(r"mid_block\.attentions\.0\.(.+)", rest)
    if m:
        return "decoder/mid_attention/" + m.group(1).replace("to_out.0",
                                                             "to_out")
    m = re.fullmatch(r"up_blocks\.(\d+)\.resnets\.(\d+)(?:\.(.+))?", rest)
    if m:
        level = n_levels - 1 - int(m.group(1))
        return _join(f"decoder/up_{level}_resnets_{m.group(2)}",
                     _video_inner(m.group(3) or ""))
    m = re.fullmatch(r"up_blocks\.(\d+)\.upsamplers\.0\.conv", rest)
    if m:
        return f"decoder/up_{n_levels - 1 - int(m.group(1))}_upsample"
    return f"decoder/{rest}"  # conv_in, conv_norm_out, conv_out, time_conv_out


def _vision_path(module: str, n_levels: int) -> str:
    """The port's ``ClipVisionEncoder`` (transformers'
    ``CLIPVisionModelWithProjection`` names) -> JAX's ``ClipVisionEncoder``
    (the inverse of ``convert_clip_vision``)."""
    if module == "visual_projection":
        return module
    rest = module.removeprefix("vision_model.")
    if rest == "embeddings":
        return ""  # class_embedding sits at the root
    if rest.startswith("embeddings."):
        return rest.removeprefix("embeddings.")
    m = re.fullmatch(r"encoder\.layers\.(\d+)\.(.+)", rest)
    if m:
        return f"layers_{m.group(1)}/" + m.group(2).replace(
            "mlp.", "").replace(".", "/")
    return rest  # pre_layrnorm / post_layernorm


def video_state_from_flax(tree: dict[str, Any], family
                          ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's ``VideoComponents.params`` (numpy) -> the port's
    float32 state dicts: ``text_encoder`` (text families) or
    ``image_encoder`` (SVD-class), ``unet`` (``UNet3D`` or
    ``UNetSpatioTemporal``) and ``vae`` (``AutoencoderKL`` or
    ``AutoencoderKLTemporalDecoder``)."""
    from chiaswarm_tpu_torch.models.clip import ClipVisionEncoder
    from chiaswarm_tpu_torch.pipelines.video import (
        make_video_unet,
        make_video_vae,
    )

    n_unet = len(family.unet.block_out_channels)
    n_vae = len(family.vae.block_out_channels)
    out = {"unet": _convert(_skeleton(make_video_unet, family), tree["unet"],
                            _video_unet_path, n_unet),
           "vae": _convert(_skeleton(make_video_vae, family), tree["vae"],
                           _temporal_vae_path if family.image_conditioned
                           else _vae_path, n_vae)}
    if family.image_conditioned:
        out["image_encoder"] = _convert(
            _skeleton(ClipVisionEncoder, family.vision),
            tree["image_encoder"], _vision_path, 0)
    else:
        out["text_encoder"] = _convert(
            _skeleton(ClipTextEncoder, family.text_encoder),
            tree["text_encoder"], _text_path, 0)
    return out


# ------------------------------------------------ ControlNet detectors

_DETECTOR_LEAVES = {"bias": "bias", "running_mean": "mean",
                    "running_var": "var"}


def _detector_state(skeleton: nn.Module, tree: dict,
                    path_of: Callable[[str, str], str],
                    flipped: Callable[[str], bool] = lambda module: False
                    ) -> dict[str, torch.Tensor]:
    """A detector's Flax params (a ``{"params": ...}`` tree) -> the state
    dict of ``skeleton`` (the port's network on ``meta``). ``path_of(module,
    leaf)`` names the Flax leaf of each tensor, its leaf already in Flax's
    words (``kernel``, ``scale``, ``bias``, ``mean``, ``var``, or the
    parameter's own name). Conv kernels HWIO -> OIHW (``flipped`` ones, JAX's
    transposed convs stored flipped as (kh, kw, in, out), -> torch's
    unflipped (in, out, kh, kw)), dense kernels transposed, other leaves
    reshaped to the port's shape. BatchNorm counters are 0. Every Flax leaf
    is used once, or this raises."""
    params = tree["params"]
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for name, slot in skeleton.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long)
            continue
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "weight":
            leaf = "kernel" if slot.dim() >= 2 else "scale"
        leaf = _DETECTOR_LEAVES.get(leaf, leaf)
        path = path_of(module, leaf)
        *parent, key = path.split("/")
        value = np.asarray(_lookup(params, "/".join(parent))[key], np.float32)
        if key == "kernel" and value.ndim == 4:
            value = (value[::-1, ::-1].transpose(2, 3, 0, 1)
                     if flipped(module) else value.transpose(3, 2, 0, 1))
        elif key == "kernel" and value.ndim == 2:
            value = value.T
        elif value.size == slot.numel():
            value = value.reshape(slot.shape)
        if tuple(value.shape) != tuple(slot.shape):
            raise ValueError(f"{name}: Flax {path} has shape {value.shape}, "
                             f"the port expects {tuple(slot.shape)}")
        out[name] = torch.tensor(np.ascontiguousarray(value))
        used.add(path)
    unused = {_joined(p, k) for p, k in _leaves(params)} - used
    if unused:
        raise ValueError(f"Flax params with no counterpart in the port: "
                         f"{sorted(unused)[:8]}")
    return out


def _joined(module: str, leaf: str) -> str:
    return f"{module}/{leaf}" if module else leaf


def hed_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's ``HEDNetwork`` params -> the port's (``ControlNetHED.pth``)
    names."""
    from chiaswarm_tpu_torch.models.hed import HEDNetwork

    def path_of(module: str, leaf: str) -> str:
        module = re.sub(r"^(block\d)\.convs\.(\d+)$", r"\1/convs_\2", module)
        return _joined(module.replace(".", "/"), leaf)

    return _detector_state(_skeleton(lambda _: HEDNetwork(), None), tree,
                           path_of)


_LINEART_PATHS = [(r"model0\.1", "stem/conv"), (r"model1\.0", "down_0"),
                  (r"model1\.3", "down_1"),
                  (r"model2\.(\d+)\.conv_block\.1", r"res_\1/conv_a/conv"),
                  (r"model2\.(\d+)\.conv_block\.5", r"res_\1/conv_b/conv"),
                  (r"model3\.0", "up_0"), (r"model3\.3", "up_1"),
                  (r"model4\.1", "head/conv")]


def lineart_state_from_flax(tree: dict, n_blocks: int
                            ) -> dict[str, torch.Tensor]:
    """JAX's ``LineartGenerator`` params -> the port's (``sk_model.pth``)
    names; the transposed convs' kernels unflipped."""
    from chiaswarm_tpu_torch.models.lineart import LineartGenerator

    def path_of(module: str, leaf: str) -> str:
        for pattern, repl in _LINEART_PATHS:
            if re.fullmatch(pattern, module):
                return f"{re.sub(pattern, repl, module)}/{leaf}"
        raise KeyError(f"no Flax path for lineart module {module!r}")

    return _detector_state(_skeleton(LineartGenerator, n_blocks), tree,
                           path_of, lambda m: m.startswith("model3."))


def mlsd_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's ``MLSDNetwork`` params -> the port's
    (``mlsd_large_512_fp32.pth``) names."""
    from chiaswarm_tpu_torch.models.mlsd import MLSDNetwork

    skeleton = _skeleton(lambda _: MLSDNetwork(), None)
    seq_len = {i: len(f.conv) for i, f in
               enumerate(skeleton.backbone.features) if i > 0}

    def path_of(module: str, leaf: str) -> str:
        if module.startswith("backbone.features.0."):
            sub = {"0": "conv", "1": "bn"}[module.rsplit(".", 1)[1]]
            return f"stem/{sub}/{leaf}"
        m = re.fullmatch(r"backbone\.features\.(\d+)\.conv\.(\d+)(?:\.(\d))?",
                         module)
        if m:
            i, j, part = int(m.group(1)), int(m.group(2)), m.group(3)
            if part is not None:  # a conv-BN-ReLU6 stage
                sub = {"0": "conv", "1": "bn"}[part]
                return f"ir_{i}/layer_{j}/{sub}/{leaf}"
            name = "project" if j == seq_len[i] - 2 else "project_bn"
            return f"ir_{i}/{name}/{leaf}"
        m = re.fullmatch(r"(block\d+)\.(conv\d)(?:\.(\d))?", module)
        if m is None:
            raise KeyError(f"no Flax path for M-LSD module {module!r}")
        block, conv, part = m.groups()
        if part is None:  # block23's head conv
            return f"{block}/{conv}/{leaf}"
        return f"{block}/{conv}/{ {'0': 'conv', '1': 'bn'}[part]}/{leaf}"

    return _detector_state(skeleton, tree, path_of)


def openpose_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's ``BodyPoseNet`` params -> the port's (controlnet_aux's
    ``model0.conv1_1`` ...) names: JAX drops the stage prefix."""
    from chiaswarm_tpu_torch.models.openpose import BodyPoseNet

    return _detector_state(
        _skeleton(lambda _: BodyPoseNet(), None), tree,
        lambda module, leaf: f"{module.split('.', 1)[1]}/{leaf}")


_DPT_LAYER = {"attention.attention.query": "query",
              "attention.attention.key": "key",
              "attention.attention.value": "value",
              "attention.output.dense": "attn_out",
              "intermediate.dense": "intermediate",
              "output.dense": "output",
              "layernorm_before": "layernorm_before",
              "layernorm_after": "layernorm_after"}


def _dpt_module(module: str) -> str:
    m = re.fullmatch(r"dpt\.encoder\.layer\.(\d+)\.(.+)", module)
    if m:
        return f"layer_{m.group(1)}/{_DPT_LAYER[m.group(2)]}"
    for pattern, repl in (
            (r"dpt\.embeddings", ""),
            (r"dpt\.embeddings\.patch_embeddings\.projection",
             "patch_embedding"),
            (r"neck\.reassemble_stage\.readout_projects\.(\d+)\.0",
             r"readout_\1"),
            (r"neck\.reassemble_stage\.layers\.(\d+)\.projection",
             r"reassemble_proj_\1"),
            (r"neck\.reassemble_stage\.layers\.(\d+)\.resize",
             r"reassemble_resize_\1"),
            (r"neck\.convs\.(\d+)", r"neck_conv_\1"),
            (r"neck\.fusion_stage\.layers\.(\d+)\.projection",
             r"fusion_\1_proj"),
            (r"neck\.fusion_stage\.layers\.(\d+)\.residual_layer(\d)"
             r"\.convolution(\d)", r"fusion_\1_res\2_conv\3"),
            (r"head\.head\.0", "head_conv1"), (r"head\.head\.2", "head_conv2"),
            (r"head\.head\.4", "head_conv3")):
        if re.fullmatch(pattern, module):
            return re.sub(pattern, repl, module)
    raise KeyError(f"no Flax path for DPT module {module!r}")


def dpt_state_from_flax(tree: dict, config) -> dict[str, torch.Tensor]:
    """JAX's ``DPTDepth`` params -> the port's (transformers'
    ``DPTForDepthEstimation``) names; the x4 and x2 reassemble transposed
    convs unflipped."""
    from chiaswarm_tpu_torch.models.dpt import DPTDepth

    return _detector_state(
        _skeleton(DPTDepth, config), tree,
        lambda module, leaf: _joined(_dpt_module(module), leaf),
        lambda m: m.endswith(".resize") and any(
            f"layers.{i}." in m for i, f in
            enumerate(config.reassemble_factors) if f > 1))


_UPERNET_BN = {"scale": "bn_scale", "bias": "bn_bias", "mean": "bn_mean",
               "var": "bn_var"}


def _upernet_path(module: str, leaf: str) -> str:
    m = re.fullmatch(r"(.+)\.batch_norm", module)
    if m:
        return f"{_upernet_module(m.group(1))}/{_UPERNET_BN[leaf]}"
    return _joined(_upernet_module(module), leaf)


def _upernet_module(module: str) -> str:
    m = re.fullmatch(r"backbone\.encoder\.stages\.(\d+)\.layers\.(\d+)"
                     r"(?:\.(\w+))?", module)
    if m:
        s, i, sub = m.groups()
        return f"stage{s}_layer{i}" + (f"/{sub}" if sub else "")
    for pattern, repl in (
            (r"backbone\.embeddings\.patch_embeddings", "patch_embed"),
            (r"backbone\.embeddings\.layernorm", "embed_norm"),
            (r"backbone\.encoder\.stages\.(\d+)\.downsampling_layer\.0",
             r"down_norm_\1"),
            (r"backbone\.encoder\.stages\.(\d+)\.downsampling_layer\.1",
             r"down_conv_\1"),
            (r"decode_head\.psp_modules\.(\d+)\.1", r"psp_\1"),
            (r"decode_head\.lateral_convs\.(\d+)", r"lateral_\1"),
            (r"decode_head\.fpn_convs\.(\d+)", r"fpn_\1"),
            (r"decode_head\.(bottleneck|fpn_bottleneck|classifier)", r"\1")):
        if re.fullmatch(pattern, module):
            return re.sub(pattern, repl, module)
    m = re.fullmatch(r"backbone\.hidden_states_norms\.stage(\d)", module)
    if m:
        return f"out_norm_{int(m.group(1)) - 1}"
    m = re.fullmatch(r"(.+)\.conv", module)
    if m:  # a conv module's conv
        return f"{_upernet_module(m.group(1))}/conv"
    raise KeyError(f"no Flax path for UperNet module {module!r}")


def upernet_state_from_flax(tree: dict, config) -> dict[str, torch.Tensor]:
    """JAX's ``UperNetSeg`` params -> the port's (transformers'
    ``UperNetForSemanticSegmentation``) names."""
    from chiaswarm_tpu_torch.models.upernet import UperNetSeg

    return _detector_state(_skeleton(UperNetSeg, config), tree,
                           _upernet_path)
