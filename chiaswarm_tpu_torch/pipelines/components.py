"""Model component bundles, counterpart of
``chiaswarm_tpu/pipelines/components.py``: modules with their weights and
tokenizers for one checkpoint family, resident on one device.

Three constructors:

- :meth:`Components.random` — a seeded init with Flax's default
  distributions (lecun-normal kernels, zero biases, unit norm scales,
  N(0, 1/width) embeddings), made directly on the target device. Weights do
  not change the work done, and a full-width random model still renders a
  finite, non-constant image.
- :meth:`Components.from_jax` — the JAX package's params carried across by
  ``convert.from_jax.params_from_flax``; the parity tests use it.
- :meth:`Components.from_checkpoint` — a diffusers-layout directory on
  disk (``convert/checkpoint.py``) and its CLIP BPE tokenizer, the
  counterpart of JAX ``Components.from_checkpoint`` (:246-272). The
  modules are allocated at their serving dtypes before the tensors land,
  each cast as it lands, so a load never holds a float32 copy of the model.

The text towers stay in float32 whatever ``dtype`` is (the JAX package runs
them in float32); the UNet and VAE are cast to ``dtype`` except the modules
the reference computes in float32 (norms, ``conv_out``).

:class:`ControlNetBundle` (JAX :279-410) is a ControlNet attachable to a
family's pipeline: the hint encoder (``embed``, float32) and the control
branch (``net``, in the family's dtype), resident on one device, from a seed
(its zero convs zero) or from a diffusers ``ControlNetModel`` directory.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Sequence

import torch
from torch import nn

from chiaswarm_tpu_torch.core.device import resolve_device
from chiaswarm_tpu_torch.core.rng import row_seed
from chiaswarm_tpu_torch.models.clip import ClipTextEncoder
from chiaswarm_tpu_torch.models.common import cast_module
from chiaswarm_tpu_torch.models.configs import FAMILIES, ModelFamily, get_family
from chiaswarm_tpu_torch.models.controlnet import (
    ControlCondEmbedding,
    ControlNet,
)
from chiaswarm_tpu_torch.models.tokenizer import (
    HashTokenizer,
    Tokenizer,
    load_tokenizer,
)
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.models.vae import AutoencoderKL

# lecun_normal is a normal truncated at +-2 std; this is the std of the
# untruncated normal whose truncation has unit variance (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@torch.no_grad()
def flax_default_init(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize in place, in module order, with Flax's defaults."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d,
                          nn.ConvTranspose1d)):
            w = m.weight
            # a transposed conv's weight is (in, out, k): its fan-in is in x k
            fan_in = (w.shape[0 if isinstance(m, nn.ConvTranspose1d) else 1]
                      * math.prod(w.shape[2:]))
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.weight.shape[1]),
                            generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


_FAMILY_BYTES_CACHE: dict[tuple[str, int], int] = {}


def estimate_family_bytes(family: ModelFamily | str,
                          bytes_per_param: int = 2) -> int:
    """Serving-footprint estimate (bf16's 2 bytes a param by default, 1
    under int8 weights) of one family's full param set, counted on the
    port's modules built on the ``meta`` device (no storage): the
    counterpart of the JAX package's
    ``pipelines/components.py::estimate_family_bytes`` (:120), which the
    worker's default-pool policy reads (``core/mesh.py``) and the registry
    plans with. Raises for a family whose modules the port does not build
    yet."""
    if isinstance(family, str):
        family = FAMILIES[family]
    key = (family.name, int(bytes_per_param))
    if key not in _FAMILY_BYTES_CACHE:
        with torch.device("meta"):
            modules = [ClipTextEncoder(cfg) for cfg in family.text_encoders]
            modules += [UNet(family.unet), AutoencoderKL(family.vae)]
        total = sum(p.numel() for m in modules for p in m.parameters())
        _FAMILY_BYTES_CACHE[key] = total * int(bytes_per_param)
    return _FAMILY_BYTES_CACHE[key]


def _empty(ctor, config, device: torch.device,
           dtype: torch.dtype | None = None) -> nn.Module:
    """The module with uninitialized storage on ``device`` (no CPU copy),
    cast to ``dtype`` first (``cast_module``) when one is given."""
    with torch.device("meta"):
        module = ctor(config)
    if dtype is not None:
        cast_module(module, dtype)
    return module.to_empty(device=device)


def build_modules(specs, device: torch.device, fill,
                  precast: bool = False) -> dict[str, nn.Module]:
    """``specs``: (name, constructor, config, dtype name) in fill order.
    Each module gets uninitialized storage on ``device``, is filled by
    ``fill(index, name, module)`` and cast to its dtype (before the fill
    too with ``precast``; modules marked ``keep_fp32`` stay float32), in
    eval mode without gradients."""
    modules = {}
    for index, (name, ctor, config, dtype) in enumerate(specs):
        dtype = _DTYPES[dtype]
        module = _empty(ctor, config, device, dtype if precast else None)
        fill(index, name, module)
        modules[name] = cast_module(module, dtype).eval().requires_grad_(False)
    return modules


@dataclasses.dataclass
class Components:
    family: ModelFamily
    model_name: str
    tokenizers: Sequence[Tokenizer]
    text_encoders: list[ClipTextEncoder]
    unet: UNet
    vae: AutoencoderKL
    device: torch.device
    dtype: torch.dtype
    #: a checkpoint load's statistics (``convert/checkpoint.py``)
    load_stats: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def _build(cls, family: ModelFamily, model_name: str | None,
               device: str | torch.device | None, dtype: torch.dtype | None,
               fill, precast: bool = False) -> "Components":
        """Modules with storage on ``device``, filled module by module
        (``fill(index, name, module)``), UNet and VAE cast to ``dtype``:
        after the fill, or before it with ``precast``."""
        dev = resolve_device(device)
        if dtype is None:
            dtype = _DTYPES[family.unet.dtype]
        text_encoders = [_empty(ClipTextEncoder, cfg, dev)
                         for cfg in family.text_encoders]
        first = dtype if precast else None
        unet = _empty(UNet, family.unet, dev, first)
        vae = _empty(AutoencoderKL, family.vae, dev, first)
        named = [(f"text_encoder_{i}", te) for i, te in enumerate(text_encoders)]
        named += [("unet", unet), ("vae", vae)]
        for index, (name, module) in enumerate(named):
            fill(index, name, module)
            module.eval().requires_grad_(False)
        cast_module(unet, dtype)
        cast_module(vae, dtype)
        tokenizers = [HashTokenizer(cfg.vocab_size, cfg.max_position_embeddings,
                                    cfg.eos_token_id)
                      for cfg in family.text_encoders]
        return cls(family=family,
                   model_name=model_name or f"random/{family.name}",
                   tokenizers=tokenizers, text_encoders=text_encoders,
                   unet=unet, vae=vae, device=dev, dtype=dtype)

    @classmethod
    def random(cls, family: ModelFamily | str, seed: int = 0,
               device: str | torch.device | None = None,
               dtype: torch.dtype | None = None,
               model_name: str | None = None) -> "Components":
        """Seeded random weights on ``device`` (default ``cuda``), UNet and
        VAE in ``dtype`` (default: the family config's)."""
        if isinstance(family, str):
            family = FAMILIES[family]

        def fill(index: int, name: str, module: nn.Module) -> None:
            dev = next(module.parameters()).device
            gen = torch.Generator(device=dev).manual_seed(row_seed(seed, index))
            flax_default_init(module, gen)

        return cls._build(family, model_name, device, dtype, fill)

    @classmethod
    def from_jax(cls, params: dict[str, Any], family: ModelFamily | str,
                 device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None,
                 model_name: str | None = None) -> "Components":
        """The JAX package's param tree (``Components.params`` there)."""
        from chiaswarm_tpu_torch.convert.from_jax import params_from_flax

        if isinstance(family, str):
            family = FAMILIES[family]
        state = params_from_flax(params, family)

        def fill(index: int, name: str, module: nn.Module) -> None:
            module.load_state_dict(state[name], strict=True)

        return cls._build(family, model_name, device, dtype, fill)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str | Path,
                        model_name: str | None = None,
                        family: ModelFamily | str | None = None,
                        device: str | torch.device | None = None,
                        dtype: torch.dtype | None = None) -> "Components":
        """A diffusers-layout snapshot on ``device`` (default ``cuda``):
        UNet and VAE in ``dtype`` (default: the family config's), text
        towers in float32, the tokenizer from the snapshot's vocab files.
        ``load_stats`` holds the file-read and device-copy seconds."""
        from chiaswarm_tpu_torch.convert.checkpoint import (
            SUBDIRS,
            TensorLander,
            load_module,
        )

        checkpoint_dir = Path(checkpoint_dir)
        model_name = model_name or checkpoint_dir.name
        if family is None:
            family = get_family(model_name)
        elif isinstance(family, str):
            family = FAMILIES[family]
        tokenizers = [load_tokenizer(checkpoint_dir, cfg.vocab_size,
                                     cfg.eos_token_id,
                                     cfg.max_position_embeddings)
                      for cfg in family.text_encoders]
        lander = TensorLander(resolve_device(device))

        def fill(index: int, name: str, module: nn.Module) -> None:
            load_module(module, name, checkpoint_dir / SUBDIRS[name], lander)

        components = cls._build(family, model_name, device, dtype, fill,
                                precast=True)
        components.tokenizers = tokenizers
        components.load_stats = lander.finish()
        return components

    def modules(self) -> list[nn.Module]:
        """The modules whose parameters the bundle holds (the JAX tree's
        ``text_encoder_{i}``, ``unet`` and ``vae``)."""
        return [*self.text_encoders, self.unet, self.vae]

    def param_bytes(self) -> int:
        """The bytes the parameters hold on the device: an int8 leaf's
        codes and scales (``convert/quantize.py``), never what it
        dequantizes into."""
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())


#: the hint encoder's prefix in a diffusers ``ControlNetModel`` state dict
HINT_PREFIX = "controlnet_cond_embedding."


@dataclasses.dataclass(eq=False)  # identity: lanes key by the bundle
class ControlNetBundle:
    """A ControlNet for one family: ``embed`` (the hint encoder, float32,
    run once per job) and ``net`` (the control branch, in ``dtype``), on
    ``device``. Lanes key by the bundle itself, and the residency ledger
    holds it under its own entry."""

    family: ModelFamily
    model_name: str
    embed: ControlCondEmbedding
    net: ControlNet
    device: torch.device
    dtype: torch.dtype
    load_stats: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def _build(cls, family: ModelFamily | str, model_name: str | None,
               device: str | torch.device | None, dtype: torch.dtype | None,
               fill, precast: bool = False) -> "ControlNetBundle":
        if isinstance(family, str):
            family = FAMILIES[family]
        dev = resolve_device(device)
        if dtype is None:
            dtype = _DTYPES[family.unet.dtype]
        with torch.device("meta"):
            embed = ControlCondEmbedding(family.unet.block_out_channels[0],
                                         downscale=family.vae.downscale)
            net = ControlNet(family.unet)
        if precast:
            cast_module(net, dtype)
        embed, net = embed.to_empty(device=dev), net.to_empty(device=dev)
        fill(embed, net)
        cast_module(net, dtype)
        for module in (embed, net):
            module.eval().requires_grad_(False)
        return cls(family=family,
                   model_name=model_name or f"random/controlnet-{family.name}",
                   embed=embed, net=net, device=dev, dtype=dtype)

    @classmethod
    def random(cls, family: ModelFamily | str, seed: int = 0,
               device: str | torch.device | None = None,
               dtype: torch.dtype | None = None,
               model_name: str | None = None) -> "ControlNetBundle":
        """Seeded weights with Flax's default distributions; the hint
        encoder's ``conv_out`` and every ``controlnet_*`` conv zero, as a
        fresh ControlNet's are (so its residuals are zero)."""

        @torch.no_grad()
        def fill(embed: nn.Module, net: nn.Module) -> None:
            for index, module in enumerate((embed, net)):
                dev = next(module.parameters()).device
                gen = torch.Generator(device=dev).manual_seed(
                    row_seed(seed, index))
                flax_default_init(module, gen)
            zero = [embed.conv_out, net.controlnet_mid_block,
                    *net.controlnet_down_blocks]
            for conv in zero:
                conv.weight.zero_()
                conv.bias.zero_()

        return cls._build(family, model_name, device, dtype, fill)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str | Path,
                        model_name: str | None = None,
                        family: ModelFamily | str | None = None,
                        device: str | torch.device | None = None,
                        dtype: torch.dtype | None = None
                        ) -> "ControlNetBundle":
        """A diffusers ``ControlNetModel`` directory (or a pipeline snapshot
        with a ``controlnet/`` subdirectory) on ``device`` (default
        ``cuda``)."""
        from chiaswarm_tpu_torch.convert.checkpoint import (
            TensorLander,
            fill_module,
            read_weights,
        )

        checkpoint_dir = Path(checkpoint_dir)
        if (checkpoint_dir / "controlnet").is_dir():
            checkpoint_dir = checkpoint_dir / "controlnet"
        model_name = model_name or checkpoint_dir.name
        if family is None:
            family = get_family(model_name)
        state = read_weights(checkpoint_dir)
        hint = {k[len(HINT_PREFIX):]: v for k, v in state.items()
                if k.startswith(HINT_PREFIX)}
        trunk = {k: v for k, v in state.items()
                 if not k.startswith(HINT_PREFIX)}
        lander = TensorLander(resolve_device(device))

        def fill(embed: nn.Module, net: nn.Module) -> None:
            fill_module(embed, "controlnet_cond_embedding", hint, lander,
                        checkpoint_dir)
            fill_module(net, "controlnet", trunk, lander, checkpoint_dir)

        bundle = cls._build(family, model_name, device, dtype, fill,
                            precast=True)
        bundle.load_stats = lander.finish()
        return bundle

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The diffusers ``ControlNetModel`` state dict of this bundle."""
        state = dict(self.net.state_dict())
        state.update((HINT_PREFIX + k, v)
                     for k, v in self.embed.state_dict().items())
        return state

    def modules(self) -> list[nn.Module]:
        return [self.embed, self.net]

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())
