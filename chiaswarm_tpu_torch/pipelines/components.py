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
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
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


_FAMILY_BYTES_CACHE: dict[str, int] = {}


def estimate_family_bytes(family: ModelFamily | str) -> int:
    """Serving-footprint estimate (bf16, 2 bytes a param) of one family's full
    param set, counted on the port's modules built on the ``meta`` device
    (no storage): the counterpart of the JAX package's
    ``pipelines/components.py::estimate_family_bytes`` (:120), which the
    worker's default-pool policy reads (``core/mesh.py``). Raises for a
    family whose modules the port does not build yet."""
    if isinstance(family, str):
        family = FAMILIES[family]
    if family.name not in _FAMILY_BYTES_CACHE:
        with torch.device("meta"):
            modules = [ClipTextEncoder(cfg) for cfg in family.text_encoders]
            modules += [UNet(family.unet), AutoencoderKL(family.vae)]
        total = sum(p.numel() for m in modules for p in m.parameters())
        _FAMILY_BYTES_CACHE[family.name] = total * 2
    return _FAMILY_BYTES_CACHE[family.name]


def _empty(ctor, config, device: torch.device,
           dtype: torch.dtype | None = None) -> nn.Module:
    """The module with uninitialized storage on ``device`` (no CPU copy),
    cast to ``dtype`` first (``cast_module``) when one is given."""
    with torch.device("meta"):
        module = ctor(config)
    if dtype is not None:
        cast_module(module, dtype)
    return module.to_empty(device=device)


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

    def param_bytes(self) -> int:
        modules = [*self.text_encoders, self.unet, self.vae]
        return sum(p.numel() * p.element_size()
                   for m in modules for p in m.parameters())
