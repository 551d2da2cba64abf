"""DeepFloyd-IF-class pixel cascade, counterpart of
``chiaswarm_tpu/pipelines/cascade.py`` (``CascadeFamily`` :60-118,
``CascadeComponents`` :121-170, ``CascadePipeline`` :173-350,
``_run_stage3`` :353-386).

A three-stage cascade, run as a plain PyTorch loop on one card:

1. the prompt through the T5 encoder under the tokenizer's padding mask
   (``ids != pad``), once, and under CFG (guidance above 1) the negative
   prompt before it; both stages share the embeddings;
2. stage 1, the 64 px base in pixel space: noise (the row's stage 1) times
   ``sigmas[0]``, the denoise (step noise: stage 2), the 6-channel output
   split to its epsilon half (the other half is the learned variance), then
   ``clip(-1, 1)``;
3. stage 2, the 256 px super-resolution: conditioned on the base upsampled
   nearest by 2, log2(sr / base) times, concatenated on channels at the
   plain batch size (before CFG doubles it), noise stages 3 and 4, then
   uint8 on the device;
4. stage 3 (:func:`_run_stage3`), upscale passes until ``final_size``
   (default 4 x sr_size): one pass of the SD x4 upscaler
   (``pipelines/upscale.py::Upscale4xPipeline``) reaches 1024 px; an
   x2-class upscaler takes two; a pass that makes no progress stops the
   loop. Stage 3 is conditioned on the prompt string again, with the job's
   seed.

The noise schedule is IF's ``squaredcos_cap_v2``, the sampler the one
``resolve(scheduler)`` picks for epsilon prediction. Row b's noise comes
from its own CPU generators, one per stage, keyed by (seed, first_row + b,
stage) (``core/rng.py::stage_generators``), where the JAX package folds the
stage into the row's key: a (seed, row) pair draws the same image in a
batch or alone at ``first_row`` = row.

Not ported: ``generate_stage_parallel`` (JAX :389-440), which splits a slot
of two or more cards into two data meshes; the port builds one slot per
card (ROADMAP queue item 7). A slot whose mesh has ``seq`` > 1 is refused
by the registry, naming item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.core.buckets import bucket_batch
from chiaswarm_tpu_torch.core.device import resolve_device, upload
from chiaswarm_tpu_torch.core.rng import randn_rows, row_seed, stage_generators
from chiaswarm_tpu_torch.models.common import upsample2x_nearest
from chiaswarm_tpu_torch.models.configs import UNetConfig
from chiaswarm_tpu_torch.models.t5 import (
    RelativeBias,
    T5Config,
    T5Encoder,
    T5LayerNorm,
)
from chiaswarm_tpu_torch.models.tokenizer import HashTokenizer, Tokenizer
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.pipelines.components import (
    build_modules,
    flax_default_init,
)
from chiaswarm_tpu_torch.pipelines.diffusion import to_uint8
from chiaswarm_tpu_torch.schedulers import (
    NOISY_KINDS,
    ScheduleConfig,
    init_sampler_state,
    make_noise_schedule,
    make_sampling_schedule,
    resolve,
    sampler_step,
    scale_model_input,
)


@dataclasses.dataclass(frozen=True)
class CascadeFamily:
    """Architecture of one IF-class cascade (base + super-res stages)."""

    name: str
    t5: T5Config
    stage1: UNetConfig          # base: sample_channels=3, out_channels=6
    stage2: UNetConfig          # super-res: sample_channels=6, out_channels=6
    base_size: int = 64
    sr_size: int = 256
    beta_schedule: str = "squaredcos_cap_v2"  # IF trains on a cosine schedule


# IF-I-XL / IF-II-L shaped (DeepFloyd/IF-I-XL-v1.0 + IF-II-L-v1.0)
IF_XL = CascadeFamily(
    name="if_xl",
    t5=T5Config(),
    stage1=UNetConfig(
        sample_channels=3, out_channels=6,
        block_out_channels=(192, 384, 768, 1536),
        transformer_depth=(0, 0, 1, 1),
        attention_head_dim=64, head_dim_is_count=False,
        cross_attention_dim=4096,
    ),
    stage2=UNetConfig(
        sample_channels=6, out_channels=6,
        block_out_channels=(128, 256, 512, 1024),
        transformer_depth=(0, 0, 1, 1),
        attention_head_dim=64, head_dim_is_count=False,
        cross_attention_dim=4096,
    ),
)

# Hermetic-test cascade: full structure, toy widths.
TINY_CASCADE = CascadeFamily(
    name="tiny_cascade",
    t5=T5Config(vocab_size=1000, d_model=32, d_kv=8, d_ff=64,
                num_layers=2, num_heads=4, max_length=77, eos_token_id=999,
                dtype="float32"),
    stage1=UNetConfig(sample_channels=3, out_channels=6,
                      block_out_channels=(32, 64), layers_per_block=1,
                      transformer_depth=(0, 1), attention_head_dim=4,
                      head_dim_is_count=True, cross_attention_dim=32,
                      dtype="float32"),
    stage2=UNetConfig(sample_channels=6, out_channels=6,
                      block_out_channels=(32, 64), layers_per_block=1,
                      transformer_depth=(0, 1), attention_head_dim=4,
                      head_dim_is_count=True, cross_attention_dim=32,
                      dtype="float32"),
    base_size=16,
    sr_size=64,
)

CASCADE_FAMILIES = {f.name: f for f in (IF_XL, TINY_CASCADE)}

#: the modules of a cascade, in fill order
MODULES = ("t5", "unet1", "unet2")

#: the noise stages of a row, each its own generator
BASE_NOISE, BASE_STEPS, SR_NOISE, SR_STEPS = 1, 2, 3, 4


def get_cascade_family(model_name: str) -> CascadeFamily:
    low = (model_name or "").lower()
    tail = low.rsplit("/", 1)[-1]
    if low in CASCADE_FAMILIES:
        return CASCADE_FAMILIES[low]
    if tail in CASCADE_FAMILIES:
        return CASCADE_FAMILIES[tail]
    return CASCADE_FAMILIES["if_xl"]


@torch.no_grad()
def init_t5(module: T5Encoder, generator: torch.Generator) -> None:
    """JAX's initialisers: Flax's defaults (``flax_default_init``: lecun
    normal kernels, N(0, 1/d) token embeddings), unit RMSNorm scales and
    the relative bias table from ``nn.initializers.normal(1.0)``."""
    flax_default_init(module, generator)
    for m in module.modules():
        if isinstance(m, T5LayerNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, RelativeBias):
            m.weight.normal_(0.0, 1.0, generator=generator)


def t5_tokenizer(config: T5Config) -> HashTokenizer:
    """The vocab-file-free tokenizer of random weights: T5's convention (no
    BOS, padding with ``pad_token_id``)."""
    return HashTokenizer(config.vocab_size, config.max_length,
                         config.eos_token_id, pad_id=config.pad_token_id,
                         add_bos=False)


@dataclasses.dataclass
class CascadeComponents:
    family: CascadeFamily
    model_name: str
    tokenizer: Tokenizer
    t5: T5Encoder
    unet1: UNet
    unet2: UNet
    device: torch.device

    @classmethod
    def build(cls, family: CascadeFamily | str, model_name: str | None,
              device: str | torch.device | None, fill,
              tokenizer: Tokenizer | None = None,
              precast: bool = False) -> "CascadeComponents":
        """T5 and the two UNets with storage on ``device``, each filled by
        ``fill(index, name, module)`` and cast to its config's dtype (before
        the fill with ``precast``); norms, the relative bias table and
        ``conv_out`` stay float32."""
        if isinstance(family, str):
            family = CASCADE_FAMILIES[family]
        specs = [("t5", T5Encoder, family.t5, family.t5.dtype),
                 ("unet1", UNet, family.stage1, family.stage1.dtype),
                 ("unet2", UNet, family.stage2, family.stage2.dtype)]
        dev = resolve_device(device)
        modules = build_modules(specs, dev, fill, precast)
        return cls(family=family,
                   model_name=model_name or f"random/{family.name}",
                   tokenizer=tokenizer or t5_tokenizer(family.t5),
                   device=dev, **modules)

    @classmethod
    def random(cls, family: CascadeFamily | str, seed: int = 0,
               model_name: str | None = None,
               device: str | torch.device | None = None
               ) -> "CascadeComponents":
        """Seeded weights with JAX's initialisers, drawn on ``device``
        (default ``cuda``) at the serving dtypes."""

        def fill(index: int, name: str, module: nn.Module) -> None:
            dev = next(module.parameters()).device
            gen = torch.Generator(device=dev).manual_seed(row_seed(seed, index))
            if name == "t5":
                init_t5(module, gen)
            else:
                flax_default_init(module, gen)

        return cls.build(family, model_name, device, fill, precast=True)

    @classmethod
    def from_jax(cls, params: dict[str, Any], family: CascadeFamily | str,
                 device: str | torch.device | None = None,
                 model_name: str | None = None) -> "CascadeComponents":
        """The JAX package's ``CascadeComponents.params``."""
        from chiaswarm_tpu_torch.convert.from_jax import cascade_state_from_flax

        if isinstance(family, str):
            family = CASCADE_FAMILIES[family]
        state = cascade_state_from_flax(params, family)

        def fill(index: int, name: str, module: nn.Module) -> None:
            module.load_state_dict(state[name], strict=True)

        return cls.build(family, model_name, device, fill)

    def modules(self) -> list[nn.Module]:
        return [getattr(self, name) for name in MODULES]

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())


class CascadePipeline:
    """The resident cascade: :meth:`submit` runs stages 1 and 2 and leaves
    the uint8 images on the device; :meth:`__call__` brings them to the host
    and runs stage 3. ``encode_text``, ``stage1`` and ``stage2`` are the
    stages a caller may time."""

    def __init__(self, components: CascadeComponents) -> None:
        self.c = components
        fam = components.family
        s1, s2 = fam.base_size, fam.sr_size
        if s2 % s1 != 0 or (s2 // s1) & (s2 // s1 - 1):
            raise ValueError("sr_size must be a power-of-two multiple of "
                             "base_size")
        self.noise_schedule = make_noise_schedule(ScheduleConfig(
            beta_schedule=fam.beta_schedule, prediction_type="epsilon"))

    @torch.inference_mode()
    def encode_text(self, ids: np.ndarray,
                    neg_ids: np.ndarray | None) -> torch.Tensor:
        """T5 under the padding mask, float32 (B|2B, L, d_model); the
        negative prompt's rows first under CFG."""
        pad = self.c.family.t5.pad_token_id

        def encode(batch_ids: np.ndarray) -> torch.Tensor:
            ids_t = upload(torch.from_numpy(batch_ids), self.c.device)
            return self.c.t5(ids_t, ids_t != pad)

        ctx = encode(ids)
        return ctx if neg_ids is None else torch.cat([encode(neg_ids), ctx])

    def _denoise(self, unet: UNet, steps: int, sampler, x: torch.Tensor,
                 ctx: torch.Tensor, cond: torch.Tensor | None,
                 guidance: float, step_gens: list) -> torch.Tensor:
        """The shared loop: ``cond`` (None or an image) is concatenated on
        channels at every step, before CFG doubles the batch; the UNet's
        output is cut to its epsilon half."""
        dev = self.c.device
        sched = make_sampling_schedule(self.noise_schedule, steps, sampler)
        timesteps = sched.timesteps.to(dev)
        use_cfg = ctx.shape[0] != x.shape[0]
        channels = x.shape[1]
        shape = tuple(x.shape[1:])
        x = x * sched.sigmas[0]
        state = init_sampler_state(x)
        for i in range(steps):
            inp = scale_model_input(sched, x, i)
            if cond is not None:
                inp = torch.cat([inp, cond], dim=1)
            if use_cfg:
                inp = torch.cat([inp, inp])
            eps = unet(inp, timesteps[i].expand(inp.shape[0]),
                       ctx)[:, :channels]  # drop the learned variance
            if use_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + guidance * (eps_c - eps_u)
            noise = (randn_rows(step_gens, shape, dev)
                     if sampler.kind in NOISY_KINDS else None)
            x, state = sampler_step(sampler, sched, i, x, eps, state,
                                    noise=noise, start_index=0)
        return x

    @torch.inference_mode()
    def stage1(self, ctx: torch.Tensor, seed: int, rows: range, steps: int,
               sampler, guidance: float) -> torch.Tensor:
        """The base: float images (B, 3, base, base) clipped to [-1, 1]."""
        s1 = self.c.family.base_size
        x = randn_rows(stage_generators(seed, rows, BASE_NOISE), (3, s1, s1),
                       self.c.device)
        x = self._denoise(self.c.unet1, steps, sampler, x, ctx, None,
                          guidance, stage_generators(seed, rows, BASE_STEPS))
        return torch.clamp(x, -1.0, 1.0)

    @torch.inference_mode()
    def stage2(self, ctx: torch.Tensor, base: torch.Tensor, seed: int,
               rows: range, steps: int, sampler,
               guidance: float) -> torch.Tensor:
        """The super-resolution, conditioned on the upsampled base: uint8
        (B, sr, sr, 3) on the device."""
        fam = self.c.family
        cond = base
        for _ in range((fam.sr_size // fam.base_size).bit_length() - 1):
            cond = upsample2x_nearest(cond)
        y = randn_rows(stage_generators(seed, rows, SR_NOISE),
                       (3, fam.sr_size, fam.sr_size), self.c.device)
        y = self._denoise(self.c.unet2, steps, sampler, y, ctx, cond,
                          guidance, stage_generators(seed, rows, SR_STEPS))
        return to_uint8(y)

    def submit(self, prompt: str, negative_prompt: str = "",
               steps: int = 50, sr_steps: int = 30,
               guidance_scale: float = 7.0, batch: int = 1,
               seed: int = 0, scheduler: str | None = None,
               first_row: int = 0) -> tuple[torch.Tensor, int, dict]:
        """Stages 1 and 2: ``(uint8 images on the device, requested rows,
        config)``, at the batch bucket."""
        requested = max(1, batch)
        batch = bucket_batch(requested)
        sampler = resolve(scheduler, prediction_type="epsilon")
        use_cfg = guidance_scale > 1.0
        tok = self.c.tokenizer
        ids = tok.encode_batch([prompt] * batch)
        neg = (tok.encode_batch([negative_prompt or ""] * batch)
               if use_cfg else None)
        rows = range(first_row, first_row + batch)
        guidance = float(guidance_scale)
        ctx = self.encode_text(ids, neg)
        base = self.stage1(ctx, seed, rows, int(steps), sampler, guidance)
        img = self.stage2(ctx, base, seed, rows, int(sr_steps), sampler,
                          guidance)
        fam = self.c.family
        config = {
            "model_name": self.c.model_name,
            "family": fam.name,
            "mode": "cascade_txt2img",
            "steps": int(steps),
            "sr_steps": int(sr_steps),
            "guidance_scale": float(guidance_scale),
            "size": [fam.sr_size, fam.sr_size],
            "scheduler": sampler.kind,
        }
        return img, requested, config

    def __call__(self, prompt: str, negative_prompt: str = "",
                 steps: int = 50, sr_steps: int = 30,
                 guidance_scale: float = 7.0, batch: int = 1,
                 seed: int = 0, scheduler: str | None = None,
                 upscaler=None, final_size: int | None = None,
                 ) -> tuple[np.ndarray, dict]:
        """The whole cascade: stages 1 and 2, and stage 3 when ``upscaler``
        is given, to ``final_size`` (default 4 x sr_size)."""
        img, requested, config = self.submit(
            prompt, negative_prompt, steps=steps, sr_steps=sr_steps,
            guidance_scale=guidance_scale, batch=batch, seed=seed,
            scheduler=scheduler)
        img_u8 = img.cpu().numpy()[:requested]
        stages = 2
        if upscaler is not None:
            img_u8, stage3 = _run_stage3(img_u8, upscaler, prompt, seed,
                                         final_size or
                                         self.c.family.sr_size * 4)
            config.update(stage3)
            if "stage3_passes" in stage3:
                stages += 1
            config["size"] = list(img_u8.shape[1:3])
        config["stages"] = stages
        return img_u8, config


def _run_stage3(img_u8: np.ndarray, upscaler, prompt: str, seed: int,
                final_size: int, first_row: int = 0,
                ) -> tuple[np.ndarray, dict]:
    """Upscale passes until ``final_size``: one x4 pass, or x2 passes. The
    upscaler buckets its input at 1024 px at most, so a pass that makes no
    progress ends the loop (an oversized ``final_size`` would spin it)."""
    target = int(final_size)
    config: dict = {}
    passes = 0
    prev_size = 0
    while img_u8.shape[1] < target and img_u8.shape[1] > prev_size:
        prev_size = img_u8.shape[1]
        img_u8, up_config = upscaler(img_u8, prompt=prompt or "",
                                     seed=seed, first_row=first_row)
        passes += 1
        config.update(up_config)
    if passes:
        config["stage3_passes"] = passes
    return img_u8, config
