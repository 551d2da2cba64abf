"""The txt2audio pipeline (AudioLDM-class mel-latent diffusion),
counterpart of ``chiaswarm_tpu/pipelines/audio.py``.

The JAX package traces text encode -> denoise scan -> VAE decode -> vocoder
into one compiled program; here the same flow is plain Python over modules
resident on one device:

- the CLAP tower encodes the prompt (and, under classifier-free guidance,
  the negative prompt), padded to 512 tokens; its projected
  ``text_embeds``, L2-normalised, are the UNet's float class labels, the
  negative prompt's rows before the prompt's;
- the UNet (no text cross-attention) denoises a (B, 8, T/4, 16) latent of
  the log-mel spectrogram, time along H, under the resolved sampler; its
  level-0 self-attention (4 heads of 32 over 2,560 tokens at 10 s) takes
  kernel B1 on the card;
- the 1-channel VAE decodes the mel spectrogram; the HiFiGAN vocoder turns
  ``mel[:, 0]`` (B, T, 64) into 16 kHz samples, trimmed to
  ``duration_s x rate``.

``_frames_for`` buckets the mel frames to a multiple of the VAE's downscale
x 2^(levels - 1), as JAX does (a 10 s job: 625 frames -> 640, a 160 x 16
latent). Noise follows the port's convention (``core/rng.py``): row b's
initial noise and, for the ancestral kinds, its step noise come from its
own CPU generator, so the same seed gives other noise, and other audio,
than the JAX package; ``init_noise`` (the JAX layout (B|1, T/4, 16, 8))
replaces the initial draw, which the parity tests use. The config keys are
JAX's.

:class:`AudioComponents` holds the four modules: CLAP and the vocoder in
float32, the UNet and the VAE in their configs' dtypes (bf16 for
``AUDIOLDM``, float32 for ``TINY_AUDIO``), from a seed (:meth:`random`),
from the JAX package's params (:meth:`from_jax`) or from a diffusers
directory (``convert/checkpoint.py::load_audio_checkpoint``). The vocoder
mirrors JAX's ``HifiGanConfig`` (hop 256), which a published SpeechT5
vocoder may not match (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.core.buckets import bucket_batch
from chiaswarm_tpu_torch.core.device import resolve_device, upload
from chiaswarm_tpu_torch.core.rng import randn_rows, row_generators, row_seed
from chiaswarm_tpu_torch.models.clap import ClapTextConfig, ClapTextEncoder
from chiaswarm_tpu_torch.models.configs import UNetConfig, VAEConfig
from chiaswarm_tpu_torch.models.tokenizer import HashTokenizer, Tokenizer
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.models.vae import AutoencoderKL
from chiaswarm_tpu_torch.models.vocoder import HifiGan, HifiGanConfig
from chiaswarm_tpu_torch.pipelines.components import (
    build_modules,
    flax_default_init,
)
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
class AudioFamily:
    """The architecture of one AudioLDM-class checkpoint."""

    name: str
    text_encoder: ClapTextConfig      # CLAP text tower (RoBERTa layout)
    unet: UNetConfig                  # over mel latents, class-conditioned
    vae: VAEConfig                    # 1-channel mel autoencoder
    vocoder: HifiGanConfig
    n_mel: int = 64
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"


AUDIOLDM = AudioFamily(
    name="audioldm",
    text_encoder=ClapTextConfig(),
    unet=UNetConfig(
        sample_channels=8, out_channels=8,
        block_out_channels=(128, 256, 384, 640),
        transformer_depth=(1, 1, 1, 1),
        attention_head_dim=32, head_dim_is_count=False,
        cross_attention_dim=None,
        class_proj_dim=512, class_embeddings_concat=True,
    ),
    vae=VAEConfig(in_channels=1, latent_channels=8,
                  block_out_channels=(128, 256, 512),
                  scaling_factor=0.9227),
    vocoder=HifiGanConfig(),
)

TINY_AUDIO = AudioFamily(
    name="tiny_audio",
    text_encoder=ClapTextConfig(
        vocab_size=1000, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4, projection_dim=32,
        max_position_embeddings=130, max_length=77),
    unet=UNetConfig(
        sample_channels=8, out_channels=8,
        block_out_channels=(32, 64), layers_per_block=1,
        transformer_depth=(1, 1), attention_head_dim=4,
        head_dim_is_count=True, cross_attention_dim=None,
        class_proj_dim=32, class_embeddings_concat=True, dtype="float32"),
    vae=VAEConfig(in_channels=1, latent_channels=8,
                  block_out_channels=(16, 32), layers_per_block=1,
                  dtype="float32"),
    vocoder=HifiGanConfig(model_in_dim=16, upsample_initial_channel=32,
                          upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                          resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),)),
    n_mel=16,
)

AUDIO_FAMILIES = {f.name: f for f in (AUDIOLDM, TINY_AUDIO)}


def get_audio_family(model_name: str) -> AudioFamily:
    """A family by name or by the name's last path part; AudioLDM
    otherwise (JAX's rule)."""
    low = (model_name or "").lower()
    tail = low.rsplit("/", 1)[-1]
    if low in AUDIO_FAMILIES:
        return AUDIO_FAMILIES[low]
    if tail in AUDIO_FAMILIES:
        return AUDIO_FAMILIES[tail]
    return AUDIO_FAMILIES["audioldm"]


#: the modules of a family, in the order their random seeds are derived
MODULES = ("text_encoder", "unet", "vae", "vocoder")


def _ctor(family: AudioFamily, name: str) -> tuple[Any, Any, str]:
    return {"text_encoder": (ClapTextEncoder, family.text_encoder,
                             family.text_encoder.dtype),
            "unet": (UNet, family.unet, family.unet.dtype),
            "vae": (AutoencoderKL, family.vae, family.vae.dtype),
            "vocoder": (HifiGan, family.vocoder, family.vocoder.dtype)}[name]


def hash_tokenizer(family: AudioFamily) -> HashTokenizer:
    """The vocab-file-free tokenizer of random weights, with the CLAP
    tower's specials and length."""
    t = family.text_encoder
    return HashTokenizer(t.vocab_size, t.max_length, eos_id=t.eos_token_id,
                         bos_id=t.bos_token_id, pad_id=t.pad_token_id)


@dataclasses.dataclass
class AudioComponents:
    family: AudioFamily
    model_name: str
    tokenizer: Tokenizer
    text_encoder: ClapTextEncoder
    unet: UNet
    vae: AutoencoderKL
    vocoder: HifiGan
    device: torch.device

    @classmethod
    def build(cls, family: AudioFamily | str, model_name: str | None,
              device: str | torch.device | None, fill,
              tokenizer: Tokenizer | None = None,
              precast: bool = False) -> "AudioComponents":
        """The four modules with storage on ``device``, each filled by
        ``fill(index, name, module)`` and cast to its config's dtype (before
        the fill with ``precast``); the norms and ``conv_out`` of the UNet
        and the VAE stay float32, as everywhere in the port."""
        if isinstance(family, str):
            family = AUDIO_FAMILIES[family]
        dev = resolve_device(device)
        modules = build_modules([(name, *_ctor(family, name))
                                 for name in MODULES], dev, fill, precast)
        return cls(family=family,
                   model_name=model_name or f"random/{family.name}",
                   tokenizer=tokenizer or hash_tokenizer(family),
                   device=dev, **modules)

    @classmethod
    def random(cls, family: AudioFamily | str, seed: int = 0,
               model_name: str | None = None,
               device: str | torch.device | None = None,
               tokenizer: Tokenizer | None = None) -> "AudioComponents":
        """Seeded weights with Flax's default distributions on ``device``
        (default ``cuda``)."""

        def fill(index: int, name: str, module: nn.Module) -> None:
            dev = next(module.parameters()).device
            flax_default_init(module, torch.Generator(device=dev).manual_seed(
                row_seed(seed, index)))

        return cls.build(family, model_name, device, fill, tokenizer)

    @classmethod
    def from_jax(cls, params: dict[str, Any], family: AudioFamily | str,
                 device: str | torch.device | None = None,
                 model_name: str | None = None,
                 tokenizer: Tokenizer | None = None) -> "AudioComponents":
        """The JAX package's ``AudioComponents.params``."""
        from chiaswarm_tpu_torch.convert.from_jax import audio_state_from_flax

        if isinstance(family, str):
            family = AUDIO_FAMILIES[family]
        state = audio_state_from_flax(params, family)

        def fill(index: int, name: str, module: nn.Module) -> None:
            module.load_state_dict(state[name], strict=True)

        return cls.build(family, model_name, device, fill, tokenizer)

    def modules(self) -> list[nn.Module]:
        return [getattr(self, name) for name in MODULES]

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())


class AudioPipeline:
    """The resident txt2audio executor: ``__call__`` -> (waveform float32
    (B, samples), sample rate, config)."""

    def __init__(self, components: AudioComponents) -> None:
        self.c = components
        fam = components.family
        self.noise_schedule = make_noise_schedule(ScheduleConfig(
            beta_schedule=fam.beta_schedule,
            prediction_type=fam.prediction_type))

    def _frames_for(self, duration_s: float) -> int:
        """Duration -> mel frames, rounded up to a multiple of the latent
        grid's total downscale (JAX :183-194)."""
        fam = self.c.family
        frames = int(round(duration_s * fam.vocoder.sampling_rate
                           / fam.vocoder.hop_length))
        quantum = fam.vae.downscale * (2 ** (
            len(fam.unet.block_out_channels) - 1))
        return max(quantum, (frames + quantum - 1) // quantum * quantum)

    def _latent_shape(self, frames: int) -> tuple[int, int, int]:
        fam = self.c.family
        f = fam.vae.downscale
        return fam.vae.latent_channels, frames // f, fam.n_mel // f

    @torch.inference_mode()
    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        """CLAP ``text_embeds`` of ``prompts``, L2-normalised (B, proj)."""
        ids = torch.from_numpy(self.c.tokenizer.encode_batch(prompts)).long()
        _, proj = self.c.text_encoder(upload(ids, self.c.device))
        return proj / proj.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def initial_noise(self, init_noise: np.ndarray | None, batch: int,
                      frames: int, generators: list) -> torch.Tensor:
        shape = self._latent_shape(frames)
        if init_noise is None:
            return randn_rows(generators, shape, self.c.device)
        noise = np.array(init_noise, np.float32)
        if noise.ndim == 3:
            noise = noise[None]
        want = (shape[1], shape[2], shape[0])
        if noise.shape[1:] != want or noise.shape[0] > batch:
            raise ValueError(f"init_noise of shape {noise.shape} does not fit "
                             f"batch {batch} of latents {want}")
        if noise.shape[0] < batch:
            noise = np.concatenate(
                [noise, np.repeat(noise[-1:], batch - noise.shape[0], 0)])
        return upload(torch.from_numpy(noise).permute(0, 3, 1, 2)
                      .contiguous(), self.c.device)

    @torch.inference_mode()
    def denoise(self, cond: torch.Tensor, noise: torch.Tensor, *, steps: int,
                sampler, guidance: float, generators: list) -> torch.Tensor:
        """The sampler's loop over the latent; ``cond`` holds the negative
        prompt's rows before the prompt's under guidance."""
        sched = make_sampling_schedule(self.noise_schedule, steps, sampler)
        timesteps = sched.timesteps.to(self.c.device)
        use_cfg = cond.shape[0] == 2 * noise.shape[0]
        rows = cond.shape[0]
        x = noise * sched.sigmas[0]
        state = init_sampler_state(x)
        for i in range(steps):
            inp = scale_model_input(sched, x, i)
            t = timesteps[i].expand(rows)
            if use_cfg:
                out = self.c.unet(torch.cat([inp, inp], dim=0), t, None,
                                  class_labels=cond)
                eps_u, eps_c = out.chunk(2, dim=0)
                eps = eps_u + guidance * (eps_c - eps_u)
            else:
                eps = self.c.unet(inp, t, None, class_labels=cond)
            step_noise = (randn_rows(generators, tuple(x.shape[1:]),
                                     self.c.device)
                          if sampler.kind in NOISY_KINDS else None)
            x, state = sampler_step(sampler, sched, i, x, eps, state,
                                    noise=step_noise, start_index=0)
        return x

    @torch.inference_mode()
    def decode_mel(self, x: torch.Tensor) -> torch.Tensor:
        """Latents -> the (B, T, n_mel) float32 log-mel spectrogram."""
        return self.c.vae.decode(x)[:, 0].float()

    @torch.inference_mode()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.c.vocoder(mel)

    def __call__(self, prompt: str, negative_prompt: str = "",
                 steps: int = 20, guidance_scale: float = 2.5,
                 duration_s: float = 10.0, batch: int = 1, seed: int = 0,
                 scheduler: str | None = None,
                 init_noise: np.ndarray | None = None
                 ) -> tuple[np.ndarray, int, dict]:
        fam = self.c.family
        batch = bucket_batch(max(1, batch))
        frames = self._frames_for(duration_s)
        sampler = resolve(scheduler, prediction_type=fam.prediction_type)
        cond = self.encode_text([prompt] * batch)
        if guidance_scale > 1.0:
            cond = torch.cat([self.encode_text([negative_prompt or ""] * batch),
                              cond], dim=0)
        generators = row_generators([(seed, i) for i in range(batch)])
        noise = self.initial_noise(init_noise, batch, frames, generators)
        x = self.denoise(cond, noise, steps=int(steps), sampler=sampler,
                         guidance=float(guidance_scale),
                         generators=generators)
        wav = self.vocode(self.decode_mel(x)).cpu().numpy()
        sr = fam.vocoder.sampling_rate
        wav = wav[:, :int(round(duration_s * sr))]
        config = {
            "model_name": self.c.model_name,
            "family": fam.name,
            "mode": "txt2audio",
            "steps": int(steps),
            "guidance_scale": float(guidance_scale),
            "duration_s": round(wav.shape[1] / sr, 3),
            "sample_rate": sr,
            "scheduler": sampler.kind,
        }
        return wav, sr, config
