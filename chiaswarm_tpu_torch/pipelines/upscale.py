"""The upscalers, counterpart of ``chiaswarm_tpu/pipelines/upscale.py``: the
x2 latent upscaler (``LatentUpscalePipeline`` :55-198) and the SD x4
upscaler (``Upscale4xPipeline`` :196-362).

The reference runs ``stabilityai/sd-x2-latent-upscaler`` over freshly
generated images at 20 steps and guidance 0 (``swarm/diffusion/upscale.py``).
The JAX package traces encode -> nearest-2x latent conditioning -> denoise
scan -> decode into one program; here the same flow is eager PyTorch on the
modules of one ``Components`` bundle (family kind ``"upscaler"``):

1. the prompt through the family's text tower (no negative prompt: no CFG);
2. each image encoded alone (batch 1) with its posterior sampled, then the
   low-res latents upsampled 2x by nearest neighbour;
3. noise on the 2x latent grid, times ``sigmas[0]``;
4. ``steps`` UNet evals on concat(scaled x, the upsampled latents), 8
   channels, under the resolved sampler;
5. the VAE decode, tiled (``models/vae.py::tiled_decode``) when the output's
   longer side is above 1024 px, quantised to uint8 on the device.

Noise: row ``r`` draws each stage from its own CPU generator keyed by
(seed, r, stage), stage 1 the posterior, 2 the initial noise and 3 the step
noise (``core/rng.py::stage_generators``), where the JAX package folds the
stage into the row's key. ``first_row`` offsets the rows, so a batch-1 call
at row i reproduces row i of a batched call.

The x4 upscaler (family kind ``"upscaler4"``, the third stage of the
DeepFloyd cascade) is text conditioned and denoises at the LOW-RES grid; its
f = 4 VAE does the 4x:

1. the prompt through the CLIP-H tower, and under CFG (guidance above 1)
   the negative prompt before it;
2. the low-res image DDPM-noised at ``noise_level`` on the model's own
   schedule, q(x_t | x_0) (stage 1 of the row's noise);
3. 4-channel noise at the low-res grid times ``sigmas[0]`` (stage 2);
4. ``steps`` UNet evals (v-prediction) on concat(scaled x, the noised image),
   7 channels, with the noise level as the class label (doubled under CFG),
   under the resolved sampler (stage 3: the step noise);
5. the decode, tiled exactly when ``4 * max(h, w) > 1024`` (as JAX), to
   uint8 on the device.

Inputs are bucketed as the x2's (``bucket_image_size``, ``bucket_batch``, the
last image repeated as padding). On a ``seq`` > 1 slot the registry refuses
it (ROADMAP queue item 7): JAX rings it, the port's cascade does not run
there.
"""

from __future__ import annotations

import numpy as np
import torch

from chiaswarm_tpu_torch.core.buckets import bucket_batch, bucket_image_size
from chiaswarm_tpu_torch.core.device import upload
from chiaswarm_tpu_torch.core.mesh import DeviceMesh
from chiaswarm_tpu_torch.core.rng import randn_rows, stage_generators
from chiaswarm_tpu_torch.models.common import upsample2x_nearest
from chiaswarm_tpu_torch.models.vae import tiled_decode
from chiaswarm_tpu_torch.parallel.context import sequence_parallel
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import _resize_image, to_uint8
from chiaswarm_tpu_torch.schedulers import (
    NOISY_KINDS,
    ScheduleConfig,
    add_noise,
    init_sampler_state,
    make_noise_schedule,
    make_sampling_schedule,
    resolve,
    sampler_step,
    scale_model_input,
)

DEFAULT_UPSCALE_STEPS = 20  # swarm/diffusion/upscale.py:22-27
DEFAULT_X4_STEPS = 75       # StableDiffusionUpscalePipeline's defaults
DEFAULT_X4_GUIDANCE = 9.0
DEFAULT_NOISE_LEVEL = 20

#: the noise stages of a row, each its own generator: the x2's posterior
#: (the x4's noise on its low-res image), the initial noise, the step noise
POSTERIOR_STAGE, NOISE_STAGE, STEP_STAGE = 1, 2, 3
IMAGE_NOISE_STAGE = POSTERIOR_STAGE


def _bucket_images(images: np.ndarray) -> tuple[np.ndarray, int, int, int]:
    """uint8 (B, H, W, 3) or (H, W, 3) -> float images in [-1, 1] on the
    bucketed grid, padded to the batch bucket with the last image; and the
    requested count and the bucketed (height, width)."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    n = images.shape[0]
    in_h, in_w = images.shape[1:3]
    height, width = bucket_image_size(in_h, in_w)
    batch = bucket_batch(n)
    fimg = images.astype(np.float32) / 127.5 - 1.0
    if (in_h, in_w) != (height, width):
        fimg = np.stack([_resize_image(frame, height, width)
                         for frame in fimg])
    if n < batch:
        fimg = np.concatenate([fimg, np.repeat(fimg[-1:], batch - n, 0)])
    return fimg, n, height, width


class LatentUpscalePipeline:
    """Resident x2 upscaler for one Components bundle. With a ``mesh``
    whose ``seq`` axis is above 1, the denoise loop and the decode run
    under the sequence-parallel context, as ``DiffusionPipeline`` runs its
    generation; the encode stays local."""

    def __init__(self, components: Components,
                 mesh: DeviceMesh | None = None) -> None:
        self.c = components
        self.mesh = mesh
        fam = components.family
        self.noise_schedule = make_noise_schedule(ScheduleConfig(
            beta_schedule=fam.beta_schedule,
            prediction_type=fam.prediction_type))

    @torch.inference_mode()
    def _encode_rows(self, images: np.ndarray, seed: int,
                     rows: range) -> torch.Tensor:
        """Float images (B, H, W, 3) in [-1, 1] -> scaled latents (B, C, h,
        w), each row encoded alone with its stage-1 posterior draw."""
        fam = self.c.family
        f = fam.vae.downscale
        shape = (fam.vae.latent_channels, images.shape[1] // f,
                 images.shape[2] // f)
        noise = randn_rows(stage_generators(seed, rows, POSTERIOR_STAGE),
                           shape, self.c.device)
        x = upload(torch.from_numpy(np.ascontiguousarray(images))
                   .permute(0, 3, 1, 2), self.c.device)
        with sequence_parallel(None):
            return torch.cat([self.c.vae.encode(x[b:b + 1], noise[b:b + 1])
                              for b in range(x.shape[0])])

    @torch.inference_mode()
    def _denoise(self, ctx: torch.Tensor, z_cond: torch.Tensor,
                 seed: int, rows: range, steps: int, sampler,
                 tiled: bool) -> torch.Tensor:
        sched = make_sampling_schedule(self.noise_schedule, steps, sampler)
        timesteps = sched.timesteps.to(self.c.device)
        shape = tuple(z_cond.shape[1:])
        x = randn_rows(stage_generators(seed, rows, NOISE_STAGE), shape,
                       self.c.device) * sched.sigmas[0]
        step_gens = stage_generators(seed, rows, STEP_STAGE)
        state = init_sampler_state(x)
        batch = x.shape[0]
        for i in range(steps):
            inp = torch.cat([scale_model_input(sched, x, i), z_cond], dim=1)
            eps = self.c.unet(inp, timesteps[i].expand(batch), ctx)
            step_noise = (randn_rows(step_gens, shape, self.c.device)
                          if sampler.kind in NOISY_KINDS else None)
            x, state = sampler_step(sampler, sched, i, x, eps, state,
                                    noise=step_noise, start_index=0)
        return to_uint8(tiled_decode(self.c.vae, x) if tiled
                        else self.c.vae.decode(x))

    def __call__(self, images: np.ndarray, prompt: str = "",
                 steps: int = DEFAULT_UPSCALE_STEPS, seed: int = 0,
                 scheduler: str | None = None,
                 first_row: int = 0) -> tuple[np.ndarray, dict]:
        """uint8 (B, H, W, 3) -> uint8 (B, 2H', 2W', 3) at the bucketed
        (H', W'), and the config keys the callers merge into a generation's
        config (namespaced, so they never clobber its own). Guidance is 0 by
        construction: the UNet sees the prompt once, with no CFG branch."""
        fam = self.c.family
        fimg, n, height, width = _bucket_images(images)
        batch = fimg.shape[0]
        sampler = resolve(scheduler, prediction_type=fam.prediction_type)
        rows = range(first_row, first_row + batch)

        ids = [upload(torch.from_numpy(tok.encode_batch([prompt] * batch)),
                      self.c.device) for tok in self.c.tokenizers]
        z_lo = self._encode_rows(fimg, seed, rows)
        with torch.inference_mode(), sequence_parallel(self.mesh):
            seqs = [te(i)[0] for te, i in zip(self.c.text_encoders, ids)]
            ctx = torch.cat(seqs, dim=-1) if len(seqs) > 1 else seqs[0]
            img = self._denoise(ctx, upsample2x_nearest(z_lo), seed, rows,
                                int(steps), sampler,
                                tiled=2 * max(height, width) > 1024)
        config = {
            "upscaler": self.c.model_name,
            "scale": 2,
            "upscale_steps": int(steps),
            "upscale_scheduler": sampler.kind,
        }
        return img.cpu().numpy()[:n], config


class Upscale4xPipeline:
    """Resident SD x4 upscaler for one Components bundle (family kind
    ``"upscaler4"``); see the module docstring. ``encode_text``,
    ``denoise`` and ``decode`` are the stages a caller may time."""

    def __init__(self, components: Components) -> None:
        self.c = components
        fam = components.family
        self.noise_schedule = make_noise_schedule(ScheduleConfig(
            beta_schedule=fam.beta_schedule,
            prediction_type=fam.prediction_type))

    @torch.inference_mode()
    def encode_text(self, ids: list[np.ndarray],
                    neg_ids: list[np.ndarray] | None) -> torch.Tensor:
        """The prompt's text states (the towers' sequences concatenated on
        features), the negative prompt's before them under CFG."""
        def encode(batch_ids: list[np.ndarray]) -> torch.Tensor:
            seqs = [te(upload(torch.from_numpy(i), self.c.device))[0]
                    for te, i in zip(self.c.text_encoders, batch_ids)]
            return torch.cat(seqs, dim=-1) if len(seqs) > 1 else seqs[0]

        ctx = encode(ids)
        return ctx if neg_ids is None else torch.cat([encode(neg_ids), ctx])

    @torch.inference_mode()
    def denoise(self, ctx: torch.Tensor, image: torch.Tensor, seed: int,
                rows: range, steps: int, sampler, guidance: float,
                noise_level: int) -> torch.Tensor:
        """Float images (B, 3, h, w) in [-1, 1] -> the denoised scaled
        latents (B, C, h, w) at the same grid."""
        dev = self.c.device
        sched = make_sampling_schedule(self.noise_schedule, steps, sampler)
        timesteps = sched.timesteps.to(dev)
        use_cfg = ctx.shape[0] != image.shape[0]
        level = torch.full((image.shape[0],), int(noise_level),
                           dtype=torch.long)
        img_noise = randn_rows(stage_generators(seed, rows, IMAGE_NOISE_STAGE),
                               tuple(image.shape[1:]), dev)
        img_noised = add_noise(self.noise_schedule, image, img_noise, level)
        shape = (self.c.family.vae.latent_channels, *image.shape[2:])
        x = randn_rows(stage_generators(seed, rows, NOISE_STAGE), shape,
                       dev) * sched.sigmas[0]
        labels = (torch.cat([level, level]) if use_cfg else level).to(dev)
        step_gens = stage_generators(seed, rows, STEP_STAGE)
        state = init_sampler_state(x)
        for i in range(steps):
            inp = torch.cat([scale_model_input(sched, x, i), img_noised],
                            dim=1)
            if use_cfg:
                inp = torch.cat([inp, inp])
            out = self.c.unet(inp, timesteps[i].expand(inp.shape[0]), ctx,
                              class_labels=labels)
            if use_cfg:
                out_u, out_c = out.chunk(2)
                out = out_u + guidance * (out_c - out_u)
            step_noise = (randn_rows(step_gens, shape, dev)
                          if sampler.kind in NOISY_KINDS else None)
            x, state = sampler_step(sampler, sched, i, x, out, state,
                                    noise=step_noise, start_index=0)
        return x

    @torch.inference_mode()
    def decode(self, x: torch.Tensor, tiled: bool) -> torch.Tensor:
        """Scaled latents -> uint8 (B, 4h, 4w, 3) on the device."""
        return to_uint8(tiled_decode(self.c.vae, x) if tiled
                        else self.c.vae.decode(x))

    def __call__(self, images: np.ndarray, prompt: str = "",
                 negative_prompt: str = "",
                 steps: int = DEFAULT_X4_STEPS,
                 guidance_scale: float = DEFAULT_X4_GUIDANCE,
                 noise_level: int = DEFAULT_NOISE_LEVEL,
                 seed: int = 0,
                 scheduler: str | None = None,
                 first_row: int = 0) -> tuple[np.ndarray, dict]:
        """uint8 (B, H, W, 3) -> uint8 (B, 4H', 4W', 3) at the bucketed
        (H', W'), and the namespaced config keys the callers merge."""
        fam = self.c.family
        fimg, n, height, width = _bucket_images(images)
        batch = fimg.shape[0]
        sampler = resolve(scheduler, prediction_type=fam.prediction_type)
        use_cfg = float(guidance_scale) > 1.0
        rows = range(first_row, first_row + batch)
        ids = [tok.encode_batch([prompt] * batch) for tok in self.c.tokenizers]
        neg = ([tok.encode_batch([negative_prompt or ""] * batch)
                for tok in self.c.tokenizers] if use_cfg else None)
        image = upload(torch.from_numpy(np.ascontiguousarray(fimg))
                       .permute(0, 3, 1, 2), self.c.device)
        ctx = self.encode_text(ids, neg)
        x = self.denoise(ctx, image, seed, rows, int(steps), sampler,
                         float(guidance_scale), int(noise_level))
        img = self.decode(x, tiled=4 * max(height, width) > 1024)
        config = {
            "upscaler": self.c.model_name,
            "scale": 4,
            "upscale_steps": int(steps),
            "upscale_noise_level": int(noise_level),
            "upscale_scheduler": sampler.kind,
        }
        return img.cpu().numpy()[:n], config
