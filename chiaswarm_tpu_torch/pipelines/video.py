"""The video pipelines, counterpart of ``chiaswarm_tpu/pipelines/video.py``:
txt2vid on the ModelScope ``UNet3D`` (:class:`VideoPipeline`, JAX
:525-631) and img2vid on SVD's ``UNetSpatioTemporal`` with its temporal
VAE (:class:`Img2VidPipeline`, JAX :634-817). vid2vid runs per-frame
img2img on an SD family (``workloads/video.py``).

The JAX package traces each job into one compiled program; here the flow
is plain Python over modules resident on one device, cut into stages a
caller can time (``encode_text`` or ``encode_image``, ``denoise``,
``decode``):

- frames bucket to a multiple of 8, capped at the family's
  ``max_frames``; the first ``requested`` frames are returned, each scaled
  to cover and centre-cropped back to the requested size on the host
  (:func:`_unbucket_frames`, PIL LANCZOS);
- txt2vid: the CLIP text tower encodes the prompt (and, under guidance,
  the negative prompt before it); the UNet denoises the (1, F, C, h, w)
  clip latent on the doubled batch under ``resolve(scheduler,
  prediction_type="epsilon")``; the SD VAE decodes the frames folded into
  its batch;
- img2vid: the start image is CLIP-preprocessed (shortest edge to the
  tower's size, bicubic, centre crop, CLIP mean and std) for the image
  tower, whose projected embedding is the one context token; the image,
  noise-augmented, is encoded to the un-scaled ``encode_moments`` mean
  (no ``scaling_factor``), broadcast to every frame and concatenated on
  the channels; under guidance the unconditional branch zeroes both the
  embedding and the conditioning latents, and the guidance ramps linearly
  per frame from ``min_guidance_scale`` to ``max_guidance_scale``; the
  denoise runs the EDM schedule (``make_edm_schedule``: Karras sigmas over
  the family's range, continuous ``0.25 log(sigma)`` timesteps) under
  ``resolve(scheduler or "EulerDiscreteScheduler",
  prediction_type="v_prediction")``; the temporal VAE decodes the whole
  clip;
- the frames are quantized to uint8 on the card and cross to the host once.

Noise follows the port's convention (``core/rng.py``): a job's initial
clip latent from one CPU generator seeded from (seed, row 0), which the
ancestral kinds keep drawing their step noise from; img2vid's noise
augmentation from the job's ``noise_aug_generator``. So the same seed gives
other bits than JAX's threefry. ``init_noise`` (JAX's layout (1, F, h, w,
C)) and, for img2vid, ``aug_noise`` ((1, H, W, 3)) replace the draws; the
parity tests use them.

:class:`VideoComponents` holds the modules: the text tower (text families)
or the image tower (SVD-class) in float32, the UNet and VAE in their
configs' dtypes, from a seed (:meth:`VideoComponents.random`), from the JAX
package's params (:meth:`VideoComponents.from_jax`) or from a diffusers
snapshot (:meth:`VideoComponents.from_checkpoint`: strict for ModelScope
and SVD snapshots, JAX's 2D inflation of a plain SD snapshot into a text
family, SVD refusing a 2D snapshot before any build).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.core.buckets import bucket_image_size
from chiaswarm_tpu_torch.core.device import resolve_device, upload
from chiaswarm_tpu_torch.core.rng import (
    noise_aug_generator,
    randn_rows,
    row_generators,
    row_seed,
)
from chiaswarm_tpu_torch.models.clip import (
    ClipTextEncoder,
    ClipVisionEncoder,
    VisionConfig,
)
from chiaswarm_tpu_torch.models.configs import (
    TextEncoderConfig,
    UNetConfig,
    VAEConfig,
)
from chiaswarm_tpu_torch.models.tokenizer import HashTokenizer, Tokenizer
from chiaswarm_tpu_torch.models.vae import (
    AutoencoderKL,
    AutoencoderKLTemporalDecoder,
)
from chiaswarm_tpu_torch.models.video_unet import (
    UNet3D,
    UNetSpatioTemporal,
    init_video_extras,
)
from chiaswarm_tpu_torch.pipelines.components import (
    build_modules,
    flax_default_init,
)
from chiaswarm_tpu_torch.pipelines.diffusion import to_uint8
from chiaswarm_tpu_torch.schedulers import (
    NOISY_KINDS,
    ScheduleConfig,
    init_sampler_state,
    make_edm_schedule,
    make_noise_schedule,
    make_sampling_schedule,
    resolve,
    sampler_step,
    scale_model_input,
)
from chiaswarm_tpu_torch.schedulers.common import linspace32


@dataclasses.dataclass(frozen=True)
class VideoFamily:
    name: str
    # None for image-conditioned families (SVD has no text tower)
    text_encoder: TextEncoderConfig | None
    unet: UNetConfig
    vae: VAEConfig
    default_size: int = 256
    max_frames: int = 64
    # SVD-class img2vid: CLIP-image conditioning + concat cond latents
    image_conditioned: bool = False
    vision: VisionConfig | None = None
    prediction_type: str = "epsilon"
    # EDM continuous-sigma schedule (SVD); None = discrete (ModelScope)
    edm_sigma_range: tuple[float, float] | None = None
    default_frames: int = 25


# text-to-video-ms-1.7b shaped (CLIP-H text tower, 4-level UNet3D); the
# spatial transformers keep the conv projections of the published snapshot
MODELSCOPE = VideoFamily(
    name="modelscope_t2v",
    text_encoder=TextEncoderConfig(
        hidden_size=1024, intermediate_size=4096, num_layers=23,
        num_heads=16, hidden_act="gelu"),
    unet=UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        transformer_depth=(1, 1, 1, 0),
        attention_head_dim=64, head_dim_is_count=False,
        cross_attention_dim=1024,
    ),
    vae=VAEConfig(),
    default_size=256,
)

TINY_VID = VideoFamily(
    name="tiny_vid",
    text_encoder=TextEncoderConfig(
        vocab_size=1000, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4, eos_token_id=999),
    unet=UNetConfig(
        block_out_channels=(32, 64), layers_per_block=1,
        transformer_depth=(1, 1), attention_head_dim=4,
        head_dim_is_count=True, cross_attention_dim=32, dtype="float32"),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                  dtype="float32"),
    default_size=64,
    max_frames=16,
    default_frames=8,
)

# stable-video-diffusion-img2vid shaped: the 8-channel spatio-temporal UNet,
# ViT-H/14's projected embedding as the one context token, the three
# micro-conditioning ids through the 256-dim added embedding, the EDM
# schedule under v-prediction
SVD = VideoFamily(
    name="svd_img2vid",
    text_encoder=None,
    unet=UNetConfig(
        sample_channels=8, out_channels=4,
        block_out_channels=(320, 640, 1280, 1280),
        transformer_depth=(1, 1, 1, 0),
        attention_head_dim=64, head_dim_is_count=False,
        cross_attention_dim=1024,
        addition_embed_dim=256,
    ),
    vae=VAEConfig(),
    default_size=512,
    max_frames=25,
    image_conditioned=True,
    vision=VisionConfig(hidden_size=1280, intermediate_size=5120,
                        num_layers=32, num_heads=16, image_size=224,
                        patch_size=14, projection_dim=1024,
                        hidden_act="gelu"),
    prediction_type="v_prediction",
    edm_sigma_range=(0.002, 700.0),
    default_frames=14,
)

TINY_SVD = VideoFamily(
    name="tiny_svd",
    text_encoder=None,
    unet=UNetConfig(
        sample_channels=8, out_channels=4,
        block_out_channels=(32, 64), layers_per_block=1,
        transformer_depth=(1, 1), attention_head_dim=4,
        head_dim_is_count=True, cross_attention_dim=16,
        addition_embed_dim=8, dtype="float32"),
    # the temporal decoder needs the published 2-resnet layout
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=2,
                  dtype="float32"),
    default_size=64,
    max_frames=16,
    image_conditioned=True,
    vision=VisionConfig(hidden_size=16, intermediate_size=32, num_layers=2,
                        num_heads=2, image_size=28, patch_size=14,
                        projection_dim=16),
    prediction_type="v_prediction",
    edm_sigma_range=(0.002, 700.0),
    default_frames=8,
)

VIDEO_FAMILIES = {f.name: f for f in (MODELSCOPE, TINY_VID, SVD, TINY_SVD)}

_VIDEO_NAME_HINTS = (
    ("stable-video", "svd_img2vid"),
    ("svd", "svd_img2vid"),
    ("img2vid", "svd_img2vid"),
)

#: CLIP's image normalisation (openai/clip-vit-large-patch14)
_CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def get_video_family(model_name: str) -> VideoFamily:
    """A model name -> its family: the family's own name (or the name's last
    path part), else the SVD name hints, else ModelScope."""
    low = (model_name or "").lower()
    tail = low.rsplit("/", 1)[-1]
    if low in VIDEO_FAMILIES:
        return VIDEO_FAMILIES[low]
    if tail in VIDEO_FAMILIES:
        return VIDEO_FAMILIES[tail]
    for hint, family in _VIDEO_NAME_HINTS:
        if hint in low:
            return VIDEO_FAMILIES[family]
    return VIDEO_FAMILIES["modelscope_t2v"]


def make_video_unet(family: VideoFamily) -> UNet3D | UNetSpatioTemporal:
    """SVD-class families run the spatio-temporal layout, text families
    the ModelScope UNet3D."""
    cls = UNetSpatioTemporal if family.image_conditioned else UNet3D
    return cls(family.unet)


def make_video_vae(family: VideoFamily
                   ) -> AutoencoderKL | AutoencoderKLTemporalDecoder:
    """SVD-class families ship the temporal-decoder VAE, text families
    the standard one."""
    cls = (AutoencoderKLTemporalDecoder if family.image_conditioned
           else AutoencoderKL)
    return cls(family.vae)


def _specs(family: VideoFamily) -> list[tuple]:
    """(name, constructor, config, dtype name) of a family's modules."""
    cond = (("image_encoder", ClipVisionEncoder, family.vision, "float32")
            if family.image_conditioned else
            ("text_encoder", ClipTextEncoder, family.text_encoder, "float32"))
    return [cond,
            ("unet", lambda _: make_video_unet(family), None,
             family.unet.dtype),
            ("vae", lambda _: make_video_vae(family), None, family.vae.dtype)]


def _hash_tokenizer(family: VideoFamily) -> HashTokenizer:
    te = family.text_encoder
    return HashTokenizer(te.vocab_size, te.max_position_embeddings,
                         te.eos_token_id)


@dataclasses.dataclass
class VideoComponents:
    family: VideoFamily
    model_name: str
    tokenizer: Tokenizer | None
    text_encoder: ClipTextEncoder | None
    unet: UNet3D | UNetSpatioTemporal
    vae: AutoencoderKL | AutoencoderKLTemporalDecoder
    device: torch.device
    image_encoder: ClipVisionEncoder | None = None
    #: a checkpoint load's statistics (``convert/checkpoint.py``)
    load_stats: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, family: VideoFamily | str, model_name: str | None,
              device: str | torch.device | None, fill,
              tokenizer: Tokenizer | None = None,
              precast: bool = False) -> "VideoComponents":
        if isinstance(family, str):
            family = VIDEO_FAMILIES[family]
        dev = resolve_device(device)
        modules = build_modules(_specs(family), dev, fill, precast)
        if not family.image_conditioned and tokenizer is None:
            tokenizer = _hash_tokenizer(family)
        return cls(family=family,
                   model_name=model_name or f"random/{family.name}",
                   tokenizer=tokenizer, device=dev,
                   text_encoder=modules.get("text_encoder"),
                   image_encoder=modules.get("image_encoder"),
                   unet=modules["unet"], vae=modules["vae"])

    @classmethod
    def random(cls, family: VideoFamily | str, seed: int = 0,
               model_name: str | None = None,
               device: str | torch.device | None = None
               ) -> "VideoComponents":
        """Seeded weights on ``device`` (default ``cuda``): Flax's default
        distributions, the published constant inits (``mix_factor``, zero
        ``conv4``) and the image tower's class embedding N(0, 0.02)."""

        @torch.no_grad()
        def fill(index: int, name: str, module: nn.Module) -> None:
            dev = next(module.parameters()).device
            gen = torch.Generator(device=dev).manual_seed(
                row_seed(seed, index))
            flax_default_init(module, gen)
            init_video_extras(module)
            if isinstance(module, ClipVisionEncoder):
                module.vision_model.embeddings.class_embedding.normal_(
                    0.0, 0.02, generator=gen)

        return cls.build(family, model_name, device, fill)

    @classmethod
    def from_jax(cls, params: dict[str, Any], family: VideoFamily | str,
                 device: str | torch.device | None = None,
                 model_name: str | None = None,
                 tokenizer: Tokenizer | None = None) -> "VideoComponents":
        """The JAX package's ``VideoComponents.params``."""
        from chiaswarm_tpu_torch.convert.from_jax import video_state_from_flax

        if isinstance(family, str):
            family = VIDEO_FAMILIES[family]
        state = video_state_from_flax(params, family)

        def fill(index: int, name: str, module: nn.Module) -> None:
            module.load_state_dict(state[name], strict=True)

        return cls.build(family, model_name, device, fill, tokenizer)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str | Path, model_name: str,
                        family: VideoFamily | str | None = None,
                        device: str | torch.device | None = None
                        ) -> "VideoComponents":
        """A diffusers video snapshot on ``device`` (default ``cuda``),
        through ``convert/checkpoint.py::load_video_checkpoint``."""
        from chiaswarm_tpu_torch.convert.checkpoint import (
            load_video_checkpoint,
        )

        if isinstance(family, str):
            family = VIDEO_FAMILIES[family]
        return load_video_checkpoint(checkpoint_dir, model_name,
                                     family or MODELSCOPE, device)

    def modules(self) -> list[nn.Module]:
        cond = self.image_encoder if self.family.image_conditioned \
            else self.text_encoder
        return [cond, self.unet, self.vae]

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for m in self.modules() for p in m.parameters())


def _unbucket_frames(img_u8: np.ndarray, req_height: int, req_width: int,
                     height: int, width: int) -> np.ndarray:
    """Scale-to-cover + centre-crop every frame back to the requested size
    after a bucketed generation (JAX :504-522)."""
    if (height, width) == (req_height, req_width):
        return img_u8
    from PIL import Image

    scale = max(req_height / height, req_width / width)
    rh = max(req_height, round(height * scale))
    rw = max(req_width, round(width * scale))
    y0, x0 = (rh - req_height) // 2, (rw - req_width) // 2
    return np.stack([
        np.asarray(Image.fromarray(frame).resize(
            (rw, rh), Image.LANCZOS))[y0:y0 + req_height, x0:x0 + req_width]
        for frame in img_u8
    ])


def _clip_frames(family: VideoFamily, num_frames: int | None
                 ) -> tuple[int, int]:
    """(requested, bucketed) frame counts: the request capped at
    ``max_frames``, bucketed to a multiple of 8 under the same cap."""
    requested = max(1, min(int(num_frames or family.default_frames),
                           family.max_frames))
    return requested, min((requested + 7) // 8 * 8, family.max_frames)


class _ClipPipeline:
    """What both video pipelines share: the initial clip latent and the
    guided denoise loop."""

    def __init__(self, components: VideoComponents) -> None:
        self.c = components

    def _latent_shape(self, frames: int, height: int,
                      width: int) -> tuple[int, ...]:
        vae = self.c.family.vae
        f = vae.downscale
        return (frames, vae.latent_channels, height // f, width // f)

    def initial_noise(self, init_noise: np.ndarray | None, frames: int,
                      height: int, width: int,
                      generators: list[torch.Generator]) -> torch.Tensor:
        """(1, F, C, h, w) standard normal: from row 0's generator, or
        ``init_noise`` in JAX's layout (1, F, h, w, C)."""
        shape = self._latent_shape(frames, height, width)
        if init_noise is None:
            return randn_rows(generators, shape, self.c.device)
        noise = np.array(init_noise, np.float32)
        want = (1, shape[0], shape[2], shape[3], shape[1])
        if noise.shape != want:
            raise ValueError(f"init_noise shape {noise.shape} != {want}")
        return upload(torch.from_numpy(noise).permute(0, 1, 4, 2, 3)
                      .contiguous(), self.c.device)

    @torch.inference_mode()
    def denoise(self, sched, noise: torch.Tensor, ctx: torch.Tensor, *,
                sampler, guidance, generators: list[torch.Generator],
                cond: torch.Tensor | None = None,
                added: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """The sampler's loop over the (1, F, C, h, w) clip latent. Under
        guidance (``ctx`` holds two rows, the unconditional first) each
        eval runs the doubled batch; ``guidance`` is a float or a
        per-frame (1, F, 1, 1, 1) tensor. ``cond`` (rows, F, C', h, w) is
        concatenated on the channels of every eval's input."""
        timesteps = sched.timesteps.to(self.c.device)
        rows = ctx.shape[0]
        x = noise * sched.sigmas[0]
        state = init_sampler_state(x)
        for i in range(len(sched.timesteps)):
            inp = scale_model_input(sched, x, i)
            if rows == 2:
                inp = torch.cat([inp, inp], dim=0)
            if cond is not None:
                inp = torch.cat([inp, cond], dim=2)
            out = self.c.unet(inp, timesteps[i].expand(rows), ctx, added)
            if rows == 2:
                eps_u, eps_c = out.chunk(2, dim=0)
                eps = eps_u + guidance * (eps_c - eps_u)
            else:
                eps = out
            step_noise = (randn_rows(generators, tuple(x.shape[1:]),
                                     self.c.device)
                          if sampler.kind in NOISY_KINDS else None)
            x, state = sampler_step(sampler, sched, i, x, eps, state,
                                    noise=step_noise, start_index=0)
        return x

    def _frames_out(self, frames_u8: torch.Tensor, requested: int,
                    hw: tuple[int, int], req_hw: tuple[int, int]
                    ) -> np.ndarray:
        img = frames_u8.cpu().numpy()
        return _unbucket_frames(img, *req_hw, *hw)[:requested]


class VideoPipeline(_ClipPipeline):
    """The resident txt2vid executor (ModelScope-class)."""

    def __init__(self, components: VideoComponents) -> None:
        if components.family.image_conditioned:
            raise ValueError("VideoPipeline requires a text-to-video family")
        super().__init__(components)
        self.noise_schedule = make_noise_schedule(ScheduleConfig(
            beta_schedule="scaled_linear", prediction_type="epsilon"))

    @torch.inference_mode()
    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.c.tokenizer.encode_batch(prompts)).long()
        seq, _ = self.c.text_encoder(upload(ids, self.c.device))
        return seq

    @torch.inference_mode()
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """The (1, F, C, h, w) clip latent -> uint8 (F, H, W, 3) on the
        device, the frames folded into the VAE's batch."""
        return to_uint8(self.c.vae.decode(x[0]))

    def __call__(self, prompt: str, negative_prompt: str = "",
                 num_frames: int | None = None, steps: int = 25,
                 guidance_scale: float = 9.0, height: int | None = None,
                 width: int | None = None, seed: int = 0,
                 scheduler: str | None = None,
                 init_noise: np.ndarray | None = None
                 ) -> tuple[np.ndarray, dict]:
        """Returns (frames uint8 (F, H, W, 3), config)."""
        fam = self.c.family
        req_h = int(height or fam.default_size)
        req_w = int(width or fam.default_size)
        height, width = bucket_image_size(req_h, req_w)
        requested, frames = _clip_frames(fam, num_frames)
        sampler = resolve(scheduler, prediction_type="epsilon")
        use_cfg = guidance_scale > 1.0
        ctx = self.encode_text([prompt])
        if use_cfg:
            ctx = torch.cat([self.encode_text([negative_prompt or ""]), ctx])
        generators = row_generators([(seed, 0)])
        noise = self.initial_noise(init_noise, frames, height, width,
                                   generators)
        sched = make_sampling_schedule(self.noise_schedule, int(steps),
                                       sampler)
        x = self.denoise(sched, noise, ctx, sampler=sampler,
                         guidance=float(guidance_scale),
                         generators=generators)
        img = self._frames_out(self.decode(x), requested, (height, width),
                               (req_h, req_w))
        config = {
            "model_name": self.c.model_name,
            "family": fam.name,
            "mode": "txt2vid",
            "frames": requested,
            "steps": int(steps),
            "guidance_scale": float(guidance_scale),
            "size": [req_h, req_w],
            "compiled_size": [height, width],
            "scheduler": sampler.kind,
        }
        return img, config


def clip_image_input(image: np.ndarray, size: int) -> np.ndarray:
    """The CLIP image processor's recipe on one uint8 (H, W, 3) image:
    shortest edge to ``size`` (bicubic), centre crop, CLIP mean and std ->
    (size, size, 3) float32 (JAX :766-779)."""
    from PIL import Image

    pil = Image.fromarray(np.asarray(image, np.uint8))
    w0, h0 = pil.size
    scale = size / min(w0, h0)
    rw, rh = max(size, round(w0 * scale)), max(size, round(h0 * scale))
    resized = pil.resize((rw, rh), Image.BICUBIC)
    x0, y0 = (rw - size) // 2, (rh - size) // 2
    clip_in = np.asarray(resized.crop((x0, y0, x0 + size, y0 + size)),
                         np.float32) / 255.0
    return (clip_in - _CLIP_MEAN) / _CLIP_STD


class Img2VidPipeline(_ClipPipeline):
    """The resident SVD-class img2vid executor."""

    def __init__(self, components: VideoComponents) -> None:
        if not components.family.image_conditioned:
            raise ValueError("Img2VidPipeline requires an image-conditioned "
                             "family (svd_img2vid/tiny_svd)")
        if components.family.edm_sigma_range is None:
            raise ValueError("image-conditioned families denoise on the "
                             "EDM schedule; set edm_sigma_range")
        super().__init__(components)

    @torch.inference_mode()
    def encode_image(self, clip_in: np.ndarray, image: np.ndarray,
                     aug: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The image tower's embedding of the CLIP input (H', W', 3) as the
        (1, 1, proj) context, and the un-scaled ``encode_moments`` mean of
        the noise-augmented image (H, W, 3) in [-1, 1]: ``image + aug``,
        ``aug`` the (1, 3, H, W) augmentation already scaled."""
        dev = self.c.device
        pixels = upload(torch.from_numpy(clip_in).permute(2, 0, 1)[None]
                        .contiguous(), dev)
        emb = self.c.image_encoder(pixels)
        img = upload(torch.from_numpy(image).permute(2, 0, 1)[None]
                     .contiguous(), dev)
        mean, _ = self.c.vae.encode_moments(img + aug)
        return emb[:, None, :].float(), mean

    @torch.inference_mode()
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """The (1, F, C, h, w) clip latent -> uint8 (F, H, W, 3) on the
        device, through the temporal decoder over the whole clip."""
        return to_uint8(self.c.vae.decode(x)[0])

    def aug_draw(self, aug_noise: np.ndarray | None, seed: int, height: int,
                 width: int) -> torch.Tensor:
        """(1, 3, H, W) standard normal: the job's ``noise_aug_generator``,
        or ``aug_noise`` in JAX's layout (1, H, W, 3)."""
        if aug_noise is None:
            return randn_rows([noise_aug_generator(seed)], (3, height, width),
                              self.c.device)
        noise = np.array(aug_noise, np.float32)
        if noise.shape != (1, height, width, 3):
            raise ValueError(f"aug_noise shape {noise.shape} != "
                             f"{(1, height, width, 3)}")
        return upload(torch.from_numpy(noise).permute(0, 3, 1, 2)
                      .contiguous(), self.c.device)

    def __call__(self, image: np.ndarray, num_frames: int | None = None,
                 steps: int = 25, fps: int = 7,
                 motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02,
                 min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0,
                 height: int | None = None, width: int | None = None,
                 seed: int = 0, scheduler: str | None = None,
                 init_noise: np.ndarray | None = None,
                 aug_noise: np.ndarray | None = None
                 ) -> tuple[np.ndarray, dict]:
        """``image`` uint8 (H, W, 3). Returns (frames uint8, config)."""
        from PIL import Image

        fam = self.c.family
        dev = self.c.device
        req_h = int(height or fam.default_size)
        req_w = int(width or fam.default_size)
        height, width = bucket_image_size(req_h, req_w)
        requested, frames = _clip_frames(fam, num_frames)
        sampler = resolve(scheduler or "EulerDiscreteScheduler",
                          prediction_type=fam.prediction_type)
        use_cfg = max_guidance_scale > 1.0

        pil = Image.fromarray(np.asarray(image, np.uint8))
        cond_img = np.asarray(pil.resize((width, height), Image.LANCZOS),
                              np.float32) / 127.5 - 1.0
        clip_in = clip_image_input(np.asarray(pil),
                                   fam.vision.image_size)
        aug = self.aug_draw(aug_noise, seed, height, width) * torch.tensor(
            float(noise_aug_strength), dtype=torch.float32)
        ctx, mean = self.encode_image(clip_in, cond_img, aug)
        cond = mean[:, None].expand(1, frames, *mean.shape[1:])
        ids = upload(torch.tensor([[float(fps - 1), float(motion_bucket_id),
                                    float(noise_aug_strength)]],
                                  dtype=torch.float32), dev)
        if use_cfg:
            ctx = torch.cat([torch.zeros_like(ctx), ctx])
            cond = torch.cat([torch.zeros_like(cond), cond])
            ids = ids.expand(2, 3)
        ramp = upload(linspace32(0.0, 1.0, frames), dev)
        g_min = torch.tensor(float(min_guidance_scale), dtype=torch.float32)
        g_max = torch.tensor(float(max_guidance_scale), dtype=torch.float32)
        guidance = (g_min.to(dev) + (g_max - g_min).to(dev) * ramp).reshape(
            1, frames, 1, 1, 1)

        generators = row_generators([(seed, 0)])
        noise = self.initial_noise(init_noise, frames, height, width,
                                   generators)
        smin, smax = fam.edm_sigma_range
        sched = make_edm_schedule(smin, smax, int(steps))
        x = self.denoise(sched, noise, ctx, sampler=sampler,
                         guidance=guidance, generators=generators,
                         cond=cond, added={"time_ids": ids})
        img = self._frames_out(self.decode(x), requested, (height, width),
                               (req_h, req_w))
        config = {
            "model_name": self.c.model_name,
            "family": fam.name,
            "mode": "img2vid",
            "frames": requested,
            "steps": int(steps),
            "fps": int(fps),
            "motion_bucket_id": int(motion_bucket_id),
            "noise_aug_strength": float(noise_aug_strength),
            "guidance_scale": [float(min_guidance_scale),
                               float(max_guidance_scale)],
            "size": [req_h, req_w],
            "compiled_size": [height, width],
            "scheduler": sampler.kind,
        }
        return img, config
