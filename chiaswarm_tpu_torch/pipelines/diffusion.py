"""The txt2img diffusion pipeline, counterpart of
``chiaswarm_tpu/pipelines/diffusion.py`` (``GenerateRequest`` :163-214,
``DiffusionPipeline.submit`` :939 and the solo program ``_build_fn``
:375-618).

The JAX package traces text encode -> denoise scan -> VAE decode into one
compiled program. PyTorch runs eagerly, so here the same flow is plain
Python over modules resident on one device: the CLIP tower encodes the
prompt and (for classifier-free guidance) the negative prompt, concatenated
along the batch; the UNet runs once per step on the doubled batch inside a
Python loop under the resolved sampler; the VAE decodes; the image is
quantized to uint8 on the device ((x + 1) * 127.5 + 0.5, clipped,
truncated) and crosses to the host once. A pipeline built with a ``seq``
mesh runs that whole flow under the sequence-parallel context, so its large
self-attentions ring over the mesh's devices (``parallel/context.py``).

Noise: row b's initial (and, for the ancestral/lcm kinds, per-step) noise
comes from its own generator (core/rng.py), so an image is independent of
the batch it rides in. ``GenerateRequest.init_noise`` replaces the drawn
initial noise; it keeps the JAX package's (B|1, H/f, W/f, C) layout so one
array drives both backends.

The lane programs (``stepper_encode``, ``stepper_row_init``,
``stepper_step``, ``stepper_decode``) are the solo flow cut at its step
boundaries for the continuous-batching lanes (``serving/stepper.py``), as
the JAX package's ``stepper_*_fn`` executables are: text encode and row
noise at admission, ONE denoise step over a lane of rows at different
ladder positions, and the VAE decode of retiring rows. Each enters
inference mode and the pipeline's sequence-parallel context itself, so a
lane's own thread runs them as the solo path does.

SDXL-class families (``addition_embed_dim`` set) add the micro-conditioning
the JAX programs build (:434-448 solo, :785-800 lanes): the text encode
returns the last tower's pooled output beside the concatenated sequence
embeddings (``_make_text_encode`` :217-230), and each UNet row gets
``time_ids`` = (h, w, 0, 0, h, w) at the bucketed size, made on the device,
and ``text_embeds`` = its pooled row, the negative prompt's before the
prompt's under CFG.

img2img and inpaint (``submit``'s ``has_init``/``has_mask`` preparation,
:960-1015): the init image is resized onto the bucketed grid and encoded by
the VAE encoder with its posterior sampled (:func:`encode_init_image`, one
batch-1 encode per job, outside any sequence-parallel context, as the JAX
package runs it outside ``seq_parallel_wrap``); a per-row stack of init
images (vid2vid's frames, on the solo path) encodes each row's image alone,
its posterior from that row's stream (:meth:`encode_init_rows`); img2img
starts the ladder at :func:`img2img_start_index` from
``init + noise * sigma[start]``; inpaint
starts at 0 and, after every step, re-projects the kept region of the clean
latents (``schedulers/sampling.py::reproject_known``) with a renoise draw
from each row's generator, after that step's own noise. The lanes carry the
same row state (``stepper_step``'s ``known``/``mask``/``mask_on``).

ControlNet (``submit``'s control preparation :1034-1052, the solo body
:548-566, ``stepper_step_fn(has_control=True)`` :745-811 and
``stepper_control_embed_fn`` :888-910): the conditioning image is resized
onto the bucketed grid (LANCZOS), divided by 255 if it is uint8 or above 1,
clipped to [0, 1] and embedded by the bundle's hint encoder once per job
(:meth:`DiffusionPipeline.stepper_control_embed`, which the lanes call at
admission too); each eval runs the control branch on the UNet's batch
(the CFG batch under guidance) and the UNet takes its residuals. A lane
step's rows carry their own hint and scale.

instruct-pix2pix (an ``image_conditioned`` family; the solo body :405-470,
:527-545, ``submit`` :973-991 and its config :1195-1202): the init image is
encoded as for img2img and divided by the VAE's scaling factor (the
unscaled image latents); generation starts from pure noise at
``sigmas[0]``; every eval runs the UNet once on the tripled batch [uncond,
uncond, text] with the 8-channel input concat([x, x, x] scaled, [0, img,
img]) and combines ``e_unc + ig (e_img - e_unc) + g (e_full - e_img)`` at the
job's image guidance ``ig`` and text guidance ``g``. Such a job needs an
init image and takes no mask and no ControlNet, as in JAX; it never rides a
lane. ``GenerateRequest.tiled_decode`` decodes through
``models/vae.py::tiled_decode``.

DeepCache (JAX :75-160, the solo reuse branch :486-595, the lane program
:836-874): with ``CHIASWARM_DEEPCACHE`` on, a request's ``reuse_schedule``
(ladder indices, or ``"every:N"``) is canonicalized by
:func:`normalize_reuse_schedule`; the solo loop carries the deep activation
across steps: a full eval refreshes it (``UNet(return_deep=True)``), a
scheduled step with a valid cache replays it (``cached_deep=``) and runs
only the level-0 blocks. The config then reads ``unet_evals`` (full evals),
``steps_skipped`` and ``reuse_schedule``, and the step-collapse counters of
``obs/metrics.py`` move. Off (the default), the schedule is ignored and the
program is the plain one; the instruct-pix2pix and ControlNet programs
ignore it too, as JAX's ``submit`` does, and ``_generate`` and
``stepper_step`` refuse reuse with them in JAX's words. ``stepper_step``
takes the lane form: each row's two cache halves and one lane-wide
``reuse_now`` flag the lane decides.

Coalesced image jobs (JAX :195-201, :997-1025): with ``init_groups`` set,
``init_image`` is a per-JOB stack (J, H, W, 3) and ``mask`` a per-job
(J, H, W) stack; job j's image is encoded at batch 1 with its own seed (the
encode its solo run makes) and repeated over its ``n_rows``. Without it a
4-D ``init_image`` keeps meaning one image per ROW (vid2vid's frames).

Low-precision activations (``CHIASWARM_ACTIVATIONS=int8|fp8``,
``convert/quantize.py``): the solo program fake-quantizes the text context
once (``unet.ctx``) and the UNet input every step (``unet.in``) as JAX's
does; the lane programs do not, as in JAX. q, k and v are quantized at the
attention dispatcher on every path.

Numerics probes (``obs/numerics.py``, off unless ``CHIASWARM_NUMERICS``
names them; JAX :427, :573, :587, :598, :610): the solo program records
``diffusion.text_ctx`` (the prompt's context, before the CFG concat),
``diffusion.eps`` (the combined prediction) and ``diffusion.latents`` (the
carry after the step and any re-projection) at each step index,
``diffusion.final_latents`` and ``diffusion.image_u8``. Each program run
(the solo generate, a lane step, a decode, an encode) starts the
``attn.*`` call-site index at 0, and every step of the solo loop rewinds it
to the loop's first index, as JAX traces the loop body once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable

import numpy as np
import torch

from chiaswarm_tpu_torch.convert.quantize import (
    activations_format,
    fake_quant_activation,
)
from chiaswarm_tpu_torch.core.buckets import bucket_batch, bucket_image_size
from chiaswarm_tpu_torch.core.device import upload
from chiaswarm_tpu_torch.core.mesh import DeviceMesh
from chiaswarm_tpu_torch.core.rng import (
    posterior_row_generator,
    randn_rows,
    row_generators,
)
from chiaswarm_tpu_torch.models.vae import tiled_decode
from chiaswarm_tpu_torch.obs import numerics as _numerics
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.obs.profiling import annotate
from chiaswarm_tpu_torch.obs.metrics import (
    STEPPER_UNET_EVAL_MODES,
    steps_skipped_counter,
    unet_evals_counter,
    unet_evals_per_image_histogram,
)
from chiaswarm_tpu_torch.parallel.context import sequence_parallel
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.schedulers import (
    NOISY_KINDS,
    SamplerConfig,
    SamplerState,
    SamplingSchedule,
    ScheduleConfig,
    init_sampler_state,
    make_noise_schedule,
    make_sampling_schedule,
    reproject_known,
    reproject_known_rows,
    resolve,
    sampler_step,
    sampler_step_rows,
    scale_model_input,
    scale_model_input_rows,
)


#: the JAX package's DeepCache switch (off unless set to 1/true/on/yes)
ENV_DEEPCACHE = "CHIASWARM_DEEPCACHE"


#: the step-collapse families, seeded with zeroes (JAX :88-99)
_UNET_EVALS = unet_evals_counter()
_STEPS_SKIPPED = steps_skipped_counter()
_EVALS_PER_IMAGE = unet_evals_per_image_histogram()
for _mode in STEPPER_UNET_EVAL_MODES:
    _UNET_EVALS.inc(0, mode=_mode)
_STEPS_SKIPPED.inc(0)


def deepcache_enabled() -> bool:
    """Is DeepCache feature reuse switched on? Off by default: every
    per-job ``reuse_schedule`` is then ignored, as in JAX."""
    return os.environ.get(ENV_DEEPCACHE, "").strip().lower() in (
        "1", "true", "on", "yes")


def normalize_reuse_schedule(steps: int, schedule: Iterable[int] | str,
                             start_step: int = 0) -> tuple[int, ...]:
    """A per-job DeepCache schedule, canonical (JAX :112-160): ladder
    indices whose deep blocks replay the cache, or ``"every:N"`` (refresh
    every Nth executed step, reuse the rest). Indices must lie strictly
    inside ``(start_step, steps)``: the first executed step fills the
    cache. Returns a sorted, deduplicated tuple; a malformed schedule is a
    ``ValueError`` (the lanes turn it into ``LaneReject``, the solo path
    into a fatal bad request)."""
    if isinstance(schedule, str):
        text = schedule.strip().lower()
        if not text.startswith("every:"):
            raise ValueError(
                f"reuse_schedule string must be 'every:N', got "
                f"{schedule!r}")
        try:
            cadence = int(text.split(":", 1)[1])
        except ValueError as exc:
            raise ValueError(
                f"reuse_schedule cadence in {schedule!r} is not an "
                f"integer") from exc
        if cadence < 2:
            raise ValueError("reuse cadence must be >= 2 (1 would never "
                             "refresh the cache)")
        schedule = [i for i in range(start_step + 1, steps)
                    if (i - start_step) % cadence != 0]
    try:
        out = sorted({int(i) for i in schedule})
    except (TypeError, ValueError) as exc:
        raise ValueError(
            f"reuse_schedule must be 'every:N' or an iterable of "
            f"ladder indices, got {schedule!r}") from exc
    for i in out:
        if not start_step < i < steps:
            raise ValueError(
                f"reuse step {i} outside the executed ladder "
                f"({start_step}, {steps}) — the first executed step "
                f"must run the full UNet to fill the cache")
    return tuple(out)


def note_unet_evals(rows: int, full: int, reused: int) -> None:
    """The step-collapse counters for ``rows`` images that paid ``full``
    full evals and ``reused`` shallow ones each."""
    _UNET_EVALS.inc(rows * full, mode="full")
    if reused:
        _UNET_EVALS.inc(rows * reused, mode="reuse")
        _STEPS_SKIPPED.inc(rows * reused)
    for _ in range(rows):
        _EVALS_PER_IMAGE.observe(full)


@dataclasses.dataclass(frozen=True)
class GenerateRequest:
    """One generation request (pre-normalized by the node dispatcher).
    The fields are the JAX package's; see the module docstring for which
    of them this slice serves."""

    prompt: str | tuple[str, ...]
    negative_prompt: str | tuple[str, ...] = ""
    steps: int = 30
    guidance_scale: float = 7.5
    height: int = 512
    width: int = 512
    batch: int = 1
    seed: int = 0
    scheduler: str | None = None  # diffusers class name from the hive
    # per-row (seed, row-index) pairs, length == batch (coalesced jobs)
    sample_seed_rows: tuple[tuple[int, int], ...] | None = None
    # explicit standard-normal initial noise, (B|1, H/f, W/f, C)
    init_noise: np.ndarray | None = None
    # (H, W, 3) for the job, or (n, H, W, 3): one per row (vid2vid frames),
    # or with ``init_groups`` one per coalesced job
    init_image: np.ndarray | None = None
    strength: float = 0.8
    mask: np.ndarray | None = None
    # coalesced img2img/inpaint: init_groups[j] = (encode seed, n_rows) of
    # job j; ``init_image`` (J, H, W, 3) and ``mask`` (J, H, W) are per job
    init_groups: tuple[tuple[int, int], ...] | None = None
    tiled_decode: bool = False
    controlnet: Any = None
    control_image: np.ndarray | None = None
    control_scale: float = 1.0
    image_guidance_scale: float = 1.5
    reuse_schedule: tuple[int, ...] | str | None = None


def img2img_start_index(steps: int, strength: float) -> int:
    """img2img strength -> denoise start index, the one quantization (clip
    to [0.05, 1], round, never past the last step), shared by the solo path,
    the lanes and the envelope's ``denoise_steps``."""
    strength = float(np.clip(strength, 0.05, 1.0))
    return min(int(round(steps * (1.0 - strength))), steps - 1)


def image_plan(steps: int, strength: float, has_init: bool,
               has_mask: bool, image_conditioned: bool = False
               ) -> tuple[str, int]:
    """A job's mode and denoise start index: ``inpaint`` (a mask, which
    needs an init image) starts at 0 and re-projects the kept region every
    step; ``img2img`` skips the first (1 - strength) of the ladder;
    ``txt2img`` starts at 0; on an ``image_conditioned`` family the job is
    ``pix2pix`` (an init image, no mask), from pure noise at 0. The one
    derivation for the solo path, the lanes and the lane envelope."""
    if has_mask and not has_init:
        raise ValueError("inpainting requires an init image with the mask")
    if image_conditioned:
        if not has_init:
            raise ValueError("this model edits an input image; "
                             "start_image_uri is required")
        if has_mask:
            raise ValueError("instruct-pix2pix models do not take a mask")
        return "pix2pix", 0
    if has_mask:
        return "inpaint", 0
    if has_init:
        return "img2img", img2img_start_index(steps, strength)
    return "txt2img", 0


def latent_mask(mask: np.ndarray, lh: int, lw: int,
                downscale: int) -> np.ndarray:
    """Inpaint mask of any size -> binarized (lh, lw) latent-grid mask (1 =
    regenerate): PIL NEAREST onto the bucketed pixel grid, box mean to the
    latent grid, ``> 0.5``. Shared by the solo path and lane admission."""
    mask = np.asarray(mask, dtype=np.float32)
    if mask.shape != (lh, lw):
        if mask.shape != (lh * downscale, lw * downscale):
            from PIL import Image

            mask = np.asarray(Image.fromarray(
                (mask * 255).clip(0, 255).astype(np.uint8)
            ).resize((lw * downscale, lh * downscale), Image.NEAREST),
                dtype=np.float32) / 255.0
        mask = mask.reshape(lh, downscale, lw, downscale).mean((1, 3))
    return (mask > 0.5).astype(np.float32)


def _to_float_image(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 127.5 - 1.0
    return img.astype(np.float32)


def _resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Host-side LANCZOS resize of one (H, W, 3) image onto the bucketed
    grid, uint8 or float in [-1, 1] (the JAX package's ``_resize_batch`` on
    one frame)."""
    from PIL import Image

    if img.dtype == np.uint8:
        return np.asarray(Image.fromarray(img).resize((width, height),
                                                      Image.LANCZOS))
    frame = ((img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    resized = np.asarray(Image.fromarray(frame).resize((width, height),
                                                       Image.LANCZOS))
    return resized.astype(np.float32) / 127.5 - 1.0


def _check_request(req: GenerateRequest, components: Components) -> None:
    """JAX's refusals, in its order."""
    image_plan(1, req.strength, req.init_image is not None,
               req.mask is not None, components.family.image_conditioned)
    if req.controlnet is not None:
        if components.family.image_conditioned:
            raise ValueError(
                "instruct-pix2pix models do not support controlnet")
        if req.control_image is None:
            raise ValueError("controlnet requires a conditioning image")


def reuse_plan(req: GenerateRequest, components: Components, steps: int,
               start: int) -> tuple[int, ...]:
    """The solo program's DeepCache schedule (JAX :1091-1098): the
    request's, canonical, only with DeepCache on and never for the
    instruct-pix2pix or ControlNet programs; () otherwise."""
    if req.reuse_schedule and deepcache_enabled() \
            and not components.family.image_conditioned \
            and req.controlnet is None:
        return normalize_reuse_schedule(steps, req.reuse_schedule, start)
    return ()


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """Decoded images (B, 3, H, W) in [-1, 1] -> uint8 (B, H, W, 3) on
    their device: (x + 1) * 127.5 + 0.5, clipped, truncated."""
    img = torch.clamp((img + 1.0) * 127.5 + 0.5, 0.0, 255.0).to(torch.uint8)
    return img.permute(0, 2, 3, 1)


@dataclasses.dataclass
class PendingImages:
    """A generation's uint8 output, on the device (or, from a lane, already
    copied to host memory). ``wait()`` brings it to the host and un-buckets
    back to the exact requested size."""

    device_images: torch.Tensor   # (B, H, W, 3) uint8
    compiled_hw: tuple[int, int]
    requested_hw: tuple[int, int]
    requested_batch: int

    def wait(self) -> np.ndarray:
        with obs_trace.span("decode", batch=self.requested_batch):
            img_u8 = self.device_images.cpu().numpy()
        height, width = self.compiled_hw
        req_h, req_w = self.requested_hw
        if (height, width) != (req_h, req_w):
            # scale-to-cover + center-crop back to the exact request
            from PIL import Image

            scale = max(req_h / height, req_w / width)
            rh, rw = (max(req_h, round(height * scale)),
                      max(req_w, round(width * scale)))
            y0, x0 = (rh - req_h) // 2, (rw - req_w) // 2
            img_u8 = np.stack([
                np.asarray(Image.fromarray(frame).resize(
                    (rw, rh), Image.LANCZOS))[y0:y0 + req_h, x0:x0 + req_w]
                for frame in img_u8
            ])
        return img_u8[: self.requested_batch]


class DiffusionPipeline:
    """Resident txt2img executor for one Components bundle. With a ``mesh``
    whose ``seq`` axis is above 1, the whole generate call (encode, denoise
    loop, VAE decode, uint8) runs under ``parallel.context.
    sequence_parallel``, so every large self-attention, the VAE mid block's
    included, rings over the mesh (the JAX solo program's
    ``seq_parallel_wrap``, ``pipelines/diffusion.py:615-618``), SDXL's
    as SD1.x's: its pooled text and time ids are row state and do not
    ring; a mesh that rings beside another axis above 1 raises there."""

    def __init__(self, components: Components,
                 mesh: DeviceMesh | None = None) -> None:
        self.c = components
        self.mesh = mesh
        fam = components.family
        self.schedule_config = ScheduleConfig(
            beta_schedule=fam.beta_schedule,
            prediction_type=fam.prediction_type,
        )
        self.noise_schedule = make_noise_schedule(self.schedule_config)

    def _tokenize(self, prompts: list[str]) -> list[torch.Tensor]:
        return [upload(torch.from_numpy(tok.encode_batch(prompts)),
                       self.c.device)
                for tok in self.c.tokenizers]

    def _encode_text(self, ids: list[torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(sequence embeddings, pooled): the towers' sequences concatenated
        along the feature axis, the pooled output of the last tower (SDXL's
        pooled text comes from its second, projected tower)."""
        seqs, pooled = [], None
        for te, i in zip(self.c.text_encoders, ids):
            seq, pooled = te(i)
            seqs.append(seq)
        return (torch.cat(seqs, dim=-1) if len(seqs) > 1 else seqs[0]), pooled

    def _added_cond(self, pooled: list[torch.Tensor], height: int,
                    width: int) -> dict[str, torch.Tensor] | None:
        """SDXL's ``added_cond`` at the bucketed (height, width), or None for
        a family without it: ``text_embeds`` the UNet rows' pooled text
        (``pooled`` concatenated: under CFG the negative prompt's rows
        before the prompt's) cut to ``addition_pooled_dim``, ``time_ids``
        (0, 0 crop, float32) made on the device, one row each."""
        unet_cfg = self.c.family.unet
        if unet_cfg.addition_embed_dim is None:
            return None
        text_embeds = torch.cat(pooled, dim=0) if len(pooled) > 1 else pooled[0]
        ids = torch.tensor([height, width, 0, 0, height, width],
                           dtype=torch.float32)
        time_ids = upload(ids, self.c.device).expand(text_embeds.shape[0], 6)
        return {"time_ids": time_ids,
                "text_embeds": text_embeds[:, :unet_cfg.addition_pooled_dim]}

    def _latent_hw(self, height: int, width: int) -> tuple[int, int]:
        f = self.c.family.vae.downscale
        return height // f, width // f

    def _initial_noise(self, req: GenerateRequest, batch: int, lh: int,
                       lw: int, generators: list[torch.Generator]) -> torch.Tensor:
        channels = self.c.family.vae.latent_channels
        if req.init_noise is None:
            return randn_rows(generators, (channels, lh, lw), self.c.device)
        noise = np.asarray(req.init_noise, np.float32)
        if noise.ndim == 3:
            noise = noise[None]
        if noise.shape[1:] != (lh, lw, channels):
            raise ValueError(f"init_noise shape {noise.shape[1:]} != latent "
                             f"grid {(lh, lw, channels)}")
        if noise.shape[0] > batch:
            raise ValueError(f"init_noise carries {noise.shape[0]} rows but the "
                             f"request buckets to batch {batch}")
        if noise.shape[0] < batch:
            pad = np.repeat(noise[-1:], batch - noise.shape[0], axis=0)
            noise = np.concatenate([noise, pad], axis=0)
        return torch.from_numpy(noise).permute(0, 3, 1, 2).contiguous().to(
            self.c.device)

    @torch.inference_mode()
    def _generate(self, *, batch: int, steps: int, sampler: SamplerConfig,
                  use_cfg: bool, guidance: float,
                  ids: list[torch.Tensor], neg_ids: list[torch.Tensor],
                  noise: torch.Tensor, generators: list[torch.Generator],
                  height: int, width: int, start: int = 0,
                  init_latent: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None,
                  control: Any = None, hint: torch.Tensor | None = None,
                  control_scale: float = 1.0,
                  image_cond: torch.Tensor | None = None,
                  image_guidance: float = 1.5,
                  tiled: bool = False,
                  reuse: tuple[int, ...] = ()) -> torch.Tensor:
        """Encode -> denoise loop -> decode -> uint8 (B, H, W, 3) on device.
        With ``init_latent`` the loop starts at ladder index ``start`` from
        ``init_latent + noise * sigma[start]``; with ``mask`` ((B, 1, h, w),
        1 = regenerate, broadcast over channels) every step re-projects the kept
        region of ``init_latent`` with a renoise draw per row, after the
        step's own noise. With ``control`` (a ``ControlNetBundle``) each eval
        runs its branch on the UNet's batch with the job's ``hint`` (1, C0,
        h, w) and feeds the residuals, times ``control_scale``, to the
        UNet. With ``image_cond`` (the scaled init latents, (B, C, h, w); an
        instruct-pix2pix family) each eval runs the tripled batch and the
        dual-guidance combine at ``image_guidance``. ``tiled`` decodes
        through ``tiled_decode``. ``reuse`` (a canonical DeepCache
        schedule) replays the deep activation at those steps once a full
        eval has filled it."""
        sched = make_sampling_schedule(self.noise_schedule, steps, sampler)
        timesteps = sched.timesteps.to(self.c.device)
        unet = self.c.unet
        if reuse and (image_cond is not None or control is not None):
            # dual guidance and the ControlNet trunk both feed the deep
            # blocks every step
            raise ValueError("DeepCache reuse supports the plain "
                             "txt2img/img2img/inpaint programs only")
        act = activations_format()
        attn_taps = _numerics.begin_program()

        ctx, pooled = self._encode_text(ids)
        ctx = _numerics.tap("diffusion.text_ctx", ctx)
        pooled_rows = [pooled]
        pix2pix = image_cond is not None
        if pix2pix:
            # dual guidance rides a tripled batch: [uncond, image only,
            # text and image]
            nctx, npooled = self._encode_text(neg_ids)
            ctx = torch.cat([nctx, nctx, ctx], dim=0)
            pooled_rows = [npooled, npooled, pooled]
            # unscaled image latents on the channels, zeros for uncond
            img = image_cond / self.c.family.vae.scaling_factor
            img3 = torch.cat([torch.zeros_like(img), img, img], dim=0)
        elif use_cfg:
            nctx, npooled = self._encode_text(neg_ids)
            ctx = torch.cat([nctx, ctx], dim=0)
            pooled_rows = [npooled, pooled]
        ctx = fake_quant_activation(ctx, act, tag="unet.ctx")  # once

        x = noise * sched.sigmas[start]
        if init_latent is not None:
            x = init_latent + x
        state = init_sampler_state(x)
        rows = (3 if pix2pix else 2 if use_cfg else 1) * batch
        added = self._added_cond(pooled_rows, height, width)
        if control is not None:
            hint = hint.expand(rows, -1, -1, -1)
        cache = None  # DeepCache: the deep activation of the last full eval
        loop_seq = _numerics.TAPS.peek_trace_seq("attn") if attn_taps else 0
        for i in range(start, steps):
            if attn_taps:
                _numerics.TAPS.rewind_trace_seq("attn", loop_seq)
            # "unet.in": every branch's batch derives from this tensor
            inp = fake_quant_activation(scale_model_input(sched, x, i), act,
                                        tag="unet.in")
            t = timesteps[i].expand(rows)
            if pix2pix:
                inp_b = torch.cat([torch.cat([inp, inp, inp], dim=0), img3],
                                  dim=1)
            else:
                inp_b = torch.cat([inp, inp], dim=0) if use_cfg else inp
            down = mid = None
            if control is not None:
                down, mid = control.net(inp_b, t, ctx, hint, added,
                                        control_scale)
            if not reuse:
                out = unet(inp_b, t, ctx, added, down, mid)
            elif i in reuse and cache is not None:
                out = unet(inp_b, t, ctx, added, cached_deep=cache)
            else:
                out, cache = unet(inp_b, t, ctx, added, return_deep=True)
            if pix2pix:
                e_unc, e_img, e_full = out.chunk(3, dim=0)
                eps = (e_unc + image_guidance * (e_img - e_unc)
                       + guidance * (e_full - e_img))
            elif use_cfg:
                eps_u, eps_c = out.chunk(2, dim=0)
                eps = eps_u + guidance * (eps_c - eps_u)
            else:
                eps = out
            eps = _numerics.tap("diffusion.eps", eps, step=i)
            step_noise = (randn_rows(generators, tuple(x.shape[1:]),
                                     self.c.device)
                          if sampler.kind in NOISY_KINDS else None)
            x, state = sampler_step(sampler, sched, i, x, eps, state,
                                    noise=step_noise, start_index=start)
            if mask is not None:
                renoise = randn_rows(generators, tuple(x.shape[1:]),
                                     self.c.device)
                x = reproject_known(sched, i, x, init_latent, mask, renoise)
            x = _numerics.tap("diffusion.latents", x, step=i)
        x = _numerics.tap("diffusion.final_latents", x)
        images = self._decode_uint8(x, tiled=True) if tiled else \
            self._decode_uint8(x)
        return _numerics.tap("diffusion.image_u8", images)

    def encode_init_image(self, image: np.ndarray, height: int, width: int,
                          seed: int, row: int = 0) -> torch.Tensor:
        """One job's init image (H, W, 3), uint8 or float in [-1, 1], at the
        bucketed size -> its scaled latents (1, C, H/f, W/f) float32 on the
        device, the posterior sampled with the job's own
        ``core/rng.py::posterior_generator`` (row ``row``'s
        ``posterior_row_generator`` for a per-row init stack). Always a
        batch-1 encode (the solo path and the lanes call this one function,
        so a job's latents do not depend on where it runs), and never under
        a sequence-parallel context: the encoder's attention stays local, as
        the JAX package runs its encode outside ``seq_parallel_wrap``."""
        img = _to_float_image(image)
        if img.shape != (height, width, 3):
            raise ValueError(f"init image {img.shape} != requested "
                             f"{(height, width, 3)}; resize on the host first")
        lh, lw = self._latent_hw(height, width)
        channels = self.c.family.vae.latent_channels
        x = upload(torch.from_numpy(img).permute(2, 0, 1)[None].contiguous(),
                   self.c.device)
        noise = randn_rows([posterior_row_generator(seed, row)],
                           (channels, lh, lw), self.c.device)
        _numerics.begin_program()
        with torch.inference_mode(), sequence_parallel(None):
            return self.c.vae.encode(x, noise)

    def prepare_image_rows(self, init_image: Any, mask: Any,
                           strength: float, steps: int, height: int,
                           width: int, seed: int, rows: int,
                           init_groups: tuple[tuple[int, int], ...] | None
                           = None
                           ) -> tuple[str, int, torch.Tensor | None,
                                      torch.Tensor | None]:
        """One job's image inputs for ``rows`` rows at the bucketed size:
        ``(mode, start, init_latent, mask)`` with :func:`image_plan`'s mode
        and start, the init image resized on the host and encoded once
        (:meth:`encode_init_image`) and expanded to (rows, C, h, w), and the
        mask quantized by :func:`latent_mask` and expanded to
        (rows, 1, h, w). The solo path and lane admission both call this,
        so a job's rows do not depend on where it runs. With
        ``init_groups`` the image and mask are per-job stacks of coalesced
        jobs (:meth:`_group_rows`)."""
        mode, start = image_plan(steps, strength, init_image is not None,
                                 mask is not None,
                                 self.c.family.image_conditioned)
        if init_groups is not None and init_image is not None:
            return (mode, start, *self._group_rows(
                init_image, mask, init_groups, height, width, rows))
        init_latent = mask_rows = None
        if init_image is not None:
            init = np.asarray(init_image)
            if init.ndim == 4:
                init_latent = self.encode_init_rows(init, height, width,
                                                    seed, rows)
            else:
                if init.shape[:2] != (height, width):
                    init = _resize_image(init, height, width)
                init_latent = self.encode_init_image(
                    init, height, width, seed).expand(rows, -1, -1, -1)
        if mask is not None:
            lh, lw = self._latent_hw(height, width)
            m = latent_mask(np.asarray(mask, np.float32), lh, lw,
                            self.c.family.vae.downscale)
            mask_rows = upload(torch.from_numpy(m)[None, None],
                               self.c.device).expand(rows, 1, lh, lw)
        return mode, start, init_latent, mask_rows

    def _group_rows(self, images: Any, masks: Any,
                    groups: tuple[tuple[int, int], ...], height: int,
                    width: int, rows: int
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Coalesced jobs' per-job stacks -> per-row (rows, C, h, w) init
        latents and (rows, 1, h, w) masks (or None): job j's image encoded
        at batch 1 with its own seed, as its solo run encodes it, and its
        mask quantized, each repeated over its rows; the bucket is padded
        with the last row (JAX :997-1025)."""
        images = np.asarray(images)
        if len(images) != len(groups):
            raise ValueError(f"{len(images)} init images for "
                             f"{len(groups)} coalesced jobs")
        latents = []
        for frame, (enc_seed, n_rows) in zip(images, groups):
            if frame.shape[:2] != (height, width):
                frame = _resize_image(frame, height, width)
            latents.append(self.encode_init_image(
                frame, height, width, int(enc_seed)).expand(
                    int(n_rows), -1, -1, -1))
        init = torch.cat(latents, dim=0)
        init = torch.cat([init, init[-1:].expand(
            (rows - init.shape[0],) + tuple(init.shape[1:]))])
        if masks is None:
            return init, None
        lh, lw = self._latent_hw(height, width)
        f = self.c.family.vae.downscale
        m = np.concatenate([
            np.repeat(latent_mask(np.asarray(mj, np.float32), lh, lw, f)[None],
                      int(n_rows), axis=0)
            for mj, (_, n_rows) in zip(np.asarray(masks), groups)])
        m = np.concatenate([m, np.repeat(m[-1:], rows - len(m), axis=0)])
        return init, upload(torch.from_numpy(m)[:, None].contiguous(),
                            self.c.device)

    def encode_init_rows(self, frames: np.ndarray, height: int, width: int,
                         seed: int, rows: int) -> torch.Tensor:
        """A per-row init stack (n, H, W, 3), one image per row (vid2vid's
        frames, JAX ``encode_init_image`` on (B, H, W, 3)) -> (rows, C, h, w):
        each frame resized onto the bucketed grid and encoded alone, its
        posterior drawn from its own row's stream; a bucketed batch is
        padded with the last frame's latent, as in JAX. A one-frame stack
        gives what a one-image job gives."""
        if len(frames) > rows:
            raise ValueError(f"{len(frames)} init images for a batch of "
                             f"{rows}")
        latents = []
        for row, frame in enumerate(frames):
            if frame.shape[:2] != (height, width):
                frame = _resize_image(frame, height, width)
            latents.append(self.encode_init_image(frame, height, width, seed,
                                                  row=row))
        latents += [latents[-1]] * (rows - len(latents))
        return torch.cat(latents, dim=0)

    def stepper_control_embed(self, controlnet: Any, control_image: Any,
                              height: int, width: int) -> torch.Tensor:
        """A job's conditioning image (H, W, 3) -> its hint embedding
        (1, C0, h, w) on the bundle's device, once per job, for the solo
        path and lane admission alike: resized onto the bucketed grid
        (LANCZOS) when its size differs, divided by 255 if it is uint8 or
        its max exceeds 1, clipped to [0, 1] (the hint encoder's range,
        not the VAE's [-1, 1])."""
        if control_image is None:
            raise ValueError("controlnet requires a conditioning image")
        cond = np.asarray(control_image)
        as_u8 = cond.dtype == np.uint8
        if cond.shape[:2] != (height, width):
            cond = _resize_image(cond, height, width)
        cond = np.asarray(cond, np.float32)
        if as_u8 or cond.max() > 1.0:
            cond = cond / 255.0
        cond = np.clip(cond, 0.0, 1.0)
        x = upload(torch.from_numpy(cond).permute(2, 0, 1)[None].contiguous(),
                   controlnet.device)
        with torch.inference_mode():
            return controlnet.embed(x)

    def _decode_uint8(self, x: torch.Tensor,
                      tiled: bool = False) -> torch.Tensor:
        return to_uint8(tiled_decode(self.c.vae, x) if tiled
                        else self.c.vae.decode(x))

    # ---------- lane programs (serving/stepper.py) ----------

    def stepper_encode(self, ids: list[torch.Tensor],
                       neg_ids: list[torch.Tensor]
                       ) -> tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
        """(ctx_u, ctx_c, pooled_u, pooled_c) for a job's rows: the solo
        path's text encode, the negative prompt's (uncond) and the prompt's
        (cond) apart."""
        with torch.inference_mode(), sequence_parallel(self.mesh):
            ctx_c, pooled_c = self._encode_text(ids)
            ctx_u, pooled_u = self._encode_text(neg_ids)
            return ctx_u, ctx_c, pooled_u, pooled_c

    def stepper_row_init(self, generators: list[torch.Generator],
                         sigma0: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
        """A fresh row's initial latents: row b's noise from its own
        generator, scaled by the ladder's ``sigma[start]``, as the solo
        prologue draws it. The generators then carry on as the rows'
        per-step noise sources (the JAX carry keys' counterpart)."""
        lh, lw = self._latent_hw(height, width)
        with torch.inference_mode():
            return randn_rows(generators,
                              (self.c.family.vae.latent_channels, lh, lw),
                              self.c.device) * sigma0

    def stepper_step(self, *, sampler: SamplerConfig, ctx_u: torch.Tensor,
                     ctx_c: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                     start_idx: torch.Tensor, sigmas: torch.Tensor,
                     timesteps: torch.Tensor, guidance: torch.Tensor,
                     old_denoised: torch.Tensor, active: torch.Tensor,
                     generators: list[torch.Generator | None],
                     pooled_u: torch.Tensor | None = None,
                     pooled_c: torch.Tensor | None = None,
                     known: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None,
                     mask_on: torch.Tensor | None = None,
                     renoise_generators: list[torch.Generator | None]
                     | None = None, control: Any = None,
                     cond: torch.Tensor | None = None,
                     cscale: torch.Tensor | None = None,
                     cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                     reuse_now: bool = False) -> tuple:
        """ONE denoise step over a lane of W rows -> (x, idx, old_denoised).

        Per row: latents ``x`` (W, C, h, w), step and start index (W,), its
        sigma (W, S+1) and timestep (W, S) ladders padded to the lane's step
        capacity, guidance (W,) float32, multistep history and an active
        flag; the pooled text rows ``pooled_u``/``pooled_c`` (W, P), which an
        SDXL-class UNet reads beside ``time_ids`` at the latents' size (other
        families ignore them and may pass None). One UNet
        call on 2W rows (uncond rows, then cond) with a (2W,)
        timestep vector; the per-row CFG combine keeps the solo path's
        dtype (the guidance rounded to the UNet's type, as a Python float
        is) and takes the conditional prediction alone where guidance is at
        most 1. Only the noisy kinds draw per-step noise, and only from the
        generators of active rows (``generators[b]`` is None elsewhere).
        Inpaint rows (``mask_on``) re-project their clean latents ``known``
        (W, C, h, w) where their ``mask`` (W, 1, h, w) is 0, with a renoise
        draw from ``renoise_generators[b]`` after the step noise; the other
        rows draw nothing more and keep the plain step's value. Without
        ``renoise_generators`` no row re-projects. A control lane passes its
        ``ControlNetBundle`` as ``control`` with each row's hint embedding
        ``cond`` (W, C0, h, w) and scale ``cscale`` (W,) float32: the branch
        runs on the 2W rows, each row's residuals times its own scale.
        Inactive rows compute and are discarded: x, history and index keep
        their values.

        A DeepCache lane passes each row's cached deep activations as
        ``cache`` = (uncond halves, cond halves), (W, C1, h, w) each, and the
        lane-wide ``reuse_now`` its thread decided: True replays them
        (``cached_deep``), False runs the full UNet and refreshes them. It
        gets ``(x, idx, old_denoised, cache)`` back (JAX :836-874)."""
        if cache is not None and control is not None:
            raise ValueError("DeepCache reuse lanes do not take the "
                             "ControlNet branch")
        _numerics.begin_program()
        with torch.inference_mode(), sequence_parallel(self.mesh):
            rows = SamplingSchedule(sigmas=sigmas, timesteps=timesteps)
            inp = scale_model_input_rows(rows, x, idx)
            last = timesteps.shape[1] - 1
            t = timesteps.gather(1, idx.clamp(0, last)[:, None].long())[:, 0]
            f = self.c.family.vae.downscale
            added = self._added_cond([pooled_u, pooled_c], x.shape[2] * f,
                                     x.shape[3] * f)
            inp2 = torch.cat([inp, inp], dim=0)
            t2 = torch.cat([t, t], dim=0)
            ctx = torch.cat([ctx_u, ctx_c], dim=0)
            down = mid = None
            if control is not None:
                down, mid = control.net(
                    inp2, t2, ctx, torch.cat([cond, cond], dim=0), added,
                    torch.cat([cscale, cscale]).reshape(-1, 1, 1, 1))
            if cache is None:
                out = self.c.unet(inp2, t2, ctx, added, down, mid)
            elif reuse_now:
                out = self.c.unet(inp2, t2, ctx, added,
                                  cached_deep=torch.cat(cache, dim=0))
            else:
                out, deep = self.c.unet(inp2, t2, ctx, added,
                                        return_deep=True)
                cache = tuple(deep.chunk(2, dim=0))
            eps_u, eps_c = out.chunk(2, dim=0)
            g = guidance.reshape(-1, 1, 1, 1)
            eps = torch.where(g > 1.0,
                              eps_u + g.to(eps_u.dtype) * (eps_c - eps_u),
                              eps_c)
            noise = None
            if sampler.kind in NOISY_KINDS:
                noise = self._row_noise(generators, tuple(x.shape[1:]))
            x_next, state = sampler_step_rows(
                sampler, rows, idx, x, eps,
                SamplerState(old_denoised=old_denoised), noise, start_idx)
            if renoise_generators is not None:
                renoise = self._row_noise(renoise_generators,
                                          tuple(x.shape[1:]))
                x_masked = reproject_known_rows(rows, idx, x_next, known,
                                                mask, renoise)
                x_next = torch.where(mask_on.reshape(-1, 1, 1, 1), x_masked,
                                     x_next)
            act = active.reshape(-1, 1, 1, 1)
            x_next = torch.where(act, x_next, x)
            old_next = torch.where(act, state.old_denoised, old_denoised)
            if cache is not None:
                return x_next, idx + active.to(idx.dtype), old_next, cache
            return x_next, idx + active.to(idx.dtype), old_next

    def _row_noise(self, generators: list[torch.Generator | None],
                   shape: tuple[int, ...]) -> torch.Tensor:
        """(W, *shape) standard-normal: row b from ``generators[b]``, zeros
        where it is None; drawn on the CPU."""
        noise = torch.zeros((len(generators),) + shape)
        drawn = [b for b, g in enumerate(generators) if g is not None]
        if drawn:
            noise[drawn] = randn_rows([generators[b] for b in drawn], shape)
        return upload(noise, self.c.device)

    def stepper_decode(self, x: torch.Tensor) -> torch.Tensor:
        """Latents of retiring rows -> uint8 (B, H, W, 3) on the device, the
        solo path's tail."""
        _numerics.begin_program()
        with torch.inference_mode(), sequence_parallel(self.mesh):
            return self._decode_uint8(x)

    def __call__(self, req: GenerateRequest) -> tuple[np.ndarray, dict]:
        """Run a request. Returns (images uint8 (B, H, W, 3), config dict)."""
        pending, config = self.submit(req)
        return pending.wait(), config

    def submit(self, req: GenerateRequest) -> tuple[PendingImages, dict]:
        """Run a request on the device, leaving the uint8 images there
        until ``PendingImages.wait()``."""
        fam = self.c.family
        _check_request(req, self.c)
        height, width = bucket_image_size(req.height, req.width)
        batch = bucket_batch(req.batch)
        steps = max(int(req.steps), 1)
        sampler = resolve(req.scheduler, prediction_type=fam.prediction_type)
        use_cfg = req.guidance_scale > 1.0
        lh, lw = self._latent_hw(height, width)
        mode, start, init_latent, mask = self.prepare_image_rows(
            req.init_image, req.mask, req.strength, steps, height, width,
            req.seed, batch, req.init_groups)
        reuse = reuse_plan(req, self.c, steps, start)
        hint = None
        if req.controlnet is not None:
            hint = self.stepper_control_embed(req.controlnet,
                                              req.control_image, height, width)

        def rows(value: str | tuple[str, ...]) -> list[str]:
            vals = (list(value) if isinstance(value, (tuple, list))
                    else [value or ""] * req.batch)
            if len(vals) != req.batch:
                raise ValueError(
                    f"{len(vals)} per-row prompts for batch {req.batch}")
            # pad to the bucket by repeating the last row
            return vals + [vals[-1]] * (batch - len(vals))

        ids = self._tokenize(rows(req.prompt))
        neg = self._tokenize(rows(req.negative_prompt))

        # one independent generator per row: row b is reproducible at any
        # batch size
        pairs = (list(req.sample_seed_rows) if req.sample_seed_rows
                 else [(req.seed, i) for i in range(req.batch)])
        if len(pairs) != req.batch:
            raise ValueError(f"{len(pairs)} sample_seed_rows for batch "
                             f"{req.batch}")
        pairs += [pairs[-1]] * (batch - len(pairs))  # bucket padding
        generators = row_generators(pairs)
        noise = self._initial_noise(req, batch, lh, lw, generators)

        image_cond = None
        if mode == "pix2pix":
            image_cond, init_latent = init_latent, None
        with sequence_parallel(self.mesh), annotate("swarm.generate"):
            images = self._generate(
                batch=batch, steps=steps, sampler=sampler, use_cfg=use_cfg,
                guidance=float(req.guidance_scale), ids=ids, neg_ids=neg,
                noise=noise, generators=generators, height=height,
                width=width, start=start, init_latent=init_latent, mask=mask,
                control=req.controlnet, hint=hint,
                control_scale=float(req.control_scale),
                image_cond=image_cond,
                image_guidance=float(req.image_guidance_scale),
                tiled=req.tiled_decode, reuse=reuse)
        # step-collapse accounting: the full evals each image paid
        full_evals = (steps - start) - len(reuse)
        note_unet_evals(req.batch, full_evals, len(reuse))
        config = {
            "model_name": self.c.model_name,
            "family": fam.name,
            "scheduler": sampler.kind,
            "steps": steps,
            # the ladder actually executed: img2img's strength maps to a
            # start index, an observable contract
            "denoise_steps": steps - start,
            "unet_evals": full_evals,
            "steps_skipped": len(reuse),
            "guidance_scale": float(req.guidance_scale),
            "size": [req.height, req.width],
            "compiled_size": [height, width],
            "batch": batch,
            "mode": mode,
        }
        if reuse:
            config["reuse_schedule"] = list(reuse)
        if mode == "pix2pix":
            config["image_guidance_scale"] = float(req.image_guidance_scale)
        if req.controlnet is not None:
            config["controlnet"] = req.controlnet.model_name
            config["controlnet_scale"] = float(req.control_scale)
        return PendingImages(images, (height, width), (req.height, req.width),
                             req.batch), config


def set_attn_impl(unet: torch.nn.Module, attn_impl: str) -> None:
    """Force the spatial self-attention dispatch of every transformer block
    of a built UNet (the JAX package rebuilds its UNet with the replaced
    config); the parity tests and the chip check drive both routes. The
    video UNets' frame attentions (``pinned``) stay on the plain path, as
    JAX pins them."""
    from chiaswarm_tpu_torch.models.unet import TransformerBlock

    unet.config = dataclasses.replace(unet.config, attn_impl=attn_impl)
    for module in unet.modules():
        if isinstance(module, TransformerBlock) and not module.pinned:
            module.attn1.attn_impl = attn_impl
