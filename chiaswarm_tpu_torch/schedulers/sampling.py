"""Sigma-space samplers, counterpart of ``chiaswarm_tpu/schedulers/sampling.py``.

Every sampler works on latents in k-diffusion coordinates
``x = x0 + sigma * eps`` over a precomputed sigma ladder: Euler, DDIM (the
Euler step on discrete-timestep sigmas), Heun's Euler predictor,
Euler-ancestral, LCM and DPM-Solver++(2M). ``SAMPLERS``/``resolve`` map the
diffusers class names the hive sends exactly as the JAX package does,
remaps included. The solo step index is a Python int (the denoise loop is
a Python loop); per-step scalars are float32 tensors, as in the reference.
The ladder lives on the host, but the solo step does its arithmetic on the
sample's device, as the per-row step does: the scalars it reads go to the
sample's device first (``core/device.py::upload``, without waiting on the
device's queue), and only its branch decisions read the host ladder. On a
card the two would otherwise part in the last bit (CUDA divides by a host
scalar as a product with its reciprocal, and its ``log``/``expm1`` are not
the host's), which the bf16 UNet grows to several uint8 levels over a
job's steps.

The per-row ``*_rows`` variants serve the continuous-batching lanes
(``serving/stepper.py``): each row of a lane carries its own sigma and
timestep ladder, step index and start index, so rows at different ladder
positions, with different step counts, share one batched step. The JAX
package ``vmap``s its scalar step; here the step is written once over the
rows, its Python branches turned into ``torch.where`` masks over the same
expressions in the same order, so each row computes its solo step.

Inpainting re-projects the kept region after each step
(:func:`reproject_known`, per row :func:`reproject_known_rows`), as the
JAX package's legacy inpaint does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from chiaswarm_tpu_torch.core.device import upload
from chiaswarm_tpu_torch.schedulers.common import (
    NoiseSchedule,
    denoised_from_model_output,
    interp,
    karras_sigmas,
    linspace32,
    sigma_to_timestep,
)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler selection."""

    kind: str = "dpmpp_2m"  # "euler" | "ddim" | "euler_ancestral" | "dpmpp_2m" | "heun" | "lcm"
    use_karras_sigmas: bool = True
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"
    steps_offset: int = 1
    prediction_type: str = "epsilon"


#: sampler kinds whose contract is the few-step regime (guidance embedded by
#: distillation, guidance <= 1 their native mode): such a job rides a lane
#: even without classifier-free guidance
FEWSTEP_KINDS = frozenset({"lcm"})

#: sampler kinds that consume fresh noise every step
NOISY_KINDS = frozenset({"euler_ancestral", "lcm"})

#: LCM boundary-condition constants (Luo et al. 2023)
LCM_SIGMA_DATA = 0.5
LCM_TIMESTEP_SCALING = 10.0


class SamplingSchedule(NamedTuple):
    sigmas: torch.Tensor     # (N+1,), descending, sigmas[N] == 0
    timesteps: torch.Tensor  # (N,) float32 model-conditioning timesteps


class SamplerState(NamedTuple):
    """Cross-step carry for multistep methods."""

    old_denoised: torch.Tensor  # previous denoised estimate (zeros at step 0)


def _inference_timesteps(config: SamplerConfig, num_train: int, n: int) -> torch.Tensor:
    if config.timestep_spacing == "leading":
        step = num_train // n
        ts = torch.arange(n, dtype=_F32) * step + config.steps_offset
    elif config.timestep_spacing == "trailing":
        ts = torch.round(torch.arange(num_train, 0, -num_train / n,
                                      dtype=_F32)) - 1.0
        ts = ts.flip(0)
    elif config.timestep_spacing == "linspace":
        ts = linspace32(0.0, num_train - 1, n)
    else:
        raise ValueError(f"unknown timestep spacing {config.timestep_spacing!r}")
    return torch.clamp(ts, 0, num_train - 1)


def make_sampling_schedule(schedule: NoiseSchedule, num_steps: int,
                           config: SamplerConfig) -> SamplingSchedule:
    """Build the descending sigma ladder + conditioning timesteps."""
    num_train = schedule.sigmas.shape[0]
    ts = _inference_timesteps(config, num_train, num_steps)  # ascending
    sigmas = interp(ts, torch.arange(num_train, dtype=_F32), schedule.sigmas)
    if config.use_karras_sigmas:
        sigmas = karras_sigmas(sigmas[0], sigmas[-1], num_steps)
        timesteps = sigma_to_timestep(schedule, sigmas)
    else:
        sigmas = sigmas.flip(0)
        timesteps = ts.flip(0)
    sigmas = torch.cat([sigmas, torch.zeros(1, dtype=sigmas.dtype)])
    return SamplingSchedule(sigmas=sigmas.to(_F32), timesteps=timesteps.to(_F32))


def make_edm_schedule(sigma_min: float, sigma_max: float,
                      num_steps: int) -> SamplingSchedule:
    """The EDM continuous-sigma schedule of SVD-class families (JAX
    :107-118): Karras sigmas over (``sigma_min``, ``sigma_max``) and a
    trailing zero, conditioned on the continuous timestep ``0.25 *
    log(sigma)`` in float32, never rounded to a train step (diffusers'
    EulerDiscrete with ``timestep_type="continuous"``)."""
    sig = karras_sigmas(sigma_min, sigma_max, num_steps)
    return SamplingSchedule(
        sigmas=torch.cat([sig, torch.zeros(1, dtype=_F32)]).to(_F32),
        timesteps=(0.25 * torch.log(sig)).to(_F32))


def scale_model_input(sched: SamplingSchedule, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
    """x / sqrt(sigma^2 + 1): k-diffusion coordinates back to the VP
    coordinates the UNet was trained in."""
    sigma = upload(sched.sigmas[i], sample.device)
    return (sample / torch.sqrt(sigma ** 2 + 1.0)).to(sample.dtype)


def init_sampler_state(sample: torch.Tensor) -> SamplerState:
    return SamplerState(old_denoised=torch.zeros_like(sample))


def sampler_step(config: SamplerConfig, sched: SamplingSchedule, i: int,
                 sample: torch.Tensor, model_output: torch.Tensor,
                 state: SamplerState, noise: torch.Tensor | None = None,
                 start_index: int = 0) -> tuple[torch.Tensor, SamplerState]:
    """One denoise step at step index ``i`` (0..N-1).

    ``noise`` (same shape as sample) is consumed only by the ancestral and
    lcm kinds. ``start_index`` is the first index the loop executes; the
    multistep history fallback keys off it.
    """
    # sigma[i - 1], sigma[i], sigma[i + 1] (and the step's timestep) on the
    # sample's device; the branches below read the host ladder
    sigma_prev, sigma, sigma_next = upload(
        sched.sigmas[torch.tensor([max(i - 1, 0), i, i + 1])],
        sample.device).unbind()
    last = float(sched.sigmas[i + 1]) == 0.0
    x = sample.to(_F32)
    denoised = denoised_from_model_output(model_output.to(_F32), x, sigma,
                                          config.prediction_type)

    if config.kind in ("euler", "ddim", "heun"):
        # heun's corrector needs a second model eval; the predictor alone
        # is the euler step, as in the reference
        d = (x - denoised) / sigma
        x_next = x + (sigma_next - sigma) * d
    elif config.kind == "euler_ancestral":
        if noise is None:
            raise ValueError("euler_ancestral requires noise")
        var = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
        sigma_up = torch.sqrt(torch.clamp(var, min=0.0))
        sigma_down = torch.sqrt(torch.clamp(sigma_next ** 2 - sigma_up ** 2,
                                            min=0.0))
        d = (x - denoised) / sigma
        x_next = x + (sigma_down - sigma) * d + noise.to(_F32) * sigma_up
    elif config.kind == "lcm":
        if noise is None:
            raise ValueError("lcm requires noise")
        ts = upload(sched.timesteps[i], sample.device) * LCM_TIMESTEP_SCALING
        c_skip = LCM_SIGMA_DATA ** 2 / (ts ** 2 + LCM_SIGMA_DATA ** 2)
        c_out = ts / torch.sqrt(ts ** 2 + LCM_SIGMA_DATA ** 2)
        sample_vp = x / torch.sqrt(sigma ** 2 + 1.0)
        denoised = c_skip * sample_vp + c_out * denoised
        x_next = denoised + noise.to(_F32) * sigma_next
    elif config.kind == "dpmpp_2m":
        # DPM-Solver++(2M), data-prediction multistep, sigma domain
        def t_fn(s: torch.Tensor) -> torch.Tensor:
            return -torch.log(torch.clamp(s, min=1e-10))

        t, t_next = t_fn(sigma), t_fn(sigma_next)
        h = t_next - t
        h_last = t - t_fn(sigma_prev)
        r = h_last / h
        old = state.old_denoised.to(_F32)
        # first executed step (no history) and final step (sigma_next == 0)
        # take the first-order update
        if i == start_index or last:
            use_d = denoised
        else:
            use_d = (1.0 + 1.0 / (2.0 * r)) * denoised - (1.0 / (2.0 * r)) * old
        x_next = (sigma_next / sigma) * x - torch.expm1(-h) * use_d
    else:
        raise ValueError(f"unknown sampler kind {config.kind!r}")

    if last:
        x_next = denoised
    return x_next.to(sample.dtype), SamplerState(old_denoised=denoised.to(sample.dtype))


def reproject_known(sched: SamplingSchedule, i: int, sample: torch.Tensor,
                    known: torch.Tensor, mask: torch.Tensor,
                    renoise: torch.Tensor) -> torch.Tensor:
    """Model-agnostic inpainting: after the sampler step to noise level
    ``i + 1``, re-noise the clean source latents ``known`` onto that level
    and paste them where ``mask`` is 0 (1 = regenerate). At the last step
    ``sigmas[i + 1]`` is 0, so the kept region ends as ``known`` exactly."""
    sigma_next = upload(sched.sigmas[i + 1], sample.device)
    known_t = known + renoise * sigma_next
    return sample * mask + known_t * (1.0 - mask)


def reproject_known_rows(sched: SamplingSchedule, i: torch.Tensor,
                         sample: torch.Tensor, known: torch.Tensor,
                         mask: torch.Tensor,
                         renoise: torch.Tensor) -> torch.Tensor:
    """Per-row :func:`reproject_known`: ``sched.sigmas`` is (B, S+1), one
    ladder per row, and ``i`` the (B,) per-row step indices."""
    sigma_next = _row_values(sched.sigmas, i + 1, sample.ndim)
    known_t = known + renoise * sigma_next
    return sample * mask + known_t * (1.0 - mask)


def _row_values(table: torch.Tensor, i: torch.Tensor, ndim: int) -> torch.Tensor:
    """``table[b, i[b]]`` for every row b, shaped to broadcast over a
    (B, ...) sample of ``ndim`` dims. Indices past the table clamp, as a
    JAX gather does: a retired or padding row may sit at its last index."""
    i = i.clamp(0, table.shape[1] - 1).to(torch.int64)
    return table.gather(1, i[:, None]).reshape((-1,) + (1,) * (ndim - 1))


def scale_model_input_rows(sched: SamplingSchedule, sample: torch.Tensor,
                           i: torch.Tensor) -> torch.Tensor:
    """Per-row :func:`scale_model_input`: ``sched.sigmas`` is (B, S+1), one
    ladder per row, and ``i`` the (B,) per-row step indices."""
    sigma = _row_values(sched.sigmas, i, sample.ndim)
    return (sample / torch.sqrt(sigma ** 2 + 1.0)).to(sample.dtype)


def sampler_step_rows(config: SamplerConfig, sched: SamplingSchedule,
                      i: torch.Tensor, sample: torch.Tensor,
                      model_output: torch.Tensor, state: SamplerState,
                      noise: torch.Tensor | None,
                      start_index: torch.Tensor
                      ) -> tuple[torch.Tensor, SamplerState]:
    """Per-row :func:`sampler_step`, the continuous-batching quantum.

    ``sched.sigmas`` is (B, S+1) and ``sched.timesteps`` (B, S): each row
    carries its own ladder, padded to the lane's step capacity; ``i`` and
    ``start_index`` are (B,) per-row positions. The step's expressions are
    the solo step's, in the same order, over (B, 1, ...) per-row scalars;
    its two branches on the step (first executed step, last step) are
    masks. No host sync: nothing here reads a device value on the host.
    """
    nd = sample.ndim
    sigma = _row_values(sched.sigmas, i, nd)
    sigma_next = _row_values(sched.sigmas, i + 1, nd)
    x = sample.to(_F32)
    denoised = denoised_from_model_output(model_output.to(_F32), x, sigma,
                                          config.prediction_type)

    if config.kind in ("euler", "ddim", "heun"):
        d = (x - denoised) / sigma
        x_next = x + (sigma_next - sigma) * d
    elif config.kind == "euler_ancestral":
        if noise is None:
            raise ValueError("euler_ancestral requires noise")
        var = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
        sigma_up = torch.sqrt(torch.clamp(var, min=0.0))
        sigma_down = torch.sqrt(torch.clamp(sigma_next ** 2 - sigma_up ** 2,
                                            min=0.0))
        d = (x - denoised) / sigma
        x_next = x + (sigma_down - sigma) * d + noise.to(_F32) * sigma_up
    elif config.kind == "lcm":
        if noise is None:
            raise ValueError("lcm requires noise")
        ts = _row_values(sched.timesteps, i, nd) * LCM_TIMESTEP_SCALING
        c_skip = LCM_SIGMA_DATA ** 2 / (ts ** 2 + LCM_SIGMA_DATA ** 2)
        c_out = ts / torch.sqrt(ts ** 2 + LCM_SIGMA_DATA ** 2)
        sample_vp = x / torch.sqrt(sigma ** 2 + 1.0)
        denoised = c_skip * sample_vp + c_out * denoised
        x_next = denoised + noise.to(_F32) * sigma_next
    elif config.kind == "dpmpp_2m":
        def t_fn(s: torch.Tensor) -> torch.Tensor:
            return -torch.log(torch.clamp(s, min=1e-10))

        t, t_next = t_fn(sigma), t_fn(sigma_next)
        h = t_next - t
        sigma_prev = _row_values(sched.sigmas, torch.clamp(i - 1, min=0), nd)
        h_last = t - t_fn(sigma_prev)
        r = h_last / h
        old = state.old_denoised.to(_F32)
        # the first executed step has r = 0, so the second-order branch is
        # inf or NaN there: the mask selects around it, never scales it
        first_or_last = ((i == start_index).reshape(sigma.shape)
                         | (sigma_next == 0.0))
        use_d = torch.where(
            first_or_last, denoised,
            (1.0 + 1.0 / (2.0 * r)) * denoised - (1.0 / (2.0 * r)) * old)
        x_next = (sigma_next / sigma) * x - torch.expm1(-h) * use_d
    else:
        raise ValueError(f"unknown sampler kind {config.kind!r}")

    x_next = torch.where(sigma_next == 0.0, denoised, x_next)
    return x_next.to(sample.dtype), SamplerState(old_denoised=denoised.to(sample.dtype))


# diffusers class name (as sent by the hive) -> sampler kind
SAMPLERS: dict[str, str] = {
    "DDIMScheduler": "ddim",
    "PNDMScheduler": "dpmpp_2m",  # nearest deterministic multistep equivalent
    "EulerDiscreteScheduler": "euler",
    "EulerAncestralDiscreteScheduler": "euler_ancestral",
    "DPMSolverMultistepScheduler": "dpmpp_2m",
    "DPMSolverSinglestepScheduler": "dpmpp_2m",
    "UniPCMultistepScheduler": "dpmpp_2m",
    "HeunDiscreteScheduler": "heun",
    "KDPM2DiscreteScheduler": "dpmpp_2m",
    "LMSDiscreteScheduler": "euler",
    "DDPMScheduler": "euler_ancestral",
    # few-step family: LCM-distilled checkpoints and the trajectory-
    # consistency variant resolve onto the lcm boundary-condition step
    "LCMScheduler": "lcm",
    "TCDScheduler": "lcm",
}


def resolve(name: str | None, *, prediction_type: str = "epsilon",
            use_karras_sigmas: bool = True) -> SamplerConfig:
    """Map a hive-supplied diffusers scheduler class name to a SamplerConfig."""
    kind = SAMPLERS.get(name or "", "dpmpp_2m")
    if kind == "lcm":
        # trailing spacing lands the first step at t=999 (the distillation
        # boundary); Karras respacing would move the pinned timesteps
        return SamplerConfig(
            kind=kind,
            use_karras_sigmas=False,
            timestep_spacing="trailing",
            prediction_type=prediction_type,
        )
    return SamplerConfig(
        kind=kind,
        use_karras_sigmas=use_karras_sigmas,
        prediction_type=prediction_type,
    )
