"""Noise-schedule math, counterpart of ``chiaswarm_tpu/schedulers/common.py``.

Every table is a float32 tensor on the CPU, computed with the JAX package's
formulas in float32 (``linspace32`` and ``interp`` follow ``jnp.linspace``
and ``jnp.interp`` step for step), so the sigma ladders agree with the
reference to float32 rounding, down to the last Karras steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Static description of a model's training noise schedule."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"      # "epsilon" | "v_prediction" | "sample"


class NoiseSchedule(NamedTuple):
    """Precomputed per-train-timestep tables."""

    betas: torch.Tensor            # (T_train,)
    alphas_cumprod: torch.Tensor   # (T_train,)
    sigmas: torch.Tensor           # (T_train,) sigma(t) = sqrt((1-a)/a)


def linspace32(start, stop, num: int) -> torch.Tensor:
    """float32 linspace with ``jnp.linspace``'s arithmetic: start*(1-s) +
    stop*s over s = i/(num-1), the last point exactly ``stop``."""
    start = torch.as_tensor(start, dtype=_F32)
    stop = torch.as_tensor(stop, dtype=_F32)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=_F32) / float(div)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` (constant extrapolation) on 1-D float32 tables."""
    x = torch.as_tensor(x, dtype=_F32)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def make_betas(config: ScheduleConfig) -> torch.Tensor:
    t = config.num_train_timesteps
    if config.beta_schedule == "linear":
        return linspace32(config.beta_start, config.beta_end, t)
    if config.beta_schedule == "scaled_linear":
        return linspace32(config.beta_start ** 0.5, config.beta_end ** 0.5, t) ** 2
    if config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(x: torch.Tensor) -> torch.Tensor:
            return torch.cos((x + 0.008) / 1.008 * math.pi / 2) ** 2

        t1 = torch.arange(t, dtype=_F32) / t
        t2 = (torch.arange(t, dtype=_F32) + 1) / t
        return torch.clamp(1.0 - alpha_bar(t2) / alpha_bar(t1), 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {config.beta_schedule!r}")


def make_noise_schedule(config: ScheduleConfig) -> NoiseSchedule:
    betas = make_betas(config)
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    sigmas = torch.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    return NoiseSchedule(betas=betas, alphas_cumprod=alphas_cumprod,
                         sigmas=sigmas)


def add_noise(schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """The forward process q(x_t | x_0) at integer train timesteps ``t``
    (JAX :78-85): sqrt(a_t) x0 + sqrt(1 - a_t) noise, ``a_t`` indexed in
    ``alphas_cumprod`` and broadcast over the trailing dims."""
    a = schedule.alphas_cumprod[t.cpu().long()].to(x0.device, x0.dtype)
    a = a.reshape(a.shape + (1,) * (x0.ndim - a.ndim))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def karras_sigmas(sigma_min, sigma_max, n: int, rho: float = 7.0) -> torch.Tensor:
    """Karras et al. (2022) sigma ladder, high to low, length n."""
    ramp = linspace32(0.0, 1.0, n)
    min_inv_rho = torch.as_tensor(sigma_min, dtype=_F32) ** (1.0 / rho)
    max_inv_rho = torch.as_tensor(sigma_max, dtype=_F32) ** (1.0 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def sigma_to_timestep(schedule: NoiseSchedule, sigma: torch.Tensor) -> torch.Tensor:
    """sigma -> (fractional) train timestep by log-sigma interpolation."""
    log_sigma = torch.log(torch.clamp(torch.as_tensor(sigma, dtype=_F32),
                                      min=1e-10))
    log_table = torch.log(schedule.sigmas)
    return interp(log_sigma, log_table,
                  torch.arange(log_table.shape[0], dtype=_F32))


def denoised_from_model_output(model_output: torch.Tensor, sample: torch.Tensor,
                               sigma: torch.Tensor, prediction_type: str) -> torch.Tensor:
    """Model output at noise level ``sigma`` (a scalar) -> denoised (x0)
    estimate, for samples in k-diffusion space x = x0 + sigma * eps."""
    sigma = torch.as_tensor(sigma, dtype=_F32)
    if prediction_type == "epsilon":
        return sample - sigma * model_output
    if prediction_type == "v_prediction":
        s2 = sigma ** 2
        return sample / (s2 + 1.0) - model_output * sigma / torch.sqrt(s2 + 1.0)
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"unknown prediction type {prediction_type!r}")
