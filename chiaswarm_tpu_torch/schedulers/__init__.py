"""Diffusion schedulers: noise schedules and sampler steps."""

from chiaswarm_tpu_torch.schedulers.common import (
    NoiseSchedule,
    ScheduleConfig,
    add_noise,
    make_noise_schedule,
)
from chiaswarm_tpu_torch.schedulers.sampling import (
    FEWSTEP_KINDS,
    NOISY_KINDS,
    SAMPLERS,
    SamplerConfig,
    SamplerState,
    SamplingSchedule,
    init_sampler_state,
    make_edm_schedule,
    make_sampling_schedule,
    reproject_known,
    reproject_known_rows,
    resolve,
    sampler_step,
    sampler_step_rows,
    scale_model_input,
    scale_model_input_rows,
)

__all__ = [
    "FEWSTEP_KINDS",
    "NOISY_KINDS",
    "NoiseSchedule",
    "SAMPLERS",
    "SamplerConfig",
    "SamplerState",
    "SamplingSchedule",
    "ScheduleConfig",
    "add_noise",
    "init_sampler_state",
    "make_edm_schedule",
    "make_noise_schedule",
    "make_sampling_schedule",
    "reproject_known",
    "reproject_known_rows",
    "resolve",
    "sampler_step",
    "sampler_step_rows",
    "scale_model_input",
    "scale_model_input_rows",
]
