"""The port's schedulers against the JAX package's: noise tables, sigma
ladders and conditioning timesteps, and ``sampler_step`` for every kind.
Model outputs and (for the ancestral and lcm kinds) per-step noise come
from numpy and go to both sides.

Tolerance 2e-4 (the repo's scheduler bar), relative and absolute: both
sides compute in float32; only the order of a few float32 reductions
(cumprod, interpolation) differs.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.schedulers import common as jc
from chiaswarm_tpu.schedulers import sampling as js
from chiaswarm_tpu_torch.schedulers import common as tc
from chiaswarm_tpu_torch.schedulers import sampling as ts

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = dict(rtol=2e-4, atol=2e-4)

KINDS = ["euler", "ddim", "heun", "euler_ancestral", "lcm", "dpmpp_2m"]
_CLASS_OF = {"euler": "EulerDiscreteScheduler", "ddim": "DDIMScheduler",
             "heun": "HeunDiscreteScheduler",
             "euler_ancestral": "EulerAncestralDiscreteScheduler",
             "lcm": "LCMScheduler", "dpmpp_2m": None}


def _pair(kind: str, prediction_type: str = "epsilon"):
    jcfg = js.resolve(_CLASS_OF[kind], prediction_type=prediction_type)
    tcfg = ts.resolve(_CLASS_OF[kind], prediction_type=prediction_type)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear",
                                           "squaredcos_cap_v2"])
def test_noise_schedule_matches(beta_schedule):
    cfg = dict(beta_schedule=beta_schedule)
    j = jc.make_noise_schedule(jc.ScheduleConfig(**cfg))
    t = tc.make_noise_schedule(tc.ScheduleConfig(**cfg))
    for field in ("betas", "alphas_cumprod", "sigmas"):
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)), **TOL,
                                   err_msg=field)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("steps", [1, 4, 20, 30, 50])
def test_sampling_schedule_matches(kind, steps):
    jcfg, tcfg = _pair(kind)
    j = js.make_sampling_schedule(
        jc.make_noise_schedule(jc.ScheduleConfig()), steps, jcfg)
    t = ts.make_sampling_schedule(
        tc.make_noise_schedule(tc.ScheduleConfig()), steps, tcfg)
    assert t.sigmas.shape == (steps + 1,) and float(t.sigmas[-1]) == 0.0
    np.testing.assert_allclose(t.sigmas.numpy(), np.asarray(j.sigmas), **TOL)
    np.testing.assert_allclose(t.timesteps.numpy(), np.asarray(j.timesteps),
                               **TOL)


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_timestep_spacings_match(spacing):
    jcfg = js.SamplerConfig(use_karras_sigmas=False, timestep_spacing=spacing)
    tcfg = ts.SamplerConfig(use_karras_sigmas=False, timestep_spacing=spacing)
    for steps in (3, 7, 25):
        j = js.make_sampling_schedule(
            jc.make_noise_schedule(jc.ScheduleConfig()), steps, jcfg)
        t = ts.make_sampling_schedule(
            tc.make_noise_schedule(tc.ScheduleConfig()), steps, tcfg)
        np.testing.assert_allclose(t.timesteps.numpy(),
                                   np.asarray(j.timesteps), **TOL)
        np.testing.assert_allclose(t.sigmas.numpy(), np.asarray(j.sigmas),
                                   **TOL)


def test_karras_and_sigma_to_timestep_match():
    j_ns = jc.make_noise_schedule(jc.ScheduleConfig())
    t_ns = tc.make_noise_schedule(tc.ScheduleConfig())
    for n in (2, 9, 20):
        j = jc.karras_sigmas(jnp.float32(0.0292), jnp.float32(14.6146), n)
        t = tc.karras_sigmas(0.0292, 14.6146, n)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
        np.testing.assert_allclose(tc.sigma_to_timestep(t_ns, t).numpy(),
                                   np.asarray(jc.sigma_to_timestep(j_ns, j)),
                                   **TOL)


def _run_trajectory(kind: str, steps: int, prediction_type: str,
                    start_index: int = 0):
    """Drive both samplers over the same model outputs and noise; compare
    every step's sample."""
    jcfg, tcfg = _pair(kind, prediction_type)
    j_sched = js.make_sampling_schedule(
        jc.make_noise_schedule(jc.ScheduleConfig()), steps, jcfg)
    t_sched = ts.make_sampling_schedule(
        tc.make_noise_schedule(tc.ScheduleConfig()), steps, tcfg)
    rng = np.random.default_rng(steps)
    x0 = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
          * float(t_sched.sigmas[start_index]))
    j_x, t_x = jnp.asarray(x0), torch.from_numpy(x0)
    j_state, t_state = js.init_sampler_state(j_x), ts.init_sampler_state(t_x)
    for i in range(start_index, steps):
        eps = rng.standard_normal(x0.shape).astype(np.float32)
        noise = rng.standard_normal(x0.shape).astype(np.float32)
        np.testing.assert_allclose(
            ts.scale_model_input(t_sched, t_x, i).numpy(),
            np.asarray(js.scale_model_input(j_sched, j_x, i)), **TOL)
        j_x, j_state = js.sampler_step(jcfg, j_sched, i, j_x, jnp.asarray(eps),
                                       j_state, noise=jnp.asarray(noise),
                                       start_index=start_index)
        t_x, t_state = ts.sampler_step(tcfg, t_sched, i, t_x,
                                       torch.from_numpy(eps), t_state,
                                       noise=torch.from_numpy(noise),
                                       start_index=start_index)
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), **TOL,
                                   err_msg=f"{kind} step {i}")
        np.testing.assert_allclose(t_state.old_denoised.numpy(),
                                   np.asarray(j_state.old_denoised), **TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction",
                                             "sample"])
def test_sampler_step_trajectory_matches(kind, prediction_type):
    _run_trajectory(kind, 8, prediction_type)


@pytest.mark.parametrize("kind", ["dpmpp_2m", "euler"])
def test_sampler_step_from_a_later_start_index(kind):
    """img2img starts partway down the ladder: the multistep history
    fallback keys off start_index, not 0."""
    _run_trajectory(kind, 10, "epsilon", start_index=3)


def test_noisy_kinds_require_noise():
    sched = ts.make_sampling_schedule(
        tc.make_noise_schedule(tc.ScheduleConfig()), 4, ts.SamplerConfig())
    x = torch.zeros(1, 4, 2, 2)
    for kind in ("euler_ancestral", "lcm"):
        with pytest.raises(ValueError, match="requires noise"):
            ts.sampler_step(ts.SamplerConfig(kind=kind), sched, 0, x, x,
                            ts.init_sampler_state(x))
    with pytest.raises(ValueError, match="unknown sampler kind"):
        ts.sampler_step(ts.SamplerConfig(kind="plms"), sched, 0, x, x,
                        ts.init_sampler_state(x))


def test_sampler_registry_is_a_copy():
    assert ts.SAMPLERS == js.SAMPLERS
    for name in [None, "", "NotAScheduler", *js.SAMPLERS]:
        for pred in ("epsilon", "v_prediction"):
            assert (dataclasses.asdict(ts.resolve(name, prediction_type=pred))
                    == dataclasses.asdict(js.resolve(name, prediction_type=pred)))
