"""The port's continuous-batching lanes (``chiaswarm_tpu_torch/serving/
stepper.py``) on the ``tiny`` family at 64 px, against the JAX package and
against the port's own solo path.

- The per-row samplers and one lane step: the same numpy inputs through the
  JAX functions and the port's, within 2e-4 (the samplers also within a
  relative 1e-5; the step's history, a denoised estimate ``x - sigma * eps``,
  within 2e-4 in eps terms, error / max(1, sigma): the UNet parity bar of
  ``tests/test_torch_models.py``).
- The splice gate, as the JAX package's ``tests/test_stepper.py`` holds it:
  a job spliced into a running lane with another step count and guidance
  matches the port's solo run to uint8 quantization (max 3 levels, more
  than 99% within 1).
- The width controller and the scheduler's width policy pinned to the JAX
  package's; the scheduling invariants; the executor's lanes-first routing
  and its envelope against the JAX lane envelope; a lane on a ``seq`` mesh.

Every scheduler a test builds is shut down before the test ends.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import gc
import io
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from chiaswarm_tpu.schedulers import sampling as jsampling
from chiaswarm_tpu.schedulers.common import (
    ScheduleConfig as JaxScheduleConfig,
)
from chiaswarm_tpu.schedulers.common import (
    make_noise_schedule as jax_noise_schedule,
)
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.mesh import MeshSpec
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.parallel.context import capture_ring_calls
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import (
    DiffusionPipeline,
    GenerateRequest,
)
from chiaswarm_tpu_torch.schedulers import ScheduleConfig, make_noise_schedule
from chiaswarm_tpu_torch.schedulers import sampling as tsampling
from chiaswarm_tpu_torch.serving.stepper import (
    LaneDeadline,
    LaneReject,
    LaneWidthController,
    StepScheduler,
    aggregate_stats,
    get_stepper,
    stepper_enabled,
)

# one representative per sampler kind the splice gate holds (the hive's
# other class names resolve onto these)
KINDS = [None,                                # -> dpmpp_2m (default)
         "DDIMScheduler",                     # -> euler family
         "EulerAncestralDiscreteScheduler"]   # -> euler_ancestral

# every kind of the per-row step
ALL_KINDS = [None, "DDIMScheduler", "EulerDiscreteScheduler",
             "EulerAncestralDiscreteScheduler", "HeunDiscreteScheduler",
             "LCMScheduler"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and a lane's many small ops wait on an oversubscribed
    thread pool far longer than they compute (several times slower than
    one thread when the suite runs in parallel)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(JaxComponents.random("tiny", seed=0))


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    params = jax.tree.map(np.asarray, jax_pipe.c.params)
    return DiffusionPipeline(Components.from_jax(params, "tiny", device="cpu"))


@contextlib.contextmanager
def scheduler(slot=None):
    sched = StepScheduler(slot)
    try:
        yield sched
    finally:
        sched.shutdown()


def _wait_steps(sched: StepScheduler, n: int, timeout: float = 120.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if sched.stats().get("steps_executed", 0) >= n:
            return
        time.sleep(0.005)
    raise AssertionError(f"scheduler never reached {n} steps: {sched.stats()}")


def _close(lane_img: np.ndarray, solo_img: np.ndarray) -> None:
    # different batch shapes: agreement to uint8 quantization, not bits
    # (the JAX splice gate's bar)
    diff = np.abs(lane_img.astype(int) - solo_img.astype(int))
    assert diff.max() <= 3 and (diff <= 1).mean() > 0.99, (
        diff.max(), (diff <= 1).mean())


def _solo(pipe, **kw) -> np.ndarray:
    img, _ = pipe(GenerateRequest(height=64, width=64, **kw))
    return img


# ---------------------------------------------------------------------------
# 1. the per-row samplers against JAX's

STEP_COUNTS = (20, 12, 7, 5)
# per row: ladder position and start index (row 0 at its first step, where
# DPM-Solver++(2M)'s unused second-order branch is inf/NaN, row 2 at its
# last, row 3 starting partway down)
IDX = np.array([0, 5, 6, 3], np.int32)
START = np.array([0, 0, 0, 3], np.int32)
CAP = 32


def _ladders(name):
    """Per-row JAX ladders of different lengths, padded to CAP as a lane
    pads them (sigmas past the ladder 0, timesteps 0)."""
    cfg = jsampling.resolve(name)
    ns = jax_noise_schedule(JaxScheduleConfig())
    sig = np.zeros((len(STEP_COUNTS), CAP + 1), np.float32)
    ts = np.zeros((len(STEP_COUNTS), CAP), np.float32)
    for b, n in enumerate(STEP_COUNTS):
        sched = jsampling.make_sampling_schedule(ns, n, cfg)
        sig[b, :n + 1] = np.asarray(sched.sigmas)
        ts[b, :n] = np.asarray(sched.timesteps)
    return sig, ts


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", ALL_KINDS)
def test_row_samplers_match_jax(name):
    sig, ts = _ladders(name)
    rng = np.random.default_rng(7)
    x, eps, old, noise = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
                          for _ in range(4))
    jcfg = jsampling.resolve(name)
    jsched = jsampling.SamplingSchedule(jnp.asarray(sig), jnp.asarray(ts))
    j_inp = jsampling.scale_model_input_rows(jsched, jnp.asarray(x),
                                             jnp.asarray(IDX))
    j_x, j_state = jsampling.sampler_step_rows(
        jcfg, jsched, jnp.asarray(IDX), jnp.asarray(x), jnp.asarray(eps),
        jsampling.SamplerState(jnp.asarray(old)), jnp.asarray(noise),
        jnp.asarray(START))

    tcfg = tsampling.resolve(name)
    tsched = tsampling.SamplingSchedule(torch.from_numpy(sig),
                                        torch.from_numpy(ts))
    idx, start = torch.from_numpy(IDX).long(), torch.from_numpy(START).long()
    t_inp = tsampling.scale_model_input_rows(tsched, _nchw(x), idx)
    t_x, t_state = tsampling.sampler_step_rows(
        tcfg, tsched, idx, _nchw(x), _nchw(eps),
        tsampling.SamplerState(_nchw(old)), _nchw(noise), start)
    for got, ref in ((t_inp, j_inp), (t_x, j_x),
                     (t_state.old_denoised, j_state.old_denoised)):
        ref = _nchw(np.asarray(ref))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ALL_KINDS)
def test_row_step_is_each_rows_solo_step(name):
    """On the CPU each row of the per-row step is its solo step bit for bit:
    the same expressions in the same order, the branches as masks."""
    cfg = tsampling.resolve(name)
    noise_sched = make_noise_schedule(ScheduleConfig())
    scheds = [tsampling.make_sampling_schedule(noise_sched, n, cfg)
              for n in STEP_COUNTS]
    sig = torch.zeros((4, CAP + 1))
    ts = torch.zeros((4, CAP))
    for b, s in enumerate(scheds):
        sig[b, :len(s.sigmas)] = s.sigmas
        ts[b, :len(s.timesteps)] = s.timesteps
    gen = torch.Generator().manual_seed(3)
    x, eps, old, noise = (torch.randn((4, 4, 8, 8), generator=gen)
                          for _ in range(4))
    idx, start = torch.from_numpy(IDX).long(), torch.from_numpy(START).long()
    rows = tsampling.SamplingSchedule(sig, ts)
    x_r, st_r = tsampling.sampler_step_rows(
        cfg, rows, idx, x, eps, tsampling.SamplerState(old), noise, start)
    inp_r = tsampling.scale_model_input_rows(rows, x, idx)
    for b in range(4):
        one = slice(b, b + 1)
        x_s, st_s = tsampling.sampler_step(
            cfg, scheds[b], int(IDX[b]), x[one], eps[one],
            tsampling.SamplerState(old[one]), noise=noise[one],
            start_index=int(START[b]))
        assert torch.equal(x_r[one], x_s)
        assert torch.equal(st_r.old_denoised[one], st_s.old_denoised)
        assert torch.equal(inp_r[one], tsampling.scale_model_input(
            scheds[b], x[one], int(IDX[b])))


@pytest.mark.parametrize("name", ALL_KINDS)
def test_solo_step_computes_on_the_samples_device(name, monkeypatch):
    """The solo step keeps its ladder on the host but computes where the
    sample lives, as the per-row step does: every ladder value it computes
    with goes to the sample's device first (``core/device.py::upload``).
    On a card, a host scalar in the arithmetic parts from the lane in the
    last bit, which bf16 grows to several uint8 levels over a job
    (``tests/test_torch_gpu.py`` holds the two bit for bit there)."""
    moved: list[tuple[str, list[float]]] = []
    real_upload = tsampling.upload

    def spy(t, device):
        moved.append((str(device), t.reshape(-1).tolist()))
        return real_upload(t, device)

    monkeypatch.setattr(tsampling, "upload", spy)
    cfg = tsampling.resolve(name)
    sched = tsampling.make_sampling_schedule(
        make_noise_schedule(ScheduleConfig()), 6, cfg)
    gen = torch.Generator().manual_seed(4)
    x, eps, old, noise = (torch.randn((1, 4, 8, 8), generator=gen)
                          for _ in range(4))
    for i in range(6):
        moved.clear()
        tsampling.scale_model_input(sched, x, i)
        tsampling.sampler_step(cfg, sched, i, x, eps,
                               tsampling.SamplerState(old), noise=noise)
        sig = sched.sigmas.tolist()
        want = [("cpu", [sig[i]]), ("cpu", [sig[max(i - 1, 0)], sig[i],
                                            sig[i + 1]])]
        if cfg.kind == "lcm":
            want.append(("cpu", [sched.timesteps[i].item()]))
        assert moved == want, (i, moved)


# ---------------------------------------------------------------------------
# 2. one lane step against the JAX lane program


def _lane_inputs(name):
    """Width 4: mixed ladder positions, step counts and guidance; row 3 is
    inactive (a padding row, frozen by the step)."""
    sig, ts = _ladders(name)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, 32, 4)).astype(np.float32)
    old = rng.standard_normal((4, 32, 32, 4)).astype(np.float32)
    ctx_u, ctx_c = (rng.standard_normal((4, 77, 32)).astype(np.float32)
                    for _ in range(2))
    guidance = np.array([7.5, 5.0, 9.0, 7.5], np.float32)
    active = np.array([True, True, True, False])
    return sig, ts, x, old, ctx_u, ctx_c, guidance, active


@pytest.mark.parametrize("name", [None, "EulerDiscreteScheduler"])
def test_lane_step_matches_jax(jax_pipe, port_pipe, name):
    from chiaswarm_tpu.core.rng import key_for_seed

    sig, ts, x, old, ctx_u, ctx_c, guidance, active = _lane_inputs(name)
    jcfg = jsampling.resolve(name)
    fn = jax_pipe.stepper_step_fn(batch=4, height=64, width=64,
                                  steps_cap=CAP, sampler=jcfg)
    keys = jnp.stack([jax.random.fold_in(key_for_seed(0), r)
                      for r in range(4)])
    placeholder = jnp.zeros((1,), jnp.float32)
    j_x, _, j_idx, j_old = fn(
        jax_pipe.c.params, jnp.asarray(ctx_u), jnp.asarray(ctx_c),
        placeholder, placeholder, jnp.asarray(x), keys, jnp.asarray(IDX),
        jnp.asarray(START), jnp.asarray(sig), jnp.asarray(ts),
        jnp.asarray(guidance), jnp.asarray(old), jnp.asarray(active),
        jnp.zeros_like(jnp.asarray(x)), jnp.ones((4, 32, 32, 1)),
        jnp.zeros(4, bool), {"zero": placeholder}, placeholder,
        jnp.ones(4, jnp.float32))

    t_x, t_idx, t_old = port_pipe.stepper_step(
        sampler=tsampling.resolve(name), ctx_u=torch.from_numpy(ctx_u),
        ctx_c=torch.from_numpy(ctx_c), x=_nchw(x),
        idx=torch.from_numpy(IDX).long(),
        start_idx=torch.from_numpy(START).long(),
        sigmas=torch.from_numpy(sig), timesteps=torch.from_numpy(ts),
        guidance=torch.from_numpy(guidance), old_denoised=_nchw(old),
        active=torch.from_numpy(active), generators=[None] * 4)
    assert t_idx.tolist() == np.asarray(j_idx).tolist() == [1, 6, 7, 3]
    torch.testing.assert_close(t_x, _nchw(np.asarray(j_x)), atol=2e-4,
                               rtol=0)
    # the history is the denoised estimate x - sigma * eps, so it carries
    # the UNet's eps error times sigma (11.03 on row 0 here): it is held in
    # eps terms, error / max(1, sigma) within 2e-4, the repo's float32 bar
    # on the UNet's eps (tests/test_torch_models.py). Measured: 3.5e-5 on
    # row 0 (3.8e-4 absolute), below 4e-5 on every row.
    sigma = torch.from_numpy(np.maximum(
        1.0, sig[np.arange(4), np.minimum(IDX, CAP)]))
    err = (t_old - _nchw(np.asarray(j_old))).abs().amax(dim=(1, 2, 3))
    print(f"history max abs error per row {err.tolist()}, in eps terms "
          f"{(err / sigma).tolist()}")  # shown under pytest -s
    assert (err / sigma <= 2e-4).all(), (err, sigma)
    # the inactive row is untouched, bit for bit
    assert torch.equal(t_x[3], _nchw(x)[3])
    assert torch.equal(t_old[3], _nchw(old)[3])


@pytest.mark.parametrize("name", [None, "EulerDiscreteScheduler"])
def test_lane_step_history_gap_is_the_unet_eps_gap(jax_pipe, port_pipe,
                                                   name):
    """At ``test_lane_step_matches_jax``'s inputs, the two packages' CFG eps
    (one UNet call on the lane's 2W rows, the per-row guidance combine) are
    held directly: within 2e-4 on every active row, the repo's float32 bar
    on the UNet. The lane step's history error on each active row is then
    no more than its sigma times that row's eps error (the history is
    ``x - sigma * eps`` from the same ``x``), so the 3.8e-4 history gap on
    row 0 (sigma 11.03) is the UNet's eps difference scaled by sigma, not
    the per-row sampler arithmetic."""
    from chiaswarm_tpu.core.rng import key_for_seed

    sig, ts, x, old, ctx_u, ctx_c, guidance, active = _lane_inputs(name)
    # the CFG eps on both sides, in the lane program's own arithmetic
    j_rows = jsampling.SamplingSchedule(sigmas=jnp.asarray(sig),
                                        timesteps=jnp.asarray(ts))
    j_inp = jsampling.scale_model_input_rows(j_rows, jnp.asarray(x),
                                             jnp.asarray(IDX))
    j_t = jnp.asarray(ts)[np.arange(4), IDX]
    j_out = jax_pipe.c.unet.apply(
        jax_pipe.c.params["unet"], jnp.concatenate([j_inp, j_inp]),
        jnp.concatenate([j_t, j_t]),
        jnp.concatenate([jnp.asarray(ctx_u), jnp.asarray(ctx_c)]))
    j_u, j_c = np.split(np.asarray(j_out), 2)
    g = guidance.reshape(-1, 1, 1, 1)
    j_eps = _nchw(j_u + g * (j_c - j_u))
    t_rows = tsampling.SamplingSchedule(sigmas=torch.from_numpy(sig),
                                        timesteps=torch.from_numpy(ts))
    t_inp = tsampling.scale_model_input_rows(t_rows, _nchw(x),
                                             torch.from_numpy(IDX).long())
    t_t = torch.from_numpy(ts[np.arange(4), IDX])
    with torch.inference_mode():
        t_out = port_pipe.c.unet(torch.cat([t_inp, t_inp]),
                                 torch.cat([t_t, t_t]),
                                 torch.from_numpy(np.concatenate([ctx_u,
                                                                  ctx_c])))
    t_u, t_c = t_out.chunk(2)
    t_eps = t_u + torch.from_numpy(g) * (t_c - t_u)
    eps_err = (t_eps - j_eps).abs().amax(dim=(1, 2, 3))
    # the lane step's history on both sides, as test_lane_step_matches_jax
    fn = jax_pipe.stepper_step_fn(batch=4, height=64, width=64,
                                  steps_cap=CAP,
                                  sampler=jsampling.resolve(name))
    keys = jnp.stack([jax.random.fold_in(key_for_seed(0), r)
                      for r in range(4)])
    placeholder = jnp.zeros((1,), jnp.float32)
    *_, j_old = fn(
        jax_pipe.c.params, jnp.asarray(ctx_u), jnp.asarray(ctx_c),
        placeholder, placeholder, jnp.asarray(x), keys, jnp.asarray(IDX),
        jnp.asarray(START), jnp.asarray(sig), jnp.asarray(ts),
        jnp.asarray(guidance), jnp.asarray(old), jnp.asarray(active),
        jnp.zeros_like(jnp.asarray(x)), jnp.ones((4, 32, 32, 1)),
        jnp.zeros(4, bool), {"zero": placeholder}, placeholder,
        jnp.ones(4, jnp.float32))
    *_, t_old = port_pipe.stepper_step(
        sampler=tsampling.resolve(name), ctx_u=torch.from_numpy(ctx_u),
        ctx_c=torch.from_numpy(ctx_c), x=_nchw(x),
        idx=torch.from_numpy(IDX).long(),
        start_idx=torch.from_numpy(START).long(),
        sigmas=torch.from_numpy(sig), timesteps=torch.from_numpy(ts),
        guidance=torch.from_numpy(guidance), old_denoised=_nchw(old),
        active=torch.from_numpy(active), generators=[None] * 4)
    old_err = (t_old - _nchw(np.asarray(j_old))).abs().amax(dim=(1, 2, 3))
    sigma = torch.from_numpy(sig[np.arange(4), IDX])
    print(f"eps max abs error per row {eps_err.tolist()}; history "
          f"{old_err.tolist()}; sigma x eps {(sigma * eps_err).tolist()}")
    rows = torch.from_numpy(active)
    assert (eps_err[rows] <= 2e-4).all(), eps_err
    # float32 rounding of x - sigma * eps (|history| ~ sigma * |eps|)
    slack = 4 * torch.finfo(torch.float32).eps * sigma * t_eps.abs().amax(
        dim=(1, 2, 3))
    assert (old_err[rows] <= sigma[rows] * eps_err[rows]
            + slack[rows]).all(), (old_err, sigma * eps_err)


# ---------------------------------------------------------------------------
# 3. the splice gate and multi-row jobs, against the port's solo path


@pytest.mark.parametrize("name", KINDS)
def test_spliced_row_matches_solo(port_pipe, name):
    """Job B splices into job A's running lane at a step >= 1, with another
    step count and guidance; both images match their solo runs."""
    with scheduler() as sched:
        fa = sched.submit_request(
            port_pipe, prompt="slow job", steps=16, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=21, scheduler=name)
        _wait_steps(sched, 1)
        fb = sched.submit_request(
            port_pipe, prompt="late arrival", steps=3, guidance_scale=5.0,
            height=64, width=64, rows=1, seed=22, scheduler=name)
        pending_b, info_b = fb.result(timeout=300)
        pending_a, info_a = fa.result(timeout=300)
    assert info_b["lane"] == info_a["lane"]
    assert 1 <= info_b["admitted_at_step"] < 16
    _close(pending_a.wait(), _solo(port_pipe, prompt="slow job", steps=16,
                                   guidance_scale=7.5, seed=21,
                                   scheduler=name))
    _close(pending_b.wait(), _solo(port_pipe, prompt="late arrival", steps=3,
                                   guidance_scale=5.0, seed=22,
                                   scheduler=name))


def test_multi_row_job_matches_solo_batch(port_pipe):
    with scheduler() as sched:
        pending, info = sched.submit_request(
            port_pipe, prompt="pair", steps=4, guidance_scale=6.0,
            height=64, width=64, rows=2, seed=33).result(timeout=300)
    imgs = pending.wait()
    solo = _solo(port_pipe, prompt="pair", steps=4, guidance_scale=6.0,
                 batch=2, seed=33)
    assert imgs.shape == solo.shape == (2, 64, 64, 3)
    assert info["lane_width"] >= 2
    _close(imgs, solo)


def test_resized_lane_keeps_rows_on_their_solo_trajectories(port_pipe,
                                                            monkeypatch):
    """A lane opened narrow grows at a step boundary when a burst cannot
    fit; the resident row survives the resize (its state compacted)."""
    monkeypatch.setenv("CHIASWARM_STEPPER_MIN_WIDTH", "2")
    with scheduler() as sched:
        fa = sched.submit_request(
            port_pipe, prompt="resident", steps=8, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=91)
        _wait_steps(sched, 1)
        late = [sched.submit_request(
            port_pipe, prompt=f"burst {i}", steps=3 + i, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=92 + i) for i in range(3)]
        results = [fut.result(timeout=300) for fut in late]
        img_a = fa.result(timeout=300)[0].wait()
        stats = sched.stats()
    assert stats.get("lane_resizes", 0) >= 1, stats
    assert max(info["lane_width"] for _, info in results) >= 4, results
    _close(img_a, _solo(port_pipe, prompt="resident", steps=8,
                        guidance_scale=7.5, seed=91))
    for i, (pending, _) in enumerate(results):
        _close(pending.wait(), _solo(port_pipe, prompt=f"burst {i}",
                                     steps=3 + i, guidance_scale=7.5,
                                     seed=92 + i))


# ---------------------------------------------------------------------------
# 4. the width controller and the width policy, pinned to the JAX package's


def _controllers(**kw):
    from chiaswarm_tpu.serving.stepper import (
        LaneWidthController as JaxController,
    )

    return LaneWidthController(**kw), JaxController(**kw)


# (width, occupied, pending rows, rate, max_width) per boundary
SCRIPTS = {
    "burst": [(2, 2, 3, 1.0, None), (8, 5, 0, 1.0, None),
              (8, 5, 0, 1.0, 4), (8, 1, 0, 0.0, None)],
    "sustained": [(4, 4, 0, 2.0, None)] * 8 + [(8, 8, 0, 0.0, None)] * 8,
    "trickle": [(16, 1, 0, 0.0, None)] * 20 + [(2, 1, 1, 0.1, None)] * 4,
    "oom": [(8, 1, 0, 0.0, 4), (8, 5, 0, 0.0, 2), (4, 3, 9, 3.0, 2)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("params", [
    {}, {"min_width": 1, "max_width": 16, "patience": 3},
    {"alpha": 1.0, "grow_at": 0.9, "patience": 2, "max_width": 32}])
def test_width_controller_matches_jax(script, params):
    ours, ref = _controllers(**params)
    for width, occupied, pending, rate, cap in SCRIPTS[script]:
        got = ours.decide(width, occupied, pending, rate, max_width=cap)
        want = ref.decide(width, occupied, pending, rate, max_width=cap)
        assert got == want, (script, width, occupied, pending, rate, cap)
        assert ours.occ_ewma == pytest.approx(ref.occ_ewma, abs=1e-12)


@pytest.mark.parametrize("env", [
    {}, {"CHIASWARM_STEPPER_LANE_WIDTH": "8"},
    {"CHIASWARM_STEPPER_ADAPTIVE": "0"},
    {"CHIASWARM_STEPPER_MIN_WIDTH": "2", "CHIASWARM_STEPPER_MAX_WIDTH": "12"},
])
def test_width_policy_matches_jax(monkeypatch, env):
    from chiaswarm_tpu.serving.stepper import StepScheduler as JaxScheduler

    for name in ("CHIASWARM_STEPPER_LANE_WIDTH", "CHIASWARM_STEPPER_ADAPTIVE",
                 "CHIASWARM_STEPPER_MIN_WIDTH", "CHIASWARM_STEPPER_MAX_WIDTH"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, ref = StepScheduler(), JaxScheduler()
    for h, w in ((512, 512), (64, 64), (768, 768), (1024, 1024)):
        assert ours.lane_width(h, w) == ref.lane_width(h, w)
        assert ours.width_bounds(h, w) == ref.width_bounds(h, w)
        for rows in (1, 2, 3, 5):
            assert (ours.initial_width(rows, h, w)
                    == ref.initial_width(rows, h, w))
    assert ours.row_deadline_s() == ref.row_deadline_s()
    ours.shutdown()
    ref.shutdown()


def test_arrival_ewma_matches_jax():
    from chiaswarm_tpu.serving.residency import ArrivalEwma as JaxEwma
    from chiaswarm_tpu_torch.serving.stepper import ArrivalEwma

    ours, ref = ArrivalEwma(), JaxEwma()
    for now, rows in ((0.0, 1), (0.5, 2), (0.6, 1), (4.0, 8), (30.0, 1)):
        ours.note(rows, now)
        ref.note(rows, now)
        assert ours.rate(now + 1.0) == ref.rate(now + 1.0)


# ---------------------------------------------------------------------------
# 5. scheduling invariants


def test_row_deadline_expires_in_lane(port_pipe):
    with scheduler() as sched:
        fut = sched.submit_request(
            port_pipe, prompt="doomed", steps=8, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=5, deadline_s=0.0)
        with pytest.raises(LaneDeadline):
            fut.result(timeout=300)
        assert sched.stats().get("rows_expired", 0) >= 1
        ok = sched.submit_request(
            port_pipe, prompt="fine", steps=2, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=6)
        ok.result(timeout=300)[0].wait()


@pytest.mark.parametrize("kwargs", [
    {"guidance_scale": 1.0},   # no-CFG jobs run the solo path
    {"steps": 4000},           # steps beyond the capacity lattice
    {"rows": 128},             # wider than the lane cap
])
def test_lane_rejects_out_of_policy_jobs(port_pipe, kwargs):
    base = dict(prompt="x", steps=4, guidance_scale=7.5, height=64,
                width=64, rows=1, seed=1)
    base.update(kwargs)
    with scheduler() as sched, pytest.raises(LaneReject):
        sched.submit_request(port_pipe, **base)


def test_fewstep_kind_rides_a_lane_without_guidance(port_pipe):
    with scheduler() as sched:
        pending, info = sched.submit_request(
            port_pipe, prompt="fast", steps=4, guidance_scale=1.0,
            height=64, width=64, rows=1, seed=4,
            scheduler="LCMScheduler").result(timeout=300)
    _close(pending.wait(), _solo(port_pipe, prompt="fast", steps=4,
                                 guidance_scale=1.0, seed=4,
                                 scheduler="LCMScheduler"))


def test_injected_fault_bounces_rows_not_loses_them(port_pipe):
    with scheduler() as sched:
        sched.inject_fault(after_steps=0, exc=RuntimeError(
            "CUDA out of memory: injected mid-lane"))
        fut = sched.submit_request(
            port_pipe, prompt="unlucky", steps=6, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=9)
        with pytest.raises(RuntimeError, match="injected mid-lane"):
            fut.result(timeout=300)
        assert sched.stats().get("lanes_failed", 0) >= 1
        ok = sched.submit_request(
            port_pipe, prompt="retry", steps=2, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=10)
        ok.result(timeout=300)[0].wait()


def test_oom_halves_width_once_after_lane_teardown(port_pipe):
    with scheduler() as sched:
        sched.inject_fault(after_steps=0, exc=RuntimeError("oom"))
        fut = sched.submit_request(
            port_pipe, prompt="oomed", steps=4, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=40)
        with pytest.raises(RuntimeError):
            fut.result(timeout=300)
        for _ in range(3):  # every resident job's collector reports it
            sched.note_oom()
        (limit,) = set(sched._width_limits.values())
        assert limit == max(1, sched.initial_width(1, 64, 64) // 2)
        ok = sched.submit_request(
            port_pipe, prompt="after", steps=2, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=41)
        _, info = ok.result(timeout=300)
        assert info["lane_width"] <= limit


def test_oom_widths_do_not_keep_a_pipeline_alive():
    class Pipe:  # a stand-in: the tables only hold it as a key
        pass

    pipe = Pipe()
    ref = weakref.ref(pipe)
    with scheduler() as sched:
        sched._note_lane_failure((pipe, 64, 64, "euler"), 4)
        sched.note_oom()
        assert sched.width_limit_for((pipe, 64, 64, "euler")) == 2
        del pipe
        gc.collect()
        assert ref() is None
        assert sched._width_limits.keys() == []
        assert sched._failed_lane_hints.keys() == []


def test_drain_and_shutdown_retire_lanes(port_pipe):
    with scheduler() as sched:
        fut = sched.submit_request(
            port_pipe, prompt="drainee", steps=6, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=11)
        assert sched.drain(timeout_s=300.0)
        assert fut.done()
        fut.result()[0].wait()
        sched.shutdown(timeout_s=30.0)
        assert sched.stats()["lanes_live"] == 0


def test_stats_aggregate(port_pipe):
    with scheduler() as sched, scheduler() as idle:
        sched.submit_request(
            port_pipe, prompt="counted", steps=4, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=12).result(timeout=300)[0].wait()
        stats = sched.stats()
        merged = aggregate_stats([sched, idle])
    assert stats["rows_admitted"] == stats["rows_admitted_txt2img"] == 1
    assert stats["steps_executed"] >= 4 and stats["rows_completed"] == 1
    assert abs(stats["lane_occupancy"] + stats["padding_waste"] - 1.0) < 1e-6
    assert merged["rows_admitted"] == stats["rows_admitted"]
    assert merged["steps_executed"] == stats["steps_executed"]
    assert 0.0 <= merged["lane_occupancy"] <= 1.0


# ---------------------------------------------------------------------------
# 6. the executor: lanes first


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                         allow_random=True, device="cpu")


@pytest.fixture()
def slot():
    slot = ChipPool(device="cpu").slots[0]
    yield slot
    get_stepper(slot).shutdown()


def _job(i: int, **over):
    job = {"id": f"s{i}", "model_name": "tiny", "prompt": f"prompt {i}",
           "seed": 200 + i, "num_inference_steps": 2, "height": 64,
           "width": 64, "content_type": "image/png"}
    job.update(over)
    return job


def _png(result) -> np.ndarray:
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_executor_routes_mixed_steps_onto_one_lane(monkeypatch, registry,
                                                   slot):
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    assert stepper_enabled()  # the default
    # s0 and s3 share a step count: two jobs retiring at one boundary
    jobs = [_job(0, num_inference_steps=2),
            _job(1, num_inference_steps=3, guidance_scale=5.0),
            _job(2, num_inference_steps=4),
            _job(3, num_inference_steps=2)]
    results = executor.synchronous_do_work_batch(jobs, slot, registry)
    assert [r["id"] for r in results] == ["s0", "s1", "s2", "s3"]
    lanes = set()
    for r in results:
        cfg = r["pipeline_config"]
        assert cfg.get("error") is None, cfg
        assert cfg["seed"] in (200, 201, 202, 203)
        lanes.add(cfg["stepper"]["lane"])
    assert len(lanes) == 1, lanes
    assert get_stepper(slot).stats()["rows_completed"] == 4


def test_executor_opt_out_restores_the_solo_path(monkeypatch, registry,
                                                 slot):
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    lane = executor.synchronous_do_work(_job(7, num_inference_steps=3), slot,
                                        registry)
    assert "stepper" in lane["pipeline_config"]
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    solo = executor.synchronous_do_work(_job(7, num_inference_steps=3), slot,
                                        registry)
    assert solo["pipeline_config"].get("error") is None
    assert "stepper" not in solo["pipeline_config"]
    assert solo["pipeline_config"]["mode"] == "txt2img"
    _close(_png(lane), _png(solo))


def test_executor_falls_back_when_the_lane_faults(monkeypatch, registry,
                                                  slot):
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    get_stepper(slot).inject_fault(after_steps=0, exc=RuntimeError(
        "injected mid-lane crash"))
    result = executor.synchronous_do_work(_job(9, num_inference_steps=3),
                                          slot, registry)
    cfg = result["pipeline_config"]
    assert cfg.get("error") is None, cfg
    assert "stepper" not in cfg  # served by the per-job path
    assert "fatal_error" not in result
    assert get_stepper(slot).stats()["lanes_failed"] == 1


def test_executor_ineligible_jobs_take_the_solo_path(monkeypatch, registry,
                                                     slot, jax_pipe):
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    r = executor.synchronous_do_work(_job(12, guidance_scale=1.0), slot,
                                     registry)
    assert r["pipeline_config"].get("error") is None
    assert "stepper" not in r["pipeline_config"]
    # a reuse schedule rides the plain lane while DeepCache is off (ignored,
    # as in JAX); switched on, the job rides a DeepCache lane with the
    # accounting JAX's reuse lane gives the same job
    from chiaswarm_tpu.serving.stepper import StepScheduler as JaxScheduler

    monkeypatch.setenv("CHIASWARM_DEEPCACHE", "1")
    job = _job(13, num_inference_steps=3, parameters={"reuse_schedule": [1]})
    r = executor.synchronous_do_work(copy.deepcopy(job), slot, registry)
    assert "error" not in r["pipeline_config"], r
    jax_sched = JaxScheduler()
    try:
        _, jax_lane = jax_sched.submit_request(
            jax_pipe, prompt=job["prompt"], steps=3, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=job["seed"],
            reuse_schedule=[1]).result(timeout=300)
    finally:
        jax_sched.shutdown()
    lane = r["pipeline_config"]["stepper"]
    assert set(lane) == set(jax_lane)
    assert lane["unet_evals"] == jax_lane["unet_evals"] == 2
    assert lane["steps_skipped"] == jax_lane["steps_skipped"] == 1


def test_lane_envelope_matches_the_jax_lane_envelope(monkeypatch, registry,
                                                     slot):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.serving.stepper import get_stepper as jax_stepper

    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    jax_slot = JaxPool(n_slots=1).slots[0]
    jax_registry = JaxRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                               allow_random=True)
    try:
        ref = jax_do_work(_job(5), jax_slot, jax_registry)
    finally:
        jax_stepper(jax_slot).shutdown()
    got = executor.synchronous_do_work(_job(5), slot, registry)
    for result in (got, ref):
        assert "error" not in result["pipeline_config"], result
    assert set(got) == set(ref)
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    assert set(got["pipeline_config"]["stepper"]) == set(
        ref["pipeline_config"]["stepper"])
    for key in ("scheduler", "steps", "denoise_steps", "guidance_scale",
                "size", "compiled_size", "batch", "mode", "seed", "nsfw",
                "safety_checker", "family", "model_name"):
        assert got["pipeline_config"][key] == ref["pipeline_config"][key], key
    assert set(got["artifacts"]) == set(ref["artifacts"])


# ---------------------------------------------------------------------------
# 7. a lane on a seq mesh


def test_lane_on_a_seq_mesh_rings_and_matches_the_solo_slot(monkeypatch,
                                                            registry):
    """A lane on a ``"cpu"`` x 4 seq mesh rings its large self-attentions
    through B3's plain version, from the lane's own thread, and
    agrees with the same lane on a solo slot within one uint8 level."""
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    seq_slot = ChipPool(mesh_spec=MeshSpec({"seq": 4}),
                        devices=["cpu"] * 4).slots[0]
    solo_slot = ChipPool(device="cpu").slots[0]
    jobs = [_job(30, num_inference_steps=3),
            _job(31, num_inference_steps=2, guidance_scale=5.0)]
    try:
        with capture_ring_calls() as rings:
            got = executor.synchronous_do_work_batch(
                [dict(j) for j in jobs], seq_slot, registry)
        solo = executor.synchronous_do_work_batch(
            [dict(j) for j in jobs], solo_slot, registry)
    finally:
        get_stepper(seq_slot).shutdown()
        get_stepper(solo_slot).shutdown()
    # tiny at 64 px: the 1024-token level of every lane step and the VAE
    # mid block of every decode ring
    assert rings and {kind for kind, _ in rings} == {"ring_flash"}
    assert all(shape[1] == 1024 for _, shape in rings)
    steps = get_stepper(seq_slot).stats()["steps_executed"]
    # 3 self-attentions at the 1024-token level per step, 1 per decode
    assert len(rings) == 3 * steps + len(jobs)
    for ours, ref in zip(got, solo):
        assert "stepper" in ours["pipeline_config"], ours
        assert "stepper" in ref["pipeline_config"], ref
        diff = np.abs(_png(ours).astype(np.int16) - _png(ref).astype(np.int16))
        assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
