"""The port's gray-failure guard (``chiaswarm_tpu_torch/serving/guard.py``,
the lanes' checkpoints, condemnation and resume in ``serving/stepper.py``,
the executor's heal, the worker's ladder) against the JAX package, on the
CPU.

- Scripted sequences through both packages' classes, outcomes equal: the
  watchdog firing or disarmed, the budgets (clamps, the cold ceiling, the
  solo budget, the slow factor), the chaos plans
  and their one shots, the ``DeviceGuard`` ladder (escalation, recovery,
  one quarantine a process, disabled), the failure taxonomy.
- The same lane scenarios on ``tiny`` at 64 px in both packages, every normal
  draw pinned to one array on both sides (JAX's ``jax.random.normal`` as the
  lane programs trace it, the executable cache flushed around; the port's
  ``randn_rows``): a wedge gives the same resume step, the same counters and
  images within one uint8 level; a NaN row retires alone while its peer
  completes. Jobs take 4 steps, checkpoints every 2, wedges at lane step 3.
- The port alone, draws unpinned: the executor heals a burst's condemned
  lane, an img2img and an inpaint row under Euler ancestral, each resumed
  image its uninterrupted run bit for bit (DPM-Solver++(2M) txt2img in the
  test beside JAX); a second hang takes the per-job path; a JAX lane
  checkpoint and corrupt payloads are refused and the job restarts at 0.
- The worker: the restart rung returns 73, a one-card slot declines
  quarantine and a data mesh of two devices sheds one, a disabled guard
  counts and never acts, the solo watchdog raises ``StepHung`` (``transient``)
  and notes a solo hang.

Wedges sleep 4 s against budgets of at most max(1 s, 3 x a step's EWMA),
so a loaded CPU cannot turn an honest step into a hang; every lane wait has
a timeout, and every scheduler a test builds is shut down, which joins the
condemned lanes' threads.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import copy
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.node import resilience as jres
from chiaswarm_tpu.obs import metrics as jmetrics
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from chiaswarm_tpu.serving import guard as jguard
from chiaswarm_tpu.serving import stepper as jstepper
from chiaswarm_tpu_torch.core.chip_pool import ChipPool, DeviceSlot
from chiaswarm_tpu_torch.core.mesh import DeviceMesh
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node import resilience as tres
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.obs import metrics as tmetrics
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.serving import guard as tguard
from chiaswarm_tpu_torch.serving import stepper as tstepper

PACKAGES = {"jax": jguard, "torch": tguard}
METRICS = {"jax": jmetrics, "torch": tmetrics}
SIZE = 64
STEPS = 4
WEDGE = "3:4.0"          # lane step 3 sleeps 4 s inside its armed window
CKPT_EVERY = "2"         # so the wedge's rows resume at step 2
LANE_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for the tiny models (the suite's workers share
    the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_guard(monkeypatch, tmp_path):
    """Each test starts with the guard's env unset and both packages'
    one-shot seams re-armed."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    for name in (tguard.ENV_CHAOS_WEDGE, tguard.ENV_CHAOS_SLOW,
                 tguard.ENV_CHAOS_NAN, tguard.ENV_ENABLE,
                 tguard.ENV_HANG_FACTOR, tguard.ENV_HANG_FLOOR,
                 tguard.ENV_HANG_CEIL, tguard.ENV_SLOW_FACTOR,
                 tstepper.ENV_CKPT_EVERY, tstepper.ENV_LANE_WIDTH):
        monkeypatch.delenv(name, raising=False)
    for guard in PACKAGES.values():
        guard.reset_chaos()
    yield
    for guard in PACKAGES.values():
        guard.reset_chaos()


# ---------------------------------------------------------------------------
# 1. scripted sequences through both packages' classes


def _fires(guard) -> list:
    """A scripted watchdog session: what fired and what disarm said."""
    dog = guard.Watchdog()
    fired = []
    quick = dog.arm(0.05, lambda: fired.append("quick"), tag="quick")
    slow = dog.arm(30.0, lambda: fired.append("slow"), tag="slow")
    end = time.monotonic() + 10
    while not fired and time.monotonic() < end:
        time.sleep(0.005)
    out = [list(fired), dog.disarm(quick), dog.disarm(slow),
           dog.disarm(slow), dog.disarm(12345)]
    time.sleep(0.05)
    return out + [list(fired)]


def test_watchdog_fires_and_disarms_alike():
    want = [["quick"], True, False, False, False, ["quick"]]
    assert _fires(jguard) == _fires(tguard) == want


@pytest.mark.parametrize("env", [
    {},
    {"FACTOR": "10", "FLOOR_S": "2", "CEIL_S": "50"},
    {"FACTOR": "3", "FLOOR_S": "0.2", "CEIL_S": "0.1"},   # ceil < floor
    {"FACTOR": "junk", "FLOOR_S": "", "CEIL_S": "7"},      # bad values
    {"FACTOR": "0", "FLOOR_S": "-1", "CEIL_S": "0"},       # zeros, negative
    {"FACTOR": "1e3", "FLOOR_S": "1e-3", "CEIL_S": "1e6"},  # wide open
])
def test_budgets_match_jax(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(f"CHIASWARM_GUARD_HANG_{key}", value)
    monkeypatch.setenv(tguard.ENV_SLOW_FACTOR, env.get("FACTOR", "0.5"))
    for ewma in (0.0, 0.001, 0.01, 0.5, 1.0, 100.0):
        assert tguard.hang_budget_s(ewma) == jguard.hang_budget_s(ewma)
        for steps in (0, 1, 20, None):
            assert tguard.solo_hang_budget_s(ewma, steps) == \
                jguard.solo_hang_budget_s(ewma, steps)
    assert tguard.slow_factor() == jguard.slow_factor()
    # cold: the ceiling, so a first dispatch's warm-up is never condemned
    assert tguard.hang_budget_s(0.0) == max(
        tguard.hang_budget_s(1e9), tguard.hang_budget_s(0.0))


@pytest.mark.parametrize("wedge,nan,slow", [
    ("3:2.5", "4:1", "3.0"),
    ("garbage", "x:y", "no"),
    ("", "7:0", ""),
    ("1:0.5", "", "1.5"),
])
def test_chaos_plans_parse_and_one_shot_alike(monkeypatch, wedge, nan, slow):
    monkeypatch.setenv(tguard.ENV_CHAOS_WEDGE, wedge)
    monkeypatch.setenv(tguard.ENV_CHAOS_NAN, nan)
    monkeypatch.setenv(tguard.ENV_CHAOS_SLOW, slow)

    def script(guard):
        plan = guard.LaneChaos.from_env()
        out = [plan.wedge_step, plan.wedge_s, plan.slow_mult, plan.nan_step,
               plan.nan_row, plan.armed]
        out += [plan.wedge_at(step) for step in range(6)]
        out += [plan.wedge_at(3), plan.nan_wants(3), plan.nan_wants(9),
                guard.consume_chaos("nan"), guard.consume_chaos("nan"),
                plan.slow_extra_s(0.1)]
        guard.reset_chaos()
        out.append(guard.consume_chaos("nan"))
        return out

    assert script(tguard) == script(jguard)


SEQUENCES = {
    # (event, devices) — "ok", "hang", "solo", "invalid", "slow", "take"
    "escalates_and_recovers": (
        dict(cache_flush_after=3, quarantine_after=5, restart_after=7),
        [("hang", "3"), ("take",), ("invalid", "3"), ("take",),
         ("hang", "3"), ("take",), ("hang", "3"), ("take",), ("hang", "3"),
         ("take",)] + [("ok", "3")] * 20 + [("hang", "3"), ("hang", "3"),
                                            ("take",)]),
    "one_quarantine_a_process": (
        dict(cache_flush_after=2, quarantine_after=4, restart_after=6),
        [("hang", "0123"), ("take",), ("hang", "0123"), ("take",),
         ("hang", "0123"), ("take",)]),
    "the_smoke_thresholds": (
        dict(cache_flush_after=1, quarantine_after=2, restart_after=3),
        [("hang", "0"), ("take",), ("ok", "0"), ("hang", "0"), ("take",),
         ("solo", "0"), ("slow", "0"), ("take",)]),
    "disabled": (
        dict(enabled=False, cache_flush_after=1, quarantine_after=2,
             restart_after=3),
        [("hang", "0")] * 5 + [("invalid", "0"), ("take",)]),
    "clamped_thresholds": (
        dict(cache_flush_after=0, quarantine_after=-3, restart_after=1),
        [("slow", "7"), ("take",), ("slow", "7"), ("take",)]),
}


def _run_ladder(guard, metrics, kwargs, events) -> tuple:
    registry = metrics.Registry()
    dg = guard.DeviceGuard(metrics_registry=registry, **kwargs)
    dg.seed_devices(["0", "3"])
    trail = [dg.health_scores()]
    for event in events:
        kind, devices = event[0], list(event[1]) if len(event) > 1 else []
        if kind == "take":
            trail.append([(a.rung, a.device, a.reason)
                          for a in dg.take_actions()])
        elif kind == "ok":
            dg.note_ok(devices)
        elif kind == "hang":
            dg.note_hang(devices)
            dg.note_condemned()
        elif kind == "solo":
            dg.note_hang(devices, phase="solo")
        elif kind == "invalid":
            dg.note_invalid_output(devices, model="tiny")
        elif kind == "slow":
            dg.note_slow_step(devices)
        trail.append(dg.health_scores())
    guard_lines = [line for line in registry.render().splitlines()
                   if "chiaswarm_guard_" in line]
    return trail, dg.snapshot(), guard_lines


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_device_guard_ladders_match_jax(name):
    kwargs, events = SEQUENCES[name]
    torch_out = _run_ladder(tguard, tmetrics, kwargs, events)
    assert torch_out == _run_ladder(jguard, jmetrics, kwargs, events)
    trail, snap, lines = torch_out
    rungs = [rung for step in trail if isinstance(step, list)
             for rung, _, _ in step]
    if name == "disabled":
        assert rungs == [] and snap["hangs"] == 5
    else:
        assert "restart" in rungs and snap["restart_requested"]
        assert rungs.count("device_quarantine") == 1
        assert len(snap["quarantined"]) == 1
    assert 'chiaswarm_guard_heal_rung_total{rung="restart"}' in "\n".join(
        lines)


def test_failure_taxonomy_matches_jax():
    for exc in (tguard.StepHung("x"), tguard.LaneHung("x"),
                tguard.InvalidOutput("x"), jguard.StepHung("x"),
                jguard.LaneHung("x", resume={"step": 1}),
                jguard.InvalidOutput("x")):
        assert tres.classify_exception(exc) == jres.classify_exception(exc)
    assert tres.classify_exception(tguard.StepHung("x")) == "transient"
    assert tres.classify_exception(tguard.LaneHung("x")) == "transient"
    assert tres.classify_exception(tguard.InvalidOutput("x")) == \
        "invalid_output"
    for kinds in ("RETRYABLE_KINDS", "BREAKER_KINDS", "REDISPATCH_KINDS",
                  "NONFATAL_KINDS"):
        assert getattr(tres, kinds) == getattr(jres, kinds)
    assert tguard.HEAL_RUNGS == jguard.HEAL_RUNGS
    assert tguard.EVENT_WEIGHTS == jguard.EVENT_WEIGHTS
    assert tguard.GUARD_RESTART_EXIT_CODE == jguard.GUARD_RESTART_EXIT_CODE
    envelope = executor.error_result({"id": "g1", "content_type":
                                      "application/json"},
                                     tguard.InvalidOutput("nan"),
                                     kind="invalid_output")
    assert "fatal_error" not in envelope
    assert tres.classify_result(envelope) == "invalid_output"


def test_slot_devices_are_distinct_torch_devices():
    ring = ChipPool(n_slots=1, mesh_spec=tstepper_mesh_spec(seq=4),
                    devices=["cpu"] * 4).slots[0]
    assert tguard._slot_devices(ring) == ["cpu"]
    two = DeviceSlot(index=0, mesh=DeviceMesh(("data",), np.array(
        [torch.device("cuda", 0), torch.device("cuda", 1)], dtype=object)))
    assert tguard._slot_devices(two) == ["cuda:0", "cuda:1"]
    assert tguard._slot_devices(object()) == []


def tstepper_mesh_spec(**axes):
    from chiaswarm_tpu_torch.core.mesh import MeshSpec

    return MeshSpec(axes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_packed_tensors_round_trip_bit_for_bit(dtype):
    t = (torch.randn(2, 4, 3, 5) * 100).to(dtype)
    spec = tstepper.pack_array(t)
    back = tstepper.unpack_array(spec)
    assert back.dtype == dtype and back.shape == t.shape
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
    # numpy arrays pack as the JAX package packs them
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert tstepper.pack_array(a) == jstepper.pack_array(a)


# ---------------------------------------------------------------------------
# 2. lanes on tiny: both packages, draws pinned


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(JaxComponents.random("tiny", seed=0))


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    params = jax.tree.map(np.asarray, jax_pipe.c.params)
    return tdiff.DiffusionPipeline(Components.from_jax(params, "tiny",
                                                       device="cpu"))


PINNED = np.random.default_rng(12).standard_normal(
    (SIZE // 2, SIZE // 2, 4)).astype(np.float32)
_PINNED_REFERENCE: list = []


def _pinned_port_reference(port_pipe) -> np.ndarray:
    """The port's uninterrupted lane image of the wedge job on ``PINNED``
    (made once; call it under ``_pinned_init_noise``)."""
    if not _PINNED_REFERENCE:
        with _scheduler(tstepper.StepScheduler) as ref:
            _PINNED_REFERENCE.append(_image(_submit(ref, port_pipe))[0])
    return _PINNED_REFERENCE[0]


@contextlib.contextmanager
def _pinned_init_noise(monkeypatch, jax_pipe, port_pipe, noise: np.ndarray):
    """Every row's initial noise in both packages is ``noise`` (H, W, C):
    the JAX lane's row-init program keeps its carry keys and returns
    ``noise * sigma``; the port's ``stepper_row_init`` returns the same.
    DPM-Solver++(2M) draws nothing else."""
    real = jax_pipe.stepper_row_init_fn

    def jax_row_init_fn(**shape):
        fn = real(**shape)

        def row_init(keys, sigma):
            carry, x0 = fn(keys, sigma)
            return carry, jnp.broadcast_to(jnp.asarray(noise),
                                           x0.shape) * sigma
        return row_init

    def port_row_init(generators, sigma0, height, width):
        one = torch.from_numpy(noise).permute(2, 0, 1)
        return torch.stack([one] * len(generators)) * sigma0

    monkeypatch.setattr(jax_pipe, "stepper_row_init_fn", jax_row_init_fn)
    monkeypatch.setattr(port_pipe, "stepper_row_init", port_row_init)
    yield


@contextlib.contextmanager
def _scheduler(cls, slot=None):
    sched = cls(slot)
    try:
        yield sched
    finally:
        sched.shutdown()


def _submit(sched, pipe, seed=404, **over):
    kw = dict(prompt="wedge me", negative_prompt="blurry", steps=STEPS,
              guidance_scale=7.5, height=SIZE, width=SIZE, rows=1, seed=seed)
    kw.update(over)
    return sched.submit_request(pipe, **kw)


def _image(future) -> np.ndarray:
    pending, info = future.result(timeout=LANE_TIMEOUT)
    return pending.wait(), info


def _arm_wedge(monkeypatch) -> None:
    monkeypatch.setenv(tguard.ENV_HANG_FACTOR, "3")
    monkeypatch.setenv(tguard.ENV_HANG_FLOOR, "1")
    monkeypatch.setenv(tguard.ENV_CHAOS_WEDGE, WEDGE)
    for guard in PACKAGES.values():
        guard.reset_chaos()


def _wedge_then_resume(sched, pipe, hung_cls, monkeypatch, **job):
    """A lane whose step 3 wedges: the job's future fails with ``hung_cls``
    carrying the step-2 checkpoint; resubmitted with it, the job resumes
    at step 2 in a fresh lane. Returns (resume, image, info, stats)."""
    _arm_wedge(monkeypatch)
    with pytest.raises(hung_cls) as excinfo:
        _submit(sched, pipe, **job).result(timeout=LANE_TIMEOUT)
    resume = excinfo.value.resume
    monkeypatch.delenv(tguard.ENV_CHAOS_WEDGE)
    img, info = _image(_submit(sched, pipe, resume=resume, **job))
    return resume, img, info, sched.stats()


GUARD_COUNTERS = ("lanes_condemned", "rows_hung", "rows_resumed",
                  "rows_completed", "rows_invalid", "resumes_rejected")


def test_a_wedged_lane_resumes_alike_in_both_packages(jax_pipe, port_pipe,
                                                      monkeypatch):
    """The lane-rebuild gate in both packages on the same initial noise
    (DPM-Solver++(2M)): the wedge condemns the lane, the checkpoint is step
    2 in both, the counters are equal, the port's resumed image is its
    uninterrupted run bit for bit (the JAX package's own
    ``tests/test_guard.py`` holds JAX's), and the two packages' resumed
    images agree within one uint8 level."""
    monkeypatch.setenv(tstepper.ENV_CKPT_EVERY, CKPT_EVERY)
    out = {}
    with _pinned_init_noise(monkeypatch, jax_pipe, port_pipe, PINNED):
        ref_img = _pinned_port_reference(port_pipe)
        for name, cls, pipe in (("jax", jstepper.StepScheduler, jax_pipe),
                                ("torch", tstepper.StepScheduler,
                                 port_pipe)):
            with _scheduler(cls) as sched:
                resume, img, info, stats = _wedge_then_resume(
                    sched, pipe, PACKAGES[name].LaneHung, monkeypatch)
            out[name] = (resume, np.asarray(img), info, stats)
    for name, (resume, img, info, stats) in out.items():
        assert resume["kind"] == "lane" and int(resume["step"]) == 2, name
        assert info["resume_step"] == 2, name
        assert img.std() > 1.0
    assert np.array_equal(out["torch"][1], ref_img)
    j, t = out["jax"], out["torch"]
    assert {k: t[0][k] for k in t[0]
            if k not in ("x", "old", "generators", "slots")} \
        == {k: j[0][k] for k in j[0] if k not in ("x", "old", "keys")}
    assert {k: t[3].get(k, 0) for k in GUARD_COUNTERS} == \
        {k: j[3].get(k, 0) for k in GUARD_COUNTERS}
    assert t[3]["lanes_condemned"] == 1 and t[3]["rows_resumed"] == 1
    diff = np.abs(t[1].astype(np.int16) - j[1].astype(np.int16))
    assert diff.max() <= 1, diff.max()
    # the checkpoint carries the JAX envelope's keys, the port's noise
    # state and the rows' slots beside them
    assert set(t[0]) - set(j[0]) == {"generators", "slots"}
    assert set(j[0]) - set(t[0]) == {"keys"}


def test_a_nan_row_retires_alone_in_both_packages(jax_pipe, port_pipe,
                                                  monkeypatch):
    """Row 1 poisoned after step 1: its job retires ``InvalidOutput`` at the
    next checkpoint while row 0's job completes, with the same counters in
    both packages and images within one uint8 level."""
    monkeypatch.setenv(tstepper.ENV_CKPT_EVERY, CKPT_EVERY)
    monkeypatch.setenv(tstepper.ENV_LANE_WIDTH, "2")
    noise = np.random.default_rng(13).standard_normal(
        (SIZE // 2, SIZE // 2, 4)).astype(np.float32)
    out = {}
    with _pinned_init_noise(monkeypatch, jax_pipe, port_pipe, noise):
        for name, cls, pipe in (("jax", jstepper.StepScheduler, jax_pipe),
                                ("torch", tstepper.StepScheduler,
                                 port_pipe)):
            monkeypatch.setenv(tguard.ENV_CHAOS_NAN, "1:1")
            PACKAGES[name].reset_chaos()
            with _scheduler(cls) as sched:
                survivor = _submit(sched, pipe, prompt="survivor", seed=72)
                doomed = _submit(sched, pipe, prompt="poisoned", seed=71)
                with pytest.raises(PACKAGES[name].InvalidOutput):
                    doomed.result(timeout=LANE_TIMEOUT)
                img, _ = _image(survivor)
                out[name] = (np.asarray(img), sched.stats())
    j, t = out["jax"], out["torch"]
    assert {k: t[1].get(k, 0) for k in GUARD_COUNTERS} == \
        {k: j[1].get(k, 0) for k in GUARD_COUNTERS}
    assert t[1]["rows_invalid"] == 1 and t[1].get("lanes_condemned", 0) == 0
    assert t[1]["rows_completed"] == 1
    assert np.abs(t[0].astype(np.int16) - j[0].astype(np.int16)).max() <= 1
    assert t[0].std() > 1.0


# ---------------------------------------------------------------------------
# 3. the port's own lanes, draws unpinned


def _init_image(seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (SIZE, SIZE, 3),
                                                dtype=np.uint8)


def _rect_mask() -> np.ndarray:
    mask = np.zeros((SIZE, SIZE), np.float32)
    mask[SIZE // 4: 3 * SIZE // 4, SIZE // 8: SIZE // 2] = 1.0
    return mask


def test_a_jax_lane_checkpoint_is_refused_and_the_job_restarts_at_0(
        jax_pipe, port_pipe, monkeypatch):
    """A JAX lane checkpoint of the same job (threefry keys, NHWC latents)
    is refused loudly: its noise stream is not the port's. The job restarts
    at step 0 and renders its uninterrupted image; the refusal is
    counted."""
    monkeypatch.setenv(tstepper.ENV_CKPT_EVERY, CKPT_EVERY)
    with _pinned_init_noise(monkeypatch, jax_pipe, port_pipe, PINNED), \
            _scheduler(tstepper.StepScheduler) as sched:
        ref_img = _pinned_port_reference(port_pipe)
        x = np.random.default_rng(0).standard_normal(
            (1, SIZE // 2, SIZE // 2, 4)).astype(np.float32)
        jax_payload = dict(_payload(), x=jstepper.pack_array(x),
                           old=jstepper.pack_array(np.zeros_like(x)),
                           keys=jstepper.pack_array(
                               np.zeros((1, 2), np.uint32)))
        del jax_payload["generators"]
        img, info = _image(_submit(sched, port_pipe, resume=jax_payload))
        assert info["resume_step"] == 0
        assert np.array_equal(img, ref_img)
        stats = sched.stats()
    assert stats["resumes_rejected"] == 1
    assert stats.get("rows_resumed", 0) == 0


def _payload(**changes) -> dict:
    """A well-formed port checkpoint of the 64 px tiny job at step 2."""
    payload = {
        "version": tstepper.CKPT_VERSION, "kind": "lane", "step": 2,
        "steps": STEPS, "rows": 1, "height": SIZE, "width": SIZE,
        "guidance": 7.5, "workload": "txt2img", "start": 0,
        "x": tstepper.pack_array(torch.randn(1, 4, SIZE // 2, SIZE // 2)),
        "old": tstepper.pack_array(torch.zeros(1, 4, SIZE // 2, SIZE // 2)),
        "generators": [tstepper.pack_array(torch.Generator().get_state())],
    }
    payload.update(changes)
    return {k: v for k, v in payload.items() if v is not None}


def _validate(port_pipe, payload):
    return tstepper.StepScheduler()._validate_resume(
        port_pipe, payload, steps=STEPS, rows=1, height=SIZE, width=SIZE,
        guidance=7.5, start=0, workload="txt2img")


BAD_PAYLOADS = {
    "jax_keys": dict(keys=tstepper.pack_array(np.zeros((1, 2), np.uint32))),
    "no_generators": dict(generators=None),
    "not_a_lane": dict(kind="phase"),
    "step_at_the_end": dict(step=STEPS),
    "step_at_the_start": dict(step=0),
    "other_guidance": dict(guidance=5.0),
    "other_rows": dict(rows=2),
    "other_steps": dict(steps=STEPS + 1),
    "other_size": dict(height=128),
    "other_workload": dict(workload="img2img"),
    "corrupt_bytes": dict(x={"dtype": "float32", "shape": [1, 4],
                             "b64": "!!"}),
    "missing_old": dict(old=None),
    "latent_shape": dict(x=tstepper.pack_array(torch.zeros(1, 4, 8, 8))),
    "nhwc_latents": dict(x=tstepper.pack_array(
        torch.zeros(1, SIZE // 2, SIZE // 2, 4))),
    "history_dtype": dict(old=tstepper.pack_array(torch.zeros(
        1, 4, SIZE // 2, SIZE // 2, dtype=torch.float64))),
    "bf16_latents": dict(x=tstepper.pack_array(torch.zeros(
        1, 4, SIZE // 2, SIZE // 2, dtype=torch.bfloat16))),
    "short_generator_state": dict(generators=[tstepper.pack_array(
        torch.zeros(3, dtype=torch.uint8))]),
    "generator_count": dict(generators=[]),
}


def test_a_well_formed_payload_validates(port_pipe):
    restored = _validate(port_pipe, _payload())
    assert restored["step"] == 2 and len(restored["generators"]) == 1
    assert restored["x"].shape == (1, 4, SIZE // 2, SIZE // 2)


@pytest.mark.parametrize("name", sorted(BAD_PAYLOADS))
def test_corrupt_or_foreign_payloads_are_refused(port_pipe, name):
    with pytest.raises(tstepper.ResumeReject):
        _validate(port_pipe, _payload(**BAD_PAYLOADS[name]))


@pytest.fixture()
def tiny_slot(monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv(tstepper.ENV_CKPT_EVERY, CKPT_EVERY)
    registry = ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    slot = ChipPool(device="cpu").slots[0]
    slot._guard = tguard.DeviceGuard(metrics_registry=tmetrics.Registry())
    yield registry, slot
    tstepper.get_stepper(slot).shutdown()


def _job(i: int = 0, **over) -> dict:
    job = {"id": f"heal-{i}", "model_name": "tiny", "prompt": f"heal {i}",
           "seed": 500 + i, "num_inference_steps": STEPS,
           "guidance_scale": 7.5, "height": SIZE, "width": SIZE,
           "content_type": "image/png"}
    job.update(over)
    return job


def _png(result) -> np.ndarray:
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_a_second_hang_takes_the_per_job_path(tiny_slot, monkeypatch):
    """The heal is one re-admission: when the fresh lane wedges too, the
    job runs on the per-job path and still succeeds."""
    registry, slot = tiny_slot
    condemn = tstepper.Lane.condemn
    rearmed = []

    def condemn_and_rearm(lane, reason):
        condemn(lane, reason)
        if not rearmed:  # the fresh lane's step 3 wedges as well
            rearmed.append(lane.lane_id)
            tguard.reset_chaos()

    monkeypatch.setattr(tstepper.Lane, "condemn", condemn_and_rearm)
    tstepper.get_stepper(slot).note_step_seconds(0.3)
    _arm_wedge(monkeypatch)
    # a floor above the suite's slowest honest tiny step (one outran a 1.3 s
    # budget beside five loaded workers), so only the wedge, which sleeps
    # far past it, condemns a lane
    monkeypatch.setenv(tguard.ENV_HANG_FLOOR, "3")
    monkeypatch.setenv(tguard.ENV_CHAOS_WEDGE, "3:10.0")
    tguard.reset_chaos()
    # 6 steps: the fresh lane, resumed at 2, reaches its own step 3
    result = executor.synchronous_do_work(_job(1, num_inference_steps=6),
                                          slot, registry)
    cfg = result["pipeline_config"]
    assert cfg.get("error") is None, cfg
    assert "stepper" not in cfg  # the solo path's envelope
    assert tstepper.get_stepper(slot).stats()["lanes_condemned"] == 2
    assert slot._guard.snapshot()["hangs"] == 2


def test_the_executor_heals_a_condemned_lane_transparently(tiny_slot,
                                                           monkeypatch):
    """A burst of an img2img and an inpaint job under Euler ancestral shares
    a lane that wedges: the callers see two successes stamped with resume
    steps past their start indices, both re-admitted to one fresh lane, each
    image its uninterrupted run bit for bit (the checkpoint carried each
    row's generator state, so the step noise and the inpaint renoise resume
    on their streams; the img2img row kept its start index, the inpaint row
    re-derived ``known`` and its mask); the slot's guard heard one lane hang
    and one condemnation."""
    registry, slot = tiny_slot
    monkeypatch.setenv(tstepper.ENV_LANE_WIDTH, "2")
    ancestral = {"scheduler_type": "EulerAncestralDiscreteScheduler"}
    jobs = [_job(0, image=_init_image(13), strength=0.75,  # start index 2
                 num_inference_steps=6, parameters=dict(ancestral)),
            _job(1, mask_image=(np.stack([_rect_mask()] * 3, -1)
                                * 255).astype(np.uint8),
                 image=_init_image(), parameters=dict(ancestral))]
    # the formatter pops from a job's nested parameters: copy deeply
    ref = executor.synchronous_do_work_batch(copy.deepcopy(jobs), slot,
                                             registry)
    tstepper.get_stepper(slot).shutdown()
    _arm_wedge(monkeypatch)
    healed = executor.synchronous_do_work_batch(copy.deepcopy(jobs), slot,
                                                registry)
    stats = tstepper.get_stepper(slot).stats()
    assert stats["lanes_condemned"] == 1 and stats["rows_resumed"] == 2
    lanes = set()
    for before, after in zip(ref, healed):
        cfg = after["pipeline_config"]
        assert cfg.get("error") is None, cfg
        assert cfg["scheduler"] == "euler_ancestral"
        start = cfg["steps"] - cfg["denoise_steps"]
        assert cfg["stepper"]["resume_step"] > start
        lanes.add(cfg["stepper"]["lane"])
        assert np.array_equal(_png(after), _png(before))
    assert len(lanes) == 1
    assert [r["pipeline_config"]["mode"] for r in healed] == \
        ["img2img", "inpaint"]
    assert healed[0]["pipeline_config"]["denoise_steps"] == 4
    snap = slot._guard.snapshot()
    assert snap["hangs"] == 1 and snap["condemned_lanes"] == 1


def test_a_burst_collects_each_lane_job_as_its_rows_retire(tiny_slot,
                                                          monkeypatch):
    """The executor collects a burst's lane jobs in order, each as soon as
    its own rows retire: a short job's decode, PNG and base64 run while a
    longer job's rows are still stepping, so its ``generation_s`` and
    ``step`` span hold its own lane residency only."""
    from chiaswarm_tpu_torch.workloads import diffusion as tworkload

    registry, slot = tiny_slot
    tickets, seen = [], []
    submit, finish = tworkload.stepper_submit, tworkload.stepper_finish

    def recording_submit(*args, **kwargs):
        tickets.append(submit(*args, **kwargs))
        return tickets[-1]

    def recording_finish(ticket):
        ticket.future.result(timeout=LANE_TIMEOUT)
        seen.append([t.future.done() for t in tickets])
        return finish(ticket)

    monkeypatch.setattr(tworkload, "stepper_submit", recording_submit)
    monkeypatch.setattr(tworkload, "stepper_finish", recording_finish)
    jobs = [_job(0), _job(1, num_inference_steps=8)]
    out = executor.synchronous_do_work_batch(jobs, slot, registry)
    cfgs = [r["pipeline_config"] for r in out]
    assert all(cfg.get("error") is None and "stepper" in cfg
               for cfg in cfgs), cfgs
    assert seen == [[True, False], [True, True]]
    assert cfgs[0]["generation_s"] < cfgs[1]["generation_s"]


# ---------------------------------------------------------------------------
# 4. the worker


def _worker(pool, **settings) -> tworker.Worker:
    base = dict(hive_uri="http://127.0.0.1:9", hive_token="t",
                worker_name="guard-w", install_signal_handlers=False,
                poll_busy_s=0.02, poll_idle_s=0.02)
    base.update(settings)
    return tworker.Worker(settings=tsettings.Settings(**base), pool=pool,
                          registry=ModelRegistry(catalog=[],
                                                 allow_random=True,
                                                 device="cpu"))


def test_the_restart_rung_drains_and_returns_73(monkeypatch):
    """Through ``run_worker``: hangs queue cache_flush, a declined
    quarantine and restart; the next poll applies them in order, the
    worker drains gracefully and returns 73."""
    from tests.fake_hive import FakeHive

    applied = []

    class CpuWorker(tworker.Worker):
        def __init__(self, settings):
            super().__init__(settings, pool=ChipPool(device="cpu"),
                             registry=ModelRegistry(catalog=[],
                                                    allow_random=True,
                                                    device="cpu"))
            self.guard.note_hang(["cpu"])
            self.guard.note_ok(["cpu"])
            self.guard.note_hang(["cpu"])
            applied.append(self)

    monkeypatch.setattr(tworker, "Worker", CpuWorker)

    async def scenario():
        hive = FakeHive()
        uri = await hive.start()
        try:
            return await asyncio.wait_for(tworker.run_worker(
                tsettings.Settings(
                    hive_uri=uri, hive_token="t", worker_name="guard-73",
                    install_signal_handlers=False, poll_idle_s=0.02,
                    guard_cache_flush_after=1, guard_quarantine_after=2,
                    guard_restart_after=3)), timeout=60)
        finally:
            await hive.stop()

    epoch = tguard.flush_epoch()
    assert asyncio.run(scenario()) == 73
    worker = applied[0]
    assert worker.guard.restart_requested and worker.exit_code == 73
    assert tguard.flush_epoch() == epoch + 1
    body = worker.metrics.render()
    for rung in ("cache_flush", "device_quarantine", "restart"):
        assert f'chiaswarm_guard_heal_rung_total{{rung="{rung}"}} 1' in body
    assert worker.guard.health_scores() == {"cpu": 0.0}
    assert "chiaswarm_stepper_lanes_condemned_total 0" in body


def test_a_one_card_slot_declines_quarantine_and_escalates():
    worker = _worker(ChipPool(device="cpu"), guard_cache_flush_after=1,
                     guard_quarantine_after=2, guard_restart_after=4)
    slot = worker.pool.slots[0]
    assert slot._guard is worker.guard
    assert worker.guard.health_scores() == {"cpu": 1.0}
    mesh = slot.mesh
    worker.guard.note_hang(["cpu"])
    worker._apply_heal_rungs()
    assert slot.mesh is mesh and worker.exit_code == 0
    assert worker.guard.snapshot()["quarantined"] == ["cpu"]
    worker.guard.note_hang(["cpu"])
    worker._apply_heal_rungs()
    assert worker.exit_code == tguard.GUARD_RESTART_EXIT_CODE
    assert worker._stop.is_set()


def test_quarantine_sheds_one_device_of_a_data_mesh(monkeypatch):
    """A slot whose data mesh spans two devices drops the sick one (the
    ``test_quarantine_amputates_at_most_one_chip_per_process`` rule: the
    other stays); built here from device labels alone."""
    import chiaswarm_tpu_torch.core.mesh as tmesh

    monkeypatch.setattr(tmesh, "resolve_device", torch.device)
    mesh = DeviceMesh(("data",), np.array(
        [torch.device("cuda", 0), torch.device("cuda", 1)], dtype=object))
    slot = DeviceSlot(index=0, mesh=mesh)
    worker = _worker([slot], guard_cache_flush_after=1,
                     guard_quarantine_after=2, guard_restart_after=6)
    worker.guard.note_hang(["cuda:0", "cuda:1"])
    worker._apply_heal_rungs()
    assert tguard._slot_devices(slot) == ["cuda:1"]
    assert slot.device == torch.device("cuda", 1) and slot.data_width == 1
    assert worker.guard.snapshot()["quarantined"] == ["cuda:0"]
    assert worker.exit_code == 0


def test_a_disabled_guard_counts_and_never_acts():
    worker = _worker(ChipPool(device="cpu"), guard_enabled=False,
                     guard_cache_flush_after=1, guard_quarantine_after=1,
                     guard_restart_after=1)
    epoch = tguard.flush_epoch()
    for _ in range(4):
        worker.guard.note_hang(["cpu"])
    worker._apply_heal_rungs()
    assert worker.exit_code == 0 and not worker._stop.is_set()
    assert tguard.flush_epoch() == epoch
    snap = worker.guard.snapshot()
    assert snap["hangs"] == 4 and not snap["enabled"]
    assert snap["quarantined"] == [] and not snap["restart_requested"]


def test_the_solo_watchdog_raises_stephung_and_notes_health(monkeypatch):
    """A warm key's solo call past its budget raises ``StepHung`` once it
    returns (``transient`` in the executor's envelope) and the guard hears
    a solo hang; a key's first call, a fast call and a cold slot are never
    flagged."""
    class FakeStepper:
        @staticmethod
        def step_ewma():
            return 0.01

    slot = ChipPool(device="cpu").slots[0]
    slot._stepper = FakeStepper()
    slot._guard = tguard.DeviceGuard(metrics_registry=tmetrics.Registry())
    monkeypatch.setenv(tguard.ENV_HANG_FACTOR, "1")
    monkeypatch.setenv(tguard.ENV_HANG_FLOOR, "0.05")
    monkeypatch.setenv(tguard.ENV_HANG_CEIL, "2")
    with tguard.watch_solo(slot, steps=5, key=("m", 64, 64)):
        time.sleep(0.3)                      # first call: the ceiling
    assert slot._guard.snapshot()["hangs"] == 0

    def slow_callback(slot_, model_name, *, seed, **kwargs):
        time.sleep(0.5)
        return {}, {}

    slow_callback.__name__ = "diffusion_callback"
    result = executor._execute("solo-1", "image/png", slow_callback,
                               {"model_name": "m", "height": 64,
                                "width": 64, "num_inference_steps": 5,
                                "seed": 1}, slot)
    assert result["pipeline_config"]["error_kind"] == "transient"
    assert result["pipeline_config"]["error_class"] == "StepHung"
    assert tres.classify_result(result) == "transient"
    snap = slot._guard.snapshot()
    assert snap["hangs"] == 1
    with tguard.watch_solo(slot, steps=5, key=("other", 64, 64)):
        time.sleep(0.3)                      # another key: its own first
    with tguard.watch_solo(slot, steps=5, key=("m", 64, 64)):
        pass
    slot._stepper = type("S", (), {"step_ewma": staticmethod(
        lambda: 0.0)})()
    with tguard.watch_solo(slot, steps=5, key=("m", 64, 64)):
        time.sleep(0.2)                      # cold: never armed
    assert slot._guard.snapshot()["hangs"] == 1
    # the cache_flush rung re-colds the warm keys
    tguard.note_cache_flush()
    slot._stepper = FakeStepper()
    with tguard.watch_solo(slot, steps=5, key=("m", 64, 64)):
        time.sleep(0.3)
    assert slot._guard.snapshot()["hangs"] == 1
