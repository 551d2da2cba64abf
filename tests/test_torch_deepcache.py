"""DeepCache feature reuse in the port (``CHIASWARM_DEEPCACHE``, a job's
``reuse_schedule``) and its quality gate, against the JAX package.

- ``normalize_reuse_schedule`` pinned to JAX's, errors included.
- The UNet seam (``return_deep`` and ``cached_deep``) against JAX's on the
  tiny SD-class and SDXL-class UNets within 2e-4, and JAX's refusals.
- A solo ``every:2`` job against JAX's solo DeepCache job on the same
  injected noise: one uint8 level, config keys equal (``unet_evals``,
  ``steps_skipped``, ``reuse_schedule``).
- ``obs/quality.py`` pinned to JAX's on random images, and the tiny
  family's quality gate at 10 steps (JAX's ``test_deepcache_quality_gate``).
- The lanes: a reuse lane against its solo twin bit for bit with the
  counters moving; lane mates that never want reuse at the same step run
  full evals only; a checkpoint taken mid-schedule resumes bit for bit; a
  tampered schedule restarts clean.
- ControlNet and instruct-pix2pix keep reuse out with JAX's messages.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.models.configs import FAMILIES as JFAMILIES
from chiaswarm_tpu.models.unet import UNet as JaxUNet
from chiaswarm_tpu.obs import quality as jquality
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu_torch.models.configs import FAMILIES
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.obs import metrics as tmetrics
from chiaswarm_tpu_torch.obs import quality as tquality
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import ControlNetBundle
from chiaswarm_tpu_torch.serving import stepper as tstepper
from chiaswarm_tpu_torch.serving.stepper import StepScheduler
from tests.test_torch_quantize import jax_twin, port_twin


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _deepcache_on(monkeypatch):
    monkeypatch.setenv("CHIASWARM_DEEPCACHE", "1")
    monkeypatch.delenv("CHIASWARM_ACTIVATIONS", raising=False)
    monkeypatch.delenv("CHIASWARM_WEIGHTS", raising=False)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's twin of the port's seeded ``tiny`` weights."""
    return jax_twin("tiny")


@pytest.fixture(scope="module")
def jax_params(jax_tiny):
    """Per tiny family, the JAX twin's params (built once)."""
    cache = {"tiny": jax_tiny.params}

    def get(family: str):
        if family not in cache:
            cache[family] = jax_twin(family).params
        return cache[family]

    return get


@pytest.fixture(scope="module")
def port_pipe():
    return tdiff.DiffusionPipeline(port_twin("tiny"))


@contextlib.contextmanager
def scheduler(slot=None):
    sched = StepScheduler(slot)
    try:
        yield sched
    finally:
        sched.shutdown()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# 1. the schedule

@pytest.mark.parametrize("args", [
    (8, (4, 2, 4)), (8, "every:2"), (8, "every:3", 2), (8, ()),
    (20, " EVERY:2 "), (20, [19, 1]), (8, (0,)), (8, (8,)), (8, (2,), 2),
    (8, "every:1"), (8, "every:x"), (8, "sometimes"), (8, 2),
    (8, [None, 2]),
])
def test_normalize_reuse_schedule_matches_jax(args):
    try:
        want = jdiff.normalize_reuse_schedule(*args)
    except ValueError as exc:
        with pytest.raises(ValueError) as info:
            tdiff.normalize_reuse_schedule(*args)
        assert str(info.value) == str(exc)
    else:
        assert tdiff.normalize_reuse_schedule(*args) == want


# ---------------------------------------------------------------------------
# 2. the UNet seam

@pytest.mark.parametrize("family", ["tiny", "tiny_xl"])
def test_unet_seam_matches_jax(jax_params, family):
    fam = FAMILIES[family]
    params = jax_params(family)
    unet = port_twin(family).unet
    jax_unet = JaxUNet(dataclasses.replace(JFAMILIES[family].unet,
                                           attn_impl="xla"))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([901.0, 250.5], np.float32)
    ctx = rng.standard_normal((2, 77, fam.unet.cross_attention_dim)
                              ).astype(np.float32)
    added = None
    if fam.unet.addition_embed_dim is not None:
        added = {"time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]],
                                              np.float32), (2, 1)),
                 "text_embeds": rng.standard_normal(
                     (2, fam.unet.addition_pooled_dim)).astype(np.float32)}
    t_added = (None if added is None
               else {k: torch.from_numpy(v) for k, v in added.items()})
    apply = jax.jit(jax_unet.apply, static_argnames=("return_deep",))
    j_out, j_deep = apply(params["unet"], x, t, ctx, added, return_deep=True)
    j_shallow = apply(params["unet"], x, t, ctx, added, cached_deep=j_deep)
    with torch.no_grad():
        out, deep = unet(_nchw(x), torch.from_numpy(t),
                         torch.from_numpy(ctx), t_added, return_deep=True)
        plain = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     t_added)
        shallow = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                       t_added, cached_deep=_nchw(j_deep))
    assert torch.equal(out, plain)  # the refresh eval is the full eval
    assert deep.shape == (2, fam.unet.block_out_channels[1], 16, 16)
    for got, want in ((out, j_out), (deep, j_deep), (shallow, j_shallow)):
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(want).max()))
    # replaying the eval's own deep activation reproduces the full eval
    np.testing.assert_allclose(shallow.numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError) as port_err, torch.no_grad():
        unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), t_added,
             cached_deep=_nchw(j_deep), return_deep=True)
    with pytest.raises(ValueError) as jax_err:
        jax_unet.apply(params["unet"], x, t, ctx, added, cached_deep=j_deep,
                       return_deep=True)
    assert str(port_err.value) == str(jax_err.value)


def test_a_one_level_unet_refuses_the_seam():
    one = dict(block_out_channels=(32,), transformer_depth=(1,),
               attn_impl="xla")
    jcfg = dataclasses.replace(JFAMILIES["tiny"].unet, **one)
    args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    # the refusal comes before any parameter is read: shapes suffice
    jparams = jax.eval_shape(lambda: JaxUNet(jcfg).init(
        jax.random.PRNGKey(0), *args))
    with pytest.raises(ValueError) as jax_err:
        jax.eval_shape(lambda p: JaxUNet(jcfg).apply(p, *args,
                                                     return_deep=True),
                       jparams)
    unet = UNet(dataclasses.replace(FAMILIES["tiny"].unet, **one))
    with pytest.raises(ValueError) as port_err, torch.no_grad():
        unet(torch.zeros(1, 4, 8, 8), torch.zeros(1), torch.zeros(1, 77, 32),
             return_deep=True)
    assert str(port_err.value) == str(jax_err.value)
    assert "single resolution level" in str(port_err.value)


# ---------------------------------------------------------------------------
# 3. the solo program

def _request(cls, **kw):
    base = dict(prompt="a lighthouse on a cliff", negative_prompt="blurry",
                steps=6, guidance_scale=7.5, height=64, width=64, seed=0,
                init_noise=np.random.default_rng(0).standard_normal(
                    (1, 32, 32, 4)).astype(np.float32))
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("schedule", ["every:2", (2, 3, 5), (1,)])
def test_solo_reuse_matches_jax(jax_tiny, port_pipe, schedule):
    jpipe = jdiff.DiffusionPipeline(jax_tiny)
    evals = tmetrics.unet_evals_counter()
    before = (evals.value(mode="reuse"), evals.value(mode="full"))
    j_img, j_cfg = jpipe(_request(jdiff.GenerateRequest,
                                  reuse_schedule=schedule))
    t_img, t_cfg = port_pipe(_request(tdiff.GenerateRequest,
                                      reuse_schedule=schedule))
    diff = np.abs(t_img.astype(np.int16) - np.asarray(j_img).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_cfg == j_cfg
    skipped = len(tdiff.normalize_reuse_schedule(6, schedule))
    assert t_cfg["steps_skipped"] == skipped
    assert t_cfg["unet_evals"] == 6 - skipped
    assert evals.value(mode="reuse") - before[0] == skipped
    assert evals.value(mode="full") - before[1] == 6 - skipped
    plain, plain_cfg = port_pipe(_request(tdiff.GenerateRequest))
    assert not np.array_equal(plain, t_img)
    assert "reuse_schedule" not in plain_cfg


def test_deepcache_off_ignores_the_schedule(monkeypatch, port_pipe):
    plain, plain_cfg = port_pipe(_request(tdiff.GenerateRequest))
    monkeypatch.delenv("CHIASWARM_DEEPCACHE")
    got, cfg = port_pipe(_request(tdiff.GenerateRequest,
                                  reuse_schedule="every:2"))
    np.testing.assert_array_equal(got, plain)
    assert cfg == plain_cfg


# ---------------------------------------------------------------------------
# 4. the quality gate

@pytest.mark.parametrize("seed", [0, 1])
def test_quality_module_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255
                ).astype(np.uint8)
    assert tquality.psnr(a, b) == jquality.psnr(a, b)
    assert tquality.ssim(a, b) == jquality.ssim(a, b)
    assert tquality.ssim(a[0, ..., 0], b[0, ..., 0]) == \
        jquality.ssim(a[0, ..., 0], b[0, ..., 0])
    assert tquality.quality_report(a, b) == jquality.quality_report(a, b)
    assert tquality.quality_report(a, a) == jquality.quality_report(a, a)
    assert tquality.quality_report(a, a)["psnr_db"] is None
    with pytest.raises(ValueError):
        tquality.psnr(a, b[:1])
    with pytest.raises(ValueError):
        tquality.ssim(a[:, :4, :4], b[:, :4, :4])


def test_deepcache_quality_gate(port_pipe):
    """JAX's gate on the tiny family: ``every:2`` at 10 steps within PSNR
    30 dB and SSIM 0.9 of the same seed's full-step image."""
    req = dict(prompt="quality", steps=10, guidance_scale=7.5, height=64,
               width=64, seed=17)
    ref, _ = port_pipe(tdiff.GenerateRequest(**req))
    out, cfg = port_pipe(tdiff.GenerateRequest(**req,
                                               reuse_schedule="every:2"))
    assert cfg["unet_evals"] == 5 and cfg["steps_skipped"] == 5
    report = tquality.quality_report(out, ref)
    assert report["passed"], report


# ---------------------------------------------------------------------------
# 5. the lanes

def _lane_job(sched, pipe, **kw):
    base = dict(prompt="a lighthouse", steps=8, guidance_scale=7.5,
                height=64, width=64, rows=1, seed=5)
    base.update(kw)
    return sched.submit_request(pipe, **base)


def test_reuse_lane_matches_solo_and_counts(port_pipe):
    schedule = (2, 4, 5)
    steps = 6
    evals = tmetrics.unet_evals_counter()
    skipped = tmetrics.steps_skipped_counter()
    before = (evals.value(mode="reuse"), skipped.value())
    with scheduler() as sched:
        pending, info = _lane_job(sched, port_pipe, steps=steps,
                                  reuse_schedule=schedule).result(120)
        lane_img = pending.wait()
        stats = sched.stats()
        # a job without a schedule rides a plain lane of its own
        _lane_job(sched, port_pipe, steps=2).result(120)
        assert sched.stats()["lanes_created"] == 2
    solo, cfg = port_pipe(tdiff.GenerateRequest(
        prompt="a lighthouse", steps=steps, guidance_scale=7.5, height=64,
        width=64, seed=5, reuse_schedule=schedule))
    np.testing.assert_array_equal(lane_img, solo)
    assert info["unet_evals"] == cfg["unet_evals"] == 3
    assert info["steps_skipped"] == cfg["steps_skipped"] == 3
    assert stats["steps_reused"] == 3 and stats["row_steps_reused"] == 3
    assert evals.value(mode="reuse") - before[0] == 3 + 3
    assert skipped.value() - before[1] == 3 + 3


def test_a_bad_schedule_is_a_lane_reject(port_pipe, monkeypatch):
    with scheduler() as sched:
        with pytest.raises(tstepper.LaneReject, match="first executed"):
            _lane_job(sched, port_pipe, reuse_schedule=(0, 2))
        # with DeepCache off the schedule is ignored: a plain lane
        monkeypatch.delenv("CHIASWARM_DEEPCACHE")
        pending, info = _lane_job(sched, port_pipe, steps=2,
                                  reuse_schedule=(0, 2)).result(120)
        assert "unet_evals" not in info


def test_misaligned_lane_mates_degrade_to_full_evals(port_pipe, monkeypatch):
    """Two reuse rows admitted together whose schedules never want reuse at
    the same step: every lane step is a full eval (more compute, the same
    math as the plain job), and neither row skips a step."""
    admitted = []
    real = tstepper.Lane._admit_locked

    def admit_together(self):
        # hold admission until both jobs wait, so they share every step
        if len(self._pending) + len(admitted) < 2:
            return
        admitted.extend(self._pending)
        real(self)

    monkeypatch.setattr(tstepper.Lane, "_admit_locked", admit_together)
    with scheduler() as sched:
        futs = [_lane_job(sched, port_pipe, seed=s, steps=5,
                          reuse_schedule=r)
                for s, r in ((1, (2, 4)), (2, (1, 3)))]
        infos = [f.result(120)[1] for f in futs]
        stats = sched.stats()
    for info in infos:
        assert info["admitted_at_step"] == 0
        assert info["unet_evals"] == 5 and info["steps_skipped"] == 0
    assert stats.get("steps_reused", 0) == 0


def _capture_checkpoints(monkeypatch) -> list:
    """Every in-memory lane checkpoint, as the lane keeps it."""
    taken: list = []
    real = tstepper.Lane._maybe_checkpoint

    def spy(self):
        real(self)
        taken.extend(dict(state) for state in self._ckpt_mem.values())

    monkeypatch.setattr(tstepper.Lane, "_maybe_checkpoint", spy)
    return taken


SCHEDULE = (2, 3, 5, 6)


@pytest.fixture(scope="module")
def checkpointed(port_pipe):
    """One uninterrupted reuse-lane job (8 steps, seed 77, ``SCHEDULE``)
    checkpointing every step: its image, info and the checkpoint taken after
    step 4 (a reuse step)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CHIASWARM_DEEPCACHE", "1")
        mp.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "1")
        taken = _capture_checkpoints(mp)
        with scheduler() as sched:
            pending, info = _lane_job(sched, port_pipe, seed=77,
                                      reuse_schedule=SCHEDULE).result(120)
            fresh = pending.wait()
    return fresh, info, next(c for c in taken if c["step"] == 4)


def test_resume_mid_schedule_is_bit_for_bit(port_pipe, checkpointed):
    """The checkpoint resumes bit for bit with the whole trajectory's
    accounting; the same checkpoint under another schedule restarts clean
    and gives the fresh run's image."""
    fresh, info, ckpt = checkpointed
    assert info["unet_evals"] == 4 and info["steps_skipped"] == 4
    assert ckpt["reuse_schedule"] == list(SCHEDULE)
    assert ckpt["cache_ok"] is True and ckpt["skipped"] == 2
    with scheduler() as sched:
        pending, info = _lane_job(sched, port_pipe, seed=0, resume=ckpt,
                                  reuse_schedule=SCHEDULE).result(120)
        assert sched.stats().get("rows_resumed") == 1
        resumed = pending.wait()
        tampered = dict(ckpt, reuse_schedule=[2, 3, 5])
        pending, clean = _lane_job(sched, port_pipe, seed=77,
                                   resume=tampered,
                                   reuse_schedule=SCHEDULE).result(120)
        assert sched.stats().get("resumes_rejected") == 1
    assert info["resume_step"] == 4
    assert info["unet_evals"] == 4 and info["steps_skipped"] == 4
    np.testing.assert_array_equal(resumed, fresh)
    assert clean["resume_step"] == 0
    np.testing.assert_array_equal(pending.wait(), fresh)


@pytest.mark.parametrize("tamper", ["schedule", "stripped", "cache",
                                    "no_schedule_job"])
def test_a_tampered_schedule_is_refused(port_pipe, checkpointed, tamper):
    """``_validate_resume`` refuses a checkpoint stepped under another
    schedule, one stripped of it, corrupt cache state, and a reuse
    checkpoint offered to a job without a schedule (JAX :1946-1985)."""
    _, _, ckpt = checkpointed
    ckpt, job_schedule = dict(ckpt), SCHEDULE
    if tamper == "schedule":
        ckpt["reuse_schedule"] = [2, 3, 5]
    elif tamper == "stripped":
        del ckpt["reuse_schedule"]
    elif tamper == "cache":
        ckpt["cache_u"] = {"dtype": "float32", "shape": [1], "b64": "!!!"}
    else:
        job_schedule = ()
    with scheduler() as sched:
        with pytest.raises(tstepper.ResumeReject):
            sched._validate_resume(
                port_pipe, ckpt, steps=8, rows=1, height=64, width=64,
                guidance=7.5, start=0, workload="txt2img",
                reuse_schedule=job_schedule)
        # the untampered checkpoint passes, caches and tally restored
        restored = sched._validate_resume(
            port_pipe, dict(checkpointed[2]), steps=8, rows=1, height=64,
            width=64, guidance=7.5, start=0, workload="txt2img",
            reuse_schedule=SCHEDULE)
    assert restored["skipped"] == 2 and restored["cache_ok"] is True
    assert tuple(restored["cache_u"].shape) == (1, 64, 32, 32)


# ---------------------------------------------------------------------------
# 6. ControlNet and instruct-pix2pix

def test_controlnet_and_pix2pix_keep_reuse_out(jax_tiny, port_pipe):
    """JAX's builders refuse reuse with the control branch and the dual
    guidance, in the messages the port's programs raise; a control job's
    schedule is ignored by both packages' ``submit``."""
    with pytest.raises(ValueError) as jax_err:
        jdiff.DiffusionPipeline(jax_tiny)._build_fn(
            batch=1, height=64, width=64, steps=4, start_step=0,
            sampler=jdiff.resolve(None), use_cfg=True, has_init=False,
            has_mask=False, tiled=False, has_control=True, has_noise=False,
            reuse=True)
    bundle = ControlNetBundle.random("tiny", device="cpu")
    with pytest.raises(ValueError) as port_err:
        port_pipe._generate(
            batch=1, steps=4, sampler=tdiff.resolve(None), use_cfg=True,
            guidance=7.5, ids=[], neg_ids=[], noise=torch.zeros(1, 4, 32, 32),
            generators=[], height=64, width=64, control=bundle,
            hint=torch.zeros(1, 32, 32, 32), reuse=(2,))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as port_img_err:
        port_pipe._generate(
            batch=1, steps=4, sampler=tdiff.resolve(None), use_cfg=True,
            guidance=7.5, ids=[], neg_ids=[], noise=torch.zeros(1, 4, 32, 32),
            generators=[], height=64, width=64,
            image_cond=torch.zeros(1, 4, 32, 32), reuse=(2,))
    assert str(port_img_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_lane:
        jdiff.DiffusionPipeline(jax_tiny).stepper_step_fn(
            batch=2, height=64, width=64, steps_cap=16,
            sampler=jdiff.resolve(None), has_control=True, reuse=True)
    with pytest.raises(ValueError) as port_lane:
        port_pipe.stepper_step(
            sampler=tdiff.resolve(None), ctx_u=None, ctx_c=None, x=None,
            idx=None, start_idx=None, sigmas=None, timesteps=None,
            guidance=None, old_denoised=None, active=None, generators=[],
            control=bundle, cache=(None, None))
    assert str(port_lane.value) == str(jax_lane.value)
    cond = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    _, cfg = port_pipe(_request(tdiff.GenerateRequest, controlnet=bundle,
                                control_image=cond, steps=3,
                                reuse_schedule=(2,)))
    assert cfg["unet_evals"] == 3 and "reuse_schedule" not in cfg
