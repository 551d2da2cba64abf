"""The port's img2img and inpaint slice on the ``tiny`` family (and
``tiny_xl`` for SDXL) at 64 px, against the JAX package.

- The helpers, exactly: ``img2img_start_index`` and ``latent_mask`` (under
  hypothesis, over steps, strengths and mask sizes), ``_to_float_image``,
  ``_resize_image``, ``reproject_known`` and ``reproject_known_rows``.
- The VAE encoder: the moments within 2e-4 in float32 (weights carried by
  ``params_from_flax``), the posterior sample with its noise pinned.
- The solo pipelines within one uint8 level, every normal draw pinned on
  both sides to one numpy array: the JAX ``jax.random.normal`` as the
  pipeline modules trace it (the executable cache flushed so the patch is
  traced in, and flushed again after), the port's ``randn_rows``. Configs
  equal, ``mode`` and ``denoise_steps`` included.
- The lanes against the port's own solo path: img2img and inpaint rows
  spliced mid-flight (the JAX package's ``tests/test_stepper.py`` gates), a
  txt2img row's bits and noise stream unchanged beside an inpaint row.
- The executor's envelopes (solo and lanes) against the JAX executor's, the
  workflow routing, the worker serving ``start_image_uri`` and
  ``mask_image_uri`` jobs from a hive, and the smoke harness's img2img job.
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
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from chiaswarm_tpu.core.compile_cache import GLOBAL_CACHE
from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.schedulers import sampling as jsampling
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.rng import (
    posterior_generator,
    posterior_seed,
    row_seed,
)
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.schedulers import sampling as tsampling
from chiaswarm_tpu_torch.serving.stepper import StepScheduler, get_stepper

SIZE = 64


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


def _image(seed: int, size: int = SIZE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                                dtype=np.uint8)


def _rect_mask(size: int = SIZE) -> np.ndarray:
    mask = np.zeros((size, size), np.float32)
    mask[size // 4: 3 * size // 4, size // 8: size // 2] = 1.0
    return mask


@pytest.fixture(scope="module")
def jax_pipe():
    return jdiff.DiffusionPipeline(JaxComponents.random("tiny", seed=0))


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    params = jax.tree.map(np.asarray, jax_pipe.c.params)
    return tdiff.DiffusionPipeline(Components.from_jax(params, "tiny",
                                                       device="cpu"))


@pytest.fixture(scope="module")
def xl_pipes():
    """(JAX, port) tiny_xl pipelines over the same weights."""
    jc = JaxComponents.random("tiny_xl", seed=0)
    return jdiff.DiffusionPipeline(jc), tdiff.DiffusionPipeline(
        Components.from_jax(jax.tree.map(np.asarray, jc.params), "tiny_xl",
                            device="cpu"))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# 1. the helpers, exactly


@settings(max_examples=200, deadline=None)
@given(steps=st.integers(1, 150),
       strength=st.floats(-0.5, 1.5, allow_nan=False))
def test_img2img_start_index_matches_jax(steps, strength):
    assert tdiff.img2img_start_index(steps, strength) == \
        jdiff.img2img_start_index(steps, strength)


@settings(max_examples=40, deadline=None)
@given(lh=st.integers(1, 12), lw=st.integers(1, 12),
       downscale=st.sampled_from([2, 8]),
       form=st.sampled_from(["pixel", "latent", "other"]),
       other=st.tuples(st.integers(3, 90), st.integers(3, 90)),
       seed=st.integers(0, 2**16))
def test_latent_mask_matches_jax(lh, lw, downscale, form, other, seed):
    shape = {"pixel": (lh * downscale, lw * downscale), "latent": (lh, lw),
             "other": other}[form]
    mask = np.random.default_rng(seed).random(shape).astype(np.float32)
    got = tdiff.latent_mask(mask, lh, lw, downscale)
    ref = jdiff.latent_mask(mask, lh, lw, downscale)
    assert got.dtype == ref.dtype and got.shape == (lh, lw)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_helpers_match_jax(dtype):
    img = _image(3, 40)
    if dtype == "float32":
        img = img.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(tdiff._to_float_image(img),
                                  jdiff._to_float_image(img))
    np.testing.assert_array_equal(tdiff._resize_image(img, 64, 48),
                                  jdiff._resize_batch(img, 64, 48))


def _ladders(steps: int):
    """The port's ladder and the same numbers as a JAX schedule (the two
    packages' Karras ladders part in the last bits; the re-projection is
    held on one ladder)."""
    from chiaswarm_tpu_torch.schedulers import (
        ScheduleConfig,
        make_noise_schedule,
        resolve,
    )

    t_sched = tsampling.make_sampling_schedule(
        make_noise_schedule(ScheduleConfig()), steps, resolve(None))
    j_sched = jsampling.SamplingSchedule(
        sigmas=jnp.asarray(t_sched.sigmas.numpy()),
        timesteps=jnp.asarray(t_sched.timesteps.numpy()))
    return t_sched, j_sched


def test_reproject_known_matches_jax_exactly():
    rng = np.random.default_rng(4)
    x, known, renoise = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                         for _ in range(3))
    mask = (rng.random((1, 8, 8, 1)) > 0.5).astype(np.float32)
    t_sched, j_sched = _ladders(10)
    for i in range(10):  # the last step's sigma[i + 1] is 0: known exactly
        ref = jsampling.reproject_known(j_sched, i, jnp.asarray(x),
                                        jnp.asarray(known), jnp.asarray(mask),
                                        jnp.asarray(renoise))
        got = tsampling.reproject_known(t_sched, i, _nchw(x), _nchw(known),
                                        _nchw(mask), _nchw(renoise))
        np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    kept = mask[0, :, :, 0] == 0
    np.testing.assert_array_equal(_nhwc(got)[:, kept], known[:, kept])


def test_reproject_known_rows_matches_jax_exactly():
    """Rows at different ladder positions with ladders of different lengths,
    padded to one capacity as a lane holds them."""
    rng = np.random.default_rng(5)
    rows, cap = 3, 16
    x, known, renoise = (rng.standard_normal((rows, 8, 8, 4))
                         .astype(np.float32) for _ in range(3))
    mask = (rng.random((rows, 8, 8, 1)) > 0.5).astype(np.float32)
    sig = np.zeros((rows, cap + 1), np.float32)
    ts = np.zeros((rows, cap), np.float32)
    for b, steps in enumerate((12, 7, 16)):
        t_sched, _ = _ladders(steps)
        sig[b, : steps + 1] = t_sched.sigmas.numpy()
        ts[b, : steps] = t_sched.timesteps.numpy()
    idx = np.array([3, 6, 15], np.int32)
    ref = jsampling.reproject_known_rows(
        jsampling.SamplingSchedule(sigmas=jnp.asarray(sig),
                                   timesteps=jnp.asarray(ts)),
        jnp.asarray(idx), jnp.asarray(x), jnp.asarray(known),
        jnp.asarray(mask), jnp.asarray(renoise))
    got = tsampling.reproject_known_rows(
        tsampling.SamplingSchedule(sigmas=torch.from_numpy(sig),
                                   timesteps=torch.from_numpy(ts)),
        torch.from_numpy(idx.astype(np.int64)), _nchw(x), _nchw(known),
        _nchw(mask), _nchw(renoise))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


def test_posterior_stream_is_its_own_domain():
    """The posterior generator's seed differs from every (seed, row)
    stream's of the same seed, and is a function of the seed alone."""
    for seed in (0, 1, 5, 2**40):
        assert posterior_seed(seed) not in {row_seed(seed, r)
                                            for r in range(64)}
        a = torch.randn(4, generator=posterior_generator(seed))
        assert torch.equal(a, torch.randn(4, generator=posterior_generator(
            seed)))


# ---------------------------------------------------------------------------
# 2. the VAE encoder


@pytest.mark.parametrize("family", ["tiny", "tiny_xl"])
def test_encode_matches_jax(family, jax_pipe, port_pipe, xl_pipes):
    pipes = (jax_pipe, port_pipe) if family == "tiny" else xl_pipes
    jc, tc = pipes[0].c, pipes[1].c
    img = tdiff._to_float_image(_image(7)[None])
    mean_ref, logvar_ref = jc.vae.apply(jc.params["vae"], jnp.asarray(img),
                                        method=JaxVAE.encode_moments)
    with torch.no_grad():
        mean, logvar = tc.vae.encode_moments(_nchw(img))
    np.testing.assert_allclose(_nhwc(mean), np.asarray(mean_ref), atol=2e-4)
    np.testing.assert_allclose(_nhwc(logvar), np.asarray(logvar_ref),
                               atol=2e-4)
    # the posterior sample with one pinned noise array on both sides
    noise = np.random.default_rng(8).standard_normal(
        mean_ref.shape).astype(np.float32)
    with _pinned_jax_normal(noise):
        z_ref = jc.vae.apply(jc.params["vae"], jnp.asarray(img),
                             jax.random.PRNGKey(0),
                             method=JaxVAE.encode)
    with torch.no_grad():
        z = tc.vae.encode(_nchw(img), _nchw(noise))
    np.testing.assert_allclose(_nhwc(z), np.asarray(z_ref), atol=2e-4)


def test_encode_init_image_is_a_batch_1_encode_outside_the_seq_context(
        port_pipe, monkeypatch):
    """The solo path and the lanes share one encode: batch 1, the job's
    posterior generator, no active sequence-parallel mesh inside."""
    from chiaswarm_tpu_torch.parallel import context

    seen = []
    real = port_pipe.c.vae.encode

    def spy(x, noise=None):
        seen.append((tuple(x.shape), context.active_seq_mesh()))
        return real(x, noise)

    monkeypatch.setattr(port_pipe.c.vae, "encode", spy)
    z = port_pipe.encode_init_image(_image(9), SIZE, SIZE, seed=4)
    again = port_pipe.encode_init_image(_image(9), SIZE, SIZE, seed=4)
    other = port_pipe.encode_init_image(_image(9), SIZE, SIZE, seed=5)
    assert seen == [((1, 3, SIZE, SIZE), None)] * 3
    assert z.shape == (1, 4, SIZE // 2, SIZE // 2) and z.dtype == torch.float32
    assert torch.equal(z, again) and not torch.equal(z, other)
    with pytest.raises(ValueError, match="resize"):
        port_pipe.encode_init_image(_image(9, 48), SIZE, SIZE, seed=4)


def test_encode_does_not_ring_under_a_seq_context(port_pipe):
    """Under a caller's ``seq = 4`` context the init-image encode rings
    nothing, where the bare encoder's 1024-token mid-block attention
    would."""
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.parallel.context import (
        capture_ring_calls,
        sequence_parallel,
    )

    mesh = build_mesh(MeshSpec({"seq": 4}), devices=["cpu"] * 4)
    x = _nchw(tdiff._to_float_image(_image(9)[None]))
    with capture_ring_calls() as calls, sequence_parallel(mesh):
        port_pipe.encode_init_image(_image(9), SIZE, SIZE, seed=4)
        assert calls == []
        with torch.no_grad():
            port_pipe.c.vae.encode(x)
    assert [kind for kind, _ in calls] == ["ring_flash"]


# ---------------------------------------------------------------------------
# 3. the solo pipelines, draws pinned


@contextlib.contextmanager
def _pinned_jax_normal(noise: np.ndarray):
    """Every ``jax.random.normal`` the JAX modules trace returns ``noise``
    (broadcast to the draw's shape); executables traced under the patch are
    dropped before and after."""
    real = jax.random.normal

    def pinned(key, shape=(), dtype=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(noise, dtype), shape)

    GLOBAL_CACHE.flush_executables()
    jax.random.normal = pinned
    try:
        yield
    finally:
        jax.random.normal = real
        GLOBAL_CACHE.flush_executables()


@pytest.fixture()
def pinned_port_draws(monkeypatch):
    """Every port draw (initial noise, posterior, step noise, renoise) is
    the one array the test pins, row for row."""
    box = {}

    def pinned(generators, shape, device="cpu"):
        one = torch.from_numpy(box["noise"]).permute(2, 0, 1)
        assert tuple(one.shape) == tuple(shape)
        return torch.stack([one] * len(generators)).to(device)

    monkeypatch.setattr(tdiff, "randn_rows", pinned)
    return box


CASES = {
    "img2img": dict(steps=6, strength=0.6),
    "inpaint": dict(steps=4, mask=True),
    "inpaint_euler_a": dict(steps=4, mask=True,
                            scheduler="EulerAncestralDiscreteScheduler"),
}


def _req(cls, case: dict, seed: int = 3, **over):
    kw = dict(prompt="a lighthouse at dusk", negative_prompt="blurry",
              guidance_scale=7.5, height=SIZE, width=SIZE, seed=seed,
              init_image=_image(11), **{k: v for k, v in case.items()
                                        if k != "mask"})
    if case.get("mask"):
        kw["mask"] = _rect_mask()
    kw.update(over)
    return cls(**kw)


def _pipeline_parity(jax_pipe, port_pipe, box, case, lh):
    noise = np.random.default_rng(12).standard_normal(
        (lh, lh, 4)).astype(np.float32)
    box["noise"] = noise
    with _pinned_jax_normal(noise):
        j_img, j_cfg = jax_pipe(_req(jdiff.GenerateRequest, case))
    t_img, t_cfg = port_pipe(_req(tdiff.GenerateRequest, case))
    j_img = np.asarray(j_img)
    assert t_img.shape == j_img.shape == (1, SIZE, SIZE, 3)
    diff = np.abs(t_img.astype(np.int16) - j_img.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_img.std() > 1.0
    assert t_cfg == j_cfg
    return t_cfg


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiny_pipeline_matches_jax(name, jax_pipe, port_pipe,
                                   pinned_port_draws):
    case = CASES[name]
    cfg = _pipeline_parity(jax_pipe, port_pipe, pinned_port_draws, case,
                           SIZE // 2)
    assert cfg["mode"] == name.split("_")[0]
    start = (0 if case.get("mask")
             else tdiff.img2img_start_index(case["steps"], case["strength"]))
    assert cfg["denoise_steps"] == cfg["unet_evals"] == case["steps"] - start


def test_tiny_xl_img2img_matches_jax(xl_pipes, pinned_port_draws):
    j_pipe, t_pipe = xl_pipes
    lh = SIZE // t_pipe.c.family.vae.downscale
    cfg = _pipeline_parity(j_pipe, t_pipe, pinned_port_draws,
                           CASES["img2img"], lh)
    assert cfg["mode"] == "img2img" and cfg["family"] == "tiny_xl"


def test_inpaint_keeps_the_known_latents_exactly(port_pipe, monkeypatch):
    """The final latents' kept region is the encoded init latent, bit for
    bit (sigma[-1] = 0), whatever the sampler kind."""
    seen = {}
    real = port_pipe._decode_uint8

    def spy(x):
        seen["x"] = x.clone()
        return real(x)

    monkeypatch.setattr(port_pipe, "_decode_uint8", spy)
    for scheduler in (None, "EulerAncestralDiscreteScheduler"):
        port_pipe(_req(tdiff.GenerateRequest, CASES["inpaint"],
                       scheduler=scheduler))
        known = port_pipe.encode_init_image(_image(11), SIZE, SIZE, seed=3)
        kept = torch.from_numpy(tdiff.latent_mask(_rect_mask(), 32, 32, 2)
                                == 0)
        assert kept.any() and (~kept).any()
        assert torch.equal(seen["x"][:, :, kept], known[:, :, kept])


def test_mask_without_image_is_refused(port_pipe):
    with pytest.raises(ValueError, match="requires an init image"):
        port_pipe(tdiff.GenerateRequest(prompt="p", height=SIZE, width=SIZE,
                                        steps=2, mask=_rect_mask()))


# ---------------------------------------------------------------------------
# 4. the lanes against the port's solo path


def _wait_steps(sched: StepScheduler, n: int, timeout: float = 120.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if sched.stats().get("steps_executed", 0) >= n:
            return
        time.sleep(0.005)
    raise AssertionError(f"scheduler never reached {n} steps")


def _close(lane_img: np.ndarray, solo_img: np.ndarray) -> None:
    # different batch shapes: agreement to uint8 quantization, not bits
    # (the JAX splice gate's bar)
    diff = np.abs(lane_img.astype(int) - solo_img.astype(int))
    assert diff.max() <= 3 and (diff <= 1).mean() > 0.99, (
        diff.max(), (diff <= 1).mean())


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_image_row_spliced_midflight_matches_solo(port_pipe, mode):
    """An img2img (strength start index 2 of 4) or inpaint row splices into
    a lane mid-flight beside a txt2img row; both match their solo runs."""
    resident = 8
    extra = (dict(init_image=_image(70), strength=0.5) if mode == "img2img"
             else dict(init_image=_image(75), mask=_rect_mask()))
    sched = StepScheduler()
    try:
        fa = sched.submit_request(
            port_pipe, prompt="resident txt2img", steps=resident,
            guidance_scale=7.5, height=SIZE, width=SIZE, rows=1, seed=71)
        _wait_steps(sched, 1)
        fb = sched.submit_request(
            port_pipe, prompt=f"late {mode}", steps=4, guidance_scale=5.5,
            height=SIZE, width=SIZE, rows=1, seed=72, **extra)
        pending_b, info_b = fb.result(timeout=300)
        pending_a, info_a = fa.result(timeout=300)
        stats = sched.stats()
    finally:
        sched.shutdown()
    assert info_b["lane"] == info_a["lane"]
    assert 1 <= info_b["admitted_at_step"] < resident
    assert stats[f"rows_admitted_{mode}"] == 1
    assert stats["rows_admitted_txt2img"] == 1
    solo_a, _ = port_pipe(tdiff.GenerateRequest(
        prompt="resident txt2img", steps=resident, guidance_scale=7.5,
        height=SIZE, width=SIZE, seed=71))
    solo_b, cfg_b = port_pipe(tdiff.GenerateRequest(
        prompt=f"late {mode}", steps=4, guidance_scale=5.5, height=SIZE,
        width=SIZE, seed=72, **extra))
    assert cfg_b["mode"] == mode
    _close(pending_a.wait(), solo_a)
    _close(pending_b.wait(), solo_b)


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_lone_image_row_is_its_solo_run_bit_for_bit(port_pipe, mode):
    """Alone in a lane of one row, an image job walks its solo trajectory
    to the bit on the CPU (the same batch composition)."""
    extra = (dict(init_image=_image(80), strength=0.3) if mode == "img2img"
             else dict(init_image=_image(80), mask=_rect_mask()))
    sched = StepScheduler()
    try:
        pending, info = sched.submit_request(
            port_pipe, prompt="alone", steps=3, guidance_scale=6.0,
            height=SIZE, width=SIZE, rows=1, seed=81,
            scheduler="EulerAncestralDiscreteScheduler",
            **extra).result(timeout=300)
    finally:
        sched.shutdown()
    solo, _ = port_pipe(tdiff.GenerateRequest(
        prompt="alone", steps=3, guidance_scale=6.0, height=SIZE, width=SIZE,
        seed=81, scheduler="EulerAncestralDiscreteScheduler", **extra))
    np.testing.assert_array_equal(pending.wait(), solo)


def test_inpaint_row_survives_a_lane_resize(port_pipe, monkeypatch):
    """An inpaint row in slot 1 of a lane of 2 (a short txt2img job took
    slot 0 and retired) moves to slot 0 when the lane grows at a step
    boundary for a burst that cannot fit: its clean latents, mask and start
    move with it, and its image matches its solo run."""
    monkeypatch.setenv("CHIASWARM_STEPPER_MIN_WIDTH", "2")
    extra = dict(init_image=_image(90), mask=_rect_mask())
    sched = StepScheduler()
    try:
        short = sched.submit_request(
            port_pipe, prompt="short", steps=2, guidance_scale=7.5,
            height=SIZE, width=SIZE, rows=1, seed=89)
        fa = sched.submit_request(
            port_pipe, prompt="resident inpaint", steps=6,
            guidance_scale=7.5, height=SIZE, width=SIZE, rows=1, seed=91,
            **extra)
        short_info = short.result(timeout=300)[1]
        late = [sched.submit_request(
            port_pipe, prompt=f"burst {i}", steps=2, guidance_scale=7.5,
            height=SIZE, width=SIZE, rows=1, seed=92 + i) for i in range(3)]
        infos = [fut.result(timeout=300)[1] for fut in late]
        img_a, info_a = fa.result(timeout=300)
        img_a = img_a.wait()
        stats = sched.stats()
    finally:
        sched.shutdown()
    assert short_info["lane_width"] == 2 and info_a["lane"] == infos[0]["lane"]
    assert stats.get("lane_resizes", 0) >= 1, stats
    assert max(info["lane_width"] for info in infos) >= 4, infos
    solo, _ = port_pipe(tdiff.GenerateRequest(
        prompt="resident inpaint", steps=6, guidance_scale=7.5, height=SIZE,
        width=SIZE, seed=91, **extra))
    _close(img_a, solo)


@pytest.mark.parametrize("scheduler", [None, "EulerAncestralDiscreteScheduler"])
def test_txt2img_row_keeps_its_bits_beside_an_inpaint_row(port_pipe,
                                                          scheduler):
    """One lane step over two rows: row 0 txt2img, row 1 either txt2img or
    inpaint. Row 0's latents, history and index are bit for bit the same
    either way, and its generator has drawn no renoise."""
    from chiaswarm_tpu_torch.core.rng import row_generators
    from chiaswarm_tpu_torch.schedulers import resolve

    sampler = resolve(scheduler)
    sched = tsampling.make_sampling_schedule(port_pipe.noise_schedule, 8,
                                             sampler)
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32))
                         .astype(np.float32))
    ids = port_pipe._tokenize(["a", "b"])
    neg = port_pipe._tokenize(["", ""])
    ctx_u, ctx_c, pu, pc = port_pipe.stepper_encode(ids, neg)
    known = torch.from_numpy(rng.standard_normal((2, 4, 32, 32))
                             .astype(np.float32))
    mask = torch.ones((2, 1, 32, 32))
    mask[1, :, :16] = 0.0
    outs, draws = [], []
    for mask_on in ([False, False], [False, True]):
        gens = row_generators([(1, 0), (2, 0)])
        noisy = gens if sampler.kind in tsampling.NOISY_KINDS else [None] * 2
        renoise = [g if on else None for g, on in zip(gens, mask_on)]
        outs.append(port_pipe.stepper_step(
            sampler=sampler, ctx_u=ctx_u, ctx_c=ctx_c, x=x,
            idx=torch.tensor([2, 1]), start_idx=torch.tensor([0, 0]),
            sigmas=sched.sigmas[None].repeat(2, 1),
            timesteps=sched.timesteps[None].repeat(2, 1),
            guidance=torch.tensor([7.5, 5.0]),
            old_denoised=torch.zeros_like(x),
            active=torch.tensor([True, True]), generators=noisy,
            pooled_u=pu, pooled_c=pc, known=known, mask=mask,
            mask_on=torch.tensor(mask_on),
            renoise_generators=renoise if any(mask_on) else None))
        draws.append(torch.randn(3, generator=gens[0]))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a[0], b[0])
    assert not torch.equal(outs[0][0][1], outs[1][0][1])
    assert torch.equal(draws[0], draws[1])
    kept = mask[1, 0] == 0
    last = tsampling.reproject_known_rows(
        tsampling.SamplingSchedule(sigmas=sched.sigmas[None],
                                   timesteps=sched.timesteps[None]),
        torch.tensor([1]), outs[0][0][1:], known[1:], mask[1:],
        torch.zeros_like(known[1:]))
    assert not torch.equal(last, outs[1][0][1:])  # renoise was drawn
    assert kept.any()


# ---------------------------------------------------------------------------
# 5. the executor, the routing, the worker, the smoke harness


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                         allow_random=True, device="cpu")


@pytest.fixture(scope="module")
def jax_registry():
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    return JaxRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                       allow_random=True)


def _job(mode: str, **over):
    job = {"id": f"job-{mode}", "model_name": "tiny",
           "prompt": "watercolor style", "num_inference_steps": 4,
           "seed": 6, "content_type": "image/png", "image": _image(13)}
    if mode == "img2img":
        job["strength"] = 0.6
    else:
        job["mask_image"] = (np.stack([_rect_mask()] * 3, -1) * 255).astype(
            np.uint8)
    job.update(over)
    return job


def _png(result) -> np.ndarray:
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("mode,lanes", [("img2img", "0"), ("inpaint", "1")])
def test_executor_envelope_matches_the_jax_executor(monkeypatch, registry,
                                                    jax_registry, mode,
                                                    lanes):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.serving.stepper import get_stepper as jax_stepper

    monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
    jax_slot = JaxPool(n_slots=1).slots[0]
    try:
        ref = jax_do_work(_job(mode), jax_slot, jax_registry)
    finally:
        jax_stepper(jax_slot).shutdown()
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(_job(mode), slot, registry)
    finally:
        get_stepper(slot).shutdown()
    for result in (got, ref):
        assert "error" not in result["pipeline_config"], result
    assert set(got) == set(ref)
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    assert ("stepper" in got["pipeline_config"]) == (lanes == "1")
    if lanes == "1":
        assert set(got["pipeline_config"]["stepper"]) == set(
            ref["pipeline_config"]["stepper"])
    for key in ("scheduler", "steps", "denoise_steps", "guidance_scale",
                "size", "compiled_size", "batch", "mode", "seed", "nsfw",
                "safety_checker", "family", "model_name"):
        assert got["pipeline_config"][key] == ref["pipeline_config"][key], key
    assert got["pipeline_config"]["mode"] == mode
    assert _png(got).shape == (SIZE, SIZE, 3)


def test_image_guidance_maps_to_strength_on_the_solo_path(monkeypatch,
                                                          registry):
    """``image_guidance_scale`` on a plain checkpoint is img2img strength
    (x / 5): no lane takes the job, and its ladder is the strength's."""
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(
            _job("img2img", image_guidance_scale=2.0, num_inference_steps=5),
            slot, registry)
    finally:
        get_stepper(slot).shutdown()
    cfg = got["pipeline_config"]
    assert "stepper" not in cfg and cfg["mode"] == "img2img"
    assert cfg["denoise_steps"] == 5 - tdiff.img2img_start_index(5, 0.4)


@pytest.mark.parametrize("workflow", [None, "txt2img", "img2img", "inpaint",
                                      "something-new"])
def test_workflow_routes_to_the_sd_formatter_as_in_jax(workflow, registry):
    from chiaswarm_tpu.node.job_args import format_args as jax_format
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.workloads.diffusion import (
        diffusion_callback as jax_callback,
    )
    from chiaswarm_tpu_torch.node.job_args import format_args
    from chiaswarm_tpu_torch.workloads.diffusion import diffusion_callback

    job = {"id": "r", "model_name": "tiny", "prompt": "p",
           "parameters": {"scheduler_type": "DDIMScheduler"}}
    if workflow is not None:
        job["workflow"] = workflow
    # both formatters pop from the job's nested ``parameters``
    callback, kwargs = format_args(copy.deepcopy(job), registry)
    j_callback, j_kwargs = jax_format(copy.deepcopy(job), JaxRegistry(
        catalog=[], allow_random=True))
    assert callback is diffusion_callback and j_callback is jax_callback
    assert {k: v for k, v in kwargs.items() if k != "registry"} == \
        {k: v for k, v in j_kwargs.items() if k != "registry"}


@pytest.mark.parametrize("workflow", ["txt2audio", "stitch", "img2txt",
                                      "vid2vid", "img2vid", "txt2vid"])
def test_other_workloads_stay_refused(workflow, registry):
    """The other workloads route to the callbacks the JAX package routes
    them to: stitch, img2txt and txt2audio since the thirteenth slice, and
    the three video workflows (``tests/test_torch_stitch.py``,
    ``test_torch_caption.py``, ``test_torch_audio.py`` and
    ``test_torch_video_pipeline.py`` hold them); what the port still refuses
    names ROADMAP queue item 6."""
    from chiaswarm_tpu_torch.node.job_args import format_args

    served = {"txt2audio": "txt2audio_callback", "stitch": "stitch_callback",
              "img2txt": "caption_callback", "vid2vid": "vid2vid_callback",
              "img2vid": "img2vid_callback", "txt2vid": "txt2vid_callback"}
    job = {"workflow": workflow, "model_name": "tiny"}
    if workflow in served:
        callback, _ = format_args(job, registry)
        assert callback.__name__ == served[workflow]
        return
    with pytest.raises(ValueError, match="later slice.*item 6"):
        format_args(job, registry)


def _worker_serves(jobs: list[dict], lanes: str, monkeypatch) -> dict:
    """``jobs`` through the port's worker against a ``FakeHive`` that also
    serves ``/assets/init.png`` and ``/assets/mask.png`` (64 px)."""
    from aiohttp import web

    from chiaswarm_tpu_torch.node import settings as tsettings
    from chiaswarm_tpu_torch.node import worker as tworker
    from tests.fake_hive import FakeHive

    def png(pixels: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, format="PNG")
        return buf.getvalue()

    assets = {"init": png(_image(14)),
              "mask": png((_rect_mask() * 255).astype(np.uint8))}

    class Hive(FakeHive):
        def __init__(self) -> None:
            super().__init__()
            self._app.router.add_route("*", "/assets/{name}.png", self._asset)

        async def _asset(self, request):
            return web.Response(body=assets[request.match_info["name"]],
                                content_type="image/png")

    monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
    registry = ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    pool = ChipPool(device="cpu")

    async def scenario():
        hive = Hive()
        uri = await hive.start()
        for job in jobs:
            job = dict(job)
            for key in ("start_image_uri", "mask_image_uri"):
                if key in job:
                    job[key] = f"{uri}{job[key]}"
            hive.jobs.append(job)
        worker = tworker.Worker(
            settings=tsettings.Settings(
                hive_uri=uri, hive_token="t", worker_name="img2img",
                poll_busy_s=0.02, poll_idle_s=0.02,
                install_signal_handlers=False),
            pool=pool, registry=registry)
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(len(jobs), timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive

    try:
        hive = asyncio.run(scenario())
    finally:
        get_stepper(pool.slots[0]).shutdown()
    return {r["id"]: r for r in hive.results}


@pytest.mark.parametrize("lanes", ["0", "1"])
def test_worker_serves_image_jobs_from_the_hive(tmp_path, monkeypatch, lanes):
    """Hive jobs with ``start_image_uri`` (img2img) and with
    ``mask_image_uri`` beside it (inpaint), with ``workflow`` absent,
    ``txt2img``, ``img2img`` or ``inpaint``: error-free envelopes with a PNG
    of the image's size, on the lanes by default and solo under
    ``CHIASWARM_STEPPER=0``."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    base = {"model_name": "tiny", "prompt": "p", "num_inference_steps": 3,
            "seed": 9, "content_type": "image/png",
            "start_image_uri": "/assets/init.png"}
    jobs = []
    for workflow, mode in ((None, "img2img"), ("txt2img", "inpaint"),
                           ("img2img", "img2img"), ("inpaint", "inpaint")):
        job = dict(base, id=f"{workflow}-{mode}")
        if workflow is not None:
            job["workflow"] = workflow
        if mode == "inpaint":
            job["mask_image_uri"] = "/assets/mask.png"
        jobs.append(job)
    results = _worker_serves(jobs, lanes, monkeypatch)
    assert sorted(results) == sorted(j["id"] for j in jobs)
    for job in jobs:
        cfg = results[job["id"]]["pipeline_config"]
        assert "error" not in cfg, cfg
        assert cfg["mode"] == job["id"].split("-")[1]
        assert ("stepper" in cfg) == (lanes == "1")
        assert _png(results[job["id"]]).shape == (SIZE, SIZE, 3)


def test_smoke_cli_runs_the_img2img_job(capsys):
    import json

    from chiaswarm_tpu_torch.node.smoke import main as smoke_main

    assert smoke_main(["--device", "cpu", "--steps", "2", "--all"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    # --all runs the JAX harness's ten workflows, the SD two first
    assert [(line["workflow"], line["mode"], line["status"])
            for line in lines[:2]] == [("txt2img", "txt2img", "ok"),
                                       ("img2img", "img2img", "ok")]
    assert len(lines) == 10 and all(line["status"] == "ok" for line in lines)
