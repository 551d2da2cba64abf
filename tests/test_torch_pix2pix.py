"""The port's instruct-pix2pix on the ``tiny_p2p`` family at 64 px, against
the JAX package.

- The routing: ``timbrooks/instruct-pix2pix`` resolves to the pix2pix family
  in both packages, and both job formatters map the hive's strength to
  ``image_guidance_scale`` = strength x 5 (0.6 when absent) and drop it.
- The solo pipeline within one uint8 level and its final latents within
  2e-4 in float32 (weights carried by ``params_from_flax``), every normal
  draw pinned on both sides to one numpy array; configs equal, ``mode`` and
  ``image_guidance_scale`` included.
- JAX's three refusals (no init image, a mask, a ControlNet), word for word.
- The job never rides a lane: the executor serves it on the solo path with
  the JAX executor's envelope keys.
- A diffusers-layout pix2pix directory with an 8-channel ``conv_in`` loads
  through the registry with no random fallback.
"""

from __future__ import annotations

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.core.compile_cache import GLOBAL_CACHE
from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.serving.stepper import get_stepper

SIZE = 64
P2P = "timbrooks/instruct-pix2pix"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _image(seed: int, size: int = SIZE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def pipes():
    """(JAX, port) tiny_p2p pipelines over the same weights."""
    jc = JaxComponents.random("tiny_p2p", seed=0)
    return jdiff.DiffusionPipeline(jc), tdiff.DiffusionPipeline(
        Components.from_jax(jax.tree.map(np.asarray, jc.params), "tiny_p2p",
                            device="cpu"))


# ---------------------------------------------------------------------------
# 1. routing and the strength remap


def test_family_routing_matches_jax():
    from chiaswarm_tpu.models.configs import get_family as jax_family
    from chiaswarm_tpu_torch.models.configs import get_family

    fam = get_family(P2P)
    assert fam.name == jax_family(P2P).name == "pix2pix"
    assert fam.image_conditioned and fam.unet.sample_channels == 8
    assert ModelRegistry(device="cpu").family_for(P2P) is fam


@pytest.mark.parametrize("strength,guidance", [(0.3, 1.5), (None, 3.0)])
def test_strength_remap_matches_jax(monkeypatch, strength, guidance):
    from PIL import Image

    from chiaswarm_tpu.node import job_args as jax_args
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu_torch.node import job_args

    picture = Image.fromarray(_image(3))
    for module in (jax_args, job_args):
        monkeypatch.setattr(module, "get_image",
                            lambda uri, size, controlnet=None: picture)
    job = {"id": "p", "model_name": P2P, "prompt": "make it snowy",
           "start_image_uri": "http://hive.example/in.png"}
    if strength is not None:
        job["strength"] = strength
    _, kwargs = job_args.format_args(copy.deepcopy(job),
                                     ModelRegistry(device="cpu"))
    _, ref = jax_args.format_args(copy.deepcopy(job),
                                  JaxRegistry(catalog=[], allow_random=True))
    assert kwargs["image_guidance_scale"] == pytest.approx(guidance)
    assert "strength" not in kwargs and "strength" not in ref
    np.testing.assert_array_equal(kwargs.pop("image"), ref.pop("image"))
    assert {k: v for k, v in kwargs.items() if k != "registry"} == \
        {k: v for k, v in ref.items() if k != "registry"}


# ---------------------------------------------------------------------------
# 2. the solo pipeline, draws pinned


@contextlib.contextmanager
def _pinned_jax(noise: np.ndarray, latents: list):
    """Every ``jax.random.normal`` the JAX modules trace returns ``noise``
    (broadcast to the draw's shape), and each VAE decode appends its input
    latents to ``latents``; executables traced under the patch are dropped
    before and after."""
    real_normal, real_decode = jax.random.normal, JaxVAE.decode

    def pinned(key, shape=(), dtype=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(noise, dtype), shape)

    def decode(self, z):
        jax.debug.callback(lambda v: latents.append(np.asarray(v)), z)
        return real_decode(self, z)

    GLOBAL_CACHE.flush_executables()
    jax.random.normal, JaxVAE.decode = pinned, decode
    try:
        yield
    finally:
        jax.random.normal, JaxVAE.decode = real_normal, real_decode
        GLOBAL_CACHE.flush_executables()


@pytest.fixture()
def pinned_port(monkeypatch):
    """Every port draw is the pinned array, row for row; each decode's
    latents are kept."""
    box = {"latents": []}

    def pinned(generators, shape, device="cpu"):
        one = torch.from_numpy(box["noise"]).permute(2, 0, 1)
        assert tuple(one.shape) == tuple(shape)
        return torch.stack([one] * len(generators)).to(device)

    monkeypatch.setattr(tdiff, "randn_rows", pinned)
    return box


def _req(cls, **over):
    kw = dict(prompt="make it snowy", negative_prompt="blurry", steps=4,
              guidance_scale=6.0, height=SIZE, width=SIZE, seed=7,
              init_image=_image(5), image_guidance_scale=1.5)
    kw.update(over)
    return cls(**kw)


@pytest.mark.parametrize("scheduler,ig", [
    (None, 1.5), ("EulerAncestralDiscreteScheduler", 3.0)])
def test_tiny_pix2pix_matches_jax(pipes, pinned_port, monkeypatch,
                                  scheduler, ig):
    jax_pipe, port_pipe = pipes
    noise = np.random.default_rng(12).standard_normal(
        (SIZE // 2, SIZE // 2, 4)).astype(np.float32)
    pinned_port["noise"] = noise
    real = port_pipe._decode_uint8

    def spy(x, tiled=False):
        pinned_port["latents"].append(x.clone())
        return real(x, tiled)

    monkeypatch.setattr(port_pipe, "_decode_uint8", spy)
    j_latents: list = []
    with _pinned_jax(noise, j_latents):
        j_img, j_cfg = jax_pipe(_req(jdiff.GenerateRequest,
                                     scheduler=scheduler,
                                     image_guidance_scale=ig))
    t_img, t_cfg = port_pipe(_req(tdiff.GenerateRequest,
                                  scheduler=scheduler,
                                  image_guidance_scale=ig))
    j_img = np.asarray(j_img)
    assert t_img.shape == j_img.shape == (1, SIZE, SIZE, 3)
    diff = np.abs(t_img.astype(np.int16) - j_img.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_img.std() > 1.0
    (t_lat,), (j_lat,) = pinned_port["latents"], j_latents
    np.testing.assert_allclose(t_lat.permute(0, 2, 3, 1).numpy(), j_lat,
                               atol=2e-4)
    assert t_cfg == j_cfg
    assert t_cfg["mode"] == "pix2pix" and t_cfg["image_guidance_scale"] == ig
    assert t_cfg["denoise_steps"] == t_cfg["unet_evals"] == 4


def test_image_guidance_steers_the_image(pipes):
    """The image guidance reaches the combine: another scale, another
    image; the same request twice, the same bits."""
    port_pipe = pipes[1]
    a, _ = port_pipe(_req(tdiff.GenerateRequest, steps=2))
    b, _ = port_pipe(_req(tdiff.GenerateRequest, steps=2))
    c, _ = port_pipe(_req(tdiff.GenerateRequest, steps=2,
                          image_guidance_scale=3.0))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ---------------------------------------------------------------------------
# 3. the refusals


def _control_bundle():
    from chiaswarm_tpu_torch.pipelines.components import ControlNetBundle

    return ControlNetBundle.random("tiny_p2p", device="cpu")


@pytest.mark.parametrize("over,match", [
    (dict(init_image=None), "start_image_uri is required"),
    (dict(mask=np.ones((SIZE, SIZE), np.float32)), "do not take a mask"),
    ("controlnet", "do not support controlnet"),
])
def test_refusals_match_jax(pipes, over, match):
    jax_pipe, port_pipe = pipes
    if over == "controlnet":
        j_over = dict(controlnet=object(), control_image=_image(6))
        t_over = dict(controlnet=_control_bundle(), control_image=_image(6))
    else:
        j_over = t_over = over
    with pytest.raises(ValueError, match=match) as ref:
        jax_pipe(_req(jdiff.GenerateRequest, **j_over))
    with pytest.raises(ValueError, match=match) as got:
        port_pipe(_req(tdiff.GenerateRequest, **t_over))
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# 4. the executor: solo only


def _job(**over):
    job = {"id": "p2p", "model_name": "tiny_p2p", "prompt": "add rain",
           "num_inference_steps": 3, "seed": 4, "content_type": "image/png",
           "image": _image(8), "image_guidance_scale": 2.0}
    job.update(over)
    return job


def test_pix2pix_jobs_are_not_lane_eligible():
    from chiaswarm_tpu.workloads.diffusion import (
        stepper_eligible as jax_eligible,
    )
    from chiaswarm_tpu_torch.workloads.diffusion import stepper_eligible

    kwargs = _job()
    assert stepper_eligible(kwargs) is False
    assert jax_eligible(kwargs) is False


def test_executor_serves_pix2pix_solo_like_jax(monkeypatch):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    catalog = [{"name": "tiny_p2p", "family": "tiny_p2p"}]
    ref = jax_do_work(_job(), JaxPool(n_slots=1).slots[0],
                      JaxRegistry(catalog=catalog, allow_random=True))
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(
            _job(), slot, ModelRegistry(catalog=catalog, allow_random=True,
                                        device="cpu"))
        assert get_stepper(slot).stats().get("steps_executed", 0) == 0
    finally:
        get_stepper(slot).shutdown()
    cfg, ref_cfg = got["pipeline_config"], ref["pipeline_config"]
    assert "error" not in cfg and "error" not in ref_cfg, (cfg, ref_cfg)
    assert "stepper" not in cfg
    assert set(cfg) == set(ref_cfg)
    for key in ("mode", "image_guidance_scale", "steps", "denoise_steps",
                "size", "family", "seed"):
        assert cfg[key] == ref_cfg[key], key
    assert cfg["mode"] == "pix2pix" and cfg["image_guidance_scale"] == 2.0


# ---------------------------------------------------------------------------
# 5. the 8-channel checkpoint


def test_eight_channel_checkpoint_loads_through_the_registry(tmp_path,
                                                             monkeypatch):
    """The carried-across ``conv_in`` is (32, 8, 3, 3), and a diffusers
    directory of it loads under the pix2pix name's catalog family with no
    random fallback, every tensor equal."""
    from chiaswarm_tpu.pipelines.components import Components as JC
    from chiaswarm_tpu_torch.convert.from_jax import params_from_flax
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.node.registry import model_dir

    state = params_from_flax(jax.tree.map(np.asarray,
                                          JC.random("tiny_p2p").params),
                             "tiny_p2p")
    assert tuple(state["unet"]["conv_in.weight"].shape) == (32, 8, 3, 3)
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    root = model_dir(P2P)
    subdirs = {"unet": "unet", "vae": "vae", "text_encoder_0": "text_encoder"}
    for name, sub in subdirs.items():
        (root / sub).mkdir(parents=True)
        save_file(state[name], root / sub / "model.safetensors")
    registry = ModelRegistry(catalog=[{"name": P2P, "family": "tiny_p2p"}],
                             device="cpu")
    pipe = registry.pipeline(P2P)
    assert pipe.c.family.name == "tiny_p2p"
    loaded = {"unet": pipe.c.unet, "vae": pipe.c.vae,
              "text_encoder_0": pipe.c.text_encoders[0]}
    for name, module in loaded.items():
        got = module.state_dict()
        for key, value in state[name].items():
            assert torch.equal(got[key], value), (name, key)
    img, cfg = pipe(_req(tdiff.GenerateRequest, steps=2))
    assert img.shape == (1, SIZE, SIZE, 3) and cfg["mode"] == "pix2pix"
