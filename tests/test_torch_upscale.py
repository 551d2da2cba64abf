"""The port's x2 latent upscale pass and tiled VAE decode, against the JAX
package.

- ``tiled_decode`` on the tiny VAE over a latent of several tiles within 2e-4
  of JAX's, and a latent of one tile bit for bit the plain decode.
- ``LatentUpscalePipeline`` on ``tiny_up``: the image within one uint8 level
  of JAX's with every draw pinned on both sides (one array per draw shape),
  the output size, the config keys, and ``first_row`` reproducing row i.
- One upscaler UNet eval with the spatial self-attention forced to
  ``"flash"`` (B1's plain version on the CPU) against JAX flash in interpret
  mode.
- The registry's class selection (the x2 and the x4 served by kind), ``diffusion_callback`` with ``upscale=True`` end to end
  against JAX's, the routing of ``parameters.upscale`` to the solo path, and
  a node without the upscaler's directory.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.core.compile_cache import GLOBAL_CACHE
from chiaswarm_tpu.models.unet import UNet as JaxUNet
from chiaswarm_tpu.models.vae import tiled_decode as jax_tiled_decode
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.upscale import (
    LatentUpscalePipeline as JaxUpscaler,
)
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.models.configs import FAMILIES
from chiaswarm_tpu_torch.models.vae import tiled_decode
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.pipelines import upscale as tup
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl
from chiaswarm_tpu_torch.serving.stepper import get_stepper

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _image(seed: int, size: int = SIZE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                                dtype=np.uint8)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tiny_vae():
    """(JAX components, port components) of ``tiny`` over one param set."""
    jc = JaxComponents.random("tiny", seed=0)
    return jc, Components.from_jax(jax.tree.map(np.asarray, jc.params),
                                   "tiny", device="cpu")


# ---------------------------------------------------------------------------
# 1. tiled decode


@pytest.mark.parametrize("hw", [(100, 72), (64, 130)])
def test_tiled_decode_matches_jax(tiny_vae, hw):
    """Several tiles (2 x 2 and 1 x 3 at tile 64, overlap 8), the last tile
    pulled back to the edge: the blend within 2e-4 of JAX's."""
    jc, tc = tiny_vae
    z = np.random.default_rng(1).standard_normal((1, *hw, 4)).astype(
        np.float32)
    ref = jax.jit(lambda p, x: jax_tiled_decode(jc.vae, p, x))(
        jc.params["vae"], jnp.asarray(z))
    with torch.no_grad():
        got = tiled_decode(tc.vae, _nchw(z))
    f = tc.family.vae.downscale
    assert got.shape == (1, 3, hw[0] * f, hw[1] * f)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-4)


def test_one_tile_is_the_plain_decode(tiny_vae):
    jc, tc = tiny_vae
    z = np.random.default_rng(2).standard_normal((2, 64, 48, 4)).astype(
        np.float32)
    with torch.no_grad():
        got = tiled_decode(tc.vae, _nchw(z))
        plain = tc.vae.decode(_nchw(z))
    assert torch.equal(got, plain.float())
    ref = jax.jit(lambda p, x: jax_tiled_decode(jc.vae, p, x))(
        jc.params["vae"], jnp.asarray(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-4)


def test_tiled_request_decodes_through_the_tiles(monkeypatch):
    """``GenerateRequest.tiled_decode`` takes ``tiled_decode`` and keeps
    the image the plain decode gives (one tile at 64 px)."""
    from chiaswarm_tpu_torch.pipelines import diffusion as tdiff

    pipe = tdiff.DiffusionPipeline(Components.random("tiny", device="cpu"))
    req = tdiff.GenerateRequest(prompt="p", steps=2, height=SIZE, width=SIZE,
                                seed=3)
    plain, _ = pipe(req)
    calls = []
    real = tdiff.tiled_decode

    def spy(vae, z, **kw):
        calls.append(tuple(z.shape))
        return real(vae, z, **kw)

    monkeypatch.setattr(tdiff, "tiled_decode", spy)
    tiled, _ = pipe(dataclasses.replace(req, tiled_decode=True))
    assert calls == [(1, 4, SIZE // 2, SIZE // 2)]
    np.testing.assert_array_equal(tiled, plain)


# ---------------------------------------------------------------------------
# 2. the upscaler pipeline, draws pinned


@pytest.fixture(scope="module")
def upscalers():
    """(JAX, port) tiny_up upscalers over the same weights."""
    jc = JaxComponents.random("tiny_up", seed=0)
    port = Components.from_jax(jax.tree.map(np.asarray, jc.params),
                               "tiny_up", device="cpu")
    return JaxUpscaler(jc), tup.LatentUpscalePipeline(port)


def _draws(lh: int) -> dict:
    """One array per draw shape (H, W, C): the posterior at the low-res
    grid, the initial and step noise at the 2x grid."""
    rng = np.random.default_rng(9)
    return {(n, n, 4): rng.standard_normal((n, n, 4)).astype(np.float32)
            for n in (lh, 2 * lh)}


@contextlib.contextmanager
def _pinned_jax(table: dict):
    real = jax.random.normal

    def pinned(key, shape=(), dtype=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(table[tuple(shape[-3:])], dtype),
                                shape)

    GLOBAL_CACHE.flush_executables()
    jax.random.normal = pinned
    try:
        yield
    finally:
        jax.random.normal = real
        GLOBAL_CACHE.flush_executables()


@pytest.fixture()
def pinned_port(monkeypatch):
    box = {}

    def pinned(generators, shape, device="cpu"):
        c, h, w = shape
        one = torch.from_numpy(box["table"][(h, w, c)]).permute(2, 0, 1)
        return torch.stack([one] * len(generators)).to(device)

    monkeypatch.setattr(tup, "randn_rows", pinned)
    return box


@pytest.mark.parametrize("scheduler", [None,
                                       "EulerAncestralDiscreteScheduler"])
def test_tiny_upscaler_matches_jax(upscalers, pinned_port, scheduler):
    jax_up, port_up = upscalers
    table = _draws(SIZE // 2)
    pinned_port["table"] = table
    images = np.stack([_image(4), _image(5)])
    with _pinned_jax(table):
        ref, ref_cfg = jax_up(images, prompt="sharp photo", steps=2, seed=7,
                              scheduler=scheduler)
    got, cfg = port_up(images, prompt="sharp photo", steps=2, seed=7,
                       scheduler=scheduler)
    assert got.shape == ref.shape == (2, 2 * SIZE, 2 * SIZE, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert got.std() > 1.0
    assert cfg == ref_cfg
    assert set(cfg) == {"upscaler", "scale", "upscale_steps",
                        "upscale_scheduler"}
    assert cfg["scale"] == 2 and cfg["upscale_steps"] == 2


def test_first_row_reproduces_row_i(upscalers):
    port_up = upscalers[1]
    images = np.stack([_image(4), _image(5)])
    batch, cfg = port_up(images, prompt="p", steps=1, seed=11)
    assert batch.shape == (2, 2 * SIZE, 2 * SIZE, 3)
    for i in range(2):
        alone, _ = port_up(images[i], prompt="p", steps=1, seed=11,
                           first_row=i)
        diff = np.abs(alone[0].astype(int) - batch[i].astype(int))
        assert diff.max() <= 1, (i, diff.max())
    other, _ = port_up(images[1], prompt="p", steps=1, seed=11, first_row=0)
    assert not np.array_equal(other[0], batch[1])


def test_unbucketed_input_is_resized_onto_the_bucket(upscalers):
    out, _ = upscalers[1](_image(4, 72)[None, :, :60], prompt="p", steps=1,
                          seed=1)
    assert out.shape == (1, 2 * 128, 2 * 64, 3)


def test_upscaler_eval_through_flash_matches_jax_interpret(upscalers):
    """One eval of the 8-channel UNet with its spatial self-attention forced
    to ``"flash"``: the port's B1 plain version against JAX's Pallas kernel
    in interpret mode."""
    jax_up, port_up = upscalers
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    t = np.array([17.0, 803.5], np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    jax_unet = JaxUNet(dataclasses.replace(FAMILIES["tiny_up"].unet,
                                           attn_impl="flash"))
    ref = jax.jit(jax_unet.apply)(jax_up.c.params["unet"], jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ctx))
    port = Components.from_jax(jax.tree.map(np.asarray, jax_up.c.params),
                               "tiny_up", device="cpu")
    set_attn_impl(port.unet, "flash")
    with torch.no_grad():
        got = port.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-4)


# ---------------------------------------------------------------------------
# 3. the registry, the workload, the routing


def test_registry_selects_the_class_by_kind():
    registry = ModelRegistry(allow_random=True, device="cpu")
    up = registry.pipeline("random/tiny_up")
    assert isinstance(up, tup.LatentUpscalePipeline)
    assert registry.pipeline("random/tiny_up") is up
    snap = registry.residency.snapshot()
    assert snap["resident_bytes"] == up.c.param_bytes()
    up4 = registry.pipeline("random/tiny_up4")
    assert isinstance(up4, tup.Upscale4xPipeline)
    assert registry.pipeline("random/tiny_up4") is up4


@pytest.fixture()
def two_upscale_steps(monkeypatch):
    """The callbacks' upscale pass at 2 steps instead of the hive's 20, in
    both packages (each eval of the tiny upscaler attends over 4,096 tokens
    on the plain path)."""
    for cls in (JaxUpscaler, tup.LatentUpscalePipeline):
        defaults = list(cls.__call__.__defaults__)
        defaults[1] = 2  # (prompt, steps, seed, scheduler, first_row)
        monkeypatch.setattr(cls.__call__, "__defaults__", tuple(defaults))


def test_diffusion_callback_upscales_like_jax(two_upscale_steps):
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.workloads.diffusion import (
        diffusion_callback as jax_callback,
    )
    from chiaswarm_tpu_torch.workloads.diffusion import diffusion_callback

    kwargs = dict(seed=3, prompt="a pier", num_inference_steps=2,
                  height=SIZE, width=SIZE, upscale=True,
                  upscaler_model_name="random/tiny_up",
                  content_type="image/png")
    ref_art, ref_cfg = jax_callback(
        "slot0", "random/tiny", registry=JaxRegistry(catalog=[],
                                                     allow_random=True),
        **kwargs)
    art, cfg = diffusion_callback(
        "slot0", "random/tiny",
        registry=ModelRegistry(allow_random=True, device="cpu"), **kwargs)
    assert set(cfg) == set(ref_cfg)
    for key in ("upscaler", "scale", "upscale_steps", "upscale_scheduler",
                "size", "mode", "steps"):
        assert cfg[key] == ref_cfg[key], key
    assert set(art) == set(ref_art)
    from PIL import Image
    import base64
    import io

    png = Image.open(io.BytesIO(base64.b64decode(art["primary"]["blob"])))
    assert png.size == (2 * SIZE, 2 * SIZE)


def test_upscale_parameter_routes_to_the_solo_path(monkeypatch,
                                                  two_upscale_steps):
    from chiaswarm_tpu_torch.node.job_args import format_args
    from chiaswarm_tpu_torch.workloads.diffusion import stepper_eligible

    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    registry = ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    job = {"id": "u", "model_name": "tiny", "prompt": "p", "seed": 2,
           "num_inference_steps": 2, "height": SIZE, "width": SIZE,
           "content_type": "image/png", "upscaler_model_name":
           "random/tiny_up", "parameters": {"upscale": True}}
    _, kwargs = format_args(dict(job), registry)
    assert kwargs["upscale"] is True and not stepper_eligible(kwargs)
    slot = ChipPool(device="cpu").slots[0]
    try:
        result = executor.synchronous_do_work(dict(job), slot, registry)
        assert get_stepper(slot).stats().get("steps_executed", 0) == 0
    finally:
        get_stepper(slot).shutdown()
    cfg = result["pipeline_config"]
    assert "error" not in cfg and "stepper" not in cfg, cfg
    assert cfg["scale"] == 2 and cfg["upscaler"] == "random/tiny_up"


def test_missing_upscaler_is_not_available(tmp_path, monkeypatch):
    """No directory and no random fallback: the non-fatal
    ``model_unavailable`` envelope, never the un-upscaled image."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")

    class Registry(ModelRegistry):
        def _load_components(self, model_name, device):
            if model_name == "tiny":
                return Components.random("tiny", device=device)
            return super()._load_components(model_name, device)

    registry = Registry(catalog=[{"name": "tiny", "family": "tiny"}],
                        device="cpu")
    job = {"id": "m", "model_name": "tiny", "prompt": "p", "seed": 2,
           "num_inference_steps": 1, "height": SIZE, "width": SIZE,
           "content_type": "image/png", "parameters": {"upscale": True}}
    result = executor.synchronous_do_work(job, ChipPool(device="cpu")
                                          .slots[0], registry)
    cfg = result["pipeline_config"]
    assert cfg["error_kind"] == "model_unavailable"
    assert "not available on this node" in cfg["error"]
    assert "fatal_error" not in result


def test_upscaler_rings_on_a_seq_mesh_like_its_local_run(upscalers):
    """On a ``seq = 4`` CPU mesh the denoise loop and the decode ring their
    self-attentions of 1,024 tokens and more (B3's plain version) and the
    encode stays local; the image within one uint8 level of the local
    run."""
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.parallel.context import capture_ring_calls

    local = upscalers[1]
    mesh = build_mesh(MeshSpec({"seq": 4}), devices=["cpu"] * 4)
    ringed = tup.LatentUpscalePipeline(local.c, mesh=mesh)
    encodes = []
    real = local.c.vae.encode

    def spy(x, noise=None):
        with capture_ring_calls() as calls:
            z = real(x, noise)
        encodes.append(len(calls))
        return z

    local.c.vae.encode = spy
    try:
        with capture_ring_calls() as calls:
            got, _ = ringed(_image(4), prompt="p", steps=1, seed=3)
    finally:
        del local.c.vae.encode
    want, _ = local(_image(4), prompt="p", steps=1, seed=3)
    # the UNet's 3 self-attentions at 4,096 tokens and 4 at 1,024, one
    # step; the VAE decoder's mid block at 4,096
    assert [kind for kind, _ in calls] == ["ring_flash"] * 8
    assert encodes == [0]
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
