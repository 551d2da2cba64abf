"""The video models of the port against the JAX package, on the CPU.

At ``TINY_VID``/``TINY_SVD`` in float32, F = 3 frames and B = 2 clips:

- ``UNet3D``, ``UNetSpatioTemporal`` (with its ``time_ids``) and the
  temporal VAE decoder against the JAX modules at 2e-4 relative to the
  output's scale, the params carried across by
  ``convert/from_jax.py::video_state_from_flax``. The JAX params come from
  the published-name references of ``tests/torch_video_ref.py``, seeded
  and randomised (every leaf, the zero ``conv4``s and the blend factors
  too), through JAX's own converters, so no JAX init runs;
- the port's modules loading those references' state dicts strictly and
  matching their forwards;
- the full ``MODELSCOPE``/``SVD`` configs: the port's state-dict keys and
  shapes against the references', both built on the ``meta`` device;
- ``make_edm_schedule``'s tables against JAX's;
- diffusers-layout snapshots written here and loaded by both packages: a
  ModelScope and an SVD snapshot (tensors equal), a plain SD snapshot
  inflated into the text family (the inflated UNets agree), and the
  truncated-snapshot and SVD-refuses-2D cases raising as JAX raises them.

:func:`tiny_components` builds the two packages' components over one set of
tiny weights; the pipeline and workflow tests import it.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert.torch_to_flax import (
    convert_clip_vision,
    convert_temporal_vae,
    convert_text_encoder,
    convert_unet3d,
    convert_unet_spatio_temporal,
    convert_vae,
)
from chiaswarm_tpu.models.clip import ClipTextEncoder as JaxText
from chiaswarm_tpu.models.clip import ClipVisionEncoder as JaxVision
from chiaswarm_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from chiaswarm_tpu.pipelines import video as jvideo
from chiaswarm_tpu.schedulers.sampling import make_edm_schedule as jax_edm
from chiaswarm_tpu_torch.convert.from_jax import video_state_from_flax
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.models.clip import ClipTextEncoder, ClipVisionEncoder
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.models.vae import AutoencoderKL, TemporalDecoder
from chiaswarm_tpu_torch.models.video_unet import UNet3D, UNetSpatioTemporal
from chiaswarm_tpu_torch.pipelines import video as tvideo
from chiaswarm_tpu_torch.pipelines.components import flax_default_init
from chiaswarm_tpu_torch.schedulers import make_edm_schedule
from tests.torch_video_ref import (
    TemporalDecoderRef,
    UNet3DRef,
    UNetSpatioTemporalRef,
    randomize_,
)

B, F, HW = 2, 3, 16
BAR = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def np_state(module: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in
            module.state_dict().items()}


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Flax's default init, norms and the vision tower's class embedding
    perturbed so they matter."""
    gen = torch.Generator().manual_seed(seed)
    flax_default_init(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                m.weight.add_(0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.2 * torch.randn(m.bias.shape, generator=gen))
        if isinstance(module, ClipVisionEncoder):
            module.vision_model.embeddings.class_embedding.normal_(
                0, 0.5, generator=gen)
    return module.eval()


def published_states(name: str, seed: int = 0
                     ) -> dict[str, dict[str, np.ndarray]]:
    """Seeded tiny weights of family ``name`` in the published (diffusers /
    transformers) names: the UNet and the temporal decoder from
    ``torch_video_ref`` (every leaf random), the rest from the port's own
    modules."""
    fam = tvideo.VIDEO_FAMILIES[name]
    vae = _seeded(AutoencoderKL(fam.vae), seed + 1)
    if fam.image_conditioned:
        unet = UNetSpatioTemporalRef(fam.unet)
        dec = TemporalDecoderRef(fam.vae)
        randomize_(dec, seed + 2)
        vae_state = {k: v for k, v in np_state(vae).items()
                     if not k.startswith(("decoder.", "post_quant_conv."))}
        vae_state.update({f"decoder.{k}": v for k, v in np_state(dec).items()})
        cond = ("image_encoder", _seeded(ClipVisionEncoder(fam.vision),
                                         seed + 3))
    else:
        unet = UNet3DRef(fam.unet)
        vae_state = np_state(vae)
        cond = ("text_encoder", _seeded(ClipTextEncoder(fam.text_encoder),
                                        seed + 3))
    randomize_(unet, seed)
    return {"unet": np_state(unet), "vae": vae_state,
            cond[0]: np_state(cond[1])}


def jax_params(name: str, states: dict[str, dict[str, np.ndarray]]) -> dict:
    """JAX's ``VideoComponents.params`` of published-name state dicts,
    through JAX's converters."""
    fam = jvideo.VIDEO_FAMILIES[name]
    if fam.image_conditioned:
        return {"unet": convert_unet_spatio_temporal(states["unet"], fam.unet),
                "vae": convert_temporal_vae(states["vae"], fam.vae),
                "image_encoder": convert_clip_vision(states["image_encoder"])}
    return {"unet": convert_unet3d(states["unet"], fam.unet),
            "vae": convert_vae(states["vae"], fam.vae),
            "text_encoder": convert_text_encoder(states["text_encoder"])}


def jax_components(name: str, params: dict) -> jvideo.VideoComponents:
    fam = jvideo.VIDEO_FAMILIES[name]
    text = tokenizer = vision = None
    if fam.image_conditioned:
        vision = JaxVision(fam.vision)
    else:
        te = fam.text_encoder
        text = JaxText(te)
        tokenizer = JaxHashTokenizer(te.vocab_size,
                                     te.max_position_embeddings,
                                     te.eos_token_id)
    return jvideo.VideoComponents(
        family=fam, model_name=f"random/{name}", tokenizer=tokenizer,
        text_encoder=text, unet=jvideo.make_video_unet(fam),
        vae=jvideo.make_video_vae(fam), params=params, image_encoder=vision)


def tiny_components(name: str, seed: int = 0
                    ) -> tuple[jvideo.VideoComponents,
                               tvideo.VideoComponents]:
    """(JAX, port) components of family ``name`` over one set of seeded
    tiny weights, the port's carried across from JAX's."""
    params = jax_params(name, published_states(name, seed))
    return jax_components(name, params), tvideo.VideoComponents.from_jax(
        params, name, device="cpu")


@pytest.fixture(scope="module")
def vid():
    states = published_states("tiny_vid")
    params = jax_params("tiny_vid", states)
    return states, params, tvideo.VideoComponents.from_jax(
        params, "tiny_vid", device="cpu")


@pytest.fixture(scope="module")
def svd():
    states = published_states("tiny_svd", seed=4)
    params = jax_params("tiny_svd", states)
    return states, params, tvideo.VideoComponents.from_jax(
        params, "tiny_svd", device="cpu")


_JAX_APPLY: dict[str, object] = {}


def _jax_unet(name: str, params: dict, sample, t, ctx, added=None):
    """One jitted apply per family, so every call at the file's shapes
    reuses one executable."""
    if name not in _JAX_APPLY:
        _JAX_APPLY[name] = jax.jit(jvideo.make_video_unet(
            jvideo.VIDEO_FAMILIES[name]).apply)
    return np.asarray(_JAX_APPLY[name](params, sample, t, ctx, added))


def _inputs(name: str, seed: int = 1):
    """(sample (B, F, H, W, C), t, ctx, added) in JAX's layout."""
    fam = tvideo.VIDEO_FAMILIES[name]
    rng = np.random.default_rng(seed)
    sample = rng.normal(size=(B, F, HW, HW, fam.unet.sample_channels)
                        ).astype(np.float32)
    ctx = rng.normal(size=(B, 1 if fam.image_conditioned else 7,
                           fam.unet.cross_attention_dim)).astype(np.float32)
    if fam.image_conditioned:
        # continuous EDM timesteps, 0.25 log(sigma)
        t = np.asarray([0.7, -1.2], np.float32)
        added = {"time_ids": np.asarray([[6.0, 127.0, 0.02],
                                         [7.0, 60.0, 0.1]], np.float32)}
    else:
        t = np.asarray([3.0, 250.0], np.float32)
        added = None
    return sample, t, ctx, added


def _port_unet(unet, sample, t, ctx, added) -> np.ndarray:
    """The port's UNet on JAX-layout inputs; its output back in JAX's
    layout (B, F, H, W, C)."""
    with torch.no_grad():
        out = unet(torch.from_numpy(sample).permute(0, 1, 4, 2, 3),
                   torch.from_numpy(t), torch.from_numpy(ctx),
                   None if added is None
                   else {"time_ids": torch.from_numpy(added["time_ids"])})
    return out.permute(0, 1, 3, 4, 2).numpy()


def _close(got: np.ndarray, want: np.ndarray, bar: float = BAR) -> None:
    """Within ``bar`` of the output's scale (its largest magnitude)."""
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"max abs {err} at scale {scale}"
    assert np.abs(want).mean() > 1e-2


# ---------------------------------------------------------------------------
# 1. the modules against JAX


@pytest.mark.parametrize("name", ["tiny_vid", "tiny_svd"])
def test_video_unet_matches_jax(name, vid, svd):
    _, params, components = vid if name == "tiny_vid" else svd
    sample, t, ctx, added = _inputs(name)
    want = _jax_unet(name, params["unet"], sample, t, ctx, added)
    got = _port_unet(components.unet, sample, t, ctx, added)
    assert got.shape == want.shape == sample.shape[:-1] + (4,)
    _close(got, want)


def test_temporal_vae_decoder_matches_jax(svd):
    _, params, components = svd
    fam = jvideo.VIDEO_FAMILIES["tiny_svd"]
    z = np.random.default_rng(7).normal(size=(B, F, 4, 4, 4)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, z: jvideo.make_video_vae(fam).apply(
        p, z, method="decode"))(params["vae"], z))
    with torch.no_grad():
        got = components.vae.decode(torch.from_numpy(z).permute(
            0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2).numpy()
    assert got.shape == want.shape == (B, F, 8, 8, 3)
    _close(got, want)


def test_temporal_vae_encode_moments_match_jax(svd):
    _, params, components = svd
    fam = jvideo.VIDEO_FAMILIES["tiny_svd"]
    x = np.random.default_rng(8).uniform(-1, 1, (B, 8, 8, 3)).astype(
        np.float32)
    mean, logvar = jax.jit(lambda p, x: jvideo.make_video_vae(fam).apply(
        p, x, method="encode_moments"))(params["vae"], x)
    with torch.no_grad():
        t_mean, t_logvar = components.vae.encode_moments(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(t_mean.permute(0, 2, 3, 1).numpy(), np.asarray(mean))
    _close(t_logvar.permute(0, 2, 3, 1).numpy(), np.asarray(logvar))


def test_video_state_from_flax_inverts_jax_converters(vid, svd):
    """The published-name weights, through JAX's converters and back
    through ``video_state_from_flax``, are the weights (the conditioning
    towers', the UNets' and the VAEs' every tensor)."""
    for states, params, _ in (vid, svd):
        fam_name = ("tiny_svd" if "image_encoder" in params else "tiny_vid")
        back = video_state_from_flax(params, tvideo.VIDEO_FAMILIES[fam_name])
        for name, state in states.items():
            assert set(back[name]) == set(state), name
            for key, value in state.items():
                np.testing.assert_array_equal(back[name][key].numpy(), value,
                                              err_msg=f"{name}.{key}")


def test_edm_timesteps_stay_continuous(svd):
    """The SVD UNet's timestep embedding takes the EDM ladder's float32
    timesteps as they are: two timesteps a rounding would merge give
    different predictions."""
    _, _, components = svd
    sample, _, ctx, added = _inputs("tiny_svd")
    a = _port_unet(components.unet, sample, np.asarray([0.2, 0.2], np.float32),
                   ctx, added)
    b = _port_unet(components.unet, sample, np.asarray([0.4, 0.4], np.float32),
                   ctx, added)
    assert np.abs(a - b).max() > 1e-3


# ---------------------------------------------------------------------------
# 2. the published names


@pytest.mark.parametrize("name", ["tiny_vid", "tiny_svd"])
def test_port_unet_loads_the_reference_strictly(name):
    fam = tvideo.VIDEO_FAMILIES[name]
    ref_cls, port_cls = ((UNetSpatioTemporalRef, UNetSpatioTemporal)
                         if fam.image_conditioned else (UNet3DRef, UNet3D))
    ref = ref_cls(fam.unet).eval()
    randomize_(ref, seed=5)
    port = port_cls(fam.unet).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    sample, t, ctx, added = _inputs(name, seed=2)
    with torch.no_grad():
        if fam.image_conditioned:
            want = ref(torch.from_numpy(sample).permute(0, 1, 4, 2, 3),
                       torch.from_numpy(t), torch.from_numpy(ctx),
                       torch.from_numpy(added["time_ids"]))
            want = want.permute(0, 1, 3, 4, 2).numpy()
        else:
            want = ref(torch.from_numpy(sample).permute(0, 4, 1, 2, 3),
                       torch.from_numpy(t), torch.from_numpy(ctx))
            want = want.permute(0, 2, 3, 4, 1).numpy()
    _close(_port_unet(port, sample, t, ctx, added), want)


def test_port_temporal_decoder_loads_the_reference_strictly():
    fam = tvideo.TINY_SVD
    ref = TemporalDecoderRef(fam.vae).eval()
    randomize_(ref, seed=6)
    port = TemporalDecoder(fam.vae).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    z = torch.randn((B, F, 4, 4, 4), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = ref(z, F).numpy()
        got = port(z).numpy()
    _close(got, want)


@pytest.mark.parametrize("module", ["modelscope_unet", "svd_unet",
                                    "svd_temporal_decoder"])
def test_full_published_configs_match_the_reference_layouts(module):
    """At the published widths (~1.4 B parameters a UNet, on the ``meta``
    device, no storage): the port's parameter names and shapes are the
    published layouts'."""
    build = {
        "modelscope_unet": (lambda: UNet3DRef(tvideo.MODELSCOPE.unet),
                            lambda: UNet3D(tvideo.MODELSCOPE.unet)),
        "svd_unet": (lambda: UNetSpatioTemporalRef(tvideo.SVD.unet),
                     lambda: UNetSpatioTemporal(tvideo.SVD.unet)),
        "svd_temporal_decoder": (lambda: TemporalDecoderRef(tvideo.SVD.vae),
                                 lambda: TemporalDecoder(tvideo.SVD.vae)),
    }[module]
    with torch.device("meta"):
        ref, port = build[0](), build[1]()
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    if module == "modelscope_unet":
        # transformer_in: 8 heads of 64 at the 320-channel stem
        assert got["transformer_in.proj_in.weight"] == (512, 320)
        assert sum(np.prod(s) for s in got.values()) > 1.3e9


# ---------------------------------------------------------------------------
# 3. the EDM schedule


@pytest.mark.parametrize("steps", [1, 2, 14, 25])
def test_edm_schedule_matches_jax(steps):
    """The float32 ladders agree to the last few bits: XLA's float32 pow and
    log are not PyTorch's (over 1-100 steps the sigmas part by at most
    7.7e-6 relative, the timesteps by 1.9e-6 of their 3.1-wide range)."""
    want = jax_edm(0.002, 700.0, steps)
    got = make_edm_schedule(0.002, 700.0, steps)
    assert got.sigmas.dtype == got.timesteps.dtype == torch.float32
    assert got.sigmas.shape == (steps + 1,) and float(got.sigmas[-1]) == 0.0
    np.testing.assert_allclose(got.sigmas.numpy(), np.asarray(want.sigmas),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.timesteps.numpy(),
                               np.asarray(want.timesteps), rtol=0, atol=3e-6)
    # the continuous conditioning, not a train step
    np.testing.assert_allclose(got.timesteps.numpy(),
                               0.25 * np.log(got.sigmas[:-1].numpy()),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# 4. snapshots loaded by both packages


def write_snapshot(root, states: dict[str, dict[str, np.ndarray]]) -> None:
    """A diffusers-layout snapshot: one directory of safetensors per
    module."""
    for sub, state in states.items():
        (root / sub).mkdir(parents=True, exist_ok=True)
        save_file({k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in state.items()},
                  root / sub / "diffusion_pytorch_model.safetensors")


def _port_states(components: tvideo.VideoComponents) -> dict:
    cond = ("image_encoder" if components.family.image_conditioned
            else "text_encoder")
    return {cond: getattr(components, cond).state_dict(),
            "unet": components.unet.state_dict(),
            "vae": components.vae.state_dict()}


@pytest.mark.parametrize("name", ["tiny_vid", "tiny_svd"])
def test_a_video_snapshot_loads_alike_in_both_packages(name, vid, svd,
                                                       tmp_path):
    states = (vid if name == "tiny_vid" else svd)[0]
    write_snapshot(tmp_path, states)
    port = tvideo.VideoComponents.from_checkpoint(tmp_path, "snap", name,
                                                  device="cpu")
    jc = jvideo.VideoComponents.from_checkpoint(tmp_path, "snap", name)
    want = video_state_from_flax(jax.tree.map(np.asarray, jc.params),
                                 tvideo.VIDEO_FAMILIES[name])
    got = _port_states(port)
    for module, state in want.items():
        assert set(got[module]) == set(state), module
        for key, value in state.items():
            assert torch.equal(got[module][key], value), f"{module}.{key}"
    # the trained temporal weights landed: a temporal leaf equals the file
    key = ("mid_block.resnets.0.time_mixer.mix_factor"
           if name == "tiny_svd"
           else "down_blocks.0.temp_convs.0.conv4.3.weight")
    np.testing.assert_array_equal(got["unet"][key].numpy(),
                                  states["unet"][key])
    assert np.abs(states["unet"][key]).max() > 0


def _plain_sd_states(seed: int = 9) -> dict[str, dict[str, np.ndarray]]:
    """A plain SD snapshot at the text family's widths (the 2D UNet)."""
    fam = tvideo.TINY_VID
    states = published_states("tiny_vid", seed)
    states["unet"] = np_state(_seeded(UNet(fam.unet), seed))
    return states


def test_a_plain_sd_snapshot_inflates_as_in_jax(tmp_path):
    """The spatial weights land from the file, the temporal modules start
    at identity (zero output projections, unit norms), so both packages'
    inflated UNets compute the same clip prediction."""
    states = _plain_sd_states()
    write_snapshot(tmp_path, states)
    port = tvideo.VideoComponents.from_checkpoint(tmp_path, "sd2d",
                                                  "tiny_vid", device="cpu")
    jc = jvideo.VideoComponents.from_checkpoint(tmp_path, "sd2d", "tiny_vid")
    unet = port.unet.state_dict()
    for key, value in states["unet"].items():
        np.testing.assert_array_equal(unet[key].numpy(), value, err_msg=key)
    for key, value in unet.items():
        if key.endswith(("conv4.3.weight", "proj_out.weight",
                         "to_out.0.weight")) and ("temp" in key or key.startswith(
                             "transformer_in")):
            assert not value.any(), key
        if key.endswith("norm.weight") and "temp_attentions" in key:
            assert torch.equal(value, torch.ones_like(value)), key
    sample, t, ctx, added = _inputs("tiny_vid", seed=3)
    want = _jax_unet("tiny_vid", jc.params["unet"], sample, t, ctx, added)
    _close(_port_unet(port.unet, sample, t, ctx, added), want)


def test_a_truncated_video_snapshot_is_refused_as_in_jax(vid, tmp_path):
    states = {k: dict(v) for k, v in vid[0].items()}
    states["unet"].pop("mid_block.temp_attentions.0.proj_out.weight")
    write_snapshot(tmp_path, states)
    with pytest.raises(ValueError, match="missing") as jax_err:
        jvideo.VideoComponents.from_checkpoint(tmp_path, "cut", "tiny_vid")
    with pytest.raises(ValueError, match="missing") as port_err:
        tvideo.VideoComponents.from_checkpoint(tmp_path, "cut", "tiny_vid",
                                               device="cpu")
    # the same words; JAX names the Flax leaf, the port the checkpoint key
    assert str(port_err.value) == str(jax_err.value).replace(
        "params/mid_tattn/proj_out/kernel",
        "mid_block.temp_attentions.0.proj_out.weight")


def test_an_svd_family_refuses_a_2d_snapshot_as_in_jax(tmp_path):
    write_snapshot(tmp_path, _plain_sd_states())
    with pytest.raises(ValueError, match="spatio-temporal") as jax_err:
        jvideo.VideoComponents.from_checkpoint(tmp_path, "bad", "tiny_svd")
    with pytest.raises(ValueError, match="spatio-temporal") as port_err:
        tvideo.VideoComponents.from_checkpoint(tmp_path, "bad", "tiny_svd",
                                               device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_random_components_take_the_published_inits():
    """Seeded random weights: every ``mix_factor`` at its published
    constant (0.5 in the UNet, 0.0 in the temporal decoder), every
    ``conv4`` zero, and the same seed the same weights."""
    a = tvideo.VideoComponents.random("tiny_svd", seed=1, device="cpu")
    b = tvideo.VideoComponents.random("tiny_svd", seed=1, device="cpu")
    for key, value in a.unet.state_dict().items():
        assert torch.equal(value, b.unet.state_dict()[key]), key
        if key.endswith("mix_factor"):
            assert float(value) == 0.5, key
    mixes = [v for k, v in a.vae.state_dict().items()
             if k.endswith("mix_factor")]
    assert mixes and all(float(v) == 0.0 for v in mixes)
    ms = tvideo.VideoComponents.random("tiny_vid", seed=1, device="cpu")
    conv4 = [v for k, v in ms.unet.state_dict().items() if ".conv4.3." in k]
    assert conv4 and not any(v.any() for v in conv4)
    assert a.param_bytes() == sum(
        p.numel() * 4 for m in a.modules() for p in m.parameters())
