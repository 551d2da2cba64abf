"""The port's CLIP text encoder, UNet and VAE against the Flax modules of the
JAX package on the ``tiny`` family, with the JAX params carried across by
``convert.from_jax.params_from_flax``. Inputs come from numpy; the JAX
modules are NHWC and the port's NCHW, so the tests transpose at the seam.

Tolerance 2e-4 in float32: the same weights and inputs, only the order of
float32 sums differs. The UNet runs once more with ``attn_impl="flash"``, so
its spatial self-attention goes through kernel B1's route (the plain
blockwise recurrence on the CPU).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.models.unet import UNet as JaxUNet
from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu_torch.convert.from_jax import params_from_flax
from chiaswarm_tpu_torch.models.common import GroupNorm32, LayerNorm32
from chiaswarm_tpu_torch.models.configs import FAMILIES
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

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


@pytest.fixture(scope="module")
def jax_tiny():
    return JaxComponents.random("tiny", seed=0)


@pytest.fixture(scope="module")
def host_params(jax_tiny):
    return jax.tree.map(np.asarray, jax_tiny.params)


@pytest.fixture(scope="module")
def port_tiny(host_params):
    return Components.from_jax(host_params, "tiny", device="cpu")


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_clip_text_encoder_matches(jax_tiny, port_tiny):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 998, (2, 77)).astype(np.int32)
    ids[0, 12:] = 999   # eos + eos padding
    ids[1, 40:] = 999
    j_seq, j_pool = jax_tiny.text_encoders[0].apply(
        jax_tiny.params["text_encoder_0"], jnp.asarray(ids))
    with torch.no_grad():
        t_seq, t_pool = port_tiny.text_encoders[0](torch.from_numpy(ids))
    np.testing.assert_allclose(t_seq.numpy(), np.asarray(j_seq), **TOL)
    np.testing.assert_allclose(t_pool.numpy(), np.asarray(j_pool), **TOL)


def _unet_inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3.25, 901.0], np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_unet_matches(jax_tiny, host_params, attn_impl):
    x, t, ctx = _unet_inputs(1)
    jax_unet = JaxUNet(dataclasses.replace(FAMILIES["tiny"].unet,
                                           attn_impl=attn_impl))
    ref = jax_unet.apply(jax_tiny.params["unet"], jnp.asarray(x),
                         jnp.asarray(t), jnp.asarray(ctx))
    port = Components.from_jax(host_params, "tiny", device="cpu")
    set_attn_impl(port.unet, attn_impl)
    with torch.no_grad():
        got = port.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_unet_context_unbroadcast_and_one_key(jax_tiny, port_tiny):
    """A per-sample context that divides the query batch, and the
    one-key shortcut, take the JAX module's branches."""
    x, t, _ = _unet_inputs(2)
    rng = np.random.default_rng(3)
    for ctx in (rng.standard_normal((1, 77, 32)).astype(np.float32),
                rng.standard_normal((2, 1, 32)).astype(np.float32)):
        ref = jax_tiny.unet.apply(jax_tiny.params["unet"], jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ctx))
        with torch.no_grad():
            got = port_tiny.unet(_nchw(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx))
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_vae_decode_matches(jax_tiny, port_tiny):
    z = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jax_tiny.vae.apply(jax_tiny.params["vae"], jnp.asarray(z),
                             method=JaxVAE.decode)
    with torch.no_grad():
        got = port_tiny.vae.decode(_nchw(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_vae_encode_matches(jax_tiny, port_tiny):
    img = np.random.default_rng(5).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mean_ref, logvar_ref = jax_tiny.vae.apply(
        jax_tiny.params["vae"], jnp.asarray(img), method=JaxVAE.encode_moments)
    ref = jax_tiny.vae.apply(jax_tiny.params["vae"], jnp.asarray(img),
                             method=JaxVAE.encode)
    with torch.no_grad():
        mean, logvar = port_tiny.vae.encode_moments(_nchw(img))
        got = port_tiny.vae.encode(_nchw(img))
    np.testing.assert_allclose(_nhwc(mean), np.asarray(mean_ref), **TOL)
    np.testing.assert_allclose(_nhwc(logvar), np.asarray(logvar_ref), **TOL)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("module", ["unet", "vae", "text_encoder_0"])
def test_params_from_flax_agrees_with_the_independent_exporter(
        jax_tiny, host_params, module):
    """tests/torch_export.py maps Flax -> diffusers names in the other
    direction; both must give the same tensors under the same names. The
    exporter writes the VAE mid attention's output projection under the
    older ``to_out`` name, diffusers' current ``AutoencoderKL`` (and the
    port) under ``to_out.0``."""
    from tests import torch_export as exp

    n_unet = len(FAMILIES["tiny"].unet.block_out_channels)
    n_vae = len(FAMILIES["tiny"].vae.block_out_channels)
    exported = {
        "unet": lambda: exp.export_unet(jax_tiny.params["unet"], n_unet),
        "vae": lambda: exp.export_vae(jax_tiny.params["vae"], n_vae),
        "text_encoder_0": lambda: exp.export_text_encoder(
            jax_tiny.params["text_encoder_0"]),
    }[module]()
    if module == "vae":
        exported = {k.replace(".attentions.0.to_out.", ".attentions.0.to_out.0."): v
                    for k, v in exported.items()}
    ours = params_from_flax(host_params, "tiny")[module]
    assert set(ours) == set(exported)
    for name, value in exported.items():
        np.testing.assert_array_equal(ours[name].numpy(), value, err_msg=name)


def test_params_from_flax_refuses_a_mismatched_tree(host_params):
    broken = dict(host_params)
    unet = {"params": dict(host_params["unet"]["params"])}
    unet["params"].pop("conv_in")
    broken["unet"] = unet
    with pytest.raises(KeyError, match="conv_in"):
        params_from_flax(broken, "tiny")
    extra = dict(host_params)
    extra["vae"] = {"params": {**host_params["vae"]["params"],
                               "stray": {"kernel": np.zeros((1, 1))}}}
    with pytest.raises(ValueError, match="no counterpart"):
        params_from_flax(extra, "tiny")


def test_random_components_follow_flax_defaults():
    c = Components.random("tiny", seed=3, device="cpu")
    w = c.unet.conv_in.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.3 * fan_in ** -0.5
    assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(c.unet.conv_in.bias) == 0
    assert torch.equal(c.unet.conv_norm_out.weight,
                       torch.ones_like(c.unet.conv_norm_out.weight))
    again = Components.random("tiny", seed=3, device="cpu")
    assert torch.equal(again.unet.conv_in.weight, w)
    other = Components.random("tiny", seed=4, device="cpu")
    assert not torch.equal(other.unet.conv_in.weight, w)


def test_bf16_cast_keeps_the_float32_modules():
    c = Components.random("tiny", seed=0, device="cpu", dtype=torch.bfloat16)
    assert c.unet.conv_in.weight.dtype == torch.bfloat16
    assert c.unet.conv_out.weight.dtype == torch.float32
    assert c.vae.decoder.conv_out.weight.dtype == torch.float32
    for m in [*c.unet.modules(), *c.vae.modules()]:
        if isinstance(m, (GroupNorm32, LayerNorm32)):
            assert m.weight.dtype == torch.float32
    # the text tower stays float32, as the JAX package runs it
    assert c.text_encoders[0].text_model.final_layer_norm.weight.dtype == torch.float32
    x = torch.randn(1, 4, 8, 8)
    with torch.no_grad():
        eps = c.unet(x, torch.tensor([10.0]), torch.randn(1, 77, 32))
        img = c.vae.decode(x)
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()
    assert img.dtype == torch.float32 and torch.isfinite(img).all()


def test_unet_refuses_unported_conditioning():
    """The x4 upscaler's noise-level table is served now (held against JAX
    in ``tests/test_torch_cascade.py``): the UNet builds its
    ``class_embedding`` table and, as JAX's, refuses an eval without class
    labels. SDXL's added conditioning is held in
    ``tests/test_torch_sdxl.py``."""
    from chiaswarm_tpu_torch.models.unet import UNet

    cfg = FAMILIES["tiny_up4"].unet
    unet = UNet(cfg)
    assert tuple(unet.class_embedding.weight.shape) == (
        cfg.num_class_embeds, 4 * cfg.block_out_channels[0])
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="requires class_labels"):
        unet(torch.zeros((1, 7, 16, 16)), torch.zeros((1,)),
             torch.zeros((1, 77, 32)))


def test_configs_are_a_copy_of_the_reference():
    from chiaswarm_tpu.models import configs as ref

    assert set(FAMILIES) == set(ref.FAMILIES)
    for name, fam in FAMILIES.items():
        assert dataclasses.asdict(fam) == dataclasses.asdict(ref.FAMILIES[name])
    from chiaswarm_tpu_torch.models.configs import get_family

    for model in ("runwayml/stable-diffusion-v1-5", "stabilityai/sdxl-turbo",
                  "stabilityai/stable-diffusion-2-1", "random/tiny_xl",
                  "timbrooks/instruct-pix2pix", "x4-upscaler"):
        assert get_family(model).name == ref.get_family(model).name


def test_sd15_full_width_parameter_count():
    """SD1.5 at its published widths: ~1.07 B parameters in the three
    modules, counted on the meta device (no storage)."""
    from chiaswarm_tpu_torch.models.clip import ClipTextEncoder
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.models.vae import AutoencoderKL

    fam = FAMILIES["sd15"]
    with torch.device("meta"):
        counts = {
            "text": sum(p.numel() for p in
                        ClipTextEncoder(fam.text_encoders[0]).parameters()),
            "unet": sum(p.numel() for p in UNet(fam.unet).parameters()),
            "vae": sum(p.numel() for p in AutoencoderKL(fam.vae).parameters()),
        }
    # diffusers' published counts: UNet 859.52 M, VAE 83.65 M, CLIP-L 123.06 M
    assert counts["unet"] == 859_520_964
    assert counts["vae"] == 83_653_863
    assert counts["text"] == 123_060_480
