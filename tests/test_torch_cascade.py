"""The port's DeepFloyd cascade slice against the JAX package, on the tiny
families.

Both packages read one set of weights: the port's seeded random modules
written as torch-named snapshots (``text_encoder/``, ``unet/``,
``unet_sr/`` for ``tiny_cascade``; ``unet/``, ``vae/``, ``text_encoder/``
for ``tiny_up4``), loaded by JAX's loaders (``load_cascade_checkpoint``,
``Components.from_checkpoint``) and by the port's, so no JAX init runs.

- T5 (fp32, with a padding mask and without) within 2e-4, the bucket table
  id for id, the random draw's initialisers;
- the UNet with the x4 upscaler's table of class embeddings within 2e-4,
  and its refusal without labels;
- ``Upscale4xPipeline`` at a 64 px input bucket, 2 steps, CFG 9.0, and
  ``CascadePipeline`` (2 + 2 steps, guidance 5.0 and 1.0, seed 4, stage 3
  through a stand-in x2 upscaler) within one uint8 level of JAX's, configs
  equal, with the draws pinned on both sides (one array per draw shape);
- ``_run_stage3`` with an x4 pass, x2 passes and a pass that makes no
  progress: images and configs equal to JAX's;
- ``cascade_callback`` through both executors (envelope keys equal), an
  absent model (the same envelope kind);
- both loaders, ``from_jax`` on JAX's loaded params, the ``tokenizer.json``
  tokenizer id for id against JAX's, the blocked plain attention, the
  registry, the routing.
"""

from __future__ import annotations

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert.torch_to_flax import (
    load_cascade_checkpoint as jax_load_cascade,
)
from chiaswarm_tpu.core.compile_cache import GLOBAL_CACHE
from chiaswarm_tpu.models import t5 as jt5
from chiaswarm_tpu.models import tokenizer as jtok
from chiaswarm_tpu.pipelines import cascade as jcascade
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.upscale import Upscale4xPipeline as JaxUp4
from chiaswarm_tpu_torch.convert.checkpoint import (
    CASCADE_SUBDIRS,
    load_cascade_checkpoint,
)
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
from chiaswarm_tpu_torch.models import t5 as tt5
from chiaswarm_tpu_torch.models import tokenizer as ttok
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.ops import attention as tattn
from chiaswarm_tpu_torch.pipelines import cascade as tcascade
from chiaswarm_tpu_torch.pipelines import upscale as tup
from chiaswarm_tpu_torch.pipelines.components import Components

BAR = 2e-4
NAME = "DeepFloyd/tiny_cascade"
UP4 = "random/tiny_up4"
PROMPT = "a red fox on a snowy roof"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write(path, module, filename: str) -> None:
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.detach().float().contiguous()
               for k, v in module.state_dict().items()}, path / filename,
              {"format": "pt"})


def _states(modules: dict) -> dict:
    return {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in modules.items()}


@pytest.fixture(scope="module")
def cascade_dir(tmp_path_factory):
    """``tiny_cascade`` random from seed 0 on the port, written in torch
    names; returns the directory and the source's state dicts."""
    root = tmp_path_factory.mktemp("tiny_cascade")
    src = tcascade.CascadeComponents.random("tiny_cascade", seed=0,
                                            device="cpu")
    for name, sub in CASCADE_SUBDIRS.items():
        _write(root / sub, getattr(src, name), "model.safetensors")
    return root, _states({n: getattr(src, n) for n in tcascade.MODULES})


@pytest.fixture(scope="module")
def cascades(cascade_dir):
    """(JAX, port) cascades loaded from the same files."""
    root, _ = cascade_dir
    jc = jax_load_cascade(root, NAME, jcascade.TINY_CASCADE)
    tc = load_cascade_checkpoint(root, NAME, tcascade.TINY_CASCADE,
                                 device="cpu")
    return jcascade.CascadePipeline(jc), tcascade.CascadePipeline(tc)


@pytest.fixture(scope="module")
def up4_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_up4")
    src = Components.random("tiny_up4", seed=0, device="cpu")
    _write(root / "unet", src.unet, "diffusion_pytorch_model.safetensors")
    _write(root / "vae", src.vae, "diffusion_pytorch_model.safetensors")
    _write(root / "text_encoder", src.text_encoders[0], "model.safetensors")
    return root, _states({"unet": src.unet, "vae": src.vae,
                          "text_encoder_0": src.text_encoders[0]})


@pytest.fixture(scope="module")
def upscalers(up4_dir):
    """(JAX, port) x4 upscalers loaded from the same files."""
    root, _ = up4_dir
    jc = JaxComponents.from_checkpoint(root, UP4, "tiny_up4")
    tc = Components.from_checkpoint(root, UP4, "tiny_up4", device="cpu")
    return JaxUp4(jc), tup.Upscale4xPipeline(tc)


def _close(got: torch.Tensor, want, nchw: bool = False) -> None:
    got = got.detach().float()
    if nchw:
        got = got.permute(0, 2, 3, 1)
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BAR)


# ---------------------------------------------------------------------------
# 1. the modules


@pytest.mark.parametrize("length,buckets,distance", [
    (1, 32, 128), (7, 32, 128), (77, 32, 128), (300, 32, 128), (40, 8, 20)])
def test_relative_position_buckets_match_jax(length, buckets, distance):
    np.testing.assert_array_equal(
        tt5.relative_position_buckets(length, buckets, distance),
        jt5.relative_position_buckets(length, buckets, distance))


@pytest.mark.parametrize("masked", [True, False])
def test_t5_matches_jax(cascades, masked):
    jax_pipe, port_pipe = cascades
    tok = port_pipe.c.tokenizer
    ids = tok.encode_batch([PROMPT, "", "rain " * 90])
    assert (ids == jax_pipe.c.tokenizer.encode_batch(
        [PROMPT, "", "rain " * 90])).all()
    assert ids[0, 0] != tok.bos_id and (ids[1, 1:] == 0).all()
    mask = ids != 0 if masked else None
    ref = jax_pipe.c.t5.apply(jax_pipe.c.params["t5"], jnp.asarray(ids),
                              None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = port_pipe.c.t5(torch.from_numpy(ids),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got, ref)


def test_random_t5_follows_the_jax_initialisers():
    """lecun-normal kernels, N(0, 1/d) token embeddings, a normal(1.0)
    relative bias, unit norm scales; finite outputs."""
    cfg = tt5.T5Config(vocab_size=512, d_model=256, d_kv=32, d_ff=512,
                       num_layers=2, num_heads=8, dtype="float32")
    module = tt5.T5Encoder(cfg)
    tcascade.init_t5(module, torch.Generator().manual_seed(0))
    attn = module.encoder.block[0].layer[0].SelfAttention
    assert abs(module.shared.weight.std().item() - 256 ** -0.5) < 0.003
    assert abs(attn.relative_attention_bias.weight.std().item() - 1.0) < 0.2
    assert abs(attn.q.weight.std().item() - 256 ** -0.5) < 0.003
    wo = module.encoder.block[1].layer[1].DenseReluDense.wo.weight
    assert abs(wo.std().item() - 512 ** -0.5) < 0.003
    assert torch.equal(module.encoder.final_layer_norm.weight,
                       torch.ones(256))
    with torch.no_grad():
        out = module(torch.arange(20)[None])
    assert torch.isfinite(out).all()


def test_class_embedding_unet_matches_jax(upscalers):
    jax_up, port_up = upscalers
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 7)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    labels = np.array([20, 3], np.int32)
    ref = jax_up.c.unet.apply(jax_up.c.params["unet"], jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(ctx),
                              class_labels=jnp.asarray(labels))
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx))
    with torch.no_grad():
        got = port_up.c.unet(*args, class_labels=torch.from_numpy(labels))
        with pytest.raises(ValueError, match="requires class_labels"):
            port_up.c.unet(*args)
    with pytest.raises(ValueError, match="requires class_labels"):
        jax_up.c.unet.apply(jax_up.c.params["unet"], jnp.asarray(x),
                            jnp.asarray(t), jnp.asarray(ctx))
    _close(got, ref, nchw=True)


@pytest.mark.parametrize("rows", [100, 7, 1])
def test_blocked_plain_attention_is_the_unblocked_one(rows):
    """Past the bound the queries go in blocks of ``rows``: the same
    function as one call, within fp32 rounding; at the bound, one call."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 100, 3, 16), generator=gen)
               for _ in range(3))
    one = tattn._plain_block(q, k, v, 0.25)
    row_bytes = 2 * 3 * 100 * 4
    blocked = tattn.xla_attention(q, k, v, 0.25,
                                  max_logits_bytes=rows * row_bytes)
    if rows == 100:
        assert torch.equal(blocked, one)
    np.testing.assert_allclose(blocked.numpy(), one.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(tattn.xla_attention(q, k, v, 0.25), one)


# ---------------------------------------------------------------------------
# 2. the pipelines, draws pinned


@contextlib.contextmanager
def _pinned(table: dict, *port_modules):
    """Every normal draw, in JAX and in the given port modules, is the
    table's array for its (H, W, C) shape."""
    real = jax.random.normal

    def jax_draw(key, shape=(), dtype=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(table[tuple(shape[-3:])], dtype),
                                shape)

    def port_draw(generators, shape, device="cpu"):
        c, h, w = shape
        one = torch.from_numpy(table[(h, w, c)]).permute(2, 0, 1)
        return torch.stack([one] * len(generators)).to(device)

    saved = [(m, m.randn_rows) for m in port_modules]
    GLOBAL_CACHE.flush_executables()
    jax.random.normal = jax_draw
    for m in port_modules:
        m.randn_rows = port_draw
    try:
        yield
    finally:
        jax.random.normal = real
        for m, fn in saved:
            m.randn_rows = fn
        GLOBAL_CACHE.flush_executables()


def _table(shapes, seed: int = 9) -> dict:
    rng = np.random.default_rng(seed)
    return {s: rng.standard_normal(s).astype(np.float32) for s in shapes}


def _image(seed: int, size: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (1, size, size, 3),
                                                dtype=np.uint8)


def _within_one(got: np.ndarray, ref) -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert got.std() > 1.0  # a picture, not a flat frame


def test_x4_upscaler_matches_jax(upscalers):
    jax_up, port_up = upscalers
    kw = dict(prompt="sharp photo", negative_prompt="blurry", steps=2,
              guidance_scale=9.0, seed=3)
    with _pinned(_table([(64, 64, 3), (64, 64, 4)]), tup):
        ref, ref_cfg = jax_up(_image(4), **kw)
        got, cfg = port_up(_image(4), **kw)
    assert got.shape == (1, 256, 256, 3)
    _within_one(got, ref)
    assert cfg == ref_cfg
    assert cfg["scale"] == 4 and cfg["upscale_noise_level"] == 20


def test_x4_rows_follow_first_row(upscalers):
    """Row 1 of a two-image call is the batch-1 call at ``first_row=1``."""
    _, port_up = upscalers
    images = np.concatenate([_image(5, 48), _image(6, 48)])
    two, _ = port_up(images, prompt="p", steps=1, seed=2)
    one, _ = port_up(images[1:], prompt="p", steps=1, seed=2, first_row=1)
    assert two.shape == (2, 256, 256, 3)  # 48 px buckets to 64
    assert np.abs(two[1].astype(np.int16) - one[0]).max() <= 1
    assert not np.array_equal(two[0], two[1])


class _Doubler:
    """A stand-in upscaler: nearest x ``factor`` and a namespaced config,
    the same for both packages."""

    def __init__(self, factor: int, cap: int = 4096) -> None:
        self.factor, self.cap, self.calls = factor, cap, []

    def __call__(self, images, prompt="", seed=0, first_row=0):
        self.calls.append((images.shape, prompt, seed, first_row))
        f = self.factor if images.shape[1] * self.factor <= self.cap else 1
        out = images.repeat(f, axis=1).repeat(f, axis=2)
        return out, {"upscaler": f"x{self.factor}", "scale": f,
                     "upscale_steps": 2}


@pytest.mark.parametrize("guidance", [5.0, 1.0])
def test_cascade_matches_jax(cascades, guidance):
    jax_pipe, port_pipe = cascades
    kw = dict(prompt=PROMPT, negative_prompt="blurry", steps=2, sr_steps=2,
              guidance_scale=guidance, seed=4, final_size=256)
    with _pinned(_table([(16, 16, 3), (64, 64, 3)]), tcascade):
        ref, ref_cfg = jax_pipe(upscaler=_Doubler(2), **kw)
        got, cfg = port_pipe(upscaler=_Doubler(2), **kw)
    assert got.shape == (1, 256, 256, 3)
    _within_one(got, ref)
    assert cfg == ref_cfg
    assert cfg["stages"] == 3 and cfg["stage3_passes"] == 2


@pytest.mark.parametrize("factor,size,final,cap", [
    (4, 256, 1024, 4096), (2, 256, 1024, 4096), (2, 256, 1024, 512),
    (4, 256, 256, 4096)],
    ids=["x4-one-pass", "x2-two-passes", "no-progress", "no-pass"])
def test_run_stage3_matches_jax(factor, size, final, cap):
    images = _image(7, size)
    want_up, got_up = _Doubler(factor, cap), _Doubler(factor, cap)
    ref, ref_cfg = jcascade._run_stage3(images, want_up, "p", 5, final,
                                        first_row=1)
    got, cfg = tcascade._run_stage3(images, got_up, "p", 5, final,
                                    first_row=1)
    np.testing.assert_array_equal(got, ref)
    assert cfg == ref_cfg and got_up.calls == want_up.calls


# ---------------------------------------------------------------------------
# 3. the workload, the loaders, the registry, the routing


class _Registry:
    """A registry stand-in handing out one cascade and one upscaler."""

    def __init__(self, cascade, upscaler) -> None:
        self._cascade, self._upscaler = cascade, upscaler

    def cascade_pipeline(self, model_name, mesh=None):
        return self._cascade

    def pipeline(self, model_name, mesh=None):
        return self._upscaler


@pytest.fixture()
def two_x4_steps(monkeypatch):
    """Stage 3 at 2 steps instead of the hive's 75, in both packages."""
    for cls in (JaxUp4, tup.Upscale4xPipeline):
        defaults = list(cls.__call__.__defaults__)
        defaults[2] = 2  # (prompt, negative_prompt, steps, ...)
        monkeypatch.setattr(cls.__call__, "__defaults__", tuple(defaults))


def test_callback_envelope_matches_the_jax_executor(cascades, upscalers,
                                                    two_x4_steps):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work

    job = {"id": "if-1", "model_name": NAME, "prompt": PROMPT, "seed": 4,
           "num_inference_steps": 2, "sr_steps": 2, "guidance_scale": 5.0,
           "upscaler_model_name": UP4, "content_type": "image/png"}
    ref = jax_do_work(copy.deepcopy(job), JaxPool(n_slots=1).slots[0],
                      _Registry(cascades[0], upscalers[0]))
    got = executor.synchronous_do_work(copy.deepcopy(job),
                                       ChipPool(device="cpu").slots[0],
                                       _Registry(cascades[1], upscalers[1]))
    for result in (ref, got):
        assert "error" not in result["pipeline_config"], result
    assert set(got) == set(ref)
    assert set(got["artifacts"]) == set(ref["artifacts"])
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    timings = {"generation_s", "images_per_sec", "slot"}
    assert {k: v for k, v in got["pipeline_config"].items()
            if k not in timings} == \
        {k: v for k, v in ref["pipeline_config"].items() if k not in timings}
    assert got["pipeline_config"]["size"] == [256, 256]
    assert got["pipeline_config"]["stages"] == 3


def test_an_absent_model_is_refused_as_jax_refuses_it(tmp_path, monkeypatch):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    job = {"id": "if-absent", "model_name": "DeepFloyd/IF-I-XL-v1.0",
           "prompt": PROMPT, "seed": 1, "content_type": "image/png"}
    ref = jax_do_work(copy.deepcopy(job), JaxPool(n_slots=1).slots[0],
                      JaxRegistry(catalog=[], allow_random=False))
    got = executor.synchronous_do_work(copy.deepcopy(job),
                                       ChipPool(device="cpu").slots[0],
                                       ModelRegistry(device="cpu"))
    assert got["pipeline_config"]["error_kind"] == \
        ref["pipeline_config"]["error_kind"] == "model_unavailable"
    assert "fatal_error" not in got and "fatal_error" not in ref
    assert set(got) == set(ref)


def test_loaders_match_jax(cascade_dir, cascades, up4_dir, upscalers,
                           tmp_path):
    """Each loaded tensor equals its source; the stage UNets and the x4
    VAE give JAX's loaders' outputs; T5's tied embedding name loads."""
    _, cascade_states = cascade_dir
    _, up4_states = up4_dir
    jax_pipe, port_pipe = cascades
    for name, state in cascade_states.items():
        loaded = getattr(port_pipe.c, name).state_dict()
        assert set(loaded) == set(state)
        assert all(torch.equal(loaded[k], v) for k, v in state.items()), name
    port_up = upscalers[1]
    modules = {"unet": port_up.c.unet, "vae": port_up.c.vae,
               "text_encoder_0": port_up.c.text_encoders[0]}
    for name, state in up4_states.items():
        loaded = modules[name].state_dict()
        assert all(torch.equal(loaded[k], v) for k, v in state.items()), name
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([900.0, 30.0], np.float32)
    for key, channels in (("unet1", 3), ("unet2", 6)):
        x = rng.standard_normal((2, 16, 16, channels)).astype(np.float32)
        ref = getattr(jax_pipe.c, key).apply(
            jax_pipe.c.params[key], jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx))
        with torch.no_grad():
            got = getattr(port_pipe.c, key)(
                torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                torch.from_numpy(ctx))
        _close(got, ref, nchw=True)
    from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVae

    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    jax_up = upscalers[0]
    ref = jax_up.c.vae.apply(jax_up.c.params["vae"], jnp.asarray(z),
                             method=JaxVae.decode)
    with torch.no_grad():
        got = port_up.c.vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert got.shape == (1, 3, 64, 64)  # f = 4
    _close(got, ref, nchw=True)
    # transformers may store the tied embedding under its encoder name only
    root, _ = cascade_dir
    tied = tmp_path / "tied"
    tied.mkdir()
    for sub in ("unet", "unet_sr"):
        (tied / sub).symlink_to(root / sub)
    state = {k: v for k, v in cascade_states["t5"].items()}
    state["encoder.embed_tokens.weight"] = state.pop("shared.weight")
    (tied / "text_encoder").mkdir()
    save_file(state, tied / "text_encoder" / "model.safetensors")
    again = load_cascade_checkpoint(tied, NAME, tcascade.TINY_CASCADE,
                                    device="cpu")
    assert torch.equal(again.t5.shared.weight,
                       cascade_states["t5"]["shared.weight"])


def test_from_jax_carries_the_params_across(cascades, upscalers):
    jax_pipe, port_pipe = cascades
    ours = tcascade.CascadeComponents.from_jax(
        jax.tree.map(np.asarray, jax_pipe.c.params), "tiny_cascade",
        device="cpu")
    for name in tcascade.MODULES:
        want = getattr(port_pipe.c, name).state_dict()
        got = getattr(ours, name).state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items()), name
    jax_up, port_up = upscalers
    up = Components.from_jax(jax.tree.map(np.asarray, jax_up.c.params),
                             "tiny_up4", device="cpu")
    want = port_up.c.unet.state_dict()
    assert all(torch.equal(up.unet.state_dict()[k], v)
               for k, v in want.items())


def write_unigram_tokenizer(path) -> None:
    """A T5-style ``tokenizer.json``: a Unigram model over a small piece
    table, Metaspace pre-tokenizer, ``</s>`` appended."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    pieces = ["<pad>", "</s>", "<unk>", "▁a", "▁red", "▁fox",
              "▁on", "▁the", "▁roof", "▁snow", "y", "s",
              "▁", *"abcdefghijklmnopqrstuvwxyz"]
    vocab = [(p, 0.0 if i < 3 else -1.0 - i / 10) for i, p in
             enumerate(pieces)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    path.parent.mkdir(parents=True, exist_ok=True)
    tok.save(str(path))


@pytest.mark.parametrize("max_length", [77, 6])
def test_hf_tokenizer_ids_match_jax(tmp_path, max_length):
    write_unigram_tokenizer(tmp_path / "tokenizer" / "tokenizer.json")
    ours = ttok.load_tokenizer(tmp_path, 1000, 1, max_length, pad_id=0,
                               add_bos=False)
    ref = jtok.load_tokenizer(tmp_path, 1000, 1, max_length, pad_id=0,
                              add_bos=False)
    assert type(ours).__name__ == type(ref).__name__ == "HFTokenizer"
    texts = [PROMPT, "", "a red fox on the snowy roof " * 4, "Zebra? 42!"]
    np.testing.assert_array_equal(ours.encode_batch(texts),
                                  ref.encode_batch(texts))
    assert ours.encode(PROMPT)[:4] == [3, 4, 5, 6]


def test_registry_serves_the_cascade_and_refuses_seq_slots(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match="not available on this node"):
        ModelRegistry(device="cpu").cascade_pipeline("DeepFloyd/IF-I-XL-v1.0")
    loose = ModelRegistry(allow_random=True, device="cpu")
    pipe = loose.cascade_pipeline(NAME)
    assert isinstance(pipe, tcascade.CascadePipeline)
    assert pipe.c.family is tcascade.TINY_CASCADE
    assert loose.cascade_pipeline(NAME) is pipe
    assert ("cascade", NAME, ("cpu",)) in loose.residency._entries
    assert loose.residency.snapshot()["resident_bytes"] == \
        pipe.c.param_bytes()
    seq = build_mesh(MeshSpec({"seq": 4}), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="item 7"):
        loose.cascade_pipeline(NAME, mesh=seq)
    with pytest.raises(NotImplementedError, match="item 7"):
        loose.pipeline(UP4, mesh=seq)


def test_deepfloyd_jobs_route_as_jax_routes_them():
    from chiaswarm_tpu.node.job_args import format_args as jax_format
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu_torch.node.job_args import format_args

    job = {"model_name": "DeepFloyd/IF-I-XL-v1.0", "prompt": PROMPT,
           "seed": 2, "parameters": {"scheduler_type": "x"}, "sr_steps": 10}
    callback, kwargs = format_args(copy.deepcopy(job), None)
    ref_callback, ref_kwargs = jax_format(copy.deepcopy(job), JaxRegistry(
        catalog=[], allow_random=True))
    assert callback.__name__ == ref_callback.__name__ == "cascade_callback"
    kwargs.pop("registry")
    ref_kwargs.pop("registry")
    assert kwargs == ref_kwargs
