"""The port's txt2audio (AudioLDM-class) against the JAX package, at
``TINY_AUDIO``'s widths on the CPU.

- ``ByteLevelBpeTokenizer`` over a byte-level vocab the test writes,
  ``HashTokenizer`` with the CLAP tower's specials, and ``load_tokenizer``'s
  choice of class, pinned to JAX's, a ``tokenizer.json`` (the T5
  snapshots') included: both wrap it with the ``tokenizers`` package.
- ``ClapTextEncoder``, the class-conditioned cross-attention-free UNet and
  ``HifiGan`` (the tiny config and the published widths on a short mel)
  within 2e-4 of JAX's in float32, the params carried across by
  ``convert/from_jax.py::audio_state_from_flax``.
- The tiny pipeline end to end with JAX's initial noise injected: the
  waveform within 2e-4 of JAX's under DPM-Solver++(2M) (no step noise) and
  Euler; ``_frames_for`` equal to JAX's.
- ``load_audio_checkpoint`` on a diffusers-layout directory the test
  writes (weight norm on the vocoder, a byte-level tokenizer) against JAX's.
- ``txt2audio_callback``: a WAV of the job's length where no ffmpeg is
  found, its config keys JAX's; the registry's refusals.
"""

from __future__ import annotations

import io
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.core.rng import key_for_seed
from chiaswarm_tpu.convert.torch_to_flax import (
    load_audio_checkpoint as jax_load_audio_checkpoint,
)
from chiaswarm_tpu.models import tokenizer as jtok
from chiaswarm_tpu.models.vocoder import HifiGan as JaxHifiGan
from chiaswarm_tpu.models.vocoder import HifiGanConfig as JaxHifiGanConfig
from chiaswarm_tpu.pipelines import audio as jaudio
from chiaswarm_tpu.workloads import audio as jworkload
from chiaswarm_tpu_torch.convert.checkpoint import load_audio_checkpoint
from chiaswarm_tpu_torch.convert.from_jax import _hifigan_state
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
from chiaswarm_tpu_torch.models import tokenizer as ttok
from chiaswarm_tpu_torch.models.vocoder import HifiGan, HifiGanConfig
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.pipelines import audio as taudio
from chiaswarm_tpu_torch.workloads import audio as tworkload

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BAR = 2e-4
TEXTS = ["a dog barking in the rain", "Thunder, then SILENCE.",
         "café crème 42 ünïcode", "", "  spaced   out  ", "x" * 300]


@pytest.fixture(scope="module")
def jax_tiny():
    return jaudio.AudioComponents.random("tiny_audio", seed=2)


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    return taudio.AudioComponents.from_jax(jax_tiny.params, "tiny_audio",
                                           device="cpu")


def byte_level_vocab() -> tuple[dict, list]:
    """A small byte-level BPE: RoBERTa's specials, every byte symbol, and
    merges built from a few words (with and without their ``Ġ``)."""
    table = ttok._bytes_to_unicode()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in table.values():
        vocab.setdefault(ch, len(vocab))
    merges = []
    for word in ("dog", "rain", "thunder", "the", "in", "bark", "ing",
                 "silence", "caf"):
        for piece in (word, "Ġ" + word):
            cur = piece[0]
            for ch in piece[1:]:
                merges.append((cur, ch))
                cur += ch
                vocab.setdefault(cur, len(vocab))
    return vocab, list(dict.fromkeys(merges))


def write_byte_level(path) -> None:
    path.mkdir(parents=True, exist_ok=True)
    vocab, merges = byte_level_vocab()
    (path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8")


@pytest.mark.parametrize("text", TEXTS)
def test_byte_level_bpe_matches_jax(tmp_path, text):
    write_byte_level(tmp_path)
    ours = ttok.ByteLevelBpeTokenizer.from_dir(tmp_path, 64)
    ref = jtok.ByteLevelBpeTokenizer.from_dir(tmp_path, 64)
    assert ours.encode(text) == ref.encode(text)
    assert (ours.bos_id, ours.eos_id, ours.pad_id) == (0, 2, 1)


@pytest.mark.parametrize("text", TEXTS)
def test_hash_tokenizer_with_clap_specials_matches_jax(text):
    kw = dict(eos_id=2, bos_id=0, pad_id=1)
    assert ttok.HashTokenizer(1000, 77, **kw).encode(text) == \
        jtok.HashTokenizer(1000, 77, **kw).encode(text)
    assert ttok.HashTokenizer(1000, 6, **kw).encode(text) == \
        jtok.HashTokenizer(1000, 6, **kw).encode(text)


def test_load_tokenizer_picks_the_class_jax_picks(tmp_path):
    from chiaswarm_tpu_torch.node.resilience import classify_exception
    from tests.test_torch_cascade import write_unigram_tokenizer
    from tests.test_torch_checkpoint import write_vocab

    write_byte_level(tmp_path / "byte" / "tokenizer")
    write_vocab(tmp_path / "clip" / "tokenizer")
    for name, cls in (("byte", "ByteLevelBpeTokenizer"),
                      ("clip", "ClipBpeTokenizer"),
                      ("none", "HashTokenizer")):
        args = (tmp_path / name, 1000, 2, 77)
        ours = ttok.load_tokenizer(*args, bos_id=0, pad_id=1)
        ref = jtok.load_tokenizer(*args, bos_id=0, pad_id=1)
        assert type(ours).__name__ == type(ref).__name__ == cls
        assert ours.encode(TEXTS[0]) == ref.encode(TEXTS[0])
    # a T5 snapshot's tokenizer.json: the tokenizers package's ids in both
    write_unigram_tokenizer(tmp_path / "t5" / "tokenizer" / "tokenizer.json")
    ours = ttok.load_tokenizer(tmp_path / "t5", 1000, 1, 77, pad_id=0)
    ref = jtok.load_tokenizer(tmp_path / "t5", 1000, 1, 77, pad_id=0)
    assert type(ours).__name__ == type(ref).__name__ == "HFTokenizer"
    assert ours.encode(TEXTS[0]) == ref.encode(TEXTS[0])
    # a broken one is not hashed: it raises
    (tmp_path / "broken" / "tokenizer").mkdir(parents=True)
    (tmp_path / "broken" / "tokenizer" / "tokenizer.json").write_text("{}")
    with pytest.raises(Exception) as info:
        ttok.load_tokenizer(tmp_path / "broken")
    assert classify_exception(info.value) != "model_unavailable"


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BAR)


def test_clap_tower_matches_jax(jax_tiny, port_tiny):
    tok = taudio.hash_tokenizer(taudio.TINY_AUDIO)
    ids = tok.encode_batch(["a dog barking", "rain on a tin roof at night",
                            ""])
    seq, proj = jax_tiny.text_encoder.apply(jax_tiny.params["text_encoder"],
                                            jnp.asarray(ids))
    with torch.no_grad():
        got_seq, got_proj = port_tiny.text_encoder(torch.from_numpy(ids).long())
    _close(got_seq, seq)
    _close(got_proj, proj)


def test_class_conditioned_unet_matches_jax(jax_tiny, port_tiny):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 8, 8)).astype(np.float32)
    t = np.asarray([999.0, 250.5], np.float32)
    labels = rng.standard_normal((2, 32)).astype(np.float32)
    want = jax_tiny.unet.apply(jax_tiny.params["unet"], jnp.asarray(x),
                               jnp.asarray(t), None,
                               class_labels=jnp.asarray(labels))
    with torch.no_grad():
        got = port_tiny.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(t), None,
                             class_labels=torch.from_numpy(labels))
    _close(got.permute(0, 2, 3, 1), want)
    assert not hasattr(port_tiny.unet.down_blocks[0].attentions[0]
                       .transformer_blocks[0], "attn2")


@pytest.mark.parametrize("config,frames", [
    ("tiny", 9),
    ("published", 3),  # hop 256, kernels 3/7/11 with dilations 1/3/5
])
def test_vocoder_matches_jax(config, frames):
    kw = {} if config == "published" else dict(
        model_in_dim=16, upsample_initial_channel=32, upsample_rates=(4, 4),
        upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),))
    jcfg, tcfg = JaxHifiGanConfig(**kw), HifiGanConfig(**kw)
    voc = JaxHifiGan(jcfg)
    mel = np.random.default_rng(4).standard_normal(
        (2, frames, jcfg.model_in_dim)).astype(np.float32)
    params = voc.init(jax.random.PRNGKey(5), jnp.asarray(mel))
    want = voc.apply(params, jnp.asarray(mel))
    flat, _ = _hifigan_state(params["params"],
                             len(tcfg.resblock_kernel_sizes))
    port = HifiGan(tcfg)
    port.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert got.shape == (2, frames * tcfg.hop_length)
    _close(got, want)


def _jax_noise(pipe, duration_s: float, seed: int, batch: int = 1):
    """The JAX program's initial draw (``_build_fn``: split the seed's key,
    normal over (B, T/f, mel/f, C))."""
    fam = pipe.c.family
    f = fam.vae.downscale
    frames = pipe._frames_for(duration_s)
    _, nkey = jax.random.split(key_for_seed(seed))
    return np.asarray(jax.random.normal(
        nkey, (batch, frames // f, fam.n_mel // f, fam.vae.latent_channels),
        jnp.float32))


@pytest.mark.parametrize("scheduler,guidance", [
    (None, 2.5),                          # DPM-Solver++(2M), CFG
    (None, 1.0),                          # no CFG
    ("EulerDiscreteScheduler", 3.0),
])
def test_tiny_pipeline_matches_jax(jax_tiny, port_tiny, scheduler, guidance):
    kw = dict(prompt="rain on a tin roof", negative_prompt="noise",
              steps=4, guidance_scale=guidance, duration_s=0.1, seed=7,
              scheduler=scheduler)
    jpipe = jaudio.AudioPipeline(jax_tiny)
    want, sr, want_cfg = jpipe(**kw)
    got, got_sr, got_cfg = taudio.AudioPipeline(port_tiny)(
        **kw, init_noise=_jax_noise(jpipe, 0.1, 7))
    assert got_sr == sr == 16000
    assert got_cfg == want_cfg
    assert got.shape == want.shape == (1, 1600)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=BAR)


@pytest.mark.parametrize("duration", [2.5, 5.0, 10.0, 10.24, 0.01])
def test_frames_for_matches_jax(duration):
    for fam in ("audioldm", "tiny_audio"):
        jstub = type("S", (), {"c": type("C", (), {
            "family": jaudio.AUDIO_FAMILIES[fam]})})()
        tstub = type("S", (), {"c": type("C", (), {
            "family": taudio.AUDIO_FAMILIES[fam]})})()
        assert taudio.AudioPipeline._frames_for(tstub, duration) == \
            jaudio.AudioPipeline._frames_for(jstub, duration)
    stub = type("S", (), {"c": type("C", (), {"family": taudio.AUDIOLDM})})()
    assert taudio.AudioPipeline._frames_for(stub, 10.0) == 640


def test_families_are_jax_copies():
    import dataclasses

    for name, fam in taudio.AUDIO_FAMILIES.items():
        ref = jaudio.AUDIO_FAMILIES[name]
        for field in ("name", "n_mel", "beta_schedule", "prediction_type"):
            assert getattr(fam, field) == getattr(ref, field)
        for part in ("text_encoder", "unet", "vae", "vocoder"):
            ours = dataclasses.asdict(getattr(fam, part))
            theirs = dataclasses.asdict(getattr(ref, part))
            assert {k: (tuple(map(tuple, v)) if k.endswith("dilation_sizes")
                        else tuple(v) if isinstance(v, list) else v)
                    for k, v in ours.items()} == \
                {k: (tuple(map(tuple, v)) if k.endswith("dilation_sizes")
                     else tuple(v) if isinstance(v, (list, tuple)) else v)
                 for k, v in theirs.items() if k in ours}
    assert taudio.get_audio_family("cvssp/audioldm-s-full-v2") is \
        taudio.AUDIOLDM
    assert taudio.get_audio_family("x/tiny_audio") is taudio.TINY_AUDIO


def write_audio_checkpoint(path, components, buffers: bool = False) -> None:
    """A diffusers AudioLDM directory from the port's modules: CLAP under
    ``text_model.``, the vocoder's first conv in weight-norm form, and a
    byte-level tokenizer; with ``buffers`` the vocoder's ``mean``/``scale``
    buffers too (JAX's ``convert_hifigan`` cannot read those)."""
    c = components
    parts = {
        "text_encoder": c.text_encoder.state_dict(),
        "unet": c.unet.state_dict(),
        "vae": c.vae.state_dict(),
        "vocoder": dict(c.vocoder.state_dict()),
    }
    w = parts["vocoder"].pop("conv_pre.weight")
    norm = w.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
    parts["vocoder"]["conv_pre.weight_g"] = norm
    parts["vocoder"]["conv_pre.weight_v"] = w * 2.0
    if buffers:
        parts["vocoder"]["mean"] = torch.zeros(16)
        parts["vocoder"]["scale"] = torch.ones(16)
    for sub, state in parts.items():
        (path / sub).mkdir(parents=True)
        save_file({k: v.float().contiguous() for k, v in state.items()},
                  path / sub / "diffusion_pytorch_model.safetensors")
    write_byte_level(path / "tokenizer")


def test_load_audio_checkpoint_matches_jax(tmp_path):
    src = taudio.AudioComponents.random("tiny_audio", seed=9, device="cpu")
    write_audio_checkpoint(tmp_path, src)
    ours = load_audio_checkpoint(tmp_path, "m", taudio.TINY_AUDIO,
                                 device="cpu")
    ref = jax_load_audio_checkpoint(tmp_path, "m", jaudio.TINY_AUDIO)
    assert type(ours.tokenizer).__name__ == "ByteLevelBpeTokenizer"
    assert ours.tokenizer.encode("the dog in the rain") == \
        ref.tokenizer.encode("the dog in the rain")
    for a, b in zip(ours.unet.parameters(), src.unet.parameters()):
        assert torch.equal(a, b)
    kw = dict(prompt="the dog in the rain", steps=3, guidance_scale=2.0,
              duration_s=0.05, seed=4)
    jpipe = jaudio.AudioPipeline(ref)
    want, _, _ = jpipe(**kw)
    got, _, _ = taudio.AudioPipeline(ours)(
        **kw, init_noise=_jax_noise(jpipe, 0.05, 4))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=BAR)


def test_load_audio_checkpoint_skips_the_vocoders_buffers(tmp_path):
    src = taudio.AudioComponents.random("tiny_audio", seed=9, device="cpu")
    write_audio_checkpoint(tmp_path, src, buffers=True)
    ours = load_audio_checkpoint(tmp_path, "m", taudio.TINY_AUDIO,
                                 device="cpu")
    for a, b in zip(ours.vocoder.state_dict().values(),
                    src.vocoder.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _wav_samples(blob_b64: str) -> tuple[int, int]:
    import base64

    with wave.open(io.BytesIO(base64.b64decode(blob_b64))) as fh:
        return fh.getframerate(), fh.getnframes()


def test_callback_writes_a_wav_of_the_jobs_length(monkeypatch, tmp_path):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    for mod in (tworkload, jworkload):
        mod._ffmpeg_path.cache_clear()
        monkeypatch.setattr(mod, "_ffmpeg_path", lambda: None)
    slot = ChipPool(device="cpu").slots[0]
    registry = ModelRegistry(allow_random=True, device="cpu")
    kw = dict(registry=registry, prompt="birdsong", num_inference_steps=2,
              audio_length_in_s=0.25)
    artifacts, config = slot(tworkload.txt2audio_callback,
                             model_name="tiny_audio", seed=3, **kw)
    assert artifacts["primary"]["content_type"] == "audio/wav"
    assert _wav_samples(artifacts["primary"]["blob"]) == (16000, 4000)
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    jkw = dict(kw, registry=JaxRegistry(allow_random=True))
    jartifacts, jconfig = JaxPool(n_slots=1).slots[0](
        jworkload.txt2audio_callback, model_name="tiny_audio", seed=3, **jkw)
    assert set(config) == set(jconfig)
    for key in ("model_name", "family", "mode", "steps", "guidance_scale",
                "duration_s", "sample_rate", "scheduler", "nsfw", "seed"):
        assert config[key] == jconfig[key], key
    assert jartifacts["primary"]["content_type"] == "audio/wav"


def test_registry_refuses_and_keys_by_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match="not available on this node"):
        ModelRegistry(device="cpu").audio_pipeline("cvssp/audioldm-s-full-v2")
    loose = ModelRegistry(allow_random=True, device="cpu")
    pipe = loose.audio_pipeline("tiny_audio")
    assert loose.audio_pipeline("tiny_audio") is pipe
    assert ("audio", "tiny_audio", "cpu") in loose.residency._entries
    seq = build_mesh(MeshSpec({"seq": 4}), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="item 7"):
        loose.audio_pipeline("tiny_audio", mesh=seq)
