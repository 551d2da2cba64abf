"""The port's img2txt (BLIP captioning and VQA) against the JAX package, at
``BLIP_TINY``'s widths on the CPU.

- ``WordPieceTokenizer`` over a vocab the test writes: ids, fixed-length
  encodes and decodes equal JAX's.
- The vision tower, the caption decoder's logits and the question tower's
  states within 2e-4 of JAX's in float32, the JAX params carried across by
  ``convert/from_jax.py::blip_state_from_flax``.
- ``generate_text``: the same ids as JAX's for a plain caption, a
  conditioned caption whose prompt fills and one whose prompt overflows the
  17-token bucket, and VQA; the pipelines' texts equal.
- ``from_checkpoint`` on a transformers-layout directory the test writes
  (``model.safetensors`` + ``vocab.txt``, with and without a question tower)
  against JAX's ``from_checkpoint`` on the same directory.
- ``caption_callback``'s envelopes against JAX's, error artifacts included;
  the registry's refusals.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.models import blip as jblip
from chiaswarm_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from chiaswarm_tpu.pipelines.caption import (
    CaptionComponents as JaxComponents,
)
from chiaswarm_tpu.pipelines.caption import CaptionPipeline as JaxPipeline
from chiaswarm_tpu.workloads import caption as jcaption
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
from chiaswarm_tpu_torch.models import blip as tblip
from chiaswarm_tpu_torch.models.tokenizer import WordPieceTokenizer
from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
from chiaswarm_tpu_torch.pipelines.caption import (
    CaptionComponents,
    CaptionPipeline,
    transformers_state,
)
from chiaswarm_tpu_torch.workloads import caption as tcaption

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
WORDS = ["a", "dog", "cat", "on", "the", "beach", "red", "##s", "##ing",
         "run", "what", "is", "color", "photo", "of", "##ly", "sun", "set"]


@pytest.fixture(scope="module")
def jax_vqa():
    return JaxComponents.random("blip_tiny", seed=3)


@pytest.fixture(scope="module")
def port_vqa(jax_vqa):
    return CaptionComponents.from_jax(jax_vqa.params, "blip_tiny",
                                      device="cpu")


def _image(seed: int = 0, size: int = 48) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (size, size + 8, 3), dtype=np.uint8)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BAR)


def write_vocab(path) -> None:
    """A WordPiece vocab.txt: BERT's specials at their ids, the test's
    words, padding entries up to 990 lines (the tiny text vocab is 1000)."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    lines += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    lines += [f"w{i}" for i in range(990 - len(lines))]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("text", ["A dog on the beach", "cats running",
                                  "what is the color of the sunset?",
                                  "zebra!!", "", "red  dogs\tsunly"])
def test_wordpiece_matches_jax(tmp_path, text):
    write_vocab(tmp_path / "vocab.txt")
    ours = WordPieceTokenizer.from_vocab_file(tmp_path / "vocab.txt")
    ref = JaxWordPiece.from_vocab_file(tmp_path / "vocab.txt")
    assert ours.tokenize(text) == ref.tokenize(text)
    assert ours.encode(text, 12) == ref.encode(text, 12)
    assert ours.encode(text) == ref.encode(text)
    ids = ref.tokenize(text) + [ref.sep_id, 5]
    assert ours.decode(ids) == ref.decode(ids)
    assert (ours.bos_id, ours.pad_id, ours.sep_id) == (ref.bos_id, ref.pad_id,
                                                       ref.sep_id)


def test_vision_tower_matches_jax(jax_vqa, port_vqa):
    cfg = jblip.BLIP_TINY
    x = np.random.default_rng(1).standard_normal(
        (2, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    want = jax_vqa.vision.apply(jax_vqa.params["vision"], jnp.asarray(x))
    with torch.no_grad():
        got = port_vqa.vision(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got, want)


def test_text_towers_match_jax(jax_vqa, port_vqa):
    cfg = jblip.BLIP_TINY.text
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 17, cfg.encoder_hidden_size)).astype(
        np.float32)
    ids = rng.integers(1, 990, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    jd, je = jax_vqa.decoder, jax_vqa.encoder
    kvs = jd.apply(jax_vqa.params["decoder"], jnp.asarray(enc),
                   method="cross_kvs")
    want_logits, _ = jd.apply(jax_vqa.params["decoder"], jnp.asarray(ids),
                              causal=True, cross_kvs=kvs)
    ekvs = je.apply(jax_vqa.params["encoder"], jnp.asarray(enc),
                    method="cross_kvs")
    want_states, _ = je.apply(jax_vqa.params["encoder"], jnp.asarray(ids),
                              causal=False, attn_mask=jnp.asarray(mask),
                              cross_kvs=ekvs, logits=False)
    tids, tenc = torch.from_numpy(ids).long(), torch.from_numpy(enc)
    with torch.no_grad():
        d, e = port_vqa.decoder, port_vqa.encoder
        logits = d(tids, causal=True, cross_kvs=d.cross_kvs(tenc))
        states = e(tids, causal=False, attn_mask=torch.from_numpy(mask),
                   cross_kvs=e.cross_kvs(tenc), logits=False)
    _close(logits, want_logits)
    _close(states, want_states)


@pytest.mark.parametrize("prompt_len,actual,masked", [
    (1, None, False),      # a plain caption: [DEC] alone
    (17, 9, False),        # a conditioned caption padded to the bucket
    (17, 17, False),       # a prompt that fills the bucket
    (1, None, True),       # the answer decoder over masked question states
])
def test_generate_text_ids_match_jax(jax_vqa, port_vqa, prompt_len, actual,
                                     masked):
    cfg = jblip.BLIP_TINY.text
    rng = np.random.default_rng(prompt_len + (actual or 0))
    enc = rng.standard_normal((1, 17, cfg.encoder_hidden_size)).astype(
        np.float32)
    prompt = rng.integers(1, 990, (1, prompt_len)).astype(np.int32)
    prompt[0, 0] = cfg.bos_token_id
    mask = None
    if masked:
        mask = np.ones((1, 17), np.int32)
        mask[0, 11:] = 0
    kw = {} if actual is None else {"actual_len": actual}
    want = jblip.generate_text(
        jax_vqa.decoder, jax_vqa.params["decoder"], jnp.asarray(prompt),
        jnp.asarray(enc), None if mask is None else jnp.asarray(mask),
        prompt_len=prompt_len, max_new=12,
        **({} if actual is None else {"actual_len": jnp.int32(actual)}))
    got = tblip.generate_text(
        port_vqa.decoder, torch.from_numpy(prompt).long(),
        torch.from_numpy(enc), None if mask is None else torch.from_numpy(mask),
        prompt_len=prompt_len, max_new=12, **kw)
    assert got.tolist() == np.asarray(want).tolist()


def test_generate_text_repeats_sep_after_it(port_vqa):
    """Once SEP is drawn every later position is SEP: a decoder whose
    every logit favours SEP returns SEP throughout."""
    dec = port_vqa.decoder
    sep = dec.config.sep_token_id
    with torch.no_grad():
        bias = dec.cls.predictions.decoder.bias
        saved = bias.clone()
        bias[sep] = 1e4
        try:
            ids = tblip.generate_text(
                dec, torch.tensor([[dec.config.bos_token_id]]),
                torch.zeros(1, 5, 32), None, prompt_len=1, max_new=6)
        finally:
            bias.copy_(saved)
    assert ids.tolist() == [[sep] * 6]


@pytest.mark.parametrize("prompt,vqa", [
    ("", False),
    ("tok5 tok9 tok33", False),
    # 16 tokens fill the bucket exactly; 20 overflow it
    (" ".join(f"tok{i}" for i in range(200, 216)), False),
    (" ".join(f"tok{i}" for i in range(300, 320)), False),
    ("tok7 tok8 tok9 ?", True),
    ("", True),
])
def test_pipeline_text_matches_jax(jax_vqa, port_vqa, prompt, vqa):
    image = _image(4)
    want = JaxPipeline(jax_vqa, max_new_tokens=10)(image, prompt, vqa=vqa)
    got = CaptionPipeline(port_vqa, max_new_tokens=10)(image, prompt, vqa=vqa)
    assert got == want


def test_preprocess_matches_jax(jax_vqa, port_vqa):
    image = _image(5, size=61)
    want = np.asarray(JaxPipeline(jax_vqa).preprocess(image))
    got = CaptionPipeline(port_vqa).preprocess(image)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("vqa", [True, False])
def test_from_checkpoint_matches_jax(tmp_path, vqa):
    src = CaptionComponents.random("blip_tiny", seed=11, vqa=vqa,
                                   device="cpu")
    save_file({k: v.contiguous() for k, v in transformers_state(src).items()},
              tmp_path / "model.safetensors")
    write_vocab(tmp_path / "vocab.txt")
    ours = CaptionComponents.from_checkpoint(tmp_path, "t", "blip_tiny",
                                             device="cpu")
    ref = JaxComponents.from_checkpoint(tmp_path, "t", "blip_tiny")
    assert (ours.encoder is None) == (ref.encoder is None) == (not vqa)
    for a, b in zip(ours.vision.state_dict().values(),
                    src.vision.state_dict().values()):
        assert torch.equal(a, b)
    image = _image(6)
    for prompt, ask in [("", False), ("sun set", False)] + (
            [("what is the color", True)] if vqa else []):
        want = JaxPipeline(ref, max_new_tokens=8)(image, prompt, vqa=ask)
        got = CaptionPipeline(ours, max_new_tokens=8)(image, prompt, vqa=ask)
        assert got == want
    enc = np.asarray(JaxPipeline(ref)._encode_image(
        ref.params["vision"], JaxPipeline(ref).preprocess(image)))
    _close(CaptionPipeline(ours).encode_image(image), enc)


def test_from_checkpoint_refuses_a_missing_parameter(tmp_path):
    from chiaswarm_tpu_torch.convert.checkpoint import CheckpointError

    src = CaptionComponents.random("blip_tiny", seed=1, vqa=False,
                                   device="cpu")
    state = transformers_state(src)
    del state["text_decoder.bert.encoder.layer.1.output.dense.bias"]
    save_file({k: v.contiguous() for k, v in state.items()},
              tmp_path / "model.safetensors")
    write_vocab(tmp_path / "vocab.txt")
    with pytest.raises(CheckpointError, match="output.dense.bias"):
        CaptionComponents.from_checkpoint(tmp_path, "t", "blip_tiny",
                                          device="cpu")


class _Registry:
    """A registry stand-in handing out one pipeline."""

    def __init__(self, pipeline) -> None:
        self.pipeline = pipeline

    def caption_pipeline(self, model_name, mesh=None):
        return self.pipeline


@pytest.mark.parametrize("kwargs", [
    {"prompt": ""},
    {"prompt": "tok3 tok4"},
    {"prompt": "tok3 tok4 ?",
     "parameters": {"model_type": "BlipForQuestionAnswering"}},
    {"prompt": "", "image": None},
])
def test_callback_envelopes_match_jax(jax_vqa, port_vqa, kwargs):
    kwargs = {"image": _image(8), **kwargs}
    want = jcaption.caption_callback(None, "blip", seed=1,
                                     registry=_Registry(JaxPipeline(jax_vqa)),
                                     **kwargs)
    got = tcaption.caption_callback(None, "blip", seed=1,
                                    registry=_Registry(CaptionPipeline(port_vqa)),
                                    **kwargs)
    for config in (want[1], got[1]):
        config.pop("elapsed_s", None)
    assert got == want


def test_vqa_without_a_question_tower_is_an_error_artifact(jax_vqa):
    ref = JaxComponents.random("blip_tiny", seed=3, vqa=False)
    ours = CaptionComponents.from_jax(ref.params, "blip_tiny", "m",
                                      device="cpu")
    ref.model_name = "m"
    params = {"model_type": "BlipForQuestionAnswering"}
    want = jcaption.caption_callback(None, "m", seed=1, image=_image(),
                                     prompt="what", parameters=params,
                                     registry=_Registry(JaxPipeline(ref)))
    got = tcaption.caption_callback(None, "m", seed=1, image=_image(),
                                    prompt="what", parameters=params,
                                    registry=_Registry(CaptionPipeline(ours)))
    assert "no question tower" in got[1]["error"]
    assert got == want


def test_registry_serves_refuses_and_keys_by_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    strict = ModelRegistry(device="cpu")
    with pytest.raises(ValueError, match="not available on this node"):
        strict.caption_pipeline("Salesforce/blip-image-captioning-base")
    loose = ModelRegistry(allow_random=True, device="cpu")
    pipe = loose.caption_pipeline("Salesforce/blip-image-captioning-base")
    assert pipe.c.config.name == "blip_tiny"
    assert loose.caption_pipeline("Salesforce/blip-image-captioning-base") \
        is pipe
    assert ("caption", "Salesforce/blip-image-captioning-base", "cpu") in \
        loose.residency._entries
    seq = build_mesh(MeshSpec({"seq": 4}), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="item 7"):
        loose.caption_pipeline("Salesforce/blip-vqa-base", mesh=seq)
    # a directory that cannot be loaded is "unusable", not random weights
    model_dir("broken/blip").mkdir(parents=True)
    with pytest.raises(ValueError, match="unusable"):
        strict.caption_pipeline("broken/blip")
