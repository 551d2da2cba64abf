"""Checkpoint loading in the port, against the JAX package and the
``safetensors`` package (CPU, the ``tiny`` family).

- ``convert/safetensors_io.py``: files it writes read back through
  ``safetensors``, files ``safetensors`` writes read back through it, in
  F32, F16 and BF16, a tensor at an offset that is not a multiple of its
  element size, and malformed headers.
- ``Components.from_checkpoint``: a snapshot that
  ``tests/torch_export.py::write_checkpoint`` writes from JAX
  ``Components.random("tiny")`` loads into exactly the float32 tensors of
  ``Components.from_jax`` over the JAX loader's params, and the two
  packages render it within one uint8 level with the snapshot's BPE
  tokenizer. The legacy VAE names, ``(O, I, 1, 1)`` projections, text keys
  without ``text_model.``, ``.bin`` pickles and a missing key.
- ``ClipBpeTokenizer``/``load_tokenizer``: the JAX ids on hypothesis-drawn
  prompts (ASCII, unicode, longer than 77 tokens), and the loud hash
  fallback of a checkpoint without vocab files.
"""

from __future__ import annotations

import json
import logging
import struct

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from safetensors import safe_open
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from chiaswarm_tpu.models.tokenizer import ClipBpeTokenizer as JaxBpe
from chiaswarm_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from chiaswarm_tpu.pipelines.diffusion import GenerateRequest as JaxRequest
from chiaswarm_tpu_torch.convert.checkpoint import CheckpointError
from chiaswarm_tpu_torch.convert.safetensors_io import (
    SafetensorsError,
    SafetensorsFile,
    save_file,
)
from chiaswarm_tpu_torch.models.tokenizer import (
    ClipBpeTokenizer,
    HashTokenizer,
    load_tokenizer,
)
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import (
    DiffusionPipeline,
    GenerateRequest,
)
from tests.torch_export import write_checkpoint

PROMPT = "a lighthouse on a cliff at golden hour, oil painting"
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


# ---- safetensors -----------------------------------------------------------


def _tensors(dtype: torch.dtype) -> dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn(5, 3, generator=gen).to(dtype),
            "b": torch.randn(7, generator=gen).to(dtype),
            "s": torch.randn((), generator=gen).to(dtype),
            "e": torch.zeros(0, 4, dtype=dtype)}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_writer_reads_back_through_safetensors(tmp_path, name):
    tensors = _tensors(DTYPES[name])
    save_file(tensors, tmp_path / "x.safetensors", {"format": "pt"})
    back = st_load(str(tmp_path / "x.safetensors"))
    assert set(back) == set(tensors)
    for key, value in tensors.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_reader_reads_safetensors_files(tmp_path, name):
    tensors = _tensors(DTYPES[name])
    st_save(tensors, str(tmp_path / "x.safetensors"),
            metadata={"format": "pt"})
    got = dict(SafetensorsFile(tmp_path / "x.safetensors").tensors())
    assert sorted(got) == sorted(tensors)
    for key, value in tensors.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value)


def _header(path) -> dict:
    """A safetensors file's JSON header, parsed here without either
    reader."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        return json.loads(fh.read(n))


def test_port_writer_keeps_metadata_and_pads_the_header(tmp_path):
    path = tmp_path / "x.safetensors"
    save_file(_tensors(torch.float32), path, {"format": "pt", "step": 3})
    (n,) = struct.unpack("<Q", path.read_bytes()[:8])
    assert n % 8 == 0
    header = _header(path)
    assert header.pop("__metadata__") == {"format": "pt", "step": "3"}
    assert sorted(header) == sorted(_tensors(torch.float32))
    assert dict(SafetensorsFile(path).tensors()).keys() == header.keys()
    with safe_open(str(path), "pt") as ref:
        assert ref.metadata() == {"format": "pt", "step": "3"}


def _raw_file(path, entries: dict, data: bytes) -> None:
    header = json.dumps(entries).encode()
    header += b" " * (-len(header) % 8)
    path.write_bytes(struct.pack("<Q", len(header)) + header + data)


def test_unaligned_offsets_are_copied(tmp_path):
    """A 1-byte tensor first puts the F32 and BF16 tensors after it at odd
    offsets; both readers agree, and the port's values are copies."""
    f32 = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7
    bf16 = torch.linspace(-1, 1, 5).to(torch.bfloat16)
    raw_f32 = f32.numpy().tobytes()
    raw_bf16 = bf16.view(torch.int16).numpy().tobytes()
    entries = {"u": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
               "f": {"dtype": "F32", "shape": [2, 3],
                     "data_offsets": [1, 1 + len(raw_f32)]},
               "h": {"dtype": "BF16", "shape": [5],
                     "data_offsets": [1 + len(raw_f32),
                                      1 + len(raw_f32) + len(raw_bf16)]}}
    path = tmp_path / "odd.safetensors"
    _raw_file(path, entries, b"\x07" + raw_f32 + raw_bf16)
    ref = st_load(str(path))
    got = dict(SafetensorsFile(path).tensors())
    for key, want in (("f", f32), ("h", bf16)):
        assert torch.equal(got[key], want) and torch.equal(ref[key], want)
    assert got["u"].tolist() == [7]


@pytest.mark.parametrize("blob", [
    b"\x01\x00",                                        # shorter than 8 bytes
    struct.pack("<Q", 1 << 40) + b"{}",                 # header past the end
    struct.pack("<Q", 8) + b"not json",
    struct.pack("<Q", 8) + b"[1,2,3] ",                 # not an object
    struct.pack("<Q", 64) + json.dumps(                 # offsets past the data
        {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}
    ).encode().ljust(64) + b"\x00" * 8,
    struct.pack("<Q", 64) + json.dumps(                 # size != shape
        {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}
    ).encode().ljust(64) + b"\x00" * 16,
    struct.pack("<Q", 64) + json.dumps(
        {"a": {"dtype": "Q7", "shape": [1], "data_offsets": [0, 1]}}
    ).encode().ljust(64) + b"\x00",
], ids=["short", "huge-header", "not-json", "not-object", "past-end",
        "wrong-size", "bad-dtype"])
def test_malformed_files_raise(tmp_path, blob):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(blob)
    with pytest.raises(SafetensorsError):
        SafetensorsFile(path)


# ---- tokenizer -------------------------------------------------------------

_WORDS = ("a lighthouse on cliff at golden hour oil painting blurry low "
          "quality the of and photo portrait of an astronaut riding horse "
          "mars city night cat dog 's").split()


def write_vocab(path, vocab_size: int = 1000, eos_id: int = 999) -> None:
    """A CLIP-format ``vocab.json`` + ``merges.txt``: the single symbols
    and their word-final forms, then the left-to-right merges that build
    each word of ``_WORDS`` (and its ``</w>`` form), the specials at
    ``eos_id - 1`` and ``eos_id``."""
    symbols = [chr(c) for c in range(33, 127)]
    vocab: dict[str, int] = {}
    for sym in symbols + [s + "</w>" for s in symbols]:
        vocab.setdefault(sym, len(vocab))
    merges: list[tuple[str, str]] = []
    for word in _WORDS:
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        left = pieces[0]
        for right in pieces[1:]:
            if (left, right) not in merges:
                merges.append((left, right))
            vocab.setdefault(left + right, len(vocab))
            left = left + right
    assert len(vocab) < eos_id - 1 <= vocab_size - 2
    vocab["<|startoftext|>"] = eos_id - 1
    vocab["<|endoftext|>"] = eos_id
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "tokenizer"
    write_vocab(path)
    return path


_TEXT = st.one_of(
    st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=126),
            max_size=60),
    st.text(max_size=40),
    st.lists(st.sampled_from(_WORDS), min_size=60, max_size=120).map(
        " ".join),
)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_bpe_ids_match_jax(vocab_dir, text):
    ours = ClipBpeTokenizer.from_dir(vocab_dir)
    ref = JaxBpe.from_dir(vocab_dir)
    assert ours.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(ours.encode_batch([text, PROMPT]),
                                  ref.encode_batch([text, PROMPT]))


def test_bpe_pieces_spell_the_prompt_and_pad_with_eos(vocab_dir):
    tok = ClipBpeTokenizer.from_dir(vocab_dir)
    ids = tok.encode(PROMPT)
    inverse = {i: piece for piece, i in tok.vocab.items()}
    body = ids[1:ids.index(999)]
    assert ids[0] == 998 and set(ids[1 + len(body):]) == {999}
    spelled = "".join(inverse[i] for i in body).replace("</w>", " ")
    assert spelled.split() == PROMPT.replace(",", " ,").split()
    assert len(body) < sum(len(w) for w in PROMPT.split())  # merges applied
    long = tok.encode(" ".join(["golden"] * 100))
    assert len(long) == 77 and long[0] == 998 and long[-1] == 999
    tok.add_token("<cat-toy>", [5, 6])
    assert tok.encode("a <cat-toy>")[1:4] == [tok.vocab["a</w>"], 5, 6]


@pytest.mark.parametrize("layout", ["", "tokenizer", "text_encoder"])
def test_load_tokenizer_finds_the_vocab_like_jax(tmp_path, layout):
    write_vocab(tmp_path / layout if layout else tmp_path)
    ours = load_tokenizer(tmp_path, 1000, 999, 77)
    ref = jax_load_tokenizer(tmp_path, 1000, 999, 77)
    assert isinstance(ours, ClipBpeTokenizer)
    assert ours.encode(PROMPT) == ref.encode(PROMPT)


def test_no_vocab_files_fall_back_loudly_to_hash(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        ours = load_tokenizer(tmp_path, 1000, 999, 77)
    assert isinstance(ours, HashTokenizer)
    assert "falling back to HashTokenizer" in caplog.text
    ref = jax_load_tokenizer(tmp_path, 1000, 999, 77)
    assert ours.encode(PROMPT) == ref.encode(PROMPT)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        load_tokenizer(None, 1000, 999, 77)
    assert "falling back" not in caplog.text  # no checkpoint: no warning


def test_unported_tokenizer_files_are_model_unavailable(tmp_path):
    from chiaswarm_tpu_torch.node.resilience import classify_exception

    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "tokenizer.json").write_text("{}")
    with pytest.raises(ValueError) as info:
        load_tokenizer(tmp_path)
    assert classify_exception(info.value) == "model_unavailable"


# ---- checkpoints -----------------------------------------------------------


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny snapshot written from JAX random params, with a BPE vocab."""
    root = tmp_path_factory.mktemp("tiny_snapshot")
    write_checkpoint(root, JaxComponents.random("tiny", seed=3))
    write_vocab(root / "tokenizer")
    return root


@pytest.fixture(scope="module")
def jax_loaded(snapshot):
    return JaxComponents.from_checkpoint(snapshot, "tiny", "tiny")


@pytest.fixture(scope="module")
def port_loaded(snapshot):
    return Components.from_checkpoint(snapshot, "tiny", "tiny", device="cpu")


def _states(c: Components) -> dict[str, dict[str, torch.Tensor]]:
    named = {f"text_encoder_{i}": te for i, te in enumerate(c.text_encoders)}
    named.update(unet=c.unet, vae=c.vae)
    return {name: m.state_dict() for name, m in named.items()}


def _assert_same_tensors(got: Components, want: Components) -> None:
    got_s, want_s = _states(got), _states(want)
    assert got_s.keys() == want_s.keys()
    for module, state in want_s.items():
        assert got_s[module].keys() == state.keys(), module
        for key, value in state.items():
            other = got_s[module][key]
            assert other.dtype == value.dtype == torch.float32, key
            assert torch.equal(other, value), f"{module}.{key}"


def test_loaded_tensors_equal_from_jax_exactly(jax_loaded, port_loaded):
    params = jax.tree.map(np.asarray, jax_loaded.params)
    _assert_same_tensors(port_loaded,
                         Components.from_jax(params, "tiny", device="cpu"))
    assert port_loaded.param_bytes() == sum(
        int(np.asarray(x).size) * 4 for x in jax.tree.leaves(params))
    assert port_loaded.load_stats["tensors"] == sum(
        len(s) for s in _states(port_loaded).values())
    assert isinstance(port_loaded.tokenizers[0], ClipBpeTokenizer)


def test_loaded_checkpoint_renders_like_jax(jax_loaded, port_loaded):
    noise = np.random.default_rng(0).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    kw = dict(prompt=PROMPT, negative_prompt="blurry", steps=3,
              guidance_scale=7.5, height=64, width=64, seed=0,
              init_noise=noise)
    j_img, _ = JaxPipeline(jax_loaded)(JaxRequest(**kw))
    t_img, _ = DiffusionPipeline(port_loaded)(GenerateRequest(**kw))
    diff = np.abs(t_img.astype(np.int16) - np.asarray(j_img).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_img.std() > 1.0


def _rewrite(path, fn) -> None:
    """Rewrite one module's safetensors file through ``fn(state)``."""
    file = next(path.glob("*.safetensors"))
    state = fn(st_load(str(file)))
    file.unlink()
    st_save({k: v.contiguous() for k, v in state.items()}, str(file))


def _copy_snapshot(snapshot, dest):
    import shutil

    shutil.copytree(snapshot, dest)
    return dest


def test_legacy_names_and_prefixless_text_keys_load(snapshot, port_loaded,
                                                    tmp_path):
    """The old VAE attention names with (O, I, 1, 1) projections, text
    keys without ``text_model.`` and a ``position_ids`` buffer."""
    root = _copy_snapshot(snapshot, tmp_path / "legacy")
    legacy = {"to_q": "query", "to_k": "key", "to_v": "value",
              "to_out": "proj_attn"}

    def old_vae(state):
        out = {}
        for key, value in state.items():
            parts = key.split(".")
            if "attentions" in parts and parts[-2] in legacy:
                parts[-2] = legacy[parts[-2]]
                if value.dim() == 2:
                    value = value[:, :, None, None]
            out[".".join(parts)] = value
        assert any(".query." in k for k in out)
        return out

    def old_text(state):
        out = {k.removeprefix("text_model."): v for k, v in state.items()}
        out["embeddings.position_ids"] = torch.arange(77)[None]
        return out

    _rewrite(root / "vae", old_vae)
    _rewrite(root / "text_encoder", old_text)
    _assert_same_tensors(
        Components.from_checkpoint(root, "tiny", "tiny", device="cpu"),
        port_loaded)


def test_bin_pickles_load(snapshot, port_loaded, tmp_path):
    root = _copy_snapshot(snapshot, tmp_path / "bin")
    for sub in ("unet", "text_encoder"):
        file = next((root / sub).glob("*.safetensors"))
        state = st_load(str(file))
        file.unlink()
        torch.save({"state_dict": state} if sub == "unet" else state,
                   root / sub / "diffusion_pytorch_model.bin")
    _assert_same_tensors(
        Components.from_checkpoint(root, "tiny", "tiny", device="cpu"),
        port_loaded)


def test_missing_key_raises_naming_it(snapshot, tmp_path):
    root = _copy_snapshot(snapshot, tmp_path / "missing")
    _rewrite(root / "unet", lambda s: {k: v for k, v in s.items()
                                       if k != "conv_out.bias"})
    with pytest.raises(CheckpointError, match=r"unet .* lacks 1 "
                       r"parameter\(s\): conv_out\.bias"):
        Components.from_checkpoint(root, "tiny", "tiny", device="cpu")


def test_wrong_shape_and_bad_files_raise(snapshot, tmp_path):
    root = _copy_snapshot(snapshot, tmp_path / "shape")
    _rewrite(root / "vae", lambda s: {
        k: (v[:1] if k == "decoder.conv_out.bias" else v)
        for k, v in s.items()})
    with pytest.raises(CheckpointError, match="decoder.conv_out.bias"):
        Components.from_checkpoint(root, "tiny", "tiny", device="cpu")
    root = _copy_snapshot(snapshot, tmp_path / "header")
    next((root / "unet").glob("*.safetensors")).write_bytes(b"\x01")
    with pytest.raises(CheckpointError, match="shorter than a header"):
        Components.from_checkpoint(root, "tiny", "tiny", device="cpu")
    root = _copy_snapshot(snapshot, tmp_path / "empty")
    next((root / "vae").glob("*.safetensors")).unlink()
    with pytest.raises(CheckpointError, match="no weight files"):
        Components.from_checkpoint(root, "tiny", "tiny", device="cpu")


def test_bf16_family_lands_cast_and_keeps_fp32_modules(snapshot,
                                                       port_loaded):
    """With a bf16 UNet/VAE the tensors land cast (the modules are
    allocated at their serving dtypes first); norms, ``conv_out`` and the
    text tower stay float32, as ``Components.random`` leaves them."""
    got = Components.from_checkpoint(snapshot, "tiny", "tiny", device="cpu",
                                     dtype=torch.bfloat16)
    want = Components.from_checkpoint(snapshot, "tiny", "tiny", device="cpu")
    for module in ("unet", "vae"):
        from chiaswarm_tpu_torch.models.common import cast_module

        cast_module(getattr(want, module), torch.bfloat16)
    _states_got, _states_want = _states(got), _states(want)
    for module, state in _states_want.items():
        for key, value in state.items():
            assert _states_got[module][key].dtype == value.dtype, key
            assert torch.equal(_states_got[module][key], value), key
    assert got.unet.conv_out.weight.dtype == torch.float32
    assert got.text_encoders[0].text_model.final_layer_norm.weight.dtype \
        == torch.float32
    assert got.param_bytes() < port_loaded.param_bytes()


def test_each_module_lands_after_the_lander_knows_it_is_allocated(
        snapshot, monkeypatch):
    """``Components.from_checkpoint`` allocates every module, then, module
    by module, tells its lander the parameters are allocated before the
    first of them lands (on a card the lander's stream then waits for the
    kernels already queued on the current stream, which may still use the
    blocks the allocator handed out)."""
    from chiaswarm_tpu_torch.convert import checkpoint

    events: list = []

    class Recording(checkpoint.TensorLander):
        def after_allocation(self) -> None:
            events.append("allocated")
            super().after_allocation()

        def land(self, param, src) -> None:
            events.append(param)
            super().land(param, src)

    monkeypatch.setattr(checkpoint, "TensorLander", Recording)
    got = Components.from_checkpoint(snapshot, "tiny", "tiny", device="cpu")
    modules = [*got.text_encoders, got.unet, got.vae]
    want: list = []
    for module in modules:
        want += ["allocated", *module.parameters()]
    assert len(events) == len(want)
    for seen, expected in zip(events, want):
        assert (seen == expected if isinstance(expected, str)
                else seen is expected)
