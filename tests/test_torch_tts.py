"""The port's bark-class text to speech against the JAX package, at
``TINY_TTS``'s widths on the CPU, in float32.

- The families and the routing gate, JAX's copies.
- ``GPT`` (a padded prefill under a ``ring_bias`` with ``actual_len <
  prefill_len``, then two decode steps at their ring slots with
  ``pos_index``; the default ring mask), ``FineGPT`` at every
  ``codebook_idx`` and ``CodecDecoder`` (a bucketed input and one short
  enough for ``causal_pad``'s small-input branch) within 2e-4 of JAX's,
  the params carried across by ``convert/from_jax.py::
  tts_state_from_flax``.
- ``_stage_decode`` at ``top_k = 1``: the semantic stage's embeds with an
  EOS that turns the rest into padding, the coarse stage's padded prompt
  and alternating masks; the ids equal to JAX's.
- The host protocol with the decode replaced on both sides by one scripted
  token stream: the semantic embeds, the ``n_sem`` rounding, the coarse
  prompts and their lengths, exactly JAX's; ``encode_semantic_text``,
  ``_coarse_history`` and the fine windows with a ``fine_prompt`` history
  equal exactly.
- ``TTSPipeline.__call__`` at temperature 0 and ``top_k = 1``: the waveform
  within 2e-4 of JAX's, the ``config`` dict equal; the same seed twice
  gives the same bytes.
- ``from_checkpoint`` on a transformers ``BarkModel`` directory written
  from JAX's tree (the ``attention`` alias, Bark's bias-free LayerNorms,
  tied fine heads, both spellings of weight norm on the codec) against
  JAX's ``convert_bark``; the codec against transformers' EnCodec decoder.
- ``tts_callback``: a WAV of ``frames x hop`` samples, a named preset
  refused as JAX refuses it, the registry's refusal of a model not on
  disk.
"""

from __future__ import annotations

import base64
import functools
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert.torch_to_flax import convert_bark as jax_convert_bark
from chiaswarm_tpu.core.rng import key_for_seed
from chiaswarm_tpu.models import codec as jcodec
from chiaswarm_tpu.models import gpt as jgpt
from chiaswarm_tpu.models import tokenizer as jtok
from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
from chiaswarm_tpu.pipelines import tts as jtts
from chiaswarm_tpu.workloads import audio as jworkload
from chiaswarm_tpu_torch.convert.from_jax import tts_state_from_flax
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.models import codec as tcodec
from chiaswarm_tpu_torch.models.common import NEG_INF
from chiaswarm_tpu_torch.models import gpt as tgpt
from chiaswarm_tpu_torch.models import tokenizer as ttok
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.pipelines import tts as ttts
from chiaswarm_tpu_torch.workloads import audio as tworkload

BAR = 2e-4
FAM = ttts.TINY_TTS
TEXTS = ["hello there, world", "a dog barking in the rain",
         "café crème 42 ünïcode", "", "x" * 200]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for the tiny models' many small ops (the suite's
    workers share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_tiny():
    return jtts.TTSComponents.random("tiny_tts", seed=3)


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    return ttts.TTSComponents.from_jax(jax_tiny.params, FAM, device="cpu")


@pytest.fixture(scope="module")
def pipes(jax_tiny, port_tiny):
    """One JAX pipeline for the module (its jitted stages compile once)."""
    return jtts.TTSPipeline(jax_tiny), ttts.TTSPipeline(port_tiny)


def _close(got: torch.Tensor, want, bar: float = BAR) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bar * max(1.0, float(np.abs(want).max())), err


def _history(seed: int = 0, n_sem: int = 20, n_frames: int = 24) -> dict:
    """A voice preset of bark's shapes at the tiny widths."""
    rng = np.random.default_rng(seed)
    return {"semantic_prompt": rng.integers(0, FAM.semantic_vocab, n_sem),
            "coarse_prompt": rng.integers(0, FAM.codebook_size,
                                          (FAM.n_coarse, n_frames)),
            "fine_prompt": rng.integers(0, FAM.codebook_size,
                                        (FAM.n_fine, n_frames))}


# ------------------------------------------------------------- families

def test_families_are_jax_copies():
    import dataclasses

    assert set(ttts.TTS_FAMILIES) == set(jtts.TTS_FAMILIES)
    for name, fam in jtts.TTS_FAMILIES.items():
        ours = ttts.TTS_FAMILIES[name]
        want = dataclasses.asdict(fam)
        assert dataclasses.asdict(ours) == want, name
        assert ours.coarse_prefill == fam.coarse_prefill
        assert ours.codec.hop_length == fam.codec.hop_length


@pytest.mark.parametrize("name", [
    "suno/bark", "suno/bark-small", "bark", "tiny_tts", "BARK", "x/tiny_tts",
    "acme/embark-audioldm", "cvssp/audioldm-s-full-v2", "", "sd15"])
def test_routing_gate_and_family_match_jax(name):
    assert ttts.is_tts_model(name) == jtts.is_tts_model(name)
    assert ttts.get_tts_family(name).name == jtts.get_tts_family(name).name


@pytest.mark.parametrize("text", TEXTS)
def test_encode_semantic_text_matches_jax(text):
    ours = ttts.encode_semantic_text(ttts.hash_tokenizer(FAM), text, FAM,
                                     FAM.semantic.vocab_size)
    ref = jtts.encode_semantic_text(
        jtok.HashTokenizer(FAM.text_encoding_offset - 2,
                           FAM.max_input_semantic_length),
        text, FAM, FAM.semantic.vocab_size)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


# -------------------------------------------------------------- modules

@pytest.mark.parametrize("entry", ["ids", "embeds"])
def test_gpt_padded_prefill_and_decode_steps_match_jax(jax_tiny, port_tiny,
                                                       entry):
    """A prefill of 10 ring slots with 6 real tokens, then two decode steps
    written at slots 10 and 11 but embedded at positions 6 and 7."""
    cfg = FAM.semantic
    rng = np.random.default_rng(1)
    P, alen = 10, 6
    ids = rng.integers(0, cfg.vocab_size, (1, P)).astype(np.int32)
    embeds = rng.standard_normal((1, P, cfg.n_embd)).astype(np.float32)
    params = jax_tiny.params["semantic"]
    gpt = port_tiny.semantic
    kpos = np.arange(cfg.block_size)

    def bias(ok):
        return np.where(ok, 0.0, NEG_INF).astype(np.float32)

    pre = bias((kpos[None] <= np.arange(P)[:, None])
               & (kpos[None] < alen))[None, None]
    j_caches = jgpt.init_caches(cfg, 1)
    t_caches = tgpt.init_caches(cfg, 1, "cpu", torch.float32)
    kw_j = ({"embeds": jnp.asarray(embeds)} if entry == "embeds" else {})
    want, j_caches = jax_tiny.semantic.apply(
        params, None if entry == "embeds" else jnp.asarray(ids), j_caches, 0,
        jnp.int32(alen), ring_bias=jnp.asarray(pre), **kw_j)
    with torch.no_grad():
        got, _ = gpt(None if entry == "embeds" else torch.from_numpy(ids)
                     .long(), t_caches, 0, alen,
                     embeds=(torch.from_numpy(embeds) if entry == "embeds"
                             else None),
                     ring_bias=torch.from_numpy(pre))
    _close(got, want)
    tok = rng.integers(0, cfg.vocab_size, (2,))
    for t in range(2):
        idx = P + t
        step = bias((kpos < alen) | ((kpos >= P) & (kpos <= idx)))
        want, j_caches = jax_tiny.semantic.apply(
            params, jnp.asarray([[tok[t]]], jnp.int32), j_caches, idx,
            jnp.int32(idx + 1), ring_bias=jnp.asarray(step)[None, None, None],
            pos_index=alen + t)
        with torch.no_grad():
            got, _ = gpt(torch.tensor([[int(tok[t])]]), t_caches, idx,
                         ring_bias=torch.from_numpy(step)[None, None, None],
                         pos_index=alen + t)
        _close(got, want)


def test_gpt_default_ring_mask_matches_jax(jax_tiny, port_tiny):
    """Without a ``ring_bias``: a prefill of 5 and three cached steps."""
    cfg = FAM.coarse
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8))
    params = jax_tiny.params["coarse"]
    j_caches = jgpt.init_caches(cfg, 1)
    t_caches = tgpt.init_caches(cfg, 1, "cpu", torch.float32)
    for start, stop in ((0, 5), (5, 6), (6, 7), (7, 8)):
        want, j_caches = jax_tiny.coarse.apply(
            params, jnp.asarray(ids[:, start:stop], jnp.int32), j_caches,
            start, jnp.int32(stop))
        with torch.no_grad():
            got, _ = port_tiny.coarse(torch.from_numpy(ids[:, start:stop]),
                                      t_caches, start, stop)
        _close(got, want)


@pytest.mark.parametrize("ci", range(1, FAM.n_fine))
def test_fine_gpt_matches_jax(jax_tiny, port_tiny, ci):
    codes = np.random.default_rng(ci).integers(
        0, FAM.fine.vocab_size, (1, FAM.fine_input_length, FAM.n_fine))
    want = jax_tiny.fine.apply(jax_tiny.params["fine"],
                               jnp.asarray(codes, jnp.int32), ci)
    with torch.no_grad():
        got = port_tiny.fine(torch.from_numpy(codes), ci)
    _close(got, want)


@pytest.mark.parametrize("frames", [64, 13, 3, 1])
def test_codec_matches_jax(jax_tiny, port_tiny, frames):
    """64 frames (the pipeline's bucket), and inputs no longer than the
    first conv's pad of 6 (``causal_pad``'s zero-extended branch)."""
    codes = np.random.default_rng(frames).integers(
        0, FAM.codec.codebook_size, (1, FAM.codec.n_codebooks, frames))
    want = jax_tiny.codec.apply(jax_tiny.params["codec"],
                                jnp.asarray(codes, jnp.int32))
    with torch.no_grad():
        got = port_tiny.codec(torch.from_numpy(codes))
    assert got.shape == (1, frames * FAM.codec.hop_length)
    _close(got, want)


@pytest.mark.parametrize("t,pad", [(10, 6), (7, 6), (6, 6), (3, 6), (1, 6),
                                   (1, 2), (4, 0)])
def test_causal_pad_matches_jax(t, pad):
    x = np.random.default_rng(t).standard_normal((2, t, 3)).astype(np.float32)
    want = np.asarray(jcodec._causal_pad(jnp.asarray(x), pad))
    got = tcodec.causal_pad(torch.from_numpy(x).transpose(1, 2), pad)
    assert np.array_equal(got.transpose(1, 2).numpy(), want)


# ---------------------------------------------------------- stage decode

def _semantic_embeds(pipe_j, text: str, history=None):
    """The semantic prefill's embeds as JAX's ``_semantic`` builds them."""
    fam = FAM
    L = fam.max_input_semantic_length
    text_ids = jtts.encode_semantic_text(pipe_j.c.tokenizer, text, fam,
                                         fam.semantic.vocab_size)
    hist = np.full((1, L), fam.semantic_vocab, np.int32)
    if history is not None:
        h = np.asarray(history, np.int32).reshape(-1)[-L:]
        hist[0, :len(h)] = h
    table = np.asarray(pipe_j.c.params["semantic"]["params"]["wte"]
                       ["embedding"])
    emb = table[text_ids] + table[hist]
    infer = table[[[fam.semantic_infer_token]]]
    return np.concatenate([emb, infer], axis=1).astype(np.float32)


def _decode_both(pipes, stage: str, prompt, embeds, actual, masks, eos, pad,
                 max_new, prefill):
    pipe_j, pipe_t = pipes
    out_j = jtts._stage_decode(
        getattr(pipe_j.c, stage), pipe_j.c.params[stage],
        None if prompt is None else jnp.asarray(prompt, jnp.int32),
        None if embeds is None else jnp.asarray(embeds), actual,
        key_for_seed(0), prefill_len=prefill, max_new=max_new, top_k=1,
        temperature=0.0, step_masks=jnp.asarray(masks), eos_id=eos,
        pad_id=pad, use_embeds=embeds is not None)
    out_t = ttts._stage_decode(
        getattr(pipe_t.c, stage),
        None if prompt is None else torch.from_numpy(prompt).long(),
        None if embeds is None else torch.from_numpy(embeds), actual,
        torch.Generator().manual_seed(0), prefill_len=prefill,
        max_new=max_new, top_k=1, temperature=0.0,
        step_masks=torch.from_numpy(masks), eos_id=eos, pad_id=pad)
    return np.asarray(out_j), out_t.numpy()


def test_semantic_stage_decode_matches_jax_through_eos(pipes):
    """The semantic prefill's embeds, its vocab mask, ``top_k = 1``: the
    ids equal to JAX's; then with an EOS the stream reaches at step >= 2,
    every later id the pad id on both sides."""
    fam = FAM
    L = fam.max_input_semantic_length
    embeds = _semantic_embeds(pipes[0], "hello there, world",
                              _history(4)["semantic_prompt"])
    mask = np.full(fam.semantic.out_vocab, NEG_INF, np.float32)
    mask[: fam.semantic_vocab + 1] = 0.0
    masks = np.stack([mask, mask])
    args = dict(prompt=None, embeds=embeds, actual=L + 1, masks=masks,
                max_new=FAM.max_semantic_tokens, prefill=L + 1)
    want, got = _decode_both(pipes, "semantic", eos=-1, pad=0, **args)
    assert np.array_equal(got, want), (got, want)
    stream = want[0]
    eos_at = next(t for t in range(2, len(stream))
                  if stream[t] not in stream[:t])
    eos = int(stream[eos_at])
    want, got = _decode_both(pipes, "semantic", eos=eos,
                             pad=fam.semantic_vocab, **args)
    assert np.array_equal(got, want), (got, want)
    assert want[0, eos_at] == eos
    assert (want[0, eos_at + 1:] == fam.semantic_vocab).all()


def test_coarse_stage_decode_matches_jax_with_alternating_masks(pipes):
    """A coarse prompt of 21 real tokens padded to the 29-slot bucket, the
    two codebooks' masks alternating step by step."""
    fam = FAM
    rng = np.random.default_rng(5)
    P = fam.coarse_prefill
    prompt = np.concatenate([
        rng.integers(0, fam.semantic_vocab, fam.max_coarse_input_length),
        [fam.coarse_infer_token],
        fam.semantic_vocab + rng.integers(0, 2 * fam.codebook_size, 4)])
    actual = len(prompt)
    prompt = np.pad(prompt, (0, P - actual))[None].astype(np.int32)
    masks = np.full((2, fam.coarse.out_vocab), NEG_INF, np.float32)
    lo = fam.semantic_vocab
    masks[0, lo: lo + fam.codebook_size] = 0.0
    masks[1, lo + fam.codebook_size: lo + 2 * fam.codebook_size] = 0.0
    want, got = _decode_both(pipes, "coarse", prompt, None, actual, masks,
                             -1, 0, fam.sliding_window_len, P)
    assert np.array_equal(got, want), (got, want)
    first = want[0] - lo
    assert (first[0::2] < fam.codebook_size).all()
    assert (first[1::2] >= fam.codebook_size).all()


# --------------------------------------------------------- host protocol

@pytest.mark.parametrize("history", [None, 0, 1], ids=["none", "h0", "h1"])
def test_coarse_history_matches_jax(pipes, history):
    pipe_j, pipe_t = pipes
    hist = None if history is None else _history(history, 9 + 4 * history,
                                                 7 + 5 * history)
    ratio = FAM.coarse_rate_hz / FAM.semantic_rate_hz * FAM.n_coarse
    max_sem = int(np.floor(FAM.max_coarse_history / ratio))
    want = pipe_j._coarse_history(hist, ratio, max_sem)
    got = pipe_t._coarse_history(hist, ratio, max_sem)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


class _Scripted:
    """A stand-in for one package's ``_stage_decode``: records each call's
    prompt and sizes and answers with a token stream that depends on the
    call only (the semantic stream ends in EOS five tokens early)."""

    def __init__(self, torch_side: bool) -> None:
        self.torch_side = torch_side
        self.calls = []

    def __call__(self, gpt, *args, **kw):
        if self.torch_side:
            prompt_ids, embeds, actual = args[0], args[1], args[2]
        else:
            prompt_ids, embeds, actual = args[1], args[2], args[3]
        semantic = kw["prefill_len"] == FAM.max_input_semantic_length + 1
        n = kw["max_new"]
        self.calls.append({
            "semantic": semantic, "actual": int(actual),
            "prefill": kw["prefill_len"], "max_new": n,
            "prompt": None if prompt_ids is None else np.asarray(prompt_ids),
            "embeds": None if embeds is None else np.asarray(embeds)})
        t = np.arange(n)
        if semantic:
            toks = (t * 7 + 3) % FAM.semantic_vocab
            toks[max(n - 5, 1):] = FAM.semantic_vocab
        else:
            toks = (FAM.semantic_vocab + (t % 2) * FAM.codebook_size
                    + (t * 5 + len(self.calls)) % FAM.codebook_size)
        toks = toks[None].astype(np.int64)
        return torch.from_numpy(toks) if self.torch_side else jnp.asarray(toks)


@pytest.mark.parametrize("duration,history", [
    (0.1, None), (0.5, None), (0.64, None), (2.0, None), (0.5, 2),
    (0.3, 3)])
def test_host_protocol_matches_jax(monkeypatch, pipes, duration, history):
    """Every prompt the two packages hand their decoders, for a scripted
    token stream: the semantic embeds (2e-4) and ``max_new`` (the ``n_sem``
    rounding), each coarse window's prompt, ``actual_len`` and size
    exactly; then the fine stage and the codec on those tokens."""
    pipe_j, pipe_t = pipes
    scripted_j, scripted_t = _Scripted(False), _Scripted(True)
    monkeypatch.setattr(jtts, "_stage_decode", scripted_j)
    monkeypatch.setattr(ttts, "_stage_decode", scripted_t)
    hist = None if history is None else _history(history, 30, 40)
    wj, _, cj = pipe_j("the rain in spain", duration_s=duration, seed=1,
                       temperature=0.0, history=hist)
    wt, _, ct = pipe_t("the rain in spain", duration_s=duration, seed=1,
                       temperature=0.0, history=hist)
    assert len(scripted_t.calls) == len(scripted_j.calls) > 1
    for got, want in zip(scripted_t.calls, scripted_j.calls):
        assert {k: got[k] for k in ("semantic", "actual", "prefill",
                                    "max_new")} == \
            {k: want[k] for k in ("semantic", "actual", "prefill", "max_new")}
        if want["semantic"]:
            np.testing.assert_allclose(got["embeds"], want["embeds"],
                                       atol=BAR)
        else:
            assert np.array_equal(got["prompt"], want["prompt"])
    assert ct == cj
    np.testing.assert_allclose(wt, np.asarray(wj), atol=BAR)


@pytest.mark.parametrize("frames,history", [(21, False), (48, True),
                                            (70, True)])
def test_fine_windows_match_jax(pipes, frames, history):
    """The window fills at argmax, with and without a ``fine_prompt``
    history (48 and 70 frames behind 16 history frames take 3 and 5
    windows): the codes equal exactly."""
    pipe_j, pipe_t = pipes
    rng = np.random.default_rng(frames)
    coarse = (FAM.semantic_vocab + rng.integers(
        0, FAM.codebook_size, (frames, FAM.n_coarse))
        + np.arange(FAM.n_coarse) * FAM.codebook_size).reshape(-1)
    hist = _history(frames, 10, 30) if history else None
    want = pipe_j._fine(coarse, key_for_seed(0), None, history=hist)
    got = pipe_t._fine(coarse, torch.Generator(), None, history=hist)
    assert got.shape == want.shape == (FAM.n_fine, frames)
    assert np.array_equal(got, want)


# -------------------------------------------------------------- pipeline

@pytest.mark.parametrize("text,history", [
    ("hello there, world", None), ("a dog barking in the rain", 5)])
def test_pipeline_matches_jax_at_top_k_1(pipes, text, history):
    pipe_j, pipe_t = pipes
    hist = None if history is None else _history(history, 30, 40)
    wj, srj, cj = pipe_j(text, duration_s=0.5, seed=2, temperature=0.0,
                         top_k=1, history=hist)
    wt, srt, ct = pipe_t(text, duration_s=0.5, seed=2, temperature=0.0,
                         top_k=1, history=hist)
    assert ct == cj and srt == srj
    assert wt.shape == np.asarray(wj).shape
    np.testing.assert_allclose(wt, np.asarray(wj), atol=BAR)


def test_same_seed_gives_the_same_bytes(pipes):
    pipe_t = pipes[1]
    a = pipe_t("hello there, world", duration_s=0.5, seed=7)
    b = pipe_t("hello there, world", duration_s=0.5, seed=7)
    c = pipe_t("hello there, world", duration_s=0.5, seed=8)
    assert a[0].tobytes() == b[0].tobytes() and a[2] == b[2]
    assert a[0].tobytes() != c[0].tobytes()


# ----------------------------------------------------------- checkpoints

def _weight_norm(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(g, v) with g v / ||v|| == w (v a scaled copy)."""
    v = 3.0 * w
    g = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
    return g.astype(np.float32), v.astype(np.float32)


def bark_state(params: dict, family) -> dict[str, np.ndarray]:
    """The JAX tree written in transformers' ``BarkModel`` layout: Bark's
    LayerNorms without bias, the coarse stage's attention named
    ``attention`` with its causal-mask buffer, the fine heads tied (left
    out), the codec's weights weight-normed in both spellings."""
    state = tts_state_from_flax(params, family)
    out: dict[str, np.ndarray] = {}
    for stage, prefix in (("semantic", "semantic."),
                          ("coarse", "coarse_acoustics."),
                          ("fine", "fine_acoustics.")):
        for key, value in state[stage].items():
            if "layernorm" in key and key.endswith(".bias"):
                continue
            if key.startswith("lm_heads."):
                continue
            if stage == "coarse":
                key = key.replace(".attn.", ".attention.")
            out[prefix + key] = value.numpy()
    n, block = family.semantic.n_layer, family.semantic.block_size
    out[f"semantic.layers.{n - 1}.attn.bias"] = np.tril(
        np.ones((block, block), np.float32))[None, None]
    for key, value in state["codec"].items():
        value = value.numpy()
        if key.startswith("codebooks."):
            k = key.split(".")[1]
            out[f"codec_model.quantizer.layers.{k}.codebook.embed"] = value
            continue
        name = "codec_model.decoder." + key
        if key.endswith(".weight") and value.ndim == 3:
            g, v = _weight_norm(value)
            base = name[: -len(".weight")]
            if ".block." in key:
                out[base + ".parametrizations.weight.original0"] = g
                out[base + ".parametrizations.weight.original1"] = v
            else:
                out[base + ".weight_g"] = g
                out[base + ".weight_v"] = v
        else:
            out[name] = value
    out["codec_model.encoder.layers.0.conv.bias"] = np.zeros(4, np.float32)
    return out


@pytest.fixture(scope="module")
def tied_jax(jax_tiny):
    """JAX's params with every fine head equal to the next table (what a
    checkpoint with tied heads holds)."""
    params = jax.tree.map(np.asarray, jax_tiny.params)
    fine = params["fine"]["params"]
    for k in range(FAM.n_fine - 1):
        fine[f"lm_head_{k}"]["kernel"] = \
            fine[f"wte_{k + 1}"]["embedding"].T.copy()
    return params


VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "there",
          "world", "dog", "bark", "##ing", "in", "the", "rain", ","]
         + [f"w{i}" for i in range(20)])


@pytest.mark.parametrize("vocab", [False, True], ids=["hash", "wordpiece"])
def test_checkpoint_loads_as_jax_converts_it(tmp_path, tied_jax, vocab):
    """The weights as JAX's ``convert_bark`` reads them; the tokenizer a
    ``vocab.txt``'s WordPiece (its raw ids JAX's), else the hash one."""
    state = bark_state(tied_jax, FAM)
    save_file({k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in state.items()}, tmp_path / "model.safetensors")
    if vocab:
        (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    loaded = ttts.TTSComponents.from_checkpoint(tmp_path, "suno/bark-tiny",
                                                FAM, device="cpu")
    if vocab:
        assert isinstance(loaded.tokenizer, ttok.WordPieceTokenizer)
        ref_tok = jtok.WordPieceTokenizer.from_vocab_file(
            tmp_path / "vocab.txt", FAM.max_input_semantic_length)
        for text in ("hello there, world", "a dog barking in the rain"):
            assert np.array_equal(
                ttts.encode_semantic_text(loaded.tokenizer, text, FAM,
                                          FAM.semantic.vocab_size),
                jtts.encode_semantic_text(ref_tok, text, FAM,
                                          FAM.semantic.vocab_size))
    else:
        assert isinstance(loaded.tokenizer, ttok.HashTokenizer)
    ref = tts_state_from_flax(jax_convert_bark(state, FAM), FAM)
    want = tts_state_from_flax(tied_jax, FAM)
    transposed = {f"layers.{i}.conv.weight"
                  for i in tcodec.transpose_slots(FAM.codec)}
    for name in ttts.MODULES:
        got = getattr(loaded, name).state_dict()
        assert set(got) == set(ref[name]) == set(want[name]), name
        for key, value in got.items():
            np.testing.assert_allclose(value.numpy(), want[name][key].numpy(),
                                       atol=1e-6, err_msg=f"{name}.{key}")
            jax_side = ref[name][key]
            if name == "codec" and key in transposed:
                # JAX's converter carries EnCodec's transposed kernels into
                # a correlating ConvTranspose unflipped: its decoder holds
                # them reversed along K (the port keeps the checkpoint's)
                jax_side = jax_side.flip(-1)
            np.testing.assert_allclose(value.numpy(), jax_side.numpy(),
                                       atol=1e-6, err_msg=f"{name}.{key}")


def test_codec_matches_transformers_encodec():
    """The port's decoder on an ``EncodecModel``'s decoder weights, loaded
    through ``convert_bark``'s codec rules, against the model's own
    quantizer decode and decoder (weights at a scale where a flipped
    transposed kernel shows)."""
    pytest.importorskip("transformers")
    from transformers import EncodecConfig, EncodecModel

    from chiaswarm_tpu_torch.convert.checkpoint import convert_bark

    cfg = FAM.codec
    torch.manual_seed(0)
    hf = EncodecModel(EncodecConfig(
        sampling_rate=cfg.sampling_rate, num_filters=cfg.num_filters,
        upsampling_ratios=list(cfg.upsampling_ratios),
        codebook_size=cfg.codebook_size, codebook_dim=cfg.codebook_dim,
        hidden_size=cfg.codebook_dim, num_lstm_layers=cfg.num_lstm_layers,
        num_residual_layers=cfg.num_residual_layers, use_causal_conv=True,
        norm_type="weight_norm", target_bandwidths=[32.0])).eval()
    sd = hf.state_dict()
    gen = torch.Generator().manual_seed(3)
    for key, value in sd.items():
        if value.dtype.is_floating_point and value.ndim >= 2:
            sd[key] = torch.randn(value.shape, generator=gen) * 0.5
    hf.load_state_dict(sd)
    state = {"codec_model." + k: v for k, v in sd.items()}
    parts = convert_bark(state, FAM)
    codec = tcodec.CodecDecoder(cfg)
    missing = set(codec.state_dict()) - set(parts["codec"])
    assert not missing, missing
    codec.load_state_dict({k: parts["codec"][k] for k in codec.state_dict()})
    codes = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.codebook_size, (1, cfg.n_codebooks, 13)))
    with torch.no_grad():
        emb = hf.quantizer.decode(codes.transpose(0, 1))
        want = hf.decoder(emb)[:, 0]
        got = codec(codes)
    assert float(want.abs().max()) > 1e-2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------- workload

def _wav(result: dict) -> tuple[int, int]:
    blob = base64.b64decode(result["primary"]["blob"])
    with wave.open(io.BytesIO(blob)) as fh:
        return fh.getframerate(), fh.getnframes()


class _Registry:
    """Hands out ``pipe`` called at ``top_k = 1`` (the decode programs the
    other tests compiled)."""

    def __init__(self, pipe) -> None:
        self.pipe = functools.partial(pipe, top_k=1)

    def tts_pipeline(self, name, mesh=None):
        return self.pipe


def test_callback_writes_a_wav_of_frames_times_hop(monkeypatch, pipes):
    for mod in (tworkload, jworkload):
        mod._ffmpeg_path.cache_clear()
        monkeypatch.setattr(mod, "_ffmpeg_path", lambda: None)
    pipe_j, pipe_t = pipes
    slot = ChipPool(device="cpu").slots[0]
    kw = dict(seed=3, prompt="hi there", audio_length_in_s=0.4,
              temperature=0.0)
    got, cfg = tworkload.tts_callback(slot, "tiny_tts",
                                      registry=_Registry(pipe_t), **kw)
    want, jcfg = jworkload.tts_callback(slot, "tiny_tts",
                                        registry=_Registry(pipe_j), **kw)
    assert set(cfg) == set(jcfg)
    assert got["primary"]["content_type"] == "audio/wav"
    assert _wav(got) == (FAM.codec.sampling_rate,
                         cfg["frames"] * FAM.codec.hop_length)
    assert _wav(got) == _wav(want)


@pytest.mark.parametrize("preset", ["v2/en_speaker_6", "announcer"])
def test_named_preset_is_refused_as_jax_refuses_it(pipes, preset):
    pipe_j, pipe_t = pipes
    kw = dict(seed=1, prompt="hi", parameters={"voice_preset": preset})
    with pytest.raises(ValueError) as ours:
        tworkload.tts_callback(None, "tiny_tts", registry=_Registry(pipe_t),
                               **kw)
    with pytest.raises(ValueError) as ref:
        jworkload.tts_callback(None, "tiny_tts", registry=_Registry(pipe_j),
                               **kw)
    assert str(ours.value) == str(ref.value)


def test_registry_serves_random_weights_or_refuses_as_jax(tmp_path,
                                                          monkeypatch,
                                                          jax_tiny):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    with pytest.raises(ValueError) as ours:
        ModelRegistry(allow_random=False, device="cpu").tts_pipeline(
            "suno/bark")
    with pytest.raises(ValueError) as ref:
        JaxRegistry(allow_random=False).tts_pipeline("suno/bark")
    assert str(ours.value) == str(ref.value)
    registry = ModelRegistry(allow_random=True, device="cpu")
    pipe = registry.tts_pipeline("tiny_tts")
    assert pipe is registry.tts_pipeline("tiny_tts")
    assert pipe.c.family is ttts.TINY_TTS and pipe.c.device.type == "cpu"
    assert pipe.c.param_bytes() == sum(
        np.asarray(leaf).nbytes for leaf in jax.tree.leaves(jax_tiny.params))
