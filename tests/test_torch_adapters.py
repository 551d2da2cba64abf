"""The port's per-job LoRA and textual inversion on the ``tiny`` family,
against the JAX package.

- ``load_lora`` reads the three formats (diffusers attn-procs, peft,
  kohya-style halves) from safetensors and ``.bin`` files to the same
  merged weights; ``merge_lora`` on every attention projection of the tiny
  UNet within 1e-6 of JAX's merge (carried across by ``params_from_flax``),
  with the same count; scale 0 leaves every weight as it was, bit for bit.
- The registry keys an adapter's pipeline by (LoRA, scale) and inversion,
  builds it from its own weights (the base stays as it was), and a missing
  adapter is classified as JAX classifies it.
- Textual inversion: the file layouts load as JAX loads them, added-token
  splitting gives JAX's ids, the tower's outputs and the image follow JAX's
  (a prompt without the token is untouched), a dimension mismatch is a
  ``ValueError``.
- The workload: the adapter stamps equal JAX's, and a LoRA job rides a lane
  of its own pipeline.
"""

from __future__ import annotations

import copy
import re

import jax
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert import lora as jlora
from chiaswarm_tpu.convert import textual_inversion as jti
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu_torch.convert import lora as tlora
from chiaswarm_tpu_torch.convert import textual_inversion as tti
from chiaswarm_tpu_torch.convert.from_jax import params_from_flax
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.serving.stepper import get_stepper

SIZE = 64
RANK = 2
_PROJ = re.compile(r"^(?P<base>.+\.attn[12])\.(?P<proj>to_q|to_k|to_v|to_out)"
                   r"(?:\.0)?\.weight$")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_tiny():
    return JaxComponents.random("tiny", seed=0)


@pytest.fixture(scope="module")
def host_params(jax_tiny):
    return jax.tree.map(np.asarray, jax_tiny.params)


def _port(host_params) -> Components:
    return Components.from_jax(host_params, "tiny", device="cpu")


def _halves(unet: torch.nn.Module, seed: int = 7) -> dict:
    """Seeded rank-2 (down, up) pairs for every attention projection:
    ``{(base, proj): (down (r, in), up (out, r))}``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, w in unet.named_parameters():
        m = _PROJ.match(name)
        if m:
            o, i = w.shape
            out[(m.group("base"), m.group("proj"))] = (
                torch.from_numpy(rng.normal(size=(RANK, i)).astype(np.float32)
                                 * 0.1),
                torch.from_numpy(rng.normal(size=(o, RANK)).astype(np.float32)
                                 * 0.1))
    return out


def _state(halves: dict, fmt: str) -> dict[str, torch.Tensor]:
    state = {}
    for (base, proj), (down, up) in halves.items():
        if fmt == "attn_procs":
            key = f"unet.{base}.processor.{proj}_lora"
            state[f"{key}.down.weight"], state[f"{key}.up.weight"] = down, up
        else:
            lo, hi = ("lora_A", "lora_B") if fmt == "peft" else (
                "lora_down", "lora_up")
            leaf = f"{base}.{proj}{'.0' if proj == 'to_out' else ''}"
            state[f"{leaf}.{lo}.weight"], state[f"{leaf}.{hi}.weight"] = \
                down, up
    return state


def _write(state: dict, path, suffix: str) -> None:
    path.mkdir(parents=True, exist_ok=True)
    if suffix == ".safetensors":
        save_file(state, path / "adapter.safetensors")
    else:
        torch.save(state, path / f"adapter{suffix}")


# ---------------------------------------------------------------------------
# 1. LoRA


@pytest.mark.parametrize("fmt,suffix", [("attn_procs", ".safetensors"),
                                        ("peft", ".bin"),
                                        ("kohya", ".safetensors")])
def test_lora_formats_merge_to_the_same_weights(tmp_path, host_params, fmt,
                                                suffix):
    base = _port(host_params).unet
    halves = _halves(base)
    _write(_state(halves, fmt), tmp_path / fmt, suffix)
    ref = _port(host_params).unet
    assert tlora.merge_lora(ref, _state(halves, "attn_procs")) == len(halves)
    got = _port(host_params).unet
    n = tlora.merge_lora(got, tlora.load_lora(tmp_path / fmt), scale=1.0)
    assert n == len(halves) == 56  # 7 transformers x 2 attentions x 4
    for (name, a), (_, b) in zip(got.named_parameters(),
                                 ref.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("scale", [1.0, 0.35])
def test_merge_lora_matches_jax(host_params, scale):
    port = _port(host_params)
    halves = _halves(port.unet)
    state = _state(halves, "attn_procs")
    n = tlora.merge_lora(port.unet, state, scale=scale)
    merged, n_ref = jlora.merge_lora(
        host_params["unet"], {k: v.numpy() for k, v in state.items()},
        scale=scale, n_levels=2)
    assert n == n_ref == len(halves)
    ref = params_from_flax(dict(host_params, unet=jax.tree.map(
        np.asarray, merged)), "tiny")["unet"]
    got = port.unet.state_dict()
    for key, value in ref.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   atol=1e-6, err_msg=key)
    moved = [k for k in ref if not torch.equal(
        ref[k], params_from_flax(host_params, "tiny")["unet"][k])]
    assert len(moved) == len(halves)


def test_lora_scale_zero_is_exact_and_bf16_merges_on_the_host(host_params):
    port = _port(host_params)
    before = {k: v.clone() for k, v in port.unet.state_dict().items()}
    tlora.merge_lora(port.unet, _state(_halves(port.unet), "peft"),
                     scale=0.0)
    for key, value in port.unet.state_dict().items():
        assert torch.equal(value, before[key]), key
    # a bf16 weight: the float32 sum cast once, the CPU merge's bits
    unet = _port(host_params).unet.to(torch.bfloat16)
    w = dict(unet.named_parameters())[
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"]
    want = w.detach().float().clone()
    halves = _halves(unet)
    down, up = halves[("down_blocks.0.attentions.0.transformer_blocks.0"
                       ".attn1", "to_q")]
    tlora.merge_lora(unet, _state(halves, "attn_procs"), scale=0.5)
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, (want + (up @ down) * 0.5).to(torch.bfloat16))


def test_lora_refusals(tmp_path, host_params):
    unet = _port(host_params).unet
    with pytest.raises(ValueError, match="matched no UNet projections"):
        tlora.merge_lora(unet, {"text_model.x.lora_A.weight":
                                torch.zeros(2, 2)})
    (tmp_path / "bad.safetensors").write_bytes(b"not a file")
    with pytest.raises(ValueError, match="unreadable LoRA"):
        tlora.load_lora(tmp_path / "bad.safetensors")
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no LoRA adapter files"):
        tlora.load_lora(tmp_path / "empty")


# ---------------------------------------------------------------------------
# 2. the registry


@pytest.fixture()
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    return tmp_path


def _registry():
    return ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                         allow_random=True, device="cpu")


def test_lora_entries_are_keyed_by_scale(root):
    registry = _registry()
    plain = registry.pipeline("tiny")
    halves = _halves(plain.c.unet)
    _write(_state(halves, "attn_procs"), model_dir("acme/style-lora"),
           ".safetensors")
    a = registry.pipeline("tiny", lora="acme/style-lora", lora_scale=1.0)
    b = registry.pipeline("tiny", lora="acme/style-lora", lora_scale=0.25)
    assert len({id(plain), id(a), id(b)}) == 3
    assert registry.pipeline("tiny", lora="acme/style-lora",
                             lora_scale=1.0) is a
    assert a.c.unet is not plain.c.unet
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    w = {p: dict(p.c.unet.named_parameters())[name] for p in (plain, a, b)}
    assert torch.equal(w[plain], dict(_registry().pipeline(
        "tiny").c.unet.named_parameters())[name])
    torch.testing.assert_close(w[b] - w[plain], (w[a] - w[plain]) / 4,
                               rtol=1e-4, atol=1e-6)
    snap = registry.residency.snapshot()
    assert snap["resident_bytes"] == 3 * plain.c.param_bytes()


@pytest.mark.parametrize("field", ["lora", "textual_inversion"])
def test_missing_adapter_is_classified_as_jax(root, monkeypatch, field):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    job = {"id": "miss", "model_name": "tiny", "prompt": "x", "seed": 1,
           "num_inference_steps": 1, "height": SIZE, "width": SIZE,
           field: "acme/not-downloaded"}
    ref = jax_do_work(dict(job), JaxPool(n_slots=1).slots[0],
                      JaxRegistry(catalog=[{"name": "tiny",
                                            "family": "tiny"}],
                                  allow_random=True))
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(dict(job), slot, _registry())
    finally:
        get_stepper(slot).shutdown()
    for result in (got, ref):
        cfg = result["pipeline_config"]
        assert cfg["error_kind"] == "model_unavailable", cfg
        assert "not available on this node" in cfg["error"]
        assert "fatal_error" not in result
    assert got["pipeline_config"]["error"] == ref["pipeline_config"]["error"]


# ---------------------------------------------------------------------------
# 3. textual inversion


def test_added_token_splitting_matches_jax():
    from chiaswarm_tpu.models.tokenizer import HashTokenizer as JaxHash
    from chiaswarm_tpu_torch.models.tokenizer import HashTokenizer

    got, ref = HashTokenizer(1000, 16, 999), JaxHash(1000, 16, 999)
    for tok in (got, ref):
        tok.add_token("<sks>", [1000, 1001])
        tok.add_token("<sks-long>", [1002])
    for text in ("a photo of <sks> dog", "<sks-long> and <sks>",
                 "a plain cat", "<sks><sks>"):
        assert got.encode(text) == ref.encode(text), text


@pytest.mark.parametrize("layout", ["diffusers", "a1111"])
def test_embedding_layouts_load_as_jax(tmp_path, layout):
    vectors = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32)).astype(np.float32))
    if layout == "diffusers":
        from safetensors.torch import save_file as package_save

        package_save({"<cat-toy>": vectors},
                     str(tmp_path / "learned_embeds.safetensors"))
    else:
        torch.save({"string_to_param": {"*": vectors}, "name": "<cat-toy>",
                    "step": 500}, tmp_path / "embedding.pt")
    got = tti.load_embeddings(tmp_path)
    ref = jti.load_embeddings(tmp_path)
    assert set(got) == set(ref) == {"<cat-toy>"}
    np.testing.assert_array_equal(got["<cat-toy>"].numpy(), ref["<cat-toy>"])


def _inverted(host_params, jax_tiny, vectors):
    """(JAX pipeline, port pipeline) with the same inversion applied."""
    jc = JaxComponents.random("tiny", seed=0)
    assert jti.apply_textual_inversion(jc, {"<sks>": vectors}) == ["<sks>"]
    port = _port(host_params)
    assert tti.apply_textual_inversion(port, {"<sks>": vectors}) == ["<sks>"]
    return jdiff.DiffusionPipeline(jc), tdiff.DiffusionPipeline(port)


def test_textual_inversion_changes_generation_as_jax(host_params, jax_tiny):
    vectors = np.random.default_rng(1).normal(size=(2, 32)).astype(
        np.float32)
    j_pipe, t_pipe = _inverted(host_params, jax_tiny, vectors)
    base = tdiff.DiffusionPipeline(_port(host_params))
    assert t_pipe.c.text_encoders[0].text_model.embeddings.token_embedding \
        .weight.shape[0] == 1002
    ids = t_pipe.c.tokenizers[0].encode("a <sks> landscape")
    assert ids == j_pipe.c.tokenizers[0].encode("a <sks> landscape")
    assert 1000 in ids and 1001 in ids
    noise = np.random.default_rng(3).standard_normal(
        (1, SIZE // 2, SIZE // 2, 4)).astype(np.float32)

    def req(cls, prompt):
        return cls(prompt=prompt, steps=2, height=SIZE, width=SIZE, seed=3,
                   guidance_scale=5.0, init_noise=noise)

    for prompt in ("a <sks> landscape", "plain hills"):
        j_img, _ = j_pipe(req(jdiff.GenerateRequest, prompt))
        t_img, _ = t_pipe(req(tdiff.GenerateRequest, prompt))
        diff = np.abs(t_img.astype(int) - np.asarray(j_img).astype(int))
        assert diff.max() <= 1, (prompt, diff.max())
        b_img, _ = base(req(tdiff.GenerateRequest, prompt))
        assert np.array_equal(b_img, t_img) == (prompt == "plain hills")


def test_dimension_mismatch_is_a_value_error(host_params):
    with pytest.raises(ValueError, match="incompatible"):
        tti.apply_textual_inversion(_port(host_params),
                                    {"<sks>": np.zeros((1, 9999), np.float32)})


# ---------------------------------------------------------------------------
# 4. the workload and the lanes


def test_adapter_jobs_format_and_stamp_as_jax(root, monkeypatch):
    from chiaswarm_tpu.node.job_args import format_args as jax_format
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu_torch.node.job_args import format_args

    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    registry = _registry()
    _write(_state(_halves(registry.pipeline("tiny").c.unet), "peft"),
           model_dir("acme/style-lora"), ".safetensors")
    vectors = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 32)).astype(np.float32))
    _write({"<sks>": vectors}, model_dir("acme/concept"), ".safetensors")
    job = {"id": "a", "model_name": "tiny", "prompt": "a <sks> boat",
           "seed": 2, "num_inference_steps": 2, "height": SIZE,
           "width": SIZE, "content_type": "image/png",
           "lora": "acme/style-lora", "cross_attention_scale": 0.5,
           "textual_inversion": "acme/concept"}
    _, kwargs = format_args(copy.deepcopy(job), registry)
    _, ref = jax_format(copy.deepcopy(job), JaxRegistry(catalog=[],
                                                        allow_random=True))
    assert {k: v for k, v in kwargs.items() if k != "registry"} == \
        {k: v for k, v in ref.items() if k != "registry"}
    got = executor.synchronous_do_work(dict(job), ChipPool(
        device="cpu").slots[0], registry)
    cfg = got["pipeline_config"]
    assert "error" not in cfg, cfg
    assert cfg["lora"] == "acme/style-lora"
    assert cfg["cross_attention_scale"] == 0.5
    assert cfg["textual_inversion"] == "acme/concept"


def test_lora_job_rides_a_lane_of_its_own_pipeline(root, monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    registry = _registry()
    _write(_state(_halves(registry.pipeline("tiny").c.unet), "attn_procs"),
           model_dir("acme/style-lora"), ".safetensors")
    job = {"id": "l", "model_name": "tiny", "prompt": "a boat", "seed": 2,
           "num_inference_steps": 2, "height": SIZE, "width": SIZE,
           "content_type": "image/png"}
    slot = ChipPool(device="cpu").slots[0]
    try:
        base = executor.synchronous_do_work(dict(job), slot, registry)
        lora = executor.synchronous_do_work(
            dict(job, lora="acme/style-lora"), slot, registry)
        lanes = get_stepper(slot).stats()
    finally:
        get_stepper(slot).shutdown()
    for result in (base, lora):
        assert "stepper" in result["pipeline_config"], result
    cfg = lora["pipeline_config"]
    assert cfg["lora"] == "acme/style-lora"
    assert cfg["cross_attention_scale"] == 1.0
    assert cfg["stepper"]["lane"] != base["pipeline_config"]["stepper"]["lane"]
    assert lanes["lanes_created"] >= 2
    assert lora["artifacts"]["primary"]["blob"] != \
        base["artifacts"]["primary"]["blob"]
