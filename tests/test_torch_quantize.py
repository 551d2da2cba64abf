"""int8 weights and activation fake-quant in the port
(``chiaswarm_tpu_torch/convert/quantize.py``) against the JAX package's
``chiaswarm_tpu/convert/quantize.py``.

- ``quantize_leaf`` on the same numpy leaves: codes and scales EQUAL after
  the layout transpose (a dense kernel, an NHWC conv and an embedding table,
  scaled along the axis that is last in JAX's leaf), the half-code
  round-trip bound, small and 1-D leaves left float.
- The env readers and ``fake_quant_activation`` (int8, fp8, off) on the same
  input: outputs equal (within one code at most).
- The ``tiny`` and ``tiny_xl`` pipelines under ``CHIASWARM_WEIGHTS=int8``:
  every code and scale equal to JAX's quantized tree (read through
  ``convert/from_jax.py::int8_from_flax``), images within one uint8 level of
  JAX's int8 pipeline on the same noise, and within JAX's int8 gate (mean
  abs < 4 levels, relative L2 < 0.05, ``tests/test_residency.py:341-345``)
  of the port's own float run.
- The registry: ``param_bytes`` under 0.8x, footprints under ``"int8"`` in
  residency.json, the int8 flag in both ledger keys, an int8 ControlNet
  bundle whose codes are JAX's, the decline on a 4-shard ``seq`` slot.
- Activations: q, k and v at the dispatcher, and the solo program's two
  seams (``unet.ctx`` once, ``unet.in`` each step) at the call sites JAX
  traces them, none in the lane programs; the images within the int8 gate
  of JAX's (a value on a quantizer's rounding edge flips one code, which
  moves a few pixels by a few levels).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert import quantize as jq
from chiaswarm_tpu.ops.attention import attention as jax_attention
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu_torch.convert import quantize as tq
from chiaswarm_tpu_torch.convert.from_jax import int8_from_flax
from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.ops.attention import attention
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import (
    Components,
    ControlNetBundle,
    estimate_family_bytes,
)
from chiaswarm_tpu_torch.serving.residency import ResidencyManager


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _formats(monkeypatch):
    monkeypatch.delenv("CHIASWARM_WEIGHTS", raising=False)
    monkeypatch.delenv("CHIASWARM_ACTIVATIONS", raising=False)
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")


PROMPT = "a lighthouse on a cliff at golden hour"


def _request(cls, **kw):
    base = dict(prompt=PROMPT, negative_prompt="blurry", steps=3,
                guidance_scale=7.5, height=64, width=64, seed=0)
    base.update(kw)
    return cls(**base)


def jax_twin(family: str) -> JaxComponents:
    """JAX's components over the weights of the port's
    ``Components.random(family, seed=0)``: the port's diffusers-named state
    dicts through JAX's own converters (``convert/torch_to_flax.py``), so
    no JAX init program compiles (about half a minute a family on a cold
    compile cache). A fresh ``Components.random(family, seed=0,
    device="cpu")`` is the port's twin, weight for weight."""
    from chiaswarm_tpu.convert.torch_to_flax import (
        convert_text_encoder,
        convert_unet,
        convert_vae,
    )
    from chiaswarm_tpu.models.clip import ClipTextEncoder as JaxClip
    from chiaswarm_tpu.models.configs import FAMILIES as JFAMILIES
    from chiaswarm_tpu.models.tokenizer import HashTokenizer
    from chiaswarm_tpu.models.unet import UNet as JaxUNet
    from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE

    port = Components.random(family, seed=0, device="cpu")
    fam = JFAMILIES[family]

    def state(module):
        return {k: v.detach().float().numpy()
                for k, v in module.state_dict().items()}

    params = {f"text_encoder_{i}": convert_text_encoder(state(te))
              for i, te in enumerate(port.text_encoders)}
    params["unet"] = convert_unet(state(port.unet), fam.unet)
    params["vae"] = convert_vae(state(port.vae), fam.vae)
    return JaxComponents(
        family=fam, model_name=f"random/{family}",
        tokenizers=[HashTokenizer(cfg.vocab_size, cfg.max_position_embeddings,
                                  cfg.eos_token_id)
                    for cfg in fam.text_encoders],
        text_encoders=[JaxClip(cfg) for cfg in fam.text_encoders],
        unet=JaxUNet(fam.unet), vae=JaxVAE(fam.vae), params=params)


def port_twin(family: str) -> Components:
    """The port's side of :func:`jax_twin`, drawn again (a few ms)."""
    return Components.random(family, seed=0, device="cpu")


def _gate(img: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    """JAX's int8 gate: (mean abs uint8 difference, relative L2)."""
    diff = np.abs(img.astype(np.float32) - ref.astype(np.float32))
    rel = np.linalg.norm(diff) / max(np.linalg.norm(ref.astype(np.float32)),
                                     1e-9)
    return float(diff.mean()), float(rel)


# ---------------------------------------------------------------------------
# 1. one leaf

# (JAX leaf shape, its torch layout as a transpose, the torch axis the scale
# runs along, a torch module of that kind)
LEAVES = {
    "dense": ((96, 64), (1, 0), 0, torch.nn.Linear(96, 64)),
    "conv": ((3, 3, 16, 32), (3, 2, 0, 1), 0, torch.nn.Conv2d(16, 32, 3)),
    "embedding": ((300, 48), (0, 1), -1, torch.nn.Embedding(300, 48)),
}


@pytest.mark.parametrize("kind", list(LEAVES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_matches_jax(kind, dtype):
    shape, perm, axis, module = LEAVES[kind]
    rng = np.random.default_rng(len(kind))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0, shape[-1])
         ).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel keeps the 1e-12 floor
    jw = jnp.asarray(w, dtype)
    ref = jq.quantize_leaf(jw)
    assert isinstance(ref, jq.Int8Param)
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32)).transpose(perm)
                          .copy()).to(getattr(torch, dtype))
    assert tq.jax_last_axis(module) == axis
    q, scale = tq.quantize_leaf(tw, axis)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(ref.q).transpose(perm))
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(ref.scale).transpose(perm))
    # dequantized at use into the leaf's dtype, within half a code
    deq = tq.Int8Weight(axis, tw.dtype)(q, scale)
    assert deq.dtype == tw.dtype
    np.testing.assert_array_equal(
        deq.float().numpy(),
        np.asarray(ref.dequantize().astype(jnp.float32)).transpose(perm))
    # (a bf16 value may sit exactly on a half code: float32 cancellation)
    err = (tw.float() - (q.float() * scale)).abs()
    assert bool((err <= scale / 2 * (1 + 1e-4) + 1e-8).all())


@pytest.mark.parametrize("shape", [(8192,), (32, 64), (4, 1000)])
def test_small_and_flat_leaves_stay_float(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    assert not isinstance(jq.quantize_leaf(jnp.asarray(w)), jq.Int8Param)
    assert tq.quantize_leaf(torch.from_numpy(w)) is None
    assert tq.quantize_leaf(torch.zeros(64, 128, dtype=torch.int32)) is None


# ---------------------------------------------------------------------------
# 2. the env readers and the activation fake-quant

@pytest.mark.parametrize("raw", ["", "bf16", "int8", "INT8 ", "fp8"])
def test_weights_format_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("CHIASWARM_WEIGHTS", raw)
    assert tq.weights_format() == jq.weights_format()
    assert tq.int8_enabled() == jq.int8_enabled()
    assert tq.bytes_per_param() == jq.bytes_per_param()


@pytest.mark.parametrize("raw", ["", "0", "off", "none", "bf16", "fp32",
                                 "int8", "fp8", " FP8", "int4"])
def test_activations_format_matches_jax(monkeypatch, caplog, raw):
    monkeypatch.setenv("CHIASWARM_ACTIVATIONS", raw)
    with caplog.at_level(logging.WARNING):
        got = tq.activations_format()
    assert got == jq.activations_format()
    assert jq.activations_enabled() == (got != "off")
    # an unknown value is off, with a warning
    assert ("not understood" in caplog.text) == (raw == "int4")


def test_fp8_is_supported_on_the_cpu_as_in_jax():
    from chiaswarm_tpu.core import compat

    assert tq.fp8_supported() is True and compat.fp8_supported() is True


@pytest.mark.parametrize("fmt", ["int8", "fp8", "off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_activation_matches_jax(monkeypatch, fmt, dtype):
    monkeypatch.setenv("CHIASWARM_ACTIVATIONS", fmt)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 33, 4, 8)) * 3.0).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jq.fake_quant_activation(jx).astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tq.fake_quant_activation(tx)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if fmt == "off":
        np.testing.assert_array_equal(got, np.asarray(jx.astype(jnp.float32)))
        return
    scale = np.abs(np.asarray(jx.astype(jnp.float32))).max() / (
        127.0 if fmt == "int8" else 448.0)
    if fmt == "int8":
        codes = [np.round(a / scale) for a in (got, want)]
    else:
        codes = [np.asarray(jnp.asarray(a / scale).astype(jnp.float8_e4m3fn)
                            .view(jnp.uint8)).astype(np.int32)
                 for a in (got, want)]
    assert np.abs(codes[0] - codes[1]).max() <= 1
    assert (got == want).mean() > 0.999
    # a non-float tensor passes through
    ints = torch.arange(6)
    assert tq.fake_quant_activation(ints) is ints


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dispatcher_quantizes_q_k_v_before_any_route(monkeypatch, fmt):
    """q, k and v are fake-quantized at the dispatcher's entry, as in JAX:
    the same output on the plain route within 2e-4, and not the
    unquantized one."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
               for _ in range(3))
    plain = attention(*(torch.from_numpy(a) for a in (q, k, v)), impl="xla")
    monkeypatch.setenv("CHIASWARM_ACTIVATIONS", fmt)
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    impl="xla"))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                    impl="xla").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(got - plain.numpy()).max() > 1e-4


# ---------------------------------------------------------------------------
# 3. pipelines under int8

@pytest.fixture(scope="module")
def families():
    """Per tiny family, JAX's twin of the port's seeded weights."""
    return {name: jax_twin(name) for name in ("tiny", "tiny_xl")}


def _noise(family: str) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)


@pytest.mark.parametrize("family", ["tiny", "tiny_xl"])
def test_int8_pipeline_matches_jax_and_its_own_float_run(monkeypatch,
                                                         families, family):
    jc = families[family]
    port = port_twin(family)
    fp_img, _ = tdiff.DiffusionPipeline(port)(
        _request(tdiff.GenerateRequest, init_noise=_noise(family)))
    monkeypatch.setenv("CHIASWARM_WEIGHTS", "int8")
    n = tq.maybe_quantize_(port.modules(), family=port.family)
    jtree = jq.quantize_tree(jc.params)
    assert n == jq.quantized_leaf_count(jtree) > 0
    # every code and scale equal to JAX's, leaf for leaf
    want = int8_from_flax(jtree, family)
    names = ["text_encoder_%d" % i for i in range(len(port.text_encoders))]
    for part, module in zip(names + ["unet", "vae"], port.modules()):
        mine = tq.int8_leaves(module)
        assert set(mine) == set(want[part]), part
        for key, (q, scale) in want[part].items():
            assert torch.equal(mine[key][0], q), key
            assert torch.equal(mine[key][1], scale.float()), key
    jpipe = jdiff.DiffusionPipeline(dataclasses.replace(jc, params=jtree))
    j_img, j_cfg = jpipe(_request(jdiff.GenerateRequest,
                                  init_noise=_noise(family)))
    t_img, t_cfg = tdiff.DiffusionPipeline(port)(
        _request(tdiff.GenerateRequest, init_noise=_noise(family)))
    diff = np.abs(t_img.astype(np.int16) - np.asarray(j_img).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_cfg == j_cfg
    mean_abs, rel = _gate(t_img, fp_img)
    assert mean_abs < 4.0 and rel < 0.05, (mean_abs, rel)
    assert not np.array_equal(t_img, fp_img)


def _registry(tmp_path, family: str = "tiny") -> ModelRegistry:
    return ModelRegistry(
        catalog=[{"name": family, "family": family}], allow_random=True,
        device="cpu", residency=ResidencyManager(
            1 << 31, 1 << 32, persist_path=tmp_path / "residency.json"))


def test_registry_quantizes_keys_and_persists_under_int8(monkeypatch,
                                                         tmp_path):
    """The measured int8 bytes are under 0.8x the float ones, live codes
    and scales; the pipeline's ledger key carries the flag (a bf16 key is
    JAX's); footprints persist under ``"int8"`` beside ``"bf16"``; a model
    never measured plans at one byte a parameter."""
    fp = _registry(tmp_path).pipeline("tiny")
    monkeypatch.setenv("CHIASWARM_WEIGHTS", "int8")
    reg = _registry(tmp_path)
    assert reg._estimate_bytes("tiny") == estimate_family_bytes("tiny", 1)
    assert 2 * estimate_family_bytes("tiny", 1) == \
        estimate_family_bytes("tiny")
    q = reg.pipeline("tiny")
    assert tq.quantized_leaf_count(q.c.modules()) > 0
    assert q.c.param_bytes() < 0.8 * fp.c.param_bytes()
    assert q.c.param_bytes() == sum(
        p.numel() * p.element_size() for m in q.c.modules()
        for p in m.parameters())
    [key] = list(reg.residency._entries)
    assert key[0] == "pipeline" and key[-1] == "int8"
    assert reg.pipeline("tiny") is q  # the same entry, a hit
    sections = json.loads((tmp_path / "residency.json").read_text())[
        "footprints"]
    assert sections["int8"]["tiny"] == q.c.param_bytes()
    assert sections["bf16"]["tiny"] == fp.c.param_bytes()


def test_int8_controlnet_bundle_codes_are_jax_codes(monkeypatch, tmp_path):
    """An int8 bundle through the registry: its ledger key carries the flag
    (JAX's key plus the device), its codes are the JAX twin's codes (the
    same multiset of leaves) and its branch forward matches JAX's int8
    forward."""
    from chiaswarm_tpu.convert.torch_to_flax import convert_controlnet
    from chiaswarm_tpu.models.configs import FAMILIES as JFAMILIES
    from chiaswarm_tpu.models.controlnet import ControlNet as JaxControlNet

    monkeypatch.setenv("CHIASWARM_WEIGHTS", "int8")
    reg = _registry(tmp_path)
    fam = reg.family_for("tiny")
    bundle = reg.controlnet("cn", fam)
    assert ("controlnet", "cn", "tiny", True, "cpu") in reg.residency._entries
    mine = tq.int8_leaves(bundle.net)
    assert mine
    # the float twin from the same seed, quantized by JAX
    source = ControlNetBundle.random(fam, device="cpu", model_name="cn")
    state = {k: v.float().numpy() for k, v in source.state_dict().items()}
    jparams = jq.quantize_tree(convert_controlnet(state, JFAMILIES[
        "tiny"].unet))
    theirs = collections.Counter()
    for leaf in jax.tree.leaves(jparams["net"], is_leaf=lambda x: isinstance(
            x, jq.Int8Param)):
        if isinstance(leaf, jq.Int8Param):
            q = np.asarray(leaf.q)
            q = q.transpose(3, 2, 0, 1) if q.ndim == 4 else q.T
            theirs[(q.shape, q.tobytes())] += 1
    ours = collections.Counter((tuple(q.shape), q.numpy().tobytes())
                               for q, _ in mine.values())
    assert ours == theirs
    rng = np.random.default_rng(4)
    sample = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    cond = rng.standard_normal((1, 16, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    t = np.array([500.0], np.float32)
    j_down, j_mid = jax.jit(JaxControlNet(JFAMILIES["tiny"].unet).apply)(
        jq.dequantize_tree(jparams["net"]), sample, t, ctx, cond, None, 1.0)
    with torch.no_grad():
        t_down, t_mid = bundle.net(
            torch.from_numpy(sample.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(cond.transpose(0, 3, 1, 2).copy()), None, 1.0)
    for got, want in zip([*t_down, t_mid], [*j_down, j_mid]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=2e-4, atol=2e-4)


def test_int8_declines_on_a_four_shard_seq_slot(monkeypatch, tmp_path,
                                                caplog):
    monkeypatch.setenv("CHIASWARM_WEIGHTS", "int8")
    reg = _registry(tmp_path)
    mesh = build_mesh(MeshSpec({"seq": 4}), devices=["cpu"] * 4)
    with caplog.at_level(logging.WARNING):
        pipe = reg.pipeline("tiny", mesh=mesh)
    assert tq.quantized_leaf_count(pipe.c.modules()) == 0
    assert "skipped for a 4-chip placement" in caplog.text
    [key] = list(reg.residency._entries)
    assert key[-1] != "int8"
    assert tq.maybe_quantize_([torch.nn.Linear(128, 64)],
                              family=reg.family_for("tiny"),
                              mesh=mesh) == 0


# ---------------------------------------------------------------------------
# 4. the solo program's activation seams

@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_solo_activation_seams_match_jax(monkeypatch, families, fmt):
    """With the knob on, both packages quantize the text context once and
    the UNet input each step (JAX traces each seam once, in its program and
    its scan body; the port calls it once and once a step), and the lane
    programs neither; the images within the int8 gate of JAX's, and not
    the float image."""
    port = tdiff.DiffusionPipeline(port_twin("tiny"))
    jpipe = jdiff.DiffusionPipeline(dataclasses.replace(families["tiny"]))
    fp_img, _ = port(_request(tdiff.GenerateRequest, init_noise=_noise("t")))
    monkeypatch.setenv("CHIASWARM_ACTIVATIONS", fmt)
    seen = {"jax": collections.Counter(), "port": [], "port_tags": []}
    real_j, real_t = jdiff.fake_quant_activation, tdiff.fake_quant_activation

    def jax_spy(x, *, tag=None):
        seen["jax"][tag] += 1
        return real_j(x, tag=tag)

    def port_spy(x, fmt=None, tag=None):
        seen["port"].append(tuple(x.shape))
        seen["port_tags"].append(tag)
        return real_t(x, fmt, tag=tag)

    monkeypatch.setattr(jdiff, "fake_quant_activation", jax_spy)
    monkeypatch.setattr(tdiff, "fake_quant_activation", port_spy)
    j_img, _ = jpipe(_request(jdiff.GenerateRequest, init_noise=_noise("t")))
    t_img, _ = port(_request(tdiff.GenerateRequest, init_noise=_noise("t")))
    assert seen["jax"] == {"unet.ctx": 1, "unet.in": 1}
    assert seen["port"] == [(2, 77, 32)] + [(1, 4, 32, 32)] * 3
    # the port's seams carry JAX's tags (the act.<tag> numerics probes)
    assert seen["port_tags"] == ["unet.ctx"] + ["unet.in"] * 3
    mean_abs, rel = _gate(t_img, np.asarray(j_img))
    assert mean_abs < 4.0 and rel < 0.05, (mean_abs, rel)
    assert not np.array_equal(t_img, fp_img)
    # a lane step calls neither seam
    seen["port"].clear()
    rows = 2
    sched = port.noise_schedule
    from chiaswarm_tpu_torch.schedulers import make_sampling_schedule, resolve

    sampler = resolve(None)
    ladder = make_sampling_schedule(sched, 3, sampler)
    ids = port._tokenize([PROMPT] * rows)
    ctx_u, ctx_c, pu, pc = port.stepper_encode(ids, ids)
    x = torch.zeros(rows, 4, 32, 32)
    port.stepper_step(
        sampler=sampler, ctx_u=ctx_u, ctx_c=ctx_c, x=x,
        idx=torch.zeros(rows, dtype=torch.int64),
        start_idx=torch.zeros(rows, dtype=torch.int64),
        sigmas=ladder.sigmas[None].expand(rows, -1).contiguous(),
        timesteps=ladder.timesteps[None].expand(rows, -1).contiguous(),
        guidance=torch.full((rows,), 7.5), old_denoised=torch.zeros_like(x),
        active=torch.ones(rows, dtype=torch.bool), generators=[None] * rows,
        pooled_u=pu, pooled_c=pc)
    assert seen["port"] == []
