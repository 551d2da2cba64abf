"""The port's SDXL path on the ``tiny_xl`` family, against the JAX package.

``tiny_xl`` mirrors SDXL's structure at toy widths: two text towers (the
first read at ``output_layer = -2`` with no final layer norm, the second
with a projection), an attention-free first UNet level and the added
conditioning (``add_embedding`` over pooled text and six time ids). JAX
params are carried across by ``convert.from_jax.params_from_flax``; inputs
come from numpy. Bars: 2e-4 in float32 (only the order of float32 sums
differs), images within one uint8 level, the lanes' splice gate (max 3
levels, more than 99% within one) and tensors exactly equal after a
checkpoint round trip.

SDXL's full-width parameter counts are held on the ``meta`` device against
the JAX package's (``jax.eval_shape``) and diffusers' published counts.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.models.unet import UNet as JaxUNet
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from chiaswarm_tpu.pipelines.diffusion import GenerateRequest as JaxRequest
from chiaswarm_tpu.schedulers import sampling as jsampling
from chiaswarm_tpu_torch.convert.from_jax import params_from_flax
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.mesh import MeshSpec
from chiaswarm_tpu_torch.models.configs import FAMILIES
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
from chiaswarm_tpu_torch.parallel.context import capture_ring_calls
from chiaswarm_tpu_torch.pipelines.components import (
    Components,
    estimate_family_bytes,
)
from chiaswarm_tpu_torch.pipelines.diffusion import (
    DiffusionPipeline,
    GenerateRequest,
    set_attn_impl,
)
from chiaswarm_tpu_torch.schedulers import sampling as tsampling
from chiaswarm_tpu_torch.serving.residency import ResidencyManager
from chiaswarm_tpu_torch.serving.stepper import get_stepper

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
PROMPT = "a lighthouse on a cliff at golden hour"
CATALOG = [{"name": "tiny_xl", "family": "tiny_xl"}]


@pytest.fixture(scope="module")
def jax_xl():
    return JaxComponents.random("tiny_xl", seed=0)


@pytest.fixture(scope="module")
def host_params(jax_xl):
    return jax.tree.map(np.asarray, jax_xl.params)


@pytest.fixture(scope="module")
def port_xl(host_params):
    return Components.from_jax(host_params, "tiny_xl", device="cpu")


@pytest.fixture(scope="module")
def port_pipe(port_xl):
    return DiffusionPipeline(port_xl)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _within_one(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert got.std() > 1.0  # a real picture, not a flat frame


# ---------------------------------------------------------------------------
# 1. the UNet's added conditioning


def _added(rng) -> dict[str, np.ndarray]:
    return {"time_ids": np.array([[64, 64, 0, 0, 64, 64],
                                  [128, 96, 8, 16, 128, 96]], np.float32),
            "text_embeds": rng.standard_normal((2, 32)).astype(np.float32)}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_unet_added_cond_matches_jax(jax_xl, host_params, attn_impl):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3.25, 901.0], np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    added = _added(rng)
    jax_unet = JaxUNet(dataclasses.replace(FAMILIES["tiny_xl"].unet,
                                           attn_impl=attn_impl))
    ref = jax.jit(jax_unet.apply)(
        host_params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        {k: jnp.asarray(v) for k, v in added.items()})
    port = Components.from_jax(host_params, "tiny_xl", device="cpu")
    set_attn_impl(port.unet, attn_impl)
    t_added = {k: torch.from_numpy(v) for k, v in added.items()}
    with torch.no_grad():
        got = port.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                        t_added)
        # the conditioning reaches the output: other time ids, other eps
        moved = port.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          {**t_added, "time_ids": t_added["time_ids"] * 2})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
    assert (moved - got).abs().max() > 1e-3
    with pytest.raises(ValueError, match="added_cond"):
        port.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))


@pytest.mark.parametrize("module", ["unet", "text_encoder_0",
                                    "text_encoder_1"])
def test_params_from_flax_agrees_with_the_independent_exporter(
        jax_xl, host_params, module):
    """``add_embedding.linear_{1,2}`` and the second tower's
    ``text_projection`` under the names ``tests/torch_export.py`` writes
    (diffusers' and transformers' own)."""
    from tests import torch_export as exp

    n_unet = len(FAMILIES["tiny_xl"].unet.block_out_channels)
    exported = (exp.export_unet(jax_xl.params["unet"], n_unet)
                if module == "unet"
                else exp.export_text_encoder(jax_xl.params[module]))
    ours = params_from_flax(host_params, "tiny_xl")[module]
    assert set(ours) == set(exported)
    for name, value in exported.items():
        np.testing.assert_array_equal(ours[name].numpy(), value, err_msg=name)
    wanted = {"unet": "add_embedding.linear_2.weight",
              "text_encoder_0": "text_model.final_layer_norm.weight",
              "text_encoder_1": "text_projection.weight"}[module]
    assert wanted in ours


# ---------------------------------------------------------------------------
# 2. both text towers


def test_text_encode_matches_jax(jax_xl, port_pipe):
    """The sequence embeddings of both towers concatenated (32 + 32), the
    pooled output of the second through its projection at the first EOS,
    against JAX ``_make_text_encode``; each tower's own readout too."""
    from chiaswarm_tpu.pipelines.diffusion import _make_text_encode

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 998, (2, 77)).astype(np.int32)
    ids[0, 12:] = 999   # eos + eos padding
    ids[1, 40:] = 999
    encode = _make_text_encode(tuple(jax_xl.text_encoders))
    j_seq, j_pool = encode(jax_xl.params, [jnp.asarray(ids)] * 2)
    t_ids = [torch.from_numpy(ids)] * 2
    with torch.no_grad():
        t_seq, t_pool = port_pipe._encode_text(t_ids)
        towers = [te(i) for te, i in zip(port_pipe.c.text_encoders, t_ids)]
    assert tuple(t_seq.shape) == (2, 77, 64) and tuple(t_pool.shape) == (2, 32)
    np.testing.assert_allclose(t_seq.numpy(), np.asarray(j_seq), **TOL)
    np.testing.assert_allclose(t_pool.numpy(), np.asarray(j_pool), **TOL)
    for i, (seq, pool) in enumerate(towers):
        j_seq_i, j_pool_i = jax_xl.text_encoders[i].apply(
            jax_xl.params[f"text_encoder_{i}"], jnp.asarray(ids))
        np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq_i), **TOL)
        np.testing.assert_allclose(pool.numpy(), np.asarray(j_pool_i), **TOL)


# ---------------------------------------------------------------------------
# 3. the solo pipeline and one lane step


@pytest.mark.parametrize("guidance", [7.5, 1.0])
def test_tiny_xl_txt2img_matches_jax(jax_xl, port_pipe, guidance):
    """With CFG (the negative prompt's pooled row before the prompt's) and
    at guidance 1.0 (the no-CFG program), 64 px, 3 steps."""
    noise = np.random.default_rng(0).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    kw = dict(prompt=PROMPT, negative_prompt="blurry", steps=3,
              guidance_scale=guidance, height=64, width=64, seed=0,
              init_noise=noise)
    j_img, j_cfg = JaxPipeline(jax_xl)(JaxRequest(**kw))
    t_img, t_cfg = port_pipe(GenerateRequest(**kw))
    assert t_img.shape == (1, 64, 64, 3)
    _within_one(t_img, j_img)
    assert t_cfg == j_cfg


def test_lane_step_with_the_pooled_pair_matches_jax(jax_xl, port_pipe):
    """One lane step over 4 rows (mixed ladder positions, step counts and
    guidance, one inactive row) with per-row pooled text, against JAX
    ``stepper_step_fn``: latents within 2e-4, the history in eps terms."""
    from chiaswarm_tpu.core.rng import key_for_seed
    from tests.test_torch_stepper import CAP, IDX, START, _ladders

    sig, ts = _ladders(None)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, 32, 4)).astype(np.float32)
    old = rng.standard_normal((4, 32, 32, 4)).astype(np.float32)
    ctx_u, ctx_c = (rng.standard_normal((4, 77, 64)).astype(np.float32)
                    for _ in range(2))
    pooled_u, pooled_c = (rng.standard_normal((4, 32)).astype(np.float32)
                          for _ in range(2))
    guidance = np.array([7.5, 5.0, 9.0, 7.5], np.float32)
    active = np.array([True, True, True, False])
    fn = JaxPipeline(jax_xl).stepper_step_fn(
        batch=4, height=64, width=64, steps_cap=CAP,
        sampler=jsampling.resolve(None))
    keys = jnp.stack([jax.random.fold_in(key_for_seed(0), r)
                      for r in range(4)])
    placeholder = jnp.zeros((1,), jnp.float32)
    j_x, _, j_idx, j_old = fn(
        jax_xl.params, jnp.asarray(ctx_u), jnp.asarray(ctx_c),
        jnp.asarray(pooled_u), jnp.asarray(pooled_c), jnp.asarray(x), keys,
        jnp.asarray(IDX), jnp.asarray(START), jnp.asarray(sig),
        jnp.asarray(ts), jnp.asarray(guidance), jnp.asarray(old),
        jnp.asarray(active), jnp.zeros_like(jnp.asarray(x)),
        jnp.ones((4, 32, 32, 1)), jnp.zeros(4, bool), {"zero": placeholder},
        placeholder, jnp.ones(4, jnp.float32))
    t_x, t_idx, t_old = port_pipe.stepper_step(
        sampler=tsampling.resolve(None), ctx_u=torch.from_numpy(ctx_u),
        ctx_c=torch.from_numpy(ctx_c), x=_nchw(x),
        idx=torch.from_numpy(IDX).long(),
        start_idx=torch.from_numpy(START).long(),
        sigmas=torch.from_numpy(sig), timesteps=torch.from_numpy(ts),
        guidance=torch.from_numpy(guidance), old_denoised=_nchw(old),
        active=torch.from_numpy(active), generators=[None] * 4,
        pooled_u=torch.from_numpy(pooled_u),
        pooled_c=torch.from_numpy(pooled_c))
    assert t_idx.tolist() == np.asarray(j_idx).tolist() == [1, 6, 7, 3]
    torch.testing.assert_close(t_x, _nchw(np.asarray(j_x)), atol=2e-4,
                               rtol=0)
    # the history x - sigma * eps carries the UNet's eps error times sigma:
    # held in eps terms, as tests/test_torch_stepper.py holds it
    sigma = torch.from_numpy(np.maximum(
        1.0, sig[np.arange(4), np.minimum(IDX, CAP)]))
    err = (t_old - _nchw(np.asarray(j_old))).abs().amax(dim=(1, 2, 3))
    assert (err / sigma <= 2e-4).all(), (err, sigma)
    assert torch.equal(t_x[3], _nchw(x)[3])


def test_spliced_sdxl_row_matches_solo(port_pipe):
    """An SDXL job spliced into a running lane at a step >= 1 (other step
    count, guidance and prompt, so other pooled rows beside it): both
    images match the port's solo runs to the splice gate's bar
    (``tests/test_torch_stepper.py``'s)."""
    from tests.test_torch_stepper import _close, scheduler

    with scheduler() as sched:
        fa = sched.submit_request(
            port_pipe, prompt="slow job", steps=5, guidance_scale=7.5,
            height=64, width=64, rows=1, seed=21)
        end = time.monotonic() + 120
        while (sched.stats().get("steps_executed", 0) < 1
               and time.monotonic() < end):
            time.sleep(0.005)
        fb = sched.submit_request(
            port_pipe, prompt="late arrival", negative_prompt="blurry",
            steps=2, guidance_scale=5.0, height=64, width=64, rows=1,
            seed=22)
        pending_b, info_b = fb.result(timeout=300)
        pending_a, info_a = fa.result(timeout=300)
    assert info_b["lane"] == info_a["lane"]
    assert 1 <= info_b["admitted_at_step"] < 5

    def solo(**kw):
        return port_pipe(GenerateRequest(height=64, width=64, **kw))[0]

    _close(pending_a.wait(), solo(prompt="slow job", steps=5,
                                  guidance_scale=7.5, seed=21))
    _close(pending_b.wait(), solo(prompt="late arrival",
                                  negative_prompt="blurry", steps=2,
                                  guidance_scale=5.0, seed=22))


# ---------------------------------------------------------------------------
# 4. a checkpoint written from JAX params, loaded by both packages


@pytest.fixture(scope="module")
def xl_snapshot(tmp_path_factory, jax_xl):
    """A ``tiny_xl`` snapshot in the diffusers layout (``text_encoder_2/``
    with ``text_projection.weight``, ``unet/`` with ``add_embedding.*``)
    written from JAX random params, one ``tokenizer/`` for both towers."""
    from tests.test_torch_checkpoint import write_vocab
    from tests.torch_export import write_checkpoint

    root = tmp_path_factory.mktemp("tiny_xl_snapshot")
    write_checkpoint(root, jax_xl)
    write_vocab(root / "tokenizer")
    return root


def test_snapshot_loads_in_both_packages(xl_snapshot):
    from safetensors import safe_open

    with safe_open(str(xl_snapshot / "text_encoder_2" / "model.safetensors"),
                   "np") as fh:
        assert "text_projection.weight" in fh.keys()
    with safe_open(str(xl_snapshot / "unet" / "model.safetensors"),
                   "np") as fh:
        assert "add_embedding.linear_1.weight" in fh.keys()
    jax_loaded = JaxComponents.from_checkpoint(xl_snapshot, "tiny_xl",
                                               "tiny_xl")
    port = Components.from_checkpoint(xl_snapshot, "tiny_xl", "tiny_xl",
                                      device="cpu")
    want = Components.from_jax(jax.tree.map(np.asarray, jax_loaded.params),
                               "tiny_xl", device="cpu")
    for got_m, want_m in zip([*port.text_encoders, port.unet, port.vae],
                             [*want.text_encoders, want.unet, want.vae]):
        got_s, want_s = got_m.state_dict(), want_m.state_dict()
        assert got_s.keys() == want_s.keys()
        for key, value in want_s.items():
            assert got_s[key].dtype == value.dtype == torch.float32, key
            assert torch.equal(got_s[key], value), key
    # both towers read the one tokenizer/ (JAX's load_tokenizer)
    assert [type(t).__name__ for t in port.tokenizers] == [
        "ClipBpeTokenizer"] * 2
    noise = np.random.default_rng(0).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    kw = dict(prompt=PROMPT, negative_prompt="blurry", steps=3,
              guidance_scale=7.5, height=64, width=64, seed=0,
              init_noise=noise)
    j_img, _ = JaxPipeline(jax_loaded)(JaxRequest(**kw))
    t_img, _ = DiffusionPipeline(port)(GenerateRequest(**kw))
    _within_one(t_img, j_img)


# ---------------------------------------------------------------------------
# 5. the executor, the registry and the worker


def _job(job_id: str = "xl-1", **over) -> dict:
    job = {"id": job_id, "model_name": "tiny_xl", "prompt": PROMPT,
           "negative_prompt": "blurry", "num_inference_steps": 2,
           "seed": 5, "content_type": "image/png"}
    job.update(over)
    return job


@pytest.mark.parametrize("lanes", ["0", "1"])
def test_executor_envelope_matches_the_jax_executor(monkeypatch, lanes):
    """No height or width in the job: the family's ``default_size`` (64
    for tiny_xl, 1024 for sdxl) sizes it, in both packages."""
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.serving.stepper import get_stepper as jax_stepper

    monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
    jax_slot = JaxPool(n_slots=1).slots[0]
    try:
        ref = jax_do_work(_job(), jax_slot,
                          JaxRegistry(catalog=CATALOG, allow_random=True))
    finally:
        jax_stepper(jax_slot).shutdown()
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(
            _job(), slot, ModelRegistry(catalog=CATALOG, allow_random=True,
                                        device="cpu"))
    finally:
        get_stepper(slot).shutdown()
    for result in (got, ref):
        assert "error" not in result["pipeline_config"], result
    assert set(got) == set(ref)
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    assert ("stepper" in got["pipeline_config"]) == (lanes == "1")
    for key in ("family", "model_name", "size", "compiled_size", "batch",
                "mode", "scheduler", "steps", "guidance_scale"):
        assert got["pipeline_config"][key] == ref["pipeline_config"][key], key
    assert got["pipeline_config"]["family"] == "tiny_xl"
    assert got["pipeline_config"]["size"] == [64, 64]


def test_an_sdxl_job_on_a_seq_slot_raises_naming_the_roadmap_item(
        monkeypatch):
    """Served now: an SDXL job on a seq = 4 slot rings (solo path) and its
    envelope is the one-device slot's, image within one uint8 level; what
    the port still refuses on a seq slot (an audio model) names the
    ROADMAP item."""
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    registry = ModelRegistry(catalog=CATALOG, allow_random=True, device="cpu")
    slot = ChipPool(mesh_spec=MeshSpec({"seq": 4}),
                    devices=["cpu"] * 4).slots[0]
    with capture_ring_calls() as rings:
        result = executor.synchronous_do_work(_job(height=64, width=64),
                                              slot, registry)
    solo = executor.synchronous_do_work(_job(height=64, width=64),
                                        ChipPool(device="cpu").slots[0],
                                        registry)
    assert "error" not in result["pipeline_config"], result
    assert rings  # the VAE mid block's 1,024 tokens at least
    assert result["pipeline_config"]["slot"]["mesh_shape"]["seq"] == 4
    _within_one(_png(result), _png(solo))
    refused = executor.synchronous_do_work(
        {"id": "audio-1", "workflow": "txt2audio",
         "model_name": "random/tiny_audio", "prompt": "rain",
         "num_inference_steps": 2, "audio_length_in_s": 0.1, "seed": 1,
         "content_type": "audio/wav"}, slot, registry)
    assert "ROADMAP queue item 7" in refused["pipeline_config"]["error"]


# ---------------------------------------------------------------------------
# SDXL on a seq = 4 mesh (ROADMAP 7d): the pipeline against JAX's seq-mesh
# pipeline and its own one-device run; the executor's lanes and an img2img
# job against the one-device slot


def _png(result) -> np.ndarray:
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("guidance", [7.5, 1.0])
def test_tiny_xl_on_a_seq_mesh_matches_jax_and_single_device(
        jax_xl, port_xl, guidance, monkeypatch):
    """Every self-attention rings (the 256-token UNet level with the ring
    threshold at 1 token, the VAE mid block's 1,024) through B3's plain
    version; the pooled text and time ids ride as row state. Within one
    uint8 level of JAX's seq-mesh pipeline and of the port's one-device
    run."""
    from chiaswarm_tpu.parallel.context import (
        capture_ring_calls as jax_capture_ring_calls,
    )
    from chiaswarm_tpu.parallel.sharding import shard_params
    from chiaswarm_tpu_torch.ops import attention as tattn
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring
    from tests.test_torch_ring import cpu_mesh, jax_seq_mesh

    monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 1)
    monkeypatch.delenv("CHIASWARM_RING_FLASH", raising=False)
    fused = []
    real = tring.ring_flash_fused_plain
    monkeypatch.setattr(tring, "ring_flash_fused_plain", lambda q, *a, **kw: (
        fused.append(tuple(q.shape)), real(q, *a, **kw))[1])
    jax_seq = dataclasses.replace(
        jax_xl, params=shard_params(jax_xl.params, jax_seq_mesh(4)))
    noise = np.random.default_rng(3).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    kw = dict(prompt=PROMPT, negative_prompt="blurry", steps=3,
              guidance_scale=guidance, height=64, width=64, seed=0,
              init_noise=noise)
    with jax_capture_ring_calls() as jax_rings:
        j_img, j_cfg = JaxPipeline(jax_seq)(JaxRequest(**kw))
    assert jax_rings, "the JAX seq-mesh pipeline never rang"
    with capture_ring_calls() as rings:
        ring_img, cfg = DiffusionPipeline(port_xl, mesh=cpu_mesh(4))(
            GenerateRequest(**kw))
    solo_img, solo_cfg = DiffusionPipeline(port_xl)(GenerateRequest(**kw))
    # the attention-free first level never rings; the second level and
    # the VAE mid block do, each a B3 (plain version) call
    assert {shape[1] for _, shape in rings} == {256, 1024}
    assert {kind for kind, _ in rings} == {"ring_flash"}
    assert len(fused) == len(rings)
    # the UNet's batch: the CFG pair, or the prompt's row alone
    assert {shape[0] for shape in fused[:-1]} == {2 if guidance > 1.0 else 1}
    assert cfg == solo_cfg == j_cfg
    assert ring_img.shape == (1, 64, 64, 3)
    _within_one(ring_img, j_img)
    _within_one(ring_img, solo_img)


def _seq_and_solo_slots():
    return (ChipPool(mesh_spec=MeshSpec({"seq": 4}),
                     devices=["cpu"] * 4).slots[0],
            ChipPool(device="cpu").slots[0])


def test_sdxl_lanes_on_a_seq_slot_match_the_one_device_slot(monkeypatch):
    """Two jobs through the lanes of a seq = 4 slot: every lane step's
    256-token self-attentions and every decode's VAE mid block ring, from
    the lane's own thread; each image within one uint8 level of the same
    jobs' lanes on a one-device slot."""
    from chiaswarm_tpu_torch.ops import attention as tattn

    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    monkeypatch.delenv("CHIASWARM_RING_FLASH", raising=False)
    monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 1)
    registry = ModelRegistry(catalog=CATALOG, allow_random=True, device="cpu")
    seq_slot, solo_slot = _seq_and_solo_slots()
    jobs = [_job("xl-lane-1", height=64, width=64, num_inference_steps=3),
            _job("xl-lane-2", height=64, width=64, seed=6,
                 guidance_scale=5.0)]
    try:
        with capture_ring_calls() as rings:
            got = executor.synchronous_do_work_batch(
                [dict(j) for j in jobs], seq_slot, registry)
        solo = executor.synchronous_do_work_batch(
            [dict(j) for j in jobs], solo_slot, registry)
        steps = get_stepper(seq_slot).stats()["steps_executed"]
    finally:
        get_stepper(seq_slot).shutdown()
        get_stepper(solo_slot).shutdown()
    assert {shape[1] for _, shape in rings} == {256, 1024}
    unet_rings = [shape for _, shape in rings if shape[1] == 256]
    decodes = [shape for _, shape in rings if shape[1] == 1024]
    assert len(decodes) == len(jobs) and len(unet_rings) % steps == 0
    for ours, ref in zip(got, solo):
        for result in (ours, ref):
            assert "stepper" in result["pipeline_config"], result
        assert ours["pipeline_config"]["slot"]["mesh_shape"]["seq"] == 4
        _within_one(_png(ours), _png(ref))


def test_an_sdxl_img2img_job_on_a_seq_slot_matches_the_one_device_slot(
        monkeypatch):
    """The solo path: the init image's encode does not ring (JAX runs it
    outside ``seq_parallel_wrap``), the denoise and the decode do; within
    one uint8 level of the one-device slot."""
    from chiaswarm_tpu_torch.ops import attention as tattn

    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 1)
    registry = ModelRegistry(catalog=CATALOG, allow_random=True, device="cpu")
    seq_slot, solo_slot = _seq_and_solo_slots()
    image = np.random.default_rng(7).integers(0, 255, (64, 64, 3),
                                              dtype=np.uint8)
    job = _job("xl-img2img-1", height=64, width=64, num_inference_steps=4,
               strength=0.5, image=image)
    with capture_ring_calls() as rings:
        got = executor.synchronous_do_work(dict(job), seq_slot, registry)
    ref = executor.synchronous_do_work(dict(job), solo_slot, registry)
    for result in (got, ref):
        assert "error" not in result["pipeline_config"], result
        assert result["pipeline_config"]["mode"] == "img2img"
    # 2 of the 4 steps run at strength 0.5; one decode rings, no encode
    assert sum(shape[1] == 1024 for _, shape in rings) == 1
    _within_one(_png(got), _png(ref))


def test_sdxl_footprint_and_eviction_against_sd15_class(tmp_path,
                                                        monkeypatch):
    """A ledger that holds one model evicts a tiny pipeline for a tiny_xl
    one and back, each reload the same weights, with tiny_xl's measured
    footprint."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    catalog = [{"name": "tiny", "family": "tiny"}, *CATALOG]
    big = Components.random("tiny_xl", device="cpu").param_bytes()
    small = Components.random("tiny", device="cpu").param_bytes()
    # room for either model, never both
    ledger = ResidencyManager(budget_bytes=max(big, small) + min(big, small) // 2,
                              hard_limit_bytes=4 * big,
                              persist_path=tmp_path / "residency.json",
                              prefetch=False)
    registry = ModelRegistry(catalog=catalog, allow_random=True,
                             device="cpu", residency=ledger)
    first = registry.pipeline("tiny_xl").c.unet.add_embedding.linear_1.weight
    first = first.clone()
    registry.pipeline("tiny")
    assert registry.model_states() == {"tiny": "resident",
                                       "tiny_xl": "evicted"}
    again = registry.pipeline("tiny_xl")
    assert registry.model_states()["tiny"] == "evicted"
    assert torch.equal(again.c.unet.add_embedding.linear_1.weight, first)
    assert registry.residency.measured_footprints()["tiny_xl"] == big


def test_worker_serves_an_sdxl_checkpoint_through_a_hive(xl_snapshot,
                                                         tmp_path,
                                                         monkeypatch):
    """The port's worker, whose registry has no random fallback, serves a
    ``tiny_xl`` directory under ``<settings root>/models/`` through the
    lanes: an error-free envelope with a 64x64 PNG, the image bit for bit
    the same job's through the executor on the same checkpoint."""
    import shutil

    from chiaswarm_tpu_torch.node import settings as tsettings
    from chiaswarm_tpu_torch.node import worker as tworker
    from tests.fake_hive import FakeHive

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    name = "test/tiny-xl-base"
    shutil.copytree(xl_snapshot, model_dir(name))
    catalog = [{"name": name, "family": "tiny_xl"}]
    job = _job("xl-w", model_name=name, height=64, width=64)
    pool = ChipPool(device="cpu")

    async def scenario():
        hive = FakeHive()
        uri = await hive.start()
        hive.jobs.append(dict(job))
        worker = tworker.Worker(
            settings=tsettings.Settings(
                hive_uri=uri, hive_token="t", worker_name="xl",
                poll_busy_s=0.02, poll_idle_s=0.02,
                install_signal_handlers=False),
            pool=pool, registry=ModelRegistry(catalog=catalog, device="cpu"))
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(1, timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive

    hive = asyncio.run(scenario())
    get_stepper(pool.slots[0]).shutdown()
    [result] = hive.results
    cfg = result["pipeline_config"]
    assert "error" not in cfg, cfg
    assert cfg["family"] == "tiny_xl" and "stepper" in cfg
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    assert Image.open(io.BytesIO(blob)).size == (64, 64)
    slot = ChipPool(device="cpu").slots[0]
    direct = executor.synchronous_do_work(
        dict(job), slot, ModelRegistry(catalog=catalog, device="cpu"))
    get_stepper(slot).shutdown()
    assert base64.b64decode(direct["artifacts"]["primary"]["blob"]) == blob


# ---------------------------------------------------------------------------
# 6. SDXL at its published widths


def test_sdxl_full_width_parameter_count():
    """SDXL is about 3.47 B parameters. Counted on the ``meta`` device, module by module, against the JAX
    package's abstract params (``jax.eval_shape``) and diffusers' and
    transformers' published counts (UNet 2,567,463,684; VAE 83,653,863;
    CLIP-L 123,060,480; OpenCLIP bigG with its projection 694,659,840)."""
    from chiaswarm_tpu.models.configs import FAMILIES as JAX_FAMILIES
    from chiaswarm_tpu.pipelines.components import abstract_params
    from chiaswarm_tpu_torch.models.clip import ClipTextEncoder
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.models.vae import AutoencoderKL

    fam = FAMILIES["sdxl"]
    with torch.device("meta"):
        modules = {f"text_encoder_{i}": ClipTextEncoder(cfg)
                   for i, cfg in enumerate(fam.text_encoders)}
        modules.update(unet=UNet(fam.unet), vae=AutoencoderKL(fam.vae))
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in modules.items()}
    shapes = abstract_params(JAX_FAMILIES["sdxl"])
    assert counts == {name: sum(int(np.prod(leaf.shape))
                                for leaf in jax.tree.leaves(tree))
                      for name, tree in shapes.items()}
    assert counts == {"text_encoder_0": 123_060_480,
                      "text_encoder_1": 694_659_840,
                      "unet": 2_567_463_684, "vae": 83_653_863}
    # the registry's pre-load reservation: bf16, as the JAX package's
    # estimate_family_bytes counts it (before this slice: None)
    assert estimate_family_bytes("sdxl") == 2 * sum(counts.values())
