"""The port's txt2img slice end to end on the ``tiny`` family, against the
JAX package.

- The pipeline: same weights (carried by ``params_from_flax``), same
  ``init_noise``, 64 px, 4 steps of DPM-Solver++(2M) with Karras sigmas,
  guidance 7.5. The uint8 images agree within one level (float32 on both
  sides; a value on a rounding boundary may truncate either way) and the
  config dicts are equal.
- The executor: the same hive job through both packages'
  ``synchronous_do_work`` gives envelopes with the same keys, both on the
  solo path (``CHIASWARM_STEPPER=0``; the lane envelope is held in
  ``tests/test_torch_stepper.py``).

Tests of the solo path pin ``CHIASWARM_STEPPER=0``; each has a twin with
the lanes on (the default) where the lane behaves the same.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import json
import struct

import jax
import numpy as np
import pytest
import torch

from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from chiaswarm_tpu.pipelines.diffusion import GenerateRequest as JaxRequest
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.node.smoke import main as smoke_main
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.pipelines.diffusion import (
    DiffusionPipeline,
    GenerateRequest,
)

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROMPT = "a lighthouse on a cliff at golden hour"


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(JaxComponents.random("tiny", seed=0))


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    params = jax.tree.map(np.asarray, jax_pipe.c.params)
    return DiffusionPipeline(Components.from_jax(params, "tiny", device="cpu"))


def _request(cls, **kw):
    base = dict(prompt=PROMPT, negative_prompt="blurry", steps=4,
                guidance_scale=7.5, height=64, width=64, seed=0)
    base.update(kw)
    return cls(**base)


def test_tiny_txt2img_matches_jax(jax_pipe, port_pipe):
    # tiny's VAE downscales by 2: 64 px -> a 32 x 32 latent grid
    noise = np.random.default_rng(0).standard_normal((1, 32, 32, 4)).astype(np.float32)
    j_img, j_cfg = jax_pipe(_request(JaxRequest, init_noise=noise))
    t_img, t_cfg = port_pipe(_request(GenerateRequest, init_noise=noise))
    assert t_img.dtype == np.uint8 and t_img.shape == j_img.shape == (1, 64, 64, 3)
    diff = np.abs(t_img.astype(np.int16) - np.asarray(j_img).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_img.std() > 1.0  # a real picture, not a flat frame
    assert t_cfg == j_cfg


def test_rows_are_independent_of_the_batch(port_pipe):
    """Row b's noise depends only on (seed, b): row 0 of a batch-2 request
    draws the batch-1 noise (and renders the same image up to the float32
    rounding of a larger batch's kernels), row 1 differs."""
    from chiaswarm_tpu_torch.core.rng import randn_rows, row_generators

    one = randn_rows(row_generators([(11, 0)]), (4, 8, 8))
    two = randn_rows(row_generators([(11, 0), (11, 1)]), (4, 8, 8))
    assert torch.equal(two[0], one[0]) and not torch.equal(two[1], two[0])
    img1, _ = port_pipe(_request(GenerateRequest, seed=11, steps=2))
    img2, cfg = port_pipe(_request(GenerateRequest, seed=11, steps=2, batch=2))
    assert cfg["batch"] == 2 and img2.shape[0] == 2
    assert np.abs(img2[0].astype(np.int16) - img1[0]).max() <= 1
    assert not np.array_equal(img2[1], img2[0])
    pinned, _ = port_pipe(_request(GenerateRequest, seed=0, steps=2,
                                   sample_seed_rows=((11, 0),)))
    np.testing.assert_array_equal(pinned[0], img1[0])


def test_unbucketed_size_is_cropped_back(port_pipe):
    img, cfg = port_pipe(_request(GenerateRequest, height=72, width=64,
                                  steps=2))
    assert img.shape == (1, 72, 64, 3)
    assert cfg["compiled_size"] == [128, 64] and cfg["size"] == [72, 64]


@pytest.mark.parametrize("field,value", [
    ("reuse_schedule", (1,)),
    ("reuse_schedule", "every:2"),
])
def test_unported_modes_raise_naming_the_slice(monkeypatch, jax_pipe,
                                              port_pipe, field, value):
    """A ``reuse_schedule`` is ignored while DeepCache is off (the JAX
    package's default): the image and config are the plain request's, bit
    for bit. With ``CHIASWARM_DEEPCACHE`` on the port serves it with feature
    reuse, as JAX does (the slice that refused it is ported): the image
    within one uint8 level of JAX's and the config, DeepCache's accounting
    included, equal."""
    monkeypatch.delenv("CHIASWARM_DEEPCACHE", raising=False)
    plain, plain_cfg = port_pipe(_request(GenerateRequest, steps=2))
    got, cfg = port_pipe(_request(GenerateRequest, steps=2, **{field: value}))
    np.testing.assert_array_equal(got, plain)
    assert cfg == plain_cfg
    monkeypatch.setenv("CHIASWARM_DEEPCACHE", "1")
    noise = np.random.default_rng(0).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    j_img, j_cfg = jax_pipe(_request(JaxRequest, init_noise=noise,
                                     **{field: value}))
    t_img, t_cfg = port_pipe(_request(GenerateRequest, init_noise=noise,
                                      **{field: value}))
    diff = np.abs(t_img.astype(np.int16) - np.asarray(j_img).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_cfg == j_cfg
    assert t_cfg["steps_skipped"] > 0
    assert t_cfg["unet_evals"] + t_cfg["steps_skipped"] == 4


def _job(**kw):
    job = {"id": "job-1", "model_name": "tiny", "prompt": PROMPT,
           "negative_prompt": "blurry", "num_inference_steps": 4,
           "height": 64, "width": 64, "seed": 5,
           "content_type": "image/png"}
    job.update(kw)
    return job


@pytest.fixture(scope="module")
def port_registry():
    return ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                         allow_random=True, device="cpu")


def _png_size(blob_b64: str) -> tuple[int, int]:
    blob = base64.b64decode(blob_b64)
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and blob[12:16] == b"IHDR"
    width, height = struct.unpack(">II", blob[16:24])
    return height, width


def test_executor_envelope_matches_the_jax_executor(monkeypatch, port_registry):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    jax_registry = JaxRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                               allow_random=True)
    ref = jax_do_work(_job(), JaxPool(n_slots=1).slots[0], jax_registry)
    got = executor.synchronous_do_work(_job(), ChipPool(device="cpu").slots[0],
                                       port_registry)
    assert "error" not in got["pipeline_config"], got["pipeline_config"]
    assert "error" not in ref["pipeline_config"], ref["pipeline_config"]
    assert set(got) == set(ref)
    assert set(got["artifacts"]) == set(ref["artifacts"])
    for key, artifact in ref["artifacts"].items():
        assert set(got["artifacts"][key]) == set(artifact)
        assert got["artifacts"][key]["content_type"] == artifact["content_type"]
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    assert got["pipeline_config"]["seed"] == ref["pipeline_config"]["seed"] == 5
    for key in ("scheduler", "steps", "guidance_scale", "size", "mode",
                "nsfw", "safety_checker", "family", "model_name"):
        assert got["pipeline_config"][key] == ref["pipeline_config"][key], key
    assert _png_size(got["artifacts"]["primary"]["blob"]) == (64, 64)
    assert got["pipeline_config"]["slot"]["platform"] == "cpu"


@pytest.mark.parametrize("stepper", ["0", "1"])
def test_a_reuse_schedule_job_is_served_as_the_jax_worker_serves_it(
        monkeypatch, port_registry, stepper):
    """DeepCache off (the default in both packages): a job carrying
    ``parameters.reuse_schedule`` gets the JAX executor's envelope keys on
    the solo path and in the lanes, and its image is the plain job's bit
    for bit on the port."""
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.serving.stepper import get_stepper as jax_stepper

    monkeypatch.setenv("CHIASWARM_STEPPER", stepper)
    monkeypatch.delenv("CHIASWARM_DEEPCACHE", raising=False)
    job = _job(parameters={"reuse_schedule": [1, 2]})
    jax_registry = JaxRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                               allow_random=True)
    jax_slot = JaxPool(n_slots=1).slots[0]
    try:
        ref = jax_do_work(copy.deepcopy(job), jax_slot, jax_registry)
    finally:
        jax_stepper(jax_slot).shutdown()
    with _slot() as slot:
        got = executor.synchronous_do_work(copy.deepcopy(job), slot,
                                           port_registry)
        plain = executor.synchronous_do_work(_job(), slot, port_registry)
    for result in (ref, got, plain):
        assert "error" not in result["pipeline_config"], result
        assert ("stepper" in result["pipeline_config"]) is (stepper == "1")
    assert set(got) == set(ref)
    assert set(got["artifacts"]) == set(ref["artifacts"])
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    assert "reuse_schedule" not in got["pipeline_config"]
    assert (got["artifacts"]["primary"]["blob"]
            == plain["artifacts"]["primary"]["blob"])


@pytest.mark.parametrize("job,kind,fatal", [
    # nothing listens on port 1: the fetch's refused connection is a
    # transient fault (retried by the worker), as in the JAX package
    (_job(start_image_uri="http://localhost:1/a.png"), "transient", False),
    # a voice preset named by a string: text to speech refuses it (JAX's
    # ValueError, no preset files on the worker)
    (_job(workflow="txt2audio", model_name="tiny_tts",
          parameters={"voice_preset": "v2/en_speaker_6"}), "fatal", True),
    # the cascade workload reads the image count before it loads a model,
    # and refuses a malformed one as JAX's does
    (_job(model_name="DeepFloyd/IF-I-XL-v1.0", num_images_per_prompt="two"),
     "fatal", True),
    (_job(height=2048, width=512), "fatal", True),
    # DeepCache on (each test switches it on): a schedule that reuses the
    # first step, which fills the cache, is JAX's bad request
    (_job(parameters={"reuse_schedule": [0, 2]}), "fatal", True),
])
def test_unserved_jobs_become_error_envelopes(monkeypatch, port_registry,
                                              job, kind, fatal):
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    monkeypatch.setenv("CHIASWARM_DEEPCACHE", "1")
    _assert_error_envelope(port_registry, job, kind, fatal)


@pytest.mark.parametrize("job,kind,fatal", [
    # nothing listens on port 1: the fetch's refused connection is a
    # transient fault (retried by the worker), as in the JAX package
    (_job(start_image_uri="http://localhost:1/a.png"), "transient", False),
    # a voice preset named by a string: text to speech refuses it (JAX's
    # ValueError, no preset files on the worker)
    (_job(workflow="txt2audio", model_name="tiny_tts",
          parameters={"voice_preset": "v2/en_speaker_6"}), "fatal", True),
    # the cascade workload reads the image count before it loads a model,
    # and refuses a malformed one as JAX's does
    (_job(model_name="DeepFloyd/IF-I-XL-v1.0", num_images_per_prompt="two"),
     "fatal", True),
    (_job(height=2048, width=512), "fatal", True),
    # DeepCache on (each test switches it on): a schedule that reuses the
    # first step, which fills the cache, is JAX's bad request
    (_job(parameters={"reuse_schedule": [0, 2]}), "fatal", True),
])
def test_unserved_jobs_become_error_envelopes_with_lanes_on(
        monkeypatch, port_registry, job, kind, fatal):
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    monkeypatch.setenv("CHIASWARM_DEEPCACHE", "1")
    _assert_error_envelope(port_registry, job, kind, fatal)


def _assert_error_envelope(registry, job, kind, fatal):
    with _slot() as slot:
        result = executor.synchronous_do_work(job, slot, registry)
    cfg = result["pipeline_config"]
    assert cfg["error_kind"] == kind
    assert bool(result.get("fatal_error")) is fatal
    assert result["artifacts"]["primary"]["content_type"] == "image/png"


@contextlib.contextmanager
def _slot():
    """A fresh CPU slot whose lanes, if a job opened one, stop after."""
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    slot = ChipPool(device="cpu").slots[0]
    try:
        yield slot
    finally:
        get_stepper(slot).shutdown()


def test_missing_model_is_non_fatal_model_unavailable(monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    _assert_model_unavailable()


def test_missing_model_is_non_fatal_with_lanes_on(monkeypatch):
    """A lane submit that cannot load the model falls back to the per-job
    path, which reports it."""
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    _assert_model_unavailable()


def _assert_model_unavailable():
    registry = ModelRegistry(allow_random=False, device="cpu")
    with _slot() as slot:
        result = executor.synchronous_do_work(
            _job(content_type="application/json"), slot, registry)
    assert result["pipeline_config"]["error_kind"] == "model_unavailable"
    assert "fatal_error" not in result
    payload = json.loads(base64.b64decode(result["artifacts"]["primary"]["blob"]))
    assert "not available on this node" in payload["caption"]


def test_poisoned_output_uploads_invalid_output(monkeypatch, port_registry):
    from chiaswarm_tpu_torch.pipelines import diffusion

    def flat(self, **kwargs):
        return torch.zeros((1, 64, 64, 3), dtype=torch.uint8)

    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    monkeypatch.setattr(diffusion.DiffusionPipeline, "_generate", flat)
    result = executor.synchronous_do_work(
        _job(), ChipPool(device="cpu").slots[0], port_registry)
    assert result["pipeline_config"]["error_kind"] == "invalid_output"
    assert "fatal_error" not in result


def test_poisoned_lane_output_uploads_invalid_output(monkeypatch,
                                                     port_registry):
    """The lane twin: a flat decoded frame is screened after the lane
    decode and uploads an ``invalid_output`` envelope, not the image."""
    from chiaswarm_tpu_torch.pipelines import diffusion

    def flat(self, x):
        return torch.zeros((x.shape[0], 64, 64, 3), dtype=torch.uint8)

    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    monkeypatch.setattr(diffusion.DiffusionPipeline, "stepper_decode", flat)
    with _slot() as slot:
        result = executor.synchronous_do_work(_job(), slot, port_registry)
    assert result["pipeline_config"]["error_kind"] == "invalid_output"
    assert "lane decode" in result["pipeline_config"]["error"]
    assert "fatal_error" not in result


def test_smoke_cli_runs_tiny_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    _assert_smoke_ok(capsys)


def test_smoke_cli_runs_tiny_on_cpu_with_lanes_on(monkeypatch, capsys):
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    _assert_smoke_ok(capsys)


def _assert_smoke_ok(capsys):
    assert smoke_main(["--device", "cpu", "--steps", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["status"] == "ok" and line["artifacts"] == ["primary"]
    assert line["model"] == "tiny"


def test_smoke_cli_default_model_follows_the_device():
    """On the GPU the bare CLI serves sd15: tiny's 1024-token level has head
    dim 8, which kernel B1 does not take."""
    from chiaswarm_tpu_torch.node.smoke import default_model

    assert default_model(torch.device("cuda")) == "sd15"
    assert default_model(torch.device("cpu")) == "tiny"


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from chiaswarm_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry(allow_random=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Components.random("tiny")
    assert resolve_device("cpu").type == "cpu"
