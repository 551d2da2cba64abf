"""Coalesced bursts in the port (``node/executor.py::
synchronous_do_work_batch``, ``workloads/diffusion.py::
diffusion_coalesced_callback``) against the JAX package.

- ``COALESCE_KEYS``, ``coalescable``, ``_coalesce_key``, ``_row_chunks`` and
  the worker's ``_burst_key`` pinned to JAX's.
- Under ``CHIASWARM_STEPPER=0`` a burst of three txt2img jobs and one of two
  img2img jobs each run as one batched program: every job's image within
  one uint8 level of its solo run (ROADMAP §3d: a row in a larger batch may
  round one level apart on the CPU), ``"coalesced"`` in each config, the
  envelope keys of the JAX executor's coalesced burst.
- A group that raises, or returns a wrong count, falls back to per-job runs
  with a WARNING; ``num_images_per_prompt`` splits a group by ``rows_cap``.
"""

from __future__ import annotations

import base64
import copy
import io
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.node import executor as jexecutor
from chiaswarm_tpu.node import worker as jworker
from chiaswarm_tpu.workloads import diffusion as jworkload
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.workloads import diffusion as tworkload
from tests.test_torch_quantize import jax_twin


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
def _solo(monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                         allow_random=True, device="cpu")


@pytest.fixture(scope="module")
def slot():
    return ChipPool(device="cpu").slots[0]


def _image(seed: int, size: int = 64) -> np.ndarray:
    small = np.random.default_rng(seed).integers(0, 256, (8, 8, 3),
                                                 dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((size, size),
                                                    Image.BICUBIC))


def _job(i: int, **over) -> dict:
    job = {"id": f"job-{i}", "model_name": "tiny",
           "prompt": f"a lighthouse, take {i}", "negative_prompt": "blurry",
           "num_inference_steps": 3, "height": 64, "width": 64,
           "seed": 20 + i, "content_type": "image/png"}
    job.update(over)
    return job


def _png(result) -> np.ndarray:
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def _within_one(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"


# ---------------------------------------------------------------------------
# 1. the keys, pinned to JAX's

KWARGS = [
    {"model_name": "tiny", "num_inference_steps": 20, "height": 512},
    {"model_name": "tiny", "num_inference_steps": 20, "height": 512,
     "reuse_schedule": "every:2"},
    {"model_name": "tiny", "upscale": True},
    {"model_name": "tiny", "controlnet_model_name": "cn"},
    {"model_name": "tiny", "image_guidance_scale": 1.5},
    {"model_name": "tiny", "image": np.zeros((64, 96, 3), np.uint8),
     "strength": 0.6},
    {"model_name": "tiny", "image": np.zeros((64, 96, 3), np.uint8),
     "mask_image": np.zeros((32, 32), np.uint8)},
    {"model_name": "sd15", "lora": "x", "cross_attention_scale": 0.5},
]


def test_coalesce_keys_match_jax():
    assert tworkload.COALESCE_KEYS == jworkload.COALESCE_KEYS
    assert tworkload._UNCOALESCABLE == jworkload._UNCOALESCABLE


@pytest.mark.parametrize("kwargs", KWARGS)
def test_coalescable_and_the_key_match_jax(kwargs):
    assert tworkload.coalescable(kwargs) == jworkload.coalescable(kwargs)
    assert executor._coalesce_key(kwargs) == jexecutor._coalesce_key(kwargs)


@pytest.mark.parametrize("rows,width,size", [
    ((1, 1, 1, 1, 1), 1, 512), ((3, 2, 1), 1, 512), ((4, 4), 2, 512),
    ((2, 2, 2), 1, 1024), ((1, 8, 1, 1), 4, 256), ((5,), 1, 512),
])
def test_row_chunks_match_jax(rows, width, size):
    group = [(i, f"job-{i}", "image/png",
              {"num_images_per_prompt": n, "height": size, "width": size})
             for i, n in enumerate(rows)]
    assert executor._row_chunks(group, width) == \
        jexecutor._row_chunks(group, width)


RAW_JOBS = [
    {"model_name": "tiny", "prompt": "a", "num_inference_steps": 20},
    {"model_name": "tiny", "prompt": "b", "num_inference_steps": 12,
     "guidance_scale": 5.0, "strength": 0.3, "height": 512},
    {"model_name": "tiny", "workflow": "img2img", "image": "u"},
    {"model_name": "tiny", "workflow": "txt2vid"},
    {"model_name": "DeepFloyd/IF-I-XL-v1.0"},
    {"model_name": "timbrooks/instruct-pix2pix"},
    {"model_name": "tiny", "parameters": {"controlnet": {"x": 1}}},
    {"model_name": "tiny", "parameters": {"upscale": True}},
    {"model_name": "tiny", "resume": {"kind": "lane"}},
]


@pytest.mark.parametrize("stepper", ["0", "1"])
@pytest.mark.parametrize("job", RAW_JOBS)
def test_burst_key_matches_jax(monkeypatch, stepper, job):
    monkeypatch.setenv("CHIASWARM_STEPPER", stepper)
    assert tworker._burst_key(copy.deepcopy(job)) == \
        jworker._burst_key(copy.deepcopy(job))


# ---------------------------------------------------------------------------
# 2. coalesced bursts


def test_a_txt2img_burst_runs_as_one_program(registry, slot, caplog):
    jobs = [_job(i) for i in range(3)]
    with caplog.at_level(logging.INFO, logger="chiaswarm_torch.executor"):
        burst = executor.synchronous_do_work_batch(
            copy.deepcopy(jobs), slot, registry)
    assert "coalesced 3 jobs onto one program" in caplog.text
    for job, got in zip(jobs, burst):
        cfg = got["pipeline_config"]
        assert "error" not in cfg, cfg
        assert got["id"] == job["id"]
        assert cfg["coalesced"] == 3 and cfg["batch"] == 1
        assert cfg["seed"] == job["seed"]
        solo = executor.synchronous_do_work(copy.deepcopy(job), slot,
                                            registry)
        assert "coalesced" not in solo["pipeline_config"]
        _within_one(_png(got), _png(solo))


def test_the_burst_envelope_matches_the_jax_executor(registry, slot):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    class TwinRegistry(JaxRegistry):
        def _load_components(self, model_name):
            # the port registry's seeded weights, without a JAX init
            return jax_twin(model_name)

    jobs = [_job(i, num_inference_steps=2) for i in range(2)]
    ref = jexecutor.synchronous_do_work_batch(
        copy.deepcopy(jobs), JaxPool(n_slots=1).slots[0],
        TwinRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                     allow_random=True))
    got = executor.synchronous_do_work_batch(copy.deepcopy(jobs), slot,
                                             registry)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert set(g["pipeline_config"]) == set(r["pipeline_config"])
        for key in ("coalesced", "batch", "seed", "steps", "mode", "size",
                    "compiled_size", "unet_evals", "steps_skipped"):
            assert g["pipeline_config"][key] == r["pipeline_config"][key], key


def test_an_img2img_burst_encodes_each_job_with_its_own_seed(registry, slot):
    jobs = [_job(i, image=_image(i), strength=0.6) for i in range(2)]
    burst = executor.synchronous_do_work_batch(copy.deepcopy(jobs), slot,
                                               registry)
    for job, got in zip(jobs, burst):
        cfg = got["pipeline_config"]
        assert cfg["coalesced"] == 2 and cfg["mode"] == "img2img", cfg
        solo = executor.synchronous_do_work(copy.deepcopy(job), slot,
                                            registry)
        assert solo["pipeline_config"]["denoise_steps"] == \
            cfg["denoise_steps"]
        _within_one(_png(got), _png(solo))


def test_coalesced_inpaint_rows_keep_their_own_masks(registry):
    """``init_groups`` reads the init stack and the mask stack per JOB: each
    job's latents are its own batch-1 encode, repeated over its rows, and
    its mask is its own; a bucket's padding row repeats the last."""
    pipe = registry.pipeline("tiny")
    images = np.stack([_image(1), _image(2)])
    masks = np.zeros((2, 64, 64), np.float32)
    masks[0, :32] = 1.0
    masks[1, 32:] = 1.0
    mode, start, init, mask = pipe.prepare_image_rows(
        images, masks, 0.6, 4, 64, 64, 0, 4, init_groups=((7, 2), (8, 1)))
    assert mode == "inpaint" and start == 0
    one = pipe.encode_init_image(images[0], 64, 64, 7)
    two = pipe.encode_init_image(images[1], 64, 64, 8)
    for row, want in enumerate((one, one, two, two)):
        assert torch.equal(init[row], want[0])
    assert mask.shape == (4, 1, 32, 32)
    assert float(mask[0, 0, :16].mean()) == 1.0
    assert float(mask[2, 0, 16:].mean()) == 1.0
    assert torch.equal(mask[3], mask[2])


@pytest.mark.parametrize("failure", ["raises", "wrong_count"])
def test_a_failing_group_falls_back_per_job(monkeypatch, registry, slot,
                                            caplog, failure):
    def broken(*args, **kwargs):
        if failure == "raises":
            raise RuntimeError("injected coalesced failure")
        return []

    monkeypatch.setattr(tworkload, "diffusion_coalesced_callback", broken)
    jobs = [_job(i, num_inference_steps=2) for i in range(2)]
    with caplog.at_level(logging.WARNING, logger="chiaswarm_torch.executor"):
        got = executor.synchronous_do_work_batch(copy.deepcopy(jobs), slot,
                                                 registry)
    assert "falling back to per-job execution" in caplog.text
    assert [r["id"] for r in got] == [j["id"] for j in jobs]
    for result in got:
        cfg = result["pipeline_config"]
        assert "error" not in cfg and "coalesced" not in cfg


def test_images_per_prompt_split_a_group(registry, slot):
    """Rows 3, 2, 1 at 64 px: the profitable batch is 4, so the first job
    runs alone and the next two coalesce (JAX's ``_row_chunks``)."""
    jobs = [_job(i, num_inference_steps=2, num_images_per_prompt=n)
            for i, n in enumerate((3, 2, 1))]
    got = executor.synchronous_do_work_batch(copy.deepcopy(jobs), slot,
                                             registry)
    configs = [r["pipeline_config"] for r in got]
    assert [c.get("coalesced") for c in configs] == [None, 2, 2]
    assert [c["batch"] for c in configs] == [4, 2, 1]
    assert _png(got[0]).shape == (64, 64 * 3, 3)
