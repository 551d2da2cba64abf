"""The port's NSFW safety checker against the JAX package, at tiny widths.

- The vision tower: the port's ``ClipVisionEncoder`` loaded through
  ``convert/checkpoint.py::split_safety_checker`` against JAX's, loaded
  through ``convert_safety_checker``, from one checker-layout state dict, at
  2e-4 in float32.
- ``_clip_preprocess``: the same float32 array on square and non-square
  uint8 frames; ``_vision_config`` from a snapshot's ``config.json``.
- ``check_images`` on a checker directory: the flags equal JAX's under
  thresholds set from JAX's embeddings so that some images flag and some
  do not, every cosine at least 1e-3 from its threshold (the special-care
  adjustment included); a clean and an ``nsfw`` result; the
  ``"unavailable"`` fields with no directory; JAX's own fixture writer's
  directories read by the port; a directory without a buffer cached as no
  checker, as in JAX.
- The executor's envelopes, solo and in lanes, with a checker installed:
  the safety fields equal the JAX executor's.
"""

from __future__ import annotations

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert.torch_to_flax import convert_safety_checker
from chiaswarm_tpu.models.clip import ClipVisionEncoder as JaxVision
from chiaswarm_tpu.models.clip import VisionConfig as JaxVisionConfig
from chiaswarm_tpu.workloads import safety as jsafety
from chiaswarm_tpu_torch.convert.checkpoint import (
    SAFETY_BUFFERS,
    CheckpointError,
    split_safety_checker,
)
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.models.clip import ClipVisionEncoder, VisionConfig
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
from chiaswarm_tpu_torch.pipelines.components import flax_default_init
from chiaswarm_tpu_torch.serving.stepper import get_stepper
from chiaswarm_tpu_torch.workloads import safety as tsafety
from tests.test_safety import write_checker_fixture

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CFG = dict(hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2,
           image_size=28, patch_size=14, projection_dim=8)
N_CONCEPTS, N_SPECIAL = 5, 2
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    """Each test reads checkers under its own settings root, through empty
    checker caches in both packages."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setattr(jsafety, "_CACHE", {})
    monkeypatch.setattr(tsafety, "_CACHE", {})


def _tower_state(seed: int = 0) -> dict[str, torch.Tensor]:
    """A seeded tower's weights in the checker's layout (the trunk under
    ``vision_model.vision_model.``), norms perturbed so they matter."""
    tower = ClipVisionEncoder(VisionConfig(**CFG))
    gen = torch.Generator().manual_seed(seed)
    flax_default_init(tower, gen)
    with torch.no_grad():
        tower.vision_model.embeddings.class_embedding.normal_(0, 0.5,
                                                               generator=gen)
        for m in tower.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.add_(0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.2 * torch.randn(m.bias.shape, generator=gen))
    return {("vision_model." + k if k.startswith("vision_model.") else k):
            v.clone() for k, v in tower.state_dict().items()}


def _buffers(seed: int, concept_t: np.ndarray | float = 2.0,
             special_t: np.ndarray | float = 2.0) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    d = CFG["projection_dim"]
    return {
        "concept_embeds": torch.from_numpy(
            rng.normal(size=(N_CONCEPTS, d)).astype(np.float32)),
        "concept_embeds_weights": torch.from_numpy(np.broadcast_to(
            np.asarray(concept_t, np.float32), (N_CONCEPTS,)).copy()),
        "special_care_embeds": torch.from_numpy(
            rng.normal(size=(N_SPECIAL, d)).astype(np.float32)),
        "special_care_embeds_weights": torch.from_numpy(np.broadcast_to(
            np.asarray(special_t, np.float32), (N_SPECIAL,)).copy()),
    }


def write_checker(target, state: dict[str, torch.Tensor]) -> None:
    """A ``StableDiffusionSafetyChecker`` snapshot: safetensors weights and
    the ``config.json`` the checker reads its vision config from."""
    target.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in state.items()},
              target / "model.safetensors")
    (target / "config.json").write_text(json.dumps({"vision_config": {
        "hidden_size": CFG["hidden_size"],
        "intermediate_size": CFG["intermediate_size"],
        "num_hidden_layers": CFG["num_layers"],
        "num_attention_heads": CFG["num_heads"],
        "image_size": CFG["image_size"],
        "patch_size": CFG["patch_size"],
        "projection_dim": CFG["projection_dim"]}}))


def _images(n: int, seed: int = 5, hw=(40, 56)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _np_state(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in state.items()}


# ---------------------------------------------------------------------------
# 1. the tower and the helpers


def test_vision_tower_matches_jax():
    state = {**_tower_state(), **_buffers(0)}
    params, jbuffers = convert_safety_checker(_np_state(state))
    tower_state, buffers = split_safety_checker(state)
    tower = ClipVisionEncoder(VisionConfig(**CFG))
    tower.load_state_dict(tower_state, strict=True)
    pixels = np.random.default_rng(1).normal(
        size=(3, CFG["image_size"], CFG["image_size"], 3)).astype(np.float32)
    want = np.asarray(JaxVision(JaxVisionConfig(**CFG)).apply(params, pixels))
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - want).max() < 2e-4, np.abs(got - want).max()
    assert np.abs(want).mean() > 1e-2
    for key in SAFETY_BUFFERS:
        np.testing.assert_array_equal(buffers[key].numpy(), jbuffers[key])


@pytest.mark.parametrize("hw", [(64, 64), (100, 400), (300, 90), (10, 20),
                                (224, 224)])
def test_clip_preprocess_matches_jax(hw):
    frame = np.random.default_rng(hw[0] * hw[1]).integers(
        0, 256, (*hw, 3), dtype=np.uint8)
    for size in (224, 28):
        got = tsafety._clip_preprocess(frame, size)
        want = jsafety._clip_preprocess(frame, size)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_vision_config_matches_jax(tmp_path):
    write_checker(tmp_path / "c", {**_tower_state(), **_buffers(0)})
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "config.json").write_text("{not json")
    for cand in (tmp_path / "c", tmp_path / "broken", tmp_path / "absent"):
        got = tsafety._vision_config(cand)
        want = jsafety._vision_config(cand)
        assert [getattr(got, f) for f in vars(want)] == list(
            vars(want).values())


def test_missing_buffer_raises_in_both_packages():
    state = {**_tower_state(), **_buffers(0)}
    del state["special_care_embeds_weights"]
    with pytest.raises(CheckpointError, match="missing"):
        split_safety_checker(state)
    with pytest.raises(ValueError, match="missing"):
        convert_safety_checker(_np_state(state))


def test_checker_dir_lookup_matches_jax(tmp_path):
    """``<model dir>/safety_checker`` first, then the standalone snapshot."""
    for name in ("some/model", None):
        assert tsafety._find_checker_dir(name) is None
        assert jsafety._find_checker_dir(name) is None
    standalone = model_dir(tsafety.CHECKER_MODEL)
    own = model_dir("some/model") / "safety_checker"
    for made in (standalone, own):
        made.mkdir(parents=True)
        for name in ("some/model", "other/model", None):
            assert tsafety._find_checker_dir(name) == \
                jsafety._find_checker_dir(name)
    assert tsafety._find_checker_dir("some/model") == own
    assert tsafety._find_checker_dir("other/model") == standalone


# ---------------------------------------------------------------------------
# 2. check_images: the flags against JAX's


def _gap_threshold(values: np.ndarray) -> float:
    """A threshold in the widest gap between sorted ``values``: some above
    it and some below."""
    v = np.sort(values)
    gaps = np.diff(v)
    i = int(np.argmax(gaps))
    return float((v[i] + v[i + 1]) / 2)


def _set_thresholds(checker_dir, state, images) -> tuple:
    """Thresholds from JAX's embeddings of ``images``: the special-care one
    in the widest gap of the special cosines, each concept's in the widest
    gap of its cosines plus each image's adjustment. Returns the effective
    margins (special, concept) and the JAX flags."""
    write_checker(checker_dir, state)
    jcheck = jsafety.SafetyChecker(checker_dir)
    pix = np.stack([jsafety._clip_preprocess(f, CFG["image_size"])
                    for f in images])
    emb = np.asarray(jcheck._jit_embed(pix))
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    def cos(b):
        return emb @ (b / np.linalg.norm(b, axis=-1, keepdims=True)).T

    special = cos(state["special_care_embeds"].numpy())
    concepts = cos(state["concept_embeds"].numpy())
    special_t = _gap_threshold(special.max(axis=1))
    adjustment = np.where((special > special_t).any(axis=1), 0.01, 0.0)
    effective = concepts + adjustment[:, None]
    concept_t = np.asarray([_gap_threshold(effective[:, j])
                            for j in range(N_CONCEPTS)], np.float32)
    state.update({
        "concept_embeds_weights": torch.from_numpy(concept_t),
        "special_care_embeds_weights": torch.full((N_SPECIAL,), special_t)})
    shutil.rmtree(checker_dir)
    write_checker(checker_dir, state)
    flags = (effective > concept_t[None]).any(axis=1)
    return (np.abs(special - special_t).min(),
            np.abs(effective - concept_t[None]).min(), flags)


def test_check_images_flags_match_jax():
    images = _images(8, hw=(48, 72))
    state = {**_tower_state(3), **_buffers(4)}
    checker_dir = model_dir(tsafety.CHECKER_MODEL)
    m_special, m_concept, flags = _set_thresholds(checker_dir, state, images)
    assert m_special >= MARGIN and m_concept >= MARGIN, (m_special,
                                                         m_concept)
    assert 0 < flags.sum() < len(flags), flags
    j_nsfw, j_fields = jsafety.check_images(images, "some/model")
    t_nsfw, t_fields = tsafety.check_images(images, "some/model", "cpu")
    assert t_fields == j_fields and t_nsfw == j_nsfw is True
    assert t_fields["nsfw_flags"] == [bool(f) for f in flags]
    # one clean image and one flagged image alone: False, then True
    for i in (int(np.argmin(flags)), int(np.argmax(flags))):
        got = tsafety.check_images(images[i:i + 1], "some/model", "cpu")
        assert got == jsafety.check_images(images[i:i + 1], "some/model")
        assert got[0] is bool(flags[i])
    checker = tsafety.get_checker("some/model", "cpu")
    assert checker.param_bytes() == sum(
        v.numel() * 4 for k, v in state.items() if k not in SAFETY_BUFFERS)


def test_unavailable_without_a_checker():
    images = _images(2)
    got = tsafety.check_images(images, "some/model", "cpu")
    assert got == jsafety.check_images(images, "some/model") == (
        False, {"nsfw": False, "safety_checker": "unavailable"})


@pytest.mark.parametrize("threshold,flag", [(-2.0, True), (2.0, False)])
def test_the_jax_fixture_writer_is_read_alike(threshold, flag):
    write_checker_fixture(model_dir(tsafety.CHECKER_MODEL), threshold)
    images = _images(3)
    got = tsafety.check_images(images, "some/model", "cpu")
    assert got == jsafety.check_images(images, "some/model")
    assert got == (flag, {"nsfw": flag, "nsfw_flags": [flag] * 3})


def test_a_broken_checker_is_cached_as_none_in_both_packages():
    state = {**_tower_state(), **_buffers(0)}
    del state["concept_embeds"]
    write_checker(model_dir(tsafety.CHECKER_MODEL), state)
    images = _images(1)
    for _ in range(2):
        got = tsafety.check_images(images, "some/model", "cpu")
        assert got == jsafety.check_images(images, "some/model")
        assert got[1] == {"nsfw": False, "safety_checker": "unavailable"}
    assert list(tsafety._CACHE.values()) == [None]


# ---------------------------------------------------------------------------
# 3. the executor's envelopes


def _job():
    return {"id": "job-safety", "model_name": "tiny", "prompt": "a harbor",
            "num_inference_steps": 3, "height": 64, "width": 64, "seed": 4,
            "content_type": "image/png"}


@pytest.mark.parametrize("lanes,threshold", [("0", -2.0), ("1", 2.0)])
def test_envelope_safety_fields_match_the_jax_executor(monkeypatch, lanes,
                                                       threshold):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.serving.stepper import get_stepper as jax_stepper

    monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
    write_checker_fixture(model_dir(tsafety.CHECKER_MODEL), threshold)
    jax_slot = JaxPool(n_slots=1).slots[0]
    try:
        ref = jax_do_work(_job(), jax_slot, JaxRegistry(
            catalog=[{"name": "tiny", "family": "tiny"}], allow_random=True))
    finally:
        jax_stepper(jax_slot).shutdown()
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(_job(), slot, ModelRegistry(
            catalog=[{"name": "tiny", "family": "tiny"}], allow_random=True,
            device="cpu"))
    finally:
        get_stepper(slot).shutdown()
    cfg, ref_cfg = got["pipeline_config"], ref["pipeline_config"]
    assert "error" not in cfg and "error" not in ref_cfg, (cfg, ref_cfg)
    assert set(cfg) == set(ref_cfg)
    assert ("stepper" in cfg) == ("stepper" in ref_cfg) == (lanes == "1")
    flag = threshold < 0
    for key in ("nsfw", "nsfw_flags"):
        assert cfg[key] == ref_cfg[key]
    assert got["nsfw"] is ref["nsfw"] is flag
    assert cfg["nsfw_flags"] == [flag] and "safety_checker" not in cfg
