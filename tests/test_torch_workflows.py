"""The first non-diffusion workflows through both hive workers, on the CPU.

One burst of a ``stitch`` job (three results fetched from the hive's
assets), an ``img2txt`` caption job, an ``img2txt`` VQA job and a
``txt2audio`` job, handed out by one poll of a ``FakeHive``, through the
JAX worker and through the port's: every envelope equal to the JAX worker's
but ``generation_s``, ``elapsed_s`` and ``slot`` (timings and the slot's
device), the audio's samples within 2e-4 (times 32767, as 16-bit PCM) of
JAX's. Both registries hand out pipelines on one set of tiny weights (the
port's carried across from JAX's), and the port's audio pipeline starts
from JAX's initial draw. A burst of two text-to-speech jobs (one served
at temperature 0, one naming its voice preset by a string) through both
workers: the same envelopes. A burst of a txt2vid, an img2vid and a
vid2vid job through both workers, the registries handing out video and SD
pipelines on shared tiny weights: the same envelope keys, configs (but the
timings) and frame counts. A DeepFloyd cascade job (the tiny cascade and
the tiny x4 upscaler) served through the port's worker; and a model not on
disk (a caption, an AudioLDM, a Bark, a ModelScope and an SVD model),
refused as the JAX worker refuses it.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import wave

import jax
import numpy as np
import pytest
import torch

from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.pipelines import audio as jaudio
from chiaswarm_tpu.pipelines.caption import (
    CaptionComponents as JaxCaptionComponents,
)
from chiaswarm_tpu.pipelines.caption import CaptionPipeline as JaxCaption
from chiaswarm_tpu.workloads import audio as jworkload
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.pipelines import audio as taudio
from chiaswarm_tpu_torch.pipelines.caption import (
    CaptionComponents,
    CaptionPipeline,
)
from chiaswarm_tpu_torch.workloads import audio as tworkload
from tests.fake_hive import FakeHive
from tests.test_torch_audio import _jax_noise


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
def _settings_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    for var in ("SDAAS_ROOT", "SDAAS_URI", "SDAAS_TOKEN", "SWARM_TPU_URI",
                "SWARM_TPU_TOKEN", "CHIASWARM_RESIDENCY_BUDGET"):
        monkeypatch.delenv(var, raising=False)
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


@pytest.fixture(autouse=True)
def _no_ffmpeg(monkeypatch):
    for mod in (tworkload, jworkload):
        mod._ffmpeg_path.cache_clear()
        monkeypatch.setattr(mod, "_ffmpeg_path", lambda: None)


def _jobs(uri: str) -> list[dict]:
    image = f"{uri}/assets/image.png"
    return [
        {"id": "stitch-1", "workflow": "stitch", "model_name": "stitch",
         "seed": 1, "content_type": "image/jpeg",
         "jobs": [{"resultUri": image, "model_name": f"m{i}",
                   "fileName": f"r{i}.png"} for i in range(3)]},
        {"id": "caption-1", "workflow": "img2txt", "seed": 2,
         "model_name": "Salesforce/blip-image-captioning-base",
         "start_image_uri": image, "prompt": "tok5 tok6",
         "content_type": "application/json"},
        {"id": "vqa-1", "workflow": "img2txt", "seed": 3,
         "model_name": "Salesforce/blip-vqa-base", "start_image_uri": image,
         "prompt": "tok7 tok8 ?", "content_type": "application/json",
         "parameters": {"model_type": "BlipForQuestionAnswering"}},
        {"id": "audio-1", "workflow": "txt2audio", "seed": 4,
         "model_name": "tiny_audio", "prompt": "rain on a tin roof",
         "negative_prompt": "hum", "num_inference_steps": 3,
         "audio_length_in_s": 0.1, "content_type": "audio/wav",
         "parameters": {"scheduler_type": "EulerDiscreteScheduler"}},
    ]


class _JaxNoiseAudio(taudio.AudioPipeline):
    """The port's pipeline started from the JAX program's initial draw."""

    def __init__(self, components, jax_pipe) -> None:
        super().__init__(components)
        self.jax_pipe = jax_pipe

    def __call__(self, **kw):
        noise = _jax_noise(self.jax_pipe, kw["duration_s"], kw["seed"])
        return super().__call__(**kw, init_noise=noise)


def _serve(worker_cls, settings_mod, pool, registry, jobs_of,
           hive_cls=FakeHive) -> dict:
    async def scenario():
        hive = hive_cls()
        uri = await hive.start()
        jobs = jobs_of(uri)
        hive.jobs.extend(jobs)
        worker = worker_cls(
            settings=settings_mod.Settings(
                hive_uri=uri, hive_token="t", worker_name="flow-worker",
                poll_busy_s=0.05, poll_idle_s=0.05,
                install_signal_handlers=False),
            pool=pool, registry=registry)
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(len(jobs), timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        # the two hives listen on other ports: the hrefs name "the hive"
        return {r["id"]: json.loads(json.dumps(r).replace(uri, "hive:"))
                for r in hive.results}

    return asyncio.run(scenario())


@pytest.fixture(scope="module")
def tiny_weights():
    caption = JaxCaptionComponents.random("blip_tiny", seed=3)
    audio = jaudio.AudioComponents.random("tiny_audio", seed=2)
    return caption, audio


def _samples(result: dict) -> np.ndarray:
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    with wave.open(io.BytesIO(blob)) as fh:
        return np.frombuffer(fh.readframes(fh.getnframes()), "<i2")


TIMINGS = ("generation_s", "elapsed_s", "slot")


def test_a_burst_of_the_new_workflows_matches_the_jax_worker(tiny_weights):
    caption, audio = tiny_weights
    j_registry = JaxRegistry(allow_random=True)
    j_caption, j_audio = JaxCaption(caption), jaudio.AudioPipeline(audio)
    j_registry.caption_pipeline = lambda name, mesh=None: j_caption
    j_registry.audio_pipeline = lambda name: j_audio
    t_registry = ModelRegistry(allow_random=True, device="cpu")
    t_caption = CaptionPipeline(CaptionComponents.from_jax(
        caption.params, "blip_tiny", device="cpu"))
    t_audio = _JaxNoiseAudio(taudio.AudioComponents.from_jax(
        audio.params, "tiny_audio", device="cpu"), j_audio)
    t_registry.caption_pipeline = lambda name, mesh=None: t_caption
    t_registry.audio_pipeline = lambda name, mesh=None: t_audio

    want = _serve(JaxWorker, jsettings, JaxPool(n_slots=1), j_registry, _jobs)
    got = _serve(tworker.Worker, tsettings, ChipPool(device="cpu"),
                 t_registry, _jobs)
    assert set(got) == set(want) == {"stitch-1", "caption-1", "vqa-1",
                                     "audio-1"}
    for job_id, ref in want.items():
        out = got[job_id]
        assert "error" not in out["pipeline_config"], out["pipeline_config"]
        assert set(out) == set(ref), job_id
        assert {k: v for k, v in out["pipeline_config"].items()
                if k not in TIMINGS} == \
            {k: v for k, v in ref["pipeline_config"].items()
             if k not in TIMINGS}, job_id
        if job_id == "audio-1":
            assert out["artifacts"]["primary"]["content_type"] == "audio/wav"
            a, b = _samples(out), _samples(ref)
            assert a.shape == b.shape == (1600,)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 7
        else:
            assert out["artifacts"] == ref["artifacts"], job_id
    assert len(got["stitch-1"]["pipeline_config"]["image_map"]) == 3
    assert got["vqa-1"]["pipeline_config"]["caption"]


def _tts_jobs(uri: str) -> list[dict]:
    return [
        {"id": "tts-1", "workflow": "txt2audio", "seed": 6,
         "model_name": "tiny_tts", "prompt": "hello there, world",
         "audio_length_in_s": 0.4, "temperature": 0.0,
         "content_type": "audio/wav"},
        {"id": "tts-preset", "workflow": "txt2audio", "seed": 7,
         "model_name": "suno/bark", "prompt": "hi",
         "content_type": "audio/wav",
         "parameters": {"voice_preset": "v2/en_speaker_6"}},
    ]


def test_a_tts_burst_matches_the_jax_worker():
    """Text to speech through both workers on one burst, both registries
    handing out pipelines on one set of tiny weights: the decode at
    temperature 0 (argmax in both packages) gives the same envelope but
    the timings, the samples within 2e-4; a preset named by a string is the
    same fatal envelope in both."""
    from chiaswarm_tpu.pipelines import tts as jtts
    from chiaswarm_tpu_torch.pipelines import tts as ttts

    weights = jtts.TTSComponents.random("tiny_tts", seed=4)
    j_tts = jtts.TTSPipeline(weights)
    t_tts = ttts.TTSPipeline(ttts.TTSComponents.from_jax(
        weights.params, "tiny_tts", device="cpu"))
    j_registry = JaxRegistry(allow_random=True)
    j_registry.tts_pipeline = lambda name: j_tts
    t_registry = ModelRegistry(allow_random=True, device="cpu")
    t_registry.tts_pipeline = lambda name, mesh=None: t_tts

    want = _serve(JaxWorker, jsettings, JaxPool(n_slots=1), j_registry,
                  _tts_jobs)
    got = _serve(tworker.Worker, tsettings, ChipPool(device="cpu"),
                 t_registry, _tts_jobs)
    assert set(got) == set(want) == {"tts-1", "tts-preset"}
    for job_id, ref in want.items():
        out = got[job_id]
        assert set(out) == set(ref), job_id
        assert {k: v for k, v in out["pipeline_config"].items()
                if k not in TIMINGS} == \
            {k: v for k, v in ref["pipeline_config"].items()
             if k not in TIMINGS}, job_id
    served = got["tts-1"]
    assert "error" not in served["pipeline_config"]
    assert served["artifacts"]["primary"]["content_type"] == "audio/wav"
    a, b = _samples(served), _samples(want["tts-1"])
    frames = served["pipeline_config"]["frames"]
    assert a.shape == b.shape == (frames * ttts.TINY_TTS.codec.hop_length,)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 7
    refused = got["tts-preset"]
    assert refused["fatal_error"] is True
    assert "named voice preset" in refused["pipeline_config"]["error"]
    assert refused["artifacts"] == want["tts-preset"]["artifacts"]


@pytest.mark.parametrize("job", [
    {"model_name": "DeepFloyd/tiny_cascade", "prompt": "a cat",
     "num_inference_steps": 2, "sr_steps": 2,
     "upscaler_model_name": "random/tiny_up4"},
], ids=["deepfloyd"])
def test_unported_workflows_stay_fatal_naming_item_6(job, monkeypatch):
    """The DeepFloyd cascade, the last workflow the port refused, is served
    through the worker now: the tiny cascade (16 then 64 px) and the tiny
    x4 upscaler (stage 3 at 2 steps instead of 75) give a 256 px PNG."""
    from PIL import Image

    from chiaswarm_tpu_torch.pipelines.upscale import Upscale4xPipeline

    defaults = list(Upscale4xPipeline.__call__.__defaults__)
    defaults[2] = 2  # (prompt, negative_prompt, steps, ...)
    monkeypatch.setattr(Upscale4xPipeline.__call__, "__defaults__",
                        tuple(defaults))

    def jobs_of(uri):
        return [dict(job, id="later-1", seed=1)]

    got = _serve(tworker.Worker, tsettings, ChipPool(device="cpu"),
                 ModelRegistry(allow_random=True, device="cpu"), jobs_of)
    result = got["later-1"]
    cfg = result["pipeline_config"]
    assert "fatal_error" not in result and "error" not in cfg, cfg
    assert cfg["mode"] == "cascade_txt2img" and cfg["stages"] == 3
    assert cfg["size"] == [256, 256] and cfg["upscale_steps"] == 2
    png = Image.open(io.BytesIO(base64.b64decode(
        result["artifacts"]["primary"]["blob"])))
    assert png.format == "PNG" and png.size == (256, 256)


@pytest.mark.parametrize("job", [
    {"workflow": "img2txt", "model_name": "Salesforce/blip-vqa-base",
     "prompt": "what is it?", "content_type": "application/json",
     "parameters": {"model_type": "BlipForQuestionAnswering"}},
    {"workflow": "txt2audio", "model_name": "cvssp/audioldm-s-full-v2",
     "prompt": "rain", "content_type": "audio/wav"},
    {"workflow": "txt2audio", "model_name": "suno/bark", "prompt": "hello",
     "content_type": "audio/wav"},
    {"workflow": "txt2vid", "model_name": "damo-vilab/text-to-video-ms-1.7b",
     "prompt": "a cat", "content_type": "video/mp4"},
    {"workflow": "img2vid",
     "model_name": "stabilityai/stable-video-diffusion-img2vid",
     "content_type": "video/mp4"},
], ids=["img2txt", "txt2audio", "tts", "txt2vid", "img2vid"])
def test_a_model_not_on_disk_is_refused_as_the_jax_worker_refuses_it(job):
    """Without ``allow_random`` a model the node lacks is "not available on
    this node" in both workers, and neither envelope is fatal. An img2txt
    job carries the refusal as an error artifact in a successful envelope
    (the caption workload turns every failure into one, so the envelope
    has no ``error_kind``); a txt2audio job's envelope is of the non-fatal
    ``model_unavailable`` kind, so the hive may route it to a node that has
    the model; so is a txt2vid or img2vid job's."""
    def jobs_of(uri):
        return [dict(job, id="missing-1", seed=1,
                     start_image_uri=f"{uri}/assets/image.png")]

    want = _serve(JaxWorker, jsettings, JaxPool(n_slots=1),
                  JaxRegistry(allow_random=False), jobs_of)["missing-1"]
    got = _serve(tworker.Worker, tsettings, ChipPool(device="cpu"),
                 ModelRegistry(allow_random=False, device="cpu"),
                 jobs_of)["missing-1"]
    config = got["pipeline_config"]
    assert "not available on this node" in config["error"]
    assert not got.get("fatal_error")
    if job["workflow"] == "img2txt":
        assert "error_kind" not in config
        text = base64.b64decode(got["artifacts"]["primary"]["blob"]).decode()
        assert config["error"] in json.loads(text)["caption"]
    else:
        assert config["error_kind"] == "model_unavailable"
    strip = ("pipeline_config", "worker_name")
    assert {k: v for k, v in got.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}
    assert {k: v for k, v in config.items() if k not in TIMINGS} == \
        {k: v for k, v in want["pipeline_config"].items()
         if k not in TIMINGS}


# ---------------------------------------------------------------------------
# video: txt2vid, img2vid and vid2vid on one burst


def _clip_bytes() -> bytes:
    """A 3-frame 64 px mp4 clip at 12 fps, written with OpenCV."""
    import tempfile
    from pathlib import Path

    import cv2

    fd, name = tempfile.mkstemp(suffix=".mp4")
    path = Path(name)
    try:
        writer = cv2.VideoWriter(name, cv2.VideoWriter_fourcc(*"mp4v"), 12.0,
                                 (64, 64))
        for i in range(3):
            writer.write(np.full((64, 64, 3), 60 * i + 20, np.uint8))
        writer.release()
        return path.read_bytes()
    finally:
        import os

        os.close(fd)
        path.unlink()


class _ClipHive(FakeHive):
    """A hive that also serves ``/assets/clip.mp4``."""

    clip = b""

    def __init__(self) -> None:
        super().__init__()
        self._app.router.add_route("*", "/assets/clip.mp4", self._clip)

    async def _clip(self, request):
        from aiohttp import web

        return web.Response(body=self.clip, content_type="video/mp4")


def _video_jobs(uri: str) -> list[dict]:
    return [
        {"id": "txt2vid-1", "workflow": "txt2vid", "seed": 8,
         "model_name": "tiny_vid", "prompt": "a lighthouse",
         "num_frames": 3, "num_inference_steps": 2, "height": 64,
         "width": 64, "content_type": "video/mp4"},
        {"id": "img2vid-1", "workflow": "img2vid", "seed": 9,
         "model_name": "tiny_svd", "start_image_uri": f"{uri}/assets/image.png",
         "num_frames": 3, "num_inference_steps": 2, "height": 64,
         "width": 64, "content_type": "video/mp4"},
        {"id": "vid2vid-1", "workflow": "vid2vid", "seed": 10,
         "model_name": "tiny", "prompt": "a watercolor",
         "video_uri": f"{uri}/assets/clip.mp4", "num_inference_steps": 3,
         "strength": 0.5, "content_type": "video/mp4"},
    ]


def _frame_count(result: dict) -> int:
    import tempfile
    from pathlib import Path

    from chiaswarm_tpu_torch.workloads.video import _read_frames

    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "out.mp4"
        path.write_bytes(blob)
        frames, _ = _read_frames(str(path))
    return len(frames)


@pytest.fixture(scope="module")
def video_burst():
    """The burst through both workers, once: (JAX's results, the port's)."""
    import os
    import tempfile

    from chiaswarm_tpu.pipelines import diffusion as jdiff
    from chiaswarm_tpu.pipelines import video as jvideo
    from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
    from chiaswarm_tpu_torch.pipelines import video as tvideo
    from tests.test_torch_video import tiny_components
    from tests.test_torch_video_pipeline import tiny_sd_pipes

    _ClipHive.clip = _clip_bytes()
    (j_vid, t_vid), (j_svd, t_svd) = (tiny_components("tiny_vid", 1),
                                      tiny_components("tiny_svd", 2))
    j_sd, t_sd = tiny_sd_pipes()
    j_pipes = {"tiny_vid": jvideo.VideoPipeline(j_vid),
               "tiny_svd": jvideo.Img2VidPipeline(j_svd)}
    t_pipes = {"tiny_vid": tvideo.VideoPipeline(t_vid),
               "tiny_svd": tvideo.Img2VidPipeline(t_svd)}
    assert isinstance(j_sd, jdiff.DiffusionPipeline)
    assert isinstance(t_sd, tdiff.DiffusionPipeline)
    j_registry = JaxRegistry(allow_random=True)
    j_registry.video_pipeline = lambda name, mesh=None: j_pipes[name]
    j_registry.pipeline = lambda name, **kw: j_sd
    t_registry = ModelRegistry(allow_random=True, device="cpu")
    t_registry.video_pipeline = lambda name, mesh=None: t_pipes[name]
    t_registry.pipeline = lambda name, **kw: t_sd
    before = os.environ.get("SWARM_TPU_ROOT")
    with tempfile.TemporaryDirectory() as root:
        os.environ["SWARM_TPU_ROOT"] = root
        try:
            want = _serve(JaxWorker, jsettings, JaxPool(n_slots=1),
                          j_registry, _video_jobs, _ClipHive)
            got = _serve(tworker.Worker, tsettings, ChipPool(device="cpu"),
                         t_registry, _video_jobs, _ClipHive)
        finally:
            if before is None:
                os.environ.pop("SWARM_TPU_ROOT", None)
            else:
                os.environ["SWARM_TPU_ROOT"] = before
    return want, got


@pytest.mark.parametrize("job_id", ["txt2vid-1", "img2vid-1", "vid2vid-1"])
def test_a_video_burst_matches_the_jax_worker(job_id, video_burst):
    """Both workers serve each of the three video workflows on one burst:
    the same envelope keys, the same ``pipeline_config`` but the timings,
    the same artifacts' content types and the same frame counts (the
    frames themselves differ: each package draws its own noise)."""
    want, got = (results[job_id] for results in video_burst)
    config = got["pipeline_config"]
    assert "error" not in config, config
    assert set(got) == set(want)
    timings = (*TIMINGS, "frames_per_sec")
    assert {k: v for k, v in config.items() if k not in timings} == \
        {k: v for k, v in want["pipeline_config"].items()
         if k not in timings}
    assert set(config) == set(want["pipeline_config"])
    assert {name: a["content_type"] for name, a in got["artifacts"].items()} \
        == {name: a["content_type"] for name, a in want["artifacts"].items()} \
        == {"primary": "video/mp4", "thumbnail": "image/jpeg"}
    assert _frame_count(got) == _frame_count(want) == 3
    assert not got.get("fatal_error")
