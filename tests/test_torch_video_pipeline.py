"""The video pipelines and workloads of the port against the JAX package,
on the CPU.

- ``VideoPipeline`` (``TINY_VID``) and ``Img2VidPipeline`` (``TINY_SVD``)
  end to end at 2 steps against JAX's over one set of tiny weights: JAX's
  initial draw (and img2vid's noise-augmentation draw) made here exactly as
  its ``_build_fn`` makes them and injected into the port; frames within
  one uint8 level, the ``config`` dicts equal;
- ``_unbucket_frames`` exactly;
- ``vid2vid_callback`` on ``tiny`` against JAX's, the frames injected, the
  chunk cut to 2 frames in both packages and every normal draw pinned to
  one array on both sides (JAX: ``jax.random.normal`` patched, its
  executables flushed before and after; the port: ``randn_rows``);
- the per-frame init: each frame's latent its own encode, a one-frame stack
  the one-image path bit for bit;
- ``_read_frames``/``_write_video`` on a clip written here, and the clip's
  fetch behind the 30 MiB cap, against JAX's;
- the routing of the three workflows against JAX's ``format_args``.
"""

from __future__ import annotations

import contextlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.convert.torch_to_flax import (
    convert_text_encoder,
    convert_unet,
    convert_vae,
)
from chiaswarm_tpu.core.compile_cache import GLOBAL_CACHE
from chiaswarm_tpu.core.rng import key_for_seed
from chiaswarm_tpu.models.clip import ClipTextEncoder as JaxText
from chiaswarm_tpu.models.configs import FAMILIES as JAX_FAMILIES
from chiaswarm_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from chiaswarm_tpu.models.unet import UNet as JaxUNet
from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE
from chiaswarm_tpu.node import job_args as jjob_args
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu.pipelines import video as jvideo
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.workloads import video as jwork
from chiaswarm_tpu_torch.models.clip import ClipTextEncoder
from chiaswarm_tpu_torch.models.configs import FAMILIES
from chiaswarm_tpu_torch.models.unet import UNet
from chiaswarm_tpu_torch.models.vae import AutoencoderKL
from chiaswarm_tpu_torch.node import job_args as tjob_args
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines import video as tvideo
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.workloads import video as twork
from tests.test_torch_video import _seeded, np_state, tiny_components


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
    """No safety checker on this node, in either package."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))


def _smooth(seed: int, hw: tuple[int, int]) -> np.ndarray:
    """A smooth uint8 picture (so a VAE round trip keeps its structure)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 255, (4, 4, 3)).astype(np.uint8)
    from PIL import Image

    return np.asarray(Image.fromarray(small).resize((hw[1], hw[0]),
                                                    Image.BILINEAR))


def _draw(key, shape) -> np.ndarray:
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _within_one_level(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert got.std() > 1.0


# ---------------------------------------------------------------------------
# 1. the pipelines against JAX


def test_txt2vid_pipeline_matches_jax():
    jc, tc = tiny_components("tiny_vid", seed=1)
    kw = dict(negative_prompt="blurry", num_frames=5, steps=2,
              guidance_scale=9.0, seed=3)
    want, want_cfg = jvideo.VideoPipeline(jc)("a lighthouse", **kw)
    # JAX's _build_fn: key, nkey = split(key); normal(nkey, (1, F, h, w, C))
    _, nkey = jax.random.split(key_for_seed(3))
    noise = _draw(nkey, (1, 8, 32, 32, 4))
    got, got_cfg = tvideo.VideoPipeline(tc)("a lighthouse", **kw,
                                            init_noise=noise)
    assert got.shape == (5, 64, 64, 3)
    _within_one_level(got, np.asarray(want))
    assert got_cfg == want_cfg
    assert got_cfg["scheduler"] == "dpmpp_2m"
    # the frames move: a clip, not one picture repeated
    assert np.abs(got[0].astype(int) - got[-1].astype(int)).mean() > 0.5


def test_img2vid_pipeline_matches_jax():
    jc, tc = tiny_components("tiny_svd", seed=2)
    image = _smooth(5, (40, 56))
    kw = dict(num_frames=5, steps=2, seed=3, fps=6, motion_bucket_id=100,
              noise_aug_strength=0.05, min_guidance_scale=1.0,
              max_guidance_scale=3.0)
    want, want_cfg = jvideo.Img2VidPipeline(jc)(image, **kw)
    # JAX's _build_fn: key, akey, nkey = split(key, 3)
    _, akey, nkey = jax.random.split(key_for_seed(3), 3)
    aug = _draw(akey, (1, 64, 64, 3))
    noise = _draw(nkey, (1, 8, 32, 32, 4))
    got, got_cfg = tvideo.Img2VidPipeline(tc)(image, **kw, init_noise=noise,
                                              aug_noise=aug)
    assert got.shape == (5, 64, 64, 3)
    _within_one_level(got, np.asarray(want))
    assert got_cfg == want_cfg
    assert got_cfg["scheduler"] == "euler"


def test_clip_preprocessing_matches_jax():
    """The image tower's input, the published CLIPImageProcessor recipe,
    exactly JAX's (JAX computes it inline in ``__call__``)."""
    from PIL import Image

    for hw in ((40, 56), (300, 90), (28, 28)):
        image = _smooth(hw[0], hw)
        got = tvideo.clip_image_input(image, 28)
        pil = Image.fromarray(image)
        w0, h0 = pil.size
        scale = 28 / min(w0, h0)
        rw, rh = max(28, round(w0 * scale)), max(28, round(h0 * scale))
        x0, y0 = (rw - 28) // 2, (rh - 28) // 2
        want = np.asarray(pil.resize((rw, rh), Image.BICUBIC).crop(
            (x0, y0, x0 + 28, y0 + 28)), np.float32) / 255.0
        mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
        std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
        np.testing.assert_array_equal(got, (want - mean) / std)


@pytest.mark.parametrize("req,compiled", [((64, 64), (64, 64)),
                                          ((100, 180), (128, 192)),
                                          ((70, 200), (128, 256))])
def test_unbucket_frames_matches_jax(req, compiled):
    frames = np.random.default_rng(req[0]).integers(
        0, 256, (3, *compiled, 3), dtype=np.uint8)
    got = tvideo._unbucket_frames(frames, *req, *compiled)
    want = jvideo._unbucket_frames(frames, *req, *compiled)
    assert got.shape == (3, *req, 3)
    np.testing.assert_array_equal(got, want)


def test_frame_buckets_and_families_match_jax():
    for name in ("modelscope_t2v", "svd_img2vid", "tiny_vid", "tiny_svd"):
        fam = tvideo.VIDEO_FAMILIES[name]
        assert fam.max_frames == jvideo.VIDEO_FAMILIES[name].max_frames
        for n in (1, 5, 8, 14, 25, 40, 80):
            assert tvideo._clip_frames(fam, n)[1] == min(
                (min(n, fam.max_frames) + 7) // 8 * 8, fam.max_frames)
    for model in ("stabilityai/stable-video-diffusion-img2vid", "my-svd",
                  "damo-vilab/text-to-video-ms-1.7b", "tiny_svd", "x/tiny_vid",
                  "anything"):
        assert tvideo.get_video_family(model).name == \
            jvideo.get_video_family(model).name


# ---------------------------------------------------------------------------
# 2. vid2vid: per-frame img2img on SD


@pytest.fixture(scope="module")
def sd_pipes():
    return tiny_sd_pipes()


def tiny_sd_pipes() -> tuple[jdiff.DiffusionPipeline,
                             tdiff.DiffusionPipeline]:
    """(JAX, port) tiny SD pipelines over one set of weights, JAX's params
    through its own converters from the port's seeded modules."""
    fam = FAMILIES["tiny"]
    text = _seeded(ClipTextEncoder(fam.text_encoders[0]), 11)
    unet = _seeded(UNet(fam.unet), 12)
    vae = _seeded(AutoencoderKL(fam.vae), 13)
    params = {"text_encoder_0": convert_text_encoder(np_state(text)),
              "unet": convert_unet(np_state(unet), fam.unet),
              "vae": convert_vae(np_state(vae), fam.vae)}
    jfam = JAX_FAMILIES["tiny"]
    te = jfam.text_encoders[0]
    jc = JaxComponents(
        family=jfam, model_name="tiny",
        tokenizers=[JaxHashTokenizer(te.vocab_size,
                                     te.max_position_embeddings,
                                     te.eos_token_id)],
        text_encoders=[JaxText(te)], unet=JaxUNet(jfam.unet),
        vae=JaxVAE(jfam.vae), params=params)
    return (jdiff.DiffusionPipeline(jc), tdiff.DiffusionPipeline(
        Components.from_jax(params, "tiny", device="cpu",
                            model_name="tiny")))


@contextlib.contextmanager
def _pinned_jax_normal(noise: np.ndarray):
    """Every ``jax.random.normal`` the JAX modules trace returns ``noise``
    (broadcast to the draw's shape); executables traced under the patch are
    dropped before and after."""
    real = jax.random.normal

    def pinned(key, shape=(), dtype=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(noise, dtype), shape)

    GLOBAL_CACHE.flush_executables()
    jax.random.normal = pinned
    try:
        yield
    finally:
        jax.random.normal = real
        GLOBAL_CACHE.flush_executables()


class _Registry:
    def __init__(self, pipe) -> None:
        self.pipe = pipe

    def pipeline(self, name, mesh=None, **_):
        return self.pipe


def _recorded(monkeypatch, module) -> list:
    """The frames each ``_video_artifacts`` call of ``module`` packs."""
    seen = []
    real = module._video_artifacts

    def record(frames, fps, content_type):
        seen.append(np.stack(frames))
        return real(frames, fps, content_type)

    monkeypatch.setattr(module, "_video_artifacts", record)
    return seen


def test_vid2vid_callback_matches_jax(sd_pipes, monkeypatch):
    j_pipe, t_pipe = sd_pipes
    noise = np.random.default_rng(12).standard_normal(
        (32, 32, 4)).astype(np.float32)

    def pinned(generators, shape, device="cpu"):
        one = torch.from_numpy(noise).permute(2, 0, 1)
        assert tuple(one.shape) == tuple(shape)
        return torch.stack([one] * len(generators)).to(device)

    monkeypatch.setattr(tdiff, "randn_rows", pinned)
    for module in (twork, jwork):
        monkeypatch.setattr(module, "FRAME_CHUNK", 2)
    t_frames, j_frames = _recorded(monkeypatch, twork), _recorded(
        monkeypatch, jwork)
    frames = [_smooth(20 + i, (64, 64)) for i in range(3)]
    kw = dict(seed=5, prompt="a watercolor", negative_prompt="blurry",
              num_inference_steps=4, guidance_scale=7.5,
              image_guidance_scale=3.0, frames=frames, fps=12.0)
    with _pinned_jax_normal(noise):
        want, want_cfg = jwork.vid2vid_callback(
            None, "tiny", registry=_Registry(j_pipe), **kw)
    got, got_cfg = twork.vid2vid_callback(None, "tiny",
                                          registry=_Registry(t_pipe), **kw)
    assert got_cfg == want_cfg
    assert got_cfg["frames"] == 3 and got_cfg["fps"] == 12.0
    assert got_cfg["compute_cost"] == 512 * 512 * 4 * 3
    assert set(got) == set(want) == {"primary", "thumbnail"}
    assert got["primary"]["content_type"] == "video/mp4"
    _within_one_level(t_frames[0], j_frames[0])


def test_each_frame_is_its_own_encode(sd_pipes):
    """vid2vid's per-row init stack: two different frames give different
    init latents, the same frame twice the same latent only where the
    posterior draw is the same (its row's stream), and a one-frame stack is
    the one-image path bit for bit."""
    _, pipe = sd_pipes
    a, b = _smooth(30, (64, 64)), _smooth(31, (64, 64))
    stack = pipe.encode_init_rows(np.stack([a, b, a]), 64, 64, seed=7, rows=4)
    assert stack.shape == (4, 4, 32, 32)
    assert not torch.equal(stack[0], stack[1])
    assert not torch.equal(stack[0], stack[2])  # row 2's own posterior
    assert torch.equal(stack[3], stack[2])      # bucket padding: the last
    one = pipe.encode_init_rows(a[None], 64, 64, seed=7, rows=1)
    assert torch.equal(one, pipe.encode_init_image(a, 64, 64, seed=7))
    req = dict(prompt="p", steps=3, height=64, width=64, seed=7,
               strength=0.6)
    single, _ = pipe(tdiff.GenerateRequest(init_image=a, **req))
    stacked, _ = pipe(tdiff.GenerateRequest(init_image=a[None], **req))
    np.testing.assert_array_equal(single, stacked)


# ---------------------------------------------------------------------------
# 3. the clip on the host: read, write, fetch


def _write_clip(path: Path, n: int, hw: tuple[int, int], fps: float) -> None:
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (hw[1], hw[0]))
    assert writer.isOpened()
    for i in range(n):
        writer.write(cv2.cvtColor(_smooth(40 + i, hw), cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory) -> Path:
    # 60 fps: subsampled every 2nd frame; 600 px high: resized to 512
    path = tmp_path_factory.mktemp("clip") / "clip.mp4"
    _write_clip(path, 9, (600, 360), 60.0)
    return path


def test_read_frames_matches_jax(clip_file):
    got, got_fps = twork._read_frames(str(clip_file))
    want, want_fps = jwork._read_frames(str(clip_file))
    assert got_fps == want_fps == 30.0
    assert len(got) == len(want) == 5
    assert got[0].shape == (512, 306, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("content_type", ["video/mp4", "video/webm"])
def test_write_video_matches_jax(content_type, tmp_path):
    frames = [_smooth(50 + i, (64, 96)) for i in range(4)]
    outcomes = []
    for module in (twork, jwork):
        try:
            blob = module._write_video(frames, 8.0, content_type)
        except ValueError as exc:
            outcomes.append(("refused", str(exc)))
            continue
        path = tmp_path / f"{module.__name__}.bin"
        path.write_bytes(blob)
        read, fps = module._read_frames(str(path))
        outcomes.append(("clip", fps, len(read), read[0].shape,
                         np.stack(read).tobytes()))
    assert outcomes[0] == outcomes[1]
    if content_type == "video/mp4":
        assert outcomes[0][:4] == ("clip", 8.0, 4, (64, 96, 3))
    else:
        assert outcomes[0][0] == "clip" or "cannot encode" in outcomes[0][1]


class _Assets(BaseHTTPRequestHandler):
    files: dict[str, tuple[bytes, str]] = {}

    def log_message(self, *args) -> None:
        pass

    def _head(self) -> bytes | None:
        entry = self.files.get(self.path.lstrip("/"))
        if entry is None:
            self.send_response(404)
            self.end_headers()
            return None
        body, content_type = entry
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        return body

    def do_HEAD(self) -> None:
        self._head()

    def do_GET(self) -> None:
        body = self._head()
        if body is not None:
            self.wfile.write(body)


@pytest.fixture(scope="module")
def assets(clip_file):
    import io

    from PIL import Image

    png = io.BytesIO()
    Image.fromarray(_smooth(60, (48, 80))).save(png, format="PNG")
    _Assets.files = {"clip.mp4": (clip_file.read_bytes(), "video/mp4"),
                     "image.png": (png.getvalue(), "image/png")}
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Assets)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def test_the_clip_fetch_matches_jax(assets, clip_file, monkeypatch):
    assert twork.MAX_VIDEO_BYTES == jwork.MAX_VIDEO_BYTES == 30 * 1048576
    for module in (twork, jwork):
        path = module._download_video(f"{assets}/clip.mp4")
        try:
            assert Path(path).read_bytes() == clip_file.read_bytes()
        finally:
            Path(path).unlink()
    messages = []
    for module in (twork, jwork):
        monkeypatch.setattr(module, "MAX_VIDEO_BYTES", 1000)
        with pytest.raises(ValueError, match="Input video too large") as info:
            module._download_video(f"{assets}/clip.mp4")
        messages.append(str(info.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# 4. the routing


def _video_job(workflow: str, assets: str) -> dict:
    job = {"workflow": workflow, "seed": 3, "prompt": "a lighthouse",
           "negative_prompt": "blurry", "num_images_per_prompt": 2,
           "content_type": "video/mp4", "fps": 10,
           "parameters": {"scheduler_type": "EulerDiscreteScheduler",
                          "unsupported_pipeline_arguments": ["fps"]}}
    if workflow == "txt2vid":
        job["model_name"] = "damo-vilab/text-to-video-ms-1.7b"
    elif workflow == "img2vid":
        job.update(model_name="stabilityai/stable-video-diffusion-img2vid",
                   start_image_uri=f"{assets}/image.png")
    else:
        job.update(model_name="runwayml/stable-diffusion-v1-5",
                   video_uri=f"{assets}/clip.mp4", strength=0.5)
    return job


@pytest.mark.parametrize("workflow", ["txt2vid", "img2vid", "vid2vid"])
def test_video_routing_matches_jax(workflow, assets):
    got_cb, got = tjob_args.format_args(_video_job(workflow, assets),
                                        registry=None)
    want_cb, want = jjob_args.format_args(_video_job(workflow, assets),
                                          registry=None)
    assert got_cb.__name__ == want_cb.__name__ == f"{workflow}_callback"
    assert got_cb.__module__ == "chiaswarm_tpu_torch.workloads.video"
    image = got.pop("image", None), want.pop("image", None)
    assert (image[0] is None) == (image[1] is None) == (workflow != "img2vid")
    if image[0] is not None:
        np.testing.assert_array_equal(image[0], image[1])
    assert got == want
    if workflow == "txt2vid":
        assert got["num_inference_steps"] == 25
        assert "num_images_per_prompt" not in got and "fps" not in got
    if workflow == "img2vid":
        assert "prompt" not in got
        assert got["scheduler_type"] == "EulerDiscreteScheduler"
