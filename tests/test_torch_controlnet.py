"""The port's ControlNet slice on ``tiny`` (and ``tiny_xl`` for the modules)
at 64 px, against the JAX package. Every ControlNet here has its zero convs
(the hint encoder's ``conv_out``, every ``controlnet_*`` conv) drawn from a
seed at a small scale: a fresh one is a no-op and would prove nothing.

- The modules: ``ControlCondEmbedding`` and ``ControlNet`` against JAX's,
  loaded by JAX's ``convert_controlnet`` from the port's diffusers-layout
  state dict, at 2e-4 in float32, and the UNet's eps with the residuals in;
  the port's own loader on that state dict written to disk.
- The solo pipeline against JAX's ``DiffusionPipeline`` with a
  ``ControlNetBundle``: CFG, scales 0.5 and 1.0, a conditioning image of
  another size resized onto the bucket, the initial noise injected; within
  one uint8 level, configs equal. The scale-0 gate: bit for bit the
  txt2img image. The conditioning image's normalisation exactly JAX's. The
  hint embedded once per job.
- The lanes: one control lane step against JAX's
  ``stepper_step_fn(has_control=True)``; a control job in a lane against
  its solo run (the lane bars); two bundles make two lanes; rows of one
  bundle at different scales share one lane; a condemned control lane
  resumes bit for bit.
- The registry, the routing of ``parameters.controlnet`` against JAX's, the
  envelopes (stamps and the ``preprocessed_input`` echo) against the JAX
  executor's, the refusals, and the preprocessing modes against JAX's and
  ``cv2.Canny`` (the detector modes in ``tests/test_torch_preprocessors.py``).
"""

from __future__ import annotations

import copy
import io
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.convert.torch_to_flax import convert_controlnet
from chiaswarm_tpu.models.configs import FAMILIES as JFAMILIES
from chiaswarm_tpu.models.controlnet import ControlCondEmbedding as JaxEmbed
from chiaswarm_tpu.models.controlnet import ControlNet as JaxControlNet
from chiaswarm_tpu.models.unet import UNet as JaxUNet
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu.pipelines.components import Components as JaxComponents
from chiaswarm_tpu.pipelines.components import (
    ControlNetBundle as JaxBundle,
)
from chiaswarm_tpu.schedulers import sampling as jsampling
from chiaswarm_tpu.serving import guard as jguard
from chiaswarm_tpu.workloads import controlnet as jcontrol
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from chiaswarm_tpu_torch.pipelines.components import (
    Components,
    ControlNetBundle,
)
from chiaswarm_tpu_torch.schedulers import sampling as tsampling
from chiaswarm_tpu_torch.serving import guard as tguard
from chiaswarm_tpu_torch.serving import stepper as tstepper
from chiaswarm_tpu_torch.serving.residency import _Entry
from chiaswarm_tpu_torch.serving.stepper import (
    LaneReject,
    StepScheduler,
    get_stepper,
)
from chiaswarm_tpu_torch.workloads import controlnet as tcontrol
from chiaswarm_tpu_torch.workloads import diffusion as tworkload

SIZE = 64
CN = "test/controlnet"
LANE_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for the tiny models (the suite's workers share
    the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))


def _perturbed(family: str, seed: int = 1,
               name: str = CN) -> ControlNetBundle:
    """A seeded bundle whose zero convs are seeded too (std 0.05)."""
    bundle = ControlNetBundle.random(family, seed=seed, device="cpu",
                                     model_name=name)
    gen = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for conv in (bundle.embed.conv_out, bundle.net.controlnet_mid_block,
                     *bundle.net.controlnet_down_blocks):
            conv.weight.normal_(0.0, 0.05, generator=gen)
            conv.bias.normal_(0.0, 0.05, generator=gen)
    return bundle


def _jax_twin(bundle: ControlNetBundle) -> JaxBundle:
    """JAX's bundle over the port bundle's weights, through JAX's own name
    rules on the diffusers-layout state dict."""
    fam = JFAMILIES[bundle.family.name]
    state = {k: v.float().numpy() for k, v in bundle.state_dict().items()}
    return JaxBundle(family=fam, model_name=bundle.model_name,
                     params=convert_controlnet(state, fam.unet))


@pytest.fixture(scope="module")
def pipes():
    """(JAX, port) tiny pipelines over the same weights."""
    jp = jdiff.DiffusionPipeline(JaxComponents.random("tiny", seed=0))
    tp = tdiff.DiffusionPipeline(Components.from_jax(
        jax.tree.map(np.asarray, jp.c.params), "tiny", device="cpu"))
    return jp, tp


@pytest.fixture(scope="module")
def bundles():
    """(port, JAX) tiny ControlNets over the same weights."""
    port = _perturbed("tiny")
    return port, _jax_twin(port)


def _cond_image(seed: int = 7, hw=(48, 80)) -> np.ndarray:
    """A smooth seeded picture (edges for Canny, structure for the hint)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((hw[1], hw[0]),
                                                    Image.BICUBIC))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close_to(got: np.ndarray, want: np.ndarray, bar: float = 2e-4) -> None:
    err = np.abs(got - want).max()
    assert err <= bar * max(1.0, np.abs(want).max()), (err,
                                                       np.abs(want).max())


# ---------------------------------------------------------------------------
# 1. the modules


@pytest.mark.parametrize("family", ["tiny", "tiny_xl"])
def test_controlnet_modules_match_jax(family):
    bundle = _perturbed(family)
    twin = _jax_twin(bundle)
    fam, jfam = bundle.family, JFAMILIES[family]
    f = fam.vae.downscale
    lh = SIZE // f
    rng = np.random.default_rng(2)
    cond = rng.random((2, SIZE, SIZE, 3)).astype(np.float32)
    sample = rng.standard_normal((2, lh, lh, 4)).astype(np.float32)
    t = np.array([901.0, 250.5], np.float32)
    ctx = rng.standard_normal(
        (2, 77, fam.unet.cross_attention_dim)).astype(np.float32)
    added = None
    if fam.unet.addition_embed_dim is not None:
        added = {"time_ids": np.tile(np.array(
                     [[SIZE, SIZE, 0, 0, SIZE, SIZE]], np.float32), (2, 1)),
                 "text_embeds": rng.standard_normal(
                     (2, fam.unet.addition_pooled_dim)).astype(np.float32)}
    scale = 0.7
    j_emb = JaxEmbed(jfam.unet.block_out_channels[0], downscale=f).apply(
        twin.params["embed"], cond)
    j_down, j_mid = JaxControlNet(jfam.unet).apply(
        twin.params["net"], sample, t, ctx, j_emb, added, scale)
    t_added = None if added is None else {k: torch.from_numpy(v)
                                          for k, v in added.items()}
    with torch.no_grad():
        t_emb = bundle.embed(_nchw(cond))
        t_down, t_mid = bundle.net(_nchw(sample), torch.from_numpy(t),
                                   torch.from_numpy(ctx), t_emb, t_added,
                                   scale)
    _close_to(_nhwc(t_emb), np.asarray(j_emb))
    assert np.abs(np.asarray(j_emb)).mean() > 1e-3
    assert len(t_down) == len(j_down)
    for got, want in zip(t_down, j_down):
        assert got.dtype == torch.float32
        _close_to(_nhwc(got), np.asarray(want))
    _close_to(_nhwc(t_mid), np.asarray(j_mid))
    assert np.abs(np.asarray(j_mid)).mean() > 1e-3

    # the UNet takes them: JAX's residuals into both UNets
    jc = JaxComponents.random(family, seed=0)
    unet = Components.from_jax(jax.tree.map(np.asarray, jc.params), family,
                               device="cpu").unet
    j_eps = JaxUNet(jfam.unet).apply(jc.params["unet"], sample, t, ctx,
                                     added, j_down, j_mid)
    j_plain = JaxUNet(jfam.unet).apply(jc.params["unet"], sample, t, ctx,
                                       added)
    with torch.no_grad():
        t_eps = unet(_nchw(sample), torch.from_numpy(t),
                     torch.from_numpy(ctx), t_added,
                     tuple(_nchw(np.asarray(r)) for r in j_down),
                     _nchw(np.asarray(j_mid)))
    _close_to(_nhwc(t_eps), np.asarray(j_eps))
    assert np.abs(np.asarray(j_eps) - np.asarray(j_plain)).max() > 1e-2


def test_the_loader_reads_a_diffusers_controlnet_as_jax_does(tmp_path,
                                                             bundles):
    """The name rules: the port's ``from_checkpoint`` and JAX's
    ``ControlNetBundle.from_checkpoint`` on one directory."""
    bundle, _ = bundles
    target = tmp_path / "cn" / "controlnet"  # a pipeline snapshot's layout
    target.mkdir(parents=True)
    save_file(bundle.state_dict(),
              target / "diffusion_pytorch_model.safetensors")
    loaded = ControlNetBundle.from_checkpoint(tmp_path / "cn", CN, "tiny",
                                              device="cpu")
    for key, value in bundle.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    jloaded = JaxBundle.from_checkpoint(tmp_path / "cn", CN,
                                        JFAMILIES["tiny"])
    cond = np.random.default_rng(3).random((1, SIZE, SIZE, 3),
                                           dtype=np.float32)
    j_emb = JaxEmbed(32, downscale=2).apply(jloaded.params["embed"], cond)
    with torch.no_grad():
        _close_to(_nhwc(loaded.embed(_nchw(cond))), np.asarray(j_emb))
    assert loaded.param_bytes() == bundle.param_bytes()


# ---------------------------------------------------------------------------
# 2. the solo pipeline


def _control_req(cls, bundle, scale: float, **over):
    noise = np.random.default_rng(12).standard_normal(
        (1, SIZE // 2, SIZE // 2, 4)).astype(np.float32)
    kw = dict(prompt="a lighthouse at dusk", negative_prompt="blurry",
              steps=4, guidance_scale=7.5, height=SIZE, width=SIZE, seed=3,
              init_noise=noise, controlnet=bundle,
              control_image=_cond_image(), control_scale=scale)
    kw.update(over)
    return cls(**kw)


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_solo_control_pipeline_matches_jax(pipes, bundles, scale,
                                           monkeypatch):
    jp, tp = pipes
    bundle, twin = bundles
    calls = []
    real = bundle.embed.forward
    monkeypatch.setattr(bundle.embed, "forward",
                        lambda x: calls.append(x.shape) or real(x))
    j_img, j_cfg = jp(_control_req(jdiff.GenerateRequest, twin, scale))
    t_img, t_cfg = tp(_control_req(tdiff.GenerateRequest, bundle, scale))
    j_img = np.asarray(j_img)
    assert t_img.shape == j_img.shape == (1, SIZE, SIZE, 3)
    diff = np.abs(t_img.astype(np.int16) - j_img.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    assert t_cfg == j_cfg
    assert t_cfg["controlnet"] == CN and t_cfg["controlnet_scale"] == scale
    assert calls == [(1, 3, SIZE, SIZE)]  # the hint, once per job
    plain, _ = tp(_control_req(tdiff.GenerateRequest, None, scale,
                               control_image=None))
    assert np.abs(t_img.astype(int) - plain.astype(int)).max() > 3


def test_scale_zero_is_the_txt2img_image_bit_for_bit(pipes, bundles):
    _, tp = pipes
    bundle, _ = bundles
    zero, cfg = tp(_control_req(tdiff.GenerateRequest, bundle, 0.0))
    plain, _ = tp(_control_req(tdiff.GenerateRequest, None, 0.0,
                               control_image=None))
    assert np.array_equal(zero, plain)
    assert cfg["controlnet_scale"] == 0.0


def _jax_normalised(image: np.ndarray) -> np.ndarray:
    """JAX ``submit``'s conditioning-image preparation (:1040-1048)."""
    cond = np.asarray(image)
    if cond.shape[:2] != (SIZE, SIZE):
        cond = jdiff._resize_batch(cond, SIZE, SIZE)
    cond = np.asarray(cond, np.float32)
    if image.dtype == np.uint8 or cond.max() > 1.0:
        cond = cond / 255.0
    return np.clip(cond, 0.0, 1.0)


@pytest.mark.parametrize("kind", ["uint8_other_size", "uint8", "float01",
                                  "float255", "float_other_size"])
def test_the_conditioning_image_is_prepared_as_jax_prepares_it(
        pipes, bundles, kind, monkeypatch):
    _, tp = pipes
    bundle, _ = bundles
    base = _cond_image(hw=(48, 80) if "other" in kind else (SIZE, SIZE))
    image = {"uint8_other_size": base, "uint8": base,
             "float01": base.astype(np.float32) / 255.0,
             "float255": base.astype(np.float32),
             "float_other_size": base.astype(np.float32) / 255.0}[kind]
    seen = []
    real = bundle.embed.forward
    monkeypatch.setattr(bundle.embed, "forward",
                        lambda x: seen.append(x.clone()) or real(x))
    tp.stepper_control_embed(bundle, image, SIZE, SIZE)
    np.testing.assert_array_equal(_nhwc(seen[0])[0], _jax_normalised(image))


def test_controlnet_refusals_match_jax(pipes, bundles):
    jp, tp = pipes
    bundle, twin = bundles
    for pipe, cls, b in ((jp, jdiff.GenerateRequest, twin),
                         (tp, tdiff.GenerateRequest, bundle)):
        with pytest.raises(ValueError, match="requires a conditioning image"):
            pipe(_control_req(cls, b, 1.0, control_image=None))
    with pytest.raises(LaneReject, match="exactly a conditioning image"):
        StepScheduler().submit_request(
            tp, prompt="p", steps=2, height=SIZE, width=SIZE,
            controlnet=bundle, control_image=_cond_image(),
            init_image=_cond_image(hw=(SIZE, SIZE)))


# ---------------------------------------------------------------------------
# 3. the lanes


def test_control_lane_step_matches_jax(pipes, bundles):
    from chiaswarm_tpu.core.rng import key_for_seed

    jp, tp = pipes
    bundle, twin = bundles
    cap, w, lh = 8, 4, SIZE // 2
    jcfg = jsampling.resolve(None)
    sched = jsampling.make_sampling_schedule(jp.noise_schedule, cap, jcfg)
    sig = np.tile(np.asarray(sched.sigmas, np.float32)[None], (w, 1))
    ts = np.tile(np.asarray(sched.timesteps, np.float32)[None], (w, 1))
    rng = np.random.default_rng(11)
    x, old = (rng.standard_normal((w, lh, lh, 4)).astype(np.float32)
              for _ in range(2))
    ctx_u, ctx_c = (rng.standard_normal((w, 77, 32)).astype(np.float32)
                    for _ in range(2))
    hint = (0.3 * rng.standard_normal((w, lh, lh, 32))).astype(np.float32)
    idx = np.array([0, 3, 5, 2], np.int32)
    start = np.zeros(w, np.int32)
    guidance = np.array([7.5, 5.0, 9.0, 7.5], np.float32)
    cscale = np.array([1.0, 0.5, 0.0, 1.0], np.float32)
    active = np.array([True, True, True, False])
    fn = jp.stepper_step_fn(batch=w, height=SIZE, width=SIZE, steps_cap=cap,
                            sampler=jcfg, has_control=True)
    keys = jnp.stack([jax.random.fold_in(key_for_seed(0), r)
                      for r in range(w)])
    placeholder = jnp.zeros((1,), jnp.float32)
    j_x, _, j_idx, _ = fn(
        jp.c.params, jnp.asarray(ctx_u), jnp.asarray(ctx_c), placeholder,
        placeholder, jnp.asarray(x), keys, jnp.asarray(idx),
        jnp.asarray(start), jnp.asarray(sig), jnp.asarray(ts),
        jnp.asarray(guidance), jnp.asarray(old), jnp.asarray(active),
        jnp.zeros_like(jnp.asarray(x)), jnp.ones((w, lh, lh, 1)),
        jnp.zeros(w, bool), twin.params, jnp.asarray(hint),
        jnp.asarray(cscale))
    t_x, t_idx, _ = tp.stepper_step(
        sampler=tsampling.resolve(None), ctx_u=torch.from_numpy(ctx_u),
        ctx_c=torch.from_numpy(ctx_c), x=_nchw(x),
        idx=torch.from_numpy(idx).long(), start_idx=torch.from_numpy(start)
        .long(), sigmas=torch.from_numpy(sig), timesteps=torch.from_numpy(ts),
        guidance=torch.from_numpy(guidance), old_denoised=_nchw(old),
        active=torch.from_numpy(active), generators=[None] * w,
        control=bundle, cond=_nchw(hint), cscale=torch.from_numpy(cscale))
    assert t_idx.tolist() == np.asarray(j_idx).tolist() == [1, 4, 6, 2]
    torch.testing.assert_close(t_x, _nchw(np.asarray(j_x)), atol=2e-4,
                               rtol=0)
    assert torch.equal(t_x[3], _nchw(x)[3])


def _lane_close(lane_img: np.ndarray, solo_img: np.ndarray) -> None:
    # other batch shapes: agreement to uint8 quantization, not bits
    diff = np.abs(lane_img.astype(int) - solo_img.astype(int))
    assert diff.max() <= 3 and (diff <= 1).mean() > 0.99, (
        diff.max(), (diff <= 1).mean())


def _solo(tp, bundle, seed: int, scale: float) -> np.ndarray:
    img, _ = tp(tdiff.GenerateRequest(
        prompt=f"job {seed}", steps=4, guidance_scale=7.5, height=SIZE,
        width=SIZE, seed=seed, controlnet=bundle, control_image=_cond_image(
            seed), control_scale=scale))
    return img


def _lane(sched, tp, bundle, seed: int, scale: float):
    return sched.submit_request(
        tp, prompt=f"job {seed}", steps=4, guidance_scale=7.5, height=SIZE,
        width=SIZE, seed=seed, controlnet=bundle,
        control_image=_cond_image(seed), control_scale=scale)


def test_control_rows_share_a_lane_per_bundle(pipes, bundles):
    """Two jobs of one bundle at scales 1.0 and 0.3 share one lane, a third
    job of another bundle opens its own; each image is its solo run's
    within the lane bars."""
    _, tp = pipes
    bundle, _ = bundles
    other = _perturbed("tiny", seed=2, name="test/controlnet-b")
    sched = StepScheduler()
    try:
        futures = [_lane(sched, tp, bundle, 21, 1.0),
                   _lane(sched, tp, bundle, 22, 0.3),
                   _lane(sched, tp, other, 23, 1.0)]
        results = [f.result(timeout=LANE_TIMEOUT) for f in futures]
        stats = sched.stats()
    finally:
        sched.shutdown()
    lanes = [info["lane"] for _, info in results]
    assert lanes[0] == lanes[1] != lanes[2]
    assert stats["rows_admitted_controlnet"] == 3
    for (pending, _), (seed, b, scale) in zip(
            results, [(21, bundle, 1.0), (22, bundle, 0.3),
                      (23, other, 1.0)]):
        _lane_close(pending.wait(), _solo(tp, b, seed, scale))


def test_a_condemned_control_lane_resumes_bit_for_bit(pipes, bundles,
                                                      monkeypatch):
    """The guard's chaos seam wedges the control lane at step 3; the job
    resumes from its step-2 checkpoint (its hint embedded again from its
    image) in a fresh lane, bit for bit its uninterrupted run. The wedge
    outlasts four uninterrupted runs, so a loaded host's slow steps (the
    hang budget is 3x the step EWMA) cannot hide it."""
    _, tp = pipes
    bundle, _ = bundles
    for name in (tguard.ENV_CHAOS_WEDGE, tguard.ENV_ENABLE):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(tstepper.ENV_CKPT_EVERY, "2")
    for guard in (tguard, jguard):
        guard.reset_chaos()
    sched = StepScheduler()
    t0 = time.perf_counter()
    try:
        ref, _ = _lane(sched, tp, bundle, 31, 0.8).result(
            timeout=LANE_TIMEOUT)
        ref = ref.wait()
    finally:
        sched.shutdown()
    wedge_s = max(4.0, 4 * (time.perf_counter() - t0))
    monkeypatch.setenv(tguard.ENV_HANG_FACTOR, "3")
    monkeypatch.setenv(tguard.ENV_HANG_FLOOR, "1")
    monkeypatch.setenv(tguard.ENV_CHAOS_WEDGE, f"3:{wedge_s:.1f}")
    tguard.reset_chaos()
    sched = StepScheduler()
    try:
        with pytest.raises(tguard.LaneHung) as excinfo:
            _lane(sched, tp, bundle, 31, 0.8).result(timeout=LANE_TIMEOUT)
        resume = excinfo.value.resume
        monkeypatch.delenv(tguard.ENV_CHAOS_WEDGE)
        pending, info = sched.submit_request(
            tp, prompt="job 31", steps=4, guidance_scale=7.5, height=SIZE,
            width=SIZE, seed=31, controlnet=bundle,
            control_image=_cond_image(31), control_scale=0.8,
            resume=resume).result(timeout=LANE_TIMEOUT)
        stats = sched.stats()
    finally:
        sched.shutdown()
        tguard.reset_chaos()
    assert resume["workload"] == "controlnet" and int(resume["step"]) == 2
    assert info["resume_step"] == 2
    assert stats["lanes_condemned"] == 1 and stats["rows_resumed"] == 1
    assert np.array_equal(pending.wait(), ref)


def test_evicting_a_bundle_retires_its_lanes(pipes, bundles):
    _, tp = pipes
    bundle, _ = bundles
    assert _Entry("k", CN, bundle, 1, 0, 0.0).owner_id == id(bundle)
    sched = StepScheduler()
    try:
        _lane(sched, tp, bundle, 41, 1.0).result(timeout=LANE_TIMEOUT)
        plain = sched.submit_request(tp, prompt="p", steps=2, height=SIZE,
                                     width=SIZE, seed=1)
        plain.result(timeout=LANE_TIMEOUT)
        assert sched.stats()["lanes_live"] == 2
        assert tstepper.retire_lanes_for_owner(id(bundle)) == 1
        assert sched.drain(10.0)
        deadline = time.monotonic() + 10
        while sched.stats()["lanes_live"] > 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert sched.stats()["lanes_live"] == 1
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# 4. the registry, the routing, the envelopes


def test_the_registry_loads_a_controlnet_directory_without_fallback(
        bundles):
    bundle, _ = bundles
    fam = bundle.family
    strict = ModelRegistry(catalog=[], device="cpu")
    with pytest.raises(ValueError, match="not available on this node"):
        strict.controlnet(CN, fam)
    target = model_dir(CN)
    target.mkdir(parents=True)
    save_file(bundle.state_dict(),
              target / "diffusion_pytorch_model.safetensors")
    loaded = strict.controlnet(CN, fam)
    assert loaded is strict.controlnet(CN, fam)  # resident
    for key, value in bundle.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    assert ("controlnet", CN, "tiny", False, "cpu") in \
        strict.residency._entries
    assert strict.model_states()[CN] == "resident"
    lenient = ModelRegistry(catalog=[], allow_random=True, device="cpu")
    fresh = lenient.controlnet("test/absent", fam)
    assert not fresh.net.controlnet_mid_block.weight.any()  # a fresh one


class _Assets(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def do_HEAD(self):
        self.do_GET()

    def do_GET(self):
        buf = io.BytesIO()
        Image.fromarray(_cond_image(5, (96, 64))).save(buf, format="PNG")
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)


@pytest.fixture(scope="module")
def asset_url():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Assets)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}/cond.png"
    server.shutdown()
    server.server_close()


def _hive_job(url: str, preprocess: bool, **control) -> dict:
    return {"id": "cn-job", "model_name": "tiny", "prompt": "a harbor",
            "num_inference_steps": 3, "seed": 8, "content_type": "image/png",
            "start_image_uri": url, "controlnet_scale": 0.6,
            "parameters": {"controlnet": {
                "controlnet_model_name": CN, "preprocess": preprocess,
                "type": "canny", "low_threshold": 60, "high_threshold": 140,
                **control}}}


@pytest.mark.parametrize("preprocess", [False, True])
def test_routing_matches_jax(asset_url, preprocess):
    from chiaswarm_tpu.node.job_args import format_args as jax_format
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu_torch.node.job_args import format_args

    job = _hive_job(asset_url, preprocess)
    _, kwargs = format_args(copy.deepcopy(job),
                            ModelRegistry(catalog=[], device="cpu"))
    _, j_kwargs = jax_format(copy.deepcopy(job),
                             JaxRegistry(catalog=[], allow_random=True))
    image, j_image = kwargs.pop("image"), j_kwargs.pop("image")
    np.testing.assert_array_equal(image, j_image)
    assert {k: v for k, v in kwargs.items() if k != "registry"} == \
        {k: v for k, v in j_kwargs.items() if k != "registry"}
    assert kwargs["controlnet_model_name"] == CN
    assert kwargs["save_preprocessed_input"] is preprocess
    assert image.shape == (96, 64, 3)
    edges = set(np.unique(image).tolist())
    assert (edges <= {0, 255}) is preprocess
    without = _hive_job(asset_url, preprocess)
    del without["parameters"]["controlnet"]["controlnet_model_name"]
    _, kwargs = format_args(without, ModelRegistry(catalog=[], device="cpu"))
    assert kwargs["controlnet_model_name"] == \
        "lllyasviel/control_v11p_sd15_canny"


def _png_size(blob: str) -> tuple[int, int]:
    import base64

    return Image.open(io.BytesIO(base64.b64decode(blob))).size


@pytest.mark.parametrize("lanes", ["0", "1"])
def test_envelopes_match_the_jax_executor(asset_url, monkeypatch, lanes):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.serving.stepper import get_stepper as jax_stepper

    monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
    job = _hive_job(asset_url, True)
    jax_slot = JaxPool(n_slots=1).slots[0]
    try:
        ref = jax_do_work(copy.deepcopy(job), jax_slot, JaxRegistry(
            catalog=[{"name": "tiny", "family": "tiny"}], allow_random=True))
    finally:
        jax_stepper(jax_slot).shutdown()
    slot = ChipPool(device="cpu").slots[0]
    try:
        got = executor.synchronous_do_work(copy.deepcopy(job), slot,
                                           ModelRegistry(
            catalog=[{"name": "tiny", "family": "tiny"}], allow_random=True,
            device="cpu"))
    finally:
        get_stepper(slot).shutdown()
    cfg, ref_cfg = got["pipeline_config"], ref["pipeline_config"]
    assert "error" not in cfg and "error" not in ref_cfg, (cfg, ref_cfg)
    assert set(cfg) == set(ref_cfg)
    assert ("stepper" in cfg) == (lanes == "1")
    for key in ("controlnet", "controlnet_scale", "mode", "nsfw",
                "safety_checker", "steps", "guidance_scale"):
        assert cfg[key] == ref_cfg[key], key
    # the size is the conditioning image's on both routes; JAX's lane
    # submit takes the family's default size (a known difference)
    assert cfg["size"] == [96, 64]
    assert ref_cfg["size"] == ([96, 64] if lanes == "0" else [SIZE, SIZE])
    assert cfg["controlnet"] == CN and cfg["controlnet_scale"] == 0.6
    # the echo: JAX's solo envelope carries it, JAX's lane finish drops it
    assert set(got["artifacts"]) == {"primary", "preprocessed_input"}
    assert ("preprocessed_input" in ref["artifacts"]) == (lanes == "0")
    assert _png_size(got["artifacts"]["primary"]["blob"]) == (64, 96)
    if lanes == "0":
        assert got["artifacts"]["preprocessed_input"]["blob"] == \
            ref["artifacts"]["preprocessed_input"]["blob"]


def test_a_control_job_with_a_mask_is_refused_as_in_jax():
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu.workloads.diffusion import (
        diffusion_callback as jax_callback,
    )

    kw = dict(seed=1, prompt="p", num_inference_steps=2,
              image=_cond_image(hw=(SIZE, SIZE)),
              mask_image=np.ones((SIZE, SIZE), np.float32),
              controlnet_model_name=CN)
    with pytest.raises(ValueError) as ours:
        tworkload.diffusion_callback(
            ChipPool(device="cpu").slots[0], "tiny", registry=ModelRegistry(
                catalog=[], allow_random=True, device="cpu"), **kw)
    with pytest.raises(ValueError) as theirs:
        jax_callback(JaxPool(n_slots=1).slots[0], "tiny",
                     registry=JaxRegistry(catalog=[], allow_random=True),
                     **kw)
    assert str(ours.value) == str(theirs.value)
    assert not tworkload.stepper_eligible(dict(kw, model_name="tiny"))
    kw.pop("mask_image")
    assert tworkload.stepper_eligible(dict(kw, model_name="tiny"))


# ---------------------------------------------------------------------------
# 5. preprocessing


@pytest.mark.parametrize("low,high", [(100, 200), (30, 90)])
def test_canny_is_cv2_canny_bit_for_bit_and_jax(low, high):
    image = Image.fromarray(_cond_image(9, (72, 88)))
    block = {"preprocess": True, "type": "canny", "low_threshold": low,
             "high_threshold": high}
    got = np.asarray(tcontrol.preprocess_image(image, block))
    want = cv2.Canny(np.asarray(image), low, high)
    assert got.shape == (72, 88, 3)
    for c in range(3):
        np.testing.assert_array_equal(got[..., c], want)
    np.testing.assert_array_equal(
        got, np.asarray(jcontrol.preprocess_image(image, block)))
    assert 0 < (want > 0).mean() < 0.5


@pytest.mark.parametrize("kind,hw", [("tile", (48, 80)), ("tile", (300, 90)),
                                     ("shuffle", (96, 70)),
                                     ("pix2pix", (40, 40)),
                                     ("canny", (64, 64))])
def test_model_free_modes_match_jax(kind, hw):
    image = Image.fromarray(_cond_image(4, hw))
    block = {"preprocess": True, "type": kind}
    got = tcontrol.preprocess_image(image, block)
    want = jcontrol.preprocess_image(image, block)
    assert got.size == want.size
    assert got.tobytes() == want.tobytes()


def test_preprocessing_is_off_unless_asked():
    image = Image.fromarray(_cond_image())
    for block in ({}, {"type": "depth"}, {"type": "canny",
                                          "preprocess": False}):
        assert tcontrol.preprocess_image(image, block) is image
        assert jcontrol.preprocess_image(image, block) is image


@pytest.mark.parametrize("kind", ("scribble", "softedge", "depth", "normal",
                                  "normalbae", "seg", "mlsd", "lineart",
                                  "openpose"))
def test_learned_modes_are_refused_naming_item_6(kind, monkeypatch):
    """Each learned mode is served (this test held their refusal until the
    detectors were ported): with no detector directory, the cv2 stand-in;
    openpose, which has none, by a detector in the cache. An unknown type
    is still refused."""
    from chiaswarm_tpu_torch.models.openpose import OpenposeDetector

    monkeypatch.setattr(tcontrol, "_DETECTORS", {})
    if kind == "openpose":
        tcontrol._DETECTORS[("openpose", "cpu")] = OpenposeDetector.random(
            0, "cpu", box_size=64)
    image = Image.fromarray(_cond_image())
    out = tcontrol.preprocess_image(image, {"preprocess": True,
                                            "type": kind}, device="cpu")
    assert out is not image and out.mode == "RGB"
    assert out.size == image.size
    with pytest.raises(ValueError, match="not supported"):
        tcontrol.preprocess_image(Image.fromarray(_cond_image()),
                                  {"preprocess": True, "type": "bogus"})
