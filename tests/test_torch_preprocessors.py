"""The port's ControlNet preprocessors against the JAX package, on the CPU.

- (a) The model-free stand-ins (scribble, softedge, depth, normal,
  normalbae, seg, mlsd, lineart) bit for bit JAX's, its caches set to
  "no weights"; openpose without weights raises in both packages.
- (b) The six networks (HED, M-LSD, lineart at 3 blocks, body-pose at their
  full graphs on 64 px canvases; DPT and UperNet at ``DPT_TINY`` and
  ``UPERNET_TINY``): JAX's Flax params through ``*_state_from_flax`` into
  the port, both run on the same input, within 2e-4 of the output's largest
  magnitude in float32 (ROADMAP convention 3; HED's side maps from 0-255
  pixels, depth and logits are unbounded, so the bar is relative).
- (c) One published-layout weight file per detector (HED, M-LSD, lineart,
  body-pose: the state dict under the published names, body-pose without
  its stage prefixes; DPT and UperNet: a tiny transformers model's state
  dict), read by both packages' ``from_checkpoint``: the same outputs, and
  the port's tensors those of (b).
- (d) The host post-processing exactly: HED's fuse, ``decode_lines`` and
  M-LSD's drawing, ``find_peaks`` / ``score_limbs`` / ``assemble_people`` /
  ``draw_skeletons`` on planted fields, DPT's scaling and UperNet's palette
  map give the same uint8 map from the same array (JAX's network stubbed
  out with it).
- (e) The whole map through ``preprocess_image(..., device="cpu")`` for each
  detector mode: within one uint8 level of JAX's for the continuous maps
  (scribble, softedge, depth, normal, normalbae, lineart), equal for the
  threshold maps (mlsd, seg, openpose).
- The resampling JAX does with matrices (``align_corners=True`` x2,
  half-pixel resizes, adaptive pools) against the ``F.interpolate`` and
  ``F.adaptive_avg_pool2d`` calls that stand in for it: equal up to the
  float32 rounding of the interpolation weights (1e-5 on unit-scale inputs;
  a wrong convention is off by tenths).
- The detector cache: one load per (detector, device), "no weights"
  cached, a wrong weight file raises instead of serving the stand-in.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from chiaswarm_tpu.models import dpt as jdpt
from chiaswarm_tpu.models import hed as jhed
from chiaswarm_tpu.models import lineart as jlineart
from chiaswarm_tpu.models import mlsd as jmlsd
from chiaswarm_tpu.models import openpose as jopenpose
from chiaswarm_tpu.models import upernet as jupernet
from chiaswarm_tpu.workloads import controlnet as jcontrol
from chiaswarm_tpu_torch.convert import from_jax
from chiaswarm_tpu_torch.convert.checkpoint import CheckpointError
from chiaswarm_tpu_torch.models import dpt as tdpt
from chiaswarm_tpu_torch.models import hed as thed
from chiaswarm_tpu_torch.models import lineart as tlineart
from chiaswarm_tpu_torch.models import mlsd as tmlsd
from chiaswarm_tpu_torch.models import openpose as topenpose
from chiaswarm_tpu_torch.models import upernet as tupernet
from chiaswarm_tpu_torch.workloads import controlnet as tcontrol

BAR = 2e-4
RESAMPLE_BAR = 1e-5
CANVAS = 64
PICTURE_HW = (48, 80)
JAX_CACHES = ("_HED", "_MLSD", "_LINEART", "_DPT", "_SEG", "_OPENPOSE")
STANDIN_MODES = ("scribble", "softedge", "depth", "normal", "normalbae",
                 "seg", "mlsd", "lineart")
# detector -> (its modes, the continuous ones among them)
DETECTOR_MODES = {"hed": ("scribble", "softedge"), "mlsd": ("mlsd",),
                  "lineart": ("lineart",),
                  "dpt": ("depth", "normal", "normalbae"),
                  "upernet": ("seg",), "openpose": ("openpose",)}
CONTINUOUS = {"scribble", "softedge", "lineart", "depth", "normal",
              "normalbae"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (the suite's workers share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _root(tmp_path, monkeypatch):
    """An empty settings root (no detector directories) and empty caches in
    both packages."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    for name in JAX_CACHES:
        monkeypatch.setattr(jcontrol, name, [])
    monkeypatch.setattr(tcontrol, "_DETECTORS", {})


def picture(seed: int = 3, hw=(96, 128)) -> np.ndarray:
    """A seeded picture with smooth shading, flat boxes and straight edges
    (structure for every stand-in: gradients, Hough lines, segments)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    arr = np.asarray(Image.fromarray(small).resize((hw[1], hw[0]),
                                                   Image.BICUBIC)).copy()
    h, w = hw
    for _ in range(3):
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        arr[y:y + h // 3, x:x + w // 3] = rng.integers(0, 256, 3)
    arr[h // 2, :] = 255
    return arr


# ---------------------------------------------------------------------------
# (a) the stand-ins


@pytest.mark.parametrize("mode", STANDIN_MODES)
def test_standins_are_jax_bit_for_bit(mode, monkeypatch):
    for name in JAX_CACHES:
        monkeypatch.setattr(jcontrol, name, [None])
    image = Image.fromarray(picture())
    block = {"preprocess": True, "type": mode}
    got = tcontrol.preprocess_image(image, block, device="cpu")
    want = jcontrol.preprocess_image(image, block)
    assert got.size == want.size and got.mode == want.mode == "RGB"
    assert got.tobytes() == want.tobytes()
    assert 0 < np.asarray(got).mean() < 255


def test_the_standins_serve_without_a_card(monkeypatch):
    """No directory: the stand-in, cached as "no weights", whatever the
    device (nothing is loaded, so nothing needs the card)."""
    image = Image.fromarray(picture(5, (64, 64)))
    block = {"preprocess": True, "type": "softedge"}
    first = tcontrol.preprocess_image(image, block)
    assert tcontrol._DETECTORS == {("hed", "cuda"): None}
    assert first.tobytes() == tcontrol.preprocess_image(image,
                                                        block).tobytes()


def test_openpose_without_weights_raises_in_both(tmp_path):
    image = Image.fromarray(picture())
    block = {"preprocess": True, "type": "openpose"}
    with pytest.raises(ValueError, match="openpose") as ours:
        tcontrol.preprocess_image(image, block, device="cpu")
    assert str(tmp_path / "models" / "openpose") in str(ours.value)
    assert "init" not in str(ours.value)
    with pytest.raises(ValueError, match="openpose"):
        jcontrol.preprocess_image(image, block)
    assert ("openpose", "cpu") not in tcontrol._DETECTORS


def test_every_jax_mode_is_served():
    assert set(tcontrol.MODES) == set(jcontrol._PREPROCESSORS)
    with pytest.raises(ValueError, match="not supported"):
        tcontrol.preprocess_image(Image.fromarray(picture()),
                                  {"preprocess": True, "type": "bogus"})


# ---------------------------------------------------------------------------
# the detectors over one set of weights


def published(net: torch.nn.Module, seed: int, first_scale: float = 1.0
              ) -> dict[str, torch.Tensor]:
    """Seeded non-degenerate weights for ``net`` under its (published)
    names: He-scaled kernels (the first one times ``first_scale``), small
    biases and shifts, norm scales near 1, running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    state, first = {}, True
    for key, v in net.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith("num_batches_tracked"):
            state[key] = v.clone()
            continue
        if key.endswith("running_var"):
            value = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("running_mean"):
            value = rng.normal(0.0, 0.1, shape)
        elif v.dim() >= 2 and key.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            value = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
            if first:
                value, first = value * first_scale, False
        elif key.endswith("weight") or key.endswith("layer_scale_parameter"):
            value = 1.0 + rng.normal(0.0, 0.1, shape)
        else:
            value = rng.normal(0.0, 0.1, shape)
        state[key] = torch.tensor(value, dtype=torch.float32)
    return state


def hf_dpt_state(seed: int) -> dict[str, torch.Tensor]:
    """A tiny transformers ``DPTForDepthEstimation`` (``DPT_TINY``'s
    widths), its floats redrawn from ``seed``."""
    pytest.importorskip("transformers")
    from transformers import DPTConfig, DPTForDepthEstimation

    cfg = DPTConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, image_size=32, patch_size=8,
        backbone_out_indices=[0, 1, 2, 3],
        neck_hidden_sizes=[16, 16, 24, 24], fusion_hidden_size=16,
        reassemble_factors=[4, 2, 1, 0.5], readout_type="project",
        is_hybrid=False, qkv_bias=True, add_projection=False,
        use_batch_norm_in_fusion_residual=False)
    return published(DPTForDepthEstimation(cfg), seed)


def hf_upernet_state(seed: int) -> dict[str, torch.Tensor]:
    """A tiny transformers ``UperNetForSemanticSegmentation``
    (``UPERNET_TINY``'s widths, with its auxiliary head), redrawn."""
    pytest.importorskip("transformers")
    from transformers import (
        ConvNextConfig,
        UperNetConfig,
        UperNetForSemanticSegmentation,
    )

    backbone = ConvNextConfig(
        depths=[1, 1, 1, 1], hidden_sizes=[8, 16, 24, 32],
        out_features=["stage1", "stage2", "stage3", "stage4"])
    cfg = UperNetConfig(backbone_config=backbone, hidden_size=16,
                        pool_scales=[1, 2, 3, 6], num_labels=10,
                        use_auxiliary_head=True, auxiliary_in_channels=24)
    return published(UperNetForSemanticSegmentation(cfg), seed)


def _mlsd_state() -> dict[str, torch.Tensor]:
    """M-LSD's weights with a tempered head: the TP map's centre logits
    near 0.5 and small displacements, so segments pass the score and
    length thresholds (He-scaled weights alone saturate the logits)."""
    state = published(tmlsd.MLSDNetwork(), 2)
    state["block23.conv3.weight"] = state["block23.conv3.weight"] * 0.02
    state["block23.conv3.bias"][7] = 0.5
    return state


def _bare_openpose(state: dict) -> dict:
    """body_pose_model.pth names its convs without their stage module."""
    return {k.split(".", 1)[1]: v for k, v in state.items()}


# name: (port class, JAX class, published file, options, JAX cache,
#        the published state, the Flax -> port converter)
SPECS = {
    "hed": (thed.HEDDetector, jhed.HEDDetector, "ControlNetHED.pth",
            {"canvas": CANVAS}, "_HED",
            lambda: published(thed.HEDNetwork(), 1, first_scale=1 / 128),
            lambda p: from_jax.hed_state_from_flax(p)),
    "mlsd": (tmlsd.MLSDDetector, jmlsd.MLSDDetector,
             "mlsd_large_512_fp32.pth", {"canvas": CANVAS}, "_MLSD",
             _mlsd_state,
             lambda p: from_jax.mlsd_state_from_flax(p)),
    "lineart": (tlineart.LineartDetector, jlineart.LineartDetector,
                "sk_model.pth", {"canvas": CANVAS, "n_blocks": 3},
                "_LINEART",
                lambda: published(tlineart.LineartGenerator(3), 3),
                lambda p: from_jax.lineart_state_from_flax(p, 3)),
    "openpose": (topenpose.OpenposeDetector, jopenpose.OpenposeDetector,
                 "body_pose_model.pth", {"box_size": CANVAS}, "_OPENPOSE",
                 lambda: _bare_openpose(published(topenpose.BodyPoseNet(),
                                                  4)),
                 lambda p: from_jax.openpose_state_from_flax(p)),
    "dpt": (tdpt.DPTDetector, jdpt.DPTDetector, "pytorch_model.bin",
            {"config": tdpt.DPT_TINY}, "_DPT", lambda: hf_dpt_state(5),
            lambda p: from_jax.dpt_state_from_flax(p, tdpt.DPT_TINY)),
    "upernet": (tupernet.UperNetDetector, jupernet.UperNetDetector,
                "pytorch_model.bin", {"config": tupernet.UPERNET_TINY},
                "_SEG", lambda: hf_upernet_state(6),
                lambda p: from_jax.upernet_state_from_flax(
                    p, tupernet.UPERNET_TINY)),
}
JAX_CONFIGS = {"dpt": jdpt.DPT_TINY, "upernet": jupernet.UPERNET_TINY}


class Twins:
    """One detector's weights in a published file, read by JAX's
    ``from_checkpoint`` (``jax``) and the port's (``from_file``); the port's
    built from JAX's params through ``*_state_from_flax`` (``from_flax``)."""

    def __init__(self, name: str, root, state=None) -> None:
        pcls, jcls, file, opts, _, make_state, to_port = SPECS[name]
        self.name, self.opts = name, opts
        self.state = make_state() if state is None else state
        path = root / name / file
        path.parent.mkdir(parents=True)
        torch.save(self.state, path)
        self.path = path
        if name in JAX_CONFIGS:
            self.jax = jcls.from_checkpoint(path, config=JAX_CONFIGS[name])
        else:
            self.jax = jcls.from_checkpoint(path)
            for key, value in opts.items():
                if key != "n_blocks":
                    setattr(self.jax, key, value)
        self.from_file = pcls.from_checkpoint(path, "cpu", **opts)
        flax = to_port({"params": jax_tree(self.jax.params["params"])})
        self.from_flax = pcls.from_state(flax, "cpu", **opts)

    def jax_out(self, x: np.ndarray):
        """JAX's network output on the NHWC batch ``x``, in the port's
        host layout (UperNet: the logits at the input's size)."""
        if self.name == "upernet":
            net = jupernet.UperNetSeg(JAX_CONFIGS["upernet"])
            _, inter = jax.jit(lambda p, x: net.apply(
                p, x, capture_intermediates=True))(self.jax.params, x)
            logits = inter["intermediates"]["classifier"]["__call__"][0]
            return np.asarray(jupernet.resize_bilinear(logits, x.shape[1:3])
                              )[0].transpose(2, 0, 1)
        out = self.jax._fwd(self.jax.params, x)
        if self.name == "hed":
            return [np.asarray(s)[0, :, :, 0] for s in out]
        if self.name == "openpose":
            return tuple(np.asarray(o)[0] for o in out)
        out = np.asarray(out)[0]
        return out[:, :, 0] if self.name == "lineart" else out

    def port_out(self, det, x: np.ndarray):
        if self.name == "upernet":
            with torch.inference_mode():
                return det.net(torch.from_numpy(x.transpose(0, 3, 1, 2))
                               )[0].numpy()
        return det.forward(x)


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    root = tmp_path_factory.mktemp("detectors")
    return {name: Twins(name, root) for name in SPECS}


def _flat(out) -> list[np.ndarray]:
    return [np.asarray(o) for o in (out if isinstance(out, (list, tuple))
                                    else [out])]


def _within(got, want, bar: float = BAR) -> float:
    """The largest error over the output's largest magnitude; asserts it
    is within ``bar``."""
    got, want = _flat(got), _flat(want)
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert scale > 0 and err <= bar * scale, (err, scale)
    return err / scale


def _input(t: Twins) -> np.ndarray:
    x, _ = t.from_file.prepare(picture(7, PICTURE_HW))
    return x


# ---------------------------------------------------------------------------
# (b) the networks through *_state_from_flax, (c) the published files


@pytest.mark.parametrize("name", SPECS)
def test_network_from_flax_params_matches_jax(twins, name):
    t = twins[name]
    x = _input(t)
    _within(t.port_out(t.from_flax, x), t.jax_out(x))


@pytest.mark.parametrize("name", SPECS)
def test_published_file_reads_as_jax_reads_it(twins, name):
    """Both packages read the same file; the port's tensors are exactly the
    file's (minus the keys JAX's converter drops) and exactly those
    ``*_state_from_flax`` rebuilds from JAX's params."""
    t = twins[name]
    x = _input(t)
    _within(t.port_out(t.from_file, x), t.jax_out(x))
    ours = t.from_file.net.state_dict()
    cls = SPECS[name][0]
    state = cls.adapt(t.state, **t.opts)
    assert set(ours) == {k for k in state if not cls.skip(k)}
    for key, value in ours.items():
        assert torch.equal(value, state[key]), key
        assert torch.equal(value, t.from_flax.net.state_dict()[key]), key


@pytest.mark.parametrize("name", SPECS)
def test_a_wrong_state_raises(twins, name):
    t = twins[name]
    cls = SPECS[name][0]
    state = dict(t.state)
    key = sorted(k for k in state
                 if k.endswith("weight") and not cls.skip(k))[0]
    with pytest.raises(CheckpointError, match="shape"):
        cls.from_state(dict(state, **{key: state[key][..., :1]}), "cpu",
                       **t.opts)
    with pytest.raises(CheckpointError, match="missing"):
        cls.from_state({k: v for k, v in state.items() if k != key}, "cpu",
                       **t.opts)
    with pytest.raises(CheckpointError, match="no slot"):
        cls.from_state(dict(state, bogus=torch.zeros(1)), "cpu", **t.opts)


def test_lineart_transposed_convs_are_unflipped(twins):
    """JAX stores the transposed kernels flipped; the port holds torch's."""
    t = twins["lineart"]
    flax = t.jax.params["params"]["up_0"]["kernel"]
    torch_w = t.state["model3.0.weight"].numpy()
    np.testing.assert_array_equal(np.asarray(flax)[::-1, ::-1],
                                  torch_w.transpose(2, 3, 0, 1))
    assert torch.equal(t.from_flax.net.model3[0].weight,
                       t.state["model3.0.weight"])


# ---------------------------------------------------------------------------
# resampling: F.interpolate / adaptive pools against JAX's matrices


@pytest.mark.parametrize("hw", [(1, 1), (4, 4), (12, 16), (24, 24)])
def test_align_corners_x2_is_jax_matrix(hw):
    x = np.random.default_rng(sum(hw)).normal(size=(1, *hw, 3)).astype(
        np.float32)
    t = torch.from_numpy(x.transpose(0, 3, 1, 2))
    got = tmlsd.up2_align_corners(t).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(jmlsd._align_corners_up2(x)),
                               atol=RESAMPLE_BAR)
    np.testing.assert_allclose(got, np.asarray(jdpt._upsample2x(x)),
                               atol=RESAMPLE_BAR)
    np.testing.assert_array_equal(tdpt.up2_align_corners(t).numpy(),
                                  tmlsd.up2_align_corners(t).numpy())


@pytest.mark.parametrize("src,dst", [((2, 2), (16, 16)), ((3, 3), (8, 8)),
                                     ((6, 6), (16, 16)), ((4, 4), (64, 64)),
                                     ((8, 8), (16, 16)), ((16, 16), (9, 5))])
def test_half_pixel_resize_is_jax_matrix(src, dst):
    x = np.random.default_rng(src[0] + dst[0]).normal(
        size=(1, *src, 3)).astype(np.float32)
    got = tupernet.resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                   dst).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(jupernet.resize_bilinear(
        x, dst)), atol=RESAMPLE_BAR)


@pytest.mark.parametrize("n,scale", [(2, 1), (2, 3), (2, 6), (16, 3),
                                     (16, 6), (7, 3)])
def test_adaptive_pool_is_jax_matrix(n, scale):
    x = np.random.default_rng(n * scale).normal(
        size=(1, n, n, 3)).astype(np.float32)
    got = F.adaptive_avg_pool2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                scale).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(
        jupernet.adaptive_avg_pool(x, scale)), atol=RESAMPLE_BAR)


# ---------------------------------------------------------------------------
# (d) the host post-processing, exactly


def _stubbed(t: Twins, out):
    """A copy of JAX's detector whose network returns ``out``."""
    jdet = copy.copy(t.jax)
    jdet._fwd = lambda params, x: out
    return jdet


def test_hed_fuse_is_jax_exactly(twins):
    t = twins["hed"]
    rng = np.random.default_rng(11)
    image = picture(8, PICTURE_HW)
    x, ctx = t.from_file.prepare(image)
    sides = [rng.normal(0, 2, (CANVAS >> b, CANVAS >> b)).astype(np.float32)
             for b in range(5)]
    want = _stubbed(t, [s[None, :, :, None] for s in sides])(image)
    got = t.from_file.finish(sides, ctx)
    np.testing.assert_array_equal(got, want)
    assert 10 < got.mean() < 245


def _planted_tp(rng, hw=(32, 32)) -> np.ndarray:
    tp = rng.normal(-6, 1, (*hw, 9)).astype(np.float32)
    tp[:, :, 1:] = rng.normal(0, 3, (*hw, 8))
    for y, x in rng.integers(2, hw[0] - 2, (12, 2)):
        tp[y, x, 0] = rng.uniform(0, 6)
    return tp


def test_mlsd_decode_and_drawing_are_jax_exactly(twins):
    t = twins["mlsd"]
    rng = np.random.default_rng(12)
    tp = _planted_tp(rng)
    for thr in (0.1, 3.0):
        lines = tmlsd.decode_lines(tp, dist_thr=thr)
        np.testing.assert_array_equal(
            lines, jmlsd.decode_lines(tp, dist_thr=thr))
    assert len(tmlsd.decode_lines(tp)) >= 6
    image = picture(9, PICTURE_HW)
    _, ctx = t.from_file.prepare(image)
    want = _stubbed(t, tp[None])(image)
    got = t.from_file.finish(tp, ctx)
    np.testing.assert_array_equal(got, want)
    assert got.any()


def _synthetic_people(h: int = 96, w: int = 96):
    """Heat blobs at two people's joints and PAFs along every limb."""
    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(13)
    for cx in (28, 68):
        joints = {j: (cx + int(rng.integers(-12, 13)),
                      12 + 4 * j + int(rng.integers(-2, 3)))
                  for j in range(18)}
        for j, (x, y) in joints.items():
            heat[:, :, j] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0)
        for k, (ja, jb) in enumerate(topenpose.LIMB_SEQ):
            (xa, ya), (xb, yb) = joints[ja], joints[jb]
            v = np.array([xb - xa, yb - ya], np.float32)
            v /= max(float(np.linalg.norm(v)), 1e-6)
            for s in np.linspace(0, 1, 40):
                px, py = int(round(xa + s * (xb - xa))), int(round(
                    ya + s * (yb - ya)))
                cx_, cy_ = topenpose.MAP_IDX[k]
                paf[max(py - 1, 0):py + 2, max(px - 1, 0):px + 2,
                    cx_ - 19] = v[0]
                paf[max(py - 1, 0):py + 2, max(px - 1, 0):px + 2,
                    cy_ - 19] = v[1]
    return paf, heat


def test_openpose_assembly_and_drawing_are_jax_exactly(twins):
    paf, heat = _synthetic_people()
    peaks = topenpose.find_peaks(heat)
    assert peaks == jopenpose.find_peaks(heat)
    conns = topenpose.score_limbs(paf, peaks)
    assert conns == jopenpose.score_limbs(paf, peaks)
    people = topenpose.assemble_people(peaks, conns)
    want_people = jopenpose.assemble_people(peaks, conns)
    assert len(people) == len(want_people) >= 1
    for a, b in zip(people, want_people):
        np.testing.assert_array_equal(a, b)
    drawing = topenpose.draw_skeletons(heat.shape[:2], peaks, people)
    np.testing.assert_array_equal(drawing, jopenpose.draw_skeletons(
        heat.shape[:2], peaks, want_people))
    assert drawing.any()
    # the detector's own host half on network-sized maps
    t = twins["openpose"]
    image = np.asarray(Image.fromarray(picture(10, (96, 96))))
    x, ctx = t.from_file.prepare(image)
    small = tuple(np.ascontiguousarray(m[::8, ::8][:x.shape[1] // 8,
                                                   :x.shape[2] // 8])
                  for m in (paf, heat))
    want = _stubbed(t, tuple(m[None] for m in small))(image)
    np.testing.assert_array_equal(t.from_file.finish(small, ctx), want)


def test_dpt_scaling_is_jax_exactly(twins):
    t = twins["dpt"]
    depth = np.random.default_rng(14).gamma(2.0, 1.0, (32, 32)).astype(
        np.float32)
    image = picture(11, PICTURE_HW)
    _, ctx = t.from_file.prepare(image)
    jdet = _stubbed(t, depth[None])
    np.testing.assert_array_equal(t.from_file.finish(depth, ctx),
                                  jdet(image))
    np.testing.assert_array_equal(t.from_file.finish_depth(depth, ctx),
                                  jdet.depth(image))


def test_upernet_palette_map_is_jax_exactly(twins):
    t = twins["upernet"]
    classes = np.random.default_rng(15).integers(
        0, 160, (64, 64)).astype(np.uint8)
    image = picture(12, PICTURE_HW)
    _, ctx = t.from_file.prepare(image)
    np.testing.assert_array_equal(t.from_file.finish(classes, ctx),
                                  _stubbed(t, classes[None])(image))


# ---------------------------------------------------------------------------
# (e) the whole map


@pytest.mark.parametrize("mode", [m for modes in DETECTOR_MODES.values()
                                  for m in modes])
def test_detector_modes_match_jax_end_to_end(twins, mode, monkeypatch):
    name = next(n for n, modes in DETECTOR_MODES.items() if mode in modes)
    t = twins[name]
    monkeypatch.setattr(jcontrol, SPECS[name][4], [t.jax])
    monkeypatch.setitem(tcontrol._DETECTORS, (name, "cpu"), t.from_file)
    image = Image.fromarray(picture(16, PICTURE_HW))
    block = {"preprocess": True, "type": mode}
    got = np.asarray(tcontrol.preprocess_image(image, block, device="cpu"))
    want = np.asarray(jcontrol.preprocess_image(image, block))
    assert got.shape == want.shape == (*PICTURE_HW, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    if mode in CONTINUOUS:
        assert diff.max() <= 1, diff.max()
    else:
        np.testing.assert_array_equal(got, want)
        assert got.any()  # random weights leave a map to compare


# ---------------------------------------------------------------------------
# the detector cache


def test_the_cache_loads_once_per_device_and_a_bad_file_raises(twins,
                                                               tmp_path):
    from chiaswarm_tpu_torch.node.registry import model_dir

    src = twins["lineart"]
    target = model_dir("lineart")
    target.mkdir(parents=True)
    torch.save(src.state, target / "sk_model.pth")
    det = tcontrol.get_detector("lineart", "cpu", "stand-in")
    assert isinstance(det, tlineart.LineartDetector)
    assert det.n_blocks == 3 and det.device == torch.device("cpu")
    assert tcontrol.get_detector("lineart", "cpu", "stand-in") is det
    tcontrol.clear_detectors()
    assert tcontrol._DETECTORS == {}
    bad = model_dir("hed")
    bad.mkdir(parents=True)
    torch.save(src.state, bad / "ControlNetHED.pth")  # not a HED
    image = Image.fromarray(picture())
    for _ in range(2):  # raised again: a failed load is not cached
        with pytest.raises(CheckpointError, match="ControlNetHED"):
            tcontrol.preprocess_image(image, {"preprocess": True,
                                              "type": "softedge"}, "cpu")
    assert ("hed", "cpu") not in tcontrol._DETECTORS


def test_concurrent_first_uses_load_a_detector_once(monkeypatch):
    """Slots' threads asking for one detector at once: one load, one shared
    detector (the cache's check and fill happen under its lock)."""
    import sys
    import threading
    import time

    from chiaswarm_tpu_torch.node.registry import model_dir

    loads = []

    class Slow:
        @classmethod
        def from_checkpoint(cls, path, device):
            loads.append(device)
            time.sleep(0.01)
            return cls()

    monkeypatch.setattr(sys.modules[__name__], "Slow", Slow, raising=False)
    monkeypatch.setitem(tcontrol._DETECTOR_CLASSES, "hed",
                        (__name__, "Slow"))
    model_dir("hed").mkdir(parents=True)
    got, interval = [], sys.getswitchinterval()
    threads = [threading.Thread(target=lambda: got.append(
        tcontrol.get_detector("hed", "cpu", "stand-in"))) for _ in range(32)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and len(got) == 32
    assert all(det is got[0] for det in got)
