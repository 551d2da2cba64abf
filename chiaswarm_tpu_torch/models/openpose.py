"""OpenPose body skeletons, the openpose detector, counterpart of
``chiaswarm_tpu/models/openpose.py`` (``_TRUNK`` :27-34, ``LIMB_SEQ`` and
``MAP_IDX`` :39-45, colours :47-52, ``BodyPoseNet`` :55-93, host assembly
:96-228, ``OpenposeDetector`` :231-291).

The network is the CMU two-branch body-pose net controlnet_aux's
``bodypose_model`` builds: a VGG trunk to 128 channels at stride 8, then six
stages, each a PAF branch (38 maps) and a heat-map branch (19), the later
stages fed the previous stage's maps with the trunk's features. Every conv
but a stage's last is followed by ReLU. Parameter names are controlnet_aux's
(``model0.conv1_1``, ``model1_1.conv5_1_CPM_L1``,
``model2_1.Mconv1_stage2_L1``, ...); the published ``body_pose_model.pth``
names the convs without their stage prefix, and since every conv name is
unique :meth:`OpenposeDetector.adapt` puts it back, as controlnet_aux's
``transfer`` does.

The wrapper scales the image to a 368-pixel height (INTER_CUBIC), pads it
with grey to a multiple of 8 and feeds BGR in [-0.5, 0.5]; the maps come
back upsampled to the padded extent, cropped and resized to the image
(INTER_CUBIC). Peaks, limb scores, the greedy assembly of people and the
drawing are host numpy and cv2, copied from JAX (:func:`find_peaks`,
:func:`score_limbs`, :func:`assemble_people`, :func:`draw_skeletons`).
Float32; on a card the convolutions run in TF32: 52 convolutions deep.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.models.annotator import (
    Detector,
    download,
    upload_nhwc,
)

# (name, out_channels, kernel) per trunk layer: the fixed CMU body graph
_TRUNK = [
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool1_stage1", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool2_stage1", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool3_stage1", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
]

N_PAF, N_HEAT = 38, 19

#: convolutions on the longest path (the TF32 bar's depth): the trunk's 12,
#: stage 1's 5 and 7 in each of stages 2-6
CONV_DEPTH = 12 + 5 + 5 * 7

# COCO-18 limb topology: (joint_a, joint_b) and their PAF channel pairs
LIMB_SEQ = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8),
            (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 0),
            (0, 14), (14, 16), (0, 15), (15, 17), (2, 16), (5, 17)]
MAP_IDX = [(31, 32), (39, 40), (33, 34), (35, 36), (41, 42), (43, 44),
           (19, 20), (21, 22), (23, 24), (25, 26), (27, 28), (29, 30),
           (47, 48), (49, 50), (53, 54), (51, 52), (55, 56), (37, 38),
           (45, 46)]

_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]


def _layers(spec: list[tuple[str, int, int, int]], last_relu: bool
            ) -> nn.Sequential:
    """(name, in, out, kernel) convs, ReLU after each (the last one too
    only with ``last_relu``); a kernel of 0 is a 2x2 max pool."""
    layers: list[tuple[str, nn.Module]] = []
    for i, (name, cin, cout, k) in enumerate(spec):
        if k == 0:
            layers.append((name, nn.MaxPool2d(2, 2)))
            continue
        layers.append((name, nn.Conv2d(cin, cout, k, padding=k // 2)))
        if last_relu or i < len(spec) - 1:
            layers.append((f"relu_{name}", nn.ReLU()))
    return nn.Sequential(OrderedDict(layers))


class BodyPoseNet(nn.Module):
    """(B, 3, H, W) BGR in [-0.5, 0.5] -> (paf (B, 38, H/8, W/8), heat
    (B, 19, H/8, W/8))."""

    def __init__(self) -> None:
        super().__init__()
        trunk, cin = [], 3
        for name, cout, k in _TRUNK:
            trunk.append((name, cin, cout, k))
            cin = cout if k else cin
        self.model0 = _layers(trunk, last_relu=True)
        for branch, out in ((1, N_PAF), (2, N_HEAT)):
            spec = [(f"conv5_{i}_CPM_L{branch}", 128, 128, 3) for i in (1, 2, 3)]
            spec += [(f"conv5_4_CPM_L{branch}", 128, 512, 1),
                     (f"conv5_5_CPM_L{branch}", 512, out, 1)]
            setattr(self, f"model1_{branch}", _layers(spec, last_relu=False))
            for t in range(2, 7):
                spec = [(f"Mconv{i}_stage{t}_L{branch}",
                         N_PAF + N_HEAT + 128 if i == 1 else 128, 128, 7)
                        for i in range(1, 6)]
                spec += [(f"Mconv6_stage{t}_L{branch}", 128, 128, 1),
                         (f"Mconv7_stage{t}_L{branch}", 128, out, 1)]
                setattr(self, f"model{t}_{branch}",
                        _layers(spec, last_relu=False))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.model0(x)
        paf, heat = self.model1_1(feat), self.model1_2(feat)
        for t in range(2, 7):
            inp = torch.cat([paf, heat, feat], dim=1)
            paf = getattr(self, f"model{t}_1")(inp)
            heat = getattr(self, f"model{t}_2")(inp)
        return paf, heat


# ------------------------------------------------------- host assembly

def find_peaks(heatmap: np.ndarray, thre1: float = 0.1) -> list[list[tuple]]:
    """Per-joint peak list [(x, y, score, id), ...] from the (H, W, 19)
    upsampled heatmap (channel 18 is background)."""
    import cv2

    all_peaks: list[list[tuple]] = []
    peak_id = 0
    for part in range(18):
        m = cv2.GaussianBlur(heatmap[:, :, part], (0, 0), 3)
        up = np.zeros_like(m)
        up[1:, :] = m[:-1, :]
        down = np.zeros_like(m)
        down[:-1, :] = m[1:, :]
        left = np.zeros_like(m)
        left[:, 1:] = m[:, :-1]
        right = np.zeros_like(m)
        right[:, :-1] = m[:, 1:]
        is_peak = (m >= up) & (m >= down) & (m >= left) & (m >= right) & \
                  (m > thre1)
        ys, xs = np.nonzero(is_peak)
        peaks = []
        for x, y in zip(xs, ys):
            peaks.append((int(x), int(y), float(heatmap[y, x, part]),
                          peak_id))
            peak_id += 1
        all_peaks.append(peaks)
    return all_peaks


def score_limbs(paf: np.ndarray, all_peaks, thre2: float = 0.05,
                n_sample: int = 10):
    """Score candidate limbs by the PAF line integral; greedy-match each
    limb type. Returns connection_all[k] = [(idA, idB, score, ia, ib)]."""
    h = paf.shape[0]
    connection_all = []
    for k, (ja, jb) in enumerate(LIMB_SEQ):
        ca, cb = all_peaks[ja], all_peaks[jb]
        if not ca or not cb:
            connection_all.append([])
            continue
        score_map = paf[:, :, [MAP_IDX[k][0] - 19, MAP_IDX[k][1] - 19]]
        candidates = []
        for ia, a in enumerate(ca):
            for ib, b in enumerate(cb):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float32)
                norm = max(float(np.linalg.norm(vec)), 1e-6)
                u = vec / norm
                xs = np.linspace(a[0], b[0], n_sample).round().astype(int)
                ys = np.linspace(a[1], b[1], n_sample).round().astype(int)
                vals = score_map[ys, xs]                  # (n, 2)
                dots = vals @ u
                prior = min(0.5 * h / norm - 1.0, 0.0)    # length penalty
                score = float(dots.mean()) + prior
                ok = (dots > thre2).sum() > 0.8 * n_sample
                if ok and score > 0:
                    candidates.append((ia, ib, score))
        candidates.sort(key=lambda c: c[2], reverse=True)
        used_a, used_b, conns = set(), set(), []
        for ia, ib, s in candidates:
            if ia in used_a or ib in used_b:
                continue
            used_a.add(ia)
            used_b.add(ib)
            conns.append((ca[ia][3], cb[ib][3], s, ia, ib))
        connection_all.append(conns)
    return connection_all


def assemble_people(all_peaks, connection_all, min_parts: int = 4,
                    min_score: float = 0.4) -> list[np.ndarray]:
    """Greedy subset assembly (the standard CMU merge): each person is a
    length-20 row — 18 joint peak-ids (-1 absent), total score, #parts."""
    flat = [p for peaks in all_peaks for p in peaks]
    score_of = {p[3]: p[2] for p in flat}
    subsets: list[np.ndarray] = []
    for k, (ja, jb) in enumerate(LIMB_SEQ):
        for ida, idb, s, _, _ in connection_all[k]:
            found = [i for i, row in enumerate(subsets)
                     if row[ja] == ida or row[jb] == idb]
            if len(found) == 1:
                row = subsets[found[0]]
                if row[jb] != idb:
                    row[jb] = idb
                    row[19] += 1
                    row[18] += score_of[idb] + s
                elif row[ja] != ida:
                    row[ja] = ida
                    row[19] += 1
                    row[18] += score_of[ida] + s
            elif len(found) == 2:
                r1, r2 = subsets[found[0]], subsets[found[1]]
                if not np.any((r1[:18] >= 0) & (r2[:18] >= 0)):
                    r1[:18] = np.where(r2[:18] >= 0, r2[:18], r1[:18])
                    r1[18] += r2[18] + s
                    r1[19] += r2[19]
                    subsets.pop(found[1])
                else:
                    r1[jb] = idb
                    r1[19] += 1
                    r1[18] += score_of[idb] + s
            else:
                row = np.full(20, -1.0)
                row[ja], row[jb] = ida, idb
                row[19] = 2
                row[18] = score_of[ida] + score_of[idb] + s
                subsets.append(row)
    return [row for row in subsets
            if row[19] >= min_parts and row[18] / row[19] >= min_score]


def draw_skeletons(shape: tuple[int, int], all_peaks, subsets) -> np.ndarray:
    """Render the openpose conditioning image: colored limbs + joints on
    black, (H, W, 3) uint8."""
    import cv2

    h, w = shape
    canvas = np.zeros((h, w, 3), np.uint8)
    pos = {p[3]: (p[0], p[1]) for peaks in all_peaks for p in peaks}
    for row in subsets:
        for k, (ja, jb) in enumerate(LIMB_SEQ[:17]):
            ida, idb = int(row[ja]), int(row[jb])
            if ida < 0 or idb < 0:
                continue
            (xa, ya), (xb, yb) = pos[ida], pos[idb]
            mx, my = (xa + xb) / 2, (ya + yb) / 2
            length = float(np.hypot(xa - xb, ya - yb))
            angle = float(np.degrees(np.arctan2(ya - yb, xa - xb)))
            poly = cv2.ellipse2Poly((int(mx), int(my)),
                                    (int(length / 2), 4), int(angle), 0,
                                    360, 1)
            cv2.fillConvexPoly(canvas, poly, _COLORS[k % len(_COLORS)])
        for j in range(18):
            idx = int(row[j])
            if idx >= 0:
                cv2.circle(canvas, pos[idx], 4, _COLORS[j], thickness=-1)
    return canvas


class OpenposeDetector(Detector):
    """uint8 RGB -> uint8 RGB skeleton map."""

    what = "CMU body_pose_model"

    def __init__(self, net: nn.Module, box_size: int = 368,
                 stride: int = 8) -> None:
        super().__init__(net)
        self.box_size = box_size
        self.stride = stride

    @classmethod
    def network(cls, box_size: int = 368, stride: int = 8) -> nn.Module:
        return BodyPoseNet()

    @classmethod
    def adapt(cls, state, **options):
        """The published file's bare conv names (``conv1_1.weight``) get
        their stage module back (``model0.conv1_1.weight``)."""
        with torch.device("meta"):
            names = {k.split(".", 1)[1]: k
                     for k in BodyPoseNet().state_dict()}
        return {names.get(k, k): v for k, v in state.items()}

    def prepare(self, image: np.ndarray):
        import cv2

        h, w = image.shape[:2]
        scale = self.box_size / max(h, 1)
        nh = int(round(h * scale))
        nw = int(round(w * scale))
        nh8 = -(-nh // self.stride) * self.stride
        nw8 = -(-nw // self.stride) * self.stride
        resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_CUBIC)
        padded = np.full((nh8, nw8, 3), 128, np.uint8)
        padded[:nh, :nw] = resized
        # CMU convention: BGR, [-0.5, 0.5]
        x = padded[:, :, ::-1].astype(np.float32) / 256.0 - 0.5
        return x[None], ((h, w), nh, nw, nh8, nw8)

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(1, H8, W8, 3) -> (paf (H8/8, W8/8, 38), heat (.., 19))."""
        paf, heat = self.net(upload_nhwc(x, self.device))
        both = torch.cat([paf, heat], dim=1)[0].permute(1, 2, 0)
        [both] = download(both)
        return both[:, :, :N_PAF], both[:, :, N_PAF:]

    def maps(self, out, ctx) -> tuple[np.ndarray, np.ndarray]:
        """The network's maps upsampled to the padded extent, the stride
        pad cropped, then resized to the image (resizing the padded maps
        straight to the image would pull every joint toward the origin)."""
        import cv2

        paf, heat = out
        (h, w), nh, nw, nh8, nw8 = ctx
        paf = cv2.resize(np.ascontiguousarray(paf), (nw8, nh8),
                         interpolation=cv2.INTER_CUBIC)[:nh, :nw]
        heat = cv2.resize(np.ascontiguousarray(heat), (nw8, nh8),
                          interpolation=cv2.INTER_CUBIC)[:nh, :nw]
        paf = cv2.resize(paf, (w, h), interpolation=cv2.INTER_CUBIC)
        heat = cv2.resize(heat, (w, h), interpolation=cv2.INTER_CUBIC)
        return paf, heat

    def finish(self, out, ctx) -> np.ndarray:
        paf, heat = self.maps(out, ctx)
        peaks = find_peaks(heat)
        people = assemble_people(peaks, score_limbs(paf, peaks))
        return draw_skeletons(ctx[0], peaks, people)
