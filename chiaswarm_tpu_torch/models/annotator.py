"""What the six ControlNet detectors share (``models/hed.py``,
``lineart.py``, ``mlsd.py``, ``openpose.py``, ``dpt.py``, ``upernet.py``):
building a network from a published state dict, the one upload and the one
download around its forward, and the aspect-preserving canvas the
informative-drawings, HED and M-LSD wrappers fit an image onto.

A detector is three steps, so a caller can time and check each:
``prepare`` (host: resize, pad, normalise; NHWC float32), ``forward`` (the
network on the detector's device; the input goes up once and the output
comes down once, with one ``.cpu()``) and ``finish`` (host numpy and cv2:
the map). ``__call__`` runs the three.

Precision: every network runs in float32, as the JAX package runs it. On a
card, cuDNN computes float32 convolutions in TF32 under PyTorch's default
``torch.backends.cudnn.allow_tf32 = True``, which the port leaves as it is
(flipping the process-wide flag would race with a lane's convolutions on
another thread); matmuls and linears stay in full float32 under the default
``torch.backends.cuda.matmul.allow_tf32 = False``. TF32 rounds each operand
to 10 mantissa bits (a unit roundoff of 2**-11), so a card's output stands
within :func:`tf32_bar` of the CPU's: ``2**-11`` per convolution on the
longest path, relative to the output's largest magnitude.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

#: TF32's unit roundoff: 10 explicit mantissa bits
TF32_ROUNDOFF = 2.0 ** -11


def tf32_bar(conv_depth: int) -> float:
    """The card-against-CPU bar of a network with ``conv_depth``
    convolutions on its longest path, relative to the output's largest
    magnitude."""
    return conv_depth * TF32_ROUNDOFF


def _is_counter(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def build(ctor: Callable[[], nn.Module], state: Mapping[str, torch.Tensor],
          device: str | torch.device | None, what: str, path: object = "",
          skip: Callable[[str], bool] = lambda key: False) -> nn.Module:
    """``ctor()`` with its storage on ``device`` and every parameter and
    buffer filled from ``state`` (float32, eval mode, no grad). Strict: a
    key of ``state`` that ``skip`` does not drop must name a tensor of the
    module, every tensor of the module must come from ``state``, at its
    shape; BatchNorm's ``num_batches_tracked`` counters may be absent
    (inference reads none). Raises ``CheckpointError`` otherwise."""
    from chiaswarm_tpu_torch.convert.checkpoint import (
        CheckpointError,
        TensorLander,
    )
    from chiaswarm_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        net = ctor()
    net = net.to_empty(device=device)
    slots = net.state_dict(keep_vars=True)
    given = {k: v for k, v in state.items() if not skip(k)}
    missing = sorted(k for k in slots if k not in given and not _is_counter(k))
    extra = sorted(k for k in given if k not in slots)
    where = f" at {path}" if path else ""
    if missing or extra:
        raise CheckpointError(
            f"not a {what} checkpoint{where}: {len(missing)} tensor(s) "
            f"missing (e.g. {missing[:3]}), {len(extra)} key(s) with no "
            f"slot (e.g. {extra[:3]})")
    bad = [k for k, v in given.items() if tuple(v.shape) != tuple(slots[k].shape)]
    if bad:
        raise CheckpointError(
            f"{what} checkpoint{where}: {bad[:3]} have shapes "
            f"{[tuple(given[k].shape) for k in bad[:3]]}, the network's are "
            f"{[tuple(slots[k].shape) for k in bad[:3]]}")
    lander = TensorLander(device)
    lander.after_allocation()
    with torch.no_grad():
        for key, slot in slots.items():
            if key in given:
                lander.land(slot, given[key])
            else:  # an absent BatchNorm counter
                slot.zero_()
    lander.finish()
    return net.eval().requires_grad_(False)


def upload_nhwc(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host NHWC float32 batch as an NCHW tensor on ``device``."""
    from chiaswarm_tpu_torch.core.device import upload

    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return upload(t.permute(0, 3, 1, 2).contiguous(), device)


def download(*outs: torch.Tensor) -> list[np.ndarray]:
    """Device tensors to host arrays with one ``.cpu()``: flattened into one
    buffer of their common dtype on the device, split on the host."""
    flat = torch.cat([o.reshape(-1) for o in outs]).cpu().numpy()
    arrays, at = [], 0
    for o in outs:
        n = o.numel()
        arrays.append(flat[at:at + n].reshape(tuple(o.shape)))
        at += n
    return arrays


def fit_canvas(image: np.ndarray, canvas: int
               ) -> tuple[np.ndarray, int, int, float]:
    """The informative-drawings/HED/M-LSD canvas: the long side scaled to
    ``canvas`` (INTER_AREA, each side 16 to ``canvas`` pixels), then
    replicate-padded to the square on the bottom and right (a zero apron
    would read as a hard dark border). Returns (padded, nh, nw, scale)."""
    import cv2

    h, w = image.shape[:2]
    scale = canvas / max(h, w, 1)
    nh = max(16, min(canvas, round(h * scale)))
    nw = max(16, min(canvas, round(w * scale)))
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_AREA)
    padded = cv2.copyMakeBorder(resized, 0, canvas - nh, 0, canvas - nw,
                                cv2.BORDER_REPLICATE)
    return padded, nh, nw, scale


class Detector:
    """A network on ``device`` with its host steps around it. A subclass
    names its checkpoint (``what``), builds its network from its options
    (:meth:`network`) and defines ``prepare``, ``forward`` and ``finish``;
    :meth:`adapt` and :meth:`skip` bend a published state dict to the
    network's names where the published layout differs."""

    what = "detector"

    def __init__(self, net: nn.Module) -> None:
        self.net = net
        self.device = next(net.parameters()).device

    @classmethod
    def network(cls, **options) -> nn.Module:
        raise NotImplementedError

    @classmethod
    def adapt(cls, state: dict[str, torch.Tensor], **options
              ) -> dict[str, torch.Tensor]:
        return state

    @staticmethod
    def skip(key: str) -> bool:
        return False

    @classmethod
    def from_state(cls, state: Mapping[str, torch.Tensor],
                   device: str | torch.device | None = None, path: object = "",
                   **options) -> "Detector":
        state = cls.adapt(dict(state), **options)
        net = build(lambda: cls.network(**options), state, device, cls.what,
                    path, cls.skip)
        return cls(net, **options)

    @classmethod
    def from_checkpoint(cls, path: str | Path,
                        device: str | torch.device | None = None,
                        **options) -> "Detector":
        """The published weight file ``path`` (or the files under a
        directory), read natively (``convert/checkpoint.py::
        read_weights``)."""
        from chiaswarm_tpu_torch.convert.checkpoint import read_weights

        return cls.from_state(read_weights(path), device, path, **options)

    @classmethod
    def random(cls, seed: int = 0, device: str | torch.device | None = None,
               **options) -> "Detector":
        """PyTorch's default initialisation, drawn from ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            state = cls.network(**options).state_dict()
        return cls.from_state(state, device, **options)

    def param_bytes(self) -> int:
        """Bytes of the network's parameters and buffers on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.net.parameters(), *self.net.buffers()))

    def prepare(self, image: np.ndarray):
        """uint8 RGB (H, W, 3) -> (NHWC float32 input, host context)."""
        raise NotImplementedError

    def forward(self, x: np.ndarray):
        """The network on the detector's device; host arrays out."""
        raise NotImplementedError

    def finish(self, out, ctx) -> np.ndarray:
        """The network's host output -> the uint8 map."""
        raise NotImplementedError

    def __call__(self, image: np.ndarray) -> np.ndarray:
        x, ctx = self.prepare(image)
        return self.finish(self.forward(x), ctx)
