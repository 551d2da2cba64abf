"""Diffusers-layout checkpoint directories -> the port's modules, the
counterpart of ``chiaswarm_tpu/convert/torch_to_flax.py``:
``read_torch_weights`` (:38-68), ``load_checkpoint`` (:939-958) and the
name rules of ``convert_vae`` (:448-508) and ``convert_text_encoder``
(:579-614).

A snapshot holds one subdirectory per module (``unet/``, ``vae/``,
``text_encoder/``, ``text_encoder_2/`` for a second tower), each with
``*.safetensors`` files (read through ``convert/safetensors_io.py``, no
``safetensors`` package) or ``*.bin``/``*.pt``/``*.pth``/``*.ckpt`` files
(``torch.load(weights_only=True)``, a ``"state_dict"`` unwrapped). Where a
directory holds safetensors files the others are not read: published
snapshots carry the same weights in both formats (the JAX reader reads
both; the later file's keys win there as here). A key found in several
files takes the later file's value, in name order.

The port's modules carry diffusers/transformers names already, so loading
is a name check plus the aliases the JAX converters accept:

- the old VAE attention names ``query``/``key``/``value``/``proj_attn``
  -> ``to_q``/``to_k``/``to_v``/``to_out.0``, their ``(O, I, 1, 1)``
  projections squeezed to ``(O, I)``;
- ``to_out.<leaf>`` -> ``to_out.0.<leaf>`` (the JAX converters accept both);
- a text tower's keys without the ``text_model.`` prefix; its
  ``position_ids`` buffer (older CLIP checkpoints) is skipped.

Keys with no parameter in the port are skipped with a debug log, as JAX
skips them. A parameter the checkpoint lacks, a shape that does not match,
a directory without weight files or a malformed file raises
:class:`CheckpointError`: nothing is filled in at random.

:class:`TensorLander` puts each tensor in its parameter as it is read, so
a load holds the modules at their serving dtypes plus one tensor in
flight. On a card it copies through a pinned staging buffer on a stream of
its own, timing the file read (the mapped pages faulted into the staging
buffer) apart from the device copy. Once a module's parameters are
allocated, that stream waits for the work queued so far on the current
stream: the caching allocator may hand a parameter a block that kernels
queued there (a lane's step on another thread) still read or write. It
synchronises after each copy, so a pipeline loaded on a background thread
is complete when it is handed over.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import torch
from torch import nn

from chiaswarm_tpu_torch.convert.safetensors_io import (
    SafetensorsError,
    SafetensorsFile,
)

log = logging.getLogger("chiaswarm_torch.convert")

#: module -> its subdirectory in a snapshot (JAX ``_SUBDIR_CANDIDATES``)
SUBDIRS = {"unet": "unet", "vae": "vae", "text_encoder_0": "text_encoder",
           "text_encoder_1": "text_encoder_2"}

_OTHER_PATTERNS = ("*.bin", "*.pt", "*.pth", "*.ckpt")

_VAE_ATTN_ALIASES = {"query": "to_q", "key": "to_k", "value": "to_v",
                     "proj_attn": "to_out.0"}


class CheckpointError(RuntimeError):
    """A checkpoint directory that cannot fill the model: no weight
    files, a malformed file, a missing parameter or a wrong shape."""


def weight_files(path: str | Path) -> list[Path]:
    """The weight files of one module directory: its safetensors files,
    else its torch pickles."""
    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        for pattern in _OTHER_PATTERNS:
            files.extend(sorted(path.glob(pattern)))
    if not files:
        raise CheckpointError(f"no weight files under {path}")
    return files


def read_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor under ``path``, on the host: safetensors tensors share
    their file's mapping, pickled ones are loaded. Non-tensor entries of a
    pickle are dropped."""
    state: dict[str, torch.Tensor] = {}
    for file in weight_files(path):
        if file.suffix == ".safetensors":
            try:
                st = SafetensorsFile(file)
            except SafetensorsError as exc:
                raise CheckpointError(str(exc)) from exc
            state.update(st.tensors())
            continue
        raw = torch.load(str(file), map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        if not isinstance(raw, dict):
            raise CheckpointError(f"{file} holds a {type(raw).__name__}, "
                                  "not a state dict")
        state.update((k, v) for k, v in raw.items()
                     if isinstance(v, torch.Tensor))
    return state


def canonical_name(module: str, key: str) -> str | None:
    """The port's parameter name for checkpoint key ``key`` of ``module``
    (``unet``/``vae``/``text_encoder_{i}``), or None for a key the JAX
    converters skip by rule."""
    parts = key.split(".")
    if module.startswith("text_encoder"):
        if parts[-1] == "position_ids":
            return None
        if parts[0] not in ("text_model", "text_projection"):
            parts.insert(0, "text_model")
        return ".".join(parts)
    if module == "vae" and len(parts) >= 2 and parts[-2] in _VAE_ATTN_ALIASES:
        parts[-2] = _VAE_ATTN_ALIASES[parts[-2]]
    elif len(parts) >= 2 and parts[-2] == "to_out":
        parts.insert(-1, "0")
    return ".".join(parts)


class TensorLander:
    """Copies host tensors into parameters one at a time. On a card:
    through a pinned staging buffer, on a stream of its own, synchronised
    after each tensor, so ``read_s`` (into the staging buffer) and
    ``copy_s`` (to the card) split the load. :meth:`after_allocation`
    orders the copies after the kernels already queued on the device's
    current stream. :meth:`finish` leaves nothing in flight."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.read_s = 0.0
        self.copy_s = 0.0
        self.bytes = 0
        self.tensors = 0
        self._staging: torch.Tensor | None = None
        self._stream = None
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)

    def after_allocation(self) -> None:
        """Make the copies that follow wait for the work queued so far on
        the current stream. Call it once the parameters they fill are
        allocated: a block freed there is handed out again at once, while
        kernels queued before the free (another thread's) may still use
        it."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _buffer(self, nbytes: int) -> torch.Tensor:
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                        pin_memory=True)
        return self._staging[:nbytes]

    @torch.no_grad()
    def land(self, param: torch.Tensor, src: torch.Tensor) -> None:
        t0 = time.perf_counter()
        src = src.contiguous()
        nbytes = src.numel() * src.element_size()
        if self._stream is None:
            t1 = time.perf_counter()
            param.copy_(src)
        else:
            staging = self._buffer(nbytes)
            if nbytes:
                staging.copy_(src.reshape(-1).view(torch.uint8))
            host = staging.view(src.dtype).view(src.shape)
            t1 = time.perf_counter()
            with torch.cuda.stream(self._stream):
                param.copy_(host, non_blocking=True)
            self._stream.synchronize()
        self.read_s += t1 - t0
        self.copy_s += time.perf_counter() - t1
        self.bytes += nbytes
        self.tensors += 1

    def finish(self) -> dict:
        if self._stream is not None:
            self._stream.synchronize()
        self._staging = None
        return {"read_s": self.read_s, "copy_s": self.copy_s,
                "bytes_read": self.bytes, "tensors": self.tensors}


def load_module(module: nn.Module, name: str, path: str | Path,
                lander: TensorLander) -> list[str]:
    """Fill every parameter of ``module`` (the port's ``name`` module,
    storage already on its device at its serving dtypes) from the weight
    files under ``path``. Returns the checkpoint keys skipped."""
    state = read_weights(path)
    params = dict(module.named_parameters())
    source: dict[str, str] = {}
    skipped: list[str] = []
    for key in state:
        target = canonical_name(name, key)
        if target is None or target not in params:
            skipped.append(key)
        else:
            source[target] = key
    missing = sorted(set(params) - set(source))
    if missing:
        raise CheckpointError(
            f"{name} checkpoint at {path} lacks {len(missing)} parameter(s): "
            f"{', '.join(missing[:8])}{' ...' if len(missing) > 8 else ''}")
    lander.after_allocation()
    for target, param in params.items():
        value = state[source[target]]
        if (name == "vae" and param.dim() == 2 and value.dim() == 4
                and tuple(value.shape[2:]) == (1, 1)):
            value = value[:, :, 0, 0]
        if tuple(value.shape) != tuple(param.shape):
            raise CheckpointError(
                f"{name} checkpoint key {source[target]!r} has shape "
                f"{tuple(value.shape)}; the port's {target} is "
                f"{tuple(param.shape)}")
        lander.land(param, value)
    if skipped:
        log.debug("%s: skipped %d checkpoint key(s) with no counterpart "
                  "(e.g. %s)", name, len(skipped), skipped[0])
    return skipped

