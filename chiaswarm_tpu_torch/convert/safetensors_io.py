"""The safetensors format, read and written with the standard library and
torch alone (the card's machine has no ``safetensors`` package; the CPU
tests hold this module against it).

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the tensors' raw little-endian
bytes; offsets count from the end of the header.

:class:`SafetensorsFile` maps the file (copy-on-write, so the views are
writable and the file is never changed) and hands out tensors that share
the mapping: a 3.4 GB float32 UNet is never read into a Python ``bytes``.
A tensor whose offset is not a multiple of its element size is copied out
of the mapping. :func:`save_file` writes F32, F16 and BF16 tensors (and the
integer types of :data:`DTYPES`).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Iterator, Mapping

import torch

#: the format's dtype names and their torch types
DTYPES: dict[str, torch.dtype] = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}

#: a header larger than this is taken for a corrupt file
MAX_HEADER_BYTES = 100 * 1024 * 1024


class SafetensorsError(ValueError):
    """The file is not a well-formed safetensors file."""


class SafetensorsFile:
    """One mapped safetensors file, its header checked when it is opened;
    :meth:`tensors` hands out its tensors. The views keep the mapping alive;
    it goes with the last of them."""

    def __init__(self, path: str | os.PathLike) -> None:
        self.path = Path(path)
        with open(self.path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            head = fh.read(8)
            if len(head) < 8:
                raise SafetensorsError(f"{self.path}: shorter than a header")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise SafetensorsError(
                    f"{self.path}: header of {n} bytes in a file of {size}")
            try:
                header = json.loads(fh.read(n).decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise SafetensorsError(
                    f"{self.path}: header is not JSON ({exc})") from exc
            if not isinstance(header, dict):
                raise SafetensorsError(f"{self.path}: header is not an object")
            header.pop("__metadata__", None)
            self._base = 8 + n
            self._entries: dict[str, tuple[torch.dtype, tuple, int, int]] = {}
            for name, entry in header.items():
                self._entries[name] = self._check(name, entry, size - 8 - n)
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)

    def _check(self, name: str, entry, data_bytes: int) -> tuple:
        try:
            dtype = DTYPES[entry["dtype"]]
            shape = tuple(int(d) for d in entry["shape"])
            begin, end = (int(o) for o in entry["data_offsets"])
        except (KeyError, TypeError, ValueError) as exc:
            raise SafetensorsError(
                f"{self.path}: bad entry for {name!r}: {entry!r}") from exc
        count = 1
        for d in shape:
            if d < 0:
                raise SafetensorsError(f"{self.path}: {name!r} shape {shape}")
            count *= d
        nbytes = count * dtype.itemsize
        if not 0 <= begin <= end <= data_bytes or end - begin != nbytes:
            raise SafetensorsError(
                f"{self.path}: {name!r} offsets [{begin}, {end}] do not hold "
                f"{shape} {entry['dtype']} in {data_bytes} data bytes")
        return dtype, shape, begin, end

    def _tensor(self, name: str) -> torch.Tensor:
        """The tensor, sharing the mapping where its offset is aligned to
        its element size, else copied out of it."""
        dtype, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - begin,
                               offset=self._base + begin)
        if (self._base + begin) % dtype.itemsize:
            raw = raw.clone()
        return raw.view(dtype).view(shape)

    def tensors(self) -> Iterator[tuple[str, torch.Tensor]]:
        """Every tensor in the header's order, as ``(name, tensor)``."""
        for name in self._entries:
            yield name, self._tensor(name)


def save_file(tensors: Mapping[str, torch.Tensor], path: str | os.PathLike,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; moved to the host one at a time) as a
    safetensors file, in name order, the header padded with spaces to a
    multiple of 8 bytes."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors "
                             "name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                fh.write(t.reshape(-1).view(torch.uint8).numpy().data)
    tmp.replace(path)
