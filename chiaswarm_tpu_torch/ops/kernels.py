"""Hand-written CUDA kernels: build, load and launch accounting.

Every kernel of the port is a ``.cu`` source under ``chiaswarm_tpu_torch/csrc``
with a plain C entry point; sources may include the ``.cuh`` headers beside
them. It is compiled on first use with ``nvcc`` for ``sm_90a`` into a shared
library under the checkout's git-ignored ``build/kernels/`` directory, keyed
by a hash of the source, the headers and the flags, and
loaded with ``ctypes``. Nothing here runs at import time: the CPU test tier
imports every module of the package on a machine with no ``nvcc``.

Each :class:`CudaKernel` carries a plain integer ``launches`` that its
wrapper increments once per launch, and a count per launched shape, so a
run can show that its main path went through the kernel and at which
shapes. The per-shape counts are mirrored into the process registry's
``chiaswarm_kernel_launches_total`` at every scrape (a worker's
``/metrics``); :func:`reset_launches`, a harness's reset, never lowers the
mirror.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

from chiaswarm_tpu_torch.obs import metrics as obs_metrics

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of chiaswarm_tpu_torch "
                       "are built from source on the machine with the GPU")


@dataclasses.dataclass
class CudaKernel:
    """One kernel source, its C entry point and its launch count.

    ``bind`` sets ``argtypes``/``restype`` on the loaded entry point.
    ``replaces`` names the TPU kernel of the JAX package it ports.
    """

    name: str
    source: Path
    symbol: str
    bind: Callable[[ctypes._CFuncPtr], None]
    replaces: str
    launches: int = 0
    #: launches by (B, L, S, H, D, dtype): the shapes a run served
    shapes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    build_log: str = ""
    build_s: float = 0.0  # seconds of this process's nvcc run, 0 if cached

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._fn: ctypes._CFuncPtr | None = None

    def count_launch(self, q, k) -> None:
        """Count one launch on ``q`` (B, L, H, D) against ``k`` (B, S, H,
        D); the wrapper calls it where it launches, and nowhere else."""
        self.launches += 1
        b, l, h, d = q.shape
        dtype = str(q.dtype).removeprefix("torch.")
        self.shapes[(b, l, k.shape[1], h, d, dtype)] += 1

    def library_path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (self.source, *sorted(self.source.parent.glob("*.cuh"))):
            digest.update(path.read_bytes())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library for this exact source and
        flag set is already built. Returns the library path."""
        out = self.library_path()
        log_path = out.with_suffix(".log")
        if out.exists():
            if log_path.exists():
                self.build_log = log_path.read_text()
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        # pid-suffixed temporary: concurrent first builds must not
        # interleave writes; os.replace installs atomically
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            self.build_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
            self.build_log = proc.stdout + proc.stderr
            log_path.write_text(self.build_log)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        return out

    def entry(self) -> ctypes._CFuncPtr:
        """The bound C entry point, building and loading on first use."""
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(self.build()))
                fn = getattr(lib, self.symbol)
                self.bind(fn)
                self._fn = fn
            return self._fn


#: every CUDA kernel of the port, by name (filled by the ops modules)
KERNELS: dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> dict[str, Path]:
    """Build every registered kernel, one ``nvcc`` per source, all started
    together: a cold build takes as long as the slowest source, not the
    sum. Raises the first failure after every build has ended."""
    # importing the ops modules registers their kernels
    from chiaswarm_tpu_torch.ops import (  # noqa: F401
        flash_attention,
        ring_flash_attention,
    )

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        futures = {name: pool.submit(k.build) for name, k in KERNELS.items()}
    return {name: f.result() for name, f in futures.items()}


def shape_label(shape: tuple) -> str:
    """``(B, L, S, H, D, dtype)`` -> ``"BxLxSxHxD:dtype"``."""
    *dims, dtype = shape
    return "x".join(str(int(n)) for n in dims) + f":{dtype}"


def _mirror_launches() -> None:
    counter = obs_metrics.kernel_launches_counter()
    for name, kernel in list(KERNELS.items()):
        for shape, n in list(kernel.shapes.items()):
            counter.set_to(n, kernel=name, shape=shape_label(shape))


obs_metrics.REGISTRY.add_collector(_mirror_launches)


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
        kernel.shapes.clear()
