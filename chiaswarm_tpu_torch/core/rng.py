"""Seed handling, counterpart of ``chiaswarm_tpu/core/rng.py``.

The reference draws a fresh seed when a job does not pin one and records it
in the result config so every image is reproducible. The port keeps that
contract (:func:`draw_seed`) and the JAX package's per-row rule: row ``b``'s
noise depends only on its own ``(seed, row)`` pair
(``chiaswarm_tpu/pipelines/diffusion.py:450-462``), so an image is the same
whether generated alone or inside a larger batch.

Where the bits come from differs. The JAX package folds the row into a
threefry ``PRNGKey``; here each row gets its own CPU ``torch.Generator``
(Philox/Mersenne streams of PyTorch) seeded from a hash of the pair, and the
drawn noise is moved to the compute device. The same seed therefore gives
different noise, and a different image, on the two backends. Noise drawn on
the CPU is the same whichever device runs the model.

An img2img or inpaint job draws one more stream: the VAE posterior's noise
when its init image is encoded (the JAX package samples the posterior with
``key_for_seed(seed)``, ``pipelines/diffusion.py:667``). That generator
(:func:`posterior_generator`) is seeded from a hash in a domain of its own,
a tag before the seed, so it never equals a ``(seed, row)`` stream. A job
draws it once, whatever its rows, and its rows share the one encoded latent,
as the JAX package repeats ``z`` over a job's rows.

The latent upscaler draws three streams per row, one per stage (the
posterior of its encode, the initial noise on the 2x grid, the step noise),
where the JAX package folds the stage into the row's key
(``pipelines/upscale.py:95-100``). Each comes from its own generator
(:func:`stage_generators`), seeded from a hash of (seed, row, stage) in a
domain of its own.
"""

from __future__ import annotations

import hashlib
import secrets
import struct

import torch

from chiaswarm_tpu_torch.core.device import upload


def draw_seed() -> int:
    """A fresh non-negative 63-bit seed (json-safe, torch.seed()-like range)."""
    return secrets.randbits(63)


def row_seed(seed: int, row: int) -> int:
    """The 63-bit generator seed of one (seed, row) pair."""
    digest = hashlib.sha256(struct.pack("<qq", int(seed) & 0x7FFF_FFFF_FFFF_FFFF,
                                        int(row))).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF


def row_generator(seed: int, row: int) -> torch.Generator:
    """An independent CPU generator for batch row ``row`` of job ``seed``."""
    return torch.Generator(device="cpu").manual_seed(row_seed(seed, row))


_POSTERIOR_DOMAIN = b"chiaswarm-vae-posterior"


def posterior_seed(seed: int) -> int:
    """The 63-bit generator seed of job ``seed``'s VAE posterior draw: a
    hash of a domain tag and the seed, so no ``(seed, row)`` pair of
    :func:`row_seed` (a 16-byte message) hashes the same message."""
    digest = hashlib.sha256(_POSTERIOR_DOMAIN + struct.pack(
        "<q", int(seed) & 0x7FFF_FFFF_FFFF_FFFF)).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF


def posterior_generator(seed: int) -> torch.Generator:
    """The CPU generator of job ``seed``'s one VAE posterior draw."""
    return torch.Generator(device="cpu").manual_seed(posterior_seed(seed))


_STAGE_DOMAIN = b"chiaswarm-stage"


def stage_seed(seed: int, row: int, stage: int) -> int:
    """The 63-bit generator seed of stage ``stage`` of row ``row`` of job
    ``seed``: a hash of a domain tag and the triple, so it equals no
    :func:`row_seed` or :func:`posterior_seed` message."""
    digest = hashlib.sha256(_STAGE_DOMAIN + struct.pack(
        "<qqq", int(seed) & 0x7FFF_FFFF_FFFF_FFFF, int(row),
        int(stage))).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF


def stage_generators(seed: int, rows: range, stage: int
                     ) -> list[torch.Generator]:
    """One CPU generator per row of ``rows`` for stage ``stage`` of job
    ``seed``."""
    return [torch.Generator(device="cpu").manual_seed(
        stage_seed(seed, r, stage)) for r in rows]


def row_generators(pairs: list[tuple[int, int]]) -> list[torch.Generator]:
    return [row_generator(s, r) for s, r in pairs]


def randn_rows(generators: list[torch.Generator], shape: tuple[int, ...],
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Standard-normal (len(generators), *shape) float32: row b from
    generator b only, drawn on the CPU and moved to ``device``."""
    rows = [torch.randn(shape, generator=g, dtype=torch.float32)
            for g in generators]
    return upload(torch.stack(rows), device)
