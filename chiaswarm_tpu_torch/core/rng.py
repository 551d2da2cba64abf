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

A vid2vid chunk encodes one init frame per row; row r's posterior comes
from :func:`posterior_row_generator` (row 0's is the job's
``posterior_generator``). An img2vid job's conditioning frame is
noise-augmented from a per-job stream of its own
(:func:`noise_aug_generator`).

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


def posterior_row_generator(seed: int, row: int) -> torch.Generator:
    """The CPU generator of the VAE posterior draw of row ``row`` of job
    ``seed``, for a job whose rows each encode their own init image (a
    vid2vid chunk's frames): row 0 is :func:`posterior_generator` itself, so
    a one-frame stack draws what a one-image job draws; row r > 0 hashes
    the domain tag with the (seed, row) pair, a message of another length."""
    if row == 0:
        return posterior_generator(seed)
    digest = hashlib.sha256(_POSTERIOR_DOMAIN + struct.pack(
        "<qq", int(seed) & 0x7FFF_FFFF_FFFF_FFFF, int(row))).digest()
    return torch.Generator(device="cpu").manual_seed(
        int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF)


_NOISE_AUG_DOMAIN = b"chiaswarm-noise-aug"


def noise_aug_generator(seed: int) -> torch.Generator:
    """The CPU generator of job ``seed``'s one noise-augmentation draw (an
    img2vid job's conditioning frame, JAX's ``akey``): a hash in a domain
    of its own."""
    digest = hashlib.sha256(_NOISE_AUG_DOMAIN + struct.pack(
        "<q", int(seed) & 0x7FFF_FFFF_FFFF_FFFF)).digest()
    return torch.Generator(device="cpu").manual_seed(
        int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF)


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
