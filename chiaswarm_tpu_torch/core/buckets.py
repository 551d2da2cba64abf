"""Shape buckets, copied by value from ``chiaswarm_tpu/core/compile_cache.py``
(``bucket_batch``, ``bucket_steps``, ``bucket_image_size``, :262-313).

The JAX package buckets shapes to bound its XLA executable cache. PyTorch
runs eagerly and has no such cache, but the port keeps the buckets so a
request is generated at the same size and batch on both backends, and the
un-bucketing contract (generate at the bucket, crop back to the request)
stays one contract.
"""

from __future__ import annotations

_POW2 = (1, 2, 4, 8, 16, 32, 64, 128)

_STEP_BUCKETS = (16, 32, 64, 128)

#: the longest ladder a lane row may carry
STEP_CAPACITY = _STEP_BUCKETS[-1]


def bucket_batch(n: int) -> int:
    """Round batch up to the next power of two."""
    if n < 1:
        raise ValueError("batch must be >= 1")
    for p in _POW2:
        if n <= p:
            return p
    raise ValueError(f"batch {n} exceeds supported maximum {_POW2[-1]}")


def bucket_steps(n: int) -> int:
    """Round a denoise step count up to the lane capacity lattice."""
    if n < 1:
        raise ValueError("steps must be >= 1")
    for cap in _STEP_BUCKETS:
        if n <= cap:
            return cap
    raise ValueError(
        f"steps {n} exceeds the lane capacity maximum {_STEP_BUCKETS[-1]}")


def bucket_image_size(height: int, width: int, *, multiple: int = 64,
                      min_size: int = 64, max_size: int = 1024) -> tuple[int, int]:
    """Snap a requested image size onto the lattice: clamp to
    [min_size, max_size], round up to ``multiple``."""

    def snap(v: int) -> int:
        v = max(min_size, min(max_size, v))
        return ((v + multiple - 1) // multiple) * multiple

    return snap(height), snap(width)
