"""Attention dispatch, counterpart of ``chiaswarm_tpu/ops/attention.py``.

One function, :func:`attention`, over (B, L, H, D) queries and (B, S, H, D)
keys/values, with the JAX package's ``impl`` kinds:

- ``"xla"``   — plain matmul-softmax, mirroring ``_xla_attention``: fp32
                logits, softmax weights cast to the input type before the V
                product. Always correct; the reference for the kernel tests.
                Past :data:`PLAIN_LOGITS_BYTES` of fp32 logits it runs the
                queries in blocks whose logits fit under that bound (each
                query row's softmax reads that row alone, so it is the same
                function); at or below the bound it is one call, as before.
                The f = 4 VAE's mid block at a 256x256 latent (65,536
                tokens) would need 17 GiB of logits at once.
- ``"flash"`` — kernel B1 (ops/flash_attention.py): the CUDA kernel on a
                CUDA tensor, its plain blockwise version on a CPU tensor.
- ``"ring"`` / ``"ring_flash"`` — sequence-parallel kinds over the mesh of
                an active ``parallel.context.sequence_parallel``; both run
                the one ring drive, ``ops/ring_flash_attention.py`` (kernel
                B3 when the shards share q's device, else the scan drive
                over kernel B2; plain versions on CPU tensors).
- ``"auto"``  — B1 for CUDA tensors when both L and S are >= 1024, else
                ``"xla"``.

Sequence parallelism comes before the local choice, for every ``impl``
(the VAE's pinned ``"xla"`` included), as the JAX ``_try_ring`` does: under a
mesh with ``seq`` = n > 1, a self-attention (S == L) with L divisible by n
rings when L >= :data:`RING_MIN_TOKENS` or when ``impl`` is a ring kind.
Every ring call takes the route ``"ring_flash"``, CPU tensors included, so
the CPU tests drive the code the card serves. Cross-attention, an
indivisible L and small self-attentions stay local. An explicit ring kind
with no active mesh raises. The plain ring of ``parallel/ring_attention.py``
is the tests' oracle and no route of the dispatcher.

``CHIASWARM_ATTENTION=<kind>`` steers the ``auto`` pick as in the JAX
package (explicit ``impl=`` callers are never steered) but never moves card
work off a kernel: where ``auto`` would launch B1 and the steered route
would not, it raises; under a seq mesh every kind rings alike. Ring kinds
in the knob are advisory: with no mesh they fall back to the ``auto``
pick.

Low-precision activations (``CHIASWARM_ACTIVATIONS=int8|fp8``, off by
default): q, k and v are fake-quantized per tensor at entry, before any
route, as JAX's dispatcher does (``:192-199``); B1 and the rings then take
the dequantized tensors in their own dtype (``convert/quantize.py``).

Numerics probes (``obs/numerics.py``, off unless ``CHIASWARM_NUMERICS``
names them; JAX ``:201-216``): ``attn.q``, ``attn.k`` and ``attn.v`` on what
the route consumes (after the fake-quant) and ``attn.out`` on its result,
each with ``step`` = the call-site index (``TAPS.trace_seq("attn")``), around
every route: B1, the rings (B3 or the scan drive over B2) and the plain
path. Off, the dispatcher reads the environment and touches no tensor.
"""

from __future__ import annotations

import os
from typing import Literal

import torch

from chiaswarm_tpu_torch.convert.quantize import (
    activations_format,
    fake_quant_activation,
)
from chiaswarm_tpu_torch.core.mesh import seq_size
from chiaswarm_tpu_torch.obs import numerics as _numerics
from chiaswarm_tpu_torch.ops.flash_attention import flash_attention
from chiaswarm_tpu_torch.ops.ring_flash_attention import ring_flash_attention
from chiaswarm_tpu_torch.parallel.context import active_seq_mesh, note_ring_call

AttentionImpl = Literal["auto", "xla", "flash", "ring", "ring_flash"]

_IMPLS = ("auto", "xla", "flash", "ring", "ring_flash")
_RING_KINDS = ("ring", "ring_flash")

#: the token count from which ``auto`` takes the flash kernel
FLASH_MIN_TOKENS = 1024

#: the token count from which self-attention rings under a seq mesh
RING_MIN_TOKENS = 1024

#: the most fp32 logits (B·H·L·S elements, 4 bytes each) the plain path
#: holds at once; past it, the queries go in blocks (1 GiB: SDXL's VAE mid
#: block at 16,384 tokens is exactly this and stays one call)
PLAIN_LOGITS_BYTES = 1 << 30


def _env_impl() -> str | None:
    """CHIASWARM_ATTENTION: operator steer of the ``auto`` pick.
    Explicit ``impl=`` callers are never overridden."""
    raw = os.environ.get("CHIASWARM_ATTENTION", "").strip().lower()
    return raw if raw in _IMPLS else None


def _plain_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    # (B, L, H, D) x (B, S, H, D) -> (B, H, L, S), logits in fp32
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
    weights = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshd->blhd", weights, v)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float,
                  max_logits_bytes: int = PLAIN_LOGITS_BYTES) -> torch.Tensor:
    """Plain attention with the numerics of the JAX ``_xla_attention``, in
    blocks of queries whose fp32 logits stay within ``max_logits_bytes``
    when all of them would not."""
    b, l, h, _ = q.shape
    row_bytes = b * h * k.shape[1] * 4
    if l * row_bytes <= max_logits_bytes:
        return _plain_block(q, k, v, scale)
    rows = max(1, max_logits_bytes // row_bytes)
    return torch.cat([_plain_block(q[:, i:i + rows], k, v, scale)
                      for i in range(0, l, rows)], dim=1)


def _route_kind(kind: str, env_forced: bool, cuda: bool, l: int, s: int,
                sp: int) -> str:
    """The route of one call for an already-steered ``kind``."""
    if (sp > 1 and s == l and l % sp == 0
            and (kind in _RING_KINDS or l >= RING_MIN_TOKENS)):
        return "ring_flash"
    if kind in _RING_KINDS:
        if sp == 1 and not env_forced:
            raise ValueError(
                f"impl={kind!r} requires an active sequence-parallel mesh "
                "(parallel.context.sequence_parallel)")
        kind = "auto"  # advisory knob, or a shape the ring does not take
    if kind != "auto":
        return kind
    kernel = cuda and l >= FLASH_MIN_TOKENS and s >= FLASH_MIN_TOKENS
    return "flash" if kernel else "xla"


def _route(impl: str, device_type: str, l: int, s: int, sp: int = 1) -> str:
    """The path one call takes: ``"flash"``, ``"xla"`` or ``"ring_flash"``,
    under a ``seq`` axis of ``sp`` (1: no active mesh); see the module
    docstring for the rules."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    cuda = device_type == "cuda"
    route = _route_kind(impl, False, cuda, l, s, sp)
    env = _env_impl() if impl == "auto" else None
    if env is None:
        return route
    steered = _route_kind(env, True, cuda, l, s, sp)
    if route == "flash" and steered != "flash":
        raise ValueError(
            f"CHIASWARM_ATTENTION={env} would move a CUDA attention over "
            f"{l}x{s} tokens off kernel B1; unset it")
    return steered


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float | None = None,
              impl: AttentionImpl = "auto") -> torch.Tensor:
    """Multi-head scaled dot-product attention, (B, L, H, D) layout."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B, L, H, D) tensors, got {tuple(q.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    fmt = activations_format()
    if fmt != "off":
        q, k, v = (fake_quant_activation(t, fmt, tag=f"attn.{name}")
                   for t, name in zip((q, k, v), "qkv"))
    mesh = active_seq_mesh()
    route = _route(impl, q.device.type, q.shape[1], k.shape[1], seq_size(mesh))
    idx = None
    if _numerics.enabled_for("attn"):
        idx = _numerics.TAPS.trace_seq("attn")
        q = _numerics.tap("attn.q", q, step=idx)
        k = _numerics.tap("attn.k", k, step=idx)
        v = _numerics.tap("attn.v", v, step=idx)
    if route == "ring_flash":
        note_ring_call(route, q.shape)
        out = ring_flash_attention(q, k, v, mesh=mesh, scale=scale)
    elif route == "flash":
        out = flash_attention(q, k, v, scale=scale)
    else:
        out = xla_attention(q, k, v, scale)
    if idx is not None:
        out = _numerics.tap("attn.out", out, step=idx)
    return out
