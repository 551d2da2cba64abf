"""Ring attention over the ``seq`` axis of a device mesh, counterpart of
``chiaswarm_tpu/parallel/ring_attention.py``.

The JAX function runs inside ``shard_map`` on per-device shards and rotates
K/V with ``lax.ppermute``. The port drives every device from one process:
:func:`ring_attention` takes the whole (B, L, H, D) tensors on the mesh's
lead device, places query shard i and K/V shard i on the i-th device of the
``seq`` axis (:func:`shard_sequence`), runs n hops, and after each hop but
the last copies every shard's K/V into the next shard's receive buffer
(:class:`KVRing`). The outputs come back to the lead device.

The per-hop math keeps the JAX numerics: float32 logits, p cast to
``v.dtype`` before the P·V product with float32 accumulation, float32
carries combined across hops by the running max. Under
``CHIASWARM_NUMERICS`` naming ``ring`` each shard records its hop's partials
(``ring.hop_partial``/``hop_rowmax``/``hop_rowsum``, step = hop) and its
float32 output (``ring.out``), in JAX's layouts (JAX ``:89-120``). It is the
port's exactness oracle for the ring, as in the JAX package, and no route of
the attention dispatcher: every ring call goes through
``ops/ring_flash_attention.py``, whose scan drive over kernel B2 shares
:func:`shard_sequence`, :class:`KVRing` and :func:`gather_shards`.
"""

from __future__ import annotations

import torch

from chiaswarm_tpu_torch.core.mesh import DeviceMesh, ring_devices
from chiaswarm_tpu_torch.obs import numerics as _numerics

NEG_INF = -1e30


def shard_sequence(x: torch.Tensor, devices: list[torch.device]
                   ) -> list[torch.Tensor]:
    """Split ``x`` (B, L, ...) along L into ``len(devices)`` shards, shard i
    on ``devices[i]``. A shard already on its device stays a view of ``x``
    (strided across the batch); one on another device is copied there."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"sequence of {x.shape[1]} tokens does not split "
                         f"into {n} ring shards")
    step = x.shape[1] // n
    return [x[:, i * step:(i + 1) * step].to(dev)
            for i, dev in enumerate(devices)]


class KVRing:
    """K/V shards travelling around the ring: at hop h, ``current[i]`` is
    the (k, v) pair that started on shard (i - h) mod n.

    The first hop reads the caller's tensors in place. :meth:`rotate`
    copies shard i's pair into the contiguous receive buffer of shard
    i + 1, on that shard's device; two sets of receive buffers alternate.
    ``Tensor.copy_`` between two CUDA devices orders itself against both
    devices' current streams, so a hop launched after :meth:`rotate` on the
    receiving device reads the copied data; on one device every launch
    and copy is in stream order."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 devices: list[torch.device]) -> None:
        self.devices = devices
        self.current = list(zip(shard_sequence(k, devices),
                                shard_sequence(v, devices)))
        self._spare: list[tuple[torch.Tensor, torch.Tensor]] | None = None
        self._owned = False  # whether ``current`` is one of our buffers

    def _buffers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                      for t in pair)
                for pair, dev in zip(self.current, self.devices)]

    def rotate(self) -> None:
        recv = self._spare if self._spare is not None else self._buffers()
        n = len(self.devices)
        for i, (k_blk, v_blk) in enumerate(self.current):
            k_dst, v_dst = recv[(i + 1) % n]
            k_dst.copy_(k_blk)
            v_dst.copy_(v_blk)
        self._spare = self.current if self._owned else None
        self.current, self._owned = recv, True


def _partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float):
    """Unnormalised attention over one KV block: o = exp(logits - m) @ v,
    m = rowmax, l = rowsum; o (B, L, H, D) fp32, m/l (B, H, L) fp32."""
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhls,bshd->blhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: DeviceMesh, scale: float | None = None
                   ) -> torch.Tensor:
    """Full (non-causal) attention over (B, L, H, D) q and (B, S, H, D) k/v,
    L and S sharded over ``mesh``'s ``seq`` axis; the result, in q's type,
    lands on q's device."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    devices = ring_devices(mesh)
    n = len(devices)
    b, l, h, d = q.shape
    q_shards = shard_sequence(q, devices)
    ring = KVRing(k, v, devices)
    tap_on = _numerics.enabled_for("ring")
    carries = []
    for qs in q_shards:
        o0 = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
        zrow = torch.zeros((b, h, qs.shape[1]), dtype=torch.float32,
                           device=qs.device)
        carries.append((o0, zrow + NEG_INF, zrow))
    for hop in range(n):
        for i, qs in enumerate(q_shards):
            o_acc, m_acc, l_acc = carries[i]
            o_i, m_i, l_i = _partial_attention(qs, *ring.current[i], scale)
            if tap_on:
                for probe, part in (("ring.hop_partial", o_i),
                                    ("ring.hop_rowmax", m_i),
                                    ("ring.hop_rowsum", l_i)):
                    _numerics.tap(probe, part, step=hop, shard=i)
            m_new = torch.maximum(m_acc, m_i)
            a_old = torch.exp(m_acc - m_new)
            a_new = torch.exp(m_i - m_new)
            # (B, H, L) -> (B, L, H, 1) to scale the (B, L, H, D) partials
            o_acc = (o_acc * a_old.transpose(1, 2)[..., None]
                     + o_i * a_new.transpose(1, 2)[..., None])
            carries[i] = (o_acc, m_new, l_acc * a_old + l_i * a_new)
        if hop < n - 1:
            ring.rotate()
    outs = [o / lsum.transpose(1, 2)[..., None] for o, _, lsum in carries]
    if tap_on:
        for i, out in enumerate(outs):
            _numerics.tap("ring.out", out, shard=i)
    return gather_shards(outs, q)


def gather_shards(shards: list[torch.Tensor], like: torch.Tensor
                  ) -> torch.Tensor:
    """Concatenate float32 shard outputs along L into a tensor of
    ``like``'s shape, type and device."""
    out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    step = like.shape[1] // len(shards)
    for i, shard in enumerate(shards):
        out[:, i * step:(i + 1) * step] = shard.to(like.dtype)
    return out
