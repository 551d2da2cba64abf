"""Ring-flash attention: kernels B2 (one ring hop) and B3 (every hop of a
ring in one launch), and the two drives over them.

Counterpart of ``chiaswarm_tpu/ops/ring_flash_attention.py``, which has the
same two drives over one recurrence: the fused TPU kernel B3
(``_fused_kernel``, all hops in one kernel, K/V sent to the neighbour chip
by remote DMA under the compute) and the scan drive ``_ring_flash_scan``,
which runs the hop kernel B2 (``_hop_kernel``) once per hop and rotates K/V
between hops.

- :func:`ring_flash_hop` is B2's wrapper: B1's blockwise recurrence over one
  K/V shard with the running (m, l, acc) state carried in and out, nothing
  normalised (``csrc/ring_flash_hop.cu``). Its plain version
  :func:`ring_flash_hop_plain` is ``ops.flash_attention.online_softmax_update``.
- :func:`ring_flash_fused` is B3's wrapper: the whole ring attention of n
  shards that share one device, one launch (``csrc/ring_flash_fused.cu``).
  Its plain version :func:`ring_flash_fused_plain` runs the same hops in
  the same order with the plain recurrence.

Both kernels have two routes. bf16 and fp16 at head dims up to
:data:`TENSOR_CORE_MAX_HEAD_DIM` run each hop on the tensor cores (B1's
tile, ``csrc/attention_tile_sm90.cuh``: p rounded to the input type for
P·V only, l summed from the fp32 p; q, k and v rows must start on 16
bytes, or the wrapper raises); fp32 and the VAE's head dim 512 keep the
CUDA-core sweep with the reference's fp32 p.
- :func:`ring_flash_attention` drives the ring over a mesh's ``seq`` axis.
  When every shard sits on q's device (a one-card mesh names ``cuda:0``
  once per shard) it calls B3; otherwise, or under
  ``CHIASWARM_RING_FLASH=scan``, it runs the scan drive over B2: q/k/v
  split along L into one shard per device, state initialised to
  m = -1e30, l = 0, acc = 0 in float32, n hops per shard with K/V rotated
  to the next shard between hops (``parallel.ring_attention.KVRing``),
  then acc / l in q's type, gathered on q's device.

Every wrapper runs its plain version for tensors on the CPU and its CUDA
C++ kernel for CUDA tensors, or raises; nothing falls back from the GPU to
a plain version.

B2's state layout: m and l are (B, H, L) float32 and acc is (B, L, H, D)
float32. The JAX package's folded (B·H, Lp, 128) lane-broadcast tiles were
a TPU tiling need; the tests unfold them at the seam.

Numerics probes (``obs/numerics.py``, under ``CHIASWARM_NUMERICS`` naming
``ring_flash``; JAX ``:345-373``): the scan drive records each shard's state
after each hop (``ring_flash.hop_rowmax``/``hop_rowsum``/``hop_acc``, step =
hop, shard = its index) and each shard's float32 output
(``ring_flash.out``). The port summarizes its logical (B, H, L) and
(B, L, H, D) state, where JAX summarizes its padded lane tiles, so the
records compare with JAX's state unfolded at the seam, not with JAX's
records. Under B3 the hops stay inside one launch: ``ring_flash.out``
records each shard's slice of its output, in q's type.
"""

from __future__ import annotations

import ctypes
import os

import torch

from chiaswarm_tpu_torch.core.mesh import DeviceMesh, ring_devices
from chiaswarm_tpu_torch.obs import numerics as _numerics
from chiaswarm_tpu_torch.ops.flash_attention import (
    NEG_INF,
    TENSOR_CORE_DTYPES,
    check_16_byte_rows,
    check_qkv,
    online_softmax_update,
)
from chiaswarm_tpu_torch.ops.kernels import CSRC_DIR, CudaKernel, register
from chiaswarm_tpu_torch.parallel.ring_attention import (
    KVRing,
    gather_shards,
    shard_sequence,
)

#: head dims B2 and B3 are instantiated for: B1's, and the VAE's single
#: 512-wide head, which rings in the mid block under a seq mesh
SUPPORTED_HEAD_DIMS = (40, 64, 80, 128, 160, 512)

#: B2's and B3's tensor-core route takes bf16 and fp16 up to this head dim;
#: above it (the VAE's 512) and in fp32 both run the CUDA-core sweep
TENSOR_CORE_MAX_HEAD_DIM = 160

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _bind(fn) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float, p]
    fn.restype = ctypes.c_int


KERNEL = register(CudaKernel(
    name="ring_flash_hop",
    source=CSRC_DIR / "ring_flash_hop.cu",
    symbol="chiaswarm_ring_flash_hop",
    bind=_bind,
    replaces="chiaswarm_tpu/ops/ring_flash_attention.py:80",
))


def _bind_fused(fn) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float, p]
    fn.restype = ctypes.c_int


FUSED_KERNEL = register(CudaKernel(
    name="ring_flash_fused",
    source=CSRC_DIR / "ring_flash_fused.cu",
    symbol="chiaswarm_ring_flash_fused",
    bind=_bind_fused,
    replaces="chiaswarm_tpu/ops/ring_flash_attention.py:152",
))


def ring_flash_hop_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                         *, scale: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2's plain version: the hop's (m, l, acc), new tensors."""
    return online_softmax_update(q, k, v, m, l, acc, scale=scale)


def _check(q, k, v, m, l, acc) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B, L, H, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    if k.shape[1] < 1:
        raise ValueError("attention over an empty key sequence")
    if m.shape != (b, h, lq) or l.shape != (b, h, lq) or acc.shape != q.shape:
        raise ValueError(f"state m {tuple(m.shape)}, l {tuple(l.shape)}, acc "
                         f"{tuple(acc.shape)} does not fit q {tuple(q.shape)}")
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise ValueError("ring state m, l and acc must be float32")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if len({t.device for t in (q, k, v, m, l, acc)}) != 1:
        raise ValueError("q, k, v and the ring state must be on one device")


def _check_kernel_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> bool:
    """What both CUDA kernels refuse: dtype, head dim, a strided D, and on
    the tensor-core route rows off 16 bytes. Returns whether the launch
    takes the tensor-core route."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes float32, float16 or bfloat16, "
                         f"not {q.dtype}")
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} kernel has no head dim {d} "
                         f"(built for {SUPPORTED_HEAD_DIMS})")
    for label, t in zip("qkv", (q, k, v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{label} must be contiguous in the head dim")
    tensor_cores = (q.dtype in TENSOR_CORE_DTYPES
                    and d <= TENSOR_CORE_MAX_HEAD_DIM)
    if tensor_cores:
        check_16_byte_rows(name, q=q, k=k, v=v)
    return tensor_cores


def ring_flash_hop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *,
                   scale: float | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring hop over (B, L, H, D) q and (B, S, H, D) k/v with the
    running state m, l (B, H, L) and acc (B, L, H, D) in float32. Returns
    the updated (m, l, acc).

    CPU tensors take :func:`ring_flash_hop_plain` (new tensors). CUDA
    tensors launch kernel B2 on the current stream, which updates m, l and
    acc IN PLACE (each block reads its own query rows' state before it
    writes them) and returns the same three tensors; it raises for what the
    kernel does not take. bf16 and fp16 up to head dim 160 take the
    tensor-core route, fp32 and head dim 512 the CUDA-core sweep."""
    _check(q, k, v, m, l, acc)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return ring_flash_hop_plain(q, k, v, m, l, acc, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_flash_hop has no kernel for {q.device}")
    if acc.stride(-1) != 1:
        raise ValueError("acc must be contiguous in the head dim")
    if _check_kernel_inputs("ring_flash_hop", q, k, v):
        # the tile moves acc rows in float2 pairs
        strides = [st for st, n in zip(acc.stride()[:-1], acc.shape[:-1])
                   if n > 1]
        if acc.data_ptr() % 8 or any(st % 2 for st in strides):
            raise ValueError(
                f"ring_flash_hop kernel runs {q.dtype} on the tensor cores, "
                f"which move acc in 8-byte pairs: acc (data pointer "
                f"{acc.data_ptr():#x}, strides {tuple(acc.stride())}) is not "
                "8-byte aligned")
    b, lq, h, d = q.shape
    s = k.shape[1]
    if b * h > 65535:
        raise ValueError(f"ring_flash_hop kernel grid takes at most 65535 "
                         f"batch*heads, got {b * h}")
    strides = (ctypes.c_int64 * 18)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        m.stride(0), m.stride(1), m.stride(2),
        l.stride(0), l.stride(1), l.stride(2),
        acc.stride(0), acc.stride(1), acc.stride(2))
    fn = KERNEL.entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
                l.data_ptr(), acc.data_ptr(), _DTYPE_CODES[q.dtype],
                b, lq, s, h, d, strides, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"ring_flash_hop kernel launch failed "
                           f"(CUDA error {rc})")
    KERNEL.count_launch(q, k)
    return m, l, acc


def ring_flash_fused_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, shards: int, scale: float) -> torch.Tensor:
    """B3's plain version: for each of ``shards`` query shards, the plain
    recurrence over the K/V shards in ring order (hop h of shard i reads
    the block that started on shard i - h), then acc / l in q's type."""
    b, length, h, d = q.shape
    lq, ls = length // shards, k.shape[1] // shards
    out = torch.empty_like(q)
    for i in range(shards):
        qs = q[:, i * lq:(i + 1) * lq]
        state = (torch.full((b, h, lq), NEG_INF, device=q.device),
                 torch.zeros((b, h, lq), device=q.device),
                 torch.zeros(qs.shape, device=q.device))
        for hop in range(shards):
            j = (i - hop) % shards
            state = online_softmax_update(
                qs, k[:, j * ls:(j + 1) * ls], v[:, j * ls:(j + 1) * ls],
                *state, scale=scale)
        _, lsum, acc = state
        out[:, i * lq:(i + 1) * lq] = acc / lsum.transpose(1, 2)[..., None]
    return out


def ring_flash_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     shards: int, scale: float | None = None) -> torch.Tensor:
    """Full (non-causal) attention over (B, L, H, D) q and (B, S, H, D) k/v
    as a ring of ``shards`` shards on q's device, every hop in one launch of
    kernel B3; L and S must split into the shards.

    CPU tensors take :func:`ring_flash_fused_plain`. CUDA tensors launch B3
    on the current stream, with K/V slots, the running state and the
    kernel's counters in a workspace allocated per call; it raises for what
    the kernel does not take."""
    check_qkv(q, k, v)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    b, length, h, d = q.shape
    s = k.shape[1]
    if shards < 1 or length % shards or s % shards:
        raise ValueError(f"{length} query and {s} key tokens do not split "
                         f"into {shards} ring shards")
    if q.device.type == "cpu":
        return ring_flash_fused_plain(q, k, v, shards=shards, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_flash_fused has no kernel for {q.device}")
    _check_kernel_inputs("ring_flash_fused", q, k, v)
    lq, ls = length // shards, s // shards
    dev = q.device
    out = torch.empty((b, length, h, d), dtype=q.dtype, device=dev)
    slots = shards if shards > 1 else 0  # one shard never rotates
    k_slots, v_slots = (torch.empty((slots, 2, b * h, ls, d), dtype=q.dtype,
                                    device=dev) for _ in range(2))
    m, lsum = (torch.empty((slots, b * h, lq), device=dev) for _ in range(2))
    acc = torch.empty((slots, b * h, lq, d), device=dev)
    flags = torch.zeros(1 + 2 * shards * b * h * shards, dtype=torch.int32,
                        device=dev)
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2))
    fn = FUSED_KERNEL.entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                k_slots.data_ptr(), v_slots.data_ptr(), m.data_ptr(),
                lsum.data_ptr(), acc.data_ptr(), flags.data_ptr(),
                _DTYPE_CODES[q.dtype], b, h, shards, lq, ls, d, strides,
                float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"ring_flash_fused kernel launch failed "
                           f"(code {rc})")
    FUSED_KERNEL.count_launch(q, k)
    return out


def _mode() -> str:
    """CHIASWARM_RING_FLASH: ``scan`` runs the scan drive over B2; unset or
    ``fused``, a ring whose shards all sit on q's device runs B3."""
    return os.environ.get("CHIASWARM_RING_FLASH", "").strip().lower()


def _placed(dev: torch.device) -> torch.device:
    """``dev`` with its index: ``cuda`` without one is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mesh: DeviceMesh, scale: float | None = None
                         ) -> torch.Tensor:
    """Full (non-causal) attention over (B, L, H, D) q and (B, S, H, D) k/v,
    L and S sharded over ``mesh``'s ``seq`` axis; the result, in q's type,
    lands on q's device. B3 when every shard sits on q's device, else (and
    under ``CHIASWARM_RING_FLASH=scan``) the scan drive over B2."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    devices = ring_devices(mesh)
    n = len(devices)
    mode = _mode()
    home = _placed(q.device)
    one_device = all(_placed(dev) == home for dev in devices)
    tap_on = _numerics.enabled_for("ring_flash")
    if mode != "scan" and one_device:
        out = ring_flash_fused(q, k, v, shards=n, scale=scale)
        if tap_on:
            step = q.shape[1] // n
            for i in range(n):
                _numerics.tap("ring_flash.out",
                              out[:, i * step:(i + 1) * step], shard=i)
        return out
    if mode == "fused":
        raise NotImplementedError(
            "CHIASWARM_RING_FLASH=fused asks for kernel B3 over a ring whose "
            f"shards sit on {sorted({str(dev) for dev in devices})}: B3 runs "
            "one launch on q's device, and a ring over distinct cards (peer "
            "stores into the neighbour's slots) is not ported yet. Unset it "
            "to run the scan drive over kernel B2.")
    b, _, h, d = q.shape
    q_shards = shard_sequence(q, devices)
    ring = KVRing(k, v, devices)
    states = []
    for qs in q_shards:
        row = (b, h, qs.shape[1])
        states.append((
            torch.full(row, NEG_INF, dtype=torch.float32, device=qs.device),
            torch.zeros(row, dtype=torch.float32, device=qs.device),
            torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)))
    for hop in range(n):
        for i, qs in enumerate(q_shards):
            states[i] = ring_flash_hop(qs, *ring.current[i], *states[i],
                                       scale=scale)
            if tap_on:
                for probe, state in zip(("ring_flash.hop_rowmax",
                                         "ring_flash.hop_rowsum",
                                         "ring_flash.hop_acc"), states[i]):
                    _numerics.tap(probe, state, step=hop, shard=i)
        if hop < n - 1:
            ring.rotate()
    outs = [acc / lsum.transpose(1, 2)[..., None] for _, lsum, acc in states]
    if tap_on:
        for i, out in enumerate(outs):
            _numerics.tap("ring_flash.out", out, shard=i)
    return gather_shards(outs, q)
