"""Blockwise flash attention (forward, inference): kernel B1 and its plain
version.

Counterpart of ``chiaswarm_tpu/ops/flash_attention.py``. The TPU package runs
a Pallas kernel (``_flash_kernel``); here the kernel is CUDA C++ written for
Hopper (``csrc/flash_attention.cu``, whose header says what bounds it and
what its design does about that), built with ``nvcc`` at first use. bf16
and fp16 run on the tensor cores (``csrc/attention_tile_sm90.cuh``, shared
with kernels B2 and B3), which round p to the input type for the P·V product only,
as ``scaled_dot_product_attention`` does; fp32 keeps the reference's fp32 p
on the CUDA cores.

- :func:`flash_attention` is the wrapper. For tensors on the CPU it runs
  :func:`flash_attention_plain`; for CUDA tensors it launches the kernel or
  raises. Nothing falls back from the GPU to the plain version.
- :func:`flash_attention_plain` repeats the blockwise running-softmax
  recurrence in PyTorch: fp32 logits and state, KV blocks padded with zeros
  and masked with the finite -1e30 past the true length, output cast to the
  input type. It is the oracle the kernel is held against on the card.
- :func:`online_softmax_update` is that recurrence with the running state
  passed in and returned; the plain version of the ring hop, kernel B2
  (``ops/ring_flash_attention.py``), is the same function.
"""

from __future__ import annotations

import ctypes

import torch

from chiaswarm_tpu_torch.ops.kernels import CSRC_DIR, CudaKernel, register

NEG_INF = -1e30  # finite stand-in: true -inf breaks exp() on fully-masked rows

#: KV block of the plain recurrence; the result depends on it only through
#: the order of float32 sums
BLOCK_KV = 512

#: head dims the kernel is instantiated for (AudioLDM 32, SD1.x 40/80/160,
#: SD2/SDXL 64, and the 128-lane width)
SUPPORTED_HEAD_DIMS = (32, 40, 64, 80, 128, 160)

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

#: dtypes B1, B2 and B3 run on the tensor cores (at head dims up to 160)
TENSOR_CORE_DTYPES = (torch.float16, torch.bfloat16)


def _bind(fn) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float, p]
    fn.restype = ctypes.c_int


KERNEL = register(CudaKernel(
    name="flash_attention",
    source=CSRC_DIR / "flash_attention.cu",
    symbol="chiaswarm_flash_attention_fwd",
    bind=_bind,
    replaces="chiaswarm_tpu/ops/flash_attention.py:117",
))


def online_softmax_update(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          m: torch.Tensor, denom: torch.Tensor,
                          acc: torch.Tensor, *, scale: float
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The running-softmax recurrence over every KV block of one K/V
    sequence: counterpart of ``online_softmax_block_update``
    (``chiaswarm_tpu/ops/flash_attention.py:84-114``), swept over blocks of
    :data:`BLOCK_KV`. B1's and B2's plain versions are this function.

    q (B, L, H, D) and k/v (B, S, H, D) in any float type; the running max
    ``m`` and denominator ``denom`` (B, H, L) and the accumulator ``acc``
    (B, L, H, D) in float32. Logits and p stay float32; v is read in
    float32. Returns the updated (m, denom, acc), new tensors in the same
    layouts; nothing is normalised."""
    s = k.shape[1]
    block_kv = BLOCK_KV  # read per call, so tests can vary it
    qf = q.float().permute(0, 2, 1, 3)          # (B, H, L, D)
    kf = k.float().permute(0, 2, 1, 3)          # (B, H, S, D)
    vf = v.float().permute(0, 2, 1, 3)
    m = m[..., None]                            # (B, H, L, 1)
    denom = denom[..., None]
    acc = acc.permute(0, 2, 1, 3)               # (B, H, L, D)
    cols = torch.arange(block_kv, device=q.device)
    for start in range(0, s, block_kv):
        kb = kf[:, :, start:start + block_kv]
        vb = vf[:, :, start:start + block_kv]
        pad = block_kv - kb.shape[2]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
        logits = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        logits = torch.where(start + cols < s, logits,
                             torch.full_like(logits, NEG_INF))
        m_cur = logits.amax(dim=-1, keepdim=True)
        m_next = torch.maximum(m, m_cur)
        alpha = torch.exp(m - m_next)
        p = torch.exp(logits - m_next)
        denom = alpha * denom + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_next
    return m[..., 0], denom[..., 0], acc.permute(0, 2, 1, 3)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float | None = None) -> torch.Tensor:
    """The blockwise recurrence in plain PyTorch over (B, L, H, D) q and
    (B, S, H, D) k/v; see the module docstring."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    b, l, h, d = q.shape
    m = torch.full((b, h, l), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, l), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, l, h, d), dtype=torch.float32, device=q.device)
    m, denom, acc = online_softmax_update(q, k, v, m, denom, acc, scale=scale)
    return (acc / denom.transpose(1, 2)[..., None]).to(q.dtype)


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse (B, L, H, D) q and (B, S, H, D) k/v that do not fit together."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B, L, H, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch, heads or head dim")
    if k.shape[1] < 1:
        raise ValueError("attention over an empty key sequence")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")


def check_16_byte_rows(kernel: str, **tensors: torch.Tensor) -> None:
    """Refuse what the tensor-core route of B1, B2 and B3 cannot load: its
    cp.async copies move 16 bytes, so every row of D must start on a
    16-byte address (the data pointer and every stride of an axis longer
    than 1 a multiple of 16 bytes)."""
    for label, t in tensors.items():
        step = 16 // t.element_size()
        strides = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.data_ptr() % 16 or any(st % step for st in strides):
            raise ValueError(
                f"{kernel} kernel runs {t.dtype} on the tensor cores, which "
                f"load rows of 16 bytes: {label} (data pointer "
                f"{t.data_ptr():#x}, strides {tuple(t.stride())}) is not "
                "16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, scale: float | None = None) -> torch.Tensor:
    """Blockwise attention over (B, L, H, D) q and (B, S, H, D) k/v.

    CPU tensors take :func:`flash_attention_plain`. CUDA tensors launch
    kernel B1 on the current stream, or raise for what it does not take.
    """
    check_qkv(q, k, v)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32, float16 or "
                         f"bfloat16, not {q.dtype}")
    b, l, h, d = q.shape
    s = k.shape[1]
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel grid takes at most 65535 "
                         f"batch*heads, got {b * h}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has no head dim {d} "
                         f"(built for {SUPPORTED_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in the head dim")
    if q.dtype in TENSOR_CORE_DTYPES:
        check_16_byte_rows("flash_attention", q=q, k=k, v=v)
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2))
    fn = KERNEL.entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[q.dtype], b, l, s, h, d, strides,
                float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(CUDA error {rc})")
    KERNEL.count_launch(q, k)
    return out
