"""Tests of the port that need an NVIDIA GPU: the CUDA kernels B1 (flash
attention), B2 (one ring hop with carried state) and B3 (a whole ring in one
launch) against their plain PyTorch versions, their refusals, and the
dispatcher's routes to them (B3, and B2 under the scan drive, through a
4-shard ring on one card), B1 and B3 at the batches a continuous-batching
lane gives them (2W rows for a lane of W), and one lane step against each
row's solo step on a small float32 UNet through B1.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips, with a reason, where ``torch.cuda.is_available()`` is
false. The file imports neither JAX nor the JAX package, so it also runs on
the machine with the card, where JAX is not installed and the suite's
conftest cannot load:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances are those of the kernel phase of chip_smoke.py: 4e-3 for bf16
and fp16 (kernel and plain version round the same fp32 sums to the output
type, and the tensor-core route of B1, B2 and B3 also rounds p to the
input type for the P·V product, about 1e-3 at outputs near 0.25), 2e-4 for
fp32 with TF32 off (only the order of float32 sums differs). B2's
normalised output acc / l is held to the same bars and to 1e-2 relative
L2; its m to 1e-5 and its l to a relative 1e-4 (float32 sums in another
order). B3's output is held to B1's bars.
"""

from __future__ import annotations

import pytest
import torch

from chiaswarm_tpu_torch.ops import attention as tattn
from chiaswarm_tpu_torch.ops.flash_attention import (
    KERNEL,
    SUPPORTED_HEAD_DIMS,
    flash_attention,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape_q, shape_kv, dtype, device, seed=7):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape_q, generator=gen).to(device, dtype),
            torch.randn(shape_kv, generator=gen).to(device, dtype),
            torch.randn(shape_kv, generator=gen).to(device, dtype))


@pytest.mark.parametrize("b,l,s,h,d,dtype,tol", [
    (2, 4096, 4096, 8, 40, torch.bfloat16, 4e-3),
    (2, 1024, 1024, 8, 80, torch.bfloat16, 4e-3),
    (1, 1000, 1000, 2, 64, torch.float32, 2e-4),
    (2, 300, 300, 2, 160, torch.float32, 2e-4),
    (1, 77, 130, 3, 128, torch.float16, 4e-3),
])
def test_kernel_matches_plain(cuda_device, b, l, s, h, d, dtype, tol):
    q, k, v = _qkv((b, l, h, d), (b, s, h, d), dtype, cuda_device)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", TENSOR_CORE_DTYPES)
@pytest.mark.parametrize("l,s", [(1000, 1000), (300, 170)])
def test_tensor_core_kernel_matches_plain(cuda_device, d, dtype, l, s):
    """Every head dim in bf16 and fp16 on the tensor-core route, at lengths
    that are no multiple of the 64-row query tile or the K/V tile."""
    q, k, v = _qkv((2, l, 2, d), (2, s, 2, d), dtype, cuda_device, seed=d)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2


@pytest.mark.parametrize("dtype", TENSOR_CORE_DTYPES)
def test_tensor_core_kernel_reads_strided_query_shards(cuda_device, dtype):
    """A query shard of a batch of two, as a ring hands it on: strided
    across the batch and offset along L; k/v heads-major."""
    full = _qkv((2, 4 * 250, 4, 80), (2, 333, 4, 80), dtype, cuda_device)
    q = full[0][:, 250:500]
    k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in full[1:])
    assert not q.is_contiguous() and not k.is_contiguous()
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v).float(),
                               rtol=0, atol=4e-3)


def test_tensor_core_kernel_refuses_misaligned_rows(cuda_device):
    """The tensor-core route loads 16-byte rows: a data pointer or a stride
    off 16 bytes raises rather than falling back. fp32 takes the CUDA-core
    sweep, which has no such need."""
    buf = torch.zeros(1 + 64 * 40, device=cuda_device, dtype=torch.bfloat16)
    shifted = buf[1:].view(1, 64, 1, 40)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(shifted, shifted, shifted)
    ok = torch.zeros(1, 64, 1, 40, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(ok, shifted, ok)
    # a sequence stride of 44 elements (88 bytes)
    odd = torch.zeros(1, 64, 44, device=cuda_device,
                      dtype=torch.float16)[..., :40].unsqueeze(2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(odd, odd, odd)
    fp32 = torch.zeros(1 + 64 * 40, device=cuda_device)[1:].view(1, 64, 1, 40)
    assert fp32.data_ptr() % 16
    before = KERNEL.launches
    flash_attention(fp32, fp32, fp32)
    assert KERNEL.launches == before + 1


def test_kernel_reads_strided_inputs(cuda_device):
    """Heads-major storage viewed as (B, L, H, D): only D is contiguous."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv((1, 300, 4, 40), (1, 200, 4, 40), torch.float32,
                             cuda_device))
    assert not q.is_contiguous() and q.stride(-1) == 1
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-4)


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 1, 48, device=cuda_device)
    assert 48 not in SUPPORTED_HEAD_DIMS
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    qd = torch.zeros(1, 8, 1, 40, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        flash_attention(qd, qd, qd)
    strided = torch.zeros(1, 8, 1, 80, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(strided, strided, strided)


def test_auto_routes_long_cuda_sequences_through_the_kernel(cuda_device,
                                                            monkeypatch):
    monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    long_q, long_k, long_v = _qkv((1, 1024, 2, 40), (1, 1024, 2, 40),
                                  torch.bfloat16, cuda_device)
    before = KERNEL.launches
    out = tattn.attention(long_q, long_k, long_v)
    assert KERNEL.launches == before + 1
    ref = tattn.attention(long_q, long_k, long_v, impl="xla")
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
    short = _qkv((1, 1023, 2, 40), (1, 77, 2, 40), torch.bfloat16, cuda_device)
    tattn.attention(*short)
    assert KERNEL.launches == before + 1  # below the bar: the plain path


def test_env_knob_cannot_move_long_cuda_sequences_off_the_kernel(
        cuda_device, monkeypatch):
    monkeypatch.setenv("CHIASWARM_ATTENTION", "xla")
    q, k, v = _qkv((1, 1024, 2, 40), (1, 1024, 2, 40), torch.bfloat16,
                   cuda_device)
    before = KERNEL.launches
    with pytest.raises(ValueError, match="off kernel B1"):
        tattn.attention(q, k, v)
    assert KERNEL.launches == before
    monkeypatch.setenv("CHIASWARM_ATTENTION", "flash")
    tattn.attention(q, k, v)
    assert KERNEL.launches == before + 1


# ---------------------------------------------------------------------------
# kernel B2, one ring hop with carried state (ops/ring_flash_attention.py)


def _hop_inputs(b, l, s, h, d, dtype, device, shards=4, seed=11):
    """Query shard 1 of a (B, shards*L, H, D) tensor (strided across the
    batch, as the ring hands it to B2), a K/V shard, and the non-trivial
    state a plain hop over another K/V shard leaves behind."""
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        ring_flash_hop_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(seed)
    full_q = torch.randn((b, shards * l, h, d), generator=gen).to(device, dtype)
    q = full_q[:, l:2 * l]
    k0, v0, k, v = (torch.randn((b, s, h, d), generator=gen).to(device, dtype)
                    for _ in range(4))
    state = (torch.full((b, h, l), -1e30, device=device),
             torch.zeros((b, h, l), device=device),
             torch.zeros((b, l, h, d), device=device))
    state = ring_flash_hop_plain(q, k0, v0, *state, scale=d ** -0.5)
    return q, k, v, state


def _held_hop(got, want, tol=4e-3):
    """B2's state against its plain version: m to 1e-5, l to a relative
    1e-4, and the normalised output acc / l to ``tol`` max abs and 1e-2
    relative L2."""
    m, lsum, acc = got
    torch.testing.assert_close(m, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lsum, want[1], rtol=1e-4, atol=0)
    out = acc / lsum.transpose(1, 2)[..., None]
    ref = want[2] / want[1].transpose(1, 2)[..., None]
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-2


@pytest.mark.parametrize("b,l,s,h,d,dtype,tol", [
    (2, 1024, 1024, 8, 40, torch.bfloat16, 4e-3),   # UNet 64x64 level shard
    (2, 256, 256, 8, 80, torch.bfloat16, 4e-3),     # UNet 32x32 level shard
    (1, 1024, 1024, 1, 512, torch.bfloat16, 4e-3),  # VAE mid block shard
    (1, 300, 170, 2, 64, torch.float32, 2e-4),      # ragged, fp32
])
def test_ring_hop_kernel_matches_plain(cuda_device, b, l, s, h, d, dtype, tol):
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v, state = _hop_inputs(b, l, s, h, d, dtype, cuda_device)
    # a shard of a batch of 2 is strided across the batch
    assert q.stride(-1) == 1 and q.is_contiguous() == (b == 1)
    want = tring.ring_flash_hop_plain(q, k, v, *state, scale=d ** -0.5)
    m, lsum, acc = (t.clone() for t in state)
    before = tring.KERNEL.launches
    got = tring.ring_flash_hop(q, k, v, m, lsum, acc)
    torch.cuda.synchronize()
    assert tring.KERNEL.launches == before + 1
    # the state is updated in place
    assert all(g is t for g, t in zip(got, (m, lsum, acc)))
    _held_hop(got, want, tol)


def test_ring_hop_kernel_refuses_what_it_does_not_take(cuda_device):
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v, state = _hop_inputs(1, 64, 64, 1, 40, torch.float32, cuda_device)
    q48 = torch.zeros(1, 8, 1, 48, device=cuda_device)
    st48 = (torch.zeros(1, 1, 8, device=cuda_device),) * 2 + (
        torch.zeros(1, 8, 1, 48, device=cuda_device),)
    with pytest.raises(ValueError, match="head dim"):
        tring.ring_flash_hop(q48, q48, q48, *st48)
    m, lsum, acc = state
    with pytest.raises(ValueError, match="float32"):
        tring.ring_flash_hop(q, k, v, m.half(), lsum, acc)
    strided = torch.zeros(1, 64, 1, 80, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tring.ring_flash_hop(q, k, v, m, lsum, strided)


@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", TENSOR_CORE_DTYPES)
@pytest.mark.parametrize("l,s", [(1000, 1000), (300, 170)])
def test_tensor_core_ring_hop_matches_plain(cuda_device, d, dtype, l, s):
    """B2's tensor-core route at every head dim in bf16 and fp16: a query
    shard strided across a batch of two, lengths no multiple of any tile, a
    non-trivial incoming state, updated in place."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v, state = _hop_inputs(2, l, s, 2, d, dtype, cuda_device, seed=d)
    assert not q.is_contiguous()
    want = tring.ring_flash_hop_plain(q, k, v, *state, scale=d ** -0.5)
    m, lsum, acc = (t.clone() for t in state)
    before = tring.KERNEL.launches
    got = tring.ring_flash_hop(q, k, v, m, lsum, acc)
    torch.cuda.synchronize()
    assert tring.KERNEL.launches == before + 1
    assert all(g is t for g, t in zip(got, (m, lsum, acc)))
    assert torch.isfinite(acc).all()
    _held_hop(got, want)


def test_tensor_core_ring_hop_refuses_misaligned_rows(cuda_device):
    """The tensor-core route loads 16-byte rows of q, k and v and moves acc
    in 8-byte pairs: a pointer or a stride off those raises rather than
    falling back, and nothing launches. fp32 takes the sweep, which reads
    any element."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v, (m, lsum, acc) = _hop_inputs(1, 64, 64, 1, 40, torch.bfloat16,
                                          cuda_device)
    shifted = torch.zeros(1 + 64 * 40, device=cuda_device,
                          dtype=torch.bfloat16)[1:].view(1, 64, 1, 40)
    acc_shifted = torch.zeros(1 + 64 * 40, device=cuda_device)[1:].view(
        1, 64, 1, 40)
    before = tring.KERNEL.launches
    for args in ((shifted, k, v, m, lsum, acc), (q, k, shifted, m, lsum, acc)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tring.ring_flash_hop(*args)
    with pytest.raises(ValueError, match="8-byte aligned"):
        tring.ring_flash_hop(q, k, v, m, lsum, acc_shifted)
    assert tring.KERNEL.launches == before
    q32 = torch.zeros(1 + 64 * 40, device=cuda_device)[1:].view(1, 64, 1, 40)
    assert q32.data_ptr() % 16
    tring.ring_flash_hop(q32, q32, q32, m, lsum, acc_shifted)
    assert tring.KERNEL.launches == before + 1


def test_scan_drive_over_b2_matches_b3_on_one_card(cuda_device, monkeypatch):
    """At the UNet's 64x64 level (the 4-shard ring of (2,4096,8,40) bf16)
    the scan drive, 16 launches of B2's tile, and B3, one launch of the
    same tile hop by hop, agree within the kernel bars."""
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    monkeypatch.setenv("CHIASWARM_RING_FLASH", "scan")
    mesh = build_mesh(MeshSpec({"seq": 4}), devices=[cuda_device] * 4)
    q, k, v = _qkv((2, 4096, 8, 40), (2, 4096, 8, 40), torch.bfloat16,
                   cuda_device)
    b2, b3 = tring.KERNEL.launches, tring.FUSED_KERNEL.launches
    scan = tring.ring_flash_attention(q, k, v, mesh=mesh)
    fused = tring.ring_flash_fused(q, k, v, shards=4)
    torch.cuda.synchronize()
    assert (tring.KERNEL.launches - b2, tring.FUSED_KERNEL.launches - b3) == (
        16, 1)
    torch.testing.assert_close(scan.float(), fused.float(), rtol=0, atol=4e-3)
    rel = ((scan.float() - fused.float()).norm() / fused.float().norm()).item()
    assert rel <= 1e-2


def test_one_card_ring_runs_b2_and_matches_unsharded(cuda_device,
                                                     monkeypatch):
    """The 4-shard scan drive on one card (cuda:0 named four times) at the
    UNet's 64x64 level: 16 B2 launches, no B1, and the unsharded answer."""
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring
    from chiaswarm_tpu_torch.parallel.context import sequence_parallel

    monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    monkeypatch.setenv("CHIASWARM_RING_FLASH", "scan")
    mesh = build_mesh(MeshSpec({"seq": 4}), devices=[cuda_device] * 4)
    q, k, v = _qkv((2, 4096, 8, 40), (2, 4096, 8, 40), torch.bfloat16,
                   cuda_device)
    b1, b2 = KERNEL.launches, tring.KERNEL.launches
    with sequence_parallel(mesh):
        out = tattn.attention(q, k, v)
    torch.cuda.synchronize()
    assert (KERNEL.launches - b1, tring.KERNEL.launches - b2) == (0, 16)
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)


# ---------------------------------------------------------------------------
# kernel B3, every hop of a ring in one launch (ops/ring_flash_attention.py)


@pytest.mark.parametrize("b,l,s,h,d,shards,dtype,tol", [
    (2, 4096, 4096, 8, 40, 4, torch.bfloat16, 4e-3),   # UNet 64x64 level
    (2, 1024, 1024, 8, 80, 4, torch.bfloat16, 4e-3),   # UNet 32x32 level
    (1, 4096, 4096, 1, 512, 4, torch.bfloat16, 4e-3),  # VAE mid block
    (1, 600, 680, 2, 64, 4, torch.float32, 2e-4),      # ragged, S != L
    (2, 390, 390, 3, 128, 3, torch.float16, 4e-3),     # three shards
    (1, 77, 130, 2, 160, 1, torch.float32, 2e-4),      # one shard: no rotation
])
def test_fused_ring_kernel_matches_plain(cuda_device, b, l, s, h, d, shards,
                                         dtype, tol):
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    # heads-major storage viewed as (B, L, H, D): strided q/k/v
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv((b, l, h, d), (b, s, h, d), dtype, cuda_device))
    before = tring.FUSED_KERNEL.launches
    out = tring.ring_flash_fused(q, k, v, shards=shards)
    torch.cuda.synchronize()
    assert tring.FUSED_KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = tring.ring_flash_fused_plain(q, k, v, shards=shards,
                                         scale=d ** -0.5)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=tol)
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v).float(),
                               rtol=0, atol=tol)


def test_fused_ring_kernel_is_repeatable(cuda_device):
    """Two launches over the same inputs agree bit for bit: the counters
    order every slot write before its read, whatever the block schedule."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v = _qkv((2, 1024, 4, 40), (2, 1024, 4, 40), torch.bfloat16,
                   cuda_device)
    outs = [tring.ring_flash_fused(q, k, v, shards=8) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", TENSOR_CORE_DTYPES)
def test_tensor_core_fused_ring_matches_plain(cuda_device, d, dtype):
    """B3's tensor-core route at every head dim in bf16 and fp16: 4 shards
    of 250 query and 170 key rows (no multiple of any tile), batch 2, so
    every query shard is strided across the batch."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v = _qkv((2, 1000, 2, d), (2, 680, 2, d), dtype, cuda_device,
                   seed=d + 1)
    before = tring.FUSED_KERNEL.launches
    out = tring.ring_flash_fused(q, k, v, shards=4)
    torch.cuda.synchronize()
    assert tring.FUSED_KERNEL.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    plain = tring.ring_flash_fused_plain(q, k, v, shards=4, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - plain.float()).norm() / plain.float().norm()).item()
    assert rel <= 1e-2


@pytest.mark.parametrize("d,dtype", [(80, torch.float16),
                                     (160, torch.bfloat16)])
def test_tensor_core_fused_ring_is_repeatable(cuda_device, d, dtype):
    """Three launches of the tensor-core route agree bit for bit, with a
    ragged per-shard length: no sum depends on the block schedule."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v = _qkv((2, 4 * 300, 4, d), (2, 4 * 300, 4, d), dtype,
                   cuda_device)
    outs = [tring.ring_flash_fused(q, k, v, shards=4) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_tensor_core_fused_ring_refuses_misaligned_rows(cuda_device):
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    buf = torch.zeros(1 + 64 * 40, device=cuda_device, dtype=torch.bfloat16)
    shifted = buf[1:].view(1, 64, 1, 40)
    before = tring.FUSED_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        tring.ring_flash_fused(shifted, shifted, shifted, shards=4)
    assert tring.FUSED_KERNEL.launches == before
    # fp32 keeps the sweep, which reads any element
    fp32 = torch.zeros(1 + 64 * 40, device=cuda_device)[1:].view(1, 64, 1, 40)
    assert fp32.data_ptr() % 16
    tring.ring_flash_fused(fp32, fp32, fp32, shards=4)
    assert tring.FUSED_KERNEL.launches == before + 1


def test_fused_ring_kernel_refuses_what_it_does_not_take(cuda_device):
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q = torch.zeros(1, 8, 1, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tring.ring_flash_fused(q, q, q, shards=2)
    q = torch.zeros(1, 10, 1, 40, device=cuda_device)
    with pytest.raises(ValueError, match="do not split"):
        tring.ring_flash_fused(q, q, q, shards=4)
    strided = torch.zeros(1, 8, 1, 80, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tring.ring_flash_fused(strided, strided, strided, shards=2)


def test_one_card_ring_runs_b3_and_matches_unsharded(cuda_device,
                                                     monkeypatch):
    """By default a ring whose shards share the card is one B3 launch: the
    UNet's 64x64 level on cuda:0 named four times, no B1 and no B2."""
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring
    from chiaswarm_tpu_torch.parallel.context import sequence_parallel

    monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    monkeypatch.delenv("CHIASWARM_RING_FLASH", raising=False)
    mesh = build_mesh(MeshSpec({"seq": 4}), devices=[cuda_device] * 4)
    q, k, v = _qkv((2, 4096, 8, 40), (2, 4096, 8, 40), torch.bfloat16,
                   cuda_device)
    counts = (KERNEL.launches, tring.KERNEL.launches,
              tring.FUSED_KERNEL.launches)
    with sequence_parallel(mesh):
        out = tattn.attention(q, k, v)
    torch.cuda.synchronize()
    assert (KERNEL.launches - counts[0], tring.KERNEL.launches - counts[1],
            tring.FUSED_KERNEL.launches - counts[2]) == (0, 0, 1)
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)


# ---------------------------------------------------------------------------
# the continuous-batching lanes (serving/stepper.py): a lane of W rows runs
# its UNet on 2W rows (CFG), so B1 and B3 take batches of 8 to 32


@pytest.mark.parametrize("b,l,h,d", [
    (8, 4096, 8, 40), (8, 1024, 8, 80),     # a lane of width 4 at 512 px
    (16, 4096, 8, 40), (16, 1024, 8, 80),   # width 8
])
def test_kernel_matches_plain_at_lane_batches(cuda_device, b, l, h, d):
    q, k, v = _qkv((b, l, h, d), (b, l, h, d), torch.bfloat16, cuda_device)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2


@pytest.mark.parametrize("b,l,d", [
    (16, 4096, 40), (16, 1024, 80),   # a lane of width 8 on a seq slot
    (32, 4096, 40), (32, 1024, 80),   # width 16
])
def test_fused_ring_kernel_matches_plain_at_lane_batches(cuda_device, b, l,
                                                         d):
    """B3's ticket counter, counters and slots at a lane's batch: up to 32
    x 8 heads x 4 shards x 4 hops of work units."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v = _qkv((b, l, 8, d), (b, l, 8, d), torch.bfloat16, cuda_device)
    before = tring.FUSED_KERNEL.launches
    out = tring.ring_flash_fused(q, k, v, shards=4)
    torch.cuda.synchronize()
    assert tring.FUSED_KERNEL.launches == before + 1
    plain = tring.ring_flash_fused_plain(q, k, v, shards=4, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - plain.float()).norm() / plain.float().norm()).item()
    assert rel <= 1e-2


@pytest.mark.parametrize("scheduler", [None, "EulerDiscreteScheduler"])
def test_lane_step_matches_each_rows_solo_step(cuda_device, scheduler):
    """One lane step over 4 rows (step counts 20, 12 and 7 at different
    ladder positions, guidance 7.5, 5.0 and 9.0, one inactive row) against
    each row's solo step (a batch-1 CFG UNet call and ``sampler_step``), on
    a small float32 UNet whose 1024-token level goes through B1: relative
    L2 1e-4, the inactive row bit for bit, B1 once per self-attention at
    that level whatever the lane's width."""
    import dataclasses

    from chiaswarm_tpu_torch.models.configs import FAMILIES, UNetConfig
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from chiaswarm_tpu_torch.schedulers import (
        SamplerState,
        make_sampling_schedule,
        resolve,
        sampler_step,
        scale_model_input,
    )

    unet_cfg = UNetConfig(block_out_channels=(80, 160), layers_per_block=1,
                          transformer_depth=(1, 1), attention_head_dim=2,
                          cross_attention_dim=32, dtype="float32")
    family = dataclasses.replace(FAMILIES["tiny"], unet=unet_cfg)
    pipe = DiffusionPipeline(Components.random(family, seed=0,
                                               device=cuda_device))
    sampler = resolve(scheduler)
    steps, idx = (20, 12, 7, 20), (0, 5, 6, 3)
    scheds = [make_sampling_schedule(pipe.noise_schedule, n, sampler)
              for n in steps]
    cap = 32
    sig = torch.zeros((4, cap + 1))
    ts = torch.zeros((4, cap))
    for b, s in enumerate(scheds):
        sig[b, :steps[b] + 1] = s.sigmas
        ts[b, :steps[b]] = s.timesteps
    gen = torch.Generator(device="cpu").manual_seed(5)
    x, old = (torch.randn((4, 4, 32, 32), generator=gen).to(cuda_device)
              for _ in range(2))
    ctx_u, ctx_c = (torch.randn((4, 77, 32), generator=gen).to(cuda_device)
                    for _ in range(2))
    guidance = torch.tensor([7.5, 5.0, 9.0, 7.5])
    active = torch.tensor([True, True, True, False])
    before = KERNEL.launches
    x_l, idx_l, old_l = pipe.stepper_step(
        sampler=sampler, ctx_u=ctx_u, ctx_c=ctx_c, x=x,
        idx=torch.tensor(idx, device=cuda_device),
        start_idx=torch.zeros(4, dtype=torch.long, device=cuda_device),
        sigmas=sig.to(cuda_device), timesteps=ts.to(cuda_device),
        guidance=guidance.to(cuda_device), old_denoised=old,
        active=active.to(cuda_device), generators=[None] * 4)
    torch.cuda.synchronize()
    assert KERNEL.launches - before == 3  # 1 down and 2 up at 1024 tokens
    assert idx_l.tolist() == [1, 6, 7, 3]
    assert torch.equal(x_l[3], x[3]) and torch.equal(old_l[3], old[3])
    with torch.inference_mode():
        for b in range(3):
            one = slice(b, b + 1)
            inp = scale_model_input(scheds[b], x[one], idx[b])
            t = scheds[b].timesteps[idx[b]].to(cuda_device).expand(2)
            eps_u, eps_c = pipe.c.unet(torch.cat([inp, inp]), t, torch.cat(
                [ctx_u[one], ctx_c[one]])).chunk(2)
            eps = eps_u + float(guidance[b]) * (eps_c - eps_u)
            x_s, state = sampler_step(sampler, scheds[b], idx[b], x[one], eps,
                                      SamplerState(old[one]))
            for got, ref in ((x_l[one], x_s), (old_l[one], state.old_denoised)):
                rel = ((got - ref).norm() / ref.norm()).item()
                assert rel <= 1e-4, (b, rel)


def test_worker_serves_a_job_on_the_card(cuda_device, monkeypatch, tmp_path):
    """One small job through the port's worker (``node/worker.py``) against
    an in-process hive, on a one-card ``ChipPool``: a float32 UNet whose
    1024-token level (64 px through the tiny VAE) goes through B1 at head
    dim 40. The envelope is error-free, a lane served it, and B1 ran."""
    import asyncio
    import dataclasses

    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.models.configs import FAMILIES, UNetConfig
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.node.settings import Settings
    from chiaswarm_tpu_torch.node.worker import Worker
    from chiaswarm_tpu_torch.serving.stepper import get_stepper
    from fake_hive import FakeHive  # tests/ is on the path under pytest

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    unet_cfg = UNetConfig(block_out_channels=(80, 160), layers_per_block=1,
                          transformer_depth=(1, 1), attention_head_dim=2,
                          cross_attention_dim=32, dtype="float32")
    monkeypatch.setitem(FAMILIES, "tiny_b1", dataclasses.replace(
        FAMILIES["tiny"], name="tiny_b1", unet=unet_cfg))
    registry = ModelRegistry(catalog=[{"name": "tiny_b1",
                                       "family": "tiny_b1"}],
                             allow_random=True, device=cuda_device)
    pool = ChipPool(device=cuda_device)

    async def scenario():
        hive = FakeHive()
        uri = await hive.start()
        hive.jobs.append({"id": "gpu-1", "model_name": "tiny_b1",
                          "prompt": "a house", "num_inference_steps": 3,
                          "height": 64, "width": 64, "seed": 5,
                          "content_type": "image/png"})
        worker = Worker(settings=Settings(hive_uri=uri, hive_token="t",
                                          worker_name="gpu", poll_busy_s=0.05,
                                          poll_idle_s=0.05,
                                          install_signal_handlers=False),
                        pool=pool, registry=registry)
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(1, timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive.results, worker

    before = KERNEL.launches
    [result], worker = asyncio.run(scenario())
    get_stepper(pool.slots[0]).shutdown()
    config = result["pipeline_config"]
    assert "error" not in config, config
    assert "stepper" in config and config["slot"]["platform"] == "gpu"
    assert worker.jobs_done == 1
    assert KERNEL.launches - before == 3 * 3  # 3 steps, 3 at 1024 tokens


@pytest.mark.parametrize("scheduler", [None, "EulerDiscreteScheduler",
                                       "EulerAncestralDiscreteScheduler",
                                       "LCMScheduler"])
def test_solo_step_is_the_lanes_per_row_step_bit_for_bit(cuda_device,
                                                          scheduler):
    """The solo step (its ladder on the host) and the lane's per-row step
    (its ladders on the card) compute on the card alike: the same scaled
    input, x and history, bit for bit, at every position of a 20-step
    ladder. The solo step moves the scalars it reads to the sample's device
    before it computes; dividing by a host scalar there would multiply by
    its reciprocal and part from the lane in the last bit."""
    from chiaswarm_tpu_torch.schedulers import (
        SamplerState,
        ScheduleConfig,
        make_noise_schedule,
        make_sampling_schedule,
        resolve,
        sampler_step,
        scale_model_input,
    )
    from chiaswarm_tpu_torch.schedulers.sampling import (
        SamplingSchedule,
        sampler_step_rows,
        scale_model_input_rows,
    )

    sampler = resolve(scheduler)
    host = make_sampling_schedule(make_noise_schedule(ScheduleConfig()), 20,
                                  sampler)
    rows = SamplingSchedule(host.sigmas[None].repeat(2, 1).to(cuda_device),
                            host.timesteps[None].repeat(2, 1).to(cuda_device))
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = (torch.randn((2, 4, 64, 64), generator=gen) * 10).to(cuda_device)
    old, noise = (torch.randn((2, 4, 64, 64), generator=gen).to(cuda_device)
                  for _ in range(2))
    eps = torch.randn((2, 4, 64, 64), generator=gen).to(cuda_device,
                                                        torch.bfloat16)
    start = torch.zeros(2, dtype=torch.long, device=cuda_device)
    for i in range(20):
        idx = torch.full((2,), i, device=cuda_device)
        assert torch.equal(scale_model_input(host, x, i),
                           scale_model_input_rows(rows, x, idx)), i
        solo_x, solo_s = sampler_step(sampler, host, i, x, eps,
                                      SamplerState(old), noise=noise)
        lane_x, lane_s = sampler_step_rows(sampler, rows, idx, x, eps,
                                           SamplerState(old), noise, start)
        assert torch.equal(solo_x, lane_x), i
        assert torch.equal(solo_s.old_denoised, lane_s.old_denoised), i


def test_checkpoint_reader_lands_tensors_in_device_memory(cuda_device,
                                                          tmp_path):
    """``Components.from_checkpoint`` onto the card: float32 safetensors
    land in bf16 UNet/VAE parameters (cast as they land) and float32 text
    and norm parameters, equal to the source bit for bit, with nothing left
    in flight and the load's peak within one tensor of the modules."""
    from chiaswarm_tpu_torch.convert.safetensors_io import (
        SafetensorsFile,
        save_file,
    )
    from chiaswarm_tpu_torch.pipelines.components import Components

    src = Components.random("tiny", seed=4, device="cpu",
                            dtype=torch.bfloat16)
    modules = {"unet": src.unet, "vae": src.vae,
               "text_encoder": src.text_encoders[0]}
    for sub, module in modules.items():
        (tmp_path / sub).mkdir()
        save_file({k: v.float() for k, v in module.state_dict().items()},
                  tmp_path / sub / "model.safetensors")
    mapped = dict(SafetensorsFile(tmp_path / "unet" / "model.safetensors")
                  .tensors())
    on_card = mapped["conv_in.weight"].to(cuda_device)
    assert torch.equal(on_card.cpu(), src.unet.conv_in.weight.float())
    del on_card, mapped
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = Components.from_checkpoint(tmp_path, "tiny", "tiny",
                                     device=cuda_device, dtype=torch.bfloat16)
    peak = torch.cuda.max_memory_allocated() - before
    largest = max(p.numel() * 4 for m in modules.values()
                  for p in m.parameters())
    assert got.param_bytes() == src.param_bytes()
    assert peak <= got.param_bytes() + 2 * largest + (1 << 20)
    for name in ("unet", "vae"):
        for key, value in getattr(src, name).state_dict().items():
            loaded = getattr(got, name).state_dict()[key]
            assert loaded.is_cuda and loaded.dtype == value.dtype, key
            assert torch.equal(loaded.cpu(), value), key
    assert got.load_stats["tensors"] == sum(
        len(m.state_dict()) for m in modules.values())


def test_eviction_drops_memory_allocated(cuda_device, monkeypatch, tmp_path):
    """A one-model ledger on the card: loading B evicts A, and once A's
    references are gone ``memory_allocated`` is back within a model of the
    level before A (the caching allocator may keep the blocks reserved)."""
    import gc

    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.obs.metrics import Registry
    from chiaswarm_tpu_torch.serving.residency import ResidencyManager

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    footprint = ModelRegistry(
        catalog=[{"name": "a", "family": "tiny"}], allow_random=True,
        device=cuda_device).pipeline("a").c.param_bytes()
    gc.collect()
    torch.cuda.synchronize()
    level0 = torch.cuda.memory_allocated()
    ledger = ResidencyManager(int(1.5 * footprint), 4 * footprint,
                              persist_path=None, prefetch=False,
                              metrics_registry=Registry())
    registry = ModelRegistry(catalog=[{"name": "a", "family": "tiny"},
                                      {"name": "b", "family": "tiny"}],
                             allow_random=True, device=cuda_device,
                             residency=ledger)
    registry.pipeline("a")
    level_a = torch.cuda.memory_allocated()
    assert level_a - level0 >= footprint
    registry.pipeline("b")
    gc.collect()
    torch.cuda.synchronize()
    assert ledger.snapshot()["evictions"] == 1
    assert ledger.model_states() == {"a": "evicted", "b": "resident"}
    assert torch.cuda.memory_allocated() - level0 <= 1.05 * footprint
    assert ledger.peak_bytes <= ledger.budget_bytes + footprint


def test_prefetch_loads_a_checkpoint_on_its_thread_before_admission(
        cuda_device, monkeypatch, tmp_path):
    """The ledger's idle prefetch loads an evicted checkpoint on its daemon
    thread; the lander copies on its own stream and synchronises it, so the
    pipeline the next job gets holds the source weights bit for bit."""
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.obs.metrics import Registry
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.serving.residency import ResidencyManager

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    src = Components.random("tiny", seed=6, device="cpu")
    root = model_dir("tiny/a")
    for sub, module in {"unet": src.unet, "vae": src.vae,
                        "text_encoder": src.text_encoders[0]}.items():
        (root / sub).mkdir(parents=True)
        save_file(module.state_dict(), root / sub / "model.safetensors")
    footprint = src.param_bytes()
    ledger = ResidencyManager(int(1.5 * footprint), 4 * footprint,
                              persist_path=None, prefetch=True,
                              metrics_registry=Registry())
    registry = ModelRegistry(catalog=[{"name": "tiny/a", "family": "tiny"}],
                             device=cuda_device, residency=ledger)
    registry.pipeline("tiny/a")
    registry.pipeline("tiny/a")
    ledger.set_budget(footprint // 2, 4 * footprint)
    ledger.set_budget(int(1.5 * footprint), 4 * footprint)
    assert ledger.model_states() == {"tiny/a": "evicted"}
    assert ledger.note_idle()
    ledger._prefetch_thread.join(timeout=120)
    assert ledger.snapshot()["prefetch_loads"] == 1
    pipe = registry.pipeline("tiny/a")
    for key, value in src.unet.state_dict().items():
        got = pipe.c.unet.state_dict()[key]
        assert got.is_cuda and torch.equal(got.cpu(), value), key


def test_lander_orders_its_copies_after_kernels_queued_on_a_reused_block(
        cuda_device):
    """A block freed while a kernel queued on the current stream still
    writes it goes at once to the next allocation there. The lander is made
    before that allocation (as ``Components.from_checkpoint`` makes it);
    once told the parameter is allocated, its copy lands after the queued
    write, so the parameter ends up holding the checkpoint's value. The
    lander's pinned staging buffer and the sleep and fill kernels are made
    ready first: a pinned allocation or a kernel's first launch can block
    the host until the device is idle, which would hide a missing wait."""
    from chiaswarm_tpu_torch.convert.checkpoint import TensorLander

    n = 1 << 20
    lander = TensorLander(cuda_device)
    lander.land(torch.empty(n, device=cuda_device), torch.zeros(n))
    torch.cuda._sleep(1000)
    torch.empty(n, device=cuda_device).fill_(0.0)
    torch.cuda.synchronize()
    scratch = torch.empty(n, device=cuda_device)
    block = scratch.data_ptr()
    torch.cuda._sleep(100_000_000)  # tens of ms of device time queued first
    scratch.fill_(-1.0)
    del scratch
    param = torch.empty(n, device=cuda_device)
    assert param.data_ptr() == block
    src = torch.arange(n, dtype=torch.float32)
    lander.after_allocation()
    lander.land(param, src)
    lander.finish()
    torch.cuda.synchronize()
    assert torch.equal(param.cpu(), src)


def test_a_checkpoint_loads_while_another_models_lane_steps(
        cuda_device, monkeypatch, tmp_path):
    """Model B loads from disk on this thread while model A's lane steps on
    its own thread, both on the card's one stream (A's steps free blocks the
    allocator hands to B's parameters). B's weights equal their source bit
    for bit, and A's image is the one A renders with the card otherwise
    idle, at the same lane composition."""
    import dataclasses
    import threading
    import time

    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.models.configs import FAMILIES, UNetConfig
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    # the tiny family at a head dim B1 takes (its 1024-token level at 64 px)
    unet_cfg = UNetConfig(block_out_channels=(80, 160), layers_per_block=1,
                          transformer_depth=(1, 1), attention_head_dim=2,
                          cross_attention_dim=32, dtype="float32")
    monkeypatch.setitem(FAMILIES, "tiny_b1", dataclasses.replace(
        FAMILIES["tiny"], name="tiny_b1", unet=unet_cfg))
    src = Components.random("tiny_b1", seed=6, device="cpu")
    modules = {"unet": src.unet, "vae": src.vae,
               "text_encoder": src.text_encoders[0]}
    for sub, module in modules.items():
        (model_dir("tiny/b") / sub).mkdir(parents=True)
        save_file(module.state_dict(),
                  model_dir("tiny/b") / sub / "model.safetensors")
    registry = ModelRegistry(catalog=[{"name": "tiny/a", "family": "tiny_b1"},
                                      {"name": "tiny/b", "family": "tiny_b1"}],
                             allow_random=True, device=cuda_device)
    slot = ChipPool(device=cuda_device).slots[0]
    sched = get_stepper(slot)
    job = {"id": "a-1", "model_name": "tiny/a", "prompt": "a house",
           "num_inference_steps": 100, "height": 64, "width": 64, "seed": 5,
           "content_type": "image/png"}
    quiet = synchronous_do_work(dict(job), slot, registry)
    sched.shutdown()

    done: dict = {}
    runner = threading.Thread(target=lambda: done.update(
        result=synchronous_do_work(dict(job), slot, registry)))
    start = sched.stats().get("steps_executed", 0)
    runner.start()
    deadline = time.monotonic() + 120
    while (sched.stats().get("steps_executed", 0) - start < 3
           and runner.is_alive() and time.monotonic() < deadline):
        time.sleep(0.001)
    at_load = sched.stats().get("steps_executed", 0)
    pipe_b = registry.pipeline("tiny/b")
    after_load = sched.stats().get("steps_executed", 0)
    runner.join(timeout=300)
    sched.shutdown()
    assert at_load - start >= 3 and after_load - start < 100, (
        start, at_load, after_load)  # the load ran while the lane stepped
    for sub, module in modules.items():
        got = (pipe_b.c.text_encoders[0] if sub == "text_encoder"
               else getattr(pipe_b.c, sub)).state_dict()
        for key, value in module.state_dict().items():
            assert torch.equal(got[key].cpu(), value.to(got[key].dtype)), key
    cfg = done["result"]["pipeline_config"]
    assert "error" not in cfg and "stepper" in cfg, cfg
    assert (done["result"]["artifacts"]["primary"]["blob"]
            == quiet["artifacts"]["primary"]["blob"])
