"""Tests of the port that need an NVIDIA GPU: the CUDA kernels B1 (flash
attention), B2 (one ring hop with carried state) and B3 (a whole ring in one
launch) against their plain PyTorch versions, their refusals, and the
dispatcher's routes to them (B3, and B2 under the scan drive, through a
4-shard ring on one card), B1 and B3 at the batches a continuous-batching
lane gives them (2W rows for a lane of W), one lane step against each
row's solo step on a small float32 UNet through B1, and SDXL's side: B1 at
its head dim 64 shapes, the tiny_xl pipeline on the card against its CPU
run, and an SDXL-class lane pair against the solo pair; the safety checker's
vision tower against its CPU run, a ControlNet eval through B1 against the
plain route, and a scale-0 control job against its txt2img twin; B1 at
AudioLDM's head dim 32 (bf16 and fp16 on the tensor cores at its serve
shapes, ragged and strided, fp32 on the sweep, and its refusal of rows off
16 bytes), B2 and B3 still at their own head dims; text to speech (the
tiny family on the card against its CPU run, launching no kernel of the
port; the same job twice, the same bytes; two layers at Bark's width in
bf16 following the float32 CPU decode); video (B1 at the spatial
self-attentions of ModelScope's, SVD's and vid2vid's folded frames, the
tiny video UNets on the card against their CPU run); the DeepFloyd cascade
(B1 at its stage-2 and x4 upscaler shapes, head dim 128 among them, the
plain path in blocks of queries against SDPA at 16,384 tokens, a T5-XXL
layer in bf16 on the card against float32 on the CPU); the six ControlNet
detectors (HED, M-LSD, lineart, body-pose, DPT, UperNet at their published
widths) on the card against their CPU run with cuDNN's TF32 allowed, within
``models/annotator.py::tf32_bar`` of their conv depth, and a detector whose
weights are wrong raising on the card instead of serving its stand-in; the
rest of the SD surface (B1 at a three-job burst's batch-6 shapes, SD1.5's
UNet under int8 weights against its bf16 twin, the int8 and fp8 fake-quant
and ``quantize_leaf`` on the card against the CPU, DeepCache's shallow
eval launching B1 at level 0 only); the hive worker's lease and health
parts (a lane checkpoint spooled by job id, handed back through JSON and
resumed on the card bit for bit; a profiler capture holding B1's kernel
events, a concurrent one answering busy); the numerics taps (a tapped B1
call's ``attn.out`` record against the plain version's summary, and B1, B2
and B3 launching the same with the taps off and on); B2 and B3 at the rings
of SDXL at 1024 px on a one-card seq = 4 slot, the VAE's D = 512 sweep over
16,384 tokens among them.

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

#: the head dims B2 and B3 take on the tensor cores (B1 alone takes 32)
RING_TENSOR_CORE_HEAD_DIMS = tuple(d for d in SUPPORTED_HEAD_DIMS if d != 32)


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


@pytest.mark.parametrize("dtype", TENSOR_CORE_DTYPES)
@pytest.mark.parametrize("b,l,s", [(2, 2560, 2560), (1, 1280, 1280),
                                   (2, 1000, 333), (1, 77, 130)])
def test_head_dim_32_matches_plain_on_the_tensor_cores(cuda_device, dtype, b,
                                                       l, s):
    """AudioLDM's level-0 self-attention (4 heads of 32 over 2,560 tokens at
    a 10 s job, 1,280 at 5 s) and ragged lengths, no multiple of the 64-key
    tile or the 128-row block: Q K^T is two k16 steps deep and P V runs at
    N = 32 over 64-byte rows."""
    q, k, v = _qkv((b, l, 4, 32), (b, s, 4, 32), dtype, cuda_device, seed=32)
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
def test_head_dim_32_reads_strided_query_shards(cuda_device, dtype):
    """At D = 32: a query shard strided across a batch of two and offset
    along L, k/v heads-major."""
    full = _qkv((2, 4 * 320, 4, 32), (2, 700, 4, 32), dtype, cuda_device)
    q = full[0][:, 320:640]
    k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in full[1:])
    assert not q.is_contiguous() and not k.is_contiguous()
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v).float(),
                               rtol=0, atol=4e-3)


@pytest.mark.parametrize("b,l,s", [(2, 2560, 2560), (1, 1000, 333)])
def test_head_dim_32_fp32_takes_the_sweep(cuda_device, b, l, s):
    """fp32 at D = 32 on the CUDA-core sweep, TF32 off: 2e-4."""
    q, k, v = _qkv((b, l, 4, 32), (b, s, 4, 32), torch.float32, cuda_device)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=0, atol=2e-4)


def test_head_dim_32_refuses_misaligned_rows(cuda_device):
    """64-byte rows at D = 32: a data pointer or a sequence stride off 16
    bytes raises on the tensor-core route, and nothing launches."""
    buf = torch.zeros(1 + 64 * 32, device=cuda_device, dtype=torch.bfloat16)
    shifted = buf[1:].view(1, 64, 1, 32)
    before = KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(shifted, shifted, shifted)
    # a sequence stride of 36 elements (72 bytes)
    odd = torch.zeros(1, 64, 36, device=cuda_device,
                      dtype=torch.float16)[..., :32].unsqueeze(2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(odd, odd, odd)
    assert KERNEL.launches == before


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
    # SDXL at 1024 px on a seq = 4 slot under the scan drive: the UNet's
    # 64x64 and 32x32 level shards and the VAE mid block's 4,096-token one
    (2, 1024, 1024, 10, 64, torch.bfloat16, 4e-3),
    (2, 256, 256, 20, 64, torch.bfloat16, 4e-3),
    (1, 4096, 4096, 1, 512, torch.bfloat16, 4e-3),
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


@pytest.mark.parametrize("d", RING_TENSOR_CORE_HEAD_DIMS)
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


@pytest.mark.parametrize("d", RING_TENSOR_CORE_HEAD_DIMS)
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


@pytest.mark.parametrize("b,l,h,d", [
    (2, 4096, 10, 64), (2, 1024, 20, 64),   # SDXL solo on a seq = 4 slot
    (4, 4096, 10, 64), (4, 1024, 20, 64),   # a lane of 2 rows there
    (1, 16384, 1, 512),                     # its VAE mid block at 1024 px
])
def test_fused_ring_kernel_matches_plain_at_sdxl_shapes(cuda_device, b, l, h,
                                                        d):
    """B3 at the rings an SDXL job at 1024 px launches on a one-card seq = 4
    slot, the D = 512 sweep over 16,384 tokens (4 shards of 4,096 queries)
    among them: 4e-3 max abs and 1e-2 relative L2 against its plain
    version."""
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    q, k, v = _qkv((b, l, h, d), (b, l, h, d), torch.bfloat16, cuda_device)
    before = tring.FUSED_KERNEL.launches
    out = tring.ring_flash_fused(q, k, v, shards=4)
    torch.cuda.synchronize()
    assert tring.FUSED_KERNEL.launches == before + 1
    assert torch.isfinite(out).all()
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


# ---------------------------------------------------------------------------
# SDXL: B1 at head dim 64, the tiny_xl pipeline on the card, and
# a lane pair against the solo pair with pooled text and time ids


@pytest.mark.parametrize("b,l,h,dtype", [
    (2, 4096, 10, torch.bfloat16), (2, 1024, 20, torch.bfloat16),   # solo
    (4, 4096, 10, torch.bfloat16), (4, 1024, 20, torch.bfloat16),   # lane of 2
    (8, 4096, 10, torch.bfloat16), (8, 1024, 20, torch.bfloat16),   # lane of 4
    (2, 4096, 10, torch.float16), (2, 1024, 20, torch.float16),
])
def test_kernel_matches_plain_at_sdxl_shapes(cuda_device, b, l, h, dtype):
    """SDXL at 1024 px: 10 heads at 4096 tokens and 20 at 1024, head dim
    64, at the UNet batches of the solo path (2) and of lanes of 2 and 4
    rows (4 and 8)."""
    q, k, v = _qkv((b, l, h, 64), (b, l, h, 64), dtype, cuda_device)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.shapes[(b, l, l, h, 64, str(dtype).removeprefix(
        "torch."))] >= 1
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2


def _png_u8(result):
    import base64
    import io

    import numpy as np
    from PIL import Image

    cfg = result["pipeline_config"]
    assert "error" not in cfg, cfg
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")).astype(
        np.int16)


def test_tiny_xl_pipeline_on_the_card_matches_its_cpu_run(cuda_device):
    """The same tiny_xl weights (float32, TF32 off) and noise on the card
    and on the CPU: two towers, pooled text and time ids on the device,
    within one uint8 level."""
    import dataclasses

    import numpy as np

    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import (
        DiffusionPipeline,
        GenerateRequest,
    )

    noise = np.random.default_rng(0).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    req = GenerateRequest(prompt="a lighthouse", negative_prompt="blurry",
                          steps=4, guidance_scale=7.5, height=64, width=64,
                          init_noise=noise)
    # drawn once, on the CPU (a card's generator draws other numbers)
    cpu = Components.random("tiny_xl", seed=2, device="cpu")
    images = {"cpu": DiffusionPipeline(cpu)(req)[0]}
    card = dataclasses.replace(
        cpu, device=cuda_device,
        text_encoders=[te.to(cuda_device) for te in cpu.text_encoders],
        unet=cpu.unet.to(cuda_device), vae=cpu.vae.to(cuda_device))
    images["cuda"], _ = DiffusionPipeline(card)(req)
    diff = np.abs(images["cuda"].astype(np.int16) - images["cpu"])
    assert diff.max() <= 1 and images["cuda"].std() > 1.0, diff.max()


def test_sdxl_class_lane_pair_is_the_solo_pair_bit_for_bit(cuda_device,
                                                           monkeypatch,
                                                           tmp_path):
    """A bf16 SDXL-class UNet whose 1024-token level (64 px through the tiny
    VAE) takes B1 at head dim 64: one job with two images on the solo path
    (a CFG batch of 4 rows) and in a lane pinned at 2 rows (the same UNet
    batch, text batch, pooled rows, time ids and noise) renders the same
    grid bit for bit, and B1 ran at (4, 1024, 1024, 1, 64) in both."""
    import dataclasses

    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    xl = FAMILIES["tiny_xl"]
    monkeypatch.setitem(FAMILIES, "tiny_xl_b1", dataclasses.replace(
        xl, name="tiny_xl_b1", unet=dataclasses.replace(
            xl.unet, block_out_channels=(64, 128), transformer_depth=(1, 1),
            attention_head_dim=64, dtype="bfloat16")))
    registry = ModelRegistry(catalog=[{"name": "tiny_xl_b1",
                                       "family": "tiny_xl_b1"}],
                             allow_random=True, device=cuda_device)
    slot = ChipPool(device=cuda_device).slots[0]
    job = {"id": "pair", "model_name": "tiny_xl_b1", "prompt": "a house",
           "negative_prompt": "blurry", "num_inference_steps": 6,
           "height": 64, "width": 64, "seed": 5, "num_images_per_prompt": 2,
           "content_type": "image/png"}
    grids, launches = {}, {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CHIASWARM_STEPPER", mode)
        monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
        kernels.reset_launches()
        result = synchronous_do_work(dict(job), slot, registry)
        assert ("stepper" in result["pipeline_config"]) == (mode == "1")
        grids[mode] = _png_u8(result)
        launches[mode] = dict(KERNEL.shapes)
    get_stepper(slot).shutdown()
    assert grids["0"].shape == (64, 128, 3) and grids["0"].std() > 1.0
    assert (grids["1"] == grids["0"]).all()
    assert launches["0"] == launches["1"] == {
        (4, 1024, 1024, 1, 64, "bfloat16"): 6 * 3}


# ---- img2img and inpaint -------------------------------------------------


def test_vae_encoder_bf16_matches_fp32(cuda_device):
    """SD1.5's full-width VAE encoder, random from a seed, at 256 px: the
    latent mean with the weights cast to bf16 (the serving dtype; norms and
    ``conv_out``/``quant_conv`` stay float32) against the same weights in
    float32, within the repo's bf16 bar of 3e-2 relative L2."""
    import copy

    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.models.vae import AutoencoderKL

    torch.manual_seed(0)
    vae32 = AutoencoderKL(FAMILIES["sd15"].vae).eval()
    vae16 = cast_module(copy.deepcopy(vae32), torch.bfloat16).to(cuda_device)
    vae32 = vae32.to(cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = (torch.rand((1, 3, 256, 256), generator=gen) * 2 - 1).to(cuda_device)
    with torch.inference_mode():
        mean16, logvar16 = vae16.encode_moments(x)
        mean32, _ = vae32.encode_moments(x)
    assert mean16.dtype == logvar16.dtype == torch.float32
    assert mean16.shape == (1, 4, 32, 32)
    rel = float((mean16 - mean32).norm() / mean32.norm())
    assert rel <= 3e-2, rel


def _tiny_b1(monkeypatch, tmp_path, cuda_device):
    """A bf16 SD-class tiny family whose 1024-token level (64 px through the
    tiny VAE) takes B1 at head dim 64, its registry and a slot."""
    import dataclasses

    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.node.registry import ModelRegistry

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    tiny = FAMILIES["tiny"]
    monkeypatch.setitem(FAMILIES, "tiny_b1", dataclasses.replace(
        tiny, name="tiny_b1", unet=dataclasses.replace(
            tiny.unet, block_out_channels=(64, 128), attention_head_dim=64,
            head_dim_is_count=False, dtype="bfloat16")))
    registry = ModelRegistry(catalog=[{"name": "tiny_b1",
                                       "family": "tiny_b1"}],
                             allow_random=True, device=cuda_device)
    return registry, ChipPool(device=cuda_device).slots[0]


def _image_job(mode: str, **over):
    import numpy as np

    rng = np.random.default_rng(3)
    job = {"id": mode, "model_name": "tiny_b1", "prompt": "a red door",
           "negative_prompt": "blurry", "num_inference_steps": 6,
           "seed": 5, "content_type": "image/png",
           "image": rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)}
    if mode == "img2img":
        job["strength"] = 0.5
    else:
        mask = np.zeros((64, 64, 3), np.uint8)
        mask[16:40, 8:48] = 255
        job["mask_image"] = mask
    job.update(over)
    return job


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_image_lane_pair_is_the_solo_pair_bit_for_bit(cuda_device,
                                                      monkeypatch, tmp_path,
                                                      mode):
    """An img2img or inpaint job with two images on the solo path (a CFG
    batch of 4 rows) and in a lane pinned at 2 rows (the same UNet batch,
    the same batch-1 encode, renoise from the same generators) renders the
    same grid bit for bit, B1 at the same shapes in both."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry, slot = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    grids, launches = {}, {}
    for lanes in ("0", "1"):
        monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
        monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
        kernels.reset_launches()
        result = synchronous_do_work(_image_job(mode,
                                                num_images_per_prompt=2),
                                     slot, registry)
        cfg = result["pipeline_config"]
        assert ("stepper" in cfg) == (lanes == "1") and cfg["mode"] == mode
        grids[lanes] = _png_u8(result)
        launches[lanes] = dict(KERNEL.shapes)
    get_stepper(slot).shutdown()
    assert grids["0"].shape == (64, 128, 3) and grids["0"].std() > 1.0
    assert (grids["1"] == grids["0"]).all()
    assert launches["0"] == launches["1"] and launches["0"]


def test_inpaint_keeps_the_known_latents_on_the_card(cuda_device,
                                                     monkeypatch, tmp_path):
    """Solo and in a lane, an inpaint job's final latents equal its encoded
    init latents exactly where the latent mask keeps them."""
    import numpy as np

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.pipelines.diffusion import latent_mask
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    registry, slot = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    pipe = registry.pipeline("tiny_b1")
    seen = {"known": [], "final": []}
    encode, decode = pipe.encode_init_image, pipe._decode_uint8

    def spy_encode(*args, **kw):
        seen["known"].append(encode(*args, **kw))
        return seen["known"][-1]

    def spy_decode(x):
        seen["final"].append(x.clone())
        return decode(x)

    monkeypatch.setattr(pipe, "encode_init_image", spy_encode)
    monkeypatch.setattr(pipe, "_decode_uint8", spy_decode)
    job = _image_job("inpaint", scheduler_type="EulerAncestralDiscreteScheduler")
    for lanes in ("0", "1"):
        monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
        _png_u8(synchronous_do_work(dict(job), slot, registry))
    get_stepper(slot).shutdown()
    m = job["mask_image"].mean(-1) / 255.0
    kept = torch.from_numpy(latent_mask(m, 32, 32, 2) == 0).to(cuda_device)
    assert kept.any() and (~kept).any()
    for known, final in zip(seen["known"], seen["final"]):
        assert torch.equal(final[:1, :, kept], known[:, :, kept])
    assert len(seen["final"]) == 2 and not np.array_equal(
        seen["final"][0].cpu().numpy(), seen["known"][0].cpu().numpy())


def test_encode_stays_outside_the_seq_context(cuda_device):
    """Under a caller's ``seq = 4`` context on one card, the init-image
    encode rings nothing and launches no B3: its 1024-token mid-block
    attention stays local, as the JAX package encodes outside
    ``seq_parallel_wrap``."""
    import numpy as np

    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.ops.ring_flash_attention import FUSED_KERNEL
    from chiaswarm_tpu_torch.parallel.context import (
        capture_ring_calls,
        sequence_parallel,
    )
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import DiffusionPipeline

    mesh = build_mesh(MeshSpec({"seq": 4}), devices=[cuda_device] * 4)
    pipe = DiffusionPipeline(Components.random("tiny", seed=0,
                                               device=cuda_device), mesh=mesh)
    image = np.random.default_rng(4).integers(0, 255, (64, 64, 3),
                                              dtype=np.uint8)
    before = FUSED_KERNEL.launches
    with capture_ring_calls() as calls, sequence_parallel(mesh):
        z = pipe.encode_init_image(image, 64, 64, seed=1)
    torch.cuda.synchronize()
    assert calls == [] and FUSED_KERNEL.launches == before
    assert z.shape == (1, 4, 32, 32) and torch.isfinite(z).all()


# ---------------------------------------------------------------------------
# the gray-failure guard on the card (tests/test_torch_guard.py on the CPU)


def _guard_env(monkeypatch):
    from chiaswarm_tpu_torch.serving import guard

    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "2")
    for name in (guard.ENV_CHAOS_WEDGE, guard.ENV_CHAOS_NAN,
                 guard.ENV_CHAOS_SLOW, guard.ENV_ENABLE):
        monkeypatch.delenv(name, raising=False)
    guard.reset_chaos()
    return guard


def test_a_wedged_lane_pair_resumes_bit_for_bit_on_the_card(
        cuda_device, monkeypatch, tmp_path):
    """A txt2img and an inpaint job share a tiny_b1 lane of 2 on the card;
    lane step 3 wedges inside its armed window (the host sleep stands in
    for a wedged card: the window's ``event.synchronize()`` is inside the
    same window). The watchdog condemns the lane from its own thread, both
    jobs resume at step 2 in one fresh lane, and each image is its
    uninterrupted run bit for bit (generator states in the checkpoint);
    B1 ran at the same shapes."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    guard = _guard_env(monkeypatch)
    registry, slot = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    ancestral = {"scheduler_type": "EulerAncestralDiscreteScheduler"}
    jobs = [{"id": "txt", "model_name": "tiny_b1", "prompt": "a red door",
             "num_inference_steps": 8, "seed": 4, "height": 64, "width": 64,
             "content_type": "image/png"},
            _image_job("inpaint", num_inference_steps=8)]
    kernels.reset_launches()
    # the formatter pops the nested parameters: a fresh copy each run
    ref = synchronous_do_work_batch(
        [dict(j, parameters=dict(ancestral)) for j in jobs], slot, registry)
    ref_shapes = dict(KERNEL.shapes)
    get_stepper(slot).shutdown()
    monkeypatch.setenv(guard.ENV_HANG_FACTOR, "3")
    monkeypatch.setenv(guard.ENV_HANG_FLOOR, "1")
    monkeypatch.setenv(guard.ENV_CHAOS_WEDGE, "3:4.0")
    guard.reset_chaos()
    kernels.reset_launches()
    healed = synchronous_do_work_batch(
        [dict(j, parameters=dict(ancestral)) for j in jobs], slot, registry)
    stats = get_stepper(slot).stats()
    get_stepper(slot).shutdown(timeout_s=30)
    assert stats["lanes_condemned"] == 1 and stats["rows_hung"] == 2
    for before, after in zip(ref, healed):
        assert after["pipeline_config"]["stepper"]["resume_step"] >= 1
        assert (_png_u8(after) == _png_u8(before)).all()
    assert set(KERNEL.shapes) == set(ref_shapes)


def test_a_nan_row_retires_alone_on_the_card(cuda_device, monkeypatch,
                                             tmp_path):
    """Row 1 of a tiny_b1 lane of 2 poisoned after lane step 1: the
    checkpoint's copy to the host finds it, its job's envelope is a
    non-fatal ``invalid_output``, and row 0's image is its unpoisoned
    twin's bit for bit."""
    from chiaswarm_tpu_torch.node.executor import synchronous_do_work_batch
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    guard = _guard_env(monkeypatch)
    registry, slot = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    jobs = [{"id": f"nan-{seed}", "model_name": "tiny_b1",
             "prompt": "a red door", "num_inference_steps": 6, "seed": seed,
             "height": 64, "width": 64, "content_type": "image/png"}
            for seed in (5, 6)]
    twin = synchronous_do_work_batch([dict(j) for j in jobs], slot, registry)
    get_stepper(slot).shutdown()
    monkeypatch.setenv(guard.ENV_CHAOS_NAN, "1:1")
    guard.reset_chaos()
    out = synchronous_do_work_batch([dict(j) for j in jobs], slot, registry)
    stats = get_stepper(slot).stats()
    get_stepper(slot).shutdown()
    assert stats["rows_invalid"] == 1
    assert out[1]["pipeline_config"]["error_kind"] == "invalid_output"
    assert "fatal_error" not in out[1]
    assert (_png_u8(out[0]) == _png_u8(twin[0])).all()


# ---------------------------------------------------------------------------
# the safety checker's tower and ControlNet on the card


def test_checker_tower_on_the_card_matches_its_cpu_run(cuda_device):
    """The checker's vision tower (published depth cut to 4 layers, width
    256, 257 tokens at 224 px) in float32 on the card against its CPU run
    within 2e-4, with cuDNN's TF32 allowed (PyTorch's default): the patch
    embedding is a GEMM, so no float32 conv of the tower runs in TF32."""
    from chiaswarm_tpu_torch.models.clip import ClipVisionEncoder, VisionConfig
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init

    tower = ClipVisionEncoder(VisionConfig(hidden_size=256,
                                           intermediate_size=1024,
                                           num_layers=4, num_heads=4,
                                           projection_dim=128))
    gen = torch.Generator().manual_seed(3)
    flax_default_init(tower, gen)
    with torch.no_grad():
        tower.vision_model.embeddings.class_embedding.normal_(
            0.0, 0.5, generator=gen)
    pixels = torch.randn((3, 3, 224, 224), generator=gen)
    with torch.inference_mode():
        want = tower(pixels)
        torch.backends.cudnn.allow_tf32 = True
        try:
            got = tower.to(cuda_device)(pixels.to(cuda_device)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    assert (got - want).abs().max().item() <= 2e-4 * max(
        1.0, want.abs().max().item())


def _seeded_zero_convs(bundle, seed: int = 9, std: float = 0.05) -> None:
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    with torch.no_grad():
        for conv in (bundle.embed.conv_out, bundle.net.controlnet_mid_block,
                     *bundle.net.controlnet_down_blocks):
            for p in (conv.weight, conv.bias):
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=bundle.device) * std)


def test_control_unet_eval_matches_the_plain_route(cuda_device):
    """One control eval (the ControlNet's residuals into the UNet, CFG
    batch) on a small float32 family whose 1024-token level goes through
    B1, against the plain attention route: relative L2 1e-4, B1 once per
    self-attention at that level (1 in the ControlNet's down trunk, 1 down
    and 2 up in the UNet)."""
    import dataclasses

    from chiaswarm_tpu_torch.models.configs import FAMILIES, UNetConfig
    from chiaswarm_tpu_torch.pipelines.components import (
        Components,
        ControlNetBundle,
    )
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl

    unet_cfg = UNetConfig(block_out_channels=(80, 160), layers_per_block=1,
                          transformer_depth=(1, 1), attention_head_dim=2,
                          cross_attention_dim=32, dtype="float32")
    family = dataclasses.replace(FAMILIES["tiny"], unet=unet_cfg)
    unet = Components.random(family, seed=0, device=cuda_device).unet
    bundle = ControlNetBundle.random(family, seed=1, device=cuda_device)
    _seeded_zero_convs(bundle)
    gen = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn((2, 4, 32, 32), generator=gen).to(cuda_device)
    ctx = torch.randn((2, 77, 32), generator=gen).to(cuda_device)
    cond = torch.rand((1, 3, 64, 64), generator=gen).to(cuda_device)
    t = torch.tensor([700.0, 700.0], device=cuda_device)

    def control_eval():
        with torch.inference_mode():
            hint = bundle.embed(cond).expand(2, -1, -1, -1)
            down, mid = bundle.net(x, t, ctx, hint, None, 0.8)
            return unet(x, t, ctx, None, down, mid)

    before = KERNEL.launches
    got = control_eval()
    torch.cuda.synchronize()
    assert KERNEL.launches - before == 4
    for module in (unet, bundle.net):
        set_attn_impl(module, "xla")
    want = control_eval()
    assert KERNEL.launches - before == 4
    with torch.inference_mode():
        plain = unet(x, t, ctx)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel
    assert ((want - plain).norm() / plain.norm()).item() > 1e-3


def test_a_scale_zero_control_job_is_its_txt2img_job_bit_for_bit(
        cuda_device, monkeypatch, tmp_path):
    """On the card in bf16: a control job at scale 0 renders the txt2img
    image of its seed bit for bit (the residuals are zeros added to the
    skips), scale 1 does not, and B1 runs 4 times an eval (3 in the UNet at
    1024 tokens, 1 in the ControlNet)."""
    import numpy as np

    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.pipelines.components import ControlNetBundle
    from chiaswarm_tpu_torch.pipelines.diffusion import GenerateRequest

    registry, _ = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    pipe = registry.pipeline("tiny_b1")
    bundle = ControlNetBundle.random(FAMILIES["tiny_b1"], seed=1,
                                     device=cuda_device)
    _seeded_zero_convs(bundle, std=0.02)
    cond = np.random.default_rng(4).integers(0, 256, (64, 64, 3),
                                             dtype=np.uint8)
    base = dict(prompt="a red door", negative_prompt="blurry", steps=4,
                height=64, width=64, seed=5)
    plain, _ = pipe(GenerateRequest(**base))
    before = KERNEL.launches
    zero, cfg = pipe(GenerateRequest(**base, controlnet=bundle,
                                     control_image=cond, control_scale=0.0))
    assert KERNEL.launches - before == 4 * 4
    one, _ = pipe(GenerateRequest(**base, controlnet=bundle,
                                  control_image=cond, control_scale=1.0))
    assert np.array_equal(zero, plain)
    assert not np.array_equal(one, plain)
    assert cfg["controlnet_scale"] == 0.0


def test_tiled_decode_on_the_card_matches_its_cpu_run(cuda_device):
    """The tiny VAE in float32 (TF32 off) over a latent of 2 x 2 tiles on
    the card and on the CPU within 1e-4, and a latent of one tile bit for
    bit the untiled decode on the card."""
    from chiaswarm_tpu_torch.models.vae import tiled_decode
    from chiaswarm_tpu_torch.pipelines.components import Components

    vae = Components.random("tiny", seed=0, device="cpu").vae
    z = torch.randn((1, 4, 100, 72), generator=torch.Generator()
                    .manual_seed(1))
    with torch.inference_mode():
        ref = tiled_decode(vae, z)
        vae = vae.to(cuda_device)
        got = tiled_decode(vae, z.to(cuda_device))
        one = z[:, :, :64, :48].to(cuda_device)
        assert torch.equal(tiled_decode(vae, one), vae.decode(one).float())
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)


def test_lora_merge_lands_the_host_merge_on_the_card(cuda_device):
    """A bf16 UNet on the card takes the float32 host merge cast once: its
    weights equal the CPU merge of the same bf16 weights bit for bit."""
    import re

    from chiaswarm_tpu_torch.convert.lora import merge_lora
    from chiaswarm_tpu_torch.pipelines.components import Components

    host = Components.random("tiny", seed=0, device="cpu").unet.to(
        torch.bfloat16)
    card = Components.random("tiny", seed=0, device="cpu").unet.to(
        cuda_device, torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    state = {}
    for name, w in host.named_parameters():
        m = re.match(r"^(.+\.attn[12])\.(to_q|to_k|to_v|to_out)(\.0)?"
                     r"\.weight$", name)
        if m:
            leaf = f"{m.group(1)}.{m.group(2)}{m.group(3) or ''}"
            state[f"{leaf}.lora_A.weight"] = torch.randn(
                (4, w.shape[1]), generator=gen)
            state[f"{leaf}.lora_B.weight"] = torch.randn(
                (w.shape[0], 4), generator=gen) * 0.1
    assert merge_lora(host, state, 0.7) == merge_lora(card, state, 0.7) > 0
    card_params = dict(card.named_parameters())
    for name, w in host.named_parameters():
        assert torch.equal(card_params[name].cpu(), w), name


def test_textual_inversion_rows_land_on_the_card(cuda_device):
    """An inversion applied to towers on the card: the new rows hold the
    vectors, the token takes one id per vector, and the tower's output on
    the card matches the same inversion on the CPU (float32, 1e-5)."""
    import numpy as np

    from chiaswarm_tpu_torch.convert.textual_inversion import (
        apply_textual_inversion,
    )
    from chiaswarm_tpu_torch.pipelines.components import Components

    vectors = np.random.default_rng(2).normal(size=(2, 32)).astype(
        np.float32)
    outs = []
    for device in ("cpu", cuda_device):
        c = Components.random("tiny", seed=0, device="cpu")
        c.text_encoders = [te.to(device) for te in c.text_encoders]
        apply_textual_inversion(c, {"<sks>": vectors})
        table = c.text_encoders[0].text_model.embeddings.token_embedding
        assert table.weight.device.type == torch.device(device).type
        assert torch.equal(table.weight[-2:].cpu(),
                           torch.from_numpy(vectors))
        ids = torch.from_numpy(c.tokenizers[0].encode_batch(
            ["a <sks> boat"])).to(device)
        assert {1000, 1001} <= set(ids[0].tolist())
        with torch.inference_mode():
            outs.append(c.text_encoders[0](ids)[0].cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)


def test_upscaler_unet_eval_through_b1_matches_the_plain_route(cuda_device):
    """The x2 upscaler's UNet at its published widths (bf16, random) on a
    64x64 latent with its 8-channel input: B1 at 4,096 tokens (6 heads)
    and 1,024 (12 heads) against the plain route, relative L2 3e-2 (the
    repo's bf16 bar), 5 launches at each of the two levels."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.models.unet import UNet
    from chiaswarm_tpu_torch.pipelines.components import flax_default_init
    from chiaswarm_tpu_torch.pipelines.diffusion import set_attn_impl
    from chiaswarm_tpu_torch.models.common import cast_module

    with torch.device("meta"):
        unet = UNet(FAMILIES["upscaler_x2"].unet)
    unet = unet.to_empty(device=cuda_device).eval().requires_grad_(False)
    flax_default_init(unet, torch.Generator(device=cuda_device)
                      .manual_seed(0))
    cast_module(unet, torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn((1, 8, 64, 64), generator=gen).to(cuda_device,
                                                      torch.bfloat16)
    ctx = torch.randn((1, 77, 768), generator=gen).to(cuda_device,
                                                      torch.bfloat16)
    t = torch.tensor([500.0], device=cuda_device)
    before = dict(KERNEL.shapes)
    with torch.inference_mode():
        got = unet(x, t, ctx).float()
        new = {k: n - before.get(k, 0) for k, n in KERNEL.shapes.items()
               if n != before.get(k, 0)}
        set_attn_impl(unet, "xla")
        want = unet(x, t, ctx).float()
    assert new == {(1, 4096, 4096, 6, 64, "bfloat16"): 5,
                   (1, 1024, 1024, 12, 64, "bfloat16"): 5}, new
    rel = ((got - want).norm() / want.norm()).item()
    assert torch.isfinite(got).all() and rel <= 3e-2, rel


# ------------------------------------------------------- text to speech

def _tts_on(components, device):
    """``components`` (drawn once, on the CPU) with every module on
    ``device``: a copy, the CPU modules kept."""
    import copy
    import dataclasses

    from chiaswarm_tpu_torch.pipelines.tts import MODULES

    return dataclasses.replace(
        components, device=device,
        **{name: copy.deepcopy(getattr(components, name)).to(device)
           for name in MODULES})


def test_tts_pipeline_on_the_card_matches_its_cpu_run(cuda_device):
    """tiny_tts in float32 (TF32 off) at temperature 0 and ``top_k = 1``:
    the same config (token counts) and waveform within 1e-4 of the CPU's,
    and no kernel of the port launched (the stages attend in plain
    PyTorch, as JAX does outside any Pallas kernel)."""
    import numpy as np

    from chiaswarm_tpu_torch.ops import (  # noqa: F401 (registers B1-B3)
        flash_attention as _b1,
        kernels,
        ring_flash_attention as _b23,
    )
    from chiaswarm_tpu_torch.pipelines.tts import TTSComponents, TTSPipeline

    cpu = TTSComponents.random("tiny_tts", seed=5, device="cpu")
    history = {"semantic_prompt": np.arange(20) % 50,
               "coarse_prompt": np.arange(48).reshape(2, 24) % 16,
               "fine_prompt": np.arange(96).reshape(4, 24) % 16}
    kw = dict(duration_s=0.5, seed=3, temperature=0.0, top_k=1,
              history=history)
    want, _, want_cfg = TTSPipeline(cpu)("hello there, world", **kw)
    kernels.reset_launches()
    got, _, got_cfg = TTSPipeline(_tts_on(cpu, cuda_device))(
        "hello there, world", **kw)
    assert sum(k.launches for k in kernels.KERNELS.values()) == 0
    assert got_cfg == want_cfg
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_tts_same_job_twice_gives_the_same_bytes_on_the_card(cuda_device):
    """Sampling at temperature 0.7 from the job's generator on the card:
    the same seed, the same waveform bytes; another seed, others."""
    from chiaswarm_tpu_torch.pipelines.tts import TTSComponents, TTSPipeline

    pipe = TTSPipeline(TTSComponents.random("tiny_tts", seed=6,
                                            device=cuda_device))
    a = pipe("a dog barking in the rain", duration_s=0.5, seed=11)
    b = pipe("a dog barking in the rain", duration_s=0.5, seed=11)
    c = pipe("a dog barking in the rain", duration_s=0.5, seed=12)
    assert a[0].tobytes() == b[0].tobytes() and a[2] == b[2]
    assert a[0].tobytes() != c[0].tobytes()


def test_bark_width_decode_in_bf16_follows_the_fp32_cpu_decode(cuda_device):
    """Two layers at Bark's width (1,024 wide, 16 heads) in bf16 on the
    card against the same weights in float32 on the CPU: a padded prefill
    and 16 decode steps at ``top_k = 1``. The first step's logits within
    3e-2 relative L2 (bf16 weights and activations), the ids equal up to
    the first step whose top-two CPU logit gap is below 0.1."""
    import copy

    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.models.gpt import GPT, GPTConfig
    from chiaswarm_tpu_torch.pipelines.tts import _random_fill, _stage_decode

    cfg = GPTConfig(vocab_size=12_096, n_layer=2, n_head=16, n_embd=1024,
                    block_size=1024)
    cpu = GPT(cfg)
    _random_fill(cpu, torch.Generator().manual_seed(0))
    cpu.eval().requires_grad_(False)
    card = cast_module(copy.deepcopy(cpu), torch.bfloat16).to(cuda_device)
    prompt = torch.randint(0, 12_096, (1, 40),
                           generator=torch.Generator().manual_seed(1))
    masks = torch.zeros(2, cfg.out_vocab)
    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda_device)):
        steps = []
        head = model.lm_head.forward

        def kept(x, head=head, steps=steps):
            out = head(x)
            steps.append(out.float().cpu())
            return out

        model.lm_head.forward = kept
        ids = _stage_decode(model, prompt.to(dev), None, 33,
                            torch.Generator(device=dev), prefill_len=40,
                            max_new=16, top_k=1, temperature=0.0,
                            step_masks=masks.to(dev), eos_id=-1, pad_id=0)
        del model.lm_head.forward
        runs[name] = (ids.cpu()[0], [steps[0][0, 32]]
                      + [s[0, 0] for s in steps[1:]])
    first_cpu, first_card = runs["cpu"][1][0], runs["card"][1][0]
    rel = float((first_card - first_cpu).norm() / first_cpu.norm())
    assert rel <= 3e-2, rel
    for t, logits in enumerate(runs["cpu"][1]):
        top2 = logits.topk(2).values
        if float(top2[0] - top2[1]) < 0.1:
            break
        assert int(runs["card"][0][t]) == int(runs["cpu"][0][t]), t


# ---------------------------------------------------------------------------
# video: B1 over folded frames, the tiny video UNets on the card


@pytest.mark.parametrize("b,l,h,d", [
    (64, 1024, 5, 64),   # ModelScope at 256 px, 32 frames, CFG
    (32, 1024, 5, 64),   # the same at guidance 1.0
    (32, 4096, 5, 64),   # SVD at 512 px, 16 frames, CFG
    (32, 1024, 10, 64),  # SVD's second level
    (16, 7680, 8, 40),   # vid2vid's 8-frame chunk at 512x960, CFG
    (16, 1920, 8, 80),
    (8, 7680, 8, 40),    # its 4-frame chunk
    (8, 1920, 8, 80),
])
def test_kernel_matches_plain_at_video_shapes(cuda_device, b, l, h, d):
    """B1 at the spatial self-attentions of the video paths' folded frames,
    bf16, against its plain version at the kernel phase's bars."""
    q, k, v = _qkv((b, l, h, d), (b, l, h, d), torch.bfloat16, cuda_device,
                   seed=b + l + d)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2


@pytest.mark.parametrize("family", ["tiny_vid", "tiny_svd"])
def test_tiny_video_unet_on_the_card_matches_its_cpu_run(cuda_device, family):
    """The tiny video UNets (float32, TF32 off) on the card against their
    CPU run at 3 frames of 16x16 latents (256 tokens: the plain path, as
    head dim 8 is no kernel's): the temporal convs, norms and blends, and
    the frame attentions, within 1e-4."""
    import copy

    from chiaswarm_tpu_torch.pipelines.video import VideoComponents

    cpu = VideoComponents.random(family, seed=3, device="cpu")
    card = copy.deepcopy(cpu.unet).to(cuda_device)
    fam = cpu.family
    gen = torch.Generator().manual_seed(4)
    sample = torch.randn((2, 3, fam.unet.sample_channels, 16, 16),
                         generator=gen)
    ctx = torch.randn((2, 1 if fam.image_conditioned else 7,
                       fam.unet.cross_attention_dim), generator=gen)
    t = torch.tensor([0.7, -1.2] if fam.image_conditioned else [3.0, 250.0])
    ids = torch.tensor([[6.0, 127.0, 0.02], [7.0, 60.0, 0.1]])
    added = {"time_ids": ids} if fam.image_conditioned else None
    with torch.inference_mode():
        want = cpu.unet(sample, t, ctx, added)
        got = card(sample.to(cuda_device), t.to(cuda_device),
                   ctx.to(cuda_device),
                   None if added is None
                   else {"time_ids": ids.to(cuda_device)}).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert want.abs().mean() > 1e-2


@pytest.mark.parametrize("b,l,h,d,dtype", [
    (2, 4096, 8, 64, torch.bfloat16),    # IF-II-L's stage 2 and the x4
    (2, 1024, 16, 64, torch.bfloat16),   # stage 2's 1,024-token level
    (2, 16384, 8, 64, torch.bfloat16),   # the x4 at a 256x256 latent
    (2, 1024, 8, 128, torch.bfloat16),   # the x4's 1,024-channel level
    (2, 1024, 8, 128, torch.float16),
])
def test_kernel_matches_plain_at_cascade_shapes(cuda_device, b, l, h, d,
                                                dtype):
    """B1 at the DeepFloyd cascade's self-attentions (head dim 128 at the
    x4 upscaler's deepest level), against its plain version at the kernel
    phase's bars."""
    q, k, v = _qkv((b, l, h, d), (b, l, h, d), dtype, cuda_device,
                   seed=l + h + d)
    before = KERNEL.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2


def test_blocked_plain_attention_matches_sdpa_at_16384_tokens(cuda_device):
    """The plain path in blocks of queries (the bound lowered to a quarter
    of its 1 GiB, so 16,384 tokens take four blocks) at the VAE mid block's
    head dim 512, bf16, against ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    q, k, v = _qkv((1, 16384, 1, 512), (1, 16384, 1, 512), torch.bfloat16,
                   cuda_device, seed=16)
    out = tattn.xla_attention(q, k, v, 512 ** -0.5,
                              max_logits_bytes=tattn.PLAIN_LOGITS_BYTES // 4)
    ref = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2


def test_t5_block_in_bf16_on_the_card_follows_fp32_on_the_cpu(cuda_device):
    """The T5-XXL-width layer (block 0: d_model 4096, 64 heads, d_ff
    10240, the position bias and a padding mask, then the final RMSNorm)
    in bf16 on the card against float32 on the CPU: finite, within the
    bf16 bar (3e-2 relative L2). A second block drifts past the bar, on
    the card as in a bf16 run on the CPU: the unscaled scores of random
    weights make a sharp softmax."""
    import copy

    from chiaswarm_tpu_torch.models.common import cast_module
    from chiaswarm_tpu_torch.models.t5 import T5Config, T5Encoder
    from chiaswarm_tpu_torch.pipelines.cascade import init_t5

    cfg = T5Config(num_layers=1, vocab_size=512, dtype="float32")
    cpu = T5Encoder(cfg)
    init_t5(cpu, torch.Generator().manual_seed(0))
    card = cast_module(copy.deepcopy(cpu), torch.bfloat16).to(cuda_device)
    ids = torch.randint(2, 512, (2, 77), generator=torch.Generator()
                        .manual_seed(1))
    ids[1, 20:] = 0
    with torch.inference_mode():
        want = cpu(ids, ids != 0)
        got = card(ids.to(cuda_device), (ids != 0).to(cuda_device)).cpu()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 3e-2


def _detector_cases():
    """(name, class, options, conv depth): the six ControlNet detectors at
    their published widths, canvases cut to 128 px, DPT cut to 4 layers and
    UperNet to depths (1, 1, 3, 1) to keep the CPU side short."""
    import dataclasses

    from chiaswarm_tpu_torch.models import dpt, hed, lineart, mlsd
    from chiaswarm_tpu_torch.models import openpose, upernet

    dpt_cfg = dataclasses.replace(dpt.DPT_LARGE, num_layers=4,
                                  backbone_out_indices=(0, 1, 2, 3))
    seg_cfg = dataclasses.replace(upernet.UPERNET_CONVNEXT_SMALL,
                                  depths=(1, 1, 3, 1), image_size=128)
    return {
        "hed": (hed.HEDDetector, {"canvas": 128}, hed.CONV_DEPTH),
        "mlsd": (mlsd.MLSDDetector, {"canvas": 128}, mlsd.CONV_DEPTH),
        "lineart": (lineart.LineartDetector, {"canvas": 128, "n_blocks": 3},
                    lineart.conv_depth(3)),
        "openpose": (openpose.OpenposeDetector, {"box_size": 128},
                     openpose.CONV_DEPTH),
        "dpt": (dpt.DPTDetector, {"config": dpt_cfg}, dpt.CONV_DEPTH),
        "upernet": (upernet.UperNetDetector, {"config": seg_cfg},
                    upernet.conv_depth(seg_cfg)),
    }


@pytest.mark.parametrize("name", ["hed", "mlsd", "lineart", "openpose", "dpt",
                                  "upernet"])
def test_detector_on_the_card_matches_its_cpu_run(cuda_device, name):
    """A detector's network on the card against its CPU run on the same
    weights and input, with cuDNN's TF32 allowed (PyTorch's default, which
    the port serves with): within ``tf32_bar`` of its conv depth (2**-11 a
    convolution, relative to the output's largest magnitude); UperNet's
    logits, the others' host outputs."""
    import numpy as np

    from chiaswarm_tpu_torch.models.annotator import tf32_bar

    cls, opts, depth = _detector_cases()[name]
    cpu = cls.random(3, "cpu", **opts)
    card = cls.from_state(cpu.net.state_dict(), cuda_device, **opts)
    image = np.random.default_rng(4).integers(0, 256, (96, 160, 3),
                                              dtype=np.uint8)
    x, _ = cpu.prepare(image)
    torch.backends.cudnn.allow_tf32 = True
    try:
        if name == "upernet":
            t = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
            with torch.inference_mode():
                want = [cpu.net(t).numpy()]
                got = [card.net(t.to(cuda_device)).cpu().numpy()]
        else:
            want, got = cpu.forward(x), card.forward(x)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = [np.asarray(w) for w in (want if isinstance(want, (list, tuple))
                                    else [want])]
    got = [np.asarray(g) for g in (got if isinstance(got, (list, tuple))
                                   else [got])]
    scale = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert scale > 0 and err <= tf32_bar(depth) * scale, (err, scale)


def test_a_detector_with_wrong_weights_raises_on_the_card(cuda_device,
                                                          tmp_path,
                                                          monkeypatch):
    """A HED directory holding another network's weights fails the job on
    the card: the load raises, every time, and no stand-in is served."""
    from PIL import Image

    from chiaswarm_tpu_torch.convert.checkpoint import CheckpointError
    from chiaswarm_tpu_torch.models.lineart import LineartGenerator
    from chiaswarm_tpu_torch.workloads import controlnet

    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setattr(controlnet, "_DETECTORS", {})
    target = tmp_path / "models" / "hed"
    target.mkdir(parents=True)
    torch.save(LineartGenerator(1).state_dict(), target / "ControlNetHED.pth")
    image = Image.new("RGB", (64, 48), (30, 140, 200))
    for _ in range(2):
        with pytest.raises(CheckpointError, match="ControlNetHED"):
            controlnet.preprocess_image(
                image, {"preprocess": True, "type": "softedge"}, cuda_device)
    assert controlnet._DETECTORS == {}


# ---------------------------------------------------------------------------
# the rest of the SD surface: int8 weights, activation fake-quant, DeepCache
# and coalesced bursts


@pytest.mark.parametrize("b,l,h,d", [(6, 4096, 8, 40), (6, 1024, 8, 80)])
def test_kernel_matches_plain_at_a_three_row_burst(cuda_device, b, l, h, d):
    """B1 at SD1.5's batch-3 program under CFG (a three-job burst without
    the bucket's padding row): the kernel phase's bars."""
    q, k, v = _qkv((b, l, h, d), (b, l, h, d), torch.bfloat16, cuda_device)
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    diff = (out.float() - ref.float())
    assert diff.abs().max().item() <= 4e-3
    assert (diff.norm() / ref.float().norm()).item() <= 1e-2


def _sd15_unet(device, dtype=torch.bfloat16):
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.pipelines.components import Components

    return Components.random(FAMILIES["sd15"], seed=0, device=device,
                             dtype=dtype).unet


def _unet_inputs(device, hw: int, cross: int, seed: int = 3):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((2, 4, hw, hw), generator=gen).to(device)
    t = torch.tensor([901.0, 250.0], device=device)
    ctx = torch.randn((2, 77, cross), generator=gen).to(device)
    return x, t, ctx


def test_int8_unet_forward_follows_its_bf16_twin(cuda_device, monkeypatch):
    """SD1.5's UNet quantized on the card (``CHIASWARM_WEIGHTS=int8``) at a
    64x64 latent: 10 B1 launches as in bf16, the output within 5e-2
    relative L2 of the bf16 twin's (JAX's int8 gate), its weights under
    half the bytes."""
    from chiaswarm_tpu_torch.convert.quantize import (
        maybe_quantize_,
        quantized_leaf_count,
    )

    unet = _sd15_unet(cuda_device)
    x, t, ctx = _unet_inputs(cuda_device, 64, 768)
    with torch.inference_mode():
        ref = unet(x, t, ctx)
    fp_bytes = sum(p.numel() * p.element_size() for p in unet.parameters())
    monkeypatch.setenv("CHIASWARM_WEIGHTS", "int8")
    assert maybe_quantize_([unet]) > 0 and quantized_leaf_count(unet) > 0
    before = KERNEL.launches
    with torch.inference_mode():
        got = unet(x, t, ctx)
    torch.cuda.synchronize()
    assert KERNEL.launches - before == 10
    rel = ((got - ref).float().norm() / ref.float().norm()).item()
    assert 0 < rel <= 5e-2, rel
    q_bytes = sum(p.numel() * p.element_size() for p in unet.parameters())
    assert q_bytes < 0.55 * fp_bytes


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_fake_quant_on_the_card_matches_the_cpu(cuda_device, fmt):
    """``fake_quant_activation`` and ``quantize_leaf`` on the card give the
    CPU's codes (the divisor rides as a tensor: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal)."""
    from chiaswarm_tpu_torch.convert.quantize import (
        fake_quant_activation,
        fp8_supported,
        quantize_leaf,
    )

    assert fp8_supported()
    gen = torch.Generator(device="cpu").manual_seed(11)
    x = (torch.randn((2, 4096, 8, 40), generator=gen) * 3).to(torch.bfloat16)
    assert torch.equal(fake_quant_activation(x.to(cuda_device), fmt).cpu(),
                       fake_quant_activation(x, fmt))
    w = torch.randn((640, 320, 3, 3), generator=gen).to(torch.bfloat16)
    q, s = quantize_leaf(w.to(cuda_device))
    q_c, s_c = quantize_leaf(w)
    assert torch.equal(q.cpu(), q_c) and torch.equal(s.cpu(), s_c)


@pytest.mark.parametrize("family,hw,full,shallow", [
    ("sd15", 64, 10, 5), ("sdxl", 128, 70, 0)])
def test_a_shallow_eval_launches_b1_at_level_zero_only(cuda_device, family,
                                                        hw, full, shallow):
    """DeepCache's shallow replay runs only the level-0 blocks: SD1.5's five
    self-attentions at 4,096 tokens, none for SDXL (its level 0 has no
    attention); the refresh eval launches a full eval's B1, and replaying
    its own cache reproduces its output."""
    from chiaswarm_tpu_torch.models.configs import FAMILIES
    from chiaswarm_tpu_torch.pipelines.components import Components

    fam = FAMILIES[family]
    unet = Components.random(fam, seed=0, device=cuda_device).unet
    x, t, ctx = _unet_inputs(cuda_device, hw, fam.unet.cross_attention_dim)
    added = None
    if fam.unet.addition_embed_dim is not None:
        added = {"time_ids": torch.tensor(
            [[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=cuda_device),
            "text_embeds": torch.zeros((2, fam.unet.addition_pooled_dim),
                                       device=cuda_device)}
    with torch.inference_mode():
        before = KERNEL.launches
        out, deep = unet(x, t, ctx, added, return_deep=True)
        torch.cuda.synchronize()
        mid = KERNEL.launches
        replay = unet(x, t, ctx, added, cached_deep=deep)
        torch.cuda.synchronize()
    assert mid - before == full and KERNEL.launches - mid == shallow
    assert deep.shape == (2, fam.unet.block_out_channels[1], hw, hw)
    rel = ((replay - out).float().norm() / out.float().norm()).item()
    assert rel <= 1e-2, rel


# ---------------------------------------------------------------------------
# lease heartbeats and the health server on the card (tests/test_torch_lease.py
# and tests/test_torch_health.py on the CPU)


def test_a_spooled_lane_checkpoint_resumes_bit_for_bit_on_the_card(
        cuda_device, monkeypatch, tmp_path):
    """A tiny_b1 lane job on the card with the worker's checkpoint spool on
    its slot: the spool holds its step-6 state by job id; that state, through
    JSON as a hive hands it back, resumes the job in a fresh lane at step 6,
    and the image is the uninterrupted run's bit for bit, B1 at the same
    shapes."""
    import json

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.node.resilience import CheckpointSpool
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    _guard_env(monkeypatch)
    registry, slot = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    job = {"id": "spooled", "model_name": "tiny_b1", "prompt": "a red door",
           "num_inference_steps": 8, "seed": 4, "height": 64, "width": 64,
           "content_type": "image/png",
           "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler"}}

    def run(**over):
        result = synchronous_do_work(
            dict(job, parameters=dict(job["parameters"]), **over), slot,
            registry)
        get_stepper(slot).shutdown()
        return result

    kernels.reset_launches()
    ref = run()
    ref_shapes = dict(KERNEL.shapes)
    spool = CheckpointSpool(tmp_path / "spool")
    slot._checkpoint_spool = spool
    spooled = run()
    slot._checkpoint_spool = None
    assert spool.written == 3  # lane steps 2, 4 and 6
    state = json.loads(json.dumps(spool.load("spooled")))
    assert state["step"] == 6 and len(state["generators"]) == 1
    kernels.reset_launches()
    resumed = run(resume=state)
    stamp = resumed["pipeline_config"]["stepper"]
    assert stamp["resume_step"] == 6 and stamp["steps_executed"] == 2
    assert (_png_u8(spooled) == _png_u8(ref)).all()
    assert (_png_u8(resumed) == _png_u8(ref)).all()
    assert KERNEL.launches > 0 and set(KERNEL.shapes) <= set(ref_shapes)


def test_a_profiler_capture_on_the_card_holds_b1s_kernel_events(
        cuda_device, monkeypatch, tmp_path):
    """``obs/profiling.py::capture`` on the card while a tiny_b1 lane steps
    records CUDA activity, B1's kernel among it, and a second capture at the
    same time answers busy."""
    import threading

    from chiaswarm_tpu_torch.node.executor import synchronous_do_work
    from chiaswarm_tpu_torch.obs import profiling
    from chiaswarm_tpu_torch.serving.stepper import get_stepper

    _guard_env(monkeypatch)
    registry, slot = _tiny_b1(monkeypatch, tmp_path, cuda_device)
    job = {"id": "profiled", "model_name": "tiny_b1", "prompt": "a red door",
           "num_inference_steps": 40, "seed": 4, "height": 64, "width": 64,
           "content_type": "image/png"}
    synchronous_do_work(dict(job), slot, registry)  # warm
    done = threading.Event()

    def serve():
        try:
            synchronous_do_work(dict(job), slot, registry)
        finally:
            done.set()

    server = threading.Thread(target=serve)
    server.start()
    got = {}
    capturer = threading.Thread(target=lambda: got.update(
        profiling.capture(0.5, str(tmp_path / "captures"))))
    capturer.start()
    while not profiling._CAPTURE_LOCK.locked():
        threading.Event().wait(0.001)
    busy = profiling.capture(0.1, str(tmp_path / "captures"))
    capturer.join()
    server.join()
    get_stepper(slot).shutdown()
    assert busy["status"] == "busy"
    assert got["status"] == "ok", got
    assert got["activities"] == ["CPU", "CUDA"] and got["device_events"] > 0
    assert any("flash_fwd" in name for name in got["kernels"])


# ---------------------------------------------------------------------------
# the numerics taps on the card (tests/test_torch_numerics.py on the CPU)


def test_a_tapped_b1_call_records_the_plain_versions_summary(cuda_device,
                                                            monkeypatch):
    """``attn.out`` of one B1 launch at SD1.5's (2,4096,4096,8,40) bf16
    against the same summary of the plain version's output on the same
    q, k, v, within B1's bars (4e-3 absolute plus 1e-2 relative); the
    summary queued on the card and read back when the ring is read."""
    from chiaswarm_tpu_torch.obs import numerics

    monkeypatch.setenv("CHIASWARM_NUMERICS", "attn.out")
    q, k, v = _qkv((2, 4096, 8, 40), (2, 4096, 8, 40), torch.bfloat16,
                   cuda_device, seed=20)
    numerics.RING.clear()
    before = KERNEL.launches
    tattn.attention(q, k, v)
    assert KERNEL.launches - before == 1
    assert numerics.RING.pending() == 1
    [rec] = numerics.RING.drain()
    want, size = numerics.summarize(flash_attention_plain(q, k, v))
    want = dict(zip(numerics.SUMMARY_FIELDS, want.tolist()))
    assert rec["probe"] == "attn.out" and rec["size"] == size
    assert rec["nonfinite"] == 0 == want["nonfinite"]
    for field in ("l2", "mean", "absmax"):
        assert abs(rec[field] - want[field]) <= 4e-3 + 1e-2 * abs(
            want[field]), (field, rec, want)


def test_taps_launch_no_kernel_of_the_port(cuda_device, monkeypatch):
    """B1, then B3 and the scan drive over B2 on a 4-shard ring on one
    card: the same launches and the same outputs with every probe off and
    on."""
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.obs import numerics
    from chiaswarm_tpu_torch.ops import kernels
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    mesh = build_mesh(MeshSpec({"seq": 4}), devices=[cuda_device] * 4)
    q, k, v = _qkv((2, 4096, 8, 40), (2, 4096, 8, 40), torch.bfloat16,
                   cuda_device, seed=21)

    def run(taps: str | None):
        if taps is None:
            monkeypatch.delenv("CHIASWARM_NUMERICS", raising=False)
        else:
            monkeypatch.setenv("CHIASWARM_NUMERICS", taps)
        numerics.RING.clear()
        kernels.reset_launches()
        outs = [tattn.attention(q, k, v)]
        for mode in ("", "scan"):
            monkeypatch.setenv("CHIASWARM_RING_FLASH", mode)
            outs.append(tring.ring_flash_attention(q, k, v, mesh=mesh))
        torch.cuda.synchronize()
        return ({n: (kern.launches, dict(kern.shapes))
                 for n, kern in kernels.KERNELS.items()},
                outs, len(numerics.RING))

    off, off_outs, off_records = run(None)
    on, on_outs, on_records = run("1")
    assert off == on
    assert off["flash_attention"][0] == 1
    assert off["ring_flash_fused"][0] == 1 and off["ring_flash_hop"][0] == 16
    assert off_records == 0 and on_records == 4 + 4 + 4 * 4 * 3 + 4
    for a, b in zip(off_outs, on_outs):
        assert torch.equal(a, b)
