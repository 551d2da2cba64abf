"""Kernel B1 and the attention dispatcher of the PyTorch port, held against
the JAX package: ``flash_attention_plain`` and ``attention(impl="flash")``
against the Pallas kernel in interpret mode, ``attention(impl="xla")``
against ``_xla_attention``. Inputs come from numpy and go to both sides.

Tolerances: 2e-4 in float32 (the bar of tests/test_ops.py; only the order
of float32 sums differs), 3e-2 in bfloat16 (bf16 inputs and outputs carry
8 mantissa bits). The CUDA kernel itself runs only on a GPU: its tests are
in tests/test_torch_gpu.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.ops.attention import _xla_attention
from chiaswarm_tpu.ops.flash_attention import flash_attention as jax_flash
from chiaswarm_tpu_torch.ops import attention as tattn
from chiaswarm_tpu_torch.ops import flash_attention as tflash
from chiaswarm_tpu_torch.ops.flash_attention import (
    KERNEL,
    SUPPORTED_HEAD_DIMS,
    flash_attention,
    flash_attention_plain,
)

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = [
    (2, 64, 64, 4, 40),     # the tests/test_ops.py cases
    (1, 100, 77, 2, 64),
    (1, 300, 300, 2, 80),
    (2, 128, 128, 1, 128),
    (1, 96, 96, 2, 40),     # SD1.5 head dims 40/80/160
    (1, 64, 130, 2, 80),
    (1, 70, 70, 1, 160),
    (1, 33, 1000, 1, 64),   # ragged lengths across KV blocks
]


def _qkv(b, l, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("b,l,s,h,d", CASES)
def test_plain_matches_jax_flash_interpret(b, l, s, h, d, monkeypatch):
    q, k, v = _qkv(b, l, s, h, d)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    block_q=64, block_kv=64, interpret=True)
    monkeypatch.setattr(tflash, "BLOCK_KV", 64)
    got = flash_attention_plain(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,l,s,h,d", CASES)
def test_xla_impl_matches_jax_xla_attention(b, l, s, h, d):
    q, k, v = _qkv(b, l, s, h, d, seed=1)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         d ** -0.5)
    got = tattn.attention(*_t(q, k, v), impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("block_kv", [16, 64, 512])
def test_flash_impl_on_cpu_is_the_plain_recurrence(block_kv, monkeypatch):
    q, k, v = _qkv(1, 90, 150, 2, 40, seed=2)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 40 ** -0.5))
    monkeypatch.setattr(tflash, "BLOCK_KV", block_kv)
    got = flash_attention_plain(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    before = KERNEL.launches
    via_dispatch = tattn.attention(*_t(q, k, v), impl="flash")
    np.testing.assert_allclose(via_dispatch.numpy(), ref, rtol=2e-4, atol=2e-4)
    assert KERNEL.launches == before  # a CPU tensor never launches


def test_bf16_io_within_bf16_tolerance():
    """bf16 in, bf16 out; fp32 state inside (JAX: test_flash_bf16_io)."""
    q, k, v = _qkv(1, 96, 96, 2, 40, seed=3)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref_flash = jax_flash(qb, kb, vb, block_q=32, block_kv=32, interpret=True)
    got = flash_attention_plain(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref_flash, np.float32),
                               rtol=3e-2, atol=3e-2)
    ref_xla = _xla_attention(qb, kb, vb, 40 ** -0.5)
    got_xla = tattn.attention(*_t(q, k, v, dtype=torch.bfloat16), impl="xla")
    assert got_xla.dtype == torch.bfloat16
    np.testing.assert_allclose(got_xla.float().numpy(),
                               np.asarray(ref_xla, np.float32),
                               rtol=3e-2, atol=3e-2)


def _tensor_core_numerics(q, k, v, block_kv):
    """The arithmetic of B1's and B3's tensor-core route in plain PyTorch:
    16-bit q and k multiplied with fp32 sums, the fp32 running max and
    denominator (l summed from the fp32 p), and P·V with p rounded to q's
    type, over K/V tiles of ``block_kv`` keys; output in q's type."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m = torch.full(qf.shape[:-1] + (1,), tflash.NEG_INF)
    denom = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for start in range(0, kf.shape[2], block_kv):
        kb, vb = kf[:, :, start:start + block_kv], vf[:, :, start:start + block_kv]
        logits = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        m_next = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(logits - m_next)
        denom = alpha * denom + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(q.dtype).float(), vb)
        m = m_next
    return (acc / denom).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("b,l,s,h,d", [(1, 200, 200, 2, 40), (1, 72, 72, 2, 80)])
def test_bf16_p_in_pv_stays_inside_the_kernel_bars(b, l, s, h, d):
    """The numerics the tensor-core route settles on: p rounded to bf16 for
    P·V only, l from the fp32 p. Held against the JAX flash kernel in
    interpret mode (fp32 p) on the same bf16-valued inputs, and against the
    port's plain version in bf16, within the bars chip_smoke.py holds the
    kernels to on the card: 4e-3 max abs and 1e-2 relative L2. K/V tiles of
    64 keys at D = 40 and 128 at D = 80, as the kernel takes them."""
    q, k, v = _t(*_qkv(b, l, s, h, d, seed=7), dtype=torch.bfloat16)
    got = _tensor_core_numerics(q, k, v, block_kv=64 if d == 40 else 128)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jax_flash(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                               block_q=64, block_kv=64, interpret=True))
    plain = flash_attention_plain(q, k, v).float().numpy()
    for want in (ref, plain):
        diff = got.float().numpy() - want
        assert np.abs(diff).max() <= 4e-3
        assert np.linalg.norm(diff) / np.linalg.norm(want) <= 1e-2
    # rounding p moves the output: the check would see a kernel that kept
    # p in fp32 and one that rounded it as different
    assert not torch.equal(got, flash_attention_plain(q, k, v))


def test_auto_keeps_cpu_tensors_on_the_plain_path(monkeypatch):
    monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    q, k, v = _t(*_qkv(1, 1024, 1024, 1, 40, seed=4))
    before = KERNEL.launches
    out = tattn.attention(q, k, v)
    ref = tattn.xla_attention(q, k, v, 40 ** -0.5)
    assert torch.equal(out, ref)
    assert KERNEL.launches == before


def test_env_override_and_ring_kinds(monkeypatch):
    q, k, v = _t(*_qkv(1, 32, 32, 2, 40, seed=5))
    monkeypatch.setenv("CHIASWARM_ATTENTION", "flash")
    np.testing.assert_allclose(tattn.attention(q, k, v).numpy(),
                               tattn.attention(q, k, v, impl="xla").numpy(),
                               rtol=2e-4, atol=2e-4)
    # explicit ring kinds are a caller contract: no seq mesh -> raise
    for kind in ("ring", "ring_flash"):
        with pytest.raises(ValueError, match="sequence-parallel"):
            tattn.attention(q, k, v, impl=kind)
    # the env knob is advisory: it falls back to the local paths
    monkeypatch.setenv("CHIASWARM_ATTENTION", "ring_flash")
    out = tattn.attention(q, k, v)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="einsum")


@pytest.mark.parametrize("env,device,tokens,want", [
    (None, "cuda", 1024, "flash"),
    (None, "cuda", 1023, "xla"),
    (None, "cpu", 4096, "xla"),
    ("flash", "cuda", 77, "flash"),
    ("flash", "cpu", 64, "flash"),
    ("xla", "cuda", 1023, "xla"),
    ("xla", "cpu", 4096, "xla"),
    ("ring_flash", "cuda", 4096, "flash"),
    ("ring", "cuda", 256, "xla"),
])
def test_auto_route_under_the_env_knob(env, device, tokens, want,
                                       monkeypatch):
    if env is None:
        monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("CHIASWARM_ATTENTION", env)
    assert tattn._route("auto", device, tokens, tokens) == want
    # explicit kinds are never steered by the knob
    assert tattn._route("xla", device, tokens, tokens) == "xla"
    assert tattn._route("flash", device, tokens, tokens) == "flash"


def test_env_knob_never_moves_card_work_off_the_kernel(monkeypatch):
    """CHIASWARM_ATTENTION=xla raises where auto would launch B1 on the card:
    a CUDA call at >= 1024 tokens goes through the kernel or raises."""
    monkeypatch.setenv("CHIASWARM_ATTENTION", "xla")
    for l, s in ((1024, 1024), (4096, 4096), (4096, 77 * 20)):
        with pytest.raises(ValueError, match="off kernel B1"):
            tattn._route("auto", "cuda", l, s)


def test_wrapper_checks_shapes():
    q, k, v = _t(*_qkv(1, 16, 16, 2, 40, seed=6))
    with pytest.raises(ValueError, match="differ"):
        flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError, match="disagree"):
        flash_attention(q, k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="mixed dtypes"):
        flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match="expected"):
        flash_attention(q[0], k, v)


def test_supported_head_dims_cover_sd_unets():
    from chiaswarm_tpu_torch.models.configs import FAMILIES

    for name in ("sd15", "sd21", "sdxl"):
        cfg = FAMILIES[name].unet
        for level, ch in enumerate(cfg.block_out_channels):
            if cfg.transformer_depth[level]:
                assert cfg.heads_for(ch, level)[1] in SUPPORTED_HEAD_DIMS


def test_jax_reference_runs_on_cpu():
    assert jax.default_backend() == "cpu"
