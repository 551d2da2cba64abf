"""Sequence-parallel serving of the PyTorch port against the JAX package:
kernel B2's and B3's plain versions, the ring drive over each and the plain
ring oracle, the dispatch under a seq mesh, the mesh copies, and the tiny
pipeline and executor on a seq = 4 mesh.

Inputs come from numpy and go to both sides. The JAX side runs on the
suite's 8-device CPU platform (tests/conftest.py), with ``_hop_kernel`` in
Pallas interpret mode as tests/test_ring_flash.py runs it. The port's CPU
meshes name the CPU device once per shard, as a one-card CUDA mesh names
``cuda:0`` once per shard.

Tolerances: 2e-4 in float32 (the repo's ring and flash bar; only the order
of float32 sums differs), uint8 images within one level (convention 3 of
ROADMAP: a value on a rounding boundary may truncate either way). The CUDA
kernels themselves run only on a GPU: their tests are in
tests/test_torch_gpu.py.
"""

from __future__ import annotations

import base64
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chiaswarm_tpu.core import mesh as jax_mesh
from chiaswarm_tpu.core.compat import shard_map, shard_map_unchecked
from chiaswarm_tpu.ops.flash_attention import _LANES, _pad_to
from chiaswarm_tpu.ops.ring_flash_attention import _hop_call
from chiaswarm_tpu.ops.ring_flash_attention import (
    ring_flash_attention as jax_ring_flash,
)
from chiaswarm_tpu.parallel.ring_attention import (
    ring_attention as jax_ring_attention,
)
from chiaswarm_tpu_torch.core import mesh as port_mesh
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.ops import attention as tattn
from chiaswarm_tpu_torch.ops import flash_attention as tflash
from chiaswarm_tpu_torch.ops import ring_flash_attention as tring
from chiaswarm_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_plain
from chiaswarm_tpu_torch.parallel.context import (
    active_seq_mesh,
    capture_ring_calls,
    sequence_parallel,
)
from chiaswarm_tpu_torch.parallel.ring_attention import KVRing, ring_attention

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


RTOL = ATOL = 2e-4
SPEC = P(None, "seq", None, None)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(seed, b, l, s, h, d):
    return _arrays(seed, (b, l, h, d), (b, s, h, d), (b, s, h, d))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def cpu_mesh(sp: int, **axes):
    return build_mesh(MeshSpec({"seq": sp, **axes}),
                      devices=["cpu"] * sp * int(np.prod(list(axes.values()) or [1])))


def jax_seq_mesh(sp: int):
    return jax_mesh.build_mesh(jax_mesh.MeshSpec({"seq": sp}),
                               devices=jax.devices()[:sp])


# ---------------------------------------------------------------------------
# 1. B2's plain version against the JAX hop kernel in interpret mode


def _fold(x, block):
    """(B, L, H, D) numpy -> the JAX hop's (B·H, Lp, Dp) padded layout."""
    b, l, h, d = x.shape
    f = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, l, d)
    return _pad_to(_pad_to(f, 1, block), 2, _LANES)


def _unfold_state(m, lsum, acc, b, l, h, d):
    """The JAX hop's folded state -> the port's m, l (B, H, L) and acc
    (B, L, H, D)."""
    m = np.asarray(m)[:, :l, 0].reshape(b, h, l)
    lsum = np.asarray(lsum)[:, :l, 0].reshape(b, h, l)
    acc = np.asarray(acc)[:, :l, :d].reshape(b, h, l, d).transpose(0, 2, 1, 3)
    return m, lsum, acc


@pytest.mark.parametrize("b,l,s,h,d,block", [
    (1, 64, 64, 2, 40, 32),
    (2, 48, 48, 1, 80, 16),
    (1, 64, 64, 1, 512, 32),
    (1, 100, 70, 2, 40, 32),   # ragged: L and S not multiples of the block
])
def test_hop_plain_matches_jax_hop_kernel(b, l, s, h, d, block, monkeypatch):
    q, k0, v0 = _qkv(d, b, l, s, h, d)
    k1, v1 = _arrays(d + 1, (b, s, h, d), (b, s, h, d))
    scale = d ** -0.5
    qf = _fold(q, block)
    bh, lp, dp = qf.shape
    hop = partial(_hop_call, scale=scale, kv_len=s, block_q=block,
                  block_kv=block, interpret=True)
    # a first hop from the initial state gives a non-trivial incoming state
    state0 = (jnp.full((bh, lp, _LANES), NEG_INF, jnp.float32),
              jnp.zeros((bh, lp, _LANES), jnp.float32),
              jnp.zeros((bh, lp, dp), jnp.float32))
    state1 = hop(qf, _fold(k0, block), _fold(v0, block), *state0)
    state2 = hop(qf, _fold(k1, block), _fold(v1, block), *state1)
    m1, l1, acc1 = _unfold_state(*state1, b, l, h, d)
    want = _unfold_state(*state2, b, l, h, d)
    assert np.all(l1 > 0) and np.abs(acc1).max() > 0.1

    monkeypatch.setattr(tflash, "BLOCK_KV", block)
    got = tring.ring_flash_hop(*_t(q, k1, v1, m1, l1, acc1), scale=scale)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_hop_wrapper_on_cpu_never_launches_and_checks_state():
    q, k, v = _t(*_qkv(1, 1, 16, 16, 2, 40))
    m = torch.full((1, 2, 16), NEG_INF)
    lsum, acc = torch.zeros(1, 2, 16), torch.zeros(1, 16, 2, 40)
    before = tring.KERNEL.launches
    out = tring.ring_flash_hop(q, k, v, m, lsum, acc)
    assert tring.KERNEL.launches == before
    assert all(o is not i for o, i in zip(out, (m, lsum, acc)))  # new tensors
    with pytest.raises(ValueError, match="does not fit"):
        tring.ring_flash_hop(q, k, v, m[:, :1], lsum, acc)
    with pytest.raises(ValueError, match="float32"):
        tring.ring_flash_hop(q, k, v, m, lsum, acc.double())


def _tensor_core_hop(q, k, v, m, lsum, acc, *, scale, block_kv):
    """The arithmetic of B2's tensor-core route over one K/V shard in plain
    PyTorch: 16-bit q and k multiplied with fp32 sums, the fp32 running max
    and denominator (l summed from the fp32 p), and P·V with p rounded to
    q's type, over K/V tiles of ``block_kv`` keys (the last one ragged).
    The state goes in and comes out in fp32, in B2's layouts."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m, lsum = m[..., None], lsum[..., None]
    acc = acc.permute(0, 2, 1, 3)
    for start in range(0, kf.shape[2], block_kv):
        kb, vb = kf[:, :, start:start + block_kv], vf[:, :, start:start + block_kv]
        logits = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        m_next = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(logits - m_next)
        lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(q.dtype).float(), vb)
        m = m_next
    return m[..., 0], lsum[..., 0], acc.permute(0, 2, 1, 3)


@pytest.mark.parametrize("d", [40, 80])
def test_tensor_core_hop_chain_stays_inside_the_kernel_bars(d):
    """The numerics of B2's tensor-core route chained over a 4-hop ring (the
    state kept in fp32 between hops, p rounded to bf16 in every hop), held
    against the JAX ``_hop_call`` chained in interpret mode (fp32 p) on the
    same bf16-valued inputs and against the port's fp32-p plain hop chain,
    within the bars chip_smoke.py holds B2 to on the card: 4e-3 max abs and
    1e-2 relative L2 on acc / l. K/V tiles of 64 keys at D = 40 and 128 at
    D = 80, as the kernel takes them; 100 keys a shard, so tiles are ragged."""
    b, l, s, h, hops, block = 2, 96, 100, 2, 4, 32
    scale = d ** -0.5
    rng = np.random.default_rng(d)
    bf16 = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in [(b, l, h, d)] + [(b, s, h, d)] * (2 * hops)]
    q, kv = bf16[0], list(zip(bf16[1::2], bf16[2::2]))
    as_np = [t.float().numpy() for t in bf16]

    qf = _fold(as_np[0], block)
    bh, lp, dp = qf.shape
    hop = partial(_hop_call, scale=scale, kv_len=s, block_q=block,
                  block_kv=block, interpret=True)
    jax_state = (jnp.full((bh, lp, _LANES), NEG_INF, jnp.float32),
                 jnp.zeros((bh, lp, _LANES), jnp.float32),
                 jnp.zeros((bh, lp, dp), jnp.float32))
    for i in range(hops):
        jax_state = hop(qf, _fold(as_np[1 + 2 * i], block),
                        _fold(as_np[2 + 2 * i], block), *jax_state)
    _, jax_l, jax_acc = _unfold_state(*jax_state, b, l, h, d)

    start = (torch.full((b, h, l), NEG_INF), torch.zeros(b, h, l),
             torch.zeros(b, l, h, d))
    tc, plain = start, start
    for k, v in kv:
        tc = _tensor_core_hop(q, k, v, *tc, scale=scale,
                              block_kv=64 if d == 40 else 128)
        plain = tring.ring_flash_hop(q, k, v, *plain, scale=scale)
    got = (tc[2] / tc[1].transpose(1, 2)[..., None]).numpy()
    plain_out = (plain[2] / plain[1].transpose(1, 2)[..., None]).numpy()
    jax_out = jax_acc / jax_l.transpose(0, 2, 1)[..., None]
    for want in (jax_out, plain_out):
        diff = got - want
        assert np.abs(diff).max() <= 4e-3
        assert np.linalg.norm(diff) / np.linalg.norm(want) <= 1e-2
    # rounding p moves the state: a kernel that kept the fp32 p and one that
    # rounded it are told apart
    assert np.abs(got - plain_out).max() > 0


# ---------------------------------------------------------------------------
# 2, 3. the two ring drives against the JAX rings


def _counting(monkeypatch, name):
    """Replace ``tring.<name>`` by a wrapper that records each call's q
    shape; returns the record."""
    calls = []
    real = getattr(tring, name)

    def counting(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(tring, name, counting)
    return calls


@pytest.mark.parametrize("mode", ["", "scan"])
@pytest.mark.parametrize("sp", [4, 8])
def test_ring_flash_matches_jax_ring_flash_and_unsharded(sp, mode,
                                                         monkeypatch):
    """Both drives: B3's plain version (the default for a ring on one
    device) and the scan drive over B2's plain version."""
    monkeypatch.setenv("CHIASWARM_RING_FLASH", mode)
    fused = _counting(monkeypatch, "ring_flash_fused_plain")
    hops = _counting(monkeypatch, "ring_flash_hop_plain")
    b, l, h, d = 2, 128, 2, 32
    q, k, v = _qkv(sp, b, l, l, h, d)
    mesh = jax_seq_mesh(sp)
    ref = jax.jit(shard_map_unchecked(
        partial(jax_ring_flash, axis_name="seq",
                mesh_axis_names=tuple(mesh.axis_names)),
        mesh=mesh, in_specs=(SPEC, SPEC, SPEC), out_specs=SPEC))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v)
    before = (tring.KERNEL.launches, tring.FUSED_KERNEL.launches)
    got = tring.ring_flash_attention(tq, tk, tv, mesh=cpu_mesh(sp))
    assert (tring.KERNEL.launches, tring.FUSED_KERNEL.launches) == before
    if mode == "scan":
        assert fused == [] and hops == [(b, l // sp, h, d)] * sp * sp
    else:
        assert fused == [(b, l, h, d)] and hops == []
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               flash_attention_plain(tq, tk, tv).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,l,s,h,d,shards", [
    (1, 96, 64, 2, 40, 4),    # S != L
    (2, 90, 90, 1, 80, 3),    # three shards
    (1, 48, 40, 2, 512, 2),   # the VAE's head dim
    (1, 30, 50, 2, 16, 1),    # one shard: flash attention
])
def test_fused_plain_matches_jax_flash_and_unsharded(b, l, s, h, d, shards,
                                                     monkeypatch):
    """B3's wrapper on CPU tensors: its plain version, never the kernel,
    against the JAX flash attention in interpret mode and the port's
    unsharded plain flash."""
    from chiaswarm_tpu.ops.flash_attention import (
        flash_attention as jax_flash,
    )

    monkeypatch.setattr(tflash, "BLOCK_KV", 16)  # several blocks per shard
    q, k, v = _qkv(30 + d, b, l, s, h, d)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    interpret=True)
    tq, tk, tv = _t(q, k, v)
    before = tring.FUSED_KERNEL.launches
    got = tring.ring_flash_fused(tq, tk, tv, shards=shards)
    assert tring.FUSED_KERNEL.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               flash_attention_plain(tq, tk, tv).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_fused_wrapper_checks_its_inputs():
    q, k, v = _t(*_qkv(21, 1, 10, 12, 2, 8))
    with pytest.raises(ValueError, match="do not split"):
        tring.ring_flash_fused(q, k, v, shards=4)
    with pytest.raises(ValueError, match="differ"):
        tring.ring_flash_fused(q, k, v[:, :8], shards=2)
    with pytest.raises(ValueError, match="mixed dtypes"):
        tring.ring_flash_fused(q, k.double(), v.double(), shards=2)
    assert tring.ring_flash_fused(q, k, v, shards=2).shape == q.shape


def test_plain_ring_matches_jax_ring_attention():
    b, l, h, d = 2, 64, 2, 16
    q, k, v = _qkv(11, b, l, l, h, d)
    mesh = jax_seq_mesh(4)
    ref = jax.jit(shard_map(
        partial(jax_ring_attention, axis_name="seq"),
        mesh=mesh, in_specs=(SPEC, SPEC, SPEC), out_specs=SPEC))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ring_attention(*_t(q, k, v), mesh=cpu_mesh(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_kv_ring_rotates_into_alternating_receive_buffers():
    k, v = _t(*_arrays(12, (1, 8, 1, 2), (1, 8, 1, 2)))
    k0, v0 = k.clone(), v.clone()
    ring = KVRing(k, v, [torch.device("cpu")] * 4)
    assert ring.current[0][0].data_ptr() == k.data_ptr()  # hop 0 reads k
    seen = []
    for hop in range(4):
        # at hop h, shard i holds the block that started on shard i - h
        for i in range(4):
            start = ((i - hop) % 4) * 2
            assert torch.equal(ring.current[i][0], k[:, start:start + 2])
            assert torch.equal(ring.current[i][1], v[:, start:start + 2])
        seen.append(ring.current[0][0].data_ptr())
        if hop < 3:
            ring.rotate()
    assert seen[1] == seen[3] != seen[2]  # two receive buffers alternate
    assert torch.equal(k, k0) and torch.equal(v, v0)  # inputs never written


# ---------------------------------------------------------------------------
# 4. dispatch under sequence_parallel(mesh)


def test_dispatch_rings_large_self_attention_only(monkeypatch):
    monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    q, k, v = _t(*_qkv(13, 1, 1024, 1024, 1, 8))
    cross_k, cross_v = _t(*_arrays(14, (1, 77, 1, 8), (1, 77, 1, 8)))
    odd = _t(*_qkv(15, 1, 1026, 1026, 1, 8))
    with capture_ring_calls() as calls, sequence_parallel(cpu_mesh(4)):
        got = tattn.attention(q, k, v)
        # auto on CPU: the drive the card serves, on plain versions
        assert calls == [("ring_flash", (1, 1024, 1, 8))]
        via_xla = tattn.attention(q, k, v, impl="xla")  # pinned xla rings too
        assert len(calls) == 2
        tattn.attention(q, cross_k, cross_v)            # cross: local
        tattn.attention(*odd)                           # 1026 % 4: local
        tattn.attention(q[:, :512], k[:, :512], v[:, :512])  # < 1024: local
        assert len(calls) == 2
    ref = tattn.xla_attention(q, k, v, 8 ** -0.5)
    for out in (got, via_xla):
        np.testing.assert_allclose(out.numpy(), ref.numpy(),
                                   rtol=RTOL, atol=ATOL)
    with capture_ring_calls() as calls:
        tattn.attention(q, k, v)  # no mesh: never rings
    assert calls == []


def test_ring_min_tokens_knob_is_honoured(monkeypatch):
    q, k, v = _t(*_qkv(16, 1, 64, 64, 2, 8))
    with capture_ring_calls() as calls, sequence_parallel(cpu_mesh(4)):
        tattn.attention(q, k, v)
        assert calls == []
        monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 64)
        tattn.attention(q, k, v)
        assert calls == [("ring_flash", (1, 64, 2, 8))]
        monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 65)
        tattn.attention(q, k, v)
        tattn.attention(q, k, v, impl="ring")  # ring kinds ignore the bar
        assert [c[0] for c in calls] == ["ring_flash", "ring_flash"]


def test_explicit_ring_flash_runs_b2_plain_version(monkeypatch):
    """Under CHIASWARM_RING_FLASH=scan an explicit ring runs the scan drive
    over B2's plain version."""
    monkeypatch.setenv("CHIASWARM_RING_FLASH", "scan")
    q, k, v = _t(*_qkv(17, 2, 64, 64, 2, 16))
    hops = _counting(monkeypatch, "ring_flash_hop_plain")
    before = tring.KERNEL.launches
    with capture_ring_calls() as calls, sequence_parallel(cpu_mesh(4)):
        got = tattn.attention(q, k, v, impl="ring_flash")
        # cross-attention stays local even for ring kinds
        cross = tattn.attention(q, k[:, :7], v[:, :7], impl="ring_flash")
    assert calls == [("ring_flash", (2, 64, 2, 16))]
    assert hops == [(2, 16, 2, 16)] * 16  # 4 shards x 4 hops
    assert tring.KERNEL.launches == before  # CPU tensors never launch
    assert cross.shape == q.shape
    np.testing.assert_allclose(got.numpy(),
                               tattn.xla_attention(q, k, v, 0.25).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_env_ring_flash_is_advisory_on_and_off_the_mesh(monkeypatch):
    monkeypatch.setenv("CHIASWARM_ATTENTION", "ring_flash")
    monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 1)
    q, k, v = _t(*_qkv(18, 1, 32, 32, 2, 8))
    with capture_ring_calls() as calls:
        with sequence_parallel(cpu_mesh(4)):
            on = tattn.attention(q, k, v)
        off = tattn.attention(q, k, v)  # no mesh: the local auto pick
    assert calls == [("ring_flash", (1, 32, 2, 8))]
    for out in (on, off):
        np.testing.assert_allclose(
            out.numpy(), tattn.xla_attention(q, k, v, 8 ** -0.5).numpy(),
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl,env,device,tokens,sp,want", [
    ("auto", None, "cuda", 4096, 4, "ring_flash"),
    ("auto", None, "cuda", 1024, 4, "ring_flash"),
    ("auto", None, "cuda", 256, 4, "xla"),        # below the ring bar
    ("auto", None, "cuda", 1024, 3, "flash"),     # indivisible: local B1
    ("auto", None, "cpu", 4096, 4, "ring_flash"),  # CPU runs the same drive
    ("xla", None, "cuda", 4096, 4, "ring_flash"),  # the VAE's pinned impl
    ("flash", None, "cuda", 4096, 4, "ring_flash"),
    ("ring", None, "cuda", 256, 4, "ring_flash"),  # both ring kinds alike
    ("ring_flash", None, "cpu", 64, 4, "ring_flash"),
    ("auto", "xla", "cuda", 4096, 4, "ring_flash"),  # never off B2
    ("auto", "flash", "cpu", 4096, 4, "ring_flash"),
    ("auto", "ring_flash", "cpu", 64, 4, "ring_flash"),
    ("auto", "ring_flash", "cuda", 4096, 1, "flash"),  # advisory off-mesh
])
def test_route_under_a_seq_mesh(impl, env, device, tokens, sp, want,
                                monkeypatch):
    if env is None:
        monkeypatch.delenv("CHIASWARM_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("CHIASWARM_ATTENTION", env)
    assert tattn._route(impl, device, tokens, tokens, sp) == want


def test_env_knob_never_moves_ring_work_off_b2(monkeypatch):
    """Under a seq mesh every steered kind rings a large self-attention, so
    no knob moves it off the ring kernels; below the bar the knob steers
    freely."""
    for env in ("ring", "ring_flash", "xla", "flash", "auto"):
        monkeypatch.setenv("CHIASWARM_ATTENTION", env)
        assert tattn._route("auto", "cuda", 4096, 4096, 4) == "ring_flash"
        assert tattn._route("auto", "cpu", 4096, 4096, 4) == "ring_flash"
    monkeypatch.setenv("CHIASWARM_ATTENTION", "ring")
    assert tattn._route("auto", "cuda", 256, 256, 4) == "ring_flash"
    monkeypatch.setenv("CHIASWARM_ATTENTION", "flash")
    assert tattn._route("auto", "cuda", 256, 256, 4) == "flash"


@pytest.mark.parametrize("axes", [{"data": 2}, {"model": 2}])
def test_two_axis_seq_mesh_raises_naming_queue_item_7(axes):
    mesh = cpu_mesh(4, **axes)
    with pytest.raises(NotImplementedError, match="queue item 7"):
        with sequence_parallel(mesh):
            pass
    q, k, v = _t(*_qkv(19, 2, 64, 64, 2, 8))
    with pytest.raises(NotImplementedError, match="queue item 7"):
        tring.ring_flash_attention(q, k, v, mesh=mesh)
    with pytest.raises(NotImplementedError, match="queue item 7"):
        ring_attention(q, k, v, mesh=mesh)


def test_fused_mode_raises_naming_b3(monkeypatch):
    """B3 is one launch on q's device: asked for over a ring whose shards
    sit on other devices, it raises rather than run the scan drive."""
    monkeypatch.setenv("CHIASWARM_RING_FLASH", "fused")
    q, k, v = _t(*_qkv(20, 1, 64, 64, 2, 8))
    spread = build_mesh(MeshSpec({"seq": 4}), devices=["cpu", "meta"] * 2)
    with sequence_parallel(spread):
        with pytest.raises(NotImplementedError, match="B3"):
            tattn.attention(q, k, v, impl="ring_flash")
    fused = _counting(monkeypatch, "ring_flash_fused_plain")
    with sequence_parallel(cpu_mesh(4)):
        assert tattn.attention(q, k, v, impl="ring_flash").shape == q.shape
    assert fused == [(1, 64, 2, 8)]


def test_context_is_a_noop_without_a_seq_axis():
    with sequence_parallel(None):
        assert active_seq_mesh() is None
    with sequence_parallel(cpu_mesh(1)):
        assert active_seq_mesh() is None
    mesh = cpu_mesh(2)
    with sequence_parallel(mesh):
        assert active_seq_mesh() is mesh
    assert active_seq_mesh() is None


# ---------------------------------------------------------------------------
# 5. the mesh copies, pinned to their source


@pytest.mark.parametrize("shape,n", [
    ({"seq": 4}, 4), ({"data": -1}, 6), ({"data": 2, "seq": -1}, 8),
    ({"data": 2, "model": 2, "seq": 2}, 8), ({"seq": 3}, 4),
    ({"data": -1, "seq": -1}, 4), ({"data": -1}, 0), ({"rows": 2}, 2),
    ({"data": 4, "seq": -1}, 6),
])
def test_mesh_spec_resolve_matches_jax(shape, n):
    def outcome(spec_cls):
        try:
            return spec_cls(dict(shape)).resolve(n)
        except (ValueError, ZeroDivisionError) as exc:
            return type(exc).__name__

    assert outcome(port_mesh.MeshSpec) == outcome(jax_mesh.MeshSpec)


def test_build_mesh_lays_devices_out_like_jax():
    ours = build_mesh(MeshSpec({"data": 2, "seq": 4}), devices=["cpu"] * 8)
    ref = jax_mesh.build_mesh(jax_mesh.MeshSpec({"data": 2, "seq": 4}),
                              devices=jax.devices()[:8])
    assert ours.shape == dict(ref.shape)
    assert ours.axis_names == tuple(ref.axis_names)
    assert ours.lead == torch.device("cpu") and ours.repeats_devices
    assert not build_mesh(MeshSpec({"seq": 1}), ["cpu"]).repeats_devices


# ---------------------------------------------------------------------------
# 6. the tiny pipeline on a seq = 4 mesh


def test_tiny_pipeline_on_a_seq_mesh_matches_jax_and_single_device(
        monkeypatch):
    from chiaswarm_tpu.parallel.context import (
        capture_ring_calls as jax_capture_ring_calls,
    )
    from chiaswarm_tpu.parallel.sharding import shard_params
    from chiaswarm_tpu.pipelines.components import Components as JaxComponents
    from chiaswarm_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipe
    from chiaswarm_tpu.pipelines.diffusion import GenerateRequest as JaxReq
    from chiaswarm_tpu_torch.pipelines.components import Components
    from chiaswarm_tpu_torch.pipelines.diffusion import (
        DiffusionPipeline,
        GenerateRequest,
    )

    monkeypatch.setattr(tattn, "RING_MIN_TOKENS", 1)
    monkeypatch.delenv("CHIASWARM_RING_FLASH", raising=False)
    fused = _counting(monkeypatch, "ring_flash_fused_plain")
    jax_comps = JaxComponents.random("tiny", seed=0)
    params = jax.tree.map(np.asarray, jax_comps.params)
    jax_comps.params = shard_params(jax_comps.params, jax_seq_mesh(4))
    comps = Components.from_jax(params, "tiny", device="cpu")
    noise = np.random.default_rng(3).standard_normal(
        (1, 32, 32, 4)).astype(np.float32)
    req = dict(prompt="a lighthouse on a cliff", negative_prompt="blurry",
               steps=3, guidance_scale=7.5, height=64, width=64, seed=0,
               init_noise=noise)

    with jax_capture_ring_calls() as jax_rings:
        j_img, _ = JaxPipe(jax_comps)(JaxReq(**req))
    assert jax_rings, "the JAX seq-mesh pipeline never rang"
    with capture_ring_calls() as rings:
        ring_img, cfg = DiffusionPipeline(comps, mesh=cpu_mesh(4))(
            GenerateRequest(**req))
    solo_img, solo_cfg = DiffusionPipeline(comps)(GenerateRequest(**req))
    # every UNet level's self-attention and the VAE mid block ring
    assert {shape[1] for _, shape in rings} >= {1024, 256}
    # each ring is one B3 (plain version) call, the drive the card serves
    assert {kind for kind, _ in rings} == {"ring_flash"}
    assert len(fused) == len(rings)
    assert cfg == solo_cfg
    assert ring_img.shape == (1, 64, 64, 3) and ring_img.std() > 1.0
    for other in (np.asarray(j_img), solo_img):
        diff = np.abs(ring_img.astype(np.int16) - other.astype(np.int16))
        assert diff.max() <= 1, f"max uint8 difference {diff.max()}"


# ---------------------------------------------------------------------------
# 7. the executor on a seq = 4 slot


def _png(result) -> np.ndarray:
    from PIL import Image

    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_executor_serves_a_seq_mesh_slot_like_the_solo_slot(monkeypatch):
    # the solo path (the lanes on a seq slot: tests/test_torch_stepper.py)
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    registry = ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    seq_slot = ChipPool(mesh_spec=MeshSpec({"seq": 4}),
                        devices=["cpu"] * 4).slots[0]
    solo_slot = ChipPool(device="cpu").slots[0]
    job = {"id": "seq-1", "model_name": "tiny", "prompt": "a harbor at dawn",
           "num_inference_steps": 3, "height": 64, "width": 64, "seed": 9,
           "content_type": "image/png"}
    with capture_ring_calls() as rings:
        got = executor.synchronous_do_work(dict(job), seq_slot, registry)
    solo = executor.synchronous_do_work(dict(job), solo_slot, registry)
    for result in (got, solo):
        assert "error" not in result["pipeline_config"], result
    # tiny at 64 px: the 1024-token level and the VAE mid block ring
    assert rings and all(shape[1] == 1024 for _, shape in rings)
    diff = np.abs(_png(got).astype(np.int16) - _png(solo).astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"
    desc = got["pipeline_config"]["slot"]
    assert desc["mesh_shape"] == {"data": 1, "model": 1, "seq": 4}
    assert desc["mesh_devices"] == ["cpu"] * 4
    assert desc["repeated_device"] is True and desc["chips"] == 1
    assert solo["pipeline_config"]["slot"]["repeated_device"] is False
    # the seq slot keys its own pipeline; a mesh that does not ring shares
    # the entry of its lead device
    assert registry.pipeline("tiny", mesh=seq_slot.mesh) is not \
        registry.pipeline("tiny")
    assert registry.pipeline("tiny", mesh=solo_slot.mesh) is \
        registry.pipeline("tiny")


def test_chip_pool_splits_devices_into_mesh_slots():
    pool = ChipPool(n_slots=2, mesh_spec=MeshSpec({"seq": 2}),
                    devices=["cpu"] * 4)
    assert [s.mesh.shape["seq"] for s in pool.slots] == [2, 2]
    assert [s.descriptor()["slot"] for s in pool.slots] == [0, 1]
    # no spec: one slot per device
    assert len(ChipPool(devices=["cpu"] * 3).slots) == 3
    with pytest.raises(ValueError, match="cannot split"):
        ChipPool(n_slots=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="not both"):
        ChipPool(device="cpu", devices=["cpu"])
