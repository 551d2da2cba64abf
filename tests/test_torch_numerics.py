"""The port's numerics flight recorder
(``chiaswarm_tpu_torch/obs/numerics.py``) and its taps, on the CPU, against
the JAX package's ``obs/numerics.py``:

- enablement: the off values and the bidirectional prefix filter, pinned to
  JAX's over a table of values;
- the summary math on identical numpy inputs (float32 and bfloat16, with NaN
  and +-inf): the port's tap and ``record_host`` against JAX's jitted tap and
  its ``record_host``, l2, mean and absmax within 1e-6 relative (a mean is
  held relative to the tensor's RMS: JAX's tap sums in float32), the
  non-finite count, checksum and size equal;
- the ring: the limit, eviction of records and of queued summaries, drain,
  the ``/debug/numerics`` payload's keys, ``limit=0`` and JAX's 400 on a bad
  ``limit`` through both workers' health servers;
- the tiny pipeline's solo job under ``CHIASWARM_NUMERICS=1``: the same
  (probe, step, shard) keys as JAX's program on the same weights and noise,
  every summary within the float32 bar (2e-4) of JAX's;
- a lane of two rows: its ``lane_row`` keys equal JAX's lane's;
- the rings: the scan drive over B2's plain version records each shard's
  state per hop and its output, held against JAX's hop kernel (interpret
  mode) unfolded at the seam; the plain ring records ``ring.*`` held against
  JAX's ring records directly; B3's plain version records each shard's
  output slice;
- the activation seams record ``act.*`` at JAX's probes;
- taps off: the bits of an untapped run, an empty ring, and the same count
  of aten ops dispatched (a ``TorchDispatchMode`` counter) as with a filter
  that matches no probe.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chiaswarm_tpu.obs import numerics as jnum
from chiaswarm_tpu.pipelines import diffusion as jdiff
from chiaswarm_tpu_torch.obs import numerics as tnum
from chiaswarm_tpu_torch.pipelines import diffusion as tdiff
from tests.test_torch_quantize import jax_twin, port_twin

ENV = "CHIASWARM_NUMERICS"
BAR = 2e-4          # the float32 bar of the port against JAX
MATH_BAR = 1e-6     # the summary math on identical inputs


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models (the suite's workers
    share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_recorders(monkeypatch):
    """Every test starts with the taps off, empty rings and fresh call-site
    counters in both packages (the recorders are process-wide)."""
    for var in (ENV, "CHIASWARM_ACTIVATIONS", "CHIASWARM_WEIGHTS",
                "CHIASWARM_NUMERICS_RING"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    for mod in (jnum, tnum):
        mod.RING.clear()
        mod.TAPS.reset_trace_seq()
    yield
    for mod in (jnum, tnum):
        mod.RING.clear()
        mod.TAPS.reset_trace_seq()


def _key(rec: dict) -> tuple:
    return rec["probe"], rec["step"], rec["shard"]


def _close(got: float, want: float, scale: float, bar: float) -> bool:
    return abs(got - want) <= bar * max(abs(want), scale)


def assert_summaries_close(got: dict, want: dict, bar: float,
                           what: str = "") -> None:
    """l2 and absmax relative to themselves, the mean relative to the RMS
    (l2 / sqrt(size)); the count fields equal."""
    assert got["size"] == want["size"], what
    assert got["nonfinite"] == want["nonfinite"], what
    rms = want["l2"] / math.sqrt(max(want["size"], 1))
    for field in ("l2", "absmax"):
        assert _close(got[field], want[field], 0.0, bar), (what, field, got,
                                                           want)
    assert _close(got["mean"], want["mean"], rms, bar), (what, got, want)


# ---------------------------------------------------------------------------
# 1. enablement


@pytest.mark.parametrize("value", [
    None, "", "0", "off", "OFF", "false", "False", "no", "none", " 0 ",
    "1", "true", "on", "all", "ALL", "attn", "attn.q", "diffusion,ring",
    "ring_flash", "ring", "lane_row", " act , attn.k ", "diffusion.eps,",
    "nothing_matches"])
def test_enablement_matches_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)
    probes = ("attn", "attn.q", "attn.k", "attn.out", "diffusion",
              "diffusion.eps", "diffusion.latents", "ring", "ring.out",
              "ring_flash", "ring_flash.hop_acc", "lane_row", "act",
              "act.attn.q", "anything")
    assert tnum.enabled() == jnum.enabled()
    assert tnum.fingerprint() == jnum.fingerprint()
    assert [tnum.enabled_for(p) for p in probes] == \
        [jnum.enabled_for(p) for p in probes]


# ---------------------------------------------------------------------------
# 2. the summary math


def _inputs() -> dict:
    rng = np.random.default_rng(20)
    plain = (rng.standard_normal((3, 7, 5, 8)) * 3.0).astype(np.float32)
    odd = rng.standard_normal((2, 33, 17)).astype(np.float32)
    odd.flat[[0, 5, 100, 777]] = [np.nan, np.inf, -np.inf, np.nan]
    small = np.asarray([1.0, np.nan, 3.0, np.inf], np.float32)
    signed = np.asarray([-0.0, 0.0, -2.5, 1e-30, -1e30], np.float32)
    return {"plain": plain, "nonfinite": odd, "small": small,
            "signed": signed, "empty": np.zeros((0, 4), np.float32)}


def _jax_tap(x) -> dict:
    jnum.RING.clear()
    jax.block_until_ready(jax.jit(lambda a: jnum.tap("math", a))(x))
    jnum.flush()
    (rec,) = jnum.RING.snapshot()
    jnum.RING.clear()
    return rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(_inputs()))
def test_summary_math_matches_jax(name, dtype, monkeypatch):
    monkeypatch.setenv(ENV, "math")
    x = _inputs()[name]
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    host = np.asarray(jx.astype(jnp.float32))  # the bf16-rounded values
    assert np.array_equal(tx.float().numpy(), host, equal_nan=True)
    wants = {"jax_host": jnum.record_host("math", np.asarray(jx))}
    if name != "empty":  # JAX's jitted tap of an empty array fails
        wants["jax_tap"] = _jax_tap(jx)
    tnum.RING.clear()
    assert tnum.tap("math", tx) is tx
    got_host = tnum.record_host("math", tx)
    got_np = tnum.record_host("math", host)
    (got_tap, again, from_np) = tnum.RING.snapshot()
    assert again is got_host and from_np is got_np
    for got in (got_tap, got_host, got_np):
        for label, want in wants.items():
            assert got["checksum"] == want["checksum"], (label, got, want)
            assert_summaries_close(got, want, MATH_BAR, label)
        assert set(got) == set(wants["jax_host"])
    assert got_tap["t"] <= got_host["t"]


def test_tap_is_the_identity_and_touches_nothing_when_off():
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"a tap read .{name} with the taps off")

    x = Untouchable()
    census = tnum.TAPS.traced_probes()
    assert tnum.tap("attn.q", x, step=3) is x
    assert tnum.record_host("lane_row", x) is None
    assert len(tnum.RING) == 0 and tnum.TAPS.traced_probes() == census


# ---------------------------------------------------------------------------
# 3. the ring and the payload


def test_ring_limits_eviction_and_queue(monkeypatch):
    monkeypatch.setenv(ENV, "p")
    ring = tnum.NumericsRing(capacity=3)
    taps = tnum.TapRegistry(ring)
    for i in range(2):
        ring.record("p.a", step=i)
    assert ring.snapshot(limit=0) == [] and len(ring.snapshot(limit=1)) == 1
    for i in range(5):  # queued on the tensor's device, two beyond capacity
        taps.tap("p.t", torch.full((4,), float(i)), step=i)
    assert ring.pending() == 3 and len(ring) == 5
    stats = ring.stats()  # reading materializes the queue, in order
    assert stats == {"capacity": 3, "depth": 3, "total": 7, "evicted": 4}
    assert [(r["probe"], r["step"]) for r in ring.snapshot()] == \
        [("p.t", 2), ("p.t", 3), ("p.t", 4)]
    assert [r["seq"] for r in ring.snapshot()] == [2, 3, 4]
    assert ring.snapshot()[-1]["l2"] == pytest.approx(8.0)
    assert taps.traced_probes() == {"p.t": 5}
    assert len(ring.drain()) == 3 and len(ring) == 0
    monkeypatch.setenv("CHIASWARM_NUMERICS_RING", "5")
    assert tnum.NumericsRing().capacity == 5 == jnum.NumericsRing().capacity


def test_debug_payload_matches_jax(monkeypatch):
    monkeypatch.setenv(ENV, "p")
    for mod in (tnum, jnum):
        mod.RING.record("p.x", step=2, shard=0, l2=1.0)
        mod.RING.record("q.y", step=1)
    mine = tnum.debug_payload(probe_prefix="p.", limit=10)
    theirs = jnum.debug_payload(probe_prefix="p.", limit=10)
    assert set(mine) == set(theirs)
    assert set(mine["ring"]) == set(theirs["ring"])
    for key in ("enabled", "filter"):
        assert mine[key] == theirs[key], key
    assert mine["ring"]["depth"] == theirs["ring"]["depth"] == 2
    assert [set(r) for r in mine["records"]] == \
        [set(r) for r in theirs["records"]]
    assert tnum.debug_payload(limit=0)["records"] == []


def test_dump_and_load(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "1")
    tnum.tap("a", torch.ones(3), step=1)
    path = tmp_path / "run.jsonl"
    assert tnum.dump(str(path)) == 1
    (rec,) = tnum.load_dump(str(path))
    (theirs,) = jnum.load_dump(str(path))
    assert rec == theirs and rec["l2"] == pytest.approx(math.sqrt(3))


def _endpoint_answers(pkg: str) -> dict:
    from chiaswarm_tpu.node import settings as jsettings
    from chiaswarm_tpu.node.chaos import ChaoticExecutor
    from chiaswarm_tpu.node.minihive import MiniHive
    from chiaswarm_tpu.node.worker import Worker as JaxWorker
    from chiaswarm_tpu_torch.node import settings as tsettings
    from chiaswarm_tpu_torch.node.worker import Worker as TorchWorker

    import aiohttp

    class StubSlot:
        depth, data_width, name = 2, 1, "stub"

        def descriptor(self):
            return self.name

    mod, cls = ((jsettings, JaxWorker) if pkg == "jax"
                else (tsettings, TorchWorker))

    async def scenario():
        hive = MiniHive(lease_s=30.0, delay_s=0.0)
        uri = await hive.start()
        worker = cls(settings=mod.Settings(
            hive_uri=uri, hive_token="t", worker_name=f"num-{pkg}",
            poll_busy_s=0.02, poll_idle_s=0.05,
            install_signal_handlers=False, health_bind_ephemeral=True,
            drain_timeout_s=5.0, result_drain_timeout_s=5.0),
            pool=[StubSlot()], registry=object(),
            executor=ChaoticExecutor())
        task = asyncio.create_task(worker.run())
        out = {}
        try:
            while getattr(worker, "health_address", None) is None:
                await asyncio.sleep(0.01)
            base = "http://%s:%d" % worker.health_address
            async with aiohttp.ClientSession() as session:
                for query in ("", "?probe=p.&limit=5", "?limit=0",
                              "?limit=soon"):
                    async with session.get(
                            base + "/debug/numerics" + query) as resp:
                        out[query] = (resp.status, await resp.json())
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return out

    return asyncio.run(scenario())


@pytest.fixture
def _restore_matmul_precision():
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


def test_debug_numerics_endpoint_answers_as_the_jax_worker_does(
        monkeypatch, tmp_path, _restore_matmul_precision):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv(ENV, "p")
    for mod in (tnum, jnum):
        for i in range(3):
            mod.RING.record(f"p.{i}", step=i)
        mod.RING.record("q", step=0)
    mine, theirs = _endpoint_answers("torch"), _endpoint_answers("jax")
    for query, (status, body) in theirs.items():
        assert mine[query][0] == status, query
        if status == 400:
            assert mine[query][1] == body
            continue
        assert set(mine[query][1]) == set(body), query
        assert [r["probe"] for r in mine[query][1]["records"]] == \
            [r["probe"] for r in body["records"]], query
    assert mine["?limit=soon"][0] == 400
    assert mine["?limit=0"][1]["records"] == []
    assert [r["probe"] for r in mine["?probe=p.&limit=5"][1]["records"]] \
        == ["p.0", "p.1", "p.2"]
    assert mine[""][1]["enabled"] is True and mine[""][1]["filter"] == "p"


# ---------------------------------------------------------------------------
# 4. the solo program against JAX's


def _request(cls, **kw):
    base = dict(prompt="a lighthouse on a cliff at golden hour",
                negative_prompt="blurry", steps=3, guidance_scale=7.5,
                height=64, width=64, seed=0,
                init_noise=np.random.default_rng(0).standard_normal(
                    (1, 32, 32, 4)).astype(np.float32))
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def tiny_jax():
    return jax_twin("tiny")


def _jax_records(jc, **kw) -> tuple[np.ndarray, list[dict]]:
    from chiaswarm_tpu.core.compile_cache import GLOBAL_CACHE

    GLOBAL_CACHE.flush_executables()  # a fresh trace: indices from 0
    jnum.TAPS.reset_trace_seq()
    jnum.RING.clear()
    img, _ = jdiff.DiffusionPipeline(dataclasses.replace(jc))(
        _request(jdiff.GenerateRequest, **kw))
    jnum.flush()
    records = jnum.RING.drain()
    GLOBAL_CACHE.flush_executables()
    return np.asarray(img), records


def _by_key(records: list[dict]) -> dict:
    out = collections.defaultdict(list)
    for rec in records:
        out[_key(rec)].append(rec)
    return out


def test_solo_program_records_jax_keys_within_the_bar(tiny_jax,
                                                      monkeypatch):
    monkeypatch.setenv(ENV, "1")
    j_img, j_records = _jax_records(tiny_jax)
    port = tdiff.DiffusionPipeline(port_twin("tiny"))
    t_img, _ = port(_request(tdiff.GenerateRequest))
    t_records = tnum.RING.drain()
    assert np.abs(t_img.astype(int) - j_img.astype(int)).max() <= 1
    mine, theirs = _by_key(t_records), _by_key(j_records)
    assert set(mine) == set(theirs)
    assert {k: len(v) for k, v in mine.items()} == \
        {k: len(v) for k, v in theirs.items()}
    probes = {p for p, _, _ in mine}
    assert probes == {"attn.q", "attn.k", "attn.v", "attn.out",
                      "diffusion.text_ctx", "diffusion.eps",
                      "diffusion.latents", "diffusion.final_latents",
                      "diffusion.image_u8"}
    assert sorted(s for p, s, _ in mine if p == "diffusion.eps") == [0, 1, 2]
    for key, recs in mine.items():
        # a repeated key (one attention call site at every step) pairs its
        # records by size of l2; JAX's callbacks arrive unordered
        for got, want in zip(sorted(recs, key=lambda r: r["l2"]),
                             sorted(theirs[key], key=lambda r: r["l2"])):
            assert_summaries_close(got, want, BAR, str(key))
    # the pipeline's tap census: one call per record
    census = tnum.TAPS.traced_probes()
    assert census["diffusion.eps"] >= 3


def test_taps_off_keep_the_bits_and_the_aten_ops(tiny_jax, monkeypatch):
    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    port = tdiff.DiffusionPipeline(port_twin("tiny"))

    def run(value):
        if value is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, value)
        with Count() as counter:
            img, _ = port(_request(tdiff.GenerateRequest, steps=2))
        return img, counter.ops

    census = tnum.TAPS.traced_probes()
    off_img, off_ops = run(None)
    assert len(tnum.RING) == 0 and tnum.TAPS.traced_probes() == census
    zero_img, zero_ops = run("0")
    none_img, none_ops = run("no_such_probe")
    assert len(tnum.RING) == 0
    on_img, on_ops = run("1")
    assert len(tnum.RING) > 0
    for img in (zero_img, none_img, on_img):
        np.testing.assert_array_equal(img, off_img)
    assert zero_ops == off_ops == none_ops
    assert sum(on_ops.values()) > sum(off_ops.values())


# ---------------------------------------------------------------------------
# 5. the lanes' checkpoint boundary


def _lane_rows(scheduler_cls, pipe) -> list[dict]:
    sched = scheduler_cls()
    try:
        fut = sched.submit_request(
            pipe, prompt="lane probes", steps=6, guidance_scale=7.5,
            height=64, width=64, rows=2, seed=9)
        fut.result(timeout=300)[0].wait()
    finally:
        sched.shutdown()


def test_lane_row_keys_match_jax_lanes(tiny_jax, monkeypatch):
    from chiaswarm_tpu.serving.stepper import StepScheduler as JaxScheduler
    from chiaswarm_tpu_torch.serving.stepper import (
        StepScheduler as TorchScheduler,
    )

    monkeypatch.setenv(ENV, "lane_row")
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
    # the probe opens the boundary with the watchdog and checks off
    monkeypatch.setenv("CHIASWARM_GUARD", "0")
    _lane_rows(JaxScheduler,
               jdiff.DiffusionPipeline(dataclasses.replace(tiny_jax)))
    theirs = jnum.RING.drain()
    _lane_rows(TorchScheduler, tdiff.DiffusionPipeline(port_twin("tiny")))
    mine = tnum.RING.drain()
    assert mine and {r["probe"] for r in mine} == {"lane_row"}
    assert sorted(_key(r) for r in mine) == sorted(_key(r) for r in theirs)
    assert {r["shard"] for r in mine} == {0, 1}
    for rec in mine:
        assert rec["nonfinite"] == 0 and rec["l2"] > 0
        assert rec["size"] == 4 * 32 * 32 and rec.get("note")


# ---------------------------------------------------------------------------
# 6. the rings


def _qkv(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32)
            for _ in range(3)]


def test_scan_drive_records_each_shard_and_hop_against_jax_state(
        monkeypatch):
    """The port summarizes its logical state; JAX's records summarize its
    padded lane tiles, so the hold is against JAX's hop kernel state
    unfolded at the seam (``tests/test_torch_ring.py``)."""
    from chiaswarm_tpu.ops.flash_attention import _LANES
    from chiaswarm_tpu.ops.ring_flash_attention import _hop_call
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring
    from chiaswarm_tpu_torch.ops.flash_attention import NEG_INF
    from tests.test_torch_ring import _fold, _unfold_state

    monkeypatch.setenv(ENV, "ring_flash")
    monkeypatch.setenv("CHIASWARM_RING_FLASH", "scan")
    n, b, l, h, d, block = 4, 2, 64, 2, 40, 16
    q, k, v = _qkv(5, b, l, h, d)
    scale = d ** -0.5
    mesh = build_mesh(MeshSpec({"seq": n}), devices=["cpu"] * n)
    out = tring.ring_flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     mesh=mesh)
    mine = {_key(r): r for r in tnum.RING.drain()}
    step = l // n
    hop = partial(_hop_call, scale=scale, kv_len=step, block_q=block,
                  block_kv=block, interpret=True)
    want = {}
    for i in range(n):
        qf = _fold(q[:, i * step:(i + 1) * step], block)
        bh, lp, dp = qf.shape
        state = (jnp.full((bh, lp, _LANES), NEG_INF, jnp.float32),
                 jnp.zeros((bh, lp, _LANES), jnp.float32),
                 jnp.zeros((bh, lp, dp), jnp.float32))
        for t in range(n):
            j = (i - t) % n  # the K/V shard at shard i on hop t
            sl = slice(j * step, (j + 1) * step)
            state = hop(qf, _fold(k[:, sl], block), _fold(v[:, sl], block),
                        *state)
            m, lsum, acc = _unfold_state(*state, b, step, h, d)
            for probe, arr in (("hop_rowmax", m), ("hop_rowsum", lsum),
                               ("hop_acc", acc)):
                want[(f"ring_flash.{probe}", t, i)] = jnum.record_host(
                    f"ring_flash.{probe}", arr, step=t, shard=i)
        want[("ring_flash.out", -1, i)] = jnum.record_host(
            "ring_flash.out", acc / lsum.transpose(0, 2, 1)[..., None],
            shard=i)
    assert set(mine) == set(want)
    assert len(mine) == n * n * 3 + n
    for key, rec in mine.items():
        assert_summaries_close(rec, want[key], BAR, str(key))
    assert out.shape == (b, l, h, d)


def test_fused_drive_records_each_shard_output(monkeypatch):
    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.ops import ring_flash_attention as tring

    monkeypatch.setenv(ENV, "ring_flash")
    n, b, l, h, d = 4, 1, 32, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, b, l, h, d))
    mesh = build_mesh(MeshSpec({"seq": n}), devices=["cpu"] * n)
    out = tring.ring_flash_attention(q, k, v, mesh=mesh)
    records = tnum.RING.drain()
    assert [_key(r) for r in records] == \
        [("ring_flash.out", -1, i) for i in range(n)]
    step = l // n
    for i, rec in enumerate(records):
        want, size = tnum.summarize(out[:, i * step:(i + 1) * step])
        assert rec["checksum"] == int(want[4]) and rec["size"] == size


def test_plain_ring_records_match_jax_ring_records(monkeypatch):
    from chiaswarm_tpu.core import mesh as jmesh
    from chiaswarm_tpu.core.compat import shard_map
    from chiaswarm_tpu.parallel.ring_attention import (
        ring_attention as jax_ring_attention,
    )
    from jax.sharding import PartitionSpec as P

    from chiaswarm_tpu_torch.core.mesh import MeshSpec, build_mesh
    from chiaswarm_tpu_torch.parallel.ring_attention import ring_attention

    monkeypatch.setenv(ENV, "ring")
    n, b, l, h, d = 4, 1, 16, 2, 8
    q, k, v = _qkv(0, b, l, h, d)
    spec = P(None, "seq", None, None)
    jmesh_ = jmesh.build_mesh(jmesh.MeshSpec({"seq": n}),
                              devices=jax.devices()[:n])
    jax.block_until_ready(jax.jit(shard_map(
        partial(jax_ring_attention, axis_name="seq"), mesh=jmesh_,
        in_specs=(spec, spec, spec), out_specs=spec))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    jnum.flush()
    theirs = {_key(r): r for r in jnum.RING.drain()}
    ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                   mesh=build_mesh(MeshSpec({"seq": n}),
                                   devices=["cpu"] * n))
    mine = {_key(r): r for r in tnum.RING.drain()}
    assert set(mine) == set(theirs)
    assert len(mine) == n * n * 3 + n
    for key, rec in mine.items():
        assert_summaries_close(rec, theirs[key], BAR, str(key))


def test_activation_seams_record_jax_probes(monkeypatch):
    from chiaswarm_tpu.ops.attention import attention as jax_attention
    from chiaswarm_tpu_torch.ops.attention import attention

    monkeypatch.setenv(ENV, "act")
    monkeypatch.setenv("CHIASWARM_ACTIVATIONS", "int8")
    q, k, v = _qkv(3, 1, 16, 2, 8)
    jax.block_until_ready(jax.jit(lambda *a: jax_attention(*a))(
        *(jnp.asarray(a) for a in (q, k, v))))
    jnum.flush()
    theirs = sorted(_key(r) for r in jnum.RING.drain())
    attention(*(torch.from_numpy(a) for a in (q, k, v)))
    mine = sorted(_key(r) for r in tnum.RING.drain())
    assert mine == theirs == sorted(
        (f"act.attn.{t}", -1, -1) for t in "qkv")


def test_attention_call_site_index_restarts_per_program(monkeypatch):
    """Each lane step and each decode starts the ``attn`` index at 0, as
    each JAX program run records its trace-time indices."""
    monkeypatch.setenv(ENV, "attn.out")
    pipe = tdiff.DiffusionPipeline(port_twin("tiny"))
    x = torch.zeros((1, 4, 32, 32))
    pipe.stepper_decode(x)
    first = [r["step"] for r in tnum.RING.drain()]
    pipe.stepper_decode(x)
    again = [r["step"] for r in tnum.RING.drain()]
    assert first == again == list(range(len(first))) and first
