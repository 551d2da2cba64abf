"""Lease heartbeats, the durable checkpoint spool and redelivered resume in
the port's worker (``chiaswarm_tpu_torch/node/worker.py``,
``node/resilience.py::CheckpointSpool``, ``serving/stepper.py``), on the CPU,
against the JAX package and its lease-aware ``MiniHive``
(``chiaswarm_tpu/node/minihive.py``):

- the spool's file names, versions, corrupt-file parking and GC equal to
  JAX's for the same ids, and its phase markers;
- the heartbeat payloads of both workers equal for the same in-flight set;
- a port worker's beats extend its lease past the lease time, push its
  checkpoints (the hive keeps custody), and report a lost lease once (ports
  of ``tests/test_minihive.py:161``, ``:584``, ``:634``);
- a lane's spooled checkpoint survives JSON into another process with its
  rows' generator states, and a resumed row returns to the slot it held;
- a port worker killed mid-lane: its job redelivers with ``resume`` and a
  second port worker resumes it at a step >= 1, the image equal to an
  uninterrupted run (port of ``:718``); a JAX checkpoint is refused and its
  job restarts at step 0.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.node import resilience as jres
from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor
from chiaswarm_tpu.node.minihive import MiniHive
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.node.worker import _burst_key as jax_burst_key
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor as texecutor
from chiaswarm_tpu_torch.node import resilience as tres
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry as TorchRegistry
from chiaswarm_tpu_torch.serving.stepper import (
    StepScheduler,
    get_stepper,
    pack_array,
)

ROOT = Path(__file__).resolve().parents[1]
TINY_CATALOG = [{"name": "tiny", "family": "tiny", "parameters": {}}]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models (the suite's workers
    share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tmp_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    for var in ("SDAAS_URI", "SDAAS_TOKEN", "SDAAS_WORKERNAME",
                "CHIASWARM_RESIDENCY_BUDGET"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


@pytest.fixture(autouse=True)
def _restore_matmul_precision():
    """The JAX worker's startup pins bf16 matmuls."""
    import jax

    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


class StubSlot:
    def __init__(self, name: str = "stub") -> None:
        self.depth = 2
        self.data_width = 1
        self.name = name

    def descriptor(self):
        return self.name


def _settings(mod, uri: str, name: str, **over):
    base = dict(
        hive_uri=uri, hive_token="t", worker_name=name,
        job_deadline_s=30.0, transient_retries=1,
        retry_backoff_s=0.01, retry_backoff_cap_s=0.05,
        poll_busy_s=0.02, poll_idle_s=0.04,
        poll_backoff_base_s=0.02, poll_backoff_cap_s=0.1,
        upload_retries=3, upload_retry_delay_s=0.02,
        drain_timeout_s=10.0, result_drain_timeout_s=10.0,
        install_signal_handlers=False, heartbeat_s=0.05)
    base.update(over)
    return mod.Settings(**base)


def _counter(hive: MiniHive, name: str) -> float:
    metric = hive.metrics.get(name)
    return 0.0 if metric is None else metric.value()


async def _until(predicate, timeout: float = 30.0, every: float = 0.01):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(every)


# ---------------------------------------------------------------------------
# 1. the spool and the phase markers against JAX's


@pytest.mark.parametrize("job_id", ["job-1", "job 1", "job_1", "x" * 120,
                                    "a/b\\c:d", 7])
def test_checkpoint_spool_matches_jax(job_id, tmp_path):
    spools = {"jax": jres.CheckpointSpool(tmp_path / "jax"),
              "torch": tres.CheckpointSpool(tmp_path / "torch")}
    seen = {}
    for name, spool in spools.items():
        trail = [spool.version(job_id), spool.depth()]
        path = spool.save(job_id, {"kind": "lane", "step": 3})
        trail += [path.name, spool.version(job_id), spool.load(job_id),
                  spool.depth()]
        spool.save(job_id, {"kind": "lane", "step": 5})
        spool.save("other", {"kind": "phase", "phase": "encoded"})
        trail += [spool.version(job_id), spool.version("other"),
                  spool.load(job_id), spool.written, spool.depth()]
        spool.discard(job_id)
        trail += [spool.version(job_id), spool.load(job_id), spool.depth()]
        # a corrupt file is parked as .bad and counted, never returned
        spool._path_for("other").write_text("{not json")
        trail += [spool.load("other"), spool.corrupt_skipped,
                  sorted(p.name for p in spool.directory.iterdir())]
        (spool.directory / "stale.ckpt.json.tmp").write_text("{}")
        trail += [spool.clear(), spool.depth(), spool.version("other")]
        seen[name] = trail
    assert seen["torch"] == seen["jax"]


def test_phase_checkpoints_match_jax(tmp_path):
    recorded = {}
    for name, mod in (("jax", jres), ("torch", tres)):
        spool = mod.CheckpointSpool(tmp_path / name)
        mod.phase_checkpoint("encoded")  # no scope: nothing written
        with mod.checkpoint_scope(None, "j"):  # no spool: nothing either
            mod.phase_checkpoint("encoded")
        with mod.checkpoint_scope(spool, "job-7"):
            mod.phase_checkpoint("encoded", model="tiny")
            first = spool.load("job-7")
            mod.phase_checkpoint("denoised", model="tiny", generation_s=1.5)
        mod.phase_checkpoint("orphan")  # the scope closed
        recorded[name] = (first, spool.load("job-7"), spool.written)
    assert recorded["torch"] == recorded["jax"]
    assert recorded["torch"][1] == {"version": 1, "kind": "phase",
                                    "phase": "denoised", "model": "tiny",
                                    "generation_s": 1.5}


def test_a_failed_phase_write_never_fails_the_job(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    spool = tres.CheckpointSpool(blocker / "under-a-file")
    with tres.checkpoint_scope(spool, "j"):
        tres.phase_checkpoint("encoded")  # OSError logged, not raised
    assert spool.written == 0


def test_spool_is_attached_only_with_heartbeats():
    off = tworker.Worker(settings=_settings(tsettings, "http://h", "off",
                                            heartbeat_s=0.0),
                         pool=[StubSlot()], registry=object(), hive=object())
    assert all(getattr(s, "_checkpoint_spool", None) is None
               for s in off.pool)
    on = tworker.Worker(settings=_settings(tsettings, "http://h", "on a/b"),
                        pool=[StubSlot()], registry=object(), hive=object())
    assert all(s._checkpoint_spool is on.checkpoints for s in on.pool)
    assert on.checkpoints.directory.name == "on_a_b"
    assert on.checkpoints.directory.parent.name == "checkpoints"


def test_a_redelivered_job_never_coalesces():
    job = {"id": "r", "model_name": "tiny", "prompt": "p"}
    resumed = dict(job, resume={"kind": "lane", "step": 3})
    assert tworker._burst_key(job) == jax_burst_key(job) is not None
    assert tworker._burst_key(resumed) is None
    assert jax_burst_key(resumed) is None


# ---------------------------------------------------------------------------
# 2. the heartbeat against the JAX worker's, and the lease protocol


def _recording(worker, payloads: list, on_beat=None) -> None:
    """Record every heartbeat body the worker posts; ``on_beat(n)`` runs
    after the n-th busy one."""
    client = worker.hive
    post = client.post_heartbeat

    async def recorded(session, payload):
        payloads.append(json.loads(json.dumps(payload)))
        if payload.get("jobs") and on_beat is not None:
            on_beat(sum(1 for p in payloads if p.get("jobs")))
        return await post(session, payload)

    client.post_heartbeat = recorded


def _beat_trail(pkg: str, worker_cls, settings_mod) -> list:
    async def scenario():
        hive = MiniHive(lease_s=60.0, delay_s=0.0)
        uri = await hive.start()
        name = "hb-parity"
        worker = worker_cls(settings=_settings(settings_mod, uri, name),
                            pool=[StubSlot()], registry=object(),
                            executor=ChaoticExecutor())
        payloads: list = []
        ckpt_a = {"kind": "lane", "step": 2, "x": [1, 2]}
        ckpt_b = {"kind": "lane", "step": 4, "x": [3, 4]}

        def on_beat(n):
            if n == 1:  # the next beat carries the changed checkpoint
                worker.checkpoints.save("hb-1", ckpt_b)

        _recording(worker, payloads, on_beat)
        task = asyncio.create_task(worker.run())
        try:
            await asyncio.sleep(0.3)  # startup cleared the spool
            for job_id in ("hb-1", "hb-2"):
                hive.submit({"id": job_id, "model_name": "m"})
            # leased to this worker by name, outside its poll loop
            hive._take_jobs(name)
            worker.checkpoints.save("hb-1", ckpt_a)
            worker._inflight.update({"hb-1": 0.0, "hb-2": 0.0})
            await _until(lambda: sum(1 for p in payloads
                                     if p.get("jobs")) >= 3)
            held = {j: hive.lease_holder(j) for j in ("hb-1", "hb-2")}
            stored = dict(hive.checkpoints)
            worker._inflight.clear()
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        # the idle beat before the jobs, then the first three busy ones
        beats = payloads[:1] + [p for p in payloads if p.get("jobs")][:3]
        return [[sorted(p), p["worker_name"], p["jobs"],
                 sorted(p.get("metrics") or {})] for p in beats], held, \
            stored, worker.stats.lease_heartbeats >= 3, \
            worker.stats.leases_lost

    return asyncio.run(scenario())


def test_heartbeat_payloads_match_the_jax_worker():
    jax_trail = _beat_trail("jax", JaxWorker, jsettings)
    torch_trail = _beat_trail("torch", tworker.Worker, tsettings)
    assert torch_trail == jax_trail
    beats, held, stored, beat_ok, lost = torch_trail
    # an idle beat carries the metrics snapshot alone
    assert beats[0][2] == [] and "lane_occupancy" in beats[0][3]
    assert [[j["checkpoint"] for j in beat[2]] for beat in beats[1:]] == [
        [{"kind": "lane", "step": 2, "x": [1, 2]}, None],
        [{"kind": "lane", "step": 4, "x": [3, 4]}, None],
        [None, None]]
    assert held == {"hb-1": "hb-parity", "hb-2": "hb-parity"}
    assert stored == {"hb-1": {"kind": "lane", "step": 4, "x": [3, 4]}}
    assert beat_ok and lost == 0


def test_heartbeats_extend_the_lease_and_hand_the_checkpoint_over():
    """A port worker's job outlives the lease time: the beats keep the
    lease, push the job's checkpoint (the hive keeps custody), and the
    acked upload collects the local file; nothing redelivers."""

    async def scenario():
        hive = MiniHive(lease_s=0.5, delay_s=0.0)
        uri = await hive.start()
        executor = ChaoticExecutor(slow_s=1.5)
        worker = tworker.Worker(
            settings=_settings(tsettings, uri, "keeper"),
            pool=[StubSlot()], registry=object(), executor=executor)
        task = asyncio.create_task(worker.run())
        try:
            hive.submit({"id": "long-1", "model_name": "m",
                         "chaos": ["slow"],
                         "content_type": "application/json"})
            await _until(lambda: hive.lease_holder("long-1") == "keeper")
            worker.checkpoints.save("long-1", {"kind": "lane", "step": 6})
            await _until(lambda: "long-1" in hive.checkpoints)
            await hive.wait_for_results(1, timeout=30)
            await _until(lambda: not worker._inflight)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return hive, worker

    hive, worker = asyncio.run(scenario())
    assert hive.uploaded_ids() == ["long-1"]
    assert _counter(hive, "chiaswarm_hive_leases_expired_total") == 0
    assert _counter(hive, "chiaswarm_hive_checkpoints_stored_total") >= 1
    assert worker.stats.lease_heartbeats >= 3
    assert worker.checkpoints.depth() == 0  # collected on the ack
    assert worker.health()["checkpoints_written"] == 1


def test_a_lost_lease_is_reported_once():
    """A heartbeat naming a job the hive no longer leases to this worker
    comes back ``lost``: counted once per loss, not once per beat, and a
    new loss of the same id after the set emptied counts again."""

    async def scenario():
        hive = MiniHive(lease_s=30.0, delay_s=0.01)
        uri = await hive.start()
        worker = tworker.Worker(
            settings=_settings(tsettings, uri, "ghost-worker"),
            pool=[StubSlot()], registry=object(), executor=ChaoticExecutor())
        worker._inflight["ghost-1"] = 0.0
        task = asyncio.create_task(worker.run())
        try:
            await _until(lambda: worker.stats.leases_lost >= 1)
            beats = worker.stats.lease_heartbeats
            await _until(lambda: worker.stats.lease_heartbeats >= beats + 5)
            once = worker.stats.leases_lost
            worker._inflight.pop("ghost-1", None)
            await asyncio.sleep(0.3)  # empty beats: the lost set resets
            worker._inflight["ghost-1"] = 0.0
            await _until(lambda: worker.stats.leases_lost >= 2)
        finally:
            worker._inflight.pop("ghost-1", None)
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return once, worker.stats.leases_lost

    assert asyncio.run(scenario()) == (1, 2)


def test_placement_hints_reach_the_residency_ledger():
    registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                             device="cpu")
    seen = []
    registry.residency.note_placement = seen.append
    worker = tworker.Worker(settings=_settings(tsettings, "http://h", "pl"),
                            pool=[StubSlot()], registry=registry,
                            hive=object())
    for raw in (None, [], "tiny", {"m": 1}, ["tiny", 3]):
        worker._note_placement(raw)
    assert seen == [["tiny", "3"]]


# ---------------------------------------------------------------------------
# 3. lanes: the spooled checkpoint, across processes and across workers


def _lane_job(job_id: str, seed: int, steps: int) -> dict:
    return {"id": job_id, "model_name": "tiny", "prompt": f"lease {seed}",
            "seed": seed, "num_inference_steps": steps,
            "guidance_scale": 7.5, "height": 64, "width": 64,
            "content_type": "image/png"}


def _pixels(result: dict) -> np.ndarray:
    assert result["pipeline_config"].get("error") is None, result
    blob = result["artifacts"]["primary"]["blob"]
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(blob))))


@pytest.fixture(scope="module")
def tiny_registry(tmp_path_factory):
    """One tiny model for the lane tests (random weights, drawn once)."""
    root = tmp_path_factory.mktemp("registry")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWARM_TPU_ROOT", str(root))
        registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                                 device="cpu")
        registry.pipeline("tiny")
    return registry


@pytest.fixture
def lanes(tiny_registry, monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
    return tiny_registry


VALIDATE = """
import json, sys
import torch
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.serving.stepper import StepScheduler
ckpt = json.load(open(sys.argv[1]))
pipe = ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                     allow_random=True, device="cpu").pipeline("tiny")
got = StepScheduler()._validate_resume(
    pipe, ckpt, steps=ckpt["steps"], rows=ckpt["rows"], height=64,
    width=64, guidance=ckpt["guidance"], start=0, workload="txt2img")
print(json.dumps({"step": got["step"],
                  "x": got["x"].double().sum().item(),
                  "draws": [torch.randn(3, generator=g).tolist()
                            for g in got["generators"]]}))
"""


def test_a_spooled_lane_checkpoint_resumes_in_another_process(lanes,
                                                             tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "2")
    spool = tres.CheckpointSpool(tmp_path / "spool")
    slot = ChipPool(device="cpu").slots[0]
    slot._checkpoint_spool = spool
    try:
        result = texecutor.synchronous_do_work(
            _lane_job("spooled-1", seed=3, steps=5), slot, lanes)
        stats = get_stepper(slot).stats()
    finally:
        get_stepper(slot).shutdown()
    assert result["pipeline_config"]["stepper"]["steps_executed"] == 5
    assert stats["checkpoints_written"] == 2 == spool.written
    ckpt = spool.load("spooled-1")
    assert ckpt["step"] == 4 and len(ckpt["generators"]) == 1
    path = tmp_path / "ckpt.json"
    path.write_text(json.dumps(ckpt))  # as the hive hands it back
    here = StepScheduler()._validate_resume(
        lanes.pipeline("tiny"), json.loads(path.read_text()), steps=5,
        rows=1, height=64, width=64, guidance=7.5, start=0,
        workload="txt2img")
    mine = {"step": here["step"], "x": here["x"].double().sum().item(),
            "draws": [torch.randn(3, generator=g).tolist()
                      for g in here["generators"]]}
    out = subprocess.run([sys.executable, "-c", VALIDATE, str(path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == mine


def test_a_resumed_row_returns_to_the_slot_it_held(lanes, tmp_path,
                                                 monkeypatch):
    """A lane checkpoint records its rows' slots, and the resumed job is
    admitted into them when they are free (a row's bits depend on its slot
    on the card), not into the lowest free slot."""
    from chiaswarm_tpu_torch.serving import stepper as tstepper

    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "1")
    admitted = []
    real = tstepper.Lane._admit_locked

    def spy(self):
        before = {id(j) for j in self._rows if j is not None}
        real(self)
        admitted.extend((j.job_id, list(j.slots)) for j in self._rows
                        if j is not None and id(j) not in before)

    monkeypatch.setattr(tstepper.Lane, "_admit_locked", spy)
    spool = tres.CheckpointSpool(tmp_path / "spool")
    slot = ChipPool(device="cpu").slots[0]
    slot._checkpoint_spool = spool
    jobs = [_lane_job("first", seed=1, steps=4),
            _lane_job("second", seed=2, steps=4)]
    try:
        texecutor.synchronous_do_work_batch([dict(j) for j in jobs], slot,
                                            lanes)
        state = json.loads(json.dumps(spool.load("second")))
        get_stepper(slot).shutdown()
        resumed = texecutor.synchronous_do_work(
            dict(jobs[1], resume=state), slot, lanes)
    finally:
        get_stepper(slot).shutdown()
    assert state["slots"] == [1]
    assert admitted[:2] == [("first", [0]), ("second", [1])]
    assert admitted[2] == ("second", [1])  # a fresh lane, slot 0 free
    assert resumed["pipeline_config"]["stepper"]["resume_step"] == \
        state["step"]
    bad = StepScheduler()._validate_resume(
        lanes.pipeline("tiny"), dict(state, slots=[0, 0]), steps=4, rows=1,
        height=64, width=64, guidance=7.5, start=0, workload="txt2img")
    assert bad["slots"] == ()  # a malformed hint is dropped, not obeyed


KILL_STEPS = 6


def _kill_mid_lane(registry, monkeypatch, resume: dict | None = None):
    """Worker A (a port worker) takes a lane job; once the hive holds a
    lane checkpoint at a step >= 1, A is partitioned and its task cancelled
    (the in-process SIGKILL) and its leases revoked; worker B, a second port
    worker, gets the redelivery. ``resume`` pre-loads the hive's checkpoint
    for the job instead (then A is never started)."""
    job = _lane_job("lane-kill-1", seed=900, steps=KILL_STEPS)

    async def scenario():
        # a long lease: the lane thread can starve the heartbeat task of
        # the GIL; the kill revokes the victim's leases explicitly
        hive = MiniHive(lease_s=60.0, delay_s=0.01, max_jobs_per_poll=1)
        uri = await hive.start()
        hive.submit(dict(job))
        workers, tasks, victim = {}, {}, None

        def start(tag: str):
            workers[tag] = tworker.Worker(
                settings=_settings(tsettings, uri, f"lane-{tag}",
                                   guard_enabled=False),
                pool=ChipPool(device="cpu"), registry=registry)
            tasks[tag] = asyncio.create_task(workers[tag].run())

        try:
            if resume is None:
                # the kill must land mid-lane: each of A's steps stretched
                monkeypatch.setenv("CHIASWARM_CHAOS_SLOW_STEP", "3")
                start("a")
                await _until(lambda: int((hive.checkpoints.get(job["id"])
                                          or {}).get("step", 0)) >= 1,
                             timeout=120)
                victim = workers["a"]
                hive.partition("lane-a")
                tasks["a"].cancel()
                await asyncio.gather(tasks["a"], return_exceptions=True)
                monkeypatch.delenv("CHIASWARM_CHAOS_SLOW_STEP")
                assert hive.expire_worker("lane-a") == [job["id"]]
            else:
                hive.checkpoints[job["id"]] = resume
            start("b")
            await hive.wait_for_results(1, timeout=240)
        finally:
            for worker in workers.values():
                worker.request_stop()
            await asyncio.gather(*(asyncio.wait_for(t, timeout=60)
                                   for t in tasks.values()),
                                 return_exceptions=True)
            if victim is not None:
                stepper = getattr(victim.pool.slots[0], "_stepper", None)
                if stepper is not None:
                    stepper.drain(60)
                    stepper.shutdown()
            await hive.stop()
        return hive, workers

    return asyncio.run(scenario())


def _uninterrupted(registry, job: dict) -> np.ndarray:
    slot = ChipPool(device="cpu").slots[0]
    try:
        return _pixels(texecutor.synchronous_do_work(dict(job), slot,
                                                     registry))
    finally:
        get_stepper(slot).shutdown()


def test_a_worker_killed_mid_lane_resumes_on_another_worker(lanes,
                                                           monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "1")
    hive, workers = _kill_mid_lane(lanes, monkeypatch)
    assert hive.uploaded_ids() == ["lane-kill-1"]  # exactly once
    [result] = hive.results
    assert result["worker_name"] == "lane-b"
    stamp = result["pipeline_config"]["stepper"]
    assert 1 <= stamp["resume_step"] < KILL_STEPS
    # B stepped only the remaining steps
    assert stamp["steps_executed"] == KILL_STEPS - stamp["resume_step"]
    survivor = workers["b"].pool.slots[0]._stepper.stats()
    assert survivor["rows_resumed"] == 1
    assert survivor.get("resumes_rejected", 0) == 0
    assert _counter(hive, "chiaswarm_hive_jobs_redelivered_total") == 1
    assert workers["a"].stats.lease_heartbeats >= 1
    assert workers["b"].health()["stepper"]["rows_resumed"] == 1
    np.testing.assert_array_equal(
        _pixels(result), _uninterrupted(lanes, _lane_job(
            "lane-kill-1", seed=900, steps=KILL_STEPS)))


def test_a_jax_checkpoint_is_refused_and_the_job_restarts(lanes,
                                                         monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "8")
    latents = np.zeros((1, 4, 32, 32), np.float32)
    jax_ckpt = {"version": 1, "kind": "lane", "step": 3,
                "steps": KILL_STEPS,
                "rows": 1, "height": 64, "width": 64, "guidance": 7.5,
                "workload": "txt2img", "start": 0,
                "x": pack_array(latents), "old": pack_array(latents),
                "keys": pack_array(np.zeros((1, 2), np.uint32))}
    hive, workers = _kill_mid_lane(lanes, monkeypatch, resume=jax_ckpt)
    [result] = hive.results
    assert result["pipeline_config"]["stepper"]["resume_step"] == 0
    assert (result["pipeline_config"]["stepper"]["steps_executed"]
            == KILL_STEPS)
    stats = workers["b"].pool.slots[0]._stepper.stats()
    assert stats["resumes_rejected"] == 1
    assert stats.get("rows_resumed", 0) == 0
    np.testing.assert_array_equal(
        _pixels(result), _uninterrupted(lanes, _lane_job(
            "lane-kill-1", seed=900, steps=KILL_STEPS)))
