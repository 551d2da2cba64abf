"""The port's worker against a federated, journaled hive
(``chiaswarm_tpu_torch/node/worker.py``, ``node/hive.py``,
``node/federation.py``), on the CPU, driven against the JAX package's hive
harness (``MiniHive`` with a journal, ``ShardHive``/``FederatedHive``) and
held against the JAX worker on the same schedules:

- **the epoch handshake with one hive**: the port's beats and uploads carry
  the grant's ``hive_epoch``; after the hive restarts from its journal, the
  pre-restart uploads settle once as epoch salvage, the first beat is
  answered ``stale_epoch`` and the next one re-registers under the new
  epoch, with the hive's and the worker's counters equal to the JAX
  worker's;
- **wire parity**: against a hive with no journal and no trace context the
  upload carries no ``hive_shard``, ``hive_epoch`` or ``span_digest``; a
  federated hive adds exactly the shard key (and a journal the epoch), as
  the JAX worker's uploads do;
- **bootstrap** from one front address (``GET /api/shards``); an
  unreachable front and an empty shard list raise;
- **stolen grants**: the upload, the beats and the dead-letter replay of a
  job stolen through another shard's poll reach its owner, which settles it
  exactly once and never forwards;
- **a shard outage** (stealing off) degrades only that shard's traffic;
- **a federated SIGKILL mid-lane**: two shards, two port workers and the
  tiny model; the owner shard and the worker holding the job die together,
  the shard recovers from its journal, and the job resumes at a step >= 1 on
  the survivor, settled exactly once across the epoch bump.
"""

from __future__ import annotations

import asyncio
import json
import time

import aiohttp
import pytest
import torch

from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor, ChaoticHive
from chiaswarm_tpu.node.federation import FederatedHive, shard_of
from chiaswarm_tpu.node.hivelog import HIVE_EPOCH_KEY as J_EPOCH_KEY
from chiaswarm_tpu.node.hivelog import HIVE_SHARD_KEY as J_SHARD_KEY
from chiaswarm_tpu.node.hivelog import HiveJournal
from chiaswarm_tpu.node.minihive import MiniHive, kill_hive, restart_hive
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.obs import flight as jflight
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.federation import bootstrap_shard_uris
from chiaswarm_tpu_torch.node.hive import HIVE_EPOCH_KEY, HIVE_SHARD_KEY
from chiaswarm_tpu_torch.node.registry import ModelRegistry as TorchRegistry
from chiaswarm_tpu_torch.obs import flight as tflight

BASE_KEYS = {"id", "artifacts", "nsfw", "worker_version", "pipeline_config",
             "worker_name"}


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
    def __init__(self, name: str = "stub", depth: int = 4) -> None:
        self.depth = depth
        self.data_width = 1
        self.name = name

    def descriptor(self):
        return self.name


def _settings(mod, uri: str, name: str, **over):
    base = dict(
        hive_uri=uri, hive_token="t", worker_name=name,
        job_deadline_s=30.0, transient_retries=1,
        retry_backoff_s=0.01, retry_backoff_cap_s=0.05,
        breaker_threshold=5, breaker_cooldown_s=3600.0,
        poll_busy_s=0.02, poll_idle_s=0.04,
        poll_backoff_base_s=0.02, poll_backoff_cap_s=0.1,
        upload_retries=3, upload_retry_delay_s=0.02,
        drain_timeout_s=10.0, result_drain_timeout_s=10.0,
        install_signal_handlers=False, heartbeat_s=0.05)
    base.update(over)
    return mod.Settings(**base)


def _pkg(pkg: str):
    return ((jsettings, JaxWorker) if pkg == "jax"
            else (tsettings, tworker.Worker))


def _job(job_id: str, chaos=None, **over) -> dict:
    job = {"id": job_id, "model_name": "shared/tiny", "prompt": f"p {job_id}",
           "num_inference_steps": 2, "height": 64, "width": 64,
           "content_type": "application/json"}
    if chaos is not None:
        job["chaos"] = chaos
    job.update(over)
    return job


def _owned(n_shards: int, index: int, count: int, prefix: str) -> list[str]:
    """``count`` job ids owned by shard ``index`` of ``n_shards`` (the
    hive's sha256 partition)."""
    out, i = [], 0
    while len(out) < count:
        job_id = f"{prefix}-{i}"
        if shard_of(job_id, n_shards) == index:
            out.append(job_id)
        i += 1
    return out


async def _until(predicate, timeout: float = 30.0, every: float = 0.01):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(every)


def _counter(hive, name: str) -> float:
    metric = hive.metrics.get(name)
    return 0.0 if metric is None else metric.value()


def _recording(worker, trail: list) -> None:
    """Record every beat and upload body each shard client sends, and the
    beat acks, as ``(kind, shard index, payload, ack)``."""
    for shard in worker.shards:
        client, index = shard.client, shard.index

        def wrap(post, kind, index=index):
            async def recorded(session, payload):
                body = json.loads(json.dumps(payload))
                entry = [kind, index, body, None]
                trail.append(entry)
                ack = await post(session, payload)
                entry[3] = ack
                return ack
            return recorded

        client.post_heartbeat = wrap(client.post_heartbeat, "beat")
        client.post_result = wrap(client.post_result, "upload")


def test_wire_keys_are_the_hive_log_copies():
    assert (HIVE_EPOCH_KEY, HIVE_SHARD_KEY) == (J_EPOCH_KEY, J_SHARD_KEY)
    assert (tflight.TRACE_CTX_KEY, tflight.SPAN_DIGEST_KEY,
            tflight.MAX_DIGEST_SPANS) == (jflight.TRACE_CTX_KEY,
                                          jflight.SPAN_DIGEST_KEY,
                                          jflight.MAX_DIGEST_SPANS)


# ---------------------------------------------------------------------------
# 1. the epoch handshake with one journaled hive


def _restart_schedule(pkg: str, tmp_path) -> dict:
    """Two slow jobs in flight; once a busy beat has landed the hive is
    killed and recovered from its journal on the same port. Returns what
    the hive and the worker counted and every beat and upload sent."""
    mod, cls = _pkg(pkg)

    async def scenario():
        journal = HiveJournal(tmp_path / f"hive-{pkg}", fsync=False)
        hive = MiniHive(lease_s=30.0, delay_s=0.0, journal=journal)
        uri = await hive.start()
        port = hive.port
        executor = ChaoticExecutor(slow_s=1.0)
        worker = cls(settings=_settings(mod, uri, f"epoch-{pkg}"),
                     pool=[StubSlot()], registry=object(), executor=executor)
        trail: list = []
        _recording(worker, trail)
        ids = ["ep-0", "ep-1"]
        for job_id in ids:
            hive.submit(_job(job_id, chaos=["slow"]))
        task = asyncio.create_task(worker.run())
        recovered = hive
        try:
            await _until(lambda: len(worker._inflight) == 2 and any(
                kind == "beat" and body["jobs"] and ack is not None
                for kind, _, body, ack in trail))
            await kill_hive(hive)
            recovered = await restart_hive(journal, port=port, lease_s=30.0,
                                           delay_s=0.0)
            await recovered.wait_for_results(2, timeout=30)
            await _until(lambda: not worker._inflight)
            await _until(lambda: any(
                kind == "beat" and body.get(HIVE_EPOCH_KEY) == 2
                and ack is not None for kind, _, body, ack in trail))
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await recovered.stop()
        return {
            "uploaded": sorted(recovered.uploaded_ids()),
            "salvaged": _counter(recovered,
                                 "chiaswarm_hive_epoch_salvage_total"),
            "stale_beats": _counter(
                recovered, "chiaswarm_hive_stale_epoch_heartbeats_total"),
            "epoch_changes": worker.stats.hive_epoch_changes,
            "worker_epoch": worker.health()["hive_epoch"],
            "upload_epochs": sorted(body.get(HIVE_EPOCH_KEY)
                                    for kind, _, body, _ in trail
                                    if kind == "upload"),
            "beat_epochs": [body.get(HIVE_EPOCH_KEY)
                            for kind, _, body, _ in trail
                            if kind == "beat" and body["jobs"]],
            "stale_acks": [ack for kind, _, body, ack in trail
                           if kind == "beat" and isinstance(ack, dict)
                           and ack.get("status") == "stale_epoch"],
        }

    return asyncio.run(scenario())


def test_beats_and_uploads_carry_the_epoch_and_survive_a_restart(tmp_path):
    """The repair: a restarted journaled hive counts the port's
    pre-restart uploads as epoch salvage and rejects its stale beat, as it
    does the JAX worker's (on the tree before this repair the port echoed
    no epoch: no salvage, no stale beat, no epoch change)."""
    mine = _restart_schedule("torch", tmp_path)
    theirs = _restart_schedule("jax", tmp_path)
    assert mine["uploaded"] == ["ep-0", "ep-1"]
    assert mine["salvaged"] == 2 and mine["stale_beats"] == 1
    assert mine["epoch_changes"] == 1 and mine["worker_epoch"] == 2
    assert mine["upload_epochs"] == [1, 1]  # the grants' epoch, echoed
    # beats claim epoch 1, the first after the restart is answered
    # stale_epoch with every claimed job lost, the next claims epoch 2
    epochs = mine["beat_epochs"]
    assert epochs[0] == 1 and epochs[-1] == 2
    assert epochs == sorted(epochs)
    [stale] = mine["stale_acks"]
    assert stale["hive_epoch"] == 2
    assert sorted(stale["lost"]) == ["ep-0", "ep-1"]
    for key in ("uploaded", "salvaged", "stale_beats", "epoch_changes",
                "worker_epoch", "upload_epochs"):
        assert mine[key] == theirs[key], key
    assert [set(a) for a in mine["stale_acks"]] == \
        [set(a) for a in theirs["stale_acks"]]


# ---------------------------------------------------------------------------
# 2. wire parity


def _sent_uploads(pkg: str, make_hive, tmp_path) -> list[dict]:
    """Serve one job through a worker of ``pkg`` against the hive
    ``make_hive`` builds; returns the upload bodies as sent."""
    mod, cls = _pkg(pkg)

    async def scenario():
        hive = make_hive(tmp_path / pkg)
        if isinstance(hive, FederatedHive):
            await hive.start()
            uri = hive.worker_uri()
            job_id = _owned(hive.n_shards, 1 if hive.n_shards > 1 else 0,
                            1, "wire")[0]
        else:
            uri = await hive.start()
            job_id = "wire-0"
        worker = cls(settings=_settings(mod, uri, f"wire-{pkg}"),
                     pool=[StubSlot()], registry=object(),
                     executor=ChaoticExecutor())
        trail: list = []
        _recording(worker, trail)
        hive.submit(_job(job_id))
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(1, timeout=30)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return [body for kind, _, body, _ in trail if kind == "upload"]

    return asyncio.run(scenario())


HIVES = {
    "reference": (lambda root: ChaoticHive(), set()),
    "minihive": (lambda root: MiniHive(lease_s=30.0, delay_s=0.0),
                 {tflight.SPAN_DIGEST_KEY}),
    "journaled": (lambda root: MiniHive(
        lease_s=30.0, delay_s=0.0, journal=HiveJournal(root, fsync=False)),
        {tflight.SPAN_DIGEST_KEY, HIVE_EPOCH_KEY}),
    "federated": (lambda root: FederatedHive(n_shards=3, lease_s=30.0,
                                             delay_s=0.0),
                  {tflight.SPAN_DIGEST_KEY, HIVE_SHARD_KEY}),
    "federated_journaled": (lambda root: FederatedHive(
        n_shards=3, journal_root=root, journal_fsync=False, lease_s=30.0,
        delay_s=0.0),
        {tflight.SPAN_DIGEST_KEY, HIVE_SHARD_KEY, HIVE_EPOCH_KEY}),
    "one_shard_federation": (lambda root: FederatedHive(
        n_shards=1, lease_s=30.0, delay_s=0.0), {tflight.SPAN_DIGEST_KEY}),
}


@pytest.mark.parametrize("kind", list(HIVES))
def test_upload_wire_matches_the_jax_worker(kind, tmp_path):
    make_hive, extra = HIVES[kind]
    [mine] = _sent_uploads("torch", make_hive, tmp_path)
    [theirs] = _sent_uploads("jax", make_hive, tmp_path)
    assert set(mine) == BASE_KEYS | extra == set(theirs)
    if HIVE_SHARD_KEY in extra:
        assert mine[HIVE_SHARD_KEY] == 1 == theirs[HIVE_SHARD_KEY]
    if HIVE_EPOCH_KEY in extra:
        assert mine[HIVE_EPOCH_KEY] == 1 == theirs[HIVE_EPOCH_KEY]
    if tflight.SPAN_DIGEST_KEY in extra:
        digest = mine[tflight.SPAN_DIGEST_KEY]
        assert set(digest) == set(theirs[tflight.SPAN_DIGEST_KEY])
        assert [p["name"] for p in digest["phases"]] == \
            ["poll", "execute", "upload"]


# ---------------------------------------------------------------------------
# 3. bootstrap from one front


def test_bootstrap_from_one_front_address():
    async def scenario():
        fed = FederatedHive(n_shards=3, lease_s=30.0)
        front = await fed.start()
        try:
            uris = await bootstrap_shard_uris(front)
            assert list(uris) == fed.shard_uris() and len(uris) == 3
            # a worker knowing only the front (its hive_uri a stale guess)
            # comes up over every shard, as the JAX worker does
            workers = {}
            for pkg in ("torch", "jax"):
                mod, cls = _pkg(pkg)
                worker = cls(settings=_settings(
                    mod, "http://127.0.0.1:9", "boot",
                    hive_front_uri=front), pool=[StubSlot()],
                    registry=object(), executor=ChaoticExecutor())
                await worker._bootstrap_from_front()
                workers[pkg] = worker
            mine, theirs = workers["torch"], workers["jax"]
            assert mine.settings.hive_shard_uris == uris
            assert mine.settings.hive_uris() == list(uris)
            assert [(s.index, s.uri, s.spool.directory.name,
                     s.session.name) for s in mine.shards] == \
                [(s.index, s.uri, s.spool.directory.name, s.session.name)
                 for s in theirs.shards]
            assert len(mine.health()["hive_shards"]) == 3
            # an injected client is the control plane and wins
            pinned = tworker.Worker(settings=_settings(
                tsettings, "http://127.0.0.1:9", "boot-pinned",
                hive_front_uri=front), pool=[StubSlot()],
                registry=object(), hive=object())
            await pinned._bootstrap_from_front()
            assert len(pinned.shards) == 1
        finally:
            await fed.stop()

    asyncio.run(scenario())


def test_an_unreachable_front_or_an_empty_list_raises():
    from aiohttp import web

    async def empty(_request):
        return web.json_response({"shards": []})

    async def scenario():
        app = web.Application()
        app.router.add_get("/api/shards", empty)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        front = "http://127.0.0.1:%d" % runner.addresses[0][1]
        try:
            with pytest.raises(RuntimeError, match="no shard uris"):
                await bootstrap_shard_uris(front)
            worker = tworker.Worker(settings=_settings(
                tsettings, "http://127.0.0.1:9", "boot-dead",
                hive_front_uri="http://127.0.0.1:9"), pool=[StubSlot()],
                registry=object(), executor=ChaoticExecutor())
            with pytest.raises(aiohttp.ClientError):
                await worker.run()
        finally:
            await runner.cleanup()

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# 4. stolen grants reach their owner


def test_stolen_grants_upload_beat_and_replay_to_their_owner(tmp_path):
    """Every job is owned by shard 1; shard 0's empty polls steal. The
    owner then dies under the worker: the jobs' uploads spool in the
    owner's dead-letter namespace and replay live to it once it recovers
    from its journal. Every upload and every busy beat of a job went to
    its owner's client; nothing was forwarded; one settle a job."""
    ids = _owned(2, 1, 4, "steal")

    async def scenario():
        fed = FederatedHive(n_shards=2, journal_root=tmp_path / "hive",
                            journal_fsync=False, lease_s=30.0, delay_s=0.0,
                            max_jobs_per_poll=1)
        await fed.start()
        executor = ChaoticExecutor(slow_s=0.8)
        worker = tworker.Worker(
            settings=_settings(tsettings, fed.worker_uri(), "thief",
                               hive_outage_after=2),
            pool=[StubSlot(depth=4)], registry=object(), executor=executor)
        trail: list = []
        _recording(worker, trail)
        for job_id in ids:
            fed.submit(_job(job_id, chaos=["slow"]))
        task = asyncio.create_task(worker.run())
        try:
            await _until(lambda: len(worker._inflight) >= 2)
            await fed.kill_shard(1)
            await _until(lambda: worker.shards[1].spool.depth() >= 1
                         and worker.shards[1].session.in_outage,
                         timeout=30)
            spooled = worker.shards[1].spool.depth()
            assert worker.shards[0].spool.depth() == 0
            assert not worker.shards[0].session.in_outage
            await fed.restart_shard(1)
            await fed.wait_for_results(len(ids), timeout=60)
            await _until(lambda: not worker._inflight)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=30)
            await fed.stop()
        return fed, worker, trail, spooled

    fed, worker, trail, spooled = asyncio.run(scenario())
    uploaded = fed.uploaded_ids()
    assert sorted(uploaded) == sorted(ids) and len(set(uploaded)) == len(ids)
    steals = fed.stats()["aggregate"]["steals"]
    assert steals.get("1->0", 0) >= 1, steals
    uploads = [(index, body) for kind, index, body, _ in trail
               if kind == "upload"]
    assert uploads and all(index == 1 for index, _ in uploads)
    assert all(body[HIVE_SHARD_KEY] == 1 for _, body in uploads)
    for kind, index, body, _ in trail:
        if kind == "beat" and body["jobs"]:
            assert index == 1, body
    assert spooled >= 1
    replayed = worker.metrics.get("chiaswarm_dead_letter_replayed_total")
    assert replayed.value(when="live") >= spooled
    for shard in fed.shards:
        assert _counter(
            shard, "chiaswarm_hive_shard_forwarded_uploads_total") == 0
    assert fed.abandoned == []


# ---------------------------------------------------------------------------
# 5. a shard outage degrades only its own traffic


def test_shard_outage_degrades_only_its_own_traffic(tmp_path):
    """Shard 1 of 3 dies under a live port worker (stealing off: the JAX
    test's known flake is ``FederatedHive.steal_for``, the harness's):
    shards 0 and 2 keep settling; only shard 1's session rides an outage
    and ``/healthz`` names it; its journal recovers its jobs and the
    session heals. Exactly once fleet-wide; only shard 1's epoch moved."""
    owned = {i: _owned(3, i, 2, "ride") for i in range(3)}

    async def scenario():
        fed = FederatedHive(n_shards=3, journal_root=tmp_path / "hive",
                            journal_fsync=False, lease_s=30.0, delay_s=0.0,
                            steal=False)
        await fed.start()
        worker = tworker.Worker(
            settings=_settings(tsettings, fed.worker_uri(), "fedrider",
                               hive_outage_after=2),
            pool=[StubSlot()], registry=object(), executor=ChaoticExecutor())
        task = asyncio.create_task(worker.run())
        try:
            for job_id in owned[1]:
                fed.submit(_job(job_id))
            await fed.kill_shard(1)
            for job_id in owned[0] + owned[2]:
                fed.submit(_job(job_id))
            await _until(lambda: len(fed.completed) >= 4
                         and worker.shards[1].session.in_outage, timeout=60)
            assert not worker.shards[0].session.in_outage
            assert not worker.shards[2].session.in_outage
            states = {b["shard"]: b["session"]["state"]
                      for b in worker.health()["hive_shards"]}
            assert states == {0: "online", 1: "outage", 2: "online"}
            body = worker.metrics.render()
            assert 'chiaswarm_hive_shard_session_state{shard="1"} 1' in body
            assert 'chiaswarm_hive_shard_session_state{shard="0"} 0' in body
            await fed.restart_shard(1)
            await fed.wait_for_results(6, timeout=60)
            await _until(lambda: not worker.shards[1].session.in_outage)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=30)
            await fed.stop()
        return fed, worker

    fed, worker = asyncio.run(scenario())
    issued = sorted(j for ids in owned.values() for j in ids)
    uploaded = fed.uploaded_ids()
    assert sorted(uploaded) == issued and len(set(uploaded)) == len(issued)
    assert fed.abandoned == []
    assert fed.verify_flights(issued) == []
    assert fed.stats()["aggregate"]["epochs"] == [1, 2, 1]
    assert [s["hive_epoch"] for s in worker.health()["hive_shards"]] == \
        [1, 2, 1]
    assert list(fed.fleet_snapshot()["workers"]) == ["fedrider"]


# ---------------------------------------------------------------------------
# 6. the federated SIGKILL mid-lane


KILL_STEPS = 6
TINY_CATALOG = [{"name": "tiny", "family": "tiny", "parameters": {}}]


@pytest.fixture(scope="module")
def tiny_registry(tmp_path_factory):
    root = tmp_path_factory.mktemp("registry")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWARM_TPU_ROOT", str(root))
        registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                                 device="cpu")
        registry.pipeline("tiny")
    return registry


def test_a_shard_and_its_worker_killed_mid_lane_resume_on_the_survivor(
        tiny_registry, monkeypatch):
    """Two shards, two port workers, the tiny model in lanes. Worker A
    holds a lane job owned by shard 0 and checkpointed there at a step
    >= 1; shard 0 and A die in one incident; shard 0 recovers from its
    journal (epoch 2) and redelivers the job with ``resume`` to worker B,
    which resumes it at that step. One settle across the epoch bump."""
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
    monkeypatch.setenv("CHIASWARM_STEPPER_CKPT_EVERY", "1")
    [job_id] = _owned(2, 0, 1, "fedlane")
    job = {"id": job_id, "model_name": "tiny", "prompt": "federated lane",
           "seed": 900, "num_inference_steps": KILL_STEPS,
           "guidance_scale": 7.5, "height": 64, "width": 64,
           "content_type": "image/png"}

    async def scenario(root):
        fed = FederatedHive(n_shards=2, journal_root=root,
                            journal_fsync=False, lease_s=60.0, delay_s=0.01,
                            max_jobs_per_poll=1, steal=False)
        await fed.start()
        workers, tasks = {}, {}

        def start(tag: str):
            workers[tag] = tworker.Worker(
                settings=_settings(tsettings, fed.worker_uri(),
                                   f"fedlane-{tag}", guard_enabled=False,
                                   job_deadline_s=240.0),
                pool=ChipPool(device="cpu"), registry=tiny_registry)
            tasks[tag] = asyncio.create_task(workers[tag].run())

        try:
            # the kill must land mid-lane: A's steps stretched
            monkeypatch.setenv("CHIASWARM_CHAOS_SLOW_STEP", "3")
            start("a")
            fed.submit(dict(job))
            shard0 = fed.shards[0]
            await _until(lambda: int((shard0.checkpoints.get(job_id)
                                      or {}).get("step", 0)) >= 1,
                         timeout=120)
            held = int(shard0.checkpoints[job_id]["step"])
            await fed.kill_shard(0)
            tasks["a"].cancel()
            await asyncio.gather(tasks["a"], return_exceptions=True)
            monkeypatch.delenv("CHIASWARM_CHAOS_SLOW_STEP")
            await fed.restart_shard(0)
            start("b")
            await fed.wait_for_results(1, timeout=240)
        finally:
            for worker in workers.values():
                worker.request_stop()
            await asyncio.gather(*(asyncio.wait_for(t, timeout=60)
                                   for t in tasks.values()),
                                 return_exceptions=True)
            for worker in workers.values():
                stepper = getattr(worker.pool.slots[0], "_stepper", None)
                if stepper is not None:
                    stepper.drain(60)
                    stepper.shutdown()
            await fed.stop()
        return fed, workers, held

    import tempfile

    with tempfile.TemporaryDirectory() as root:
        fed, workers, held = asyncio.run(scenario(root))
    assert fed.uploaded_ids() == [job_id]  # exactly once
    [result] = fed.results
    assert result["worker_name"] == "fedlane-b"
    assert "fatal_error" not in result
    stamp = result["pipeline_config"]["stepper"]
    assert 1 <= stamp["resume_step"] < KILL_STEPS
    assert stamp["resume_step"] >= held
    assert fed.stats()["aggregate"]["epochs"] == [2, 1]
    b = workers["b"]
    assert b.pool.slots[0]._stepper.stats()["rows_resumed"] == 1
    [trace] = [t for t in b.traces.traces() if t.meta["id"] == job_id]
    assert trace.meta[HIVE_EPOCH_KEY] == 2
    assert trace.meta[HIVE_SHARD_KEY] == 0
    assert [s["hive_epoch"] for s in b.health()["hive_shards"]] == [2, 1]
    record = fed.flight(job_id)
    events = [e["event"] for e in record["events"]]
    assert "hive_recovered" in events and events.count("settled") == 1
