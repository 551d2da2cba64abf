"""The port's hive worker (``chiaswarm_tpu_torch/node/worker.py``) and the
modules it brings, on the CPU, against the JAX package.

- **Copies pinned to their sources**: ``Settings`` (defaults, JSON and
  legacy round trip, env precedence, ``deadline_for``, ``hive_uris``, the
  file helpers), ``Backoff``/``backoff_delay`` (the same delays from the
  same seeds), ``BreakerBoard`` (the same transitions on scripted outcomes;
  state files pass both ways), ``DeadLetterSpool`` (a spool of either
  package replays through the other's worker), ``classify_result``,
  ``derive_mesh_spec``, ``estimate_family_bytes`` and the metrics render.
- **The worker against the JAX worker**: the same tiny job (64 px, 2 steps,
  seed 5) through each worker and its own ``FakeHive``, lanes off and on:
  the same envelope keys and config values, the same requests (paths,
  headers, query strings), the same ``jobs_done``.
- **The fault seams of the JAX package's ``node/chaos.py``**:
  ``ChaoticHive`` and ``ChaoticExecutor`` through the ``hive=`` and
  ``executor=`` seams of both workers, on the same schedules: the final
  outcome of every job and the ``ResilienceStats`` snapshot are equal, for
  each scenario of ``tests/test_chaos.py`` listed in ``CHAOS``.
- **Lanes through the worker**: a burst handed out while a lane steps
  splices into it; two solo bursts never run on one device at once and
  never give ``SlotBusy``; a job submitted from an executor thread renders
  the bits of one submitted directly.
- **No CPU fallback**, the default pool's rules, and the federation
  settings (several hive uris, ``hive_front_uri``), which the worker once
  refused and now serves (``tests/test_torch_federation.py``).
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import io
import json
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import aiohttp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.core import mesh as jmesh
from chiaswarm_tpu.node import executor as jexecutor
from chiaswarm_tpu.node import resilience as jres
from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor, ChaoticHive
from chiaswarm_tpu.node.hive import BadWorkerError as JaxBadWorkerError
from chiaswarm_tpu.node.hive import HiveClient as JaxHiveClient
from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.obs import metrics as jmetrics
from chiaswarm_tpu_torch.core import mesh as tmesh
from chiaswarm_tpu_torch.core.chip_pool import ChipPool, DeviceSlot, SlotBusy
from chiaswarm_tpu_torch.node import executor as texecutor
from chiaswarm_tpu_torch.node import resilience as tres
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.hive import BadWorkerError as TorchBadWorkerError
from chiaswarm_tpu_torch.node.hive import HiveClient as TorchHiveClient
from chiaswarm_tpu_torch.node.registry import ModelRegistry as TorchRegistry
from chiaswarm_tpu_torch.obs import metrics as tmetrics
from chiaswarm_tpu_torch.serving.stepper import get_stepper
from tests.fake_hive import FakeHive

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: the suite's workers
    share the CPU, and many small ops wait on an oversubscribed thread pool
    far longer than they compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _tmp_root(tmp_path, monkeypatch):
    """Settings root (logs, spools, breaker files) per test."""
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    for var in ("SDAAS_ROOT", "SDAAS_URI", "SDAAS_TOKEN", "SDAAS_WORKERNAME",
                "SWARM_TPU_URI", "SWARM_TPU_TOKEN", "SWARM_TPU_WORKERNAME",
                "SWARM_TPU_FRONT_URI", "SWARM_TPU_LOG_LEVEL",
                "CHIASWARM_RESIDENCY_BUDGET"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


@pytest.fixture(autouse=True)
def _restore_matmul_precision():
    """The JAX worker's startup pins bf16 matmuls; later tests of the suite
    compare in float32."""
    import jax

    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


# ---------------------------------------------------------------------------
# 1. copies pinned to their sources


def _custom_settings(mod):
    return mod.Settings(
        hive_uri="http://hive.example:8000", hive_token="tok",
        worker_name="node-7", mesh_shape={"data": 2}, latency_mode=True,
        job_deadline_s=120.0, workflow_deadline_s={"txt2vid": 900.0},
        transient_retries=4, breaker_threshold=5, upload_retries=6,
        family_deadline_s={"sd15": 30.0})


def test_settings_defaults_and_json_round_trips_match_jax():
    assert ([f.name for f in dataclasses.fields(tsettings.Settings)]
            == [f.name for f in dataclasses.fields(jsettings.Settings)])
    assert (tsettings.Settings().to_json() == jsettings.Settings().to_json())
    for mod in (tsettings, jsettings):
        assert (mod.POLL_BUSY_S, mod.POLL_IDLE_S, mod.POLL_ERROR_S) == (
            jsettings.POLL_BUSY_S, jsettings.POLL_IDLE_S,
            jsettings.POLL_ERROR_S)
    t, j = _custom_settings(tsettings), _custom_settings(jsettings)
    assert t.to_json() == j.to_json()
    assert t.to_legacy_json() == j.to_legacy_json()
    legacy = json.loads(json.dumps(j.to_legacy_json()))
    assert (tsettings.Settings.from_json(legacy).to_json()
            == jsettings.Settings.from_json(legacy).to_json()
            == json.loads(json.dumps(j.to_json())))


@pytest.mark.parametrize("env", [
    {},
    {"SDAAS_URI": "http://legacy", "SDAAS_TOKEN": "lt"},
    {"SDAAS_URI": "http://legacy", "SWARM_TPU_URI": "http://native",
     "SWARM_TPU_WORKERNAME": "w2", "SWARM_TPU_LOG_LEVEL": "DEBUG"},
    {"SDAAS_WORKERNAME": "legacy-name", "SWARM_TPU_FRONT_URI": "http://f"},
], ids=["file-only", "legacy-env", "native-over-legacy", "names"])
def test_settings_env_precedence_matches_jax(env, tmp_path, monkeypatch):
    """defaults < settings.json < env vars, for both packages on the same
    root; a settings.json written by one package loads in the other."""
    tsettings.save_settings(_custom_settings(tsettings))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    t, j = tsettings.load_settings(), jsettings.load_settings()
    assert t.to_json() == j.to_json()
    assert tsettings.settings_root() == jsettings.settings_root() == tmp_path
    jsettings.save_file({"models": [1, 2]}, "models.json")
    assert tsettings.load_file("models.json") == {"models": [1, 2]}
    assert tsettings.load_file("absent.json") is None


def test_settings_root_falls_back_like_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SWARM_TPU_ROOT")
    monkeypatch.setenv("SDAAS_ROOT", str(tmp_path / "legacy"))
    assert (tsettings.settings_root() == jsettings.settings_root()
            == tmp_path / "legacy")
    monkeypatch.delenv("SDAAS_ROOT")
    assert tsettings.settings_root() == jsettings.settings_root()


@pytest.mark.parametrize("workflow", [None, "", "txt2img", "txt2vid",
                                      "img2vid", "stitch"])
def test_deadline_for_matches_jax(workflow):
    for table in ({}, {"txt2vid": 1800.0}, {"default": 90.0,
                                            "img2vid": 1200.0}):
        t = tsettings.Settings(job_deadline_s=300.0,
                               workflow_deadline_s=dict(table))
        j = jsettings.Settings(job_deadline_s=300.0,
                               workflow_deadline_s=dict(table))
        assert t.deadline_for(workflow) == j.deadline_for(workflow)


@pytest.mark.parametrize("uri,shards", [
    ("http://a", ()), ("http://a, http://b ,", ()),
    ("http://a", ("http://x", " ", "http://y"))])
def test_hive_uris_match_jax(uri, shards):
    assert (tsettings.Settings(hive_uri=uri,
                               hive_shard_uris=shards).hive_uris()
            == jsettings.Settings(hive_uri=uri,
                                  hive_shard_uris=shards).hive_uris())


@pytest.mark.parametrize("seed", ["poll:test", "retry:node-7", 7])
def test_backoff_matches_jax(seed):
    t = tres.Backoff(base=2.0, cap=121.0, seed=seed)
    j = jres.Backoff(base=2.0, cap=121.0, seed=seed)
    seq_t = [t.next() for _ in range(12)]
    assert seq_t == [j.next() for _ in range(12)]
    assert t.failures == j.failures == 12
    t.reset(), j.reset()
    assert t.next() == j.next()
    rng_t, rng_j = random.Random(seed), random.Random(seed)
    for attempt in range(1, 13):
        assert (tres.backoff_delay(attempt, 0.5, 30.0, rng_t)
                == jres.backoff_delay(attempt, 0.5, 30.0, rng_j))
        assert (tres.backoff_delay(attempt, 5.0, 121.0)
                == jres.backoff_delay(attempt, 5.0, 121.0))


BREAKER_SCRIPTS = {
    "open-probe-close": [("fail", "m"), ("fail", "m"), ("allow", "m"),
                         ("tick", 11.0), ("allow", "m"), ("allow", "m"),
                         ("ok", "m"), ("allow", "m")],
    "probe-fails-rearms": [("fail", "m"), ("fail", "m"), ("fail", "m"),
                           ("tick", 10.0), ("allow", "m"), ("fail", "m"),
                           ("allow", "m"), ("tick", 10.0), ("allow", "m"),
                           ("inconclusive", "m"), ("allow", "m")],
    "two-models": [("ok", "a"), ("fail", "a"), ("fail", "b"), ("ok", "a"),
                   ("fail", "b"), ("allow", "b"), ("allow", "a"),
                   ("tick", 5.0), ("inconclusive", "b"), ("tick", 6.0),
                   ("allow", "b"), ("fail", "b"), ("allow", "b")],
}


def _drive_board(mod, script, persist_path=None):
    clock = [100.0]
    events: list = []
    board = mod.BreakerBoard(
        threshold=2, cooldown_s=10.0, clock=lambda: clock[0],
        on_open=lambda m: events.append(("open", m)),
        on_close=lambda m: events.append(("close", m)),
        on_probe=lambda m: events.append(("probe", m)),
        persist_path=persist_path)
    trail = []
    for op, arg in script:
        if op == "tick":
            clock[0] += arg
            continue
        if op == "allow":
            trail.append(board.allow(arg))
        elif op == "inconclusive":
            board.record_inconclusive(arg)
        else:
            board.record(arg, ok=(op == "ok"))
        trail.append((board.states(), board.open_models(), list(events)))
    return trail, board, clock


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_board_transitions_match_jax(name):
    t_trail, _, _ = _drive_board(tres, BREAKER_SCRIPTS[name])
    j_trail, _, _ = _drive_board(jres, BREAKER_SCRIPTS[name])
    assert t_trail == j_trail


def test_breaker_state_files_pass_both_ways(tmp_path):
    """The port writes the JAX format byte for byte, and each package's
    board restores the other's open breakers (and mirrors them into its
    registry's quarantine)."""
    script = [("fail", "a"), ("fail", "a"), ("fail", "b"), ("tick", 4.0),
              ("fail", "b")]
    j_path, t_path = tmp_path / "j.breakers.json", tmp_path / "t.breakers.json"
    _, j_board, j_clock = _drive_board(jres, script, j_path)
    _, t_board, t_clock = _drive_board(tres, script, t_path)
    j_board.save(), t_board.save()
    assert t_path.read_bytes() == j_path.read_bytes()
    for reader, path in ((tres, j_path), (jres, t_path)):
        opened: list = []
        restored = reader.BreakerBoard(
            threshold=2, cooldown_s=10.0, clock=lambda: 5000.0,
            on_open=opened.append, persist_path=path)
        assert sorted(opened) == ["a", "b"]
        assert restored.states() == j_board.states()
        assert not restored.allow("a") and not restored.allow("b")
    registry = TorchRegistry(catalog=[], allow_random=True, device="cpu")
    board = tres.BreakerBoard(threshold=2, cooldown_s=10.0,
                              on_open=registry.quarantine, persist_path=j_path)
    assert board.open_models() == ["a", "b"]
    assert registry.is_quarantined("a") and registry.is_quarantined("b")
    with pytest.raises(ValueError, match="quarantined"):
        registry.pipeline("a")


ENVELOPES = [
    None,
    {"id": 1, "pipeline_config": {}},
    {"id": 2, "pipeline_config": {"seed": 3}},
    {"id": 3, "pipeline_config": {"error": "boom"}},
    {"id": 4, "pipeline_config": {"error": "boom"}, "fatal_error": True},
    {"id": 5, "pipeline_config": {"error": "x", "error_kind": "oom"}},
    {"id": 6, "pipeline_config": {"error": "x", "error_kind": "timeout"},
     "fatal_error": True},
    {"id": 7, "pipeline_config": "not-a-dict"},
    {"id": 8},
    "not-an-envelope",
]


@pytest.mark.parametrize("envelope", ENVELOPES,
                         ids=[str(i) for i in range(len(ENVELOPES))])
def test_classify_result_matches_jax(envelope):
    assert tres.classify_result(envelope) == jres.classify_result(envelope)


def test_failure_kind_sets_match_jax():
    for name in ("RETRYABLE_KINDS", "BREAKER_KINDS", "REDISPATCH_KINDS",
                 "NONFATAL_KINDS"):
        assert getattr(tres, name) == getattr(jres, name), name


def test_dead_letter_spool_files_match_jax(tmp_path):
    envelope = jexecutor.error_result({"id": "dl/1 x",
                                       "content_type": "application/json"},
                                      "spooled", kind="error")
    t_path = tres.DeadLetterSpool(tmp_path / "t").spool(dict(envelope))
    j_path = jres.DeadLetterSpool(tmp_path / "j").spool(dict(envelope))
    assert t_path.name == j_path.name
    assert t_path.read_bytes() == j_path.read_bytes()
    (tmp_path / "t" / "broken.json").write_text("{not json")
    replayed = tres.DeadLetterSpool(tmp_path / "t").replay()
    assert [p.name for p, _ in replayed] == [t_path.name]
    assert replayed[0][1] == envelope
    assert (tmp_path / "t" / "broken.json.bad").exists()


SDXL_CLASS_BYTES = 6_937_675_734   # the JAX estimate of the sdxl family


@pytest.fixture(scope="module")
def sd15_bytes():
    from chiaswarm_tpu_torch.pipelines.components import estimate_family_bytes

    return estimate_family_bytes("sd15")


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("which", [None, "sd15", "sdxl_class"])
@pytest.mark.parametrize("latency", [False, True])
def test_derive_mesh_spec_matches_jax(n, which, latency, sd15_bytes):
    nbytes = {None: None, "sd15": sd15_bytes,
              "sdxl_class": SDXL_CLASS_BYTES}[which]
    for hbm in (None, 80 * 1024**3):
        t = tmesh.derive_mesh_spec(n, nbytes, hbm_bytes=hbm, latency=latency)
        j = jmesh.derive_mesh_spec(n, nbytes, hbm_bytes=hbm, latency=latency)
        assert dict(t.shape) == dict(j.shape), (n, which, latency, hbm)


def test_residency_budget_matches_jax(monkeypatch):
    assert tmesh._DEFAULT_HBM_BYTES == jmesh._DEFAULT_HBM_BYTES
    assert tmesh.device_hbm_bytes("cpu") == jmesh._DEFAULT_HBM_BYTES
    for hbm in (16 * 1024**3, 80 * 1024**3):
        assert (tmesh.resident_param_budget_bytes(hbm)
                == jmesh.resident_param_budget_bytes(hbm))
    monkeypatch.setenv(tmesh.ENV_RESIDENCY_BUDGET, "3e9")
    assert (tmesh.resident_param_budget_bytes(1)
            == jmesh.resident_param_budget_bytes(1) == 3_000_000_000)


@pytest.mark.parametrize("family", ["tiny", "tiny_up", "tiny_p2p", "sd15",
                                    "upscaler_x2", "tiny_xl"])
def test_estimate_family_bytes_matches_jax(family):
    from chiaswarm_tpu.pipelines.components import (
        estimate_family_bytes as jax_estimate,
    )
    from chiaswarm_tpu_torch.pipelines.components import estimate_family_bytes

    assert estimate_family_bytes(family) == jax_estimate(family)


def test_estimate_refuses_families_the_port_does_not_build():
    """The class-conditioned x4 upscaler has modules in the port since the
    cascade's slice: its estimate is JAX's (held on ``tiny_up4``; the
    published family counts its 1,000-row noise-level table too)."""
    from chiaswarm_tpu.pipelines.components import (
        estimate_family_bytes as jax_estimate,
    )
    from chiaswarm_tpu_torch.pipelines.components import estimate_family_bytes

    assert estimate_family_bytes("tiny_up4") == jax_estimate("tiny_up4")
    assert estimate_family_bytes("upscaler_x4") > estimate_family_bytes(
        "upscaler_x2")


def _drive_metrics(mod, stats_cls):
    reg = mod.Registry()
    c = reg.counter("demo_total", "a counter", labelnames=("kind",))
    c.inc(kind="a"), c.inc(2.5, kind="b\n\"q\"")
    reg.gauge("demo_depth", "a gauge").set(3.5)
    h = reg.histogram("demo_seconds", "a histogram", labelnames=("phase",),
                      buckets=(0.1, 1.0, 10.0))
    for v, p in ((0.05, "poll"), (0.5, "execute"), (50.0, "execute")):
        h.observe(v, phase=p)
    plain = reg.histogram("demo_job_seconds", "no labels")
    plain.observe(1.25)
    mod.dead_letter_replayed_counter(reg).inc(when="live")
    mod.hive_session_state_gauge(reg).set(1)
    stats = stats_cls(reg)
    stats.jobs_failed += 2
    stats.upload_retries += 1
    with pytest.raises(ValueError):
        reg.counter("demo_total")  # other labels than its first declaration
    return (reg.render(), stats.snapshot(), h.count(phase="execute"),
            h.sum(phase="execute"), plain.count(), plain.sum(),
            c.value(kind="a"), mod.render_all([reg, mod.Registry()]))


def test_metrics_render_matches_jax():
    assert (tmetrics.DEAD_LETTER_REPLAY_WHEN
            == jmetrics.DEAD_LETTER_REPLAY_WHEN)
    assert (_drive_metrics(tmetrics, tres.ResilienceStats)
            == _drive_metrics(jmetrics, jres.ResilienceStats))


# ---------------------------------------------------------------------------
# 2. the worker against the JAX worker on the same job


class RecordingHive(FakeHive):
    """FakeHive that records each request's method, path, query string and
    headers (``Host`` and ``Content-Length`` dropped: the port differs, and
    so does each upload's size)."""

    def __init__(self) -> None:
        super().__init__()
        self.requests: list[tuple] = []

    def _record(self, request) -> None:
        headers = tuple(sorted(
            (k.lower(), v) for k, v in request.headers.items()
            if k.lower() not in ("host", "content-length")))
        self.requests.append((request.method, request.path,
                              request.query_string, headers))

    async def _work(self, request):
        self._record(request)
        return await super()._work(request)

    async def _results(self, request):
        self._record(request)
        return await super()._results(request)


TINY_JOB = {"id": "wire-1", "model_name": "tiny",
            "prompt": "a lighthouse on a cliff", "num_inference_steps": 2,
            "height": 64, "width": 64, "seed": 5, "content_type": "image/png"}
TINY_CATALOG = [{"name": "tiny", "family": "tiny", "parameters": {}}]


def _serve_one(worker_cls, settings_mod, make_pool, make_registry, jobs):
    async def scenario():
        hive = RecordingHive()
        uri = await hive.start()
        hive.jobs.extend(dict(job) for job in jobs)
        worker = worker_cls(
            settings=settings_mod.Settings(
                hive_uri=uri, hive_token="t", worker_name="wire-worker",
                poll_busy_s=0.05, poll_idle_s=0.05,
                install_signal_handlers=False),
            pool=make_pool(), registry=make_registry())
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(len(jobs), timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive, worker

    return asyncio.run(scenario())


@pytest.mark.parametrize("lanes", ["0", "1"], ids=["solo", "lanes"])
def test_worker_wire_and_envelope_match_the_jax_worker(lanes, monkeypatch):
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool

    monkeypatch.setenv("CHIASWARM_STEPPER", lanes)
    j_hive, j_worker = _serve_one(
        JaxWorker, jsettings, lambda: JaxPool(n_slots=1),
        lambda: JaxRegistry(catalog=TINY_CATALOG, allow_random=True),
        [TINY_JOB])
    t_pool = ChipPool(device="cpu")
    t_hive, t_worker = _serve_one(
        tworker.Worker, tsettings, lambda: t_pool,
        lambda: TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                              device="cpu"),
        [TINY_JOB])
    get_stepper(t_pool.slots[0]).shutdown()
    [ref], [got] = j_hive.results, t_hive.results
    assert "error" not in ref["pipeline_config"], ref["pipeline_config"]
    assert "error" not in got["pipeline_config"], got["pipeline_config"]
    assert set(got) == set(ref)
    assert got["worker_name"] == ref["worker_name"] == "wire-worker"
    assert set(got["artifacts"]) == set(ref["artifacts"])
    for key, artifact in ref["artifacts"].items():
        assert set(got["artifacts"][key]) == set(artifact)
        assert got["artifacts"][key]["content_type"] == artifact["content_type"]
    assert set(got["pipeline_config"]) == set(ref["pipeline_config"])
    for key in ("scheduler", "steps", "guidance_scale", "size", "mode",
                "nsfw", "safety_checker", "family", "model_name", "seed"):
        assert got["pipeline_config"][key] == ref["pipeline_config"][key], key
    assert ("stepper" in got["pipeline_config"]) is (lanes == "1")
    assert set(t_hive.requests) == set(j_hive.requests)
    assert {r[:2] for r in t_hive.requests} == {("GET", "/api/work"),
                                                ("POST", "/api/results")}
    assert t_worker.jobs_done == j_worker.jobs_done == 1
    assert t_worker.stats.snapshot() == j_worker.stats.snapshot()
    # the job's trace: poll -> execute -> upload, folded into the histogram
    [trace] = t_worker.traces.traces()
    assert [c.name for c in trace.root.children] == ["poll", "execute",
                                                     "upload"]
    # the execute phase's spans break the worker's host seconds down: on
    # the lanes, JAX's (format, text encode, lane wait, decode) and the
    # PNG and base64 of the artifacts
    execute = [c.name for c in trace.root.children[1].children]
    if lanes == "1":
        [j_trace] = j_worker.traces.traces()
        j_execute = [c.name for c in j_trace.root.children[1].children]
        assert execute == j_execute + ["artifacts"], (execute, j_execute)
    else:
        assert execute == ["format", "decode", "artifacts"], execute
    assert t_worker._job_seconds.count() == 1
    assert t_worker._job_seconds.sum() == pytest.approx(
        trace.root.duration_s)


# ---------------------------------------------------------------------------
# 3. the fault seams of chiaswarm_tpu/node/chaos.py, against both workers


class StubSlot:
    """Executor-less slot, as ``tests/test_chaos.py``'s: the
    ChaoticExecutor never touches a device."""

    def __init__(self, depth: int = 2, data_width: int = 1,
                 name: str = "stub"):
        self.depth = depth
        self.data_width = data_width
        self.name = name

    def descriptor(self):
        return self.name


PACKAGES = {
    "jax": dict(worker=JaxWorker, settings=jsettings, res=jres,
                client=JaxHiveClient, bad_worker=JaxBadWorkerError,
                error_result=jexecutor.error_result,
                registry=lambda: JaxRegistry(catalog=[], allow_random=True)),
    "torch": dict(worker=tworker.Worker, settings=tsettings, res=tres,
                  client=TorchHiveClient, bad_worker=TorchBadWorkerError,
                  error_result=texecutor.error_result,
                  registry=lambda: TorchRegistry(catalog=[],
                                                 allow_random=True,
                                                 device="cpu")),
}


def _settings(pkg, uri="http://unused", **over):
    base = dict(
        hive_uri=uri, hive_token="t", worker_name="chaos-worker",
        job_deadline_s=0.25, transient_retries=2,
        retry_backoff_s=0.01, retry_backoff_cap_s=0.05,
        breaker_threshold=2, breaker_cooldown_s=3600.0,
        poll_busy_s=0.02, poll_idle_s=0.05,
        poll_backoff_base_s=0.02, poll_backoff_cap_s=0.1,
        upload_retries=3, upload_retry_delay_s=0.01,
        drain_timeout_s=5.0, result_drain_timeout_s=5.0,
        install_signal_handlers=False)
    base.update(over)
    return PACKAGES[pkg]["settings"].Settings(**base)


def _cjob(job_id, chaos=None, model=None, **over):
    job = {"id": job_id, "model_name": model or f"model/{job_id}",
           "prompt": f"p {job_id}", "num_inference_steps": 2,
           "height": 64, "width": 64, "content_type": "application/json"}
    if chaos is not None:
        job["chaos"] = chaos
    job.update(over)
    return job


def _worker(pkg, settings, executor, registry=None, hive=None, slots=None):
    return PACKAGES[pkg]["worker"](
        settings=settings, pool=slots if slots is not None else [StubSlot()],
        registry=registry if registry is not None else object(),
        hive=hive if hive is not None else object(), executor=executor)


def _outcome(result):
    config = result.get("pipeline_config") or {}
    return (jres.classify_result(result), bool(result.get("fatal_error")),
            config.get("error"), config.get("error_class"))


def _outcomes(results):
    return {str(r["id"]): _outcome(r) for r in results}


async def _run_against_chaotic_hive(pkg, hive, settings_over, executor,
                                    wait_results, registry=None,
                                    until=None):
    uri = await hive.start()
    settings = _settings(pkg, uri, **settings_over)
    client = PACKAGES[pkg]["client"](uri, "t", settings.worker_name)
    worker = PACKAGES[pkg]["worker"](
        settings=settings, pool=[StubSlot()],
        registry=registry or PACKAGES[pkg]["registry"](), hive=client,
        executor=executor)
    task = asyncio.create_task(worker.run())
    try:
        await hive.wait_for_results(wait_results, timeout=60)
        if until is not None:
            for _ in range(200):
                if until(worker):
                    break
                await asyncio.sleep(0.05)
    finally:
        worker.request_stop()
        await asyncio.wait_for(task, timeout=20)
        await hive.stop()
    return worker


async def chaos_zero_loss(pkg):
    hive = ChaoticHive(
        poll_faults=["drop", "ok", "http_500", "delay", "bad_worker",
                     "malformed"],
        result_faults={"c-retry": ["http_500", "ok"],
                       "c-retry2": ["drop", "ok"],
                       "c-dead": ["http_500"] * 10},
        delay_s=0.02)
    jobs = [_cjob("c-ok"), _cjob("c-crash", chaos=["crash"]),
            _cjob("c-oom", chaos=["oom", "ok"]),
            _cjob("c-fetch", chaos=["fetch", "ok"]),
            _cjob("c-hang", chaos=["hang"]),
            _cjob("c-fatal", chaos=["fatal"]),
            _cjob("c-retry"), _cjob("c-retry2"), _cjob("c-dead")]
    for job in jobs:
        hive.submit(job)
    executor = ChaoticExecutor(hang_s=1.0)
    # c-dead's failed uploads would flip the hive session into an outage
    # whose live replays and assumed-lost leases depend on what else is in
    # flight at that instant; the outage path is held by poll_backoff
    worker = await _run_against_chaotic_hive(
        pkg, hive, {"hive_outage_after": 10}, executor, len(jobs),
        until=lambda w: w.dead_letters.depth() >= 1)
    dead = {json.loads(p.read_text())["id"]: _outcome(
        json.loads(p.read_text()))
        for p in worker.dead_letters.directory.glob("*.json")}
    uploaded = hive.uploaded_ids()
    assert len(uploaded) == len(set(uploaded))
    assert set(uploaded) == {j["id"] for j in jobs} - {"c-dead"} | {
        "malformed-1"}
    assert set(dead) == {"c-dead"}
    return {"uploaded": _outcomes(hive.results), "dead": dead,
            "attempts": dict(executor.attempts),
            "stats": worker.stats.snapshot(),
            "poll_errors": worker._poll_backoff.failures}


async def chaos_oom_split(pkg):
    executor = ChaoticExecutor()
    worker = _worker(pkg, _settings(pkg), executor)
    jobs = [_cjob(f"b{i}", chaos=["oom", "ok"], model="shared/model")
            for i in range(3)]
    results = await worker._execute_burst(jobs, StubSlot())
    assert executor.events[0] == ("batch", ["b0", "b1", "b2"])
    assert executor.events[1:] == [("solo", ["b0"]), ("solo", ["b1"]),
                                   ("solo", ["b2"])]
    return {"results": _outcomes(results), "events": executor.events,
            "stats": worker.stats.snapshot()}


async def chaos_transient_retry(pkg):
    executor = ChaoticExecutor()
    worker = _worker(pkg, _settings(pkg), executor)
    results = await worker._execute_burst(
        [_cjob("t1", chaos=["fetch", "fetch", "ok"])], StubSlot())
    assert executor.attempts["t1"] == 3
    return {"results": _outcomes(results), "attempts": executor.attempts,
            "stats": worker.stats.snapshot()}


async def chaos_fatal_never_retried(pkg):
    executor = ChaoticExecutor()
    worker = _worker(pkg, _settings(pkg), executor)
    results = await worker._execute_burst(
        [_cjob("f1", chaos=["fatal", "ok"])], StubSlot())
    assert executor.attempts["f1"] == 1 and results[0]["fatal_error"]
    return {"results": _outcomes(results), "stats": worker.stats.snapshot()}


async def chaos_workflow_deadline(pkg):
    executor = ChaoticExecutor(hang_s=30.0)
    worker = _worker(pkg, _settings(pkg, job_deadline_s=100.0,
                                    workflow_deadline_s={"slowflow": 0.05}),
                     executor)
    results = await worker._execute_burst(
        [_cjob("d1", chaos=["hang"], workflow="slowflow")], StubSlot())
    assert results[0]["pipeline_config"]["error_kind"] == "timeout"
    return {"results": _outcomes(results), "stats": worker.stats.snapshot()}


async def chaos_breaker_probe_recovery(pkg):
    clock = [0.0]
    executor = ChaoticExecutor()
    registry = PACKAGES[pkg]["registry"]()
    worker = _worker(pkg, _settings(pkg), executor, registry=registry)
    worker.breakers = PACKAGES[pkg]["res"].BreakerBoard(
        threshold=2, cooldown_s=10.0, clock=lambda: clock[0],
        on_open=registry.quarantine, on_close=registry.unquarantine,
        on_probe=registry.unquarantine)
    bad, trail = "bad/checkpoint", []
    for i in range(2):
        trail.append(_outcomes(await worker._execute_burst(
            [_cjob(f"q{i}", chaos=["crash"], model=bad)], StubSlot())))
    trail.append((registry.is_quarantined(bad), worker.breakers.states()))
    trail.append(_outcomes(await worker._execute_burst(
        [_cjob("q2", chaos=["ok"], model=bad)], StubSlot())))
    assert "q2" not in executor.attempts  # refused without running
    clock[0] = 11.0
    trail.append(_outcomes(await worker._execute_burst(
        [_cjob("q3", chaos=["ok"], model=bad)], StubSlot())))
    trail.append((registry.is_quarantined(bad), worker.breakers.states()))
    assert trail[2][0] and not trail[-1][0]
    return {"trail": trail, "stats": worker.stats.snapshot()}


async def chaos_crashed_burst(pkg):
    executor = ChaoticExecutor()
    slot = StubSlot(depth=1, data_width=4)
    worker = _worker(pkg, _settings(pkg), executor, slots=[slot])
    for i in range(3):
        worker.work_queue.put_nowait(_cjob(f"x{i}", chaos=["crash"],
                                           model="tiny"))
    task = asyncio.create_task(worker._slot_worker(slot))
    await asyncio.wait_for(worker.work_queue.join(), timeout=10)
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    envelopes = []
    while not worker.result_queue.empty():
        envelopes.append(worker.result_queue.get_nowait())
    assert sorted(e["id"] for e in envelopes) == ["x0", "x1", "x2"]
    return {"results": _outcomes(envelopes), "events": executor.events,
            "stats": worker.stats.snapshot()}


async def chaos_shutdown_drains(pkg):
    hive = ChaoticHive()
    uri = await hive.start()
    executor = ChaoticExecutor(slow_s=0.4)
    hive.submit(_cjob("c-slow", chaos=["slow"]))
    worker = _worker(pkg, _settings(pkg, uri, job_deadline_s=10.0),
                     executor, registry=PACKAGES[pkg]["registry"](),
                     hive=PACKAGES[pkg]["client"](uri, "t", "chaos-worker"))
    task = asyncio.create_task(worker.run())
    try:
        await asyncio.wait_for(executor.started.wait(), timeout=30)
        worker.request_stop()  # the job is in flight right now
        await asyncio.wait_for(task, timeout=20)
    finally:
        await hive.stop()
    assert hive.uploaded_ids() == ["c-slow"]
    return {"uploaded": _outcomes(hive.results),
            "dead": worker.dead_letters.depth(),
            "stats": worker.stats.snapshot()}


async def chaos_forced_cancel_requeues(pkg):
    executor = ChaoticExecutor(hang_s=30.0)
    worker = _worker(pkg, _settings(pkg, job_deadline_s=100.0), executor,
                     slots=[StubSlot(depth=1, data_width=4)])
    worker.work_queue.put_nowait(_cjob("A", chaos=["hang"], model="tiny"))
    worker.work_queue.put_nowait(_cjob("B", chaos=["ok"], model="tiny",
                                       height=128))
    task = asyncio.create_task(worker._slot_worker(worker.pool[0]))
    await asyncio.wait_for(executor.started.wait(), timeout=10)
    await asyncio.sleep(0.05)  # A hangs in flight; B is held
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    queued = [worker.work_queue.get_nowait()["id"]
              for _ in range(worker.work_queue.qsize())]
    assert queued == ["B"]
    return {"queued": queued, "events": executor.events,
            "stats": worker.stats.snapshot()}


async def chaos_spool_replay(pkg):
    spool = PACKAGES[pkg]["res"].DeadLetterSpool(
        tsettings.settings_root() / "dead_letter" / "chaos-worker")
    spool.spool(PACKAGES[pkg]["error_result"](
        {"id": "dl-1", "content_type": "application/json"},
        "spooled by a previous run", kind="error"))
    hive = ChaoticHive()
    worker = await _run_against_chaotic_hive(pkg, hive, {},
                                             ChaoticExecutor(), 1)
    assert hive.uploaded_ids() == ["dl-1"] and spool.depth() == 0
    return {"uploaded": _outcomes(hive.results),
            "stats": worker.stats.snapshot()}


async def chaos_full_queue_respects_stop(pkg):
    worker = _worker(pkg, _settings(pkg), ChaoticExecutor(),
                     slots=[StubSlot(depth=1, data_width=1)])
    worker.work_queue.put_nowait(_cjob("fill"))
    assert worker.work_queue.full()
    task = asyncio.create_task(worker._poll_loop())
    await asyncio.sleep(0.1)  # parked in the backpressure wait
    worker.request_stop()
    await asyncio.wait_for(task, timeout=2.0)  # returns, not cancelled
    return {"done": task.done() and not task.cancelled(),
            "stats": worker.stats.snapshot()}


async def chaos_nonjson_400_is_bad_worker(pkg):
    hive = ChaoticHive(poll_faults=["bad_worker", "bad_worker"])
    uri = await hive.start()
    try:
        client = PACKAGES[pkg]["client"](uri, "t", "w")
        async with aiohttp.ClientSession() as session:
            with pytest.raises(PACKAGES[pkg]["bad_worker"]) as caught:
                await client.get_work(session)
            # through the worker: the hive answered, so it is no outage
            worker = _worker(pkg, _settings(pkg, uri), ChaoticExecutor(),
                             hive=client)
            delay = await worker._ask_for_work(session)
    finally:
        await hive.stop()
    return {"message": str(caught.value), "delay": delay,
            "session": worker.hive_session.snapshot(),
            "stats": worker.stats.snapshot()}


async def chaos_poll_backoff(pkg):
    hive = ChaoticHive(poll_faults=["http_500"] * 5 + ["drop"] * 3 + ["ok"])
    uri = await hive.start()
    try:
        worker = _worker(pkg, _settings(pkg, uri, poll_backoff_base_s=2.0,
                                        poll_backoff_cap_s=121.0,
                                        hive_outage_after=4),
                         ChaoticExecutor(),
                         hive=PACKAGES[pkg]["client"](uri, "t", "w"))
        async with aiohttp.ClientSession() as session:
            delays = [await worker._ask_for_work(session) for _ in range(9)]
    finally:
        await hive.stop()
    assert all(d <= 121.0 for d in delays[:8]) and max(delays[5:8]) > 30.0
    assert delays[8] == 0.05  # reset: the next poll waits poll_idle_s
    session = worker.hive_session.snapshot()
    session.pop("last_outage_s")  # wall-clock seconds, not a count
    return {"delays": delays, "failures": worker._poll_backoff.failures,
            "session": session,
            "stats": worker.stats.snapshot()}


CHAOS = {f.__name__[len("chaos_"):]: f for f in (
    chaos_zero_loss, chaos_oom_split, chaos_transient_retry,
    chaos_fatal_never_retried, chaos_workflow_deadline,
    chaos_breaker_probe_recovery, chaos_crashed_burst, chaos_shutdown_drains,
    chaos_forced_cancel_requeues, chaos_spool_replay,
    chaos_full_queue_respects_stop, chaos_nonjson_400_is_bad_worker,
    chaos_poll_backoff)}


@pytest.mark.parametrize("name", list(CHAOS))
def test_chaos_scenario_matches_the_jax_worker(name, tmp_path, monkeypatch):
    observed = {}
    for pkg in ("jax", "torch"):
        # each worker on a settings root of its own: same spool paths
        root = tmp_path / pkg
        monkeypatch.setenv("SWARM_TPU_ROOT", str(root))
        observed[pkg] = asyncio.run(CHAOS[name](pkg))
    assert observed["torch"] == observed["jax"]


# ---------------------------------------------------------------------------
# 4. spools and breaker files between the two workers


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_dead_letter_spool_replays_through_the_other_worker(writer, reader):
    spool = PACKAGES[writer]["res"].DeadLetterSpool(
        tsettings.settings_root() / "dead_letter" / "chaos-worker")
    for i in range(2):
        spool.spool(PACKAGES[writer]["error_result"](
            {"id": f"dl-{i}", "content_type": "image/png"},
            f"spooled by the {writer} worker", kind="timeout"))
    assert spool.depth() == 2

    async def scenario():
        hive = ChaoticHive()
        worker = await _run_against_chaotic_hive(reader, hive, {},
                                                 ChaoticExecutor(), 2)
        return hive, worker

    hive, worker = asyncio.run(scenario())
    assert sorted(hive.uploaded_ids()) == ["dl-0", "dl-1"]
    assert worker.stats.results_replayed == 2
    assert spool.depth() == 0
    for result in hive.results:
        assert result["pipeline_config"]["error_kind"] == "timeout"
        assert result["worker_name"] == "chaos-worker"


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_breaker_file_quarantines_through_the_other_worker(writer, reader):
    async def scenario():
        first = _worker(writer, _settings(writer), ChaoticExecutor(),
                        registry=PACKAGES[writer]["registry"]())
        for i in range(2):
            await first._execute_burst(
                [_cjob(f"bp{i}", chaos=["crash"], model="bad/checkpoint")],
                StubSlot())
        assert first._breaker_state_path().is_file()
        executor = ChaoticExecutor()
        registry = PACKAGES[reader]["registry"]()
        second = _worker(reader, _settings(reader), executor,
                         registry=registry)
        assert registry.is_quarantined("bad/checkpoint")
        [refused] = await second._execute_burst(
            [_cjob("bp2", chaos=["ok"], model="bad/checkpoint")], StubSlot())
        assert "bp2" not in executor.attempts
        return refused

    refused = asyncio.run(scenario())
    assert refused["pipeline_config"]["error_kind"] == "quarantined"
    assert "fatal_error" not in refused


# ---------------------------------------------------------------------------
# 5. lanes, slots and threads


def _decode(blob_b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(blob_b64)))
                      .convert("RGB")).astype(np.int16)


def _lane_job(job_id, seed, steps, guidance=7.5):
    return {"id": job_id, "model_name": "tiny", "prompt": f"prompt {seed}",
            "num_inference_steps": steps, "guidance_scale": guidance,
            "height": 64, "width": 64, "seed": seed,
            "content_type": "image/png"}


def test_burst_handed_out_mid_lane_splices_into_it(monkeypatch):
    """Burst A (2 jobs, 12 steps) opens a lane; burst B (2 jobs, 3 steps)
    is handed out once the lane has stepped twice. B's rows join A's lane
    mid-flight, nothing answers SlotBusy, and every image is within one
    uint8 level of the same four jobs run directly through
    ``synchronous_do_work_batch``."""
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.delenv("CHIASWARM_STEPPER_LANE_WIDTH", raising=False)
    burst_a = [_lane_job("a0", 31, 12), _lane_job("a1", 32, 12, 5.0)]
    burst_b = [_lane_job("b0", 33, 3, 6.0), _lane_job("b1", 34, 3)]
    registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                             device="cpu")
    pool = ChipPool(device="cpu")
    slot = pool.slots[0]

    async def scenario():
        hive = FakeHive()
        uri = await hive.start()
        hive.jobs.extend(dict(j) for j in burst_a)
        worker = tworker.Worker(
            settings=tsettings.Settings(
                hive_uri=uri, hive_token="t", worker_name="lanes",
                poll_busy_s=0.02, poll_idle_s=0.02,
                install_signal_handlers=False),
            pool=pool, registry=registry)
        task = asyncio.create_task(worker.run())
        try:
            while get_stepper(slot).stats().get("steps_executed", 0) < 2:
                await asyncio.sleep(0.01)
            hive.jobs.extend(dict(j) for j in burst_b)
            await hive.wait_for_results(4, timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive, worker

    before = get_stepper(slot).stats()
    hive, worker = asyncio.run(scenario())
    after = get_stepper(slot).stats()
    get_stepper(slot).shutdown()
    by_id = {r["id"]: r for r in hive.results}
    assert sorted(by_id) == ["a0", "a1", "b0", "b1"]
    stamps = {}
    for job_id, result in by_id.items():
        config = result["pipeline_config"]
        assert "error" not in config, config  # no SlotBusy, no fallback
        stamps[job_id] = config["stepper"]
    assert len({s["lane"] for s in stamps.values()}) == 1
    assert stamps["b0"]["admitted_at_step"] >= 1
    assert stamps["b1"]["admitted_at_step"] >= 1
    assert (after.get("rows_admitted_midflight", 0)
            - before.get("rows_admitted_midflight", 0)) >= 2
    assert worker.jobs_done == 4
    fresh = ChipPool(device="cpu").slots[0]
    direct = texecutor.synchronous_do_work_batch(
        [dict(j) for j in burst_a + burst_b], fresh, registry)
    get_stepper(fresh).shutdown()
    for job, result in zip(burst_a + burst_b, direct):
        diff = np.abs(_decode(by_id[job["id"]]["artifacts"]["primary"]["blob"])
                      - _decode(result["artifacts"]["primary"]["blob"]))
        assert diff.max() <= 1, (job["id"], int(diff.max()))


def test_a_replayed_burst_takes_the_same_slots_and_gives_the_same_bits(
        monkeypatch):
    """``chip_smoke.py``'s exact check of the worker's burst: the lane
    admissions of a worker run (burst A at step 0, burst B handed out
    once the lane has stepped twice, at a pinned width of 8) are
    recorded, then ``replay_burst`` admits the same jobs at the same lane
    steps without the worker. The replay takes the same slots at the same
    steps, runs as many lane steps and renders every image bit for bit."""
    import chip_smoke

    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH",
                       str(chip_smoke.LANE_WIDTH))
    burst_a = [_lane_job("a0", 41, 6), _lane_job("a1", 42, 6, 5.0),
               _lane_job("a2", 43, 3)]
    burst_b = [_lane_job("b0", 44, 3, 6.0), _lane_job("b1", 45, 4)]
    registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                             device="cpu")
    pool = ChipPool(device="cpu")
    slot = pool.slots[0]
    admissions: dict = {}

    async def scenario():
        hive = FakeHive()
        uri = await hive.start()
        hive.jobs.extend(dict(j) for j in burst_a)
        worker = tworker.Worker(
            settings=tsettings.Settings(
                hive_uri=uri, hive_token="t", worker_name="replay",
                poll_busy_s=0.02, poll_idle_s=0.02,
                install_signal_handlers=False),
            pool=pool, registry=registry)
        task = asyncio.create_task(worker.run())
        try:
            while get_stepper(slot).stats().get("steps_executed", 0) < 2:
                await asyncio.sleep(0.01)
            hive.jobs.extend(dict(j) for j in burst_b)
            await hive.wait_for_results(5, timeout=300)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive

    before = get_stepper(slot).stats()
    with chip_smoke.lane_admissions(record=admissions):
        hive = asyncio.run(scenario())
    steps = (get_stepper(slot).stats()["steps_executed"]
             - before.get("steps_executed", 0))
    get_stepper(slot).shutdown()
    jobs = burst_a + burst_b
    assert sorted(admissions) == sorted(j["id"] for j in jobs)
    assert len({lane for lane, _, _ in admissions.values()}) == 1
    assert min(admissions[j["id"]][1] for j in burst_b) >= 1
    replay = chip_smoke.replay_burst(registry, slot, jobs, admissions)
    assert {k: v[1:] for k, v in replay["admissions"].items()} == {
        k: v[1:] for k, v in admissions.items()}
    assert replay["steps"] == steps
    by_id = {r["id"]: r for r in hive.results}
    for job in jobs:
        got = replay["results"][job["id"]]
        assert got["pipeline_config"]["stepper"]["admitted_at_step"] == (
            admissions[job["id"]][1])
        assert (got["artifacts"]["primary"]["blob"]
                == by_id[job["id"]]["artifacts"]["primary"]["blob"]), job


def test_solo_bursts_never_share_a_device_and_never_answer_slot_busy(
        monkeypatch):
    """With the lanes off, four bursts (their guidance differs, so each job
    is a burst) at slot depth 2: two are in the executor at once, their
    callbacks run one at a time, and all four upload images."""
    from chiaswarm_tpu_torch.workloads import diffusion

    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    inner = diffusion.diffusion_callback
    state = {"now": 0, "max": 0, "calls": 0}
    lock = threading.Lock()

    def counting(*args, **kwargs):
        with lock:
            state["now"] += 1
            state["calls"] += 1
            state["max"] = max(state["max"], state["now"])
        try:
            return inner(*args, **kwargs)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(diffusion, "diffusion_callback", counting)
    jobs = [_lane_job(f"s{i}", 40 + i, 2, 5.0 + i) for i in range(4)]
    pool = ChipPool(device="cpu")
    assert pool.slots[0].depth == 2
    hive, worker = _serve_one(
        tworker.Worker, tsettings, lambda: pool,
        lambda: TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                              device="cpu"), jobs)
    assert sorted(r["id"] for r in hive.results) == ["s0", "s1", "s2", "s3"]
    for result in hive.results:
        assert "error" not in result["pipeline_config"], result
    assert state == {"now": 0, "max": 1, "calls": 4}


def test_slot_admits_depth_and_runs_callbacks_one_at_a_time():
    slot = DeviceSlot(index=0, device=torch.device("cpu"), depth=2)
    entered, release = threading.Event(), threading.Event()
    running = {"now": 0, "max": 0}
    lock = threading.Lock()

    def slow(s, model_name, *, seed):
        with lock:
            running["now"] += 1
            running["max"] = max(running["max"], running["now"])
        entered.set()
        release.wait(timeout=10)
        with lock:
            running["now"] -= 1
        return {}, {"seed_seen": seed}

    threads = [threading.Thread(target=slot, args=(slow,)) for _ in range(2)]
    threads[0].start()
    assert entered.wait(timeout=10)
    threads[1].start()
    for _ in range(200):  # the second call is admitted and waits
        if slot._admitted._value == 0:
            break
        threading.Event().wait(0.01)
    with pytest.raises(SlotBusy):  # a third is beyond the depth
        slot(slow)
    release.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert running["max"] == 1
    assert slot.data_width == 1


def test_job_from_an_executor_thread_renders_the_direct_bits(monkeypatch):
    """The lane thread runs in a copy of its creator's context; through
    the worker the creator is a thread of the event loop's default
    executor, not the caller's. The same job gives the same bits either
    way."""
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                             device="cpu")
    direct_slot = ChipPool(device="cpu").slots[0]
    thread_slot = ChipPool(device="cpu").slots[0]
    direct = texecutor.synchronous_do_work(dict(TINY_JOB), direct_slot,
                                           registry)
    via_thread = asyncio.run(texecutor.do_work(dict(TINY_JOB), thread_slot,
                                               registry))
    for slot in (direct_slot, thread_slot):
        get_stepper(slot).shutdown()
    assert "stepper" in direct["pipeline_config"]
    assert "stepper" in via_thread["pipeline_config"]
    assert (direct["artifacts"]["primary"]["blob"]
            == via_thread["artifacts"]["primary"]["blob"])


# ---------------------------------------------------------------------------
# 6. entry point, default pool, refused settings


def test_worker_entry_point_has_no_cpu_fallback(tmp_path):
    env = dict(os.environ, SWARM_TPU_ROOT=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "chiaswarm_tpu_torch.node.worker"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("cards,over,catalog,want", [
    (1, {}, ["sd15"], ({"data": 1, "model": 1, "seq": 1}, 1, {"data": 1})),
    (4, {}, ["sd15"], ({"data": 4, "model": 1, "seq": 1}, 4, {"data": 1})),
    (8, {}, ["sdxl-base"], ({"data": 8, "model": 1, "seq": 1}, 8,
                            {"data": 1})),
    (4, {"latency_mode": True}, ["sd15"],
     ({"data": 1, "model": 1, "seq": 4}, 1, {"seq": 4})),
    (4, {"mesh_shape": {"seq": 4}}, [],
     ({"data": 1, "model": 1, "seq": 4}, 1, {"seq": 4})),
    (6, {"latency_mode": True}, ["sd15"], "raises"),
    (8, {"mesh_shape": {"data": 4, "model": 2}}, ["sd15"], "raises"),
], ids=["one-card", "data-4", "sdxl-no-estimate", "latency-seq-4",
        "mesh-shape-wins", "data-x-seq-raises", "model-raises"])
def test_default_pool_rules(cards, over, catalog, want, monkeypatch):
    """On ``cards`` H100s (80 GiB each): SDXL's bf16 estimate fits one card,
    so eight cards serve it data-parallel."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tmesh, "device_hbm_bytes",
                        lambda device=None: 80 * 1024**3)
    worker = tworker.Worker(
        settings=tsettings.Settings(**over),
        pool=ChipPool(device="cpu"),
        registry=TorchRegistry(catalog=[{"name": n} for n in catalog],
                               device="cpu"),
        hive=object())
    if want == "raises":
        with pytest.raises(NotImplementedError, match="item 7"):
            tworker.default_pool_plan(worker.settings, worker.registry)
        return
    spec, n_slots, slot_spec = tworker.default_pool_plan(worker.settings,
                                                         worker.registry)
    assert (spec.resolve(cards), n_slots, dict(slot_spec.shape)) == want


def test_sdxl_estimate_reaches_the_default_pool_policy(monkeypatch):
    """SDXL's estimate (6.94 GB) on eight cards of the JAX module's default
    16 GiB: the port's policy derives the JAX policy's tensor-parallel mesh,
    which the port's pool refuses (ROADMAP queue item 7)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    worker = tworker.Worker(
        settings=tsettings.Settings(), pool=ChipPool(device="cpu"),
        registry=TorchRegistry(catalog=[{"name": "sdxl-base"}], device="cpu"),
        hive=object())
    nbytes = tworker.heaviest_catalog_bytes(worker.registry)
    assert nbytes == 6_937_675_734
    assert (tmesh.derive_mesh_spec(8, nbytes).resolve(8)
            == jmesh.derive_mesh_spec(8, nbytes).resolve(8))
    assert tmesh.derive_mesh_spec(8, nbytes).resolve(8)["model"] > 1
    with pytest.raises(NotImplementedError, match="item 7"):
        tworker.default_pool_plan(worker.settings, worker.registry)


@pytest.mark.parametrize("over", [
    {"hive_uri": "http://a,http://b"}, {"hive_front_uri": "http://front"},
], ids=["shards", "front"])
def test_worker_refuses_parts_of_the_next_slice(over):
    # the name predates federation's port: the worker refused these
    # settings until it served them. Now it builds one session bundle per
    # shard as the JAX worker does (an injected client is the whole
    # control plane, one bundle), and a front is resolved at run()
    kwargs = dict(pool=[StubSlot()], registry=object())
    mine = tworker.Worker(settings=tsettings.Settings(**over), **kwargs)
    theirs = JaxWorker(settings=jsettings.Settings(**over), **kwargs)
    assert [(s.index, s.uri, s.spool.directory.name,
             s.session.name) for s in mine.shards] == \
        [(s.index, s.uri, s.spool.directory.name, s.session.name)
         for s in theirs.shards]
    assert len(mine.shards) == (2 if "hive_uri" in over else 1)
    injected = tworker.Worker(settings=tsettings.Settings(**over),
                              hive=object(), **kwargs)
    assert len(injected.shards) == 1


def test_worker_ignores_guard_enabled_and_logs_it(caplog):
    # the name predates the guard's port: guard_enabled is now honoured (a
    # device guard on every slot, tests/test_torch_guard.py), and startup
    # no longer logs that the setting is ignored
    worker = tworker.Worker(settings=tsettings.Settings(guard_enabled=True),
                            pool=ChipPool(device="cpu"), registry=object(),
                            hive=object())
    with caplog.at_level("INFO", logger="chiaswarm_torch.worker"):
        worker.startup()
    assert "guard_enabled is ignored" not in caplog.text
    assert "1 slot(s)" in caplog.text
    assert worker.guard.enabled
    assert all(slot._guard is worker.guard for slot in worker.pool)
