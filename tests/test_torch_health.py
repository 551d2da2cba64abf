"""The port worker's health surface (``chiaswarm_tpu_torch/node/worker.py``
``health``/``_collect_metrics``/``_start_health_server``,
``obs/metrics.py``, ``obs/trace.py``, ``obs/profiling.py``,
``serving/guard.py::suggest_hang_budget``), on the CPU, against the JAX
package:

- ``Histogram.percentile``/``percentiles`` and ``suggest_hang_budget``
  equal to JAX's on the same samples (``test_budget_suggestion_matches_jax``);
- ``health()``'s keys and the worker registry's metric families and label
  sets equal to the JAX worker's for the ported parts;
- the trace ring's cursor and Chrome export equal to JAX's;
- the endpoints: ``/healthz``, ``/metrics`` as Prometheus text,
  ``/debug/traces`` (Chrome, tree, ``?since=``), ``/debug/profile`` on the
  CPU (``ok``, and ``busy`` for a concurrent capture), JAX's 400 answers;
- the profiler lock shared by captures, per-job traces and tools.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import time

import aiohttp
import pytest
import torch

from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor
from chiaswarm_tpu.node.minihive import MiniHive
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.obs import metrics as jmetrics
from chiaswarm_tpu.obs import trace as jtrace
from chiaswarm_tpu.serving import guard as jguard
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry as TorchRegistry
from chiaswarm_tpu_torch.obs import metrics as tmetrics
from chiaswarm_tpu_torch.obs import profiling
from chiaswarm_tpu_torch.obs import trace as ttrace
from chiaswarm_tpu_torch.serving import guard as tguard
from chiaswarm_tpu_torch.serving import stepper as tstepper

#: federation's per-shard views and the hive epoch: once left for the next
#: worker slice, served since; the tests below hold them present with JAX's
#: shapes
NEXT_SLICE_KEYS = {"hive_epoch", "hive_shards"}
NEXT_SLICE_FAMILIES = {"chiaswarm_hive_shard_session_state"}
#: the port's own: each card's allocator levels
PORT_KEYS = {"device_memory"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tmp_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("CHIASWARM_RESIDENCY_BUDGET", raising=False)
    return tmp_path


@pytest.fixture(autouse=True)
def _restore_matmul_precision():
    import jax

    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


SAMPLES = {
    "steady": [0.05] * 40,
    "spread": [0.01 * (1 + i % 7) for i in range(64)],
    "tail": [0.04] * 60 + [0.9, 2.0, 12.0],
    "few": [0.1, 0.2, 0.3],
    "overflow": [0.02] * 30 + [50.0] * 5,
}
STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0)


def _histogram(metrics, values):
    hist = metrics.Registry().histogram("step_seconds", "h",
                                        buckets=STEP_BUCKETS)
    for v in values:
        hist.observe(v)
    return hist


@pytest.mark.parametrize("name", list(SAMPLES))
def test_histogram_percentiles_match_jax(name):
    got = {}
    for pkg, metrics in (("jax", jmetrics), ("torch", tmetrics)):
        hist = _histogram(metrics, SAMPLES[name])
        got[pkg] = ([hist.percentile(q) for q in
                     (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)],
                    hist.percentiles(), hist.percentiles((0.25, 0.999)))
    assert got["torch"] == got["jax"]
    empty = tmetrics.Registry().histogram("e")
    assert empty.percentile(0.5) is None and empty.percentiles() is None


@pytest.mark.parametrize("env", [{}, {"CHIASWARM_GUARD_HANG_FACTOR": "8",
                                      "CHIASWARM_GUARD_HANG_CEIL_S": "90"}])
@pytest.mark.parametrize("name", list(SAMPLES))
def test_budget_suggestion_matches_jax(name, env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert tguard.SUGGEST_MIN_SAMPLES == jguard.SUGGEST_MIN_SAMPLES
    mine = tguard.suggest_hang_budget(_histogram(tmetrics, SAMPLES[name]))
    theirs = jguard.suggest_hang_budget(_histogram(jmetrics, SAMPLES[name]))
    assert mine == theirs
    assert mine["measured"] == (len(SAMPLES[name])
                                >= tguard.SUGGEST_MIN_SAMPLES)
    assert tguard.suggest_hang_budget(None)["measured"] in (True, False)


def test_trace_ring_cursor_and_exports_match_jax():
    def fill(mod):
        ring = mod.TraceRing(capacity=2)
        for i in range(3):
            trace = mod.JobTrace("job", id=f"t{i}", attempt=1)
            trace.phase("poll", http_s=0.1)
            with trace.active():
                with mod.span("encode", rows=1):
                    pass
            trace.phase("execute")
            trace.finish(ring)
        chrome = ring.to_chrome(since=1)
        shape = [(e["name"], e["ph"], e["tid"], e.get("args"))
                 for e in chrome["traceEvents"]]
        trees = [(t["seq"], t["root"]["name"],
                  [c["name"] for c in t["root"].get("children", [])])
                 for t in ring.to_dicts()]
        return (ring.cursor(), len(ring), shape, trees,
                chrome["displayTimeUnit"], ring.spans_evicted)

    assert fill(ttrace) == fill(jtrace)


class StubSlot:
    def __init__(self, name: str = "stub") -> None:
        self.depth = 2
        self.data_width = 1
        self.name = name

    def descriptor(self):
        return self.name


def _settings(mod, uri: str = "http://unused", name: str = "health",
              **over):
    base = dict(hive_uri=uri, hive_token="t", worker_name=name,
                poll_busy_s=0.02, poll_idle_s=0.05,
                install_signal_handlers=False, heartbeat_s=0.05,
                drain_timeout_s=5.0, result_drain_timeout_s=5.0)
    base.update(over)
    return mod.Settings(**base)


def _families(body: str) -> dict[str, tuple]:
    """family name -> (type, label names) from a Prometheus text body."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", body, re.M))
    labels: dict[str, set] = {name: set() for name in types}
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, rest = line.partition("{")
        base = re.sub(r"_(bucket|sum|count)$", "", name.split(" ")[0])
        family = name.split(" ")[0] if name.split(" ")[0] in types else base
        if rest:
            labels.setdefault(family, set()).update(
                k for k in re.findall(r'(\w+)="', rest) if k != "le")
    return {name: (types[name], tuple(sorted(labels.get(name, ()))))
            for name in types}


def _workers():
    jax_worker = JaxWorker(settings=_settings(jsettings), pool=[StubSlot()],
                           registry=object(), executor=ChaoticExecutor())
    torch_worker = tworker.Worker(settings=_settings(tsettings),
                                  pool=[StubSlot()], registry=object(),
                                  executor=ChaoticExecutor())
    return jax_worker, torch_worker


def test_health_keys_match_the_jax_worker():
    jax_worker, torch_worker = _workers()
    theirs, mine = jax_worker.health(), torch_worker.health()
    assert set(mine) - PORT_KEYS == set(theirs)
    assert NEXT_SLICE_KEYS <= set(mine)
    assert mine["hive_epoch"] is None is theirs["hive_epoch"]
    assert [set(s) for s in mine["hive_shards"]] == \
        [set(s) for s in theirs["hive_shards"]]
    assert [{k: v for k, v in s.items() if k != "session"}
            for s in mine["hive_shards"]] == \
        [{k: v for k, v in s.items() if k != "session"}
         for s in theirs["hive_shards"]]
    for key in ("stepper", "guard", "overload", "hive_session"):
        assert set(mine[key]) == set(theirs[key]), key
    # the suggestion reads each package's process-wide histogram, which
    # other tests of the same process fill (measured or not)
    for health in (mine, theirs):
        assert {"measured", "samples", "current"} <= set(
            health["guard"]["suggested_hang_budget"])
    assert mine["backend"] == "cpu" and mine["device_memory"] == {}
    for key in ("status", "slots", "jobs_done", "queue_depth",
                "checkpoint_depth", "inflight_jobs", "chips_in_service",
                "breakers"):
        assert mine[key] == theirs[key], key


def test_a_registry_health_reports_residency_and_models():
    registry = TorchRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    worker = tworker.Worker(settings=_settings(tsettings),
                            pool=ChipPool(device="cpu"), registry=registry,
                            hive=object())
    health = worker.health()
    assert health["devices"] == 1 and health["backend"] == "cpu"
    assert set(health["residency"]) >= {"budget_bytes", "resident_bytes"}
    assert health["models"] == registry.model_states()


def test_metric_families_match_the_jax_worker():
    jax_worker, torch_worker = _workers()
    theirs = _families(jax_worker.metrics.render())
    mine = _families(torch_worker.metrics.render())
    assert theirs == mine
    assert all(mine[name] == ("gauge", ("shard",))
               for name in NEXT_SLICE_FAMILIES)
    # the lanes' process-wide families this slice adds
    from chiaswarm_tpu.serving import stepper as jstepper  # noqa: F401

    for name in ("chiaswarm_stepper_step_seconds",
                 "chiaswarm_stepper_resume_step",
                 "chiaswarm_stepper_checkpoint_seconds"):
        j, t = jmetrics.REGISTRY.get(name), tmetrics.REGISTRY.get(name)
        assert (type(t).__name__, t.labelnames, t.buckets) == (
            type(j).__name__, j.labelnames, j.buckets), name
    assert tstepper._STEP_SECONDS is tmetrics.REGISTRY.get(
        "chiaswarm_stepper_step_seconds")


# ---------------------------------------------------------------------------
# the endpoints


PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*'
    r'\})? (-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')


def _parse_prometheus(body: str) -> int:
    samples = 0
    for line in body.splitlines():
        if not line or line.startswith("# HELP ") or \
                line.startswith("# TYPE "):
            continue
        assert PROM_LINE.match(line), line
        samples += 1
    return samples


async def _get(session, url: str):
    async with session.get(url) as response:
        text = await response.text()
        try:
            body = json.loads(text)
        except ValueError:
            body = text
        return response.status, body


def _scrape(pkg: str, tmp_path) -> dict:
    async def scenario():
        hive = MiniHive(lease_s=30.0, delay_s=0.0)
        uri = await hive.start()
        mod, cls = ((jsettings, JaxWorker) if pkg == "jax"
                    else (tsettings, tworker.Worker))
        worker = cls(settings=_settings(mod, uri, f"scrape-{pkg}",
                                        health_bind_ephemeral=True),
                     pool=[StubSlot()], registry=object(),
                     executor=ChaoticExecutor())
        hive.submit({"id": "scraped-1", "model_name": "m",
                     "content_type": "application/json"})
        task = asyncio.create_task(worker.run())
        out = {}
        try:
            await hive.wait_for_results(1, timeout=30)
            deadline = time.monotonic() + 10
            while len(worker.traces) < 1 and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            base = "http://%s:%d" % worker.health_address
            async with aiohttp.ClientSession() as session:
                for path in ("/healthz", "/metrics", "/debug/traces",
                             "/debug/traces?format=tree&since=0",
                             "/debug/traces?since=1",
                             "/debug/traces?since=soon",
                             "/debug/profile?seconds=soon",
                             "/debug/nothing"):
                    out[path] = await _get(session, base + path)
                if pkg == "torch":
                    url = (base + "/debug/profile?seconds=0.6&dir="
                           + str(tmp_path / "captures"))
                    first = asyncio.create_task(_get(session, url))
                    await asyncio.sleep(0.2)
                    out["busy"] = await _get(session, url)
                    out["profile"] = await first
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return out

    return asyncio.run(scenario())


def test_the_health_endpoints_answer_as_the_jax_worker_does(tmp_path):
    mine = _scrape("torch", tmp_path)
    theirs = _scrape("jax", tmp_path)
    status, health = mine["/healthz"]
    assert status == 200 and health["jobs_done"] == 1
    assert set(health) - PORT_KEYS == set(theirs["/healthz"][1])
    assert health["hive_shards"][0]["shard"] == 0
    assert set(health["hive_shards"][0]) == \
        set(theirs["/healthz"][1]["hive_shards"][0])
    status, body = mine["/metrics"]
    assert status == 200 and _parse_prometheus(body) > 50
    assert 'chiaswarm_jobs_total{outcome="ok"} 1' in body
    assert "chiaswarm_stepper_step_seconds" in body  # the process registry
    status, doc = mine["/debug/traces"]
    assert status == 200 and doc["cursor"]["last_seq"] == 1
    assert {e["name"] for e in doc["traceEvents"]} >= {"job", "poll",
                                                       "execute", "upload"}
    status, tree = mine["/debug/traces?format=tree&since=0"]
    assert [t["root"]["meta"]["id"] for t in tree["traces"]] == ["scraped-1"]
    assert mine["/debug/traces?since=1"][1]["traceEvents"] == []
    for path in ("/debug/traces?since=soon", "/debug/profile?seconds=soon",
                 "/debug/nothing"):
        assert mine[path][0] == theirs[path][0], path
        if mine[path][0] == 400:
            assert mine[path][1] == theirs[path][1], path
    assert mine["/debug/nothing"][0] == 404
    status, profile = mine["profile"]
    assert status == 200 and profile["status"] == "ok", profile
    assert profile["activities"] == ["CPU"]
    assert os.path.isfile(profile["trace"])
    assert mine["busy"][0] == 409 and mine["busy"][1]["status"] == "busy"


# ---------------------------------------------------------------------------
# the profiler


def test_a_capture_on_a_missing_card_fails_loudly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    got = profiling.capture(0.1, str(tmp_path), device="cuda")
    assert got["status"] == "error" and "CUDA" in got["error"]
    assert profiling.capture(0.1, None, device="cpu")["status"] == "error"


def test_one_lock_covers_captures_jobs_and_tools(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
    with profiling.job_profile("job-1", device="cpu") as recording:
        assert recording
        torch.ones(8) + 1
        assert profiling.capture(0.1, device="cpu")["status"] == "busy"
        with profiling.job_profile("job-2", device="cpu") as nested:
            assert not nested  # unprofiled, never crashed
        with pytest.raises(profiling.ProfilerBusy):
            with profiling.profile():
                pass
    assert os.path.isfile(tmp_path / "job-1" / "trace.json")
    assert not (tmp_path / "job-2").exists()
    with profiling.profile(activities=profiling.activities_for("cpu")):
        pass
    with profiling.annotate("swarm.lane.step"):  # free outside a capture
        pass
    monkeypatch.delenv(profiling.PROFILE_DIR_ENV)
    with profiling.job_profile("job-3") as recording:
        assert not recording


def test_annotated_regions_reach_the_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    with profiling.profile(
            activities=profiling.activities_for("cpu")) as prof:
        for name in ("swarm.lane.step", "swarm.lane.decode",
                     "swarm.generate"):
            with profiling.annotate(name):
                torch.ones(16, 16) @ torch.ones(16, 16)
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"swarm.lane.step", "swarm.lane.decode",
            "swarm.generate"} <= names
    assert profiling.trace_summary(path)["device_events"] == 0
