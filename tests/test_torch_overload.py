"""Overload control in the port (``chiaswarm_tpu_torch/node/overload.py``,
the worker's shed gate and backpressure, the lanes' brownout cap), on the
CPU, against the JAX package:

- the controller's decisions, states, snapshots and metric families equal to
  JAX's on the same injected clock sequences (the scenarios of
  ``tests/test_overload.py:93-229``);
- ``overloaded`` is a redispatch kind in both packages;
- the worker's shed gate gives JAX's verdicts on the same queue state, its
  deadlines resolve as JAX's do, and a shed job never reaches the executor;
- a flooded port worker under a lease-aware ``MiniHive`` sheds stale jobs as
  non-fatal envelopes counted apart from failures, every job settling once;
  with ``overload_control`` off it admits everything, as the reference does;
- the brownout cap reaches the lanes, which admit at most that many rows at
  a step boundary.
"""

from __future__ import annotations

import asyncio
import time

import pytest
import torch

from chiaswarm_tpu.node import overload as joverload
from chiaswarm_tpu.node import resilience as jres
from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor
from chiaswarm_tpu.node.executor import error_result as jax_error_result
from chiaswarm_tpu.node.loadgen import SyntheticExecutor
from chiaswarm_tpu.node.minihive import MiniHive
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.obs import metrics as jmetrics
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor as texecutor
from chiaswarm_tpu_torch.node import overload as toverload
from chiaswarm_tpu_torch.node import resilience as tres
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry as TorchRegistry
from chiaswarm_tpu_torch.obs import metrics as tmetrics
from chiaswarm_tpu_torch.serving.stepper import get_stepper


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tmp_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    return tmp_path


@pytest.fixture(autouse=True)
def _restore_matmul_precision():
    import jax

    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


PACKAGES = {"jax": (joverload, jmetrics), "torch": (toverload, tmetrics)}


# ---------------------------------------------------------------------------
# 1. the controller on scripted clocks


def _decision(d) -> tuple:
    return (d.shed, round(d.predicted_s, 9), round(d.remaining_s, 9),
            d.reason)


def scenario_cold(ctl, clock):
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=0.5,
                                    deadline_s=1.0, queued_ahead=50,
                                    slots=1))
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=100.0,
                                    deadline_s=1.0, queued_ahead=0, slots=1))


def scenario_predicted(ctl, clock):
    ctl.note_service("txt2img", 2.0)
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=0.0,
                                    deadline_s=30.0, queued_ahead=0,
                                    slots=1))
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=0.0,
                                    deadline_s=10.0, queued_ahead=5,
                                    slots=1))
    ctl.note_service("img2img", 0.1)
    ctl.note_service("img2img", 0.3)
    yield [ctl.service_estimate(w) for w in ("img2img", "txt2img", None,
                                             "", "inpaint")]


def scenario_expired(ctl, clock):
    ctl.note_service("txt2img", 0.01)
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=5.0,
                                    deadline_s=2.0, queued_ahead=0, slots=1))


def scenario_lane_floor(ctl, clock):
    ctl.note_service("txt2img", 0.05)
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=0.0,
                                    deadline_s=3.0, queued_ahead=0, slots=1,
                                    lane_estimate_s=6.0))
    yield _decision(ctl.should_shed(workflow="txt2img", waited_s=0.0,
                                    deadline_s=30.0, queued_ahead=2, slots=2,
                                    lane_estimate_s=6.0))


def scenario_brownout(ctl, clock):
    ctl.note_service("txt2img", 1.0)
    yield ctl.admission_cap()
    for t in (0.0, 0.0, 0.0, 4.0):
        clock[0] = t
        yield _decision(ctl.should_shed(workflow="txt2img", waited_s=9.0,
                                        deadline_s=1.0, queued_ahead=0,
                                        slots=1))
        yield ctl.state
    for t in (8.0, 9.5, 9.6, 9.7, 9.8, 11.5):
        clock[0] = t
        yield (ctl.admission_cap(), ctl.state)


def scenario_margin(ctl, clock):
    ctl.note_service("txt2img", 1.0)
    borderline = dict(workflow="txt2img", waited_s=0.0, deadline_s=1.5,
                      queued_ahead=0, slots=1)
    yield _decision(ctl.should_shed(**borderline))
    for _ in range(2):
        yield _decision(ctl.should_shed(workflow="txt2img", waited_s=9.0,
                                        deadline_s=1.0, queued_ahead=0,
                                        slots=1))
    yield ctl.state
    yield _decision(ctl.should_shed(**borderline))


def scenario_throttle(ctl, clock):
    yield ctl.poll_throttle(queue_depth=100, slots=1)
    ctl.note_service("txt2img", 0.5)
    yield ctl.poll_throttle(queue_depth=1, slots=1)
    yield ctl.poll_throttle(queue_depth=10, slots=1)
    yield ctl.poll_throttle(queue_depth=10, slots=8)
    yield ctl.backpressure_waits
    yield ctl.fleet_view()


SCENARIOS = {
    "cold": (scenario_cold, {}),
    "predicted": (scenario_predicted, {}),
    "expired": (scenario_expired, {}),
    "lane_floor": (scenario_lane_floor, {}),
    "brownout": (scenario_brownout, dict(brownout_sheds=3, window_s=10.0,
                                         cooldown_s=5.0,
                                         admission_cap_rows=2)),
    "margin": (scenario_margin, dict(brownout_sheds=2, window_s=10.0,
                                     cooldown_s=60.0,
                                     brownout_margin_scale=0.5)),
    "throttle": (scenario_throttle, dict(backpressure_s=1.0)),
}


def _run_scenario(pkg: str, name: str) -> tuple:
    mod, metrics = PACKAGES[pkg]
    script, over = SCENARIOS[name]
    clock = [0.0]
    registry = metrics.Registry()
    ctl = mod.OverloadController(clock=lambda: clock[0],
                                 metrics_registry=registry, **over)
    trail = list(script(ctl, clock))
    return trail, ctl.snapshot(), registry.render()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_decisions_match_jax(name):
    assert _run_scenario("torch", name) == _run_scenario("jax", name)


def test_overloaded_is_a_redispatch_kind_in_both_packages():
    for mod in (jres, tres):
        assert "overloaded" in mod.REDISPATCH_KINDS
        assert "overloaded" in mod.NONFATAL_KINDS
        assert "overloaded" not in mod.BREAKER_KINDS
    assert toverload.SEED_WORKLOADS == joverload.SEED_WORKLOADS
    assert tmetrics.OVERLOAD_STATES == jmetrics.OVERLOAD_STATES
    shed = texecutor.error_result({"id": "j", "content_type":
                                   "application/json"}, "shed",
                                  kind="overloaded")
    assert shed == jax_error_result({"id": "j", "content_type":
                                     "application/json"}, "shed",
                                    kind="overloaded")
    assert tres.classify_result(shed) == "overloaded"
    assert not shed.get("fatal_error")


# ---------------------------------------------------------------------------
# 2. the worker's gate


class StubSlot:
    def __init__(self, name: str = "stub", depth: int = 6) -> None:
        self.depth = depth
        self.data_width = 1
        self.name = name

    def descriptor(self):
        return self.name


def _worker(pkg: str, uri: str = "http://unused", name: str = "ovl",
            executor=None, pool=None, registry=None, **over):
    mod, worker_cls = ((jsettings, JaxWorker) if pkg == "jax"
                       else (tsettings, tworker.Worker))
    base = dict(hive_uri=uri, hive_token="t", worker_name=name,
                poll_busy_s=0.02, poll_idle_s=0.05,
                poll_backoff_base_s=0.02, poll_backoff_cap_s=0.2,
                upload_retries=5, upload_retry_delay_s=0.02,
                transient_retries=1, retry_backoff_s=0.01,
                retry_backoff_cap_s=0.05,
                drain_timeout_s=10.0, result_drain_timeout_s=10.0,
                install_signal_handlers=False, heartbeat_s=0.1,
                overload_control=True, job_deadline_s=30.0,
                backpressure_s=0.5, overload_margin=0.8)
    base.update(over)
    return worker_cls(settings=mod.Settings(**base),
                      pool=pool if pool is not None else [StubSlot(name)],
                      registry=registry if registry is not None else object(),
                      executor=executor)


GATE_JOBS = [
    {"id": "fresh", "workflow": "txt2img", "num_inference_steps": 20},
    {"id": "stale", "workflow": "txt2img", "queued_s": 50.0},
    {"id": "tight", "workflow": "img2img", "deadline_s": 1.0},
    {"id": "roomy", "workflow": "img2img", "deadline_s": 100.0},
    {"id": "family", "model_name": "sd15", "workflow": "txt2img"},
    {"id": "late", "workflow": "txt2img", "num_inference_steps": 40},
]


def _gate(pkg: str) -> tuple:
    worker = _worker(pkg, family_deadline_s={"sd15": 4.0})
    worker.overload.note_service("txt2img", 2.0)
    worker.overload.note_service("img2img", 0.5)
    now = time.monotonic()
    burst = [dict(j, content_type="application/json") for j in GATE_JOBS]
    for job in burst:
        worker._inflight[job["id"]] = now
    results: list = [None] * len(burst)
    admitted = worker._shed_gate(burst, results, list(range(len(burst))))
    kinds = [None if r is None else jres.classify_result(r)
             for r in results]
    deadlines = [worker._job_deadline_s(j) for j in burst]
    return (admitted, kinds, deadlines, worker.stats.jobs_shed,
            worker.overload.snapshot()["state"],
            worker.overload.sheds_total)


def test_the_shed_gate_matches_the_jax_worker():
    got = _gate("torch")
    assert got == _gate("jax")
    admitted, kinds, deadlines, shed, _, _ = got
    assert kinds.count("overloaded") == shed > 0 and admitted
    assert deadlines[2:5] == [1.0, 100.0, 4.0]


def test_a_shed_job_never_reaches_the_executor():
    async def scenario():
        hive = MiniHive(lease_s=30.0, delay_s=0.0)
        uri = await hive.start()
        executor = ChaoticExecutor()
        worker = _worker("torch", uri, "never-runs", executor=executor)
        # the estimator has seen 2 s jobs: a 1 s deadline cannot be met
        worker.overload.note_service("txt2img", 2.0)
        hive.submit({"id": "doomed", "model_name": "m", "deadline_s": 1.0,
                     "content_type": "application/json"})
        task = asyncio.create_task(worker.run())
        try:
            deadline = time.monotonic() + 30
            while not hive.excluded.get("doomed") and \
                    time.monotonic() < deadline:
                await asyncio.sleep(0.02)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return hive, worker, executor

    hive, worker, executor = asyncio.run(scenario())
    assert executor.events == []  # no executor call: no kernel, no time
    assert hive.excluded["doomed"] == {"never-runs"}
    assert worker.stats.jobs_shed == 1 and worker.stats.jobs_failed == 0
    redispatched = hive.metrics.get("chiaswarm_hive_jobs_redispatched_total")
    assert redispatched.value(kind="overloaded") == 1


def _flood(n: int, deadline_s: float) -> list[dict]:
    return [{"id": f"flood-{i}", "model_name": "m", "workflow": "txt2img",
             "prompt": f"p{i}", "deadline_s": deadline_s,
             "content_type": "application/json"} for i in range(n)]


def _serve_flood(jobs: list[dict], **over):
    async def scenario():
        hive = MiniHive(lease_s=5.0, delay_s=0.0, max_attempts=2,
                        max_jobs_per_poll=4)
        uri = await hive.start()
        for job in jobs:
            hive.submit(job)
        worker = _worker("torch", uri, "flood-w0",
                         executor=SyntheticExecutor(seed="flood-w0"), **over)
        task = asyncio.create_task(worker.run())
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                hive.sweep()
                if len(hive.completed) >= len(jobs):
                    break
                await asyncio.sleep(0.05)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=30)
            await hive.stop()
        return hive, worker

    return asyncio.run(scenario())


def test_a_flooded_worker_sheds_stale_jobs_apart_from_failures():
    hive, worker = _serve_flood(_flood(24, deadline_s=0.4))
    uploaded = hive.uploaded_ids()
    assert len(uploaded) == len(set(uploaded))
    assert sorted(hive.completed) == sorted(f"flood-{i}" for i in range(24))
    kinds = {jres.classify_result(r) for r in hive.completed.values()}
    assert "overloaded" in kinds
    assert worker.stats.jobs_shed > 0
    assert worker.stats.jobs_failed == 0
    redispatched = hive.metrics.get("chiaswarm_hive_jobs_redispatched_total")
    assert redispatched.value(kind="overloaded") >= 1
    health = worker.health()
    assert health["overload"]["enabled"] is True
    assert health["overload"]["sheds_total"] == worker.stats.jobs_shed
    assert health["jobs_shed"] == worker.stats.jobs_shed
    body = worker.metrics.render()
    assert (f'chiaswarm_overload_shed_total{{workload="txt2img"}} '
            f'{worker.stats.jobs_shed}') in body


def test_overload_control_off_admits_everything():
    hive, worker = _serve_flood(_flood(10, deadline_s=0.2),
                                overload_control=False)
    assert worker.stats.jobs_shed == 0
    assert worker.stats.polls_backpressured == 0
    assert all(jres.classify_result(r) == "ok"
               for r in hive.completed.values())
    assert worker.health()["overload"]["enabled"] is False


# ---------------------------------------------------------------------------
# 3. brownout in the lanes


def test_the_brownout_cap_reaches_the_lanes(monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    monkeypatch.setenv("CHIASWARM_STEPPER_LANE_WIDTH", "2")
    registry = TorchRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    pool = ChipPool(device="cpu")
    slot = pool.slots[0]
    worker = _worker("torch", pool=pool, registry=registry,
                     overload_brownout_sheds=1, overload_admission_cap=1,
                     overload_cooldown_s=600.0)
    stepper = get_stepper(slot)
    worker._push_admission_caps()
    assert stepper.admission_cap() is None
    worker.overload.note_service("txt2img", 1.0)
    shed = worker.overload.should_shed(workflow="txt2img", waited_s=9.0,
                                       deadline_s=1.0, queued_ahead=0,
                                       slots=1)
    assert shed.shed and worker.overload.state == "brownout"
    worker._push_admission_caps()
    assert stepper.admission_cap() == 1
    jobs = [{"id": f"cap-{i}", "model_name": "tiny", "prompt": f"p {i}",
             "seed": i, "num_inference_steps": 2, "guidance_scale": 7.5,
             "height": 64, "width": 64, "content_type": "image/png"}
            for i in range(2)]
    try:
        results = texecutor.synchronous_do_work_batch(jobs, slot, registry)
    finally:
        stepper.shutdown()
    stamps = [r["pipeline_config"]["stepper"] for r in results]
    # two one-row jobs, a cap of one row a boundary: one lane, the second
    # job spliced in one step after the first
    assert len({s["lane"] for s in stamps}) == 1
    assert sorted(s["admitted_at_step"] for s in stamps) == [0, 1]
    stepper.set_admission_cap(0)
    assert stepper.admission_cap() is None
