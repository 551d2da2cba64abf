"""The worker half of the flight record in the port
(``chiaswarm_tpu_torch/obs/flight.py``, the trace join and the digest in
``node/worker.py``), on the CPU, against the JAX package's
``obs/flight.py`` and its ``MiniHive``:

- ``span_digest`` equal to JAX's on the same trace tree, and on twin trees
  built in each package with their times masked (the span cap and
  ``spans_truncated`` too);
- a job with no trace context: the trace starts locally, stamps ``attempt``
  and ``queued_s``, and the upload carries no digest (port of
  ``tests/test_flight.py:507``);
- a tiny job served by the port through a ``MiniHive`` that stamps trace
  context: the worker's trace joins it, the upload carries the digest, and
  the hive's flight record settles with it; its budget attribution has the
  same non-zero phases as the same job served by the JAX worker, whose
  digest phase and span names the port's match.
"""

from __future__ import annotations

import asyncio
import time

import pytest
import torch

from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor, ChaoticHive
from chiaswarm_tpu.node.minihive import MiniHive
from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.obs import flight as jflight
from chiaswarm_tpu.obs import trace as jtrace
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry as TorchRegistry
from chiaswarm_tpu_torch.obs import flight as tflight
from chiaswarm_tpu_torch.obs import trace as ttrace
from chiaswarm_tpu_torch.serving.stepper import get_stepper

TINY_CATALOG = [{"name": "tiny", "family": "tiny", "parameters": {}}]
TINY_JOB = {"id": "flight-1", "model_name": "tiny",
            "prompt": "a lighthouse on a cliff", "num_inference_steps": 2,
            "height": 64, "width": 64, "seed": 5, "content_type": "image/png"}
#: the digest's time fields, masked when two traces are built apart
TIMES = ("t0_s", "dur_s", "duration_s", "started_at_unix")


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


class StubSlot:
    depth, data_width, name = 2, 1, "stub"

    def descriptor(self):
        return self.name


def _masked(value):
    if isinstance(value, dict):
        return {k: ("<t>" if k in TIMES else _masked(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_masked(v) for v in value]
    return value


def _tree(trace_mod, spans: int = 3):
    """One job's trace: the poll, execute and upload phases, spans nested
    under execute (``splice_wait_s`` on the steps, a tensor-free meta)."""
    trace = trace_mod.JobTrace("job", id="d-1", model="tiny", workflow="",
                               worker="w", attempt=2, queued_s=0.25,
                               resume_step=4, trace_id="abc",
                               span_id="abc.2")
    trace.phase("poll", http_s=0.001)
    trace.phase("execute")
    with trace_mod.activate(trace):
        with trace_mod.span("format"):
            pass
        with trace_mod.span("encode", rows=1, steps=2):
            pass
        for i in range(spans):
            with trace_mod.span("step", steps=2, rows=1,
                                splice_wait_s=0.002, label="x" * 300,
                                obj=object()):
                with trace_mod.span("lane.wait", i=i):
                    pass
        with trace_mod.span("decode", batch=1):
            pass
    trace.phase("upload")
    trace.root.end()  # the clock stops: both digests read one tree
    return trace


@pytest.mark.parametrize("spans", [3, 80])
def test_span_digest_matches_jax(spans):
    trace = _tree(ttrace, spans)
    mine = tflight.span_digest(trace, worker_name="w1")
    assert mine == jflight.span_digest(trace, worker_name="w1")
    twin = jflight.span_digest(_tree(jtrace, spans), worker_name="w1")
    assert _masked(mine) == _masked(twin)
    assert len(mine["spans"]) == min(tflight.MAX_DIGEST_SPANS,
                                     2 + 2 * spans + 1)
    assert mine.get("spans_truncated", False) is (spans == 80)
    assert mine["attempt"] == 2 and mine["resume_step"] == 4.0
    step = next(s for s in mine["spans"] if s["name"] == "step")
    assert step["meta"] == {"steps": 2, "rows": 1, "splice_wait_s": 0.002}
    # the hive's phase split reads the port's span names
    split = jflight._digest_phase_split(mine)
    assert split["admission"] > 0 and split["decode"] >= 0


def test_no_context_no_digest_and_a_local_trace():
    async def scenario():
        hive = ChaoticHive()
        uri = await hive.start()
        hive.submit({"id": "p1", "model_name": "shared/tiny",
                     "content_type": "application/json"})
        worker = tworker.Worker(
            settings=tsettings.Settings(
                hive_uri=uri, hive_token="t", worker_name="flight-w",
                poll_busy_s=0.02, poll_idle_s=0.05,
                install_signal_handlers=False),
            pool=[StubSlot()], registry=object(), executor=ChaoticExecutor())
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(1, timeout=30)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=20)
            await hive.stop()
        return hive, worker

    hive, worker = asyncio.run(scenario())
    [result] = hive.results
    assert set(result) == {"id", "artifacts", "nsfw", "worker_version",
                           "pipeline_config", "worker_name"}
    [trace] = worker.traces.traces()
    assert trace.meta["attempt"] == 1 and trace.meta["queued_s"] == 0.0
    assert "trace_id" not in trace.meta


def _serve(pkg: str) -> tuple:
    """The tiny job through a worker of ``pkg`` (lanes on) and a
    ``MiniHive`` that stamps trace context; returns the flight record and
    the worker's trace."""
    if pkg == "jax":
        mod, cls = jsettings, JaxWorker
        pool = JaxPool(n_slots=1)
        registry = JaxRegistry(catalog=TINY_CATALOG, allow_random=True)
    else:
        mod, cls = tsettings, tworker.Worker
        pool = ChipPool(device="cpu")
        registry = TorchRegistry(catalog=TINY_CATALOG, allow_random=True,
                                 device="cpu")

    async def scenario():
        hive = MiniHive(lease_s=60.0, delay_s=0.01)
        uri = await hive.start()
        worker = cls(settings=mod.Settings(
            hive_uri=uri, hive_token="t", worker_name=f"flight-{pkg}",
            poll_busy_s=0.05, poll_idle_s=0.05,
            install_signal_handlers=False), pool=pool, registry=registry)
        hive.submit(dict(TINY_JOB))
        task = asyncio.create_task(worker.run())
        try:
            await hive.wait_for_results(1, timeout=300)
            deadline = time.monotonic() + 10
            while not worker.traces.traces() and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
        finally:
            worker.request_stop()
            await asyncio.wait_for(task, timeout=60)
            await hive.stop()
        return hive, worker

    hive, worker = asyncio.run(scenario())
    if pkg == "torch":
        get_stepper(pool.slots[0]).shutdown()
    result = hive.completed[TINY_JOB["id"]]
    assert tflight.SPAN_DIGEST_KEY not in result  # the hive pops it
    assert "error" not in result["pipeline_config"], result
    [trace] = worker.traces.traces()
    return hive.flights.get(TINY_JOB["id"]), trace, hive


def test_a_served_job_settles_a_flight_record_as_the_jax_worker_does(
        monkeypatch):
    monkeypatch.setenv("CHIASWARM_STEPPER", "1")
    mine, trace, hive = _serve("torch")
    theirs, _, _ = _serve("jax")
    [attempt] = mine["attempts"]
    digest = attempt["digest"]
    assert digest["worker"] == "flight-torch" and digest["attempt"] == 1
    assert [p["name"] for p in digest["phases"]] == \
        ["poll", "execute", "upload"]
    assert digest["trace_id"] == mine["trace_id"]
    assert digest["span_id"] == f"{mine['trace_id']}.1"
    assert trace.meta["trace_id"] == mine["trace_id"]
    assert mine["settled"]["outcome"] == "ok"
    assert hive.flights.verify([TINY_JOB["id"]]) == []
    attribution, want = mine["attribution"], theirs["attribution"]
    assert attribution["measured"] is True is want["measured"]
    assert set(attribution["phases"]) == set(want["phases"])
    worker_side = ("admission", "steps", "decode")
    assert {p for p in worker_side if attribution["phases"][p] > 0} == \
        {p for p in worker_side if want["phases"][p] > 0} == set(worker_side)
    [j_attempt] = theirs["attempts"]
    j_digest = j_attempt["digest"]
    # the port's spans carry JAX's names (what the hive's split reads),
    # and the port's artifacts span beside them
    names = [s["name"] for s in digest["spans"]]
    assert [n for n in names if n != "artifacts"] == \
        [s["name"] for s in j_digest["spans"]]
