"""The residency ledger in the port, against the JAX package (CPU).

- ``serving/residency.py``: one scripted sequence (hits, donation swaps,
  priority over LRU, the load-per-job rung and its release, the bounce, a
  budget squeeze, idle prefetch, quarantine, persistence and a restart)
  through JAX's ``ResidencyManager`` and the port's, on one fake clock:
  the same loads, evictions, states, peak, snapshots and footprint file.
- The registry over two ``tiny`` checkpoints in ``<settings root>/models``
  with a one-model budget: loading B evicts A and retires A's lane at
  drain, A's reload renders A's image again bit for bit, a degraded model
  runs solo (``lane_resident_ok``) with the solo path's image, a hard limit
  below the footprint gives a non-fatal ``model_unavailable`` envelope, an
  idle tick prefetches an evicted model back.
- The worker: ``residency_budget_bytes``/``residency_prefetch`` reach the
  ledger, measured footprints feed the mesh policy first, and an empty
  poll calls ``note_idle``.
"""

from __future__ import annotations

import asyncio
import base64
import gc
import json
import time

import pytest
import torch

from chiaswarm_tpu.obs.metrics import Registry as JaxMetrics
from chiaswarm_tpu.serving.residency import ModelUnavailable as JaxUnavailable
from chiaswarm_tpu.serving.residency import ResidencyManager as JaxManager
from chiaswarm_tpu_torch.convert.safetensors_io import save_file
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.node.registry import ModelRegistry, model_dir
from chiaswarm_tpu_torch.obs.metrics import Registry as PortMetrics
from chiaswarm_tpu_torch.pipelines.components import Components
from chiaswarm_tpu_torch.serving.residency import (
    ModelUnavailable,
    ResidencyManager,
    is_transient,
)
from chiaswarm_tpu_torch.serving.stepper import get_stepper


@pytest.fixture(autouse=True)
def _root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("CHIASWARM_WEIGHTS", raising=False)
    return tmp_path


# ---- the ledger, scripted through both packages ------------------------------


class Clock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


class FakeModel:
    def __init__(self, nbytes: int) -> None:
        self.nbytes = nbytes


def _script(cls, unavailable, metrics, persist, clock) -> list:
    """Run the scripted sequence on a ``cls`` manager; returns what each
    step observed (loads, states, snapshots)."""
    m = cls(budget_bytes=1000, hard_limit_bytes=2500, clock=clock,
            persist_path=persist, prefetch=True, reserve_wait_s=0.05,
            metrics_registry=metrics)
    loads: list[str] = []
    out: list = []

    def get(key, model, nbytes, priority=0, estimate=None):
        def load():
            loads.append(model)
            return FakeModel(nbytes)

        clock.now += 1.0
        return m.acquire(key, load, model=model,
                         size_of=lambda v: v.nbytes, priority=priority,
                         estimate=None if estimate is None
                         else (lambda: estimate))

    def note(label, value=None):
        out.append((label, value, list(loads), m.snapshot(),
                    m.model_states(), m.measured_footprints(),
                    m.resident_bytes, m.reserved_bytes))

    note("a", type(get("ka", "a", 400, estimate=300)).__name__)
    note("a-hit", get("ka", "a", 400).nbytes)
    note("b", get("kb", "b", 400, priority=5).nbytes)
    note("c-evicts-a", get("kc", "c", 500).nbytes)      # a is LRU, prio 0
    note("d-evicts-c-not-b", get("kd", "d", 500).nbytes)  # b has priority 5
    big = get("kbig", "big", 1500)                       # over budget
    note("degraded", is_transient_of(big))
    note("would-degrade", (m.would_degrade("big"), m.would_degrade("a")))
    del big
    gc.collect()
    note("released")
    try:
        get("khuge", "huge", 3000, estimate=3000)
        note("huge", "loaded")
    except unavailable as exc:
        note("huge", str(exc))
    m.set_budget(600)
    note("squeezed")
    m.set_budget(1000)
    m.note_quarantined("a")
    started = m.note_idle()                              # c is the hottest
    if m._prefetch_thread is not None:
        m._prefetch_thread.join(timeout=10)
    note("prefetch", started)
    m.note_unquarantined("a")
    m.note_placement(["a"])
    clock.now += 1.0
    m.set_budget(1000, 2500)
    started = m.note_idle()
    if m._prefetch_thread is not None:
        m._prefetch_thread.join(timeout=10)
    note("prefetch-placed", started)
    m.reset_peak()
    note("reset-peak")
    restarted = cls(budget_bytes=1000, clock=clock, persist_path=persist,
                    metrics_registry=metrics)
    note("restart", restarted.measured_footprints())
    return out


def is_transient_of(value) -> bool:
    from chiaswarm_tpu.serving.residency import is_transient as jax_transient

    assert is_transient(value) == jax_transient(value)
    return is_transient(value)


def test_scripted_sequence_matches_jax(tmp_path):
    ours = _script(ResidencyManager, ModelUnavailable, PortMetrics(),
                   tmp_path / "port.json", Clock())
    ref = _script(JaxManager, JaxUnavailable, JaxMetrics(),
                  tmp_path / "jax.json", Clock())
    assert [step[0] for step in ours] == [step[0] for step in ref]
    for got, want in zip(ours, ref):
        assert got == want, got[0]
    labels = {step[0]: step for step in ours}
    assert labels["c-evicts-a"][4]["a"] == "evicted"
    assert labels["degraded"][1] is True
    assert labels["released"][7] == 0          # transient reservation freed
    assert "is not available on this node" in labels["huge"][1]
    assert labels["prefetch-placed"][1] is True
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def test_metric_families_render_zeroes_from_the_first_scrape():
    from chiaswarm_tpu_torch.obs import metrics

    # importing serving/residency.py (above) registered the families
    text = metrics.REGISTRY.render()
    for state in metrics.RESIDENCY_STATES:
        assert f'chiaswarm_residency_models{{state="{state}"}}' in text
    for mode in metrics.RESIDENCY_LOAD_MODES:
        assert f'chiaswarm_residency_loads_total{{mode="{mode}"}}' in text
    for name in ("resident_bytes", "budget_bytes", "peak_bytes",
                 "bounces_total", "load_seconds"):
        assert f"chiaswarm_residency_{name}" in text


def test_stepper_keeps_one_arrival_ewma():
    from chiaswarm_tpu_torch.serving import residency, stepper

    assert stepper.ArrivalEwma is residency.ArrivalEwma


# ---- the registry over two tiny checkpoints ----------------------------------


def _write_snapshot(name: str, seed: int) -> Components:
    """``Components.random("tiny", seed)`` written to ``model_dir(name)``
    as float32 safetensors, with a CLIP vocab."""
    from tests.test_torch_checkpoint import write_vocab

    src = Components.random("tiny", seed=seed, device="cpu")
    root = model_dir(name)
    modules = {"unet": src.unet, "vae": src.vae,
               "text_encoder": src.text_encoders[0]}
    for sub, module in modules.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.float() for k, v in module.state_dict().items()},
                  root / sub / "model.safetensors")
    write_vocab(root / "tokenizer")
    return src


def _job(model: str, seed: int = 3, **over) -> dict:
    job = {"id": f"{model}-{seed}", "model_name": model,
           "prompt": "a lighthouse on a cliff at golden hour",
           "num_inference_steps": 3, "height": 64, "width": 64,
           "seed": seed, "content_type": "image/png"}
    job.update(over)
    return job


def _image(result) -> bytes:
    cfg = result["pipeline_config"]
    assert "error" not in cfg, cfg
    return base64.b64decode(result["artifacts"]["primary"]["blob"])


def _wait(predicate, timeout: float = 10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


@pytest.fixture
def two_models(_root):
    footprint = _write_snapshot("tiny/a", 0).param_bytes()
    _write_snapshot("tiny/b", 1)
    catalog = [{"name": "tiny/a", "family": "tiny"},
               {"name": "tiny/b", "family": "tiny"}]
    ledger = ResidencyManager(budget_bytes=int(1.5 * footprint),
                              hard_limit_bytes=4 * footprint,
                              persist_path=_root / "residency.json",
                              prefetch=False, metrics_registry=PortMetrics())
    registry = ModelRegistry(catalog=catalog, device="cpu", residency=ledger)
    slot = ChipPool(device="cpu").slots[0]
    yield registry, slot, footprint
    get_stepper(slot).shutdown()


def test_eviction_retires_the_lane_and_the_reload_renders_the_same(
        two_models, monkeypatch):
    monkeypatch.delenv("CHIASWARM_STEPPER", raising=False)
    registry, slot, footprint = two_models
    sched = get_stepper(slot)
    first = executor.synchronous_do_work(_job("tiny/a"), slot, registry)
    assert "stepper" in first["pipeline_config"]
    pipe_a = registry.pipeline("tiny/a")
    owner_a = id(pipe_a.c)
    del pipe_a
    assert [id(k[0].c) for k in sched._lanes] == [owner_a]

    other = executor.synchronous_do_work(_job("tiny/b"), slot, registry)
    assert "stepper" in other["pipeline_config"]
    assert registry.model_states() == {"tiny/a": "evicted",
                                       "tiny/b": "resident"}
    # A's lane retired at drain: only B's lane is left
    assert _wait(lambda: [id(k[0].c) for k in list(sched._lanes)]
                 != [owner_a] and len(sched._lanes) == 1)
    assert owner_a not in {id(k[0].c) for k in list(sched._lanes)}
    snap = registry.residency.snapshot()
    assert snap["evictions"] == 1 and snap["resident_models"] == ["tiny/b"]
    assert snap["peak_bytes"] <= snap["budget_bytes"] + footprint
    assert registry.residency.measured_footprints() == {
        "tiny/a": footprint, "tiny/b": footprint}

    again = executor.synchronous_do_work(_job("tiny/a"), slot, registry)
    assert _image(again) == _image(first)
    assert _image(other) != _image(first)
    assert registry.residency.snapshot()["evictions"] == 2


def test_degraded_model_runs_solo_with_the_solo_image(two_models,
                                                      monkeypatch):
    registry, slot, footprint = two_models
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")
    solo = executor.synchronous_do_work(_job("tiny/a"), slot, registry)
    assert "stepper" not in solo["pipeline_config"]

    monkeypatch.delenv("CHIASWARM_STEPPER")
    registry.residency.set_budget(footprint // 2, 4 * footprint)
    assert not registry.lane_resident_ok("tiny/a")
    assert registry.lane_resident_ok("tiny/never-loaded")
    degraded = executor.synchronous_do_work(_job("tiny/a"), slot, registry)
    cfg = degraded["pipeline_config"]
    assert "stepper" not in cfg and cfg["residency"] == "per_job"
    assert _image(degraded) == _image(solo)
    assert not get_stepper(slot)._lanes
    assert registry.model_states()["tiny/a"] == "degraded"
    gc.collect()
    assert registry.residency.reserved_bytes == 0
    pipe = registry.pipeline("tiny/a")
    assert is_transient(pipe)


def test_hard_limit_below_the_footprint_is_model_unavailable(two_models):
    registry, slot, footprint = two_models
    executor.synchronous_do_work(_job("tiny/a"), slot, registry)  # measured
    registry.residency.set_budget(footprint // 4, footprint // 2)
    result = executor.synchronous_do_work(_job("tiny/a", seed=4), slot,
                                          registry)
    cfg = result["pipeline_config"]
    assert cfg["error_kind"] == "model_unavailable"
    assert "fatal_error" not in result
    assert registry.model_states()["tiny/a"] == "unavailable"
    assert registry.residency.snapshot()["bounces"] >= 1


def test_idle_prefetch_reloads_the_evicted_checkpoint(two_models):
    """A squeeze evicts A; once the budget has room again an idle tick
    loads A back on the prefetch thread, complete when admitted."""
    registry, _, footprint = two_models
    ledger = registry.residency
    ledger.prefetch_enabled = True
    first = registry.pipeline("tiny/a")
    registry.pipeline("tiny/a")  # a second arrival: a nonzero demand rate
    want = {k: v.clone() for k, v in first.c.unet.state_dict().items()}
    del first
    ledger.set_budget(footprint // 2, 4 * footprint)  # squeeze: A evicted
    assert registry.model_states()["tiny/a"] == "evicted"
    ledger.set_budget(int(1.5 * footprint), 4 * footprint)
    assert ledger.note_idle()
    ledger._prefetch_thread.join(timeout=30)
    assert not ledger._prefetch_thread.is_alive()
    snap = ledger.snapshot()
    assert snap["prefetch_loads"] == 1 and snap["resident_models"] == [
        "tiny/a"]
    misses = snap["misses"]
    again = registry.pipeline("tiny/a")  # a hit: the prefetched pipeline
    assert ledger.snapshot()["misses"] == misses
    for key, value in again.c.unet.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_a_checkpoint_directory_is_never_replaced_by_random_weights(
        _root):
    """``allow_random`` only fills in for a model with no directory."""
    model_dir("tiny").mkdir(parents=True)  # exists, holds no weights
    registry = ModelRegistry(catalog=[{"name": "tiny", "family": "tiny"}],
                             allow_random=True, device="cpu")
    with pytest.raises(Exception, match="no weight files"):
        registry.pipeline("tiny")
    assert registry.model_states()["tiny"] == "unavailable"


def test_quarantine_reaches_the_ledger_states(two_models):
    registry, _, _ = two_models
    registry.quarantine("tiny/b", "broken")
    assert registry.model_states() == {"tiny/a": "cold",
                                       "tiny/b": "quarantined"}
    with pytest.raises(ValueError, match="quarantined"):
        registry.pipeline("tiny/b")
    registry.unquarantine("tiny/b")
    assert registry.model_states()["tiny/b"] == "cold"


# ---- the worker --------------------------------------------------------------


def _worker(registry, **over) -> tworker.Worker:
    return tworker.Worker(settings=tsettings.Settings(**over),
                          pool=ChipPool(device="cpu"), registry=registry,
                          hive=object())


def test_worker_applies_the_residency_settings():
    registry = ModelRegistry(device="cpu", residency=ResidencyManager(
        budget_bytes=10_000, persist_path=None,
        metrics_registry=PortMetrics()))
    _worker(registry, residency_budget_bytes=12_345,
            residency_prefetch=False)
    assert registry.residency.budget_bytes == 12_345
    assert registry.residency.prefetch_enabled is False
    _worker(registry)  # 0 keeps the ledger's budget
    assert registry.residency.budget_bytes == 12_345


def test_worker_mesh_policy_reads_measured_footprints_first(_root):
    from chiaswarm_tpu_torch.pipelines.components import (
        estimate_family_bytes,
    )

    (_root / "residency.json").write_text(json.dumps(
        {"version": 2, "footprints": {"bf16": {"sd15": 123}}}))
    registry = ModelRegistry(catalog=[{"name": "sd15"}, {"name": "tiny"}],
                             device="cpu")
    assert registry.residency.measured_footprints() == {"sd15": 123}
    worker = _worker(registry)
    assert worker._heaviest_catalog_bytes() == estimate_family_bytes("tiny")
    registry = ModelRegistry(catalog=[{"name": "sd15"}], device="cpu")
    assert _worker(registry)._heaviest_catalog_bytes() == 123


def test_an_empty_poll_lets_the_ledger_prefetch():
    registry = ModelRegistry(device="cpu", residency=ResidencyManager(
        budget_bytes=10_000, persist_path=None,
        metrics_registry=PortMetrics()))
    ticks = []
    registry.residency.note_idle = lambda: ticks.append(1) or False

    class Hive:
        def __init__(self, jobs):
            self.jobs = jobs

        async def get_work(self, session):
            return self.jobs

    worker = _worker(registry)

    async def poll(jobs):
        worker.hive = Hive(jobs)
        return await worker._ask_for_work(None)

    asyncio.run(poll([]))
    assert ticks == [1]
    asyncio.run(poll([{"id": "j1", "model_name": "tiny"}]))
    assert ticks == [1]  # a poll with work never prefetches
