"""The lanes' poll hint and control-loop families of the port
(``chiaswarm_tpu_torch/serving/stepper.py``: ``StepScheduler.note_poll``,
``demand_signal``, ``_note_arrival``, ``Lane._resize_locked``;
``node/worker.py::_note_poll``), on the CPU, against the JAX package:

- the same script of polls, submissions and reads on one fake clock gives
  the same ``demand_signal`` from both schedulers (the hint fresh for 2 s,
  burnt down by the rows that land);
- the same script of step boundaries gives the same lane widths from each
  package's own ``Lane._resize_locked`` and ``LaneWidthController``, and a
  lane grows at the boundary after a poll, before the burst lands;
- one poll of k jobs through each worker (one hive, and the second shard
  of a federated worker) calls ``note_poll`` with the same rows on every
  slot's existing scheduler and creates none; an empty poll calls nothing;
- the five families render with JAX's names, types, labels and buckets,
  zeroes seeded at import.
"""

from __future__ import annotations

import asyncio
import re
import types

import aiohttp
import pytest

from chiaswarm_tpu.node import settings as jsettings
from chiaswarm_tpu.node.chaos import ChaoticExecutor
from chiaswarm_tpu.node.worker import Worker as JaxWorker
from chiaswarm_tpu.obs import metrics as jmetrics
from chiaswarm_tpu.serving import stepper as jstepper
from chiaswarm_tpu_torch.node import settings as tsettings
from chiaswarm_tpu_torch.node import worker as tworker
from chiaswarm_tpu_torch.obs import metrics as tmetrics
from chiaswarm_tpu_torch.serving import stepper as tstepper
from tests.fake_hive import FakeHive

PACKAGES = {"jax": jstepper, "torch": tstepper}


@pytest.fixture(autouse=True)
def _tmp_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))


@pytest.fixture(autouse=True)
def _restore_matmul_precision():
    """The JAX worker's startup pins bf16 matmuls."""
    import jax

    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


class FakeClock:
    """A stand-in for a stepper module's ``time``: ``monotonic`` reads the
    script's clock, ``perf_counter`` too."""

    def __init__(self) -> None:
        self.now = 100.0

    def monotonic(self) -> float:
        return self.now

    perf_counter = monotonic


def _schedulers(monkeypatch) -> tuple[dict, FakeClock]:
    clock = FakeClock()
    scheds = {}
    for pkg, mod in PACKAGES.items():
        monkeypatch.setattr(mod, "time", clock)
        scheds[pkg] = mod.StepScheduler()
    return scheds, clock


# (op, value, seconds after the previous event): a burst polled then
# landing in parts, a stale hint, a poll of nothing, a trickle
SCRIPTS = {
    "burst_lands": [("poll", 9, 0.0), ("read", 0, 0.01), ("arrive", 1, 0.05),
                    ("read", 0, 0.0), ("arrive", 4, 0.1), ("read", 0, 0.02),
                    ("arrive", 4, 0.1), ("read", 0, 0.0)],
    "hint_goes_stale": [("poll", 6, 0.0), ("read", 0, 1.5), ("read", 0, 0.5),
                        ("read", 0, 0.01), ("arrive", 2, 0.1),
                        ("read", 0, 0.0)],
    "polls_overwrite": [("poll", 4, 0.0), ("arrive", 1, 0.2), ("poll", 3, 0.3),
                        ("read", 0, 0.0), ("poll", 0, 0.1), ("read", 0, 0.0)],
    "trickle": [("arrive", 1, 0.0), ("read", 0, 1.0), ("arrive", 1, 3.0),
                ("read", 0, 0.5), ("poll", 1, 4.0), ("arrive", 1, 0.3),
                ("read", 0, 0.0), ("read", 0, 30.0)],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_demand_signal_matches_jax(script, monkeypatch):
    scheds, clock = _schedulers(monkeypatch)
    seen = {pkg: [] for pkg in scheds}
    for op, value, dt in SCRIPTS[script]:
        clock.now += dt
        for pkg, sched in scheds.items():
            if op == "poll":
                sched.note_poll(value)
            elif op == "arrive":
                sched._note_arrival(value)
            else:
                seen[pkg].append(sched.demand_signal())
    assert seen["torch"] == seen["jax"]
    hints = [hint for _, hint in seen["torch"]]
    if script == "burst_lands":
        # the hint counts the rows not landed yet, and none twice
        assert hints == [9, 8, 4, 0]
    if script == "hint_goes_stale":
        # fresh through 2.0 s, then gone
        assert hints == [6, 6, 0, 0]
    # an explicit clock reads the same too
    later = {pkg: [sched.demand_signal(now=clock.now + dt)
                   for dt in (0.0, 1.0, 2.5)]
             for pkg, sched in scheds.items()}
    assert later["torch"] == later["jax"]


class _Job:
    def __init__(self, rows: int) -> None:
        self.n_rows = rows
        self.future = types.SimpleNamespace(cancelled=lambda: False)


class _LaneStandIn:
    """The attributes ``Lane._resize_locked`` reads, and a resize that
    records the new width instead of rebuilding a row file."""

    def __init__(self, mod, width: int) -> None:
        self._adaptive = True
        self._mesh = None
        self._ctl = mod.LaneWidthController(min_width=1, max_width=16)
        self.width = width
        self._rows = [None] * width
        self._pending: list[_Job] = []
        self.resizes: list[int] = []

    def _apply_resize_locked(self, new_width: int) -> None:
        self.resizes.append(int(new_width))
        self._rows = (self._rows + [None] * new_width)[:new_width]
        self.width = int(new_width)


# boundaries: (occupied rows, pending rows, rows polled just before or
# None, rows landed just before, seconds since the last boundary)
BOUNDARIES = [
    (2, 0, None, 2, 0.2),      # a lone pair in a lane of 2
    (2, 0, 9, 0, 0.1),         # a poll of nine: the lane grows now
    (2, 3, None, 3, 0.1),      # three landed, six still hinted
    (5, 0, None, 6, 0.1),      # the rest landed; the hint is spent
    (11, 0, None, 0, 0.2),
    (8, 0, None, 0, 0.2),
    (4, 0, None, 0, 0.2),
    (1, 0, None, 0, 3.0),      # trickle: the hint long stale
    (1, 0, None, 0, 0.5),
    (1, 0, None, 0, 0.5),
    (1, 0, None, 0, 0.5),
    (1, 0, None, 0, 0.5),
    (1, 0, None, 0, 0.5),
    (1, 0, 1, 1, 0.5),
]


def _widths(mod, sched, clock, hints: bool) -> list[int]:
    lane = _LaneStandIn(mod, width=2)
    widths = []
    for occupied, pending, polled, landed, dt in BOUNDARIES:
        clock.now += dt
        if polled is not None and hints:
            sched.note_poll(polled)
        if landed:
            sched._note_arrival(landed)
        lane._rows = ([object()] * occupied
                      + [None] * max(0, lane.width - occupied))
        lane._pending = [_Job(pending)] if pending else []
        rate, hint_rows = sched.demand_signal()
        mod.Lane._resize_locked(lane, None, rate, hint_rows)
        widths.append(lane.width)
    return widths


@pytest.mark.parametrize("hints", [True, False])
def test_lane_widths_follow_the_poll_hint_like_jax(hints, monkeypatch):
    scheds, clock = _schedulers(monkeypatch)
    got = {}
    for pkg, sched in scheds.items():
        clock.now = 100.0
        got[pkg] = _widths(PACKAGES[pkg], sched, clock, hints)
    assert got["torch"] == got["jax"]
    if hints:
        # the boundary after the poll of nine holds the pair plus the
        # burst: the lane is 16 wide before any of the burst landed
        assert got["torch"][:2] == [2, 16]
    else:
        assert got["torch"][1] == 2 and got["torch"][2] == 8


def _settings(mod, uri: str, name: str):
    return mod.Settings(hive_uri=uri, hive_token="t", worker_name=name,
                        poll_busy_s=0.02, poll_idle_s=0.05,
                        install_signal_handlers=False,
                        drain_timeout_s=5.0, result_drain_timeout_s=5.0)


class _Recorder:
    def __init__(self) -> None:
        self.polls: list[int] = []

    def note_poll(self, rows: int) -> None:
        self.polls.append(rows)

    def set_admission_cap(self, rows) -> None:
        pass


class StubSlot:
    def __init__(self, name: str, stepper: _Recorder | None = None) -> None:
        self.depth = 2
        self.data_width = 1
        self.name = name
        if stepper is not None:
            self._stepper = stepper

    def descriptor(self):
        return self.name


JOBS = [{"id": "hint-0", "model_name": "tiny", "prompt": "a"},
        {"id": "hint-1", "model_name": "tiny", "prompt": "b",
         "num_images_per_prompt": 2},
        {"id": "hint-2", "model_name": "tiny", "prompt": "c",
         "num_images_per_prompt": 0}]


@pytest.mark.parametrize("federated", [False, True])
def test_a_poll_hints_each_existing_scheduler_and_creates_none(federated):
    async def poll(cls, mod, pkg: str) -> tuple[list, list, bool]:
        hives = [FakeHive() for _ in range(2 if federated else 1)]
        uris = [await hive.start() for hive in hives]
        hinted, bare = _Recorder(), StubSlot("bare")
        worker = cls(settings=_settings(mod, ",".join(uris), f"hint-{pkg}"),
                     pool=[StubSlot("lanes", hinted), bare],
                     registry=object(), executor=ChaoticExecutor())
        shard = worker.shards[-1]
        try:
            async with aiohttp.ClientSession() as session:
                await worker._ask_for_work(session, shard)  # nothing queued
                hives[-1].jobs = [dict(job) for job in JOBS]
                await worker._ask_for_work(session, shard)
        finally:
            for hive in hives:
                await hive.stop()
        return (hinted.polls, [j["id"] for j in _queued(worker)],
                hasattr(bare, "_stepper"))

    got = {pkg: asyncio.run(poll(cls, mod, pkg)) for pkg, cls, mod in (
        ("jax", JaxWorker, jsettings), ("torch", tworker.Worker, tsettings))}
    assert got["torch"] == got["jax"]
    polls, queued, created = got["torch"]
    assert polls == [1 + 2 + 1]  # one call, for the poll that had jobs
    assert queued == [job["id"] for job in JOBS]
    assert not created


def _queued(worker) -> list[dict]:
    jobs = []
    while not worker.work_queue.empty():
        jobs.append(worker.work_queue.get_nowait())
    return [job if isinstance(job, dict) else job[0] for job in jobs]


FAMILIES = ("chiaswarm_stepper_admission_seconds",
            "chiaswarm_stepper_lane_occupancy_ratio",
            "chiaswarm_stepper_lane_resizes_total",
            "chiaswarm_stepper_arrival_rate",
            "chiaswarm_stepper_lane_admissions_total")


@pytest.mark.parametrize("name", FAMILIES)
def test_lane_families_render_like_jax(name):
    j, t = jmetrics.REGISTRY.get(name), tmetrics.REGISTRY.get(name)
    assert j is not None and t is not None
    assert (type(t).__name__, t.help, t.labelnames,
            getattr(t, "buckets", None)) == (
        type(j).__name__, j.help, j.labelnames, getattr(j, "buckets", None))
    body = tmetrics.REGISTRY.render()
    assert re.search(rf"^# TYPE {name} ", body, re.M), name
    if name == "chiaswarm_stepper_lane_resizes_total":
        for direction in ("grow", "shrink"):
            assert f'{name}{{direction="{direction}"}}' in body
    if name == "chiaswarm_stepper_lane_admissions_total":
        assert tstepper.WORKLOADS == jstepper.WORKLOADS
        for workload in tstepper.WORKLOADS:
            assert f'{name}{{workload="{workload}"}}' in body
    if name == "chiaswarm_stepper_arrival_rate":
        assert re.search(rf"^{name} ", body, re.M)
