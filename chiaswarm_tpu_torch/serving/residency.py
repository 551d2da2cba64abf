"""The device-memory ledger of resident models: a copy of
``chiaswarm_tpu/serving/residency.py`` (``ModelUnavailable``,
``ArrivalEwma``, ``is_transient``, the budget defaults and
``ResidencyManager`` :100-929).

What it copies, with the JAX package's behaviour and numbers:

- **Measured footprints.** Every load measures the live modules
  (``Components.param_bytes``: the bytes of every parameter, which is what
  JAX's ``measured_param_bytes`` sums) and remembers them per model in
  ``<settings root>/residency.json``, in the JAX file's format (one
  section per serving weight format, ``bf16`` or ``int8``), so the next
  load and the worker's mesh policy plan with real numbers.
- **Donation: evict-then-load under one reservation.** A miss reserves the
  model's remembered (or estimated) footprint first, evicting victims in
  (priority, LRU) order until it fits, and only then loads: a swap never
  holds victim and replacement at once. ``peak_bytes`` is the high-water
  mark of resident + reserved bytes.
- **The degradation rungs.** A model whose footprint exceeds the budget
  loads per job: the value comes back uncached, its transient reservation
  released by ``weakref.finalize`` when the job drops it. One that cannot
  fit even transiently bounces as :class:`ModelUnavailable`, which the
  executor reports as the non-fatal ``model_unavailable`` kind.
- **Demand-driven prefetch.** Every acquire feeds a per-model
  :class:`ArrivalEwma`; on an empty poll the worker calls
  :meth:`ResidencyManager.note_idle`, which warm-loads the hottest evicted
  model that fits the free budget on a daemon thread (prefetch never
  evicts). ``note_placement`` reorders that choice by a fleet planner's
  hint.

What is PyTorch's own:

- **Bytes are module bytes.** The ledger counts ``param_bytes``; the
  caching allocator keeps freed blocks reserved, so after an eviction
  ``torch.cuda.memory_allocated`` falls and ``memory_reserved`` need not.
  Nothing here calls ``torch.cuda.empty_cache``.
- **Eviction retires the victim's lanes** at drain
  (``serving/stepper.py::retire_lanes_for_owner``): a lane's row state and
  text embeddings hold device memory until it retires. JAX's other
  eviction hook, ``_drop_owner_executables``, has no counterpart: the port
  keeps no executable cache.
- **A background load is complete when it is admitted.** JAX syncs a
  prefetched tree (``_block_until_ready``) before handing it over; here
  the checkpoint loader copies on a stream of its own and synchronises it
  before it returns (``convert/checkpoint.py::TensorLander``), so the
  ledger admits a pipeline whose weights are on the card.
- **Budgets** default to ``core/mesh.py``'s ``resident_param_budget_bytes``
  (``CHIASWARM_RESIDENCY_BUDGET`` overrides) and 90% of the device's memory
  (``device_hbm_bytes``) for the hard limit. There is no process-wide
  default manager: each registry owns one (``node/registry.py``).

Stdlib and the port's ``obs.metrics`` at import; torch only through the
budget defaults. The ledger tests run with fake loaders and no device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Hashable

from chiaswarm_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("chiaswarm_torch.residency")

ENV_HARD_LIMIT = "CHIASWARM_RESIDENCY_HARD_LIMIT"
ENV_PREFETCH = "CHIASWARM_RESIDENCY_PREFETCH"

# ---- the residency families (obs/metrics.py declares and documents them) ----
_RESIDENT_BYTES = obs_metrics.residency_bytes_gauge()
_BUDGET_BYTES = obs_metrics.residency_budget_gauge()
_PEAK_BYTES = obs_metrics.residency_peak_gauge()
_MODELS = obs_metrics.residency_models_gauge()
_EVICTIONS = obs_metrics.residency_evictions_counter()
_LOADS = obs_metrics.residency_loads_counter()
_BOUNCES = obs_metrics.residency_bounces_counter()
_LOAD_SECONDS = obs_metrics.residency_load_seconds_histogram()

# pre-seed every label vocabulary so the families render zeroes from the
# first scrape
for _state in obs_metrics.RESIDENCY_STATES:
    _MODELS.set(0, state=_state)
for _reason in obs_metrics.RESIDENCY_EVICT_REASONS:
    _EVICTIONS.inc(0, reason=_reason)
for _mode in obs_metrics.RESIDENCY_LOAD_MODES:
    _LOADS.inc(0, mode=_mode)


class _PrefetchSkip(RuntimeError):
    """A background warm load found no free budget (the race window
    between candidate selection and reservation): skipped silently —
    prefetch must never evict or error a job."""


class ModelUnavailable(ValueError):
    """This node cannot hold the model even transiently. The message
    carries the ``is not available on this node`` marker, so
    ``node/resilience.py::classify_exception`` sorts it as
    ``model_unavailable``: non-fatal, breaker fodder, and a redispatch
    signal (another node may have the memory this one lacks)."""


#: half-life of the per-model arrival EWMAs the prefetch ranking reads:
#: JAX's value, the winner of its load-harness sweep
#: (``chiaswarm_tpu/node/loadgen.py::sweep_prefetch_window``), longer than
#: the lane demand EWMA's 10 s because model reuse has minutes-scale
#: locality.
PREFETCH_RANK_WINDOW_S = 20.0


class ArrivalEwma:
    """Events/second EWMA over inter-arrival gaps, decayed while idle.

    The demand signal the adaptive lane-width controller reads
    (serving/stepper.py) and, per model, the prefetch ranking here. All
    methods take an explicit monotonic ``now`` (testable on a fake
    clock)."""

    def __init__(self, window_s: float = 10.0) -> None:
        self.window_s = float(window_s)
        self._rate = 0.0
        self._last: float | None = None

    def note(self, rows: int, now: float) -> None:
        if self._last is not None:
            gap = max(now - self._last, 1e-3)
            decay = 0.5 ** (gap / self.window_s)
            self._rate = decay * self._rate + (1.0 - decay) * (rows / gap)
        self._last = now

    def rate(self, now: float) -> float:
        if self._last is None:
            return 0.0
        return self._rate * 0.5 ** (max(now - self._last, 0.0)
                                    / self.window_s)


def default_budget_bytes(device=None) -> int:
    """Resident-param budget of ``device`` (the first card, where there is
    one, when None): ``CHIASWARM_RESIDENCY_BUDGET`` wins, else a fixed
    share of its memory (``core/mesh.py::resident_param_budget_bytes``)."""
    from chiaswarm_tpu_torch.core.mesh import (
        device_hbm_bytes,
        resident_param_budget_bytes,
    )

    return resident_param_budget_bytes(device_hbm_bytes(device))


def default_hard_limit_bytes(budget: int, device=None) -> int:
    """Absolute transient ceiling: a load may briefly exceed the
    resident budget (degraded load-per-job), never this. Defaults to
    90% of the device's memory: params past that leave no activation
    room."""
    raw = os.environ.get(ENV_HARD_LIMIT, "").strip()
    if raw:
        with contextlib.suppress(ValueError):
            return max(int(budget), int(float(raw)))
    from chiaswarm_tpu_torch.core.mesh import device_hbm_bytes

    return max(int(budget), int(0.9 * device_hbm_bytes(device)))


def prefetch_enabled_default() -> bool:
    return os.environ.get(ENV_PREFETCH, "").strip().lower() not in (
        "0", "false", "off", "no")


def is_transient(value: Any) -> bool:
    """True when ``value`` came from a degraded load-per-job acquire —
    holders (lanes!) must not keep it resident past the job."""
    return bool(getattr(value, "_residency_transient", False))


def current_weights_format() -> str:
    """The section of residency.json the footprints live in, the serving
    weight format (``CHIASWARM_WEIGHTS``, ``convert/quantize.py``; JAX
    :210-216): an int8 footprint must not size a bf16 restart's
    reservations."""
    raw = os.environ.get("CHIASWARM_WEIGHTS", "").strip().lower()
    return raw or "bf16"


class _Entry:
    __slots__ = ("key", "model", "value", "bytes", "priority",
                 "last_used", "owner_id")

    def __init__(self, key: Hashable, model: str, value: Any,
                 nbytes: int, priority: int, last_used: float) -> None:
        self.key = key
        self.model = model
        self.value = value
        self.bytes = int(nbytes)
        self.priority = int(priority)
        self.last_used = float(last_used)
        # the object the value's lanes are keyed through (a pipeline's
        # components, a ControlNet bundle itself): eviction retires them
        owner = getattr(value, "c", value)
        self.owner_id = None if owner is None else id(owner)


class _Recipe:
    """Everything needed to re-load an evicted entry in the background."""

    __slots__ = ("loader", "model", "size_of", "priority")

    def __init__(self, loader: Callable[[], Any], model: str,
                 size_of: Callable[[Any], int] | None,
                 priority: int) -> None:
        self.loader = loader
        self.model = model
        self.size_of = size_of
        self.priority = priority


class ResidencyManager:
    """The device-memory ledger: measured residency, priority eviction
    with donation, demand-driven prefetch, and the degradation rungs.

    One per registry (``node/registry.py``); tests construct private
    managers with explicit budgets and their own metrics registry."""

    #: sentinel: "use <settings root>/residency.json"; an explicit None
    #: turns persistence OFF (benches and tests must not write the
    #: operator's real footprint file)
    DEFAULT_PERSIST: Any = object()

    def __init__(self, budget_bytes: int | None = None,
                 hard_limit_bytes: int | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 persist_path: Path | str | None | Any = DEFAULT_PERSIST,
                 prefetch: bool | None = None,
                 reserve_wait_s: float = 15.0,
                 metrics_registry: Any = None) -> None:
        self.budget_bytes = int(budget_bytes if budget_bytes is not None
                                else default_budget_bytes())
        self.hard_limit_bytes = int(
            hard_limit_bytes if hard_limit_bytes is not None
            else default_hard_limit_bytes(self.budget_bytes))
        self.reserve_wait_s = float(reserve_wait_s)
        self.prefetch_enabled = (prefetch_enabled_default()
                                 if prefetch is None else bool(prefetch))
        self._clock = clock
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._entries: dict[Hashable, _Entry] = {}
        self._loading: dict[Hashable, threading.Event] = {}
        self._resident_bytes = 0
        # reservations split by kind: resident-bound loads count against
        # the BUDGET, transient (load-per-job) ones only against the
        # HARD limit — an in-flight degraded load must not make every
        # concurrent resident reserve evict the working set and bounce
        self._reserved_resident = 0
        self._reserved_transient = 0
        self.peak_bytes = 0
        self._states: dict[str, str] = {}
        self._quarantined: set[str] = set()
        self._arrivals: dict[str, ArrivalEwma] = {}
        self._recipes: dict[Hashable, _Recipe] = {}
        # fleet-planner placement hint: the models the current plan
        # assigns this worker, in plan order; idle-poll prefetch warms
        # these before the local arrival ranking
        self._placement: tuple[str, ...] = ()
        self.placement_hints = 0
        self._prefetch_thread: threading.Thread | None = None
        # per-manager counters for snapshot() (the metric families are
        # process-global; hermetic views need per-manager numbers)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.degraded_loads = 0
        self.prefetch_loads = 0
        self.bounces = 0
        if metrics_registry is not None:
            reg = metrics_registry
            self._m_bytes = obs_metrics.residency_bytes_gauge(reg)
            self._m_budget = obs_metrics.residency_budget_gauge(reg)
            self._m_peak = obs_metrics.residency_peak_gauge(reg)
            self._m_models = obs_metrics.residency_models_gauge(reg)
            self._m_evictions = obs_metrics.residency_evictions_counter(reg)
            self._m_loads = obs_metrics.residency_loads_counter(reg)
            self._m_bounces = obs_metrics.residency_bounces_counter(reg)
            self._m_load_s = obs_metrics.residency_load_seconds_histogram(reg)
        else:
            self._m_bytes, self._m_budget = _RESIDENT_BYTES, _BUDGET_BYTES
            self._m_peak, self._m_models = _PEAK_BYTES, _MODELS
            self._m_evictions, self._m_loads = _EVICTIONS, _LOADS
            self._m_bounces, self._m_load_s = _BOUNCES, _LOAD_SECONDS
        # measured footprints survive restarts: the worker's mesh policy
        # and the first post-restart swap plan with real numbers
        if persist_path is ResidencyManager.DEFAULT_PERSIST:
            self._persist_path = self._default_persist_path()
        else:
            self._persist_path = (None if persist_path is None
                                  else Path(persist_path))
        self._footprints: dict[str, int] = {}
        self._load_footprints()
        self._refresh_gauges_locked()

    # ---- persistence of measured footprints --------------------------

    @staticmethod
    def _default_persist_path() -> Path:
        from chiaswarm_tpu_torch.node.settings import settings_root

        return settings_root() / "residency.json"

    def _load_footprints(self) -> None:
        """Restore the current weight format's section (the others are
        kept as they are when the file is written back)."""
        path = self._persist_path
        if path is None or not path.is_file():
            return
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
            sections = data.get("footprints") or {}
            raw = sections.get(current_weights_format()) or {}
            self._footprints = {str(m): int(b) for m, b in raw.items()
                                if int(b) > 0}
            self._persisted_sections = {
                str(fmt): dict(entries)
                for fmt, entries in sections.items()
                if isinstance(entries, dict)}
        except (OSError, json.JSONDecodeError, TypeError, ValueError,
                AttributeError) as exc:
            log.warning("unreadable residency footprint file %s (%s); "
                        "starting from estimates", path, exc)

    def _save_footprints(self) -> None:
        path = self._persist_path
        if path is None:
            return
        try:
            sections = dict(getattr(self, "_persisted_sections", {}))
            sections[current_weights_format()] = dict(self._footprints)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(path.suffix + ".tmp")
            tmp.write_text(json.dumps(
                {"version": 2, "footprints": sections},
                sort_keys=True), encoding="utf-8")
            tmp.replace(path)
            self._persisted_sections = sections
        except OSError as exc:  # persistence must never break serving
            log.warning("residency footprint persist to %s failed: %s",
                        path, exc)

    # ---- ledger internals (call with self._lock held) -----------------

    @property
    def _reserved_bytes(self) -> int:
        return self._reserved_resident + self._reserved_transient

    def _note_peak_locked(self) -> None:
        total = self._resident_bytes + self._reserved_bytes
        if total > self.peak_bytes:
            self.peak_bytes = total

    def _set_state_locked(self, model: str, state: str) -> None:
        self._states[model] = state

    def _models_with_entries_locked(self) -> set[str]:
        return {e.model for e in self._entries.values()}

    @staticmethod
    def _retire_owner_lanes(owner_id: int | None, model: str) -> None:
        """Eviction -> lane retire: a resident lane holds the evicted
        model's pipeline, row state and text embeddings between jobs, so
        without this hook its memory frees only after the lane's idle
        grace. Retire the victim's lanes at drain: idle lanes free at
        once. Lazy import: the stepper imports this module's
        ArrivalEwma."""
        if owner_id is None:
            return
        try:
            from chiaswarm_tpu_torch.serving.stepper import (
                retire_lanes_for_owner,
            )

            retired = retire_lanes_for_owner(owner_id)
            if retired:
                log.info("eviction of %s retired %d lane(s) at drain",
                         model, retired)
        except Exception:  # lane hygiene must never break the ledger
            log.exception("retiring the lanes of %s failed", model)

    def _charge_locked(self, need_bytes: int, limit: int,
                       count_transient: bool) -> int:
        """Bytes the ``limit`` check sees: resident + resident-bound
        reservations (+ transient ones only for hard-limit checks) +
        the incoming need. Resident-budget checks EXCLUDE in-flight
        transient reservations — a degraded load-per-job in progress
        must not starve (or mass-evict for) resident loads that fit."""
        reserved = self._reserved_resident
        if count_transient:
            reserved += self._reserved_transient
        return self._resident_bytes + reserved + need_bytes - limit

    def _evict_locked(self, need_bytes: int, limit: int, reason: str,
                      count_transient: bool = False) -> bool:
        """Drop (priority, LRU)-ordered victims until ``need_bytes`` more
        fit under ``limit``. Returns True when they do. The donation
        invariant lives here: this runs BEFORE the incoming load, under
        its reservation, so victim and replacement never coexist."""
        while self._charge_locked(need_bytes, limit, count_transient) > 0:
            victims = list(self._entries.values())
            if not victims:
                return self._charge_locked(need_bytes, limit,
                                           count_transient) <= 0
            victim = min(victims,
                         key=lambda e: (e.priority, e.last_used))
            del self._entries[victim.key]
            self._resident_bytes -= victim.bytes
            self.evictions += 1
            self._m_evictions.inc(reason=reason)
            if victim.model not in self._models_with_entries_locked():
                self._set_state_locked(victim.model, "evicted")
            self._retire_owner_lanes(victim.owner_id, victim.model)
            log.info("evicted %s (%.1f MiB, priority %d, reason %s); "
                     "resident now %.1f MiB", victim.model,
                     victim.bytes / 2**20, victim.priority, reason,
                     self._resident_bytes / 2**20)
            self._space.notify_all()
        return True

    def _refresh_gauges_locked(self) -> None:
        self._m_bytes.set(self._resident_bytes)
        self._m_budget.set(self.budget_bytes)
        self._m_peak.set(self.peak_bytes)
        counts = {state: 0 for state in obs_metrics.RESIDENCY_STATES}
        for model, state in self._states.items():
            if model in self._quarantined:
                state = "quarantined"
            counts[state] = counts.get(state, 0) + 1
        for state, n in counts.items():
            self._m_models.set(n, state=state)

    # ---- the acquire path ---------------------------------------------

    def acquire(self, key: Hashable, loader: Callable[[], Any], *,
                model: str,
                size_of: Callable[[Any], int] | None = None,
                estimate: Callable[[], int | None] | None = None,
                priority: int = 0,
                mode: str = "demand") -> Any:
        """Resident value for ``key``, loading (and evicting) as needed.

        ``size_of`` measures the built value's live footprint (the
        registry passes ``pipe.c.param_bytes()``); ``estimate`` is the
        pre-load reservation fallback for a model never measured before
        (the bf16 family estimate). Raises :class:`ModelUnavailable` when the model
        cannot fit even transiently."""
        model = str(model)
        now = self._clock()
        with self._lock:
            if mode != "prefetch":
                # prefetch re-loads must not inflate the demand signal
                # they themselves are ranked by
                self._arrivals.setdefault(
                    model, ArrivalEwma(
                        window_s=PREFETCH_RANK_WINDOW_S)).note(1, now)
                self._recipes[key] = _Recipe(loader, model, size_of,
                                             priority)
            entry = self._entries.get(key)
            if entry is not None:
                entry.last_used = now
                self.hits += 1
                return entry.value
        # serialize concurrent loads of one key: the second caller waits
        # for the first instead of double-loading a multi-GB tree
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    entry.last_used = self._clock()
                    self.hits += 1
                    return entry.value
                event = self._loading.get(key)
                if event is None:
                    event = threading.Event()
                    self._loading[key] = event
                    break
            if not event.wait(timeout=600.0):
                raise TimeoutError(
                    f"timed out waiting for a concurrent load of {model!r}")
            # loader finished: loop re-checks residency (a degraded load
            # admits nothing — this caller becomes the next loader)
        try:
            return self._load(key, loader, model=model, size_of=size_of,
                              estimate=estimate, priority=priority,
                              mode=mode)
        finally:
            with self._lock:
                self._loading.pop(key, None)
            event.set()

    def _expected_bytes(self, model: str,
                        estimate: Callable[[], int | None] | None) -> int:
        measured = self._footprints.get(model)
        if measured:
            return int(measured)
        if estimate is not None:
            try:
                guess = estimate()
                if guess:
                    return int(guess)
            except Exception as exc:  # estimates must never block serving
                log.debug("footprint estimate for %s failed: %s", model,
                          exc)
        return 0

    def _reserve(self, model: str, expected: int, transient: bool,
                 mode: str) -> bool:
        """Take the pre-load reservation, evicting for it (donation).
        Resident reservations check the BUDGET (excluding in-flight
        transient bytes — see ``_charge_locked``); transient
        (over-budget) loads reserve against the HARD limit, counting
        everything, and may wait ``reserve_wait_s`` for in-flight
        transients to release. Prefetch reservations never evict — a
        background warm load racing a demand load must not churn the
        working set the demand load just built. Returns False when the
        space never materializes (bounce / prefetch skip)."""
        limit = self.hard_limit_bytes if transient else self.budget_bytes
        deadline = self._clock() + self.reserve_wait_s
        with self._space:
            while True:
                if mode == "prefetch":
                    fits = self._charge_locked(expected, limit,
                                               count_transient=True) <= 0
                else:
                    fits = self._evict_locked(
                        expected, limit, reason="capacity",
                        count_transient=transient)
                if fits:
                    if transient:
                        self._reserved_transient += expected
                    else:
                        self._reserved_resident += expected
                    self._note_peak_locked()
                    self._set_state_locked(model, "loading")
                    self._refresh_gauges_locked()
                    return True
                if mode == "prefetch":
                    return False  # never evict, never wait: just skip
                # no room even after evicting everything evictable:
                # CONCURRENT reservations hold the rest. They settle
                # into evictable entries (or release) quickly — wait
                # for them instead of spuriously bouncing a model that
                # fits the node sequentially.
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._space.wait(timeout=min(remaining, 1.0))

    def _release_transient(self, nbytes: int) -> None:
        """A degraded load-per-job value's last reference died: release
        its reservation."""
        with self._space:
            self._reserved_transient = max(
                0, self._reserved_transient - nbytes)
            self._refresh_gauges_locked()
            self._space.notify_all()

    def _load(self, key: Hashable, loader: Callable[[], Any], *,
              model: str, size_of: Callable[[Any], int] | None,
              estimate: Callable[[], int | None] | None,
              priority: int, mode: str) -> Any:
        self.misses += 1
        expected = self._expected_bytes(model, estimate)
        if expected > self.hard_limit_bytes:
            self._bounce(model, expected)
        transient = expected > self.budget_bytes
        if not self._reserve(model, expected, transient, mode):
            if mode == "prefetch":
                raise _PrefetchSkip(
                    f"no free budget to prefetch {model!r}")
            self._bounce(model, expected)

        def release_reservation_locked(nbytes: int) -> None:
            if transient:
                self._reserved_transient = max(
                    0, self._reserved_transient - nbytes)
            else:
                self._reserved_resident = max(
                    0, self._reserved_resident - nbytes)

        evicted_before = self.evictions
        t0 = time.perf_counter()
        try:
            value = loader()
        except BaseException:
            with self._space:
                release_reservation_locked(expected)
                if model not in self._models_with_entries_locked():
                    self._set_state_locked(model, "unavailable")
                self._refresh_gauges_locked()
                self._space.notify_all()
            raise
        actual = expected
        if size_of is not None:
            try:
                actual = int(size_of(value))
            except Exception as exc:
                log.warning("footprint measurement for %s failed (%s); "
                            "keeping the %.1f MiB reservation", model,
                            exc, expected / 2**20)
        load_mode = ("prefetch" if mode == "prefetch"
                     else "per_job" if (transient
                                        or actual > self.budget_bytes)
                     else "resident")
        self._m_load_s.observe(
            time.perf_counter() - t0, mode=load_mode,
            swapped="1" if self.evictions > evicted_before else "0")
        with self._space:
            # swap the pre-load reservation for the measured footprint
            release_reservation_locked(expected)
            if actual > 0:
                self._footprints[model] = actual
            if transient or actual > self.budget_bytes:
                # degradation rung: serve load-per-job; the transient
                # reservation releases when the value's refs die
                self._reserved_transient += actual
                self._note_peak_locked()
                self.degraded_loads += 1
                self._m_loads.inc(mode="per_job")
                self._set_state_locked(model, "degraded")
                try:
                    value._residency_transient = True
                except (AttributeError, TypeError):
                    pass  # slotted stubs: is_transient just reads False
                weakref.finalize(value, self._release_transient, actual)
                self._refresh_gauges_locked()
                self._space.notify_all()
                log.warning(
                    "model %s (%.1f MiB measured) exceeds the %.1f MiB "
                    "residency budget; degraded to load-per-job", model,
                    actual / 2**20, self.budget_bytes / 2**20)
            else:
                # admit: evict again only if the measurement overshot
                # the estimate. Prefetch still never evicts — it skips
                # instead (the next demand acquire reloads properly).
                if mode == "prefetch":
                    if self._charge_locked(actual, self.budget_bytes,
                                           count_transient=True) > 0:
                        self._set_state_locked(model, "evicted")
                        self._refresh_gauges_locked()
                        self._space.notify_all()
                        raise _PrefetchSkip(
                            f"free budget for {model!r} vanished mid-load")
                elif not self._evict_locked(actual, self.budget_bytes,
                                            reason="capacity"):
                    # nothing left to evict: CONCURRENT reservations
                    # hold the rest of the budget. The memory is
                    # already allocated (the value is loaded) — admit
                    # anyway with honest accounting; the ledger trims
                    # back under budget on the next reservation, once
                    # those in-flight loads settle into evictable
                    # entries. Refusing the job here would waste the
                    # load AND mislabel a healthy model.
                    log.warning(
                        "admitting %s (%.1f MiB) above budget: "
                        "concurrent reservations hold %.1f MiB; the "
                        "ledger trims on the next load", model,
                        actual / 2**20, self._reserved_bytes / 2**20)
                self._entries[key] = _Entry(key, model, value, actual,
                                            priority, self._clock())
                self._resident_bytes += actual
                self._note_peak_locked()
                self._m_loads.inc(mode=load_mode)
                if mode == "prefetch":
                    self.prefetch_loads += 1
                self._set_state_locked(model, "resident")
                self._refresh_gauges_locked()
        self._save_footprints()
        return value

    def _bounce(self, model: str, expected: int) -> None:
        with self._lock:
            self.bounces += 1
            self._m_bounces.inc()
            self._set_state_locked(model, "unavailable")
            self._refresh_gauges_locked()
        raise ModelUnavailable(
            f"model {model!r} is not available on this node: its "
            f"~{expected / 2**20:.0f} MiB footprint cannot fit the "
            f"{self.hard_limit_bytes / 2**20:.0f} MiB transient HBM "
            f"limit (budget {self.budget_bytes / 2**20:.0f} MiB)")

    # ---- budget control --------------------------------------------------

    def set_budget(self, budget_bytes: int,
                   hard_limit_bytes: int | None = None) -> None:
        """Shrink (or grow) the ledger at runtime; a shrink evicts down
        to the new budget immediately, counted ``reason="squeeze"``."""
        with self._space:
            self.budget_bytes = max(0, int(budget_bytes))
            if hard_limit_bytes is not None:
                self.hard_limit_bytes = max(self.budget_bytes,
                                            int(hard_limit_bytes))
            else:
                self.hard_limit_bytes = max(self.budget_bytes,
                                            self.hard_limit_bytes)
            self._evict_locked(0, self.budget_bytes, reason="squeeze")
            self._refresh_gauges_locked()

    def reset_peak(self) -> None:
        """Re-arm the high-water mark (tests/benches bracket one swap)."""
        with self._lock:
            self.peak_bytes = self._resident_bytes + self._reserved_bytes
            self._refresh_gauges_locked()

    # ---- prefetch (worker idle-poll hook) ------------------------------

    def note_placement(self, models: Any) -> None:
        """Accept a fleet planner's model assignment for this worker
        (delivered on heartbeat acks, which the port's worker does not
        send yet). Purely advisory: it reorders the idle-poll prefetch
        preference below; it never loads, evicts, or blocks anything."""
        cleaned = tuple(str(m) for m in (models or ()) if str(m))
        with self._lock:
            if cleaned != self._placement:
                self.placement_hints += 1
                log.info("placement hint: %s", list(cleaned) or "(clear)")
            self._placement = cleaned

    def note_idle(self) -> bool:
        """The poll loop came back empty: warm-load the hottest evicted
        model that fits the FREE budget, on a daemon thread. Returns
        True when a prefetch was started. Plan-assigned models (a
        ``note_placement`` hint) outrank the local arrival EWMAs, in
        plan order — the planner sees fleet-wide demand this worker's
        local stream has not delivered yet."""
        with self._lock:
            if not self.prefetch_enabled:
                return False
            if (self._prefetch_thread is not None
                    and self._prefetch_thread.is_alive()):
                return False
            now = self._clock()
            free = (self.budget_bytes - self._resident_bytes
                    - self._reserved_bytes)
            hint_order = {model: index
                          for index, model in enumerate(self._placement)}
            best_key, best_rate = None, 0.0
            best_hint: tuple[int, Hashable] | None = None
            for key, recipe in self._recipes.items():
                if key in self._entries or key in self._loading:
                    continue
                if recipe.model in self._quarantined:
                    continue
                footprint = self._footprints.get(recipe.model)
                if not footprint or footprint > self.budget_bytes:
                    continue  # degraded models never prefetch
                if footprint > free:
                    continue  # prefetch must not evict the working set
                hint = hint_order.get(recipe.model)
                if hint is not None and (best_hint is None
                                         or hint < best_hint[0]):
                    best_hint = (hint, key)
                ewma = self._arrivals.get(recipe.model)
                rate = ewma.rate(now) if ewma is not None else 0.0
                if rate > best_rate:
                    best_key, best_rate = key, rate
            if best_hint is not None:
                best_key = best_hint[1]
                model = self._recipes[best_key].model
                ewma = self._arrivals.get(model)
                best_rate = ewma.rate(now) if ewma is not None else 0.0
            if best_key is None:
                return False
            recipe = self._recipes[best_key]

            def warm(key=best_key, recipe=recipe):
                try:
                    self.acquire(
                        key, recipe.loader, model=recipe.model,
                        size_of=recipe.size_of, priority=recipe.priority,
                        mode="prefetch")
                    log.info("prefetched %s (arrival rate %.2f/s)",
                             recipe.model, best_rate)
                except _PrefetchSkip as exc:
                    log.debug("prefetch skipped: %s", exc)
                except Exception as exc:
                    log.warning("prefetch of %s failed: %s", recipe.model,
                                exc)

            self._prefetch_thread = threading.Thread(
                target=warm, name="residency-prefetch", daemon=True)
            self._prefetch_thread.start()
            return True

    # ---- state shared with the registry (quarantine enum merge) --------

    def note_quarantined(self, model: str) -> None:
        with self._lock:
            self._quarantined.add(str(model))
            self._refresh_gauges_locked()

    def note_unquarantined(self, model: str) -> None:
        with self._lock:
            self._quarantined.discard(str(model))
            self._refresh_gauges_locked()

    def would_degrade(self, model: str) -> bool:
        """True when the model's remembered footprint no longer fits the
        budget — the executor's pre-load check that keeps degraded
        models off resident lanes (node/executor.py)."""
        with self._lock:
            footprint = self._footprints.get(str(model))
            return bool(footprint and footprint > self.budget_bytes)

    def model_states(self) -> dict[str, str]:
        """The authoritative per-model state enum: quarantine overrides
        residency; models never touched read as absent (the registry
        fills catalog entries in as ``cold``)."""
        with self._lock:
            out = dict(self._states)
            for model in self._quarantined:
                out[model] = "quarantined"
            return out

    def measured_footprints(self) -> dict[str, int]:
        with self._lock:
            return dict(self._footprints)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    @property
    def reserved_bytes(self) -> int:
        with self._lock:
            return self._reserved_bytes

    def resident_models(self) -> list[str]:
        with self._lock:
            return sorted(self._models_with_entries_locked())

    def snapshot(self) -> dict[str, Any]:
        """The ledger at a glance (JAX serves it at ``/healthz``)."""
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "hard_limit_bytes": self.hard_limit_bytes,
                "resident_bytes": self._resident_bytes,
                "reserved_bytes": self._reserved_bytes,
                "peak_bytes": self.peak_bytes,
                "resident_models":
                    sorted(self._models_with_entries_locked()),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "degraded_loads": self.degraded_loads,
                "prefetch_loads": self.prefetch_loads,
                "bounces": self.bounces,
                "prefetch_enabled": self.prefetch_enabled,
                "placement": list(self._placement),
                "placement_hints": self.placement_hints,
            }

