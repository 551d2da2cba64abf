"""Prometheus-style metrics registry: counters, gauges, histograms. A copy of
``chiaswarm_tpu/obs/metrics.py`` (:31-387 and :806-831), trimmed to what the
worker (``node/worker.py``) and ``node/resilience.py::ResilienceStats`` use:
:class:`Registry` (with its scrape-time collectors), :class:`Counter`,
:class:`Gauge`, :class:`Histogram` (with ``percentile``/``percentiles``,
:204-250), :func:`render_all`, the process-global :data:`REGISTRY`, the
dead-letter and hive-session families, the lanes' families (the
occupancy histogram, resume step, resizes, arrival rate and admissions by
workload, :388-490), the residency families (:530-636), which
``serving/residency.py`` registers on :data:`REGISTRY` with zeroes, the
overload families (:630-702), which each worker's
``node/overload.py::OverloadController`` registers on the worker's registry
with zeroes, the gray-failure guard's ``chiaswarm_guard_*`` families
(:704-780), which each worker's ``serving/guard.py::DeviceGuard`` registers
on the worker's registry with zeroes, the trace-ring eviction counter
(:779-790), and the step-collapse families (:472-530), which
``pipelines/diffusion.py`` seeds on :data:`REGISTRY` with zeroes.

Each worker owns its own :class:`Registry` (hermetic test workers must not
bleed counters into each other); process-wide state, such as the hive
client's request counts and the lanes' step seconds, lives on
:data:`REGISTRY`, and ``/metrics`` serves both. The port's own family,
:func:`kernel_launches_counter`, mirrors each hand-written kernel's launch
count at scrape time (``ops/kernels.py``). Stdlib only.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Callable, Iterable, Sequence

log = logging.getLogger("chiaswarm_torch.obs")

#: default histogram buckets (seconds): poll blips (~ms) through whole
#: jobs (~minutes)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                   600.0)


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class _Metric:
    """Base: one named family holding a value per label-values tuple."""

    typ = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}
        if not self.labelnames:
            # unlabeled series exist from registration, so /metrics shows
            # an explicit 0 instead of omitting the family entirely
            self._values[()] = 0.0

    def _key(self, labels: dict[str, Any]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def series(self) -> dict[tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)

    # ---- exposition ----

    def _series_name(self, suffix: str, key: tuple[str, ...],
                     extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = tuple(zip(self.labelnames, key)) + extra
        if not pairs:
            return f"{self.name}{suffix}"
        inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
        return f"{self.name}{suffix}{{{inner}}}"

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.typ}")
        series = self.series()
        for key in sorted(series):
            lines.append(f"{self._series_name('', key)} "
                         f"{_format_value(series[key])}")
        return lines

class Counter(_Metric):
    """Monotonic counter."""

    typ = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_to(self, value: float, **labels: Any) -> None:
        """Mirror a cumulative count kept elsewhere (never goes down)."""
        key = self._key(labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, 0.0),
                                    float(value))


class Gauge(_Metric):
    typ = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative ``le`` buckets + sum/count)."""

    typ = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        self._values.clear()  # histograms expose bucket/sum/count instead

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            self._sums[key] += value
            self._totals[key] += 1

    def count(self, **labels: Any) -> int:
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def sum(self, **labels: Any) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def percentile(self, q: float, **labels: Any) -> float | None:
        """Estimate the q-quantile (q in [0, 1]) from the bucket counts by
        linear interpolation inside the covering bucket (Prometheus'
        ``histogram_quantile``, computed locally). None for an empty
        series; mass above the last finite bucket clamps to that bound."""
        key = self._key(labels)
        with self._lock:
            # copied under the lock: observe() mutates the list in place
            counts = list(self._counts.get(key) or ())
            total = self._totals.get(key, 0)
        if not counts or total <= 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = q * total
        cum = 0
        for i, n in enumerate(counts):
            if not n:
                continue
            lo = self.buckets[i - 1] if i else 0.0
            hi = self.buckets[i]
            if cum + n >= rank:
                frac = (rank - cum) / n
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += n
        return self.buckets[-1]  # overflow mass: clamp to the last bound

    def percentiles(self, qs: Sequence[float] = (0.5, 0.9, 0.99),
                    **labels: Any) -> dict[str, float] | None:
        """{"p50": ..., "p90": ..., ...} or None when empty."""
        out = {}
        for q in qs:
            v = self.percentile(q, **labels)
            if v is None:
                return None
            out[f"p{str(round(q * 100, 1)).rstrip('0').rstrip('.')}"] = v
        return out

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.typ}")
        with self._lock:
            items = [(k, list(c), self._sums[k], self._totals[k])
                     for k, c in sorted(self._counts.items())]
        for key, counts, total_sum, total in items:
            cum = 0
            for bound, n in zip(self.buckets, counts):
                cum += n
                lines.append(
                    f"{self._series_name('_bucket', key, (('le', _format_value(bound)),))} "
                    f"{cum}")
            lines.append(
                f"{self._series_name('_bucket', key, (('le', '+Inf'),))} "
                f"{total}")
            lines.append(f"{self._series_name('_sum', key)} "
                         f"{_format_value(total_sum)}")
            lines.append(f"{self._series_name('_count', key)} {total}")
        return lines

class Registry:
    """Named metric families and scrape-time collector callbacks.

    ``counter``/``gauge``/``histogram`` are get-or-create: asking twice
    for the same name returns the same object (so modules can declare
    their metrics independently), but re-declaring with a different type
    or label set is a programming error and raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}")
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callback run before every render: the place to mirror
        state kept elsewhere (lane stats, queue depths, breaker states,
        kernel launches) into gauges and counters at scrape time."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # a broken mirror must never break scrapes
                log.exception("metrics collector failed")

    def _sorted_metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        self.collect()
        lines: list[str] = []
        for metric in self._sorted_metrics():
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"


def render_all(registries: Iterable[Registry]) -> str:
    """Concatenate several registries' expositions (the worker's own
    registry + the process-global one) into one scrape body."""
    return "".join(r.render() for r in registries)


#: process-global registry (the hive client's request counts, the lanes'
#: step timing); worker-scoped counters live on each worker's own Registry
#: (hermetic tests)
REGISTRY = Registry()

#: resume-step buckets: powers of two over the step lattice
RESUME_STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def resume_step_histogram(registry: Registry | None = None) -> Histogram:
    """Step index at which redelivered rows splice back into a lane,
    observed by ``serving/stepper.py`` at admission: a redelivered job that
    resumed records step >= 1 here (and in its result's
    ``pipeline_config.stepper.resume_step``); a distribution stuck at low
    steps means leases expire faster than the checkpoint cadence
    (``CHIASWARM_STEPPER_CKPT_EVERY``) pushes progress. Unlabeled: lane ids
    would leak one series per rebuilt lane."""
    return (registry or REGISTRY).histogram(
        "chiaswarm_stepper_resume_step",
        "step index at which resumed (redelivered) rows spliced into "
        "a lane",
        buckets=RESUME_STEP_BUCKETS)


#: occupancy-ratio buckets: one per eighth of a lane, which reads at every
#: power-of-two width
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def lane_occupancy_histogram(registry: Registry | None = None) -> Histogram:
    """Active rows / lane width, sampled at every lane step by
    ``serving/stepper.py``: whether padding is a steady trickle (the width
    too large for the arrival rate) or bursts draining out. Labelled by
    width, a bounded power-of-two lattice, never by lane id, which grows
    with every rebuilt lane."""
    return (registry or REGISTRY).histogram(
        "chiaswarm_stepper_lane_occupancy_ratio",
        "active rows / lane width at each lane step, by lane width",
        labelnames=("width",),
        buckets=OCCUPANCY_BUCKETS)


def lane_resizes_counter(registry: Registry | None = None) -> Counter:
    """Adaptive-width resizes at step boundaries, by direction: a handful
    as traffic shifts is healthy; a high rate means the controller
    thrashes; all-grow means demand outruns ``CHIASWARM_STEPPER_MAX_WIDTH``,
    all-shrink an initial width habitually too large."""
    return (registry or REGISTRY).counter(
        "chiaswarm_stepper_lane_resizes_total",
        "adaptive lane-width resizes at step boundaries, by direction",
        labelnames=("direction",))


def arrival_rate_gauge(registry: Registry | None = None) -> Gauge:
    """The lane scheduler's arrival-rate EWMA (rows/s), the demand half of
    the adaptive-width signal (occupancy is the supply half), sampled at
    each arrival and each control read; 0 when lanes idle."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_stepper_arrival_rate",
        "EWMA of lane row arrivals per second (adaptive-width demand "
        "signal)")


def lane_admissions_counter(registry: Registry | None = None) -> Counter:
    """Rows admitted into lanes, by workload: a workload stuck at 0 while
    its jobs flow is falling back to the per-job path."""
    return (registry or REGISTRY).counter(
        "chiaswarm_stepper_lane_admissions_total",
        "lane rows admitted, by workload kind",
        labelnames=("workload",))


def kernel_launches_counter(registry: Registry | None = None) -> Counter:
    """Launches of the port's hand-written kernels, by kernel and launched
    shape ``BxLxSxHxD:dtype`` (``ops/kernels.py``, mirrored at scrape time):
    a worker's ``/metrics`` shows which kernels its jobs went through, at
    which shapes. The port's own family; the JAX package has none."""
    return (registry or REGISTRY).counter(
        "chiaswarm_kernel_launches_total",
        "launches of the hand-written CUDA kernels, by kernel and shape",
        labelnames=("kernel", "shape"))


#: when a dead-letter envelope was replayed back into the upload queue:
#: ``startup`` (the worker process restarted) vs ``live`` (the hive healed
#: mid-run and the spool drained without a restart)
DEAD_LETTER_REPLAY_WHEN = ("startup", "live")


def dead_letter_replayed_counter(
        registry: Registry | None = None) -> Counter:
    """Dead-letter envelopes re-queued for upload, split by when: a
    ``live`` count rising during an incident is the ride-through working;
    a ``startup`` count means the outage outlived the worker process."""
    return (registry or REGISTRY).counter(
        "chiaswarm_dead_letter_replayed_total",
        "dead-letter results re-queued for upload, by replay moment",
        labelnames=("when",))


def hive_session_state_gauge(registry: Registry | None = None) -> Gauge:
    """The worker's hive-session state: 0 = online, 1 = OUTAGE
    ride-through (leases assumed lost, in-flight work completing,
    results spooling)."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_hive_session_state",
        "worker's hive reachability state (0=online, 1=outage)")


def hive_shard_session_state_gauge(
        registry: Registry | None = None) -> Gauge:
    """The per-shard half of the session signal: a worker over several
    hive shards holds one session per shard, and this family shows which
    shard's traffic rides an outage while the rest keep serving. The
    unlabeled gauge above is the any-shard rollup."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_hive_shard_session_state",
        "worker's per-shard hive session (0=online, 1=outage)",
        ("shard",))


# ---- residency families (serving/residency.py owns the ledger) ----

#: the authoritative per-model state vocabulary (registry + residency:
#: quarantine and residency share one enum)
RESIDENCY_STATES = ("cold", "loading", "resident", "degraded",
                    "evicted", "unavailable", "quarantined")

#: why a resident model was dropped from HBM
RESIDENCY_EVICT_REASONS = ("capacity", "squeeze")

#: how a model load was served (resident admit / degraded load-per-job /
#: background prefetch)
RESIDENCY_LOAD_MODES = ("resident", "per_job", "prefetch")


def residency_bytes_gauge(registry: Registry | None = None) -> Gauge:
    """Bytes of model params the residency ledger holds resident,
    measured from the live modules at load, not estimated. The headroom
    signal: steady-state near the budget with a nonzero eviction rate
    means the catalog is memory-bound (raise CHIASWARM_RESIDENCY_BUDGET)."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_residency_resident_bytes",
        "measured bytes of model params currently resident in HBM")


def residency_budget_gauge(registry: Registry | None = None) -> Gauge:
    return (registry or REGISTRY).gauge(
        "chiaswarm_residency_budget_bytes",
        "HBM byte budget the residency ledger evicts down to")


def residency_peak_gauge(registry: Registry | None = None) -> Gauge:
    """High-water mark of resident + reserved bytes, the no-double-buffer
    proof: a swap that evicts before loading keeps this at most budget +
    one model (the churn checks assert exactly that)."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_residency_peak_bytes",
        "high-water mark of resident + in-flight reserved bytes")


def residency_models_gauge(registry: Registry | None = None) -> Gauge:
    """Model count per residency state (the /healthz ``models`` enum,
    aggregated). ``degraded`` > 0 is the graceful-degradation rung in
    action: some model serves load-per-job because its measured
    footprint exceeds the budget."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_residency_models",
        "models per residency state (cold/loading/resident/degraded/"
        "evicted/unavailable/quarantined)",
        labelnames=("state",))


def residency_evictions_counter(registry: Registry | None = None) -> Counter:
    """Ledger evictions by reason: ``capacity`` (donation — room made
    for an incoming load) vs ``squeeze`` (the budget itself shrank). A
    high capacity rate with a small catalog means footprints ~ budget:
    expect swap latency on every model switch."""
    return (registry or REGISTRY).counter(
        "chiaswarm_residency_evictions_total",
        "models evicted from HBM residency, by reason",
        labelnames=("reason",))


def residency_loads_counter(registry: Registry | None = None) -> Counter:
    """Model loads by mode. ``per_job`` counting up is the degradation
    rung burning load latency per job, the signal to grow the budget;
    ``prefetch`` counts idle-poll warm loads driven by the per-model
    arrival EWMA."""
    return (registry or REGISTRY).counter(
        "chiaswarm_residency_loads_total",
        "model param-tree loads, by residency mode",
        labelnames=("mode",))


def residency_bounces_counter(registry: Registry | None = None) -> Counter:
    """Jobs refused because the model cannot fit even transiently
    (footprint > hard limit): uploaded as non-fatal
    ``model_unavailable`` so a lease-aware hive redispatches them."""
    return (registry or REGISTRY).counter(
        "chiaswarm_residency_bounces_total",
        "jobs bounced model_unavailable: model cannot fit transiently")


def residency_load_seconds_histogram(
        registry: Registry | None = None) -> Histogram:
    """Wall time of one model load (read, build, measure), by mode, with
    ``swapped="1"`` when the load had to evict first: the swap latency."""
    return (registry or REGISTRY).histogram(
        "chiaswarm_residency_load_seconds",
        "model load wall time, by residency mode and whether the load "
        "evicted residents first",
        labelnames=("mode", "swapped"),
        buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                 60.0, 120.0, 300.0))


# ---- overload-control families (node/overload.py) ----
#
# The controller is per worker (hermetic test workers must not bleed shed
# counts into each other): it takes the worker's registry and pre-seeds
# every label vocabulary at construction.

#: overload controller states (the brownout rung)
OVERLOAD_STATES = ("normal", "brownout")


def overload_state_gauge(registry: Registry | None = None) -> Gauge:
    """Overload-control state: 0 = normal, 1 = brownout (sustained shedding
    tripped the rung: lane admissions are capped per step and the shed
    margin tightens until sheds stop for the cooldown)."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_overload_state",
        "overload control state (0=normal, 1=brownout)")


def overload_shed_counter(registry: Registry | None = None) -> Counter:
    """Jobs shed at admission because the estimator predicted a deadline
    miss, by workload: non-fatal ``overloaded`` envelopes a lease-aware
    hive redispatches with this worker excluded."""
    return (registry or REGISTRY).counter(
        "chiaswarm_overload_shed_total",
        "jobs shed by deadline-aware admission control, by workload",
        labelnames=("workload",))


def overload_backpressure_counter(
        registry: Registry | None = None) -> Counter:
    """Poll-loop waits inserted by queue-depth backpressure: the queued
    backlog alone was predicted to outlast the backpressure budget."""
    return (registry or REGISTRY).counter(
        "chiaswarm_overload_backpressure_waits_total",
        "poll-loop waits inserted by queue-depth backpressure")


def overload_predicted_wait_histogram(
        registry: Registry | None = None) -> Histogram:
    """The admission estimator's predicted completion time (queue drain +
    service estimate) at every shed decision."""
    return (registry or REGISTRY).histogram(
        "chiaswarm_overload_predicted_wait_seconds",
        "admission estimator's predicted completion time at each "
        "shed decision",
        buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                 120.0, 300.0, 600.0, 1800.0))


def overload_admission_cap_gauge(
        registry: Registry | None = None) -> Gauge:
    """Current brownout lane-admission cap (rows per step boundary); 0 =
    uncapped. Pushed into every slot's ``StepScheduler`` while brownout
    holds."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_overload_admission_cap",
        "brownout cap on lane rows admitted per step boundary "
        "(0 = uncapped)")


def trace_spans_evicted_counter(
        registry: Registry | None = None) -> Counter:
    """Spans dropped from the bounded trace ring by eviction: a scraper of
    ``/debug/traces`` polling too slowly loses them (the ``?since=``
    cursor shows the gap)."""
    return (registry or REGISTRY).counter(
        "chiaswarm_trace_spans_evicted_total",
        "spans evicted from the bounded trace ring before any scrape "
        "collected them (use /debug/traces?since= to detect gaps)")


# ---- gray-failure guard families (serving/guard.py) ----
#
# The DeviceGuard is per worker (hermetic test workers must not bleed
# health events into each other): it takes the worker's registry and
# pre-seeds every enumerable label. The ``model`` and ``device`` labels
# are bounded by the catalog and the card count.


def guard_hangs_counter(registry: Registry | None = None) -> Counter:
    """Calls the watchdog declared hung, by phase (``lane`` step dispatch
    or ``solo`` denoise): the gray-failure signal, a card that wedges
    without dying."""
    return (registry or REGISTRY).counter(
        "chiaswarm_guard_hangs_total",
        "compiled calls declared hung by the step watchdog, by phase",
        labelnames=("phase",))


def guard_condemned_counter(registry: Registry | None = None) -> Counter:
    """Lanes condemned by the watchdog, each one a lane-rebuild rung: the
    rows re-admit to a fresh lane from their last step-boundary
    checkpoint."""
    return (registry or REGISTRY).counter(
        "chiaswarm_guard_condemned_lanes_total",
        "lanes condemned by the hang watchdog (rows re-admitted to a "
        "fresh lane)")


def guard_invalid_counter(registry: Registry | None = None) -> Counter:
    """Jobs retired ``invalid_output`` (non-finite latents or a poisoned
    decoded frame), by model: one model alone points at its weights,
    every model together at the card."""
    return (registry or REGISTRY).counter(
        "chiaswarm_guard_invalid_outputs_total",
        "jobs retired invalid_output instead of uploading a poisoned "
        "image, by model",
        labelnames=("model",))


def guard_device_health_gauge(registry: Registry | None = None) -> Gauge:
    """Per-device health in [0, 1]: 1 healthy, falling with the sickness
    streak of hangs, slow steps and invalid outputs, rising with OK
    steps."""
    return (registry or REGISTRY).gauge(
        "chiaswarm_guard_device_health",
        "per-device health score (1 = healthy; ladder rungs fire as "
        "the sickness streak grows)",
        labelnames=("device",))


def guard_heal_rung_counter(registry: Registry | None = None) -> Counter:
    """Healing-ladder escalations by rung: ``lane_rebuild`` (every
    condemnation), ``cache_flush``, ``device_quarantine``, ``restart``."""
    return (registry or REGISTRY).counter(
        "chiaswarm_guard_heal_rung_total",
        "self-healing ladder escalations, by rung",
        labelnames=("rung",))


def guard_quarantined_gauge(registry: Registry | None = None) -> Gauge:
    return (registry or REGISTRY).gauge(
        "chiaswarm_guard_quarantined_devices",
        "devices currently quarantined out of the serving mesh")


# ---- step collapse: DeepCache feature reuse (JAX :472-530) ----

#: the UNet eval modes: ``full`` runs every level (the cache refresh too);
#: ``reuse`` replays the cached deep activation and recomputes only the
#: shallow level-0 blocks
STEPPER_UNET_EVAL_MODES = ("full", "reuse")

#: per-image UNet-eval buckets: powers of two over the step lattice
UNET_EVAL_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def unet_evals_counter(registry: Registry | None = None) -> Counter:
    """Per-row UNet evaluations by mode (``full`` vs DeepCache ``reuse``):
    full / (full + reuse) is the share of the per-step cost traffic still
    pays."""
    return (registry or REGISTRY).counter(
        "chiaswarm_stepper_unet_evals_total",
        "per-row UNet evaluations, by mode (full vs DeepCache reuse)",
        labelnames=("mode",))


def steps_skipped_counter(registry: Registry | None = None) -> Counter:
    """Denoise steps whose deep UNet blocks were skipped by DeepCache
    reuse (per row). Zero while reuse jobs flow means misaligned lane mates
    kept forcing full evals."""
    return (registry or REGISTRY).counter(
        "chiaswarm_stepper_steps_skipped_total",
        "denoise steps served from the DeepCache deep-feature cache "
        "(per row)")


def unet_evals_per_image_histogram(
        registry: Registry | None = None) -> Histogram:
    """Full UNet evaluations each finished image paid, observed once per
    row at retirement (lanes) or submit (solo)."""
    return (registry or REGISTRY).histogram(
        "chiaswarm_stepper_unet_evals_per_image",
        "full UNet evaluations per finished image",
        buckets=UNET_EVAL_BUCKETS)


#: the Prometheus text exposition content type
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
