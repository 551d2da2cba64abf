"""Prometheus-style metrics registry: counters, gauges, histograms. A copy of
``chiaswarm_tpu/obs/metrics.py`` (:31-387 and :806-831), trimmed to what the
worker (``node/worker.py``) and ``node/resilience.py::ResilienceStats`` use:
:class:`Registry`, :class:`Counter`, :class:`Gauge`, :class:`Histogram`,
:func:`render_all`, the process-global :data:`REGISTRY`, the dead-letter
and hive-session families, and the residency families (:530-636), which
``serving/residency.py`` registers on :data:`REGISTRY` with zeroes.

Each worker owns its own :class:`Registry` (hermetic test workers must not
bleed counters into each other); process-wide state, such as the hive
client's request counts, lives on :data:`REGISTRY`. Stdlib only.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterable, Sequence

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
    """Named metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create: asking twice
    for the same name returns the same object (so modules can declare
    their metrics independently), but re-declaring with a different type
    or label set is a programming error and raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

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

    def _sorted_metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for metric in self._sorted_metrics():
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"


def render_all(registries: Iterable[Registry]) -> str:
    """Concatenate several registries' expositions (the worker's own
    registry + the process-global one) into one scrape body."""
    return "".join(r.render() for r in registries)


#: process-global registry (the hive client's request counts); worker-
#: scoped counters live on each worker's own Registry (hermetic tests)
REGISTRY = Registry()


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
