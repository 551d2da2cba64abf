"""Dapper-style trace spans: where a job's wall-clock actually goes. A copy
of ``chiaswarm_tpu/obs/trace.py`` (``Span``, ``span``, ``JobTrace``,
``TraceRing`` with its scrape cursor and Chrome export :229-300,
``job_trace``, ``attach``, ``detach``, ``activate``).

One :class:`JobTrace` per hive job, built across the worker's thread
boundaries (poll loop -> slot task -> executor thread -> upload task),
answering where a job's time went: queue wait, execution, upload.

Mechanics:

- Durations come from ``time.perf_counter()`` only: the wall clock
  jumps under NTP.
- Within one thread, :func:`span` nests via a ``contextvars`` context
  variable: the executor activates a job's trace once at entry
  (:meth:`JobTrace.active`) and every ``span()`` below — pipeline
  encode, lane wait, decode — attaches at the right depth with no
  plumbing.
- Across threads/tasks the handoff is explicit: the trace object rides
  the job dict (``node/worker.py`` attaches it at poll receipt under
  ``TRACE_KEY``; the executor pops it before argument formatting) and
  phases are opened/closed manually (:meth:`JobTrace.phase`).
- Finished traces land in a bounded in-memory :class:`TraceRing`; the
  worker folds their phases into its latency histograms and serves the
  ring at ``/debug/traces``: Chrome-tracing "complete" events
  (Perfetto-loadable) or span trees (``?format=tree``), after a scrape
  cursor (``?since=<seq>``; evictions are counted, so a gap shows).

Everything is stdlib; a ``span()`` outside any active trace times into
a detached throwaway Span, so library code can instrument
unconditionally (allocation-light: one small object per span, none per
lookup).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import threading
import time
from typing import Any, Iterator

#: key under which a JobTrace rides a job/result dict between worker
#: stages. Executors MUST pop it before kwargs formatting and the
#: worker pops it before JSON-serializing an envelope.
TRACE_KEY = "_obs_trace"

ENV_RING_CAPACITY = "CHIASWARM_TRACE_RING"

_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "chiaswarm_obs_span", default=None)


class Span:
    """One timed region; children nest. Durations on perf_counter."""

    __slots__ = ("name", "meta", "t0", "t1", "children")

    def __init__(self, name: str, meta: dict[str, Any] | None = None,
                 t0: float | None = None) -> None:
        self.name = str(name)
        self.meta = dict(meta or {})
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.t1: float | None = None
        self.children: list[Span] = []

    def child(self, name: str, **meta: Any) -> "Span":
        span = Span(name, meta)
        self.children.append(span)
        return span

    def end(self) -> None:
        """Close this span (idempotent); still-open children close at
        the same instant so a crashed region never exports negative or
        unbounded durations."""
        if self.t1 is None:
            self.t1 = time.perf_counter()
        for child in self.children:
            if child.t1 is None:
                child.t1 = self.t1
                child.end()

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration_s(self) -> float:
        end = time.perf_counter() if self.t1 is None else self.t1
        return max(0.0, end - self.t0)

    def find(self, name: str) -> "Span | None":
        """First span named ``name`` in this subtree."""
        if self.name == name:
            return self
        for child in self.children:
            hit = child.find(name)
            if hit is not None:
                return hit
        return None

    def to_dict(self) -> dict[str, Any]:
        data: dict[str, Any] = {
            "name": self.name,
            "start_us": int(self.t0 * 1e6),
            "duration_us": int(self.duration_s * 1e6),
        }
        if self.meta:
            data["meta"] = dict(self.meta)
        if self.children:
            data["children"] = [c.to_dict() for c in self.children]
        return data


@contextlib.contextmanager
def span(name: str, **meta: Any) -> Iterator[Span]:
    """Time a region under the currently active span (contextvar).

    With no active trace the span is detached and discarded — safe to
    sprinkle through library code unconditionally."""
    parent = _CURRENT.get()
    current = parent.child(name, **meta) if parent is not None \
        else Span(name, meta)
    token = _CURRENT.set(current)
    try:
        yield current
    finally:
        _CURRENT.reset(token)
        current.end()


class JobTrace:
    """Span tree for one job, handed explicitly across worker stages.

    Top-level *phases* (poll / execute / upload) are children of the
    root, opened with :meth:`phase` — starting a phase closes the
    previous one, so the manual cross-thread bookkeeping can never leak
    an open span. Library spans attach below whatever phase is open via
    :meth:`active` + :func:`span`.
    """

    def __init__(self, name: str = "job", **meta: Any) -> None:
        self.root = Span(name, meta)
        # wall-clock anchor for readers of the exports; durations never
        # touch it
        self.started_at_unix = time.time()
        self.finished = False
        # ring sequence number from TraceRing.push (0 = never pushed): the
        # /debug/traces?since=<seq> cursor key
        self.seq = 0

    @property
    def meta(self) -> dict[str, Any]:
        return self.root.meta

    def phase(self, name: str, **meta: Any) -> Span:
        """Open a new top-level phase, closing any open predecessor."""
        for child in self.root.children:
            if child.open:
                child.end()
        return self.root.child(name, **meta)

    def tail(self) -> Span:
        """Deepest open span — where library spans should attach."""
        node = self.root
        while node.children and node.children[-1].open:
            node = node.children[-1]
        return node

    @contextlib.contextmanager
    def active(self) -> Iterator[Span]:
        """Make this trace the thread/task's ambient span target."""
        token = _CURRENT.set(self.tail())
        try:
            yield self.root
        finally:
            _CURRENT.reset(token)

    def finish(self, ring: "TraceRing | None" = None) -> None:
        """Close the tree and publish it (idempotent)."""
        if self.finished:
            return
        self.finished = True
        self.root.end()
        (ring if ring is not None else TRACE_RING).push(self)

    # ---- export ----

    def to_dict(self) -> dict[str, Any]:
        return {"started_at_unix": round(self.started_at_unix, 6),
                "seq": self.seq,
                "root": self.root.to_dict()}

    def to_chrome_events(self, pid: int = 1,
                         tid: int = 1) -> list[dict[str, Any]]:
        """Chrome-tracing "complete" (ph=X) events, microsecond ts on the
        process perf_counter timebase (Perfetto-loadable)."""
        events: list[dict[str, Any]] = []

        def emit(node: Span) -> None:
            event = {
                "name": node.name,
                "ph": "X",
                "ts": int(node.t0 * 1e6),
                "dur": max(1, int(node.duration_s * 1e6)),
                "pid": pid,
                "tid": tid,
            }
            if node.meta:
                event["args"] = {k: str(v) for k, v in node.meta.items()}
            events.append(event)
            for child in node.children:
                emit(child)

        emit(self.root)
        return events


def _span_count(node: Span) -> int:
    return 1 + sum(_span_count(child) for child in node.children)


class TraceRing:
    """Bounded ring of recently finished traces (newest last). Every pushed
    trace gets a monotone ``seq``; evictions are counted (``spans_evicted``
    feeds ``chiaswarm_trace_spans_evicted_total``), so a scraper passing
    ``?since=<seq>`` sees a gap (``cursor()["oldest_seq"] > since + 1``)
    instead of losing traces silently."""

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get(ENV_RING_CAPACITY, "128") or 128)
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._traces: collections.deque[JobTrace] = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self.traces_evicted = 0
        self.spans_evicted = 0

    def push(self, trace: JobTrace) -> None:
        with self._lock:
            self._seq += 1
            trace.seq = self._seq
            if len(self._traces) == self.capacity:
                oldest = self._traces[0]  # the deque's maxlen drops it
                self.traces_evicted += 1
                self.spans_evicted += _span_count(oldest.root)
            self._traces.append(trace)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def traces(self, since: int | None = None) -> list[JobTrace]:
        """Ring contents, oldest first; ``since`` keeps only the traces
        pushed after that sequence number (the scrape cursor)."""
        with self._lock:
            out = list(self._traces)
        if since is not None:
            out = [t for t in out if t.seq > int(since)]
        return out

    def cursor(self) -> dict[str, Any]:
        """Scraper bookkeeping: pass ``last_seq`` back as ``?since=``; a
        later ``oldest_seq`` > since + 1 means the ring evicted traces the
        scraper never saw."""
        with self._lock:
            return {
                "last_seq": self._seq,
                "oldest_seq": self._traces[0].seq if self._traces else None,
                "evicted_traces": self.traces_evicted,
                "evicted_spans": self.spans_evicted,
            }

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def to_dicts(self, since: int | None = None) -> list[dict[str, Any]]:
        return [t.to_dict() for t in self.traces(since)]

    def to_chrome(self, since: int | None = None) -> dict[str, Any]:
        """One Perfetto-loadable document; each trace its own track."""
        events: list[dict[str, Any]] = []
        for tid, trace in enumerate(self.traces(since), start=1):
            events.extend(trace.to_chrome_events(tid=tid))
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: process-global ring; each worker passes its own to finish()
TRACE_RING = TraceRing()


def job_trace(job: dict[str, Any] | None) -> JobTrace | None:
    """The trace riding ``job`` (or a result envelope), if any."""
    if not isinstance(job, dict):
        return None
    trace = job.get(TRACE_KEY)
    return trace if isinstance(trace, JobTrace) else None


def attach(job: dict[str, Any], trace: JobTrace) -> None:
    job[TRACE_KEY] = trace


def detach(job: dict[str, Any] | None) -> JobTrace | None:
    """Pop the trace off a job/result dict (before kwargs formatting or
    JSON serialization)."""
    if not isinstance(job, dict):
        return None
    trace = job.pop(TRACE_KEY, None)
    return trace if isinstance(trace, JobTrace) else None


def unbind() -> None:
    """Drop the ambient span of the current context: a thread started in a
    copy of a job's context (a lane) outlives that job."""
    _CURRENT.set(None)


@contextlib.contextmanager
def activate(trace: JobTrace | None) -> Iterator[JobTrace | None]:
    """``trace.active()`` that tolerates None (jobs without traces —
    directly-injected test jobs, replayed dead letters)."""
    if trace is None:
        yield None
        return
    with trace.active():
        yield trace
