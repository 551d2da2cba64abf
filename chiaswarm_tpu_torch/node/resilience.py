"""Failure classification, backoff, circuit breakers and result durability:
a copy of ``chiaswarm_tpu/node/resilience.py`` (``classify_exception``
:131, ``classify_result`` :211, ``backoff_delay`` :234, ``Backoff`` :248,
``CircuitBreaker`` :279, ``BreakerBoard`` :343, ``hive_reachable_error``
:521, ``HiveSession`` :532, ``DeadLetterSpool`` :619, ``CheckpointSpool``
:682-811, ``checkpoint_scope`` :822, ``phase_checkpoint`` :837,
``ResilienceStats`` :893-941), the degradation ladder of the worker
(``node/worker.py``):

- :func:`classify_exception` / :func:`classify_result` sort failures into
  kinds: ``transient`` and ``oom`` retry locally with capped backoff (an
  OOM'd burst also splits and re-runs serially), ``fatal`` input errors
  upload at once and are never retried, ``model``/``timeout``/``error``
  feed the breaker.
- :class:`BreakerBoard` keeps one :class:`CircuitBreaker` per model;
  ``BREAKER_KINDS`` failures in a row quarantine the model, and after a
  cooldown one half-open probe may close it again. Its state file keeps
  the JAX format, so open breakers pass between the two workers.
- :class:`Backoff` / :func:`backoff_delay`: capped exponential backoff with
  seeded equal jitter, for the poll loop, the retry ladder and uploads.
- :class:`HiveSession` names the hive's reachability (online / outage).
- :class:`DeadLetterSpool` keeps result envelopes that exhausted their
  upload retries on disk, one JSON file each in the JAX format; the worker
  replays them on its next start.
- :class:`CheckpointSpool` keeps each in-flight job's latest resume state
  on disk, one JSON file per hive job id, named as JAX names it (the same
  file for the same id); lanes write it at step boundaries, the solo path
  records phase markers through :func:`phase_checkpoint` inside the
  executor's :func:`checkpoint_scope`, and the worker's heartbeat pushes
  each changed file to a lease-aware hive. Durability never fails the job:
  a write that raises ``OSError`` is logged and the job runs on.

Stdlib only and synchronous.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import logging
import random
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable

log = logging.getLogger("chiaswarm_torch.resilience")

#: kinds worth a local retry (the degradation ladder)
RETRYABLE_KINDS = frozenset({"transient", "oom"})

#: kinds that count as a model-level failure toward its circuit breaker
BREAKER_KINDS = frozenset({"model_unavailable", "timeout", "error", "oom",
                           "invalid_output"})

#: kinds a lease-aware hive redispatches to another worker
REDISPATCH_KINDS = frozenset({"model_unavailable", "quarantined",
                              "overloaded", "invalid_output"})

#: kinds whose error envelopes upload WITHOUT the fatal flag
NONFATAL_KINDS = RETRYABLE_KINDS | REDISPATCH_KINDS | frozenset(
    {"bad_asset"})

_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Allocation failure",
)

# exception type names (matched across the MRO, so library subclasses
# match without importing them) that mean "the outside world hiccuped"
_TRANSIENT_TYPE_NAMES = frozenset({
    "ConnectionError",
    "ConnectionResetError",
    "ConnectionAbortedError",
    "ConnectionRefusedError",
    "BrokenPipeError",
    "ConnectTimeout",
    "ReadTimeout",
    "Timeout",
    "TimeoutError",
    "ChunkedEncodingError",
    "ContentDecodingError",
    "SSLError",
    "ProxyError",
    "ServerDisconnectedError",
    "ClientConnectorError",
    "ClientOSError",
    "StepHung",
    "LaneHung",
})


class BadAssetError(ValueError):
    """An input asset violated the trust-boundary guards (size, content
    type, decoded dimensions). A ValueError, but classified as the
    non-fatal ``bad_asset`` kind."""


_MODEL_UNAVAILABLE_MARKERS = (
    "is not available on this node",
    "quarantined",
)


def classify_exception(exc: BaseException) -> str:
    """Sort an exception into ``oom`` / ``model_unavailable`` /
    ``invalid_output`` / ``bad_asset`` / ``transient`` / ``fatal`` /
    ``error`` (the JAX package's order of tests)."""
    text = f"{type(exc).__name__}: {exc}"
    if any(marker in text for marker in _OOM_MARKERS):
        return "oom"
    if any(marker in str(exc) for marker in _MODEL_UNAVAILABLE_MARKERS):
        return "model_unavailable"
    names = {cls.__name__ for cls in type(exc).__mro__}
    if "InvalidOutput" in names:
        return "invalid_output"
    if "BadAssetError" in names:
        return "bad_asset"
    if "HTTPError" in names:
        # the status class decides: 5xx is the server's bad day (retry),
        # 4xx a request no node can make good. ``requests`` attaches a
        # response; ``urllib.error.HTTPError`` carries ``.code`` and its
        # text starts "HTTP Error 503"; else the message's leading status
        status = getattr(getattr(exc, "response", None), "status_code", None)
        if status is None and isinstance(getattr(exc, "code", None), int):
            status = exc.code
        if status is None:
            match = re.match(r"\s*(\d{3})\b", str(exc))
            status = int(match.group(1)) if match else None
        if status is None:
            return "error"
        return "transient" if 500 <= status <= 599 else "fatal"
    if names & _TRANSIENT_TYPE_NAMES:
        return "transient"
    if isinstance(exc, (TimeoutError, OSError)):
        return "transient"
    if isinstance(exc, ValueError):
        return "fatal"
    return "error"


def classify_result(result: dict[str, Any] | None) -> str:
    """Kind of a finished result envelope: ``ok`` or a failure kind.

    The executor stamps ``pipeline_config["error_kind"]`` on every error
    envelope it builds (node/executor.py); envelopes from older nodes or
    test stubs that lack the stamp fall back to the fatal flag.
    """
    if not isinstance(result, dict):
        return "error"
    config = result.get("pipeline_config") or {}
    if not isinstance(config, dict) or "error" not in config:
        return "ok"
    kind = config.get("error_kind")
    if kind:
        return str(kind)
    return "fatal" if result.get("fatal_error") else "error"


# ---------------------------------------------------------------------------
# backoff
# ---------------------------------------------------------------------------


def backoff_delay(attempt: int, base: float, cap: float,
                  rng: random.Random | None = None) -> float:
    """Capped exponential backoff with equal jitter for ``attempt`` >= 1.

    ``min(cap, base * 2**(attempt-1))``, half fixed + half uniformly
    jittered, so synchronized failures across a fleet decorrelate but the
    delay never collapses to ~0 (which would hammer a struggling hive).
    """
    span = min(float(cap), float(base) * (2.0 ** max(0, int(attempt) - 1)))
    if rng is None:
        return span
    return span / 2.0 + rng.uniform(0.0, span / 2.0)


class Backoff:
    """Stateful capped-exponential backoff with deterministic jitter.

    ``next()`` grows the delay; ``reset()`` (called on the first success)
    snaps back to the base. Seeding by worker name keeps a node's schedule
    reproducible (chaos tests) while decorrelating nodes from each other.
    """

    def __init__(self, base: float, cap: float, seed: Any = None) -> None:
        self.base = float(base)
        self.cap = float(cap)
        self._rng = random.Random(seed)
        self._failures = 0

    def next(self) -> float:
        self._failures += 1
        return backoff_delay(self._failures, self.base, self.cap, self._rng)

    def reset(self) -> None:
        self._failures = 0

    @property
    def failures(self) -> int:
        return self._failures


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """closed -> open after ``threshold`` consecutive failures; after
    ``cooldown_s`` exactly ONE half-open probe is admitted at a time —
    its success closes the breaker, its failure re-opens (and re-arms the
    cooldown), and an inconclusive outcome (the probe died of something
    that says nothing about the model, e.g. bad user inputs) releases the
    probe slot so the next job probes again."""

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "closed"
        self.failures = 0
        self._opened_at = 0.0
        self._probing = False

    def allow(self) -> bool:
        """May a job for this model run now? Transitions open->half_open
        when the cooldown has elapsed (the caller should un-quarantine the
        model before dispatching the probe). In half_open only one probe
        is in flight at a time — a queued backlog must not stampede a
        likely-broken checkpoint the moment the cooldown expires."""
        if self.state == "open":
            if self._clock() - self._opened_at >= self.cooldown_s:
                self.state = "half_open"
                self._probing = True
                return True
            return False
        if self.state == "half_open":
            if self._probing:
                return False
            self._probing = True
            return True
        return True

    def record(self, ok: bool) -> str | None:
        """Record an outcome; returns ``"opened"``/``"closed"`` on a state
        transition the caller must mirror (registry quarantine), else
        None."""
        self._probing = False
        if ok:
            was = self.state
            self.failures = 0
            self.state = "closed"
            return "closed" if was != "closed" else None
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self._opened_at = self._clock()
            return "opened"
        return None

    def release_probe(self) -> None:
        """The in-flight half-open probe ended without a verdict on the
        model; free the slot so the next job may probe."""
        self._probing = False

    def snapshot(self) -> dict[str, Any]:
        return {"state": self.state,
                "consecutive_failures": self.failures}


class BreakerBoard:
    """Per-model circuit breakers with registry-mirroring callbacks.

    ``on_open(model)`` fires when a breaker opens (quarantine the model),
    ``on_close(model)`` when it closes after a successful probe, and
    ``on_probe(model)`` when a half-open probe is about to dispatch (the
    registry must accept the load again or the probe can never succeed).
    Callbacks may be None (test stubs without a real registry).

    ``persist_path`` makes open breakers survive restarts : every open/close transition serializes the non-closed
    breakers to one JSON file next to the dead-letter spool, storing the
    REMAINING cooldown (the monotonic clock does not survive a
    restart); loading re-opens them, re-arms the residual cooldown, and
    re-mirrors the quarantine — a checkpoint that broke the node five
    minutes before a crash is still quarantined when it comes back.
    """

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Callable[[str], Any] | None = None,
                 on_close: Callable[[str], Any] | None = None,
                 on_probe: Callable[[str], Any] | None = None,
                 persist_path: Path | str | None = None) -> None:
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}
        self._on_open = on_open
        self._on_close = on_close
        self._on_probe = on_probe
        self._persist_path = (None if persist_path is None
                              else Path(persist_path))
        if self._persist_path is not None:
            self._load()

    @staticmethod
    def _notify(callback: Callable[[str], Any] | None, model: str) -> None:
        if callback is None:
            return
        try:
            callback(model)
        except Exception:  # a mirror must never break dispatch
            log.exception("breaker callback failed for %s", model)

    def allow(self, model: str) -> bool:
        breaker = self._breakers.get(model)
        if breaker is None:
            return True
        was_open = breaker.state == "open"
        allowed = breaker.allow()
        if allowed and was_open:  # open -> half_open: let the probe load
            log.warning("breaker for %s half-open: dispatching one probe",
                        model)
            self._notify(self._on_probe, model)
        return allowed

    def record(self, model: str, ok: bool) -> None:
        breaker = self._breakers.get(model)
        if breaker is None:
            if ok:
                return  # never-failed models stay untracked
            breaker = self._breakers[model] = CircuitBreaker(
                self.threshold, self.cooldown_s, self._clock)
        transition = breaker.record(ok)
        if transition == "opened":
            log.error("breaker OPEN for %s after %d consecutive failures; "
                      "quarantining for %.0fs", model, breaker.failures,
                      self.cooldown_s)
            self._notify(self._on_open, model)
        elif transition == "closed":
            log.info("breaker closed for %s (probe succeeded)", model)
            self._notify(self._on_close, model)
        if transition is not None:
            self._persist()

    def record_inconclusive(self, model: str) -> None:
        """The job's failure says nothing about the model (bad user
        inputs, network blip): don't move the breaker, but release the
        half-open probe slot so another job may probe — otherwise an
        inconclusive probe would leave the breaker stuck half-open."""
        breaker = self._breakers.get(model)
        if breaker is not None:
            breaker.release_probe()

    def states(self) -> dict[str, dict[str, Any]]:
        return {model: breaker.snapshot()
                for model, breaker in self._breakers.items()}

    def open_models(self) -> list[str]:
        return [m for m, b in self._breakers.items() if b.state == "open"]

    # ---- persistence across restarts ----

    def save(self) -> None:
        """Re-serialize now (worker shutdown): transitions persist
        eagerly, but a clean stop refreshes the REMAINING cooldowns so
        a long-lived open breaker doesn't re-arm its full window on the
        next start."""
        self._persist()

    def dump(self) -> dict[str, Any]:
        """Serializable view of the non-closed breakers. Half-open is
        stored as open with zero remaining cooldown: a restart aborts
        any in-flight probe, so the next allow() re-probes cleanly."""
        now = self._clock()
        out: dict[str, Any] = {}
        for model, breaker in self._breakers.items():
            if breaker.state == "closed":
                continue
            if breaker.state == "half_open":
                remaining = 0.0
            else:
                remaining = max(0.0, self.cooldown_s
                                - (now - breaker._opened_at))
            out[model] = {
                "state": "open",
                "consecutive_failures": int(breaker.failures),
                "cooldown_remaining_s": round(remaining, 3),
            }
        return out

    def _persist(self) -> None:
        if self._persist_path is None:
            return
        try:
            data = self.dump()
            path = self._persist_path
            if not data:
                path.unlink(missing_ok=True)
                return
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(path.suffix + ".tmp")
            tmp.write_text(json.dumps({"version": 1, "breakers": data},
                                      sort_keys=True), encoding="utf-8")
            tmp.replace(path)
        except OSError as exc:  # persistence must never break dispatch
            log.warning("breaker-state persist to %s failed: %s",
                        self._persist_path, exc)

    def _load(self) -> None:
        path = self._persist_path
        if path is None or not path.is_file():
            return
        try:
            payload = json.loads(path.read_text(encoding="utf-8"))
            entries = dict(payload.get("breakers") or {})
        except (OSError, json.JSONDecodeError, AttributeError) as exc:
            log.error("unreadable breaker-state file %s (%s); starting "
                      "with closed breakers", path, exc)
            return
        now = self._clock()
        for model, entry in entries.items():
            try:
                remaining = max(0.0, min(
                    self.cooldown_s,
                    float(entry.get("cooldown_remaining_s", 0.0))))
                failures = max(self.threshold,
                               int(entry.get("consecutive_failures", 0)))
            except (TypeError, ValueError):
                continue
            breaker = CircuitBreaker(self.threshold, self.cooldown_s,
                                     self._clock)
            breaker.state = "open"
            breaker.failures = failures
            breaker._opened_at = now - (self.cooldown_s - remaining)
            self._breakers[str(model)] = breaker
            log.warning("breaker for %s restored OPEN from %s "
                        "(%.0fs cooldown remaining)", model, path,
                        remaining)
            self._notify(self._on_open, str(model))


# ---------------------------------------------------------------------------
# hive session
# ---------------------------------------------------------------------------


def hive_reachable_error(exc: BaseException) -> bool:
    """True when the error PROVES the hive answered: an HTTP 4xx client
    response (aiohttp sets ``.status``). A reachable hive rejecting a
    request is a protocol problem, not an outage — it must neither grow
    the outage streak (a reference hive 404ing heartbeats would
    otherwise flip the session while polls succeed) nor count as a
    healing success (nothing healed)."""
    status = getattr(exc, "status", None)
    return isinstance(status, int) and 400 <= status < 500


class HiveSession:
    """The worker's view of hive reachability: ONLINE until
    ``outage_after`` consecutive poll/upload/heartbeat failures flip it
    to OUTAGE, and back on the first success ("healed").

    Ride-through semantics the worker attaches to the flip
    (node/worker.py): leases are ASSUMED LOST (a dead hive cannot
    extend them; a journaled hive's recovery voids them anyway),
    in-flight work runs to completion, results spool to the
    DeadLetterSpool after a single upload attempt, and the heal
    triggers a LIVE spool replay — paid chip time rides out the outage
    and lands the moment the hive is back. The capped poll backoff
    already paces the probing; this class only names the state
    so the ladder, the spool, and the operator signals agree on it.

    Stdlib-only and synchronous like the rest of this module.
    """

    def __init__(self, *, outage_after: int = 3,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "") -> None:
        self.outage_after = max(1, int(outage_after))
        self._clock = clock
        # a multiplexed worker holds one session PER HIVE SHARD — the
        # label tells them apart (empty for the single-hive worker)
        self.name = str(name)
        self.state = "online"
        self.consecutive_failures = 0
        self.outages = 0
        self.outage_started_at: float | None = None
        self.last_outage_s = 0.0
        self.last_failure_source = ""

    @property
    def in_outage(self) -> bool:
        return self.state == "outage"

    def note_failure(self, source: str = "poll") -> bool:
        """Record one hive-unreachable failure; True exactly when this
        one flipped the session into OUTAGE (the caller logs and counts
        the assumed-lost leases once, not per failure)."""
        self.consecutive_failures += 1
        self.last_failure_source = str(source)
        if self.state == "online" \
                and self.consecutive_failures >= self.outage_after:
            self.state = "outage"
            self.outages += 1
            self.outage_started_at = self._clock()
            return True
        return False

    def note_success(self) -> bool:
        """Record one successful hive exchange; True exactly when it
        HEALED an outage (the caller replays the dead-letter spool)."""
        self.consecutive_failures = 0
        if self.state != "outage":
            return False
        self.state = "online"
        if self.outage_started_at is not None:
            self.last_outage_s = max(
                0.0, self._clock() - self.outage_started_at)
        self.outage_started_at = None
        return True

    def snapshot(self) -> dict[str, Any]:
        out = {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "outages": self.outages,
            "last_outage_s": round(self.last_outage_s, 3),
            "last_failure_source": self.last_failure_source,
        }
        if self.name:
            out["name"] = self.name
        if self.outage_started_at is not None:
            out["outage_age_s"] = round(
                max(0.0, self._clock() - self.outage_started_at), 3)
        return out


# ---------------------------------------------------------------------------
# dead-letter spool
# ---------------------------------------------------------------------------


class DeadLetterSpool:
    """Disk spool for result envelopes whose uploads exhausted retries.

    One JSON file per envelope, named ``<job id>-<content hash>.json`` so
    re-spooling the same envelope is idempotent; the tmp-then-rename write
    keeps a crash mid-spool from leaving a half file that replay would
    then misparse. ``replay()`` yields everything spooled so the worker
    can re-queue it at startup (result durability across restarts)."""

    def __init__(self, directory: Path | str) -> None:
        self.directory = Path(directory)

    def _path_for(self, result: dict[str, Any], payload: str) -> Path:
        digest = hashlib.sha256(payload.encode("utf-8")).hexdigest()[:12]
        job_id = re.sub(r"[^A-Za-z0-9._-]+", "_",
                        str(result.get("id") or "result"))[:80]
        return self.directory / f"{job_id}-{digest}.json"

    def spool(self, result: dict[str, Any]) -> Path:
        payload = json.dumps(result, sort_keys=True)
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path_for(result, payload)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(payload, encoding="utf-8")
        tmp.replace(path)
        log.error("result %s spooled to dead-letter: %s",
                  result.get("id"), path)
        return path

    def replay(self) -> list[tuple[Path, dict[str, Any]]]:
        if not self.directory.is_dir():
            return []
        entries: list[tuple[Path, dict[str, Any]]] = []
        for path in sorted(self.directory.glob("*.json")):
            try:
                entries.append((path, json.loads(
                    path.read_text(encoding="utf-8"))))
            except (OSError, json.JSONDecodeError) as exc:
                log.error("unreadable dead-letter file %s (%s); parking as "
                          ".bad", path, exc)
                try:
                    path.replace(path.with_suffix(".json.bad"))
                except OSError:
                    pass
        return entries

    def discard(self, path: Path | str) -> None:
        try:
            Path(path).unlink()
        except FileNotFoundError:
            pass

    def depth(self) -> int:
        if not self.directory.is_dir():
            return 0
        return sum(1 for _ in self.directory.glob("*.json"))


# ---------------------------------------------------------------------------
# checkpoint spool (step-boundary resume state)
# ---------------------------------------------------------------------------


class CheckpointSpool:
    """Disk spool of in-flight job checkpoints, the resume-state twin of the
    dead-letter spool, namespaced per worker the same way.

    One JSON file per job id, overwritten as the job progresses (lanes
    snapshot their rows at step boundaries, ``serving/stepper.py``; the solo
    path records coarser phase markers). The worker's heartbeat pushes the
    latest state to a lease-aware hive, so a job redelivered after this
    worker dies resumes at its step on a survivor instead of at step 0.

    - files live under ``<root>/checkpoints/<worker name>/``: workers sharing
      a settings root never read or collect each other's state;
    - a corrupt snapshot is skipped loudly: parked as ``.bad``, counted in
      ``corrupt_skipped``, never returned;
    - a job's checkpoint goes when its upload is acked
      (``node/worker.py::_deliver``), and startup clears leftovers: after a
      restart the hive's pushed copy is the authority.

    Thread-safe: lane threads save while the heartbeat's thread loads.
    """

    def __init__(self, directory: Path | str) -> None:
        self.directory = Path(directory)
        self._lock = threading.Lock()
        self.written = 0
        self.corrupt_skipped = 0
        # per-job write sequence (file name -> self.written at its last
        # save): the heartbeat's has-it-changed probe (an mtime can repeat
        # across saves on a coarse clock)
        self._versions: dict[str, int] = {}

    def _path_for(self, job_id: Any) -> Path:
        # a digest of the full id: sanitizing alone would let "job 1" and
        # "job_1" share a file, and one job resume the other's trajectory
        raw = str(job_id or "job")
        digest = hashlib.sha256(raw.encode("utf-8")).hexdigest()[:12]
        name = re.sub(r"[^A-Za-z0-9._-]+", "_", raw)[:80]
        return self.directory / f"{name}-{digest}.ckpt.json"

    def save(self, job_id: Any, state: dict[str, Any]) -> Path:
        payload = json.dumps(state, sort_keys=True)
        path = self._path_for(job_id)
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(payload, encoding="utf-8")
        tmp.replace(path)
        with self._lock:
            self.written += 1
            self._versions[path.name] = self.written
        return path

    def load(self, job_id: Any) -> dict[str, Any] | None:
        path = self._path_for(job_id)
        if not path.is_file():
            return None
        try:
            return json.loads(path.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError) as exc:
            log.error("corrupt checkpoint %s (%s); parking as .bad: the job "
                      "restarts from scratch", path, exc)
            with self._lock:
                self.corrupt_skipped += 1
            try:
                path.replace(path.with_suffix(".json.bad"))
            except OSError:
                pass
            return None

    def version(self, job_id: Any) -> int | None:
        """Monotone write sequence of a job's checkpoint, or None if absent;
        a file this process never wrote (an external ``checkpoint_dir``)
        reports 0, which still reads as present."""
        path = self._path_for(job_id)
        with self._lock:
            seq = self._versions.get(path.name)
        if seq is not None:
            return seq
        return 0 if path.is_file() else None

    def discard(self, job_id: Any) -> None:
        """The job settled: its resume state is garbage."""
        path = self._path_for(job_id)
        with self._lock:
            self._versions.pop(path.name, None)
        try:
            path.unlink()
        except FileNotFoundError:
            pass
        except OSError as exc:
            log.warning("checkpoint GC for %s failed: %s", job_id, exc)

    def clear(self) -> int:
        """Startup: drop every leftover checkpoint, parked ``.bad`` files and
        orphaned ``.tmp`` files of a crash mid-save included."""
        with self._lock:
            self._versions.clear()
        if not self.directory.is_dir():
            return 0
        removed = 0
        for path in self.directory.glob("*.ckpt.json*"):
            try:
                path.unlink()
                removed += 1
            except OSError:
                pass
        if removed:
            log.info("cleared %d stale checkpoint(s) from %s", removed,
                     self.directory)
        return removed

    def depth(self) -> int:
        if not self.directory.is_dir():
            return 0
        return sum(1 for _ in self.directory.glob("*.ckpt.json"))


# the executor binds (spool, job id) for one job's run so workload callbacks
# can record phase checkpoints without threading the spool through them
_CKPT_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "chiaswarm_torch_checkpoint_scope", default=None)


@contextlib.contextmanager
def checkpoint_scope(spool: CheckpointSpool | None, job_id: Any):
    """Bind :func:`phase_checkpoint` to (spool, job_id) for this thread's
    run of one job (``node/executor.py``). With no spool (heartbeats off)
    the scope, and every ``phase_checkpoint`` inside it, does nothing."""
    if spool is None or job_id is None:
        yield
        return
    token = _CKPT_SCOPE.set((spool, job_id))
    try:
        yield
    finally:
        _CKPT_SCOPE.reset(token)


def phase_checkpoint(phase: str, **extra: Any) -> None:
    """Record a coarse phase boundary of the current solo-path job
    (``encoded``, ``denoised``; ``workloads/diffusion.py``): the solo loop
    keeps no step state to resume from, so the marker tells the hive how far
    a job that died got."""
    scope = _CKPT_SCOPE.get()
    if scope is None:
        return
    spool, job_id = scope
    try:
        spool.save(job_id, {"version": 1, "kind": "phase",
                            "phase": str(phase), **extra})
    except OSError as exc:  # durability must never fail the job
        log.warning("phase checkpoint %r for %s failed: %s", phase,
                    job_id, exc)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


_STAT_HELP = {
    "jobs_failed": "jobs whose final envelope was a failure",
    "jobs_timed_out": "jobs that exceeded their execution deadline",
    "jobs_retried": "solo re-runs taken by the degradation ladder",
    "jobs_quarantined": "jobs refused by an open circuit breaker",
    "upload_retries": "result-upload attempts that failed and retried",
    "results_dead_lettered": "results spooled after exhausting uploads",
    "results_replayed": "dead-letter results replayed at startup",
    "lease_heartbeats": "heartbeats delivered to a lease-aware hive",
    "leases_lost": "in-flight jobs whose lease the hive reassigned",
    # overload control (the JAX node/overload.py): sheds and
    # backpressure waits are capacity decisions, counted DISTINCTLY
    # from failures — a shed job is redispatchable work this node
    # declined, not work it broke
    "jobs_shed": "jobs shed by deadline-aware admission control "
                 "(overloaded, redispatched by a lease-aware hive)",
    "polls_backpressured": "poll-loop waits inserted by queue-depth "
                           "backpressure before over-committing",
    # hive-outage ride-through: state the
    # worker keeps while the hive is DOWN, distinct from per-request
    # failures — an outage is one incident however many polls it eats
    "hive_outages": "consecutive-failure streaks that flipped the hive "
                    "session into OUTAGE ride-through",
    "leases_assumed_lost": "in-flight leases written off when the hive "
                           "session flipped to OUTAGE (work rides "
                           "through; results spool and replay on heal)",
    "hive_epoch_changes": "hive epoch bumps observed on grants or "
                          "heartbeat acks (the hive recovered from its "
                          "journal since we last spoke)",
}


def _stat_property(name: str):
    def get(self: "ResilienceStats") -> int:
        return int(self._counters[name].value())

    def set_(self: "ResilienceStats", value: int) -> None:
        # the worker's idiom is `stats.field += 1`; counters stay
        # monotonic because the read-modify-write only ever grows
        counter = self._counters[name]
        counter.inc(max(0, int(value) - int(counter.value())))

    return property(get, set_, doc=_STAT_HELP[name])


class ResilienceStats:
    """Worker-level failure counters on the metrics registry
    (``obs/metrics.py``): each field IS a registry counter
    (``chiaswarm_<field>_total`` on the worker's /metrics), and
    ``snapshot()`` keeps the original /healthz JSON keys as a
    read-through view. The ``stats.field += 1`` call sites are
    unchanged — the properties forward to the counters."""

    _FIELDS = tuple(_STAT_HELP)

    jobs_failed = _stat_property("jobs_failed")
    jobs_timed_out = _stat_property("jobs_timed_out")
    jobs_retried = _stat_property("jobs_retried")
    jobs_quarantined = _stat_property("jobs_quarantined")
    upload_retries = _stat_property("upload_retries")
    results_dead_lettered = _stat_property("results_dead_lettered")
    results_replayed = _stat_property("results_replayed")
    lease_heartbeats = _stat_property("lease_heartbeats")
    leases_lost = _stat_property("leases_lost")
    jobs_shed = _stat_property("jobs_shed")
    polls_backpressured = _stat_property("polls_backpressured")
    hive_outages = _stat_property("hive_outages")
    leases_assumed_lost = _stat_property("leases_assumed_lost")
    hive_epoch_changes = _stat_property("hive_epoch_changes")

    def __init__(self, registry: Any = None) -> None:
        from chiaswarm_tpu_torch.obs.metrics import Registry

        self.registry = registry if registry is not None else Registry()
        self._counters = {
            name: self.registry.counter(f"chiaswarm_{name}_total", help_)
            for name, help_ in _STAT_HELP.items()
        }

    def snapshot(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in self._FIELDS}
