"""The gray-failure guard: a copy of ``chiaswarm_tpu/serving/guard.py``
(``StepHung`` :108, ``LaneHung`` :115, ``InvalidOutput`` :127, the budgets
and the measured suggestion :134-250, ``Watchdog``/``WATCHDOG`` :256-326, the flush epoch :328-347,
``_slot_devices`` :350, ``watch_solo`` :361, ``screen_images`` :427, the
chaos seams :459-540, ``HEAL_RUNGS``/``HealAction``/``DeviceGuard``
:547-758), with the same knobs and defaults.

A card that degrades without dying is caught three ways:

- **The hang watchdog.** One monitor thread (:data:`WATCHDOG`) arms a
  wall-clock budget around each lane step, the depth-2 window's
  ``event.synchronize()`` included (``serving/stepper.py``), and around
  each watched solo denoise (:func:`watch_solo`). A lane step past its
  budget condemns the lane from the monitor thread; its rows resume at
  their last step-boundary checkpoint in a fresh lane. A solo call past
  its budget raises :class:`StepHung` once it returns (``transient``: the
  worker's retry ladder re-runs the job).
- **Output validation.** A per-row finite check rides the lanes'
  checkpoint copy to the host, and :func:`screen_images` screens decoded
  frames: a poisoned job retires alone with a non-fatal
  ``invalid_output`` envelope.
- **The device-health ledger** (:class:`DeviceGuard`): hangs, slow steps
  and invalid outputs grow a per-device streak; rungs escalate through
  ``cache_flush``, ``device_quarantine`` and ``restart`` (the worker's
  graceful drain, exit code :data:`GUARD_RESTART_EXIT_CODE`).

What is the port's own: devices are labelled ``str(torch.device)`` and
de-duplicated, so a one-card ``seq = 4`` mesh (``cuda:0`` four times) is one
device. The ``cache_flush`` rung has no executable cache to drop here
(``node/worker.py``). :func:`suggest_hang_budget` (:187-250) reads the
lanes' step-seconds histogram (``serving/stepper.py``) for the measured
knobs ``/healthz`` shows beside the priors.

Knobs (env): ``CHIASWARM_GUARD=0`` disables the watchdog and validation;
``CHIASWARM_GUARD_HANG_FACTOR`` (20), ``_HANG_FLOOR_S`` (30), ``_HANG_CEIL_S``
(600, also the cold budget of a lane's first dispatch at a width),
``_SLOW_FACTOR`` (4). Chaos seams: ``CHIASWARM_CHAOS_WEDGE_STEP="N:S"`` (a
host sleep of S seconds inside lane step N's armed window, one shot
process-wide), ``CHIASWARM_CHAOS_SLOW_STEP="M"`` (every lane step stretched
to ~M x its time), ``CHIASWARM_CHAOS_NAN_STEP="T:R"`` (lane row R poisoned
with NaN at or after step T, one shot). Steps count from the dispatch at
which a lane first saw the plan. Stdlib and numpy only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np

from chiaswarm_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("chiaswarm_torch.guard")

#: exit code of a guard-requested restart, after the graceful drain
GUARD_RESTART_EXIT_CODE = 73

ENV_ENABLE = "CHIASWARM_GUARD"
ENV_HANG_FACTOR = "CHIASWARM_GUARD_HANG_FACTOR"
ENV_HANG_FLOOR = "CHIASWARM_GUARD_HANG_FLOOR_S"
ENV_HANG_CEIL = "CHIASWARM_GUARD_HANG_CEIL_S"
ENV_SLOW_FACTOR = "CHIASWARM_GUARD_SLOW_FACTOR"

ENV_CHAOS_WEDGE = "CHIASWARM_CHAOS_WEDGE_STEP"
ENV_CHAOS_SLOW = "CHIASWARM_CHAOS_SLOW_STEP"
ENV_CHAOS_NAN = "CHIASWARM_CHAOS_NAN_STEP"


# ---- failure vocabulary ----


class StepHung(RuntimeError):
    """A watched solo phase outlived its hang budget. Raised after the
    call returns (a blocked thread cannot be interrupted) and classified
    ``transient``, so the retry ladder re-runs the job."""


class LaneHung(RuntimeError):
    """A condemned lane failed this job's rows. ``resume`` carries the last
    in-memory step-boundary checkpoint, or None; the executor re-admits
    the job to a fresh lane, resuming there when it has one."""

    def __init__(self, message: str,
                 resume: dict[str, Any] | None = None) -> None:
        super().__init__(message)
        self.resume = resume


class InvalidOutput(RuntimeError):
    """A row's trajectory is numerically poisoned (non-finite latents or a
    constant decoded frame). The job retires with a non-fatal
    ``invalid_output`` envelope, never an uploaded garbage image."""


def watchdog_enabled() -> bool:
    """The guard is on by default; ``CHIASWARM_GUARD=0`` turns it off."""
    return os.environ.get(ENV_ENABLE, "").strip().lower() not in (
        "0", "false", "off", "no")


def validation_enabled() -> bool:
    return watchdog_enabled()


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def hang_budget_s(step_ewma: float) -> float:
    """Budget of one lane step: ``factor x`` the step-seconds EWMA, clamped
    to [floor, ceiling]; the ceiling while there is no EWMA yet."""
    factor = _env_float(ENV_HANG_FACTOR, 20.0)
    floor = _env_float(ENV_HANG_FLOOR, 30.0)
    ceil = max(floor, _env_float(ENV_HANG_CEIL, 600.0))
    if step_ewma <= 0.0:
        return ceil
    return min(ceil, max(floor, factor * float(step_ewma)))


def solo_hang_budget_s(step_ewma: float, steps: int) -> float | None:
    """Budget of a whole solo denoise (``steps`` x the lane step EWMA x
    factor, clamped); None, never armed, without an EWMA or a step
    count."""
    if step_ewma <= 0.0 or int(steps or 0) <= 0:
        return None
    factor = _env_float(ENV_HANG_FACTOR, 20.0)
    floor = _env_float(ENV_HANG_FLOOR, 30.0)
    ceil = max(floor, _env_float(ENV_HANG_CEIL, 600.0))
    return min(ceil, max(floor, factor * float(step_ewma) * int(steps)))


def slow_factor() -> float:
    return max(1.0, _env_float(ENV_SLOW_FACTOR, 4.0))


#: step-seconds observations before a hang-budget suggestion is called
#: measured: below this the histogram is warm-up noise
SUGGEST_MIN_SAMPLES = 32


def suggest_hang_budget(histogram: Any = None, *,
                        min_samples: int = SUGGEST_MIN_SAMPLES) -> dict:
    """The watchdog knobs suggested by the live step-seconds histogram
    (``chiaswarm_stepper_step_seconds`` on the process registry), beside
    the current ones (the priors: factor 20, floor 30 s, ceiling 600 s):

    - ``factor``  = 4x the measured p99/p50 dispersion, clamped to [4, 20];
    - ``floor_s`` = 20x p99, at least 1 s;
    - ``ceil_s``  = 200x p99 bounded to [60 s, the configured ceiling]
      (a lane's first dispatch at a width runs under the ceiling alone, so
      the ceiling need not cover warm-up).

    ``{"measured": False, "samples": n, ...}`` until ``min_samples``
    observations exist."""
    if histogram is None:
        histogram = obs_metrics.REGISTRY.get("chiaswarm_stepper_step_seconds")
    current = {
        "factor": _env_float(ENV_HANG_FACTOR, 20.0),
        "floor_s": _env_float(ENV_HANG_FLOOR, 30.0),
        "ceil_s": max(_env_float(ENV_HANG_FLOOR, 30.0),
                      _env_float(ENV_HANG_CEIL, 600.0)),
    }
    samples = histogram.count() if histogram is not None else 0
    if histogram is None or samples < min_samples:
        return {"measured": False, "samples": int(samples),
                "min_samples": int(min_samples), "current": current}
    p50 = histogram.percentile(0.5)
    p99 = histogram.percentile(0.99)
    if not p50 or not p99:
        return {"measured": False, "samples": int(samples),
                "min_samples": int(min_samples), "current": current}
    dispersion = max(1.0, p99 / p50)
    factor = min(20.0, max(4.0, 4.0 * dispersion))
    floor_s = max(1.0, 20.0 * p99)
    ceil_s = min(current["ceil_s"], max(60.0, 200.0 * p99))
    return {
        "measured": True,
        "samples": int(samples),
        "p50_s": round(p50, 6),
        "p99_s": round(p99, 6),
        "suggested": {
            "factor": round(factor, 2),
            "floor_s": round(floor_s, 3),
            "ceil_s": round(max(ceil_s, floor_s), 3),
        },
        "current": current,
    }


# ---- the watchdog monitor thread ----


@dataclasses.dataclass
class _Armed:
    deadline: float
    on_hang: Callable[[], None]
    tag: str
    fired: bool = False


class Watchdog:
    """One monitor thread declaring in-flight calls hung.

    ``arm(budget, on_hang)`` registers a deadline; ``disarm(ticket)``
    withdraws it and reports whether it fired. A disarmed ticket never
    fires afterwards, and a fired one reports True to its disarmer.
    ``on_hang`` runs in the monitor thread and must never wait on the
    device: the wedged call is what it cannot wait on."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._armed: dict[int, _Armed] = {}
        self._ids = itertools.count(1)
        self._thread: threading.Thread | None = None

    def arm(self, budget_s: float, on_hang: Callable[[], None],
            tag: str = "") -> int:
        ticket = next(self._ids)
        entry = _Armed(time.monotonic() + float(budget_s), on_hang, tag)
        with self._cond:
            self._armed[ticket] = entry
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._monitor, name="swarmguard-watchdog",
                    daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return ticket

    def disarm(self, ticket: int) -> bool:
        """Withdraw ``ticket``; True when it already fired."""
        with self._cond:
            entry = self._armed.pop(ticket, None)
        return bool(entry is not None and entry.fired)

    def _monitor(self) -> None:
        while True:
            with self._cond:
                now = time.monotonic()
                due = [e for e in self._armed.values()
                       if not e.fired and e.deadline <= now]
                for entry in due:
                    entry.fired = True
                pending = [e.deadline for e in self._armed.values()
                           if not e.fired]
                timeout = (min(pending) - now) if pending else 60.0
            for entry in due:
                log.error("watchdog: %s exceeded its hang budget; "
                          "declaring it hung", entry.tag or "a call")
                try:
                    entry.on_hang()
                except Exception:  # a broken heal hook must not kill it
                    log.exception("watchdog on_hang callback failed "
                                  "for %s", entry.tag)
            with self._cond:
                self._cond.wait(timeout=max(0.005, min(timeout, 60.0)))


#: process-wide watchdog (lane threads and solo phases share the monitor)
WATCHDOG = Watchdog()

# the cache_flush rung's epoch: a lane's next dispatch after a flush is
# cold (the ceiling budget), so the rung cannot feed the ladder hangs of
# its own making
_FLUSH_LOCK = threading.Lock()
_FLUSH_EPOCH = 0


def flush_epoch() -> int:
    with _FLUSH_LOCK:
        return _FLUSH_EPOCH


def note_cache_flush() -> None:
    """Record the cache_flush rung: lanes and solo keys re-enter their
    cold-budget window."""
    global _FLUSH_EPOCH
    with _FLUSH_LOCK:
        _FLUSH_EPOCH += 1


def _slot_devices(slot: Any) -> list[str]:
    """The distinct devices of a slot's mesh, as ``str(torch.device)`` in
    mesh order (stub slots report nothing)."""
    mesh = getattr(slot, "mesh", None)
    if mesh is None:
        return []
    try:
        return list(dict.fromkeys(str(d) for d in mesh.device_list))
    except Exception:  # exotic mesh stubs
        return []


@contextlib.contextmanager
def watch_solo(slot: Any, steps: Any, key: Any = None):
    """Arm the watchdog around one solo denoise (``node/executor.py``).
    Budget: steps x the slot scheduler's lane step EWMA x factor; unarmed
    without an EWMA. The first watched call of each ``key`` (model,
    height, width) in a flush epoch runs under the ceiling. On fire the
    slot's device guard hears a solo hang, and :class:`StepHung` raises
    once the call returns."""
    stepper = getattr(slot, "_stepper", None)
    if not watchdog_enabled() or stepper is None:
        yield
        return
    try:
        ewma = float(stepper.step_ewma())
        n_steps = int(steps or 0)
    except (AttributeError, TypeError, ValueError):
        yield
        return
    budget = solo_hang_budget_s(ewma, n_steps)
    if budget is None:
        yield
        return
    epoch = flush_epoch()
    state = getattr(slot, "_guard_solo_warm", None)
    warm_keys = (state[1] if isinstance(state, tuple)
                 and state[0] == epoch else set())
    if key not in warm_keys:
        floor = _env_float(ENV_HANG_FLOOR, 30.0)
        budget = max(floor, _env_float(ENV_HANG_CEIL, 600.0))
    guard = getattr(slot, "_guard", None)

    def on_hang() -> None:
        if guard is not None:
            guard.note_hang(_slot_devices(slot), phase="solo")

    ticket = WATCHDOG.arm(budget, on_hang, tag="solo-denoise")
    fired = False
    try:
        yield
    finally:
        fired = WATCHDOG.disarm(ticket)
    if fired:
        raise StepHung(
            f"solo denoise exceeded its {budget:.1f}s hang budget "
            f"(declared hung; retrying through the ladder)")
    try:
        warm_keys.add(key)
        slot._guard_solo_warm = (epoch, warm_keys)
    except (AttributeError, TypeError):  # exotic slot stubs
        pass


# ---- output validation ----


def screen_images(images: Any, *, context: str = "decode") -> None:
    """Raise :class:`InvalidOutput` when decoded frames are non-finite
    (float stages) or a frame is exactly constant (a NaN trajectory casts
    to a flat frame in uint8; a real generation never is)."""
    if not validation_enabled():
        return
    arr = np.asarray(images)
    if arr.size == 0:
        return
    if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
        raise InvalidOutput(
            f"non-finite pixel values after {context}; refusing to "
            f"upload a poisoned image")
    # ndim >= 4 is a (B, H, W, C) batch; anything smaller is ONE image
    frames = arr if arr.ndim >= 4 else arr[None]
    for i, frame in enumerate(frames):
        flat = np.asarray(frame)
        if flat.size and flat.max() == flat.min():
            raise InvalidOutput(
                f"frame {i} is constant (value {flat.flat[0]!r}) after "
                f"{context} — a poisoned trajectory, not an image")


# ---- chaos seams ----

_CHAOS_LOCK = threading.Lock()
_CHAOS_CONSUMED: set[str] = set()


def consume_chaos(kind: str) -> bool:
    """One-shot gate: the first caller for ``kind`` wins, process-wide."""
    with _CHAOS_LOCK:
        if kind in _CHAOS_CONSUMED:
            return False
        _CHAOS_CONSUMED.add(kind)
        return True


def reset_chaos() -> None:
    """Re-arm the one-shot chaos seams."""
    with _CHAOS_LOCK:
        _CHAOS_CONSUMED.clear()


@dataclasses.dataclass(frozen=True)
class LaneChaos:
    """The parsed lane chaos plan. Lanes re-read the env at every dispatch
    and count trigger steps from the dispatch at which the plan first
    appeared on them."""

    wedge_step: int | None = None
    wedge_s: float = 0.0
    slow_mult: float = 1.0
    nan_step: int | None = None
    nan_row: int = 0

    @classmethod
    def from_env(cls) -> "LaneChaos":
        def pair(name: str) -> tuple[int, float] | None:
            raw = os.environ.get(name, "").strip()
            if not raw or ":" not in raw:
                return None
            a, b = raw.split(":", 1)
            try:
                return int(a), float(b)
            except ValueError:
                return None

        wedge = pair(ENV_CHAOS_WEDGE)
        nan = pair(ENV_CHAOS_NAN)
        return cls(
            wedge_step=None if wedge is None else wedge[0],
            wedge_s=0.0 if wedge is None else wedge[1],
            slow_mult=max(1.0, _env_float(ENV_CHAOS_SLOW, 1.0)),
            nan_step=None if nan is None else nan[0],
            nan_row=0 if nan is None else int(nan[1]),
        )

    @property
    def armed(self) -> bool:
        return (self.wedge_step is not None or self.nan_step is not None
                or self.slow_mult > 1.0)

    def wedge_at(self, step: int) -> float:
        """Seconds to wedge inside lane step ``step`` (0 = no wedge)."""
        if self.wedge_step is None or step != self.wedge_step:
            return 0.0
        return self.wedge_s if consume_chaos("wedge") else 0.0

    def nan_wants(self, step: int) -> int | None:
        """Row the NaN seam wants to poison at or after ``step``; the lane
        consumes the one shot only on an active row with a later
        checkpoint boundary."""
        if self.nan_step is None or step < self.nan_step:
            return None
        return self.nan_row

    def slow_extra_s(self, step_s: float) -> float:
        """Extra sleep stretching a step to ~slow_mult x its time."""
        if self.slow_mult <= 1.0:
            return 0.0
        return max(0.0, float(step_s) * (self.slow_mult - 1.0))


# ---- device health and the healing ladder ----

#: rung vocabulary in escalation order (``lane_rebuild`` is every
#: condemnation; the worker applies the others)
HEAL_RUNGS = ("lane_rebuild", "cache_flush", "device_quarantine",
              "restart")

#: hang phases the counter labels by
HANG_PHASES = ("lane", "solo")

#: streak weight per event kind
EVENT_WEIGHTS = {"hang": 2, "invalid_output": 1, "slow_step": 1}


@dataclasses.dataclass(frozen=True)
class HealAction:
    """One queued ladder action for the worker to apply."""

    rung: str
    device: str
    reason: str


class DeviceGuard:
    """Per-device health ledger and the healing-ladder policy.

    Events grow a weighted, consecutive sickness streak per device (an OK
    event shrinks it by one); health is ``1 - streak / restart_after``,
    floored at 0. Crossing a rung's threshold queues one
    :class:`HealAction` per rung per episode, which the worker applies from
    its poll loop; the rungs re-arm once the streak is back at 0. Events
    are slot-granular, so quarantine takes at most one device a process.
    Disabled, it counts and never queues. Thread-safe; metrics on the
    worker's registry."""

    def __init__(self, *, enabled: bool = True,
                 cache_flush_after: int = 3,
                 quarantine_after: int = 5,
                 restart_after: int = 7,
                 metrics_registry: Any = None) -> None:
        self.enabled = bool(enabled)
        self.cache_flush_after = max(1, int(cache_flush_after))
        self.quarantine_after = max(self.cache_flush_after,
                                    int(quarantine_after))
        self.restart_after = max(self.quarantine_after, int(restart_after))
        self._lock = threading.Lock()
        self._streak: dict[str, int] = {}
        #: rung index (into HEAL_RUNGS) already queued this episode
        self._rung_done: dict[str, int] = {}
        self._actions: collections.deque[HealAction] = collections.deque()
        self.quarantined: set[str] = set()
        self.restart_requested = False
        self.hangs_total = 0
        self.invalid_total = 0
        self.slow_total = 0
        self.condemned_lanes = 0
        reg = metrics_registry
        self._m_hangs = obs_metrics.guard_hangs_counter(reg)
        self._m_condemned = obs_metrics.guard_condemned_counter(reg)
        self._m_invalid = obs_metrics.guard_invalid_counter(reg)
        self._m_health = obs_metrics.guard_device_health_gauge(reg)
        self._m_rungs = obs_metrics.guard_heal_rung_counter(reg)
        self._m_quarantined = obs_metrics.guard_quarantined_gauge(reg)
        for phase in HANG_PHASES:
            self._m_hangs.inc(0, phase=phase)
        for rung in HEAL_RUNGS:
            self._m_rungs.inc(0, rung=rung)
        self._m_condemned.inc(0)
        self._m_quarantined.set(0)

    # ---- event intake ----

    def seed_devices(self, devices: Iterable[str]) -> None:
        """Register the devices served, so their gauges read 1.0 at once."""
        with self._lock:
            for device in devices:
                self._streak.setdefault(str(device), 0)
        self._publish_health()

    def note_hang(self, devices: Iterable[str], phase: str = "lane") -> None:
        with self._lock:
            self.hangs_total += 1
        self._m_hangs.inc(phase=phase if phase in HANG_PHASES else "lane")
        self._note_bad(devices, "hang")

    def note_condemned(self) -> None:
        with self._lock:
            self.condemned_lanes += 1
        self._m_condemned.inc()
        self._m_rungs.inc(rung="lane_rebuild")

    def note_invalid_output(self, devices: Iterable[str],
                            model: str = "") -> None:
        with self._lock:
            self.invalid_total += 1
        self._m_invalid.inc(model=str(model or "unknown"))
        self._note_bad(devices, "invalid_output")

    def note_slow_step(self, devices: Iterable[str]) -> None:
        with self._lock:
            self.slow_total += 1
        self._note_bad(devices, "slow_step")

    def note_ok(self, devices: Iterable[str]) -> None:
        """A healthy step or job: the streak decays by one, and a device
        back at 0 re-arms its ladder."""
        with self._lock:
            for device in (str(d) for d in devices):
                streak = max(0, self._streak.get(device, 0) - 1)
                self._streak[device] = streak
                if streak == 0:
                    self._rung_done.pop(device, None)
        self._publish_health()

    def _note_bad(self, devices: Iterable[str], kind: str) -> None:
        weight = EVENT_WEIGHTS.get(kind, 1)
        queued: list[HealAction] = []
        with self._lock:
            for device in (str(d) for d in devices):
                streak = self._streak.get(device, 0) + weight
                self._streak[device] = streak
                if not self.enabled:
                    continue
                done = self._rung_done.get(device, 0)
                for rung_idx, (rung, threshold) in enumerate((
                        ("cache_flush", self.cache_flush_after),
                        ("device_quarantine", self.quarantine_after),
                        ("restart", self.restart_after)), start=1):
                    if streak < threshold or done >= rung_idx:
                        continue
                    # each rung once per call; quarantine takes at most
                    # one device a process (the next rung is restart)
                    repeat = any(a.rung == rung for a in queued)
                    if repeat or (rung == "device_quarantine"
                                  and self.quarantined):
                        done = rung_idx
                        continue
                    reason = (f"device {device} sickness streak "
                              f"{streak} >= {threshold} ({kind})")
                    queued.append(HealAction(rung, device, reason))
                    done = rung_idx
                    if rung == "device_quarantine":
                        self.quarantined.add(device)
                    elif rung == "restart":
                        self.restart_requested = True
                self._rung_done[device] = done
            self._actions.extend(queued)
        for action in queued:
            self._m_rungs.inc(rung=action.rung)
            log.error("guard ladder: %s queued (%s)", action.rung,
                      action.reason)
        self._m_quarantined.set(len(self.quarantined))
        self._publish_health()

    def _publish_health(self) -> None:
        for device, score in self.health_scores().items():
            self._m_health.set(score, device=device)

    def health_scores(self) -> dict[str, float]:
        with self._lock:
            return {device: round(
                max(0.0, 1.0 - streak / self.restart_after), 4)
                for device, streak in sorted(self._streak.items())}

    # ---- the worker drains queued actions ----

    def take_actions(self) -> list[HealAction]:
        with self._lock:
            actions = list(self._actions)
            self._actions.clear()
        return actions

    def snapshot(self) -> dict[str, Any]:
        """The ledger's state, the JAX worker's ``/healthz`` ``guard`` key."""
        with self._lock:
            streaks = dict(sorted(self._streak.items()))
            return {
                "enabled": self.enabled,
                "hangs": self.hangs_total,
                "condemned_lanes": self.condemned_lanes,
                "invalid_outputs": self.invalid_total,
                "slow_steps": self.slow_total,
                "streaks": streaks,
                "health": {d: round(max(0.0, 1.0 - s / self.restart_after),
                                    4) for d, s in streaks.items()},
                "quarantined": sorted(self.quarantined),
                "restart_requested": self.restart_requested,
                "rungs": {"cache_flush_after": self.cache_flush_after,
                          "quarantine_after": self.quarantine_after,
                          "restart_after": self.restart_after},
            }
