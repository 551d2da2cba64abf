"""Overload control: deadline-aware admission, backpressure, brownout. A
copy of ``chiaswarm_tpu/node/overload.py`` (the whole module, stdlib only),
with the same knobs, decisions and ``chiaswarm_overload_*`` families,
threaded through the worker (``node/worker.py``) and the lanes
(``serving/stepper.py``):

- **Admission estimator**: per-workflow service-time EWMAs (fed by
  completed jobs) plus the lanes' step-seconds EWMA, as measured on the
  card, predict a job's completion behind the current queue. A job
  predicted to miss its deadline is shed as a non-fatal ``overloaded``
  envelope (a ``REDISPATCH_KINDS`` member, ``node/resilience.py``), so a
  lease-aware hive requeues it with this worker excluded. It launches no
  kernel.
- **Queue-depth backpressure**: when the queued backlog alone is predicted
  to outlast the backpressure budget, the poll loop stops asking for more
  work (counted) instead of stacking jobs it would only shed.
- **Brownout rung**: sustained shedding inside a sliding window tightens
  the shed margin and caps lane admissions per step boundary
  (``StepScheduler.set_admission_cap``), so resident rows finish before
  fresh rows splice in; it clears after a shed-free cooldown.

Synchronous on an injectable monotonic clock, so its decisions are held
against the JAX module's on scripted clocks (``tests/test_torch_overload.py``).
The controller is off by default (``overload_control``): shedding helps
only when the hive redispatches ``overloaded`` envelopes.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable

from chiaswarm_tpu_torch.obs import metrics as obs_metrics

#: label vocabulary pre-seeded at construction so every family renders
#: zeroes from the first /metrics scrape
SEED_WORKLOADS = ("txt2img", "img2img", "inpaint", "controlnet")


@dataclasses.dataclass(frozen=True)
class ShedDecision:
    """One admission verdict: shed or admit, with the evidence."""

    shed: bool
    predicted_s: float
    remaining_s: float
    reason: str


class OverloadController:
    """Deadline-aware admission estimator + backpressure + brownout.

    ``margin``            shed when predicted completion exceeds
                          ``margin`` x the job's remaining deadline
                          budget (1.0 = shed exactly at the predicted
                          miss; < 1 sheds earlier, > 1 later)
    ``backpressure_s``    queue-drain estimate (seconds) past which the
                          poll loop stops asking for more work
    ``brownout_sheds``    sheds within ``window_s`` that trip brownout
    ``window_s``          the sliding shed window
    ``cooldown_s``        shed-free seconds that clear brownout
    ``admission_cap_rows``  lane rows admitted per step boundary while
                          brownout holds (pushed into the step
                          schedulers by the worker)
    ``brownout_margin_scale``  how much the margin tightens in brownout
    """

    def __init__(self, *, margin: float = 1.0,
                 backpressure_s: float = 60.0,
                 brownout_sheds: int = 6,
                 window_s: float = 10.0,
                 cooldown_s: float = 5.0,
                 admission_cap_rows: int = 2,
                 brownout_margin_scale: float = 0.7,
                 alpha: float = 0.3,
                 clock: Callable[[], float] = time.monotonic,
                 metrics_registry: Any = None) -> None:
        self.margin = float(margin)
        self.backpressure_s = float(backpressure_s)
        self.brownout_sheds = max(1, int(brownout_sheds))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.admission_cap_rows = max(1, int(admission_cap_rows))
        self.brownout_margin_scale = float(brownout_margin_scale)
        self.alpha = float(alpha)
        self._clock = clock
        self._lock = threading.Lock()
        # per-workflow service-time EWMAs; "" normalizes to txt2img (the
        # plain stable-diffusion path, node/settings.py deadline_for)
        self._service_ewma: dict[str, float] = {}
        self._overall_ewma = 0.0
        self._sheds: collections.deque[float] = collections.deque()
        self._last_shed = float("-inf")
        self.state = "normal"
        self.sheds_total = 0
        self.backpressure_waits = 0
        reg = metrics_registry
        self._m_state = obs_metrics.overload_state_gauge(reg)
        self._m_shed = obs_metrics.overload_shed_counter(reg)
        self._m_backpressure = obs_metrics.overload_backpressure_counter(reg)
        self._m_predicted = obs_metrics.overload_predicted_wait_histogram(reg)
        self._m_cap = obs_metrics.overload_admission_cap_gauge(reg)
        self._m_state.set(0)
        self._m_cap.set(0)
        self._m_backpressure.inc(0)
        for workload in SEED_WORKLOADS:
            self._m_shed.inc(0, workload=workload)

    # ---- the estimator ------------------------------------------------

    @staticmethod
    def _workload(workflow: str | None) -> str:
        return str(workflow) if workflow else "txt2img"

    def note_service(self, workflow: str | None, seconds: float) -> None:
        """Feed one completed job's wall time into the EWMAs (the worker
        times each executor attempt; shed/refused jobs never feed it —
        they would drag the estimate toward zero)."""
        seconds = max(0.0, float(seconds))
        key = self._workload(workflow)
        with self._lock:
            prev = self._service_ewma.get(key)
            self._service_ewma[key] = (
                seconds if prev is None
                else prev + self.alpha * (seconds - prev))
            self._overall_ewma = (
                seconds if self._overall_ewma <= 0.0
                else self._overall_ewma
                + self.alpha * (seconds - self._overall_ewma))

    def service_estimate(self, workflow: str | None) -> float:
        """Expected solo wall time for one job of ``workflow`` (0.0 =
        no evidence yet — a cold estimator never sheds)."""
        with self._lock:
            return self._service_ewma.get(self._workload(workflow),
                                          self._overall_ewma)

    def queue_drain_estimate(self, queued_ahead: int, slots: int) -> float:
        """Seconds until ``queued_ahead`` already-admitted jobs drain
        across ``slots`` executors, by the overall service EWMA."""
        with self._lock:
            ewma = self._overall_ewma
        return max(0, int(queued_ahead)) * ewma / max(1, int(slots))

    def should_shed(self, *, workflow: str | None, waited_s: float,
                    deadline_s: float, queued_ahead: int, slots: int,
                    lane_estimate_s: float | None = None) -> ShedDecision:
        """The admission verdict for one job about to execute.

        ``waited_s`` is how long the job has already sat on this worker
        (poll receipt -> now); ``lane_estimate_s`` is the lane-path
        prediction (job steps x the scheduler's step-latency EWMA) when
        the job would ride a lane — used as a floor under the workflow
        EWMA, so a cold EWMA cannot under-predict a long lane run."""
        now = self._clock()
        remaining = float(deadline_s) - max(0.0, float(waited_s))
        service = self.service_estimate(workflow)
        if lane_estimate_s is not None:
            service = max(service, float(lane_estimate_s))
        predicted = self.queue_drain_estimate(queued_ahead, slots) + service
        self._m_predicted.observe(predicted)
        if remaining <= 0.0:
            # needs no local-speed evidence — the budget is ALREADY
            # gone, so this sheds even on a cold (just-restarted)
            # worker; executing would only burn chip time into a
            # guaranteed miss
            return self._shed(now, workflow, predicted, remaining,
                              "deadline already expired in queue")
        if service <= 0.0:
            # no evidence about this node's speed yet: never shed on a
            # prediction the estimator cannot make
            return ShedDecision(False, predicted, remaining, "cold")
        margin = self.margin
        state = self._update_state(now)
        if state == "brownout":
            margin *= self.brownout_margin_scale
        if predicted > remaining * margin:
            return self._shed(
                now, workflow, predicted, remaining,
                f"predicted {predicted:.2f}s exceeds "
                f"{margin:.2f} x {remaining:.2f}s remaining")
        return ShedDecision(False, predicted, remaining, "admitted")

    def _shed(self, now: float, workflow: str | None, predicted: float,
              remaining: float, reason: str) -> ShedDecision:
        with self._lock:
            self.sheds_total += 1
            self._sheds.append(now)
            self._last_shed = now
        self._m_shed.inc(workload=self._workload(workflow))
        self._update_state(now)
        return ShedDecision(True, predicted, remaining, reason)

    # ---- brownout rung ------------------------------------------------

    def _update_state(self, now: float) -> str:
        with self._lock:
            while self._sheds and now - self._sheds[0] > self.window_s:
                self._sheds.popleft()
            if self.state == "normal":
                if len(self._sheds) >= self.brownout_sheds:
                    self.state = "brownout"
            elif now - self._last_shed >= self.cooldown_s:
                self.state = "normal"
                # drain the window with the transition: the sheds that
                # tripped the rung must not re-trip it on the very next
                # call (state would flap normal/brownout once per poll
                # until the window ages out)
                self._sheds.clear()
            state = self.state
        self._m_state.set(obs_metrics.OVERLOAD_STATES.index(state))
        self._m_cap.set(self.admission_cap_rows
                        if state == "brownout" else 0)
        return state

    def admission_cap(self) -> int | None:
        """Lane rows admissible per step boundary right now (None =
        uncapped). The worker pushes this into every slot's step
        scheduler on each poll and each shed."""
        return (self.admission_cap_rows
                if self._update_state(self._clock()) == "brownout"
                else None)

    # ---- backpressure -------------------------------------------------

    def poll_throttle(self, queue_depth: int, slots: int) -> float:
        """Seconds the poll loop should wait INSTEAD of asking for more
        work (0.0 = poll normally): engages when the queued backlog's
        drain estimate alone exceeds the backpressure budget. The wait
        is one service quantum, bounded — backpressure is a brake, not
        a parking brake (the loop re-evaluates every wait)."""
        drain = self.queue_drain_estimate(queue_depth, slots)
        if drain <= self.backpressure_s:
            return 0.0
        with self._lock:
            self.backpressure_waits += 1
            ewma = self._overall_ewma
        self._m_backpressure.inc()
        return min(2.0, max(0.05, ewma / 2.0))

    # ---- observability ------------------------------------------------

    def fleet_view(self) -> dict[str, Any]:
        """Compact overload state for the heartbeat's metrics snapshot
        (``node/worker.py::_fleet_metrics``): the brownout state, the shed
        volume and the per-workflow service EWMAs that price this node's
        capacity."""
        snap = self.snapshot()
        return {"state": snap["state"],
                "sheds_total": snap["sheds_total"],
                "service_ewma_s": snap["service_ewma_s"]}

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``overload`` key (node/worker.py)."""
        now = self._clock()
        state = self._update_state(now)
        with self._lock:
            return {
                "state": state,
                "sheds_total": self.sheds_total,
                "recent_sheds": len(self._sheds),
                "backpressure_waits": self.backpressure_waits,
                "admission_cap": (self.admission_cap_rows
                                  if state == "brownout" else 0),
                "margin": self.margin,
                "backpressure_s": self.backpressure_s,
                "service_ewma_s": {k: round(v, 4) for k, v in
                                   sorted(self._service_ewma.items())},
            }
