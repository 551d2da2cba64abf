"""Continuous step-level batching, counterpart of
``chiaswarm_tpu/serving/stepper.py``: the UNet step is the scheduling
quantum.

One resident **lane** per (pipeline, bucketed size, sampler) runs ONE
denoise step per dispatch over a row file of fixed width. A job
arriving while the lane steps splices into free rows at the next step
boundary; a finished row retires, decodes and goes back to its job while
the others keep stepping. Each row carries its own ladder, step index,
guidance, multistep history, noise generator and text embeddings (the
pooled ones too, which an SDXL-class UNet reads), so every row walks its
solo trajectory (``pipelines/diffusion.py::stepper_step``;
``tests/test_torch_stepper.py`` holds the splice against the solo path).
Lanes are the default engine, as in the JAX package: ``CHIASWARM_STEPPER=0``
opts out and the executor runs every job on the solo path.

Lane width is a closed loop (:class:`LaneWidthController`, copied with its
defaults): it grows when pending rows cannot fit, doubles under sustained
occupancy with arrivals flowing, halves under trickle, only at step
boundaries and only onto the power-of-two lattice. Demand is the arrival
EWMA of the rows submitted and the worker's poll hint
(:meth:`StepScheduler.note_poll`, JAX :1539-1560): after a poll that
returned jobs, the rows about to be submitted count as pending at the
next boundary for 2 s, burnt down as they land, so a lane grows before a
burst queues behind it. A failed lane fails every
resident row's future and the executor falls back to the per-job path; rows
carry their own deadline; an out-of-memory lane halves the width lanes are
rebuilt with; ``drain``/``shutdown`` retire lanes, and so does the
residency ledger when it evicts a lane's model (:func:`retire_lanes_for_owner`,
at drain: the lane's row state and text embeddings free when it retires).

What is PyTorch's own here:

- **The lane thread** runs in a copy of its creator's context and inside
  ``torch.inference_mode()`` (both are per thread); the lane programs enter
  the pipeline's sequence-parallel context themselves.
- **One stream.** The submitting thread encodes text and draws noise while
  the lane steps, both on the device's current stream, so admission needs
  no barrier. Host mirrors (index, ladders, guidance, active flags) go to
  the device as copies of fresh buffers, never of a buffer admission later
  mutates. Every host-device copy on the lane path goes through pinned
  memory without waiting on the card's queue (``core/device.py::upload``,
  and the retiring rows' images to the host): a plain copy would hold the
  submitting thread behind every step the lane has queued.
- **Depth-2 throttle.** Eager PyTorch lets the host run ahead of the device
  without bound: the lane thread records a CUDA event per step and waits on the
  one from two steps back, so an execution error surfaces inside the
  lane thread's containment ``try`` and a step's seconds are a step's, not an
  enqueue's.
- **Keys** hold the pipeline by reference, never by ``id()``: a freed
  pipeline's reused address cannot serve another model's lane. The widths
  remembered after an out-of-memory lane hold it weakly, so they never keep
  a model alive once no lane serves it. Keys leave
  out the step capacity the JAX package keys by: it sizes a compiled
  program there, while here a lane's ladder tables simply hold the longest
  ladder of the lattice (``STEP_CAPACITY``), so jobs of any step count
  share one lane.

Knobs (the JAX package's names and defaults):

- ``CHIASWARM_STEPPER=0``  opt out of lane routing (default on)
- ``CHIASWARM_STEPPER_LANE_WIDTH``  pin rows per lane (disables the
  adaptive controller)
- ``CHIASWARM_STEPPER_ADAPTIVE=0``  lanes keep their initial width
- ``CHIASWARM_STEPPER_MIN_WIDTH`` / ``_MAX_WIDTH``  adaptive bounds
- ``CHIASWARM_STEPPER_ROW_DEADLINE_S``  per-row in-lane deadline (600)
- ``CHIASWARM_STEPPER_IDLE_S``  idle grace before a lane retires (15)
- ``CHIASWARM_STEPPER_CKPT_EVERY``  steps between in-memory row checkpoints
  (8; 0 turns them and the per-row finite check off)

Workload row state: an img2img row starts at its strength's ladder index
from its encoded init image; an inpaint row starts at 0 and carries its
clean latents (``known``) and latent-grid mask, and only such rows
(``mask_on``) re-project and draw renoise, so a txt2img row beside them keeps
its bits. A ControlNet job (JAX :184, :299-300, :725-729, :776, :836-855,
:1694-1812) rides a lane of its own bundle: the lane key holds the
``ControlNetBundle`` (by reference, as it holds the pipeline), each row
carries its job's hint embedding (``cond``, embedded once at admission by
``pipelines/diffusion.py::stepper_control_embed``) and conditioning scale
(``cscale``), copied in at the row's slot like ``known`` and ``mask``, and
the step runs the control branch on the lane's rows. A control job takes
exactly one conditioning image, with no init image and no mask. The
residency ledger's eviction of a bundle retires its lanes, as a pipeline's
does.

The gray-failure guard (``serving/guard.py``; JAX :473-610, :1003-1156,
:1246-1376, :1630-1985):

- **Watchdog.** Each dispatch is armed from before the step's launches to
  after the depth-2 window's ``event.synchronize()``, where a wedged card
  blocks the lane thread; so are the checkpoint's copy to the host and an
  idle lane's wait for its last decodes (JAX arms the dispatch alone).
  The budget is the scheduler's :meth:`StepScheduler.hang_budget`, the
  ceiling for a lane's first dispatch at a width and the first after a
  ``cache_flush`` rung. Past it, :meth:`Lane.condemn` runs in the monitor
  thread and never touches the device: it retires the lane and fails every
  job with :class:`~chiaswarm_tpu_torch.serving.guard.LaneHung`, carrying
  the job's last checkpoint; the returning lane thread condemns again (a
  no-op) and exits. A scheduler joins its condemned lanes' threads at
  shutdown, with the same timeout.
- **Checkpoints.** Every ``CHIASWARM_STEPPER_CKPT_EVERY`` lane steps the
  lane copies ``x`` to the host (the copy waits for every queued step),
  finite-checks each job's rows (a poisoned job retires alone with
  ``InvalidOutput``) and keeps each job's resume state in memory: latents,
  multistep history and step, in the JAX envelope's keys, and beside them,
  under ``generators``, each row's noise ``torch.Generator`` state, taken
  in the lane thread where the draws happen, and under ``slots`` the rows'
  slots. When the worker attached its checkpoint spool to the slot
  (``slot._checkpoint_spool``, heartbeats on; JAX :474-476, :1245-1354) the
  same state is written there by the hive's job id, ``checkpoints_written``
  counts it, and the worker's heartbeat ships it to a lease-aware hive.
  Every field is JSON (``pack_array``), so it survives the hive and resumes
  in another process.
- **Resume.** ``submit_request(resume=...)`` validates a checkpoint against
  the job (:meth:`StepScheduler._validate_resume`) and splices the rows in
  at its step with their latents, history and generators, into the slots
  they held when those are free (on the card a row's bits depend on its
  slot, so a job redelivered to another worker's lane of the same width
  renders its uninterrupted image bit for bit, whatever order the jobs
  arrive in); an image row re-derives its start index, ``known`` and mask
  from the job's inputs. A
  payload it cannot trust, a JAX lane checkpoint among them (its threefry
  keys are not the port's noise stream), is rejected loudly and the job
  restarts at 0.

DeepCache reuse lanes (JAX :417-466, :838-849, :984-1000, :1105-1125,
:1205-1220, :1322-1336, :1724-1767, :1823-1830, :1946-1957): with
``CHIASWARM_DEEPCACHE`` on, a job's ``reuse_schedule`` is canonicalized as
the solo path does it (a malformed one is :class:`LaneReject`; a ControlNet
job's is ignored, as in JAX) and the job rides a lane keyed apart from the
plain ones. Each row carries its two deep-cache halves (``cache_u``,
``cache_c``), its schedule as a row of the reuse table, a cache-valid flag
and its skipped tally. The lane thread decides each step for the whole
lane on the host: replay the caches only when every active row wants reuse
at its current step and holds a valid cache; a misaligned mate degrades the
step to a full eval, which refreshes every active row's cache. A retiring row's
``info`` carries ``unet_evals`` and ``steps_skipped``; ``stats()`` counts
``steps_reused`` and ``row_steps_reused``; checkpoints carry the caches,
the flag, the tally and the schedule, and a resume under another schedule
is refused.

Overload control (``node/overload.py``; JAX :1570-1580, :778-793): the
worker pushes a brownout admission cap into every slot's scheduler
(:meth:`StepScheduler.set_admission_cap`); each lane reads it before a
boundary, and at most that many rows splice in at it (the first pending job
always admits). The lanes' step seconds feed the process registry's
``chiaswarm_stepper_step_seconds`` (the hang-budget suggestion,
``serving/guard.py``) and resumed rows ``chiaswarm_stepper_resume_step``;
``obs/profiling.py`` names each lane step and decode in a profiler's
timeline. The control loop's families (JAX :143-193), seeded with zeroes
at import: the admission-prep seconds, the occupancy at each step by
width, resizes by direction, the arrival-rate EWMA and admissions by
workload.
"""

from __future__ import annotations

import atexit
import base64
import collections
import contextlib
import contextvars
import dataclasses
import logging
import os
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from chiaswarm_tpu_torch.core.buckets import (
    STEP_CAPACITY,
    bucket_batch,
    bucket_image_size,
    bucket_steps,
)
from chiaswarm_tpu_torch.core.device import upload
from chiaswarm_tpu_torch.core.rng import row_generators
from chiaswarm_tpu_torch.models.common import param_dtype
from chiaswarm_tpu_torch.obs import metrics as obs_metrics
from chiaswarm_tpu_torch.obs import numerics as _numerics
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.obs.profiling import annotate
from chiaswarm_tpu_torch.pipelines.diffusion import (
    PendingImages,
    deepcache_enabled,
    image_plan,
    normalize_reuse_schedule,
)
from chiaswarm_tpu_torch.schedulers import (
    FEWSTEP_KINDS,
    NOISY_KINDS,
    make_sampling_schedule,
    resolve,
)
from chiaswarm_tpu_torch.serving import guard as _guard
from chiaswarm_tpu_torch.serving.guard import InvalidOutput, LaneHung
from chiaswarm_tpu_torch.serving.residency import ArrivalEwma

log = logging.getLogger("chiaswarm_torch.stepper")

ENV_ENABLE = "CHIASWARM_STEPPER"
ENV_LANE_WIDTH = "CHIASWARM_STEPPER_LANE_WIDTH"
ENV_ADAPTIVE = "CHIASWARM_STEPPER_ADAPTIVE"
ENV_MIN_WIDTH = "CHIASWARM_STEPPER_MIN_WIDTH"
ENV_MAX_WIDTH = "CHIASWARM_STEPPER_MAX_WIDTH"
ENV_ROW_DEADLINE = "CHIASWARM_STEPPER_ROW_DEADLINE_S"
ENV_IDLE_S = "CHIASWARM_STEPPER_IDLE_S"
ENV_CKPT_EVERY = "CHIASWARM_STEPPER_CKPT_EVERY"

_OFF = ("0", "false", "off", "no")

# lane step wall time, the depth-2 window's wait included: in steady state
# the device's step time (the hang-budget suggestion reads it)
_STEP_SECONDS = obs_metrics.REGISTRY.histogram(
    "chiaswarm_stepper_step_seconds",
    "lane step wall time (dispatch + pipelined-window backpressure)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
# checkpoint seconds (chip_smoke's guard_cost reads them)
_CKPT_SECONDS = obs_metrics.REGISTRY.histogram(
    "chiaswarm_stepper_checkpoint_seconds",
    "wall time of one lane checkpoint (device->host copy, finite check, "
    "generator states, spool write)",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
# the step index redelivered rows splice back in at
_RESUME_STEP = obs_metrics.resume_step_histogram()
# admission prep on the submitting thread (tokenize, encode, row init)
_LANE_ADMIT_SECONDS = obs_metrics.REGISTRY.histogram(
    "chiaswarm_stepper_admission_seconds",
    "submit-side admission prep (tokenize + encode + row init)",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))
# the adaptive-width loop: occupancy at each step, resizes, the demand
# EWMA and the rows each workload admits
_LANE_OCCUPANCY = obs_metrics.lane_occupancy_histogram()
_LANE_RESIZES = obs_metrics.lane_resizes_counter()
_ARRIVAL_RATE = obs_metrics.arrival_rate_gauge()
_LANE_ADMISSIONS = obs_metrics.lane_admissions_counter()

# the step-collapse families (obs/metrics.py; seeded by pipelines/diffusion)
_UNET_EVALS = obs_metrics.unet_evals_counter()
_STEPS_SKIPPED = obs_metrics.steps_skipped_counter()
_EVALS_PER_IMAGE = obs_metrics.unet_evals_per_image_histogram()

#: the version of the port's lane checkpoint (JAX's envelope keys plus
#: ``generators``)
CKPT_VERSION = 1

#: lane workload kinds (the ``workload`` label's vocabulary)
WORKLOADS = ("txt2img", "img2img", "inpaint", "controlnet")

#: seconds a poll hint counts as demand
POLL_HINT_S = 2.0

# every label seeded at import, so the first /metrics scrape shows zeroes
_ARRIVAL_RATE.set(0.0)
for _direction in ("grow", "shrink"):
    _LANE_RESIZES.inc(0, direction=_direction)
for _workload in WORKLOADS:
    _LANE_ADMISSIONS.inc(0, workload=_workload)


def stepper_enabled() -> bool:
    """Continuous batching is the default engine; ``CHIASWARM_STEPPER=0``
    restores the solo routing end to end."""
    return os.environ.get(ENV_ENABLE, "").strip().lower() not in _OFF


def adaptive_enabled() -> bool:
    """Adaptive lane width is on by default; a pinned
    ``CHIASWARM_STEPPER_LANE_WIDTH`` or ``CHIASWARM_STEPPER_ADAPTIVE=0``
    turns the controller off (lanes keep their creation width)."""
    if os.environ.get(ENV_LANE_WIDTH, "").strip():
        return False
    return os.environ.get(ENV_ADAPTIVE, "").strip().lower() not in _OFF


# ---- resume-state packing (JAX :199-222) ----
#
# A checkpoint is JSON-safe: arrays ride as base64 raw bytes with dtype and
# shape, exact bit for bit. numpy has no bfloat16, so a bf16 tensor rides
# as its raw 16-bit words under dtype "bfloat16".


def pack_array(arr: Any) -> dict[str, Any]:
    """A tensor or array -> ``{"dtype", "shape", "b64"}``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "b64": base64.b64encode(
                        t.view(torch.int16).numpy().tobytes()
                    ).decode("ascii")}
        arr = t.numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def unpack_array(spec: dict[str, Any]) -> torch.Tensor:
    """:func:`pack_array`'s inverse, a CPU tensor."""
    raw = base64.b64decode(spec["b64"])
    shape = [int(n) for n in spec["shape"]]
    if str(spec["dtype"]) == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    a = np.frombuffer(raw, dtype=np.dtype(str(spec["dtype"])))
    return torch.from_numpy(a.reshape(shape).copy())


class ResumeReject(RuntimeError):
    """The resume payload does not match this job (another job's shape or
    steps, corrupt arrays, another noise stream): the job restarts at step
    0. Lost progress is acceptable; the wrong trajectory is not."""


class LaneReject(RuntimeError):
    """The job cannot ride a lane (too many rows, steps beyond the
    capacity lattice, ...): run it through the per-job path."""


class LaneDeadline(TimeoutError):
    """A row exceeded its in-lane deadline and was retired unfinished."""


class LaneRetired(RuntimeError):
    """The lane shut down (stop or fault) before the row completed."""


@dataclasses.dataclass(eq=False)  # identity semantics: membership checks
class _RowJob:                    # must never compare tensor fields
    """One job's rows plus everything admission needs, prepared in the
    submitting thread (tokenize, encode, noise) so the lane thread stays a step
    pump."""

    job_id: Any
    n_rows: int
    steps: int
    guidance: float
    sigmas: np.ndarray          # (steps+1,) this job's ladder
    timesteps: np.ndarray       # (steps,)
    ctx_u: torch.Tensor         # (n, L, D) on the device
    ctx_c: torch.Tensor
    pooled_u: torch.Tensor      # (n, P) on the device (SDXL reads them)
    pooled_c: torch.Tensor
    generators: list[torch.Generator]  # one per row: the noise carry
    x0: torch.Tensor            # (n, C, h, w) initial latents
    deadline: float             # absolute time.monotonic() cutoff
    # workload row state: img2img rows start partway down the ladder;
    # inpaint rows carry their clean latents and latent-grid mask
    workload: str = "txt2img"
    start_step: int = 0
    known0: torch.Tensor | None = None  # (n, C, h, w) clean init latents
    mask0: torch.Tensor | None = None   # (n, 1, h, w) 1 = regenerate
    # a ControlNet job's rows: the pre-embedded hint and the scale
    cond0: torch.Tensor | None = None   # (n, C0, h, w)
    cscale: float = 1.0
    # a resumed job's rows splice in at ``resume_step`` with restored
    # latents (x0), multistep history and generators, into the slots they
    # held when those are free (a row's bits depend on its slot)
    resume_step: int = 0
    old0: torch.Tensor | None = None    # (n, C, h, w) restored history
    slots0: tuple[int, ...] = ()
    # DeepCache: the canonical schedule, and a resumed row's caches (n, C1,
    # h, w), validity and skipped tally
    reuse_schedule: tuple[int, ...] = ()
    cache_u0: torch.Tensor | None = None
    cache_c0: torch.Tensor | None = None
    cache_ok0: bool = False
    skipped0: int = 0
    future: Future = dataclasses.field(default_factory=Future)
    admitted_at_step: int = -1
    slots: list[int] = dataclasses.field(default_factory=list)
    submitted_t: float = dataclasses.field(default_factory=time.perf_counter)
    admitted_t: float = 0.0

    @property
    def idx0(self) -> int:
        """The ladder index the rows are admitted at: the resume step, else
        the workload's start."""
        return self.resume_step if self.resume_step > 0 else self.start_step


class LaneWidthController:
    """Closed-loop lane capacity, copied from the JAX package with its
    defaults: width follows demand.

    Demand is the scheduler's arrival-rate EWMA (rows/s); supply is the
    lane's occupancy EWMA. Decisions land only at step boundaries and only
    on the pow2 width lattice:

    - **grow under burst**: pending rows that cannot fit resize at once to
      the bucket that holds them; sustained occupancy >= ``grow_at`` with
      arrivals flowing doubles the width.
    - **shrink under trickle**: occupancy <= ``shrink_at`` for ``patience``
      boundaries with nothing pending halves the width.
    - bounds clamp each decision, so an OOM width limit (``note_oom``) holds
      from the next boundary on.

    Pure host arithmetic."""

    def __init__(self, *, min_width: int = 1, max_width: int = 128,
                 alpha: float = 0.25, grow_at: float = 0.75,
                 shrink_at: float = 0.25, patience: int = 6,
                 rate_window_s: float = 10.0) -> None:
        self.min_width = max(1, int(min_width))
        self.max_width = max(self.min_width, int(max_width))
        self.alpha = float(alpha)
        self.grow_at = float(grow_at)
        self.shrink_at = float(shrink_at)
        self.patience = max(1, int(patience))
        self.rate_window_s = float(rate_window_s)
        self.occ_ewma = 0.0
        # EWMA-driven moves need ``patience`` boundaries of evidence from
        # birth too; only the burst reaction acts at once
        self._boundaries_since_resize = 0

    def decide(self, width: int, occupied: int, pending_rows: int,
               rate: float, *, max_width: int | None = None) -> int:
        """Target width for the NEXT step, given current occupancy, rows
        waiting at the gate and the arrival-rate EWMA. Returns ``width``
        unchanged when the loop holds steady."""
        hi = self.max_width if max_width is None else max(1, min(
            self.max_width, int(max_width)))
        lo = min(self.min_width, hi)
        self.occ_ewma += self.alpha * (occupied / max(1, width)
                                       - self.occ_ewma)
        self._boundaries_since_resize += 1
        target = width
        need = occupied + pending_rows
        if need > width:
            target = bucket_batch(min(need, hi))
        elif self._boundaries_since_resize >= self.patience:
            if (self.occ_ewma >= self.grow_at and rate > 0.0
                    and width * 2 <= hi):
                target = width * 2
            elif (self.occ_ewma <= self.shrink_at and pending_rows == 0
                    and occupied <= width // 2 and width > lo):
                target = width // 2
        target = max(lo, min(hi, bucket_batch(max(1, target))))
        target = max(target, bucket_batch(max(1, occupied)))
        if target != width:
            self._boundaries_since_resize = 0
            # re-seed at the post-resize ratio so one resize does not
            # immediately argue for the next
            self.occ_ewma = occupied / max(1, target)
        return target


class _ByPipe:
    """A table over lane keys ``(pipe, *rest)`` that holds each pipeline
    weakly: an entry goes with its pipeline, so a width remembered after an
    out-of-memory lane never keeps a model's weights on the card."""

    def __init__(self) -> None:
        self._tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def get(self, key: tuple, default: Any = None) -> Any:
        table = self._tables.get(key[0])
        return default if table is None else table.get(key[1:], default)

    def __setitem__(self, key: tuple, value: Any) -> None:
        self._tables.setdefault(key[0], {})[key[1:]] = value

    def keys(self) -> list[tuple]:
        return [(pipe, *rest) for pipe, table in list(self._tables.items())
                for rest in table]

    def values(self) -> list[Any]:
        return [value for table in list(self._tables.values())
                for value in table.values()]


def _fresh(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host mirror (``upload`` copies before it
    returns): admission may mutate the mirror at once."""
    return upload(torch.from_numpy(values), device)


@contextlib.contextmanager
def _on_device(device: torch.device):
    """The lane thread's current card (a per-thread setting)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


class Lane:
    """One resident batched denoise loop: a fixed-width row file through
    the pipeline's step program, driven by a dedicated thread."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, sched: "StepScheduler", key: tuple, pipe, *,
                 width: int, height: int, width_px: int, sampler,
                 width_bounds: tuple[int, int] | None = None,
                 reuse: bool = False) -> None:
        self._sched = sched
        # (pipe, height, width, sampler, ControlNet bundle, reuse)
        self.key = key
        self.pipe = pipe
        # a DeepCache lane carries per-row deep caches (keyed apart)
        self.reuse = bool(reuse)
        self.device = pipe.c.device
        self.width = int(width)
        self.height = int(height)
        self.width_px = int(width_px)
        self.steps_cap = STEP_CAPACITY
        self.sampler = sampler
        self.lane_id = next(Lane._ids)
        self._cond = threading.Condition()
        self._pending: collections.deque[_RowJob] = collections.deque()
        self._rows: list[_RowJob | None] = [None] * self.width
        self._stop = False
        self._retired = False
        self._retire_asap = False
        self.steps_executed = 0
        self._adaptive = adaptive_enabled()
        lo, hi = width_bounds if width_bounds else (self.width, self.width)
        self._ctl = LaneWidthController(min_width=lo, max_width=hi)
        self._new_mirrors()
        self._dev: dict[str, torch.Tensor] | None = None  # at first admission
        self._deferred_counts: list[dict] = []
        self._window: collections.deque = collections.deque()
        # retired rows whose decode is still in flight: the future resolves
        # once the images are resident
        self._handoff: collections.deque = collections.deque()
        # the guard: condemnation (from the watchdog's thread), each job's
        # last in-memory checkpoint, the chaos plan (trigger steps count
        # from the dispatch that first saw it) and the widths whose first
        # dispatch this lane has made in the current flush epoch
        self._ckpt_every = int(os.environ.get(ENV_CKPT_EVERY, "8") or 8)
        # the worker's durable spool, attached to the slot only with
        # heartbeats on: the lane then writes each job's state by job id
        self._spool = getattr(getattr(sched, "slot", None),
                              "_checkpoint_spool", None)
        # the brownout cap read before each boundary (None = uncapped)
        self._admit_cap: int | None = None
        self._condemned = False
        self._ckpt_mem: dict[int, dict[str, Any]] = {}
        self._chaos_base: int | None = None
        self._chaos_seen: _guard.LaneChaos | None = None
        self._warm_widths: set[int] = set()
        self._flush_epoch = _guard.flush_epoch()
        # the creator's context (instrumentation such as capture_ring_calls)
        # reaches the lane thread, as it would an asyncio task; the job
        # trace of the row that opened the lane does not
        context = contextvars.copy_context()
        context.run(obs_trace.unbind)
        self._thread = threading.Thread(
            target=context.run, args=(self._drive,),
            name=f"stepper-lane-{self.lane_id}", daemon=True)
        self._thread.start()

    def _new_mirrors(self) -> None:
        """Host mirrors of the per-row inputs at the current width (copied
        to the device when admission or retirement changes them)."""
        w = self.width
        self._h_start = np.zeros(w, np.int64)
        self._h_idx = np.zeros(w, np.int64)
        self._h_sig = np.ones((w, self.steps_cap + 1), np.float32)
        self._h_ts = np.zeros((w, self.steps_cap), np.float32)
        self._h_guid = np.ones(w, np.float32)
        self._h_active = np.zeros(w, bool)
        self._h_mask_on = np.zeros(w, bool)
        self._h_cscale = np.ones(w, np.float32)
        # DeepCache row state: the steps each row's schedule reuses, a
        # valid cache (a full step ran since admission), the skipped tally
        self._h_reuse = np.zeros((w, self.steps_cap), bool)
        self._h_cache_ok = np.zeros(w, bool)
        self._h_skipped = np.zeros(w, np.int64)
        self._gens: list[torch.Generator | None] = [None] * w

    def _mirrors(self) -> tuple:
        return (self._h_start, self._h_idx, self._h_sig, self._h_ts,
                self._h_guid, self._h_active, self._h_mask_on,
                self._h_cscale, self._h_reuse, self._h_cache_ok,
                self._h_skipped)

    # ---- submission side ----

    def try_enqueue(self, job: _RowJob) -> bool:
        with self._cond:
            if self._stop or self._retired:
                return False
            self._pending.append(job)
            self._cond.notify_all()
            return True

    def busy(self) -> bool:
        with self._cond:
            return (bool(self._pending) or bool(self._handoff)
                    or any(r is not None for r in self._rows))

    def occupancy(self) -> tuple[int, int]:
        with self._cond:
            return sum(r is not None for r in self._rows), self.width

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    def request_retire(self) -> None:
        """Retire as soon as the row file drains; never fails resident
        rows (unlike :meth:`stop`)."""
        with self._cond:
            self._retire_asap = True
            self._cond.notify_all()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    def condemn(self, reason: str) -> None:
        """Declare the lane hung (JAX :548-611). Runs in the watchdog's
        thread while the lane thread is blocked in the wedged step, so it
        never touches the device: it retires the lane (a racing submit opens
        a fresh one), clears the row file and fails every job with
        :class:`LaneHung`, resident jobs with their last checkpoint. Rows
        whose decode is queued fail too: waiting on it here would wedge the
        watchdog, so those jobs re-run. Idempotent."""
        with self._cond:
            if self._retired or self._condemned:
                return
            self._condemned = True
            self._retired = True
            jobs = {id(j): j for j in self._rows if j is not None}
            pending = list(self._pending)
            self._pending.clear()
            for s in range(self.width):
                self._rows[s] = None
            self._h_active[:] = False
            resumes = {jid: self._ckpt_mem.get(jid) for jid in jobs}
            handoff = list(self._handoff)
            self._handoff.clear()
            self._cond.notify_all()
        # outside the lane lock: _lane_done and _count take sched._lock
        self._sched._lane_condemned(self)
        rows_hung = 0
        for jid, job in jobs.items():
            rows_hung += job.n_rows
            if not job.future.done():
                job.future.set_exception(LaneHung(
                    f"lane {self.lane_id} condemned: {reason}",
                    resume=resumes.get(jid)))
        for job in pending:
            rows_hung += job.n_rows
            if not job.future.done():
                job.future.set_exception(LaneHung(
                    f"lane {self.lane_id} condemned with the job still "
                    f"pending: {reason}"))
        for job, _images, _info, _event in handoff:
            if not job.future.done():
                job.future.set_exception(LaneHung(
                    f"lane {self.lane_id} condemned with the decode "
                    f"in flight: {reason}"))
        self._sched._count(lanes_condemned=1, rows_hung=rows_hung)
        device_guard = getattr(self._sched.slot, "_guard", None)
        if device_guard is not None:
            device_guard.note_hang(_guard._slot_devices(self._sched.slot),
                                   phase="lane")
            device_guard.note_condemned()
        log.error("lane %d CONDEMNED (%s): %d row(s) failed over with "
                  "resume state for a fresh lane", self.lane_id, reason,
                  rows_hung)

    # ---- the lane thread ----

    def _drive(self) -> None:
        idle_s = float(os.environ.get(ENV_IDLE_S, "15") or 15)
        idle_since: float | None = None
        try:
            with torch.inference_mode(), _on_device(self.device):
                while True:
                    # scheduler-side signals, read OUTSIDE the lane lock:
                    # submitters hold sched._lock while they wait on this
                    # lane's cond, so taking it under self._cond would
                    # invert the lock order
                    width_limit = self._sched.width_limit_for(self.key)
                    rate, hint_rows = self._sched.demand_signal()
                    self._admit_cap = self._sched.admission_cap()
                    with self._cond:
                        while True:
                            if self._stop:
                                raise LaneRetired("lane stopped")
                            self._resize_locked(width_limit, rate,
                                                hint_rows)
                            self._admit_locked()
                            if self._h_active.any():
                                idle_since = None
                                break
                            if self._retire_asap and not self._pending:
                                self._retired = True
                                return
                            now = time.monotonic()
                            if idle_since is None:
                                idle_since = now
                            elif now - idle_since >= idle_s:
                                if self._pending:
                                    # a job the lane can never admit must
                                    # bounce, not leak an unresolved future
                                    raise LaneRetired(
                                        "lane retired with unadmittable "
                                        "pending rows")
                                self._retired = True
                                return
                            self._cond.wait(
                                timeout=max(0.05,
                                            idle_s - (now - idle_since)))
                    self._flush_counts()
                    self._sched._maybe_fault(self)
                    self._dispatch_step()
                    self._retire_rows()
                    self._maybe_checkpoint()
                    self._flush_handoff(block=not self._h_active.any())
        except Exception as exc:  # containment seam: rows bounce, not hang
            self._fail_all(exc)
        finally:
            with self._cond:
                self._retired = True
            self._flush_counts()
            self._sched._lane_done(self)

    def _flush_counts(self) -> None:
        while self._deferred_counts:
            self._sched._count(**self._deferred_counts.pop(0))

    def _mark(self) -> torch.cuda.Event | None:
        """An event after the work queued so far on the lane's card (None
        on the CPU, where every op has finished when it returns)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device).record_event()

    def _index(self, slots: list[int]) -> torch.Tensor:
        return _fresh(np.asarray(slots, np.int64), self.device)

    def _alloc_dev(self, job: _RowJob) -> None:
        w = self.width
        x = torch.zeros((w,) + tuple(job.x0.shape[1:]), dtype=job.x0.dtype,
                        device=self.device)
        self._dev = {
            "x": x,
            "old": torch.zeros_like(x),
            "known": torch.zeros_like(x),
            "mask": torch.ones((w, 1) + tuple(x.shape[2:]),
                               dtype=torch.float32, device=self.device),
            "idx": torch.zeros(w, dtype=torch.int64, device=self.device),
            "ctx_u": torch.zeros((w,) + tuple(job.ctx_u.shape[1:]),
                                 dtype=job.ctx_u.dtype, device=self.device),
            "ctx_c": torch.zeros((w,) + tuple(job.ctx_c.shape[1:]),
                                 dtype=job.ctx_c.dtype, device=self.device),
            "pooled_u": torch.zeros((w,) + tuple(job.pooled_u.shape[1:]),
                                    dtype=job.pooled_u.dtype,
                                    device=self.device),
            "pooled_c": torch.zeros((w,) + tuple(job.pooled_c.shape[1:]),
                                    dtype=job.pooled_c.dtype,
                                    device=self.device),
        }
        if job.cond0 is not None:
            self._dev["cond"] = torch.zeros(
                (w,) + tuple(job.cond0.shape[1:]), dtype=job.cond0.dtype,
                device=self.device)
        if self.reuse:
            unet = self.pipe.c.unet
            shape = (w, unet.config.block_out_channels[1]) + tuple(x.shape[2:])
            for half in ("cache_u", "cache_c"):
                self._dev[half] = torch.zeros(shape, dtype=param_dtype(unet),
                                              device=self.device)
        self._sync_tables()

    def _sync_tables(self) -> None:
        """Rebuild the device copies of the host-mirrored per-row inputs
        (each from a private copy: the step queued before may still read
        the previous ones, and admission mutates the mirrors in place)."""
        dev = self._dev
        dev["start"] = _fresh(self._h_start, self.device)
        dev["sig"] = _fresh(self._h_sig, self.device)
        dev["ts"] = _fresh(self._h_ts, self.device)
        dev["guid"] = _fresh(self._h_guid, self.device)
        dev["active"] = _fresh(self._h_active, self.device)
        dev["mask_on"] = _fresh(self._h_mask_on, self.device)
        dev["cscale"] = _fresh(self._h_cscale, self.device)

    def _admit_locked(self) -> None:
        """Splice pending jobs into free row slots: the step boundary is
        wherever the lane thread is between dispatches. Admission is FIFO; the
        job's tensors were queued by the submitting thread on the same
        stream, so they are ready before anything queued here reads them.
        Under a brownout cap (``self._admit_cap``) at most that many rows
        splice in at one boundary; the first pending job always admits."""
        cap = self._admit_cap
        admitted_rows = 0
        free = [s for s in range(self.width) if self._rows[s] is None]
        while self._pending and self._pending[0].n_rows <= len(free):
            if (cap is not None and admitted_rows > 0
                    and admitted_rows + self._pending[0].n_rows > cap):
                break
            job = self._pending.popleft()
            if job.future.cancelled():
                continue
            slots = ([s for s in job.slots0 if s in free]
                     if job.slots0 else [])
            if len(slots) != job.n_rows:
                slots = free[:job.n_rows]
            free = [s for s in free if s not in slots]
            admitted_rows += job.n_rows
            if self._dev is None:
                self._alloc_dev(job)
            mid_flight = bool(self._h_active.any())
            sel = self._index(slots)
            dev = self._dev
            dev["x"].index_copy_(0, sel, job.x0)
            # a resumed row brings its multistep history and rejoins at
            # its step; a fresh one starts clean at its workload's start
            if job.old0 is None:
                dev["old"].index_fill_(0, sel, 0.0)
            else:
                dev["old"].index_copy_(0, sel, job.old0)
            dev["idx"].index_fill_(0, sel, job.idx0)
            if job.known0 is None:
                dev["known"].index_fill_(0, sel, 0.0)
                dev["mask"].index_fill_(0, sel, 1.0)
            else:
                dev["known"].index_copy_(0, sel, job.known0)
                dev["mask"].index_copy_(0, sel, job.mask0)
            dev["ctx_u"].index_copy_(0, sel, job.ctx_u)
            dev["ctx_c"].index_copy_(0, sel, job.ctx_c)
            dev["pooled_u"].index_copy_(0, sel, job.pooled_u)
            dev["pooled_c"].index_copy_(0, sel, job.pooled_c)
            if job.cond0 is not None:
                dev["cond"].index_copy_(0, sel, job.cond0)
                self._h_cscale[slots] = job.cscale
            if self.reuse:
                # a fresh row starts cache-invalid (its first step runs the
                # full network); a resumed one brings its checkpointed state
                for half, rows0 in (("cache_u", job.cache_u0),
                                    ("cache_c", job.cache_c0)):
                    if rows0 is None:
                        dev[half].index_fill_(0, sel, 0.0)
                    else:
                        dev[half].index_copy_(0, sel, rows0)
                self._h_reuse[slots, :] = False
                for step_j in job.reuse_schedule:
                    if 0 <= int(step_j) < self.steps_cap:
                        self._h_reuse[slots, int(step_j)] = True
                self._h_cache_ok[slots] = job.cache_ok0
                self._h_skipped[slots] = job.skipped0
            self._h_idx[slots] = job.idx0
            self._h_start[slots] = job.start_step
            self._h_mask_on[slots] = job.known0 is not None
            self._h_sig[slots, :] = 0.0
            self._h_sig[slots, : job.steps + 1] = job.sigmas
            self._h_ts[slots, :] = 0.0
            self._h_ts[slots, : job.steps] = job.timesteps
            self._h_guid[slots] = job.guidance
            self._h_active[slots] = True
            for s, gen in zip(slots, job.generators):
                self._gens[s] = gen
            self._sync_tables()
            for s in slots:
                self._rows[s] = job
            job.slots = slots
            job.admitted_at_step = self.steps_executed
            job.admitted_t = time.perf_counter()
            # deferred: submitters hold sched._lock while waiting on
            # self._cond, and _count takes sched._lock
            self._deferred_counts.append(dict(
                rows_admitted=job.n_rows,
                rows_admitted_midflight=job.n_rows if mid_flight else 0,
                rows_resumed=job.n_rows if job.resume_step > 0 else 0,
                **{f"rows_admitted_{job.workload}": job.n_rows}))
            # metric-local locks only: safe under self._cond
            _LANE_ADMISSIONS.inc(job.n_rows, workload=job.workload)
            if job.resume_step > 0:
                _RESUME_STEP.observe(job.resume_step)
                log.info("job %s resumed at step %d/%d (%d row(s))",
                         job.job_id, job.resume_step, job.steps, job.n_rows)

    def _resize_locked(self, width_limit: int | None, rate: float,
                       hint_rows: int) -> None:
        """Adaptive capacity, applied only here: between dispatches, under
        ``self._cond``. The poll hint's rows count as pending (the
        scheduler burns the hint down as they land, so no row counts
        twice)."""
        if not self._adaptive:
            return
        occupied = sum(r is not None for r in self._rows)
        pending = sum(j.n_rows for j in self._pending
                      if not j.future.cancelled())
        target = self._ctl.decide(self.width, occupied,
                                  pending + max(0, hint_rows), rate,
                                  max_width=width_limit)
        if target != self.width:
            self._apply_resize_locked(target)

    def _apply_resize_locked(self, new_width: int) -> None:
        """Rebuild the row file at ``new_width``: resident rows compact onto
        the first slots (their device state gathered across), the host
        mirrors re-seed."""
        old_width, self.width = self.width, int(new_width)
        occupied = [(s, self._rows[s]) for s in range(old_width)
                    if self._rows[s] is not None]
        grow = self.width > old_width
        log.info("lane %d %s %d -> %d rows (%d resident)", self.lane_id,
                 "grows" if grow else "shrinks", old_width, self.width,
                 len(occupied))
        _LANE_RESIZES.inc(direction="grow" if grow else "shrink")
        self._deferred_counts.append(dict(lane_resizes=1))
        old_h, old_gens = self._mirrors(), self._gens
        self._new_mirrors()
        for new_s, (old_s, _) in enumerate(occupied):
            for old_m, new_m in zip(old_h, self._mirrors()):
                new_m[new_s] = old_m[old_s]
            self._gens[new_s] = old_gens[old_s]
        self._rows = [None] * self.width
        for new_s, (_, job) in enumerate(occupied):
            self._rows[new_s] = job
        for job in {id(j): j for _, j in occupied}.values():
            job.slots = [s for s, (_, j) in enumerate(occupied) if j is job]
        if self._dev is not None:
            sel = self._index([old_s for old_s, _ in occupied])

            def remap(arr: torch.Tensor) -> torch.Tensor:
                taken = arr.index_select(0, sel)
                pad = self.width - taken.shape[0]
                if pad <= 0:
                    return taken
                return torch.cat([taken, arr.new_zeros(
                    (pad,) + tuple(arr.shape[1:]))])

            for name in ("x", "old", "known", "mask", "idx", "ctx_u",
                         "ctx_c", "pooled_u", "pooled_c", "cond", "cache_u",
                         "cache_c"):
                if name in self._dev:
                    self._dev[name] = remap(self._dev[name])
            self._sync_tables()

    @contextlib.contextmanager
    def _watched(self, budget: float | None, what: str):
        """Arm the watchdog around a stretch of the lane thread that may
        wait on the card (JAX :1026-1091). If it fired meanwhile, the lane
        was condemned from the monitor thread; condemn again here (a no-op
        unless this thread got back first) and leave the lane thread."""
        if budget is None:
            yield
            return
        ticket = _guard.WATCHDOG.arm(
            budget, lambda: self.condemn(
                f"{what} exceeded its {budget:.1f}s hang budget"),
            tag=f"lane-{self.lane_id}-{what}")
        try:
            yield
        finally:
            fired = _guard.WATCHDOG.disarm(ticket)
        if fired:
            self.condemn(f"{what} exceeded its hang budget")
            raise LaneRetired(f"lane {self.lane_id} condemned by the hang "
                              f"watchdog at {what}")

    def _dispatch_step(self) -> None:
        dev = self._dev
        this_step = self.steps_executed + 1
        # the chaos plan, re-read at each dispatch; its trigger steps count
        # from the dispatch that first saw it
        chaos = _guard.LaneChaos.from_env()
        if not chaos.armed:
            self._chaos_base = self._chaos_seen = None
        elif chaos != self._chaos_seen:
            self._chaos_base = self.steps_executed
            self._chaos_seen = chaos
        chaos_step = (this_step - self._chaos_base
                      if self._chaos_base is not None else 0)
        # a lane's first dispatch at a width, and the first after a
        # cache_flush rung, pay warm-up: the ceiling budget, not k x EWMA
        epoch = _guard.flush_epoch()
        if epoch != self._flush_epoch:
            self._flush_epoch = epoch
            self._warm_widths.clear()
        budget = self._sched.hang_budget()
        if budget is not None and self.width not in self._warm_widths:
            budget = _guard.hang_budget_s(0.0)
        gens: list[torch.Generator | None] = [None] * self.width
        if self.sampler.kind in NOISY_KINDS:
            gens = [self._gens[s] if self._h_active[s] else None
                    for s in range(self.width)]
        # renoise only for active inpaint rows; a lane without one
        # re-projects nothing
        masked = self._h_active & self._h_mask_on
        renoise = ([self._gens[s] if masked[s] else None
                    for s in range(self.width)] if masked.any() else None)
        # the DeepCache decision, on the host, for the whole lane: replay
        # only when every active row wants reuse at its step and holds a
        # valid cache; a misaligned mate makes this a full eval
        reuse_now = False
        if self.reuse and self._h_active.any():
            step_of = np.minimum(self._h_idx, self.steps_cap - 1)
            wants = self._h_reuse[np.arange(self.width), step_of]
            reuse_now = bool(np.all(
                ~self._h_active | (wants & self._h_cache_ok)))
        cache = ((dev["cache_u"], dev["cache_c"]) if self.reuse else None)
        t0 = time.perf_counter()
        with self._watched(budget, f"step {this_step}"), \
                annotate("swarm.lane.step"):
            out = self.pipe.stepper_step(
                sampler=self.sampler, ctx_u=dev["ctx_u"], ctx_c=dev["ctx_c"],
                x=dev["x"], idx=dev["idx"], start_idx=dev["start"],
                sigmas=dev["sig"], timesteps=dev["ts"], guidance=dev["guid"],
                old_denoised=dev["old"], active=dev["active"],
                generators=gens, pooled_u=dev["pooled_u"],
                pooled_c=dev["pooled_c"], known=dev["known"],
                mask=dev["mask"], mask_on=dev["mask_on"],
                renoise_generators=renoise, control=self.key[4],
                cond=dev.get("cond"), cscale=dev["cscale"], cache=cache,
                reuse_now=reuse_now)
            dev["x"], dev["idx"], dev["old"] = out[:3]
            if self.reuse:
                dev["cache_u"], dev["cache_c"] = out[3]
            wedge_s = chaos.wedge_at(chaos_step)
            if wedge_s > 0:  # the scripted stand-in for a wedged card
                log.warning("chaos: wedging lane %d step %d for %.1fs",
                            self.lane_id, this_step, wedge_s)
                time.sleep(wedge_s)
            # throttle: at most two dispatched steps in flight, so the
            # host cannot run away from the device and execution errors
            # surface here, inside the lane thread's containment try
            self._window.append(self._mark())
            if len(self._window) > 2:
                event = self._window.popleft()
                if event is not None:
                    event.synchronize()
        self._warm_widths.add(self.width)
        nan_row = chaos.nan_wants(chaos_step)
        if nan_row is not None:
            # spent only on an active row that steps on past this
            # boundary, so a checkpoint's finite check (or the decode's
            # screen) is what catches it
            row = min(max(0, int(nan_row)), self.width - 1)
            victim = self._rows[row]
            if (victim is not None and self._h_active[row]
                    and int(self._h_idx[row]) + 1 < victim.steps
                    and _guard.consume_chaos("nan")):
                log.warning("chaos: poisoning lane %d row %d with NaN "
                            "after step %d", self.lane_id, row, this_step)
                dev["x"][row] = float("nan")
        active = int(self._h_active.sum())
        if reuse_now:
            # every active row skipped its deep blocks this step
            self._h_skipped[self._h_active] += 1
            _UNET_EVALS.inc(active, mode="reuse")
            _STEPS_SKIPPED.inc(active)
            self._sched._count(steps_reused=1, row_steps_reused=active)
        else:
            if self.reuse:  # a full step refreshed every active row's cache
                self._h_cache_ok[self._h_active] = True
            _UNET_EVALS.inc(active, mode="full")
        self._h_idx[self._h_active] += 1
        self.steps_executed += 1
        self._sched._count(steps_executed=1, row_steps_active=active,
                           row_steps_padded=self.width - active)
        _LANE_OCCUPANCY.observe(active / self.width, width=str(self.width))
        step_s = time.perf_counter() - t0
        slow_extra = chaos.slow_extra_s(step_s)
        if slow_extra > 0:  # chaos: the sick but living card
            time.sleep(slow_extra)
            step_s += slow_extra
        _STEP_SECONDS.observe(step_s)
        # the lane's first step pays cuDNN's and the allocator's warm-up:
        # it does not feed the EWMA the hang budget reads
        ewma_before = self._sched.step_ewma()
        if self.steps_executed > 1:
            self._sched.note_step_seconds(step_s)
        device_guard = getattr(self._sched.slot, "_guard", None)
        if device_guard is not None:
            devices = _guard._slot_devices(self._sched.slot)
            if ewma_before > 0 and step_s > _guard.slow_factor() * \
                    ewma_before:
                self._sched._count(steps_slow=1)
                device_guard.note_slow_step(devices)
            else:
                device_guard.note_ok(devices)

    def _retire_rows(self) -> None:
        """Retire finished rows (their decode is queued and overlaps the
        next steps) and expire rows past their deadline."""
        now = time.monotonic()
        done: list[_RowJob] = []
        expired: list[_RowJob] = []
        for s, job in enumerate(self._rows):
            if job is None or not self._h_active[s]:
                continue
            if self._h_idx[s] >= job.steps and job not in done:
                done.append(job)
            elif (now > job.deadline and job not in expired
                    and self._h_idx[s] < job.steps):
                expired.append(job)
        changed = False
        for job in done:
            rows_x = self._dev["x"].index_select(0, self._index(job.slots))
            bucket = bucket_batch(job.n_rows)
            if job.n_rows < bucket:  # the solo decode's batch bucket
                rows_x = torch.cat([rows_x, rows_x[-1:].expand(
                    (bucket - job.n_rows,) + tuple(rows_x.shape[1:]))])
            with annotate("swarm.lane.decode"):
                images = self.pipe.stepper_decode(rows_x)
            if images.device.type == "cuda":
                # queue the copy to the host behind the decode: the job's
                # collector then reads host memory, not the lane's queue
                host = torch.empty(images.shape, dtype=images.dtype,
                                   pin_memory=True)
                images = host.copy_(images, non_blocking=True)
            pending = PendingImages(
                device_images=images,
                compiled_hw=(self.height, self.width_px),
                requested_hw=(self.height, self.width_px),
                requested_batch=job.n_rows)
            info = {
                "lane": self.lane_id,
                "lane_width": self.width,
                "admitted_at_step": job.admitted_at_step,
                "steps_executed": self.steps_executed,
                "resume_step": job.resume_step,
                "splice_wait_s": round(
                    max(0.0, job.admitted_t - job.submitted_t), 6)
                if job.admitted_t else 0.0,
            }
            # the full evals this row paid over its whole trajectory (the
            # skipped tally survives a resume), observed once per row
            skipped = (int(self._h_skipped[job.slots[0]])
                       if self.reuse and job.slots else 0)
            evals = (job.steps - job.start_step) - skipped
            for _ in range(job.n_rows):
                _EVALS_PER_IMAGE.observe(evals)
            if self.reuse:
                info["unet_evals"] = evals
                info["steps_skipped"] = skipped
            # handoff BEFORE releasing the slots: busy() reads "_pending or
            # _handoff or _rows", so releasing first would let a draining
            # caller see an idle lane while this future is unresolved
            self._handoff.append((job, pending, info, self._mark()))
            self._release_rows(job)
            changed = True
            self._sched._count(rows_completed=job.n_rows)
        for job in expired:
            # the caller wakes on set_exception: the count lands first, and
            # the slots stop counting toward busy() only after
            self._sched._count(rows_expired=job.n_rows)
            if not job.future.done():
                job.future.set_exception(LaneDeadline(
                    f"row(s) of job {job.job_id} exceeded the in-lane "
                    f"deadline"))
            self._release_rows(job)
            changed = True
        if changed:
            with self._cond:
                self._cond.notify_all()

    def _maybe_checkpoint(self) -> None:
        """Every ``CHIASWARM_STEPPER_CKPT_EVERY`` lane steps (JAX
        :1246-1354): copy the lane's latents and history to the host (the
        copy waits for every queued step, under the watchdog), retire each
        job whose rows are not finite (:meth:`_poison_rows`) and keep each
        other job's resume state: JAX's envelope keys, the rows' latents and
        history in NCHW, and under ``generators`` each row's
        ``torch.Generator`` state. The states are read here, in the thread
        that draws from them, after the dispatch of the step whose latents
        the copy holds, so draws and latents agree. The state goes to the
        in-memory twin the guard resumes a condemned lane from, and, with
        the worker's spool attached, to the spool by the hive's job id
        (a failed write never fails the lane). Rows at their start or about
        to retire keep no checkpoint.

        The numerics probe ``lane_row`` rides the same copy (JAX
        :1263-1297): enabled, it opens the boundary even with the spool,
        the watchdog and the output checks off, and records each active
        row's latents (step = the row's step index, shard = its slot, note
        = the job id) before the finite screen, so a poisoned row's step is
        on the record. Set ``CHIASWARM_STEPPER_CKPT_EVERY=1`` for a record
        every step."""
        validate = _guard.validation_enabled()
        want_ckpt = self._spool is not None or _guard.watchdog_enabled()
        numerics_on = _numerics.enabled_for("lane_row")
        if (self._ckpt_every <= 0 or self._dev is None
                or not (validate or want_ckpt or numerics_on)
                or self.steps_executed % self._ckpt_every):
            return
        jobs = {id(j): j for j in self._rows if j is not None}
        if not jobs:
            return
        t0 = time.perf_counter()
        with self._watched(self._sched.hang_budget(),
                           f"checkpoint at step {self.steps_executed}"):
            x = self._dev["x"].to("cpu")
            if want_ckpt:
                old = self._dev["old"].to("cpu")
                if self.reuse:
                    cache_u = self._dev["cache_u"].to("cpu")
                    cache_c = self._dev["cache_c"].to("cpu")
        written = 0
        poisoned: list[_RowJob] = []
        for job in jobs.values():
            sel = list(job.slots)
            if numerics_on:
                for s in sel:
                    _numerics.record_host(
                        "lane_row", x[s], step=int(self._h_idx[s]),
                        shard=s, note=str(job.job_id))
            if validate and not bool(torch.isfinite(x[sel]).all()):
                poisoned.append(job)
                continue
            step = int(self._h_idx[sel[0]])
            if not want_ckpt or step <= job.start_step or step >= job.steps:
                continue
            state = {
                "version": CKPT_VERSION, "kind": "lane",
                "step": step, "steps": int(job.steps),
                "rows": int(job.n_rows),
                "height": int(self.height), "width": int(self.width_px),
                "guidance": float(job.guidance),
                "workload": str(job.workload),
                "start": int(job.start_step),
                "x": pack_array(x[sel]),
                "old": pack_array(old[sel]),
                "generators": [pack_array(self._gens[s].get_state())
                               for s in sel],
                "slots": [int(s) for s in sel],
            }
            if self.reuse:
                # the deep caches, their validity and the skipped tally:
                # a resumed row replays the remaining reuse decisions bit
                # for bit; the schedule is recorded for validation
                state.update({
                    "reuse_schedule": [int(j) for j in job.reuse_schedule],
                    "cache_u": pack_array(cache_u[sel]),
                    "cache_c": pack_array(cache_c[sel]),
                    "cache_ok": bool(self._h_cache_ok[sel[0]]),
                    "skipped": int(self._h_skipped[sel[0]]),
                })
            self._ckpt_mem[id(job)] = state
            if self._spool is None or job.job_id is None:
                continue
            try:
                self._spool.save(job.job_id, state)
                written += 1
            except OSError as exc:  # durability never fails the lane
                log.warning("checkpoint for job %s failed: %s", job.job_id,
                            exc)
        for job in poisoned:
            self._poison_rows(job)
        if written:
            self._sched._count(checkpoints_written=written)
        _CKPT_SECONDS.observe(time.perf_counter() - t0)

    def _poison_rows(self, job: _RowJob) -> None:
        """Retire one job's rows as numerically poisoned (JAX :1356-1374):
        they never decode, the job fails with :class:`InvalidOutput` (a
        non-fatal ``invalid_output`` envelope) and the lane's other jobs
        step on."""
        step = int(self._h_idx[job.slots[0]]) if job.slots else 0
        # the caller wakes on set_exception: the count lands first, and the
        # slots stop counting toward busy() only after
        self._sched._count(rows_invalid=job.n_rows)
        if not job.future.done():
            job.future.set_exception(InvalidOutput(
                f"job {job.job_id}: non-finite latents at step {step}; "
                f"row(s) retired without decoding"))
        self._release_rows(job)
        log.error("lane %d: job %s poisoned (non-finite latents at step "
                  "%d); %d row(s) retired invalid_output, peers keep "
                  "stepping", self.lane_id, job.job_id, step, job.n_rows)
        with self._cond:
            self._cond.notify_all()

    def _flush_handoff(self, block: bool) -> None:
        """Resolve retired rows whose decoded images are resident. With
        ``block=False`` (rows still stepping) in-flight decodes stay queued
        and resolve at a later boundary; with ``block=True`` (lane idle)
        the lane thread waits them out, under the watchdog."""
        while self._handoff:
            job, pending, info, event = self._handoff[0]
            if event is not None:
                if block:
                    with self._watched(self._sched.hang_budget(),
                                       f"decode of job {job.job_id}"):
                        event.synchronize()
                elif not event.query():
                    return
            self._handoff.popleft()
            if not job.future.cancelled():
                job.future.set_result((pending, info))

    def _release_rows(self, job: _RowJob) -> None:
        for s in job.slots:
            self._rows[s] = None
            self._h_active[s] = False
            self._h_mask_on[s] = False
            self._gens[s] = None
        self._ckpt_mem.pop(id(job), None)
        if self._dev is not None:
            self._sync_tables()

    def _fail_all(self, exc: Exception) -> None:
        # retired rows with queued decodes: deliver if the decode survives
        while self._handoff:
            job, pending, info, event = self._handoff.popleft()
            try:
                if event is not None:
                    event.synchronize()
                if not job.future.done():
                    job.future.set_result((pending, info))
            except Exception:  # the device failed the decode too
                if not job.future.done():
                    job.future.set_exception(exc)
        with self._cond:
            # retire BEFORE draining: a racing submit must see a dead lane
            # (and open a fresh one), not append a job nobody resolves
            self._retired = True
            jobs = {id(j): j for j in self._rows if j is not None}
            jobs.update({id(j): j for j in self._pending})
            self._pending.clear()
            for s in range(self.width):
                self._rows[s] = None
            self._h_active[:] = False
        failed_rows = 0
        for job in jobs.values():
            failed_rows += job.n_rows
            if not job.future.done():
                job.future.set_exception(exc)
        if jobs:
            # remember (key, width) before collectors wake: note_oom may run
            # after _lane_done has deregistered this lane
            self._sched._note_lane_failure(self.key, self.width)
            self._sched._count(rows_failed=failed_rows, lanes_failed=1)
            log.warning("lane %d failed (%s): %d row(s) bounced to the "
                        "per-job path", self.lane_id, exc, failed_rows)
        self._dev = None
        self._window.clear()


class StepScheduler:
    """Owns the lanes of one slot; thread-safe submit/stats/drain. Lock
    order: ``self._lock`` before a lane's ``_cond``, never the reverse."""

    def __init__(self, slot: Any = None) -> None:
        self.slot = slot
        self._lock = threading.Lock()
        self._lanes: dict[tuple, Lane] = {}
        # the OOM-halved width cap per lane key
        self._width_limits = _ByPipe()
        self._stats: collections.Counter = collections.Counter()
        self._fault: list[tuple[int, Exception]] = []
        self._total_steps = 0
        self._last_oom_incident = -1
        # (key -> width) of failed lanes: note_oom must find the lane that
        # just died even after _lane_done removed it
        self._failed_lane_hints = _ByPipe()
        # the demand signal: submissions feed the rows/s EWMA; the worker's
        # poll leaves a short-lived hint of the rows about to land
        self._arrivals = ArrivalEwma()
        self._poll_hint_rows = 0
        self._poll_hint_t = float("-inf")
        self._step_ewma = 0.0
        # condemned lanes whose threads may still be inside the wedged
        # step: shutdown joins them too
        self._condemned: list[Lane] = []
        # the brownout cap the worker's overload controller pushes
        self._admission_cap: int | None = None
        _register_for_exit(self)

    # ---- policy ----

    def lane_width(self, height: int, width: int) -> int:
        """Pinned width (``CHIASWARM_STEPPER_LANE_WIDTH``) or the static
        slot-saturation heuristic: data width x the per-device profitable
        batch, pow2-bucketed. With the adaptive controller on this only
        anchors :meth:`width_bounds`."""
        env = os.environ.get(ENV_LANE_WIDTH, "").strip()
        if env:
            width_rows = int(env)
        else:
            from chiaswarm_tpu_torch.node.executor import single_chip_rows

            data_width = max(1, int(getattr(self.slot, "data_width", 1)))
            per_device = single_chip_rows({"height": height, "width": width})
            width_rows = bucket_batch(max(2, data_width * per_device))
        return max(1, width_rows)

    def width_bounds(self, height: int, width: int) -> tuple[int, int]:
        """(min, max) lane width for the adaptive controller: 1 to 4x the
        saturation heuristic (pow2, at most 128). A pinned width collapses
        the range to a point."""
        if not adaptive_enabled():
            pinned = self.lane_width(height, width)
            return pinned, pinned
        env_min = os.environ.get(ENV_MIN_WIDTH, "").strip()
        env_max = os.environ.get(ENV_MAX_WIDTH, "").strip()
        lo = max(1, int(env_min)) if env_min else 1
        if env_max:
            hi = bucket_batch(min(128, max(1, int(env_max))))
        else:
            hi = bucket_batch(min(128, 4 * self.lane_width(height, width)))
        return min(lo, hi), max(lo, hi)

    def initial_width(self, rows: int, height: int, width: int) -> int:
        """A fresh lane opens just big enough for its first job plus one
        more row, and the controller follows demand from there."""
        lo, hi = self.width_bounds(height, width)
        if not adaptive_enabled():
            return hi
        return max(lo, min(hi, bucket_batch(max(2, int(rows)))))

    def row_deadline_s(self) -> float:
        return float(os.environ.get(ENV_ROW_DEADLINE, "600") or 600)

    # ---- demand and step signals ----

    def _note_arrival(self, rows: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._arrivals.note(int(rows), now)
            # the hinted rows landed (in part) as submissions: burn the
            # hint down, so no row counts as both pending and hinted
            self._poll_hint_rows = max(0, self._poll_hint_rows - int(rows))
            rate = self._arrivals.rate(now)
        _ARRIVAL_RATE.set(rate)

    def note_poll(self, jobs: int, now: float | None = None) -> None:
        """The worker's poll hook: a poll just returned ``jobs`` rows, about
        to be formatted and submitted. Lanes read the hint at their next
        step boundary and grow before the submissions land."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._poll_hint_rows = max(0, int(jobs))
            self._poll_hint_t = now

    def demand_signal(self, now: float | None = None) -> tuple[float, int]:
        """(arrival-rate EWMA in rows/s, the poll hint's rows while fresh),
        read by the lane threads outside their lane's lock."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rate = self._arrivals.rate(now)
            hint = (self._poll_hint_rows
                    if now - self._poll_hint_t <= POLL_HINT_S else 0)
        _ARRIVAL_RATE.set(rate)
        return rate, hint

    def width_limit_for(self, key: tuple) -> int | None:
        """The OOM-halving width cap for ``key`` (:meth:`note_oom`), read by
        the lane thread before each boundary."""
        with self._lock:
            return self._width_limits.get(key)

    def set_admission_cap(self, rows: int | None) -> None:
        """Brownout rung (``node/overload.py``): at most ``rows`` lane rows
        admitted per step boundary (None or 0 = uncapped). The worker pushes
        it on every poll and every shed."""
        with self._lock:
            self._admission_cap = (None if not rows or int(rows) <= 0
                                   else int(rows))

    def admission_cap(self) -> int | None:
        with self._lock:
            return self._admission_cap

    def note_step_seconds(self, seconds: float) -> None:
        """Lane threads feed each step's wall time (throttle included): the
        hang budgets, the slow-step signal and the overload estimator's lane
        floor read its EWMA."""
        with self._lock:
            self._step_ewma = (float(seconds) if self._step_ewma <= 0.0
                               else self._step_ewma + 0.25 * (
                                   float(seconds) - self._step_ewma))

    def step_ewma(self) -> float:
        """The step-seconds EWMA (0.0 while cold): the hang budgets and the
        slow-step signal read it."""
        with self._lock:
            return self._step_ewma

    def hang_budget(self) -> float | None:
        """The watchdog's budget for one lane step (JAX :1598-1613): k x
        the step EWMA between the floor and ceiling knobs, the ceiling
        while cold; None with the guard off (``CHIASWARM_GUARD=0``)."""
        if not _guard.watchdog_enabled():
            return None
        return _guard.hang_budget_s(self.step_ewma())

    # ---- submission ----

    def submit_request(self, pipe, *, prompt: str, negative_prompt: str = "",
                       steps: int = 30, guidance_scale: float = 7.5,
                       height: int | None = None, width: int | None = None,
                       rows: int = 1, seed: int = 0,
                       scheduler: str | None = None,
                       deadline_s: float | None = None,
                       job_id: Any = None,
                       resume: dict[str, Any] | None = None,
                       init_image: Any = None, strength: float = 0.8,
                       mask: Any = None, controlnet: Any = None,
                       control_image: Any = None,
                       control_scale: float = 1.0,
                       reuse_schedule: Any = None) -> Future:
        """Prepare a job's rows (tokenize, encode, ladder, initial noise;
        for img2img and inpaint the init image's VAE encode and the latent
        mask) and hand them to the matching lane. Returns a Future of
        ``(PendingImages, lane_info)``; raises :class:`LaneReject` when the
        job cannot ride a lane.

        ``init_image`` makes the rows img2img: ``strength`` maps to their
        start index as the solo path quantizes it. ``mask`` (with
        ``init_image``) makes them inpaint: they start at 0 and carry the
        clean latents and the latent-grid mask. The image is encoded with
        the job's own seed through the solo path's batch-1 encode
        (``pipelines/diffusion.py::encode_init_image``) and shared by the
        job's rows. ``controlnet`` (a ``ControlNetBundle``, with exactly one
        ``control_image`` and no init image or mask) routes the job to that
        bundle's lane; its hint is embedded here, once, and rides each row
        with ``control_scale``.

        ``resume`` (a lane checkpoint, :meth:`Lane._maybe_checkpoint`)
        replaces the fresh noise: the rows splice in at its step with its
        latents, history and generator states; an image row's start,
        ``known`` and mask come from the job's own inputs as above. A
        payload :meth:`_validate_resume` refuses is logged and counted
        (``resumes_rejected``), and the job restarts at step 0.

        ``reuse_schedule`` (with ``CHIASWARM_DEEPCACHE`` on, and no
        ``controlnet``: ignored otherwise, as in JAX) sends the job to a
        DeepCache lane of its key; one that does not normalize is a
        :class:`LaneReject`."""
        fam = pipe.c.family
        if fam.kind != "sd" or fam.image_conditioned:
            raise LaneReject(f"family {fam.name!r} does not ride lanes")
        sampler = resolve(scheduler, prediction_type=fam.prediction_type)
        if float(guidance_scale) <= 1.0 and sampler.kind not in FEWSTEP_KINDS:
            raise LaneReject("guidance <= 1 runs the solo (no-CFG) path")
        if mask is not None and init_image is None:
            raise LaneReject("inpainting requires an init image")
        if controlnet is not None and (control_image is None
                                       or mask is not None
                                       or init_image is not None):
            raise LaneReject("controlnet lanes take exactly a "
                             "conditioning image")
        height, width = bucket_image_size(int(height or fam.default_size),
                                          int(width or fam.default_size))
        steps = max(1, int(steps))
        try:
            bucket_steps(steps)  # the capacity lattice bounds a lane row
        except ValueError as exc:
            raise LaneReject(str(exc)) from exc
        rows = max(1, int(rows))
        bounds = self.width_bounds(height, width)
        if rows > bounds[1]:
            raise LaneReject(
                f"{rows} rows exceed the lane width cap {bounds[1]}")
        reuse: tuple[int, ...] = ()
        if reuse_schedule and deepcache_enabled() and controlnet is None:
            # the schedule lies inside the executed ladder: img2img's
            # starts at its strength's index
            _, start0 = image_plan(steps, strength, init_image is not None,
                                   mask is not None)
            try:
                reuse = normalize_reuse_schedule(steps, reuse_schedule,
                                                 start0)
            except ValueError as exc:
                # the solo path raises the canonical user error
                raise LaneReject(str(exc)) from exc
        # the pipeline (and a control lane's bundle) key the lane: held by
        # reference, never id(); DeepCache lanes are keyed apart
        key = (pipe, height, width, sampler, controlnet, bool(reuse))
        lane_rows = self.initial_width(rows, height, width)
        limit = self.width_limit_for(key)
        if limit is not None and limit < lane_rows:
            lane_rows = max(rows, limit)
        self._note_arrival(rows)

        t_prep = time.perf_counter()
        with obs_trace.span("encode", rows=rows, steps=steps):
            sched = make_sampling_schedule(pipe.noise_schedule, steps,
                                           sampler)
            eb = bucket_batch(rows)
            ids = pipe._tokenize([prompt or ""] * eb)
            neg = pipe._tokenize([negative_prompt or ""] * eb)
            ctx_u, ctx_c, pooled_u, pooled_c = pipe.stepper_encode(ids, neg)
            workload, start_step, init_rows, mask_rows = \
                pipe.prepare_image_rows(init_image, mask, strength, steps,
                                        height, width, int(seed), rows)
            cond_rows = None
            if controlnet is not None:
                workload = "controlnet"
                cond_rows = pipe.stepper_control_embed(
                    controlnet, control_image, height, width
                ).expand(rows, -1, -1, -1)
            restored = None
            if resume is not None:
                try:
                    restored = self._validate_resume(
                        pipe, resume, steps=steps, rows=rows, height=height,
                        width=width, guidance=float(guidance_scale),
                        start=start_step, workload=workload,
                        reuse_schedule=reuse)
                except ResumeReject as exc:
                    log.error("resume state for job %s rejected (%s); "
                              "restarting at step 0", job_id, exc)
                    self._count(resumes_rejected=1)
            resume_step, old0, slots0 = 0, None, ()
            cache_u0 = cache_c0 = None
            cache_ok0, skipped0 = False, 0
            if restored is not None:
                resume_step = restored["step"]
                slots0 = restored["slots"]
                generators = restored["generators"]
                x0 = upload(restored["x"], pipe.c.device)
                old0 = upload(restored["old"], pipe.c.device)
                if reuse:
                    # the deep caches, validity and tally splice back in:
                    # the remaining reuse decisions replay bit for bit
                    cache_u0 = upload(restored["cache_u"], pipe.c.device)
                    cache_c0 = upload(restored["cache_c"], pipe.c.device)
                    cache_ok0 = restored["cache_ok"]
                    skipped0 = restored["skipped"]
            else:
                # one generator per row, the solo path's (seed, row) pairs
                generators = row_generators([(int(seed), r)
                                             for r in range(rows)])
                x0 = pipe.stepper_row_init(
                    generators, sched.sigmas[start_step], height, width)
                if init_rows is not None:
                    # x = init + noise * sigma[start], the solo prologue
                    x0 = init_rows + x0
        _LANE_ADMIT_SECONDS.observe(time.perf_counter() - t_prep)
        job = _RowJob(
            job_id=job_id, n_rows=rows, steps=steps,
            guidance=float(guidance_scale),
            sigmas=sched.sigmas.numpy(), timesteps=sched.timesteps.numpy(),
            ctx_u=ctx_u[:rows], ctx_c=ctx_c[:rows], pooled_u=pooled_u[:rows],
            pooled_c=pooled_c[:rows], generators=generators,
            x0=x0, workload=workload, start_step=start_step,
            known0=init_rows if mask_rows is not None else None,
            mask0=mask_rows, cond0=cond_rows, cscale=float(control_scale),
            resume_step=resume_step, old0=old0, slots0=slots0,
            reuse_schedule=reuse,
            cache_u0=cache_u0, cache_c0=cache_c0, cache_ok0=cache_ok0,
            skipped0=skipped0,
            deadline=time.monotonic() + (deadline_s if deadline_s is not None
                                         else self.row_deadline_s()))
        self._enqueue(key, pipe, job, lane_rows, height, width, sampler,
                      bounds)
        return job.future

    def _validate_resume(self, pipe, resume: dict[str, Any], *, steps: int,
                         rows: int, height: int, width: int,
                         guidance: float, start: int,
                         workload: str,
                         reuse_schedule: tuple[int, ...] = ()
                         ) -> dict[str, Any]:
        """Hold a checkpoint against the job it claims to resume (JAX
        :1870-1985, with the port's noise state in place of the threefry
        keys): ``{"step", "x", "old", "generators"}`` on the host (and a
        DeepCache job's ``cache_u``, ``cache_c``, ``cache_ok``,
        ``skipped``), or :class:`ResumeReject`. Every field is hostile
        until proven: a JAX lane checkpoint (``keys``, no ``generators``) is
        refused, since its noise stream is not the port's, and so is one
        stepped under another reuse schedule."""
        if resume.get("kind") != "lane":
            raise ResumeReject(
                f"not a lane checkpoint (kind={resume.get('kind')!r})")
        if "keys" in resume or "generators" not in resume:
            raise ResumeReject(
                "a JAX-package lane checkpoint (threefry keys, no generator "
                "states): its noise stream is not this package's")
        try:
            step = int(resume["step"])
            ck_steps, ck_rows = int(resume["steps"]), int(resume["rows"])
            ck_h, ck_w = int(resume["height"]), int(resume["width"])
            ck_guidance = float(resume["guidance"])
            ck_start = int(resume.get("start", 0))
            ck_workload = str(resume.get("workload", "txt2img"))
            x = unpack_array(resume["x"])
            old = unpack_array(resume["old"])
            states = [unpack_array(g) for g in resume["generators"]]
        except (KeyError, TypeError, ValueError) as exc:
            raise ResumeReject(f"corrupt payload: {exc}") from exc
        if not start < step < steps:
            raise ResumeReject(f"step {step} outside ({start}, {steps})")
        if (ck_start, ck_workload) != (start, workload):
            raise ResumeReject(
                f"workload mismatch: checkpoint is {ck_workload} from "
                f"step {ck_start}, job is {workload} from {start}")
        if (ck_steps, ck_rows) != (steps, rows):
            raise ResumeReject(
                f"job mismatch: checkpoint is {ck_rows} row(s) x "
                f"{ck_steps} step(s), job wants {rows} x {steps}")
        if (ck_h, ck_w) != (height, width):
            raise ResumeReject(f"size mismatch: checkpoint {ck_h}x{ck_w}, "
                               f"job {height}x{width}")
        if ck_guidance != guidance:
            raise ResumeReject(f"guidance mismatch: checkpoint "
                               f"{ck_guidance}, job {guidance}")
        lh, lw = pipe._latent_hw(height, width)
        want = (rows, pipe.c.family.vae.latent_channels, lh, lw)
        if tuple(x.shape) != want or tuple(old.shape) != want:
            raise ResumeReject(f"latent shape {tuple(x.shape)} != {want}")
        if x.dtype != torch.float32 or old.dtype != torch.float32:
            raise ResumeReject(f"latent dtype {x.dtype}/{old.dtype}, lanes "
                               f"carry float32")
        if len(states) != rows:
            raise ResumeReject(f"{len(states)} generator states for "
                               f"{rows} row(s)")
        generators = []
        for state in states:
            gen = torch.Generator()
            try:
                gen.set_state(state)
            except (RuntimeError, TypeError, ValueError) as exc:
                raise ResumeReject(f"bad generator state: {exc}") from exc
            generators.append(gen)
        # the slots the rows held: a hint, kept only when it names one
        # distinct slot a row (a redelivered job lands where it stepped)
        slots = resume.get("slots")
        if not (isinstance(slots, list) and len(slots) == rows
                and len(set(slots)) == rows
                and all(isinstance(n, int) and n >= 0 for n in slots)):
            slots = []
        restored = {"step": step, "x": x, "old": old,
                    "generators": generators, "slots": tuple(slots)}
        try:
            ck_reuse = tuple(int(j) for j in
                             (resume.get("reuse_schedule") or ()))
        except (TypeError, ValueError) as exc:
            raise ResumeReject(f"corrupt reuse_schedule: {exc}") from exc
        if ck_reuse != tuple(reuse_schedule):
            raise ResumeReject(
                f"reuse-schedule mismatch: checkpoint {list(ck_reuse)}, "
                f"job {list(reuse_schedule)}")
        if reuse_schedule:
            try:
                cache_u = unpack_array(resume["cache_u"])
                cache_c = unpack_array(resume["cache_c"])
                cache_ok = bool(resume["cache_ok"])
                skipped = int(resume["skipped"])
            except (KeyError, TypeError, ValueError) as exc:
                raise ResumeReject(
                    f"corrupt DeepCache state: {exc}") from exc
            unet = pipe.c.unet
            want = (rows, unet.config.block_out_channels[1], lh, lw)
            if tuple(cache_u.shape) != want or tuple(cache_c.shape) != want:
                raise ResumeReject(f"deep-cache shape {tuple(cache_u.shape)}"
                                   f" != {want}")
            dtype = param_dtype(unet)
            if cache_u.dtype != dtype or cache_c.dtype != dtype:
                raise ResumeReject(f"deep-cache dtype {cache_u.dtype}, lanes "
                                   f"carry {dtype}")
            if not 0 <= skipped < steps:
                raise ResumeReject(
                    f"skipped tally {skipped} outside [0, {steps})")
            restored.update(cache_u=cache_u, cache_c=cache_c,
                            cache_ok=cache_ok, skipped=skipped)
        return restored

    def _enqueue(self, key, pipe, job, lane_rows, height, width, sampler,
                 bounds) -> None:
        created = False
        with self._lock:
            lane = self._lanes.get(key)
            # a lane narrower than the job could never admit it (admission
            # is FIFO): unless it can grow to fit, open a fresh, wide-enough
            # lane and let the old one drain and idle out
            if lane is not None and lane.width < job.n_rows:
                limit = self._width_limits.get(key)
                can_grow = lane._adaptive and (limit is None
                                               or limit >= job.n_rows)
                if not can_grow:
                    lane = None
            if lane is None or not lane.try_enqueue(job):
                lane = Lane(self, key, pipe, width=lane_rows, height=height,
                            width_px=width, sampler=sampler,
                            width_bounds=bounds, reuse=key[5])
                self._lanes[key] = lane
                created = True
                if not lane.try_enqueue(job):
                    raise LaneRetired("fresh lane refused the job")
        if created:  # outside the lock: _count takes it too
            self._count(lanes_created=1)

    # ---- lifecycle / observability ----

    def retire_lanes_for_owner(self, owner_id: int) -> int:
        """Ask every lane built on the components object, or keyed by the
        ControlNet bundle, with ``id == owner_id`` to retire as soon as its
        rows drain (idle lanes on the lane thread's next wakeup). Returns
        the number asked."""
        with self._lock:
            lanes = [lane for key, lane in self._lanes.items()
                     if owner_id in (id(key[0].c), id(key[4]))]
        for lane in lanes:
            lane.request_retire()
        return len(lanes)

    def _lane_done(self, lane: Lane) -> None:
        with self._lock:
            if self._lanes.get(lane.key) is lane:
                del self._lanes[lane.key]
            self._condemned = [c for c in self._condemned if c is not lane]

    def _lane_condemned(self, lane: Lane) -> None:
        """A condemned lane leaves the table (submits open a fresh one);
        its thread is joined at shutdown."""
        with self._lock:
            if self._lanes.get(lane.key) is lane:
                del self._lanes[lane.key]
            self._condemned.append(lane)

    def _note_lane_failure(self, key: tuple, width: int) -> None:
        with self._lock:
            self._failed_lane_hints[key] = int(width)

    def note_oom(self) -> None:
        """Degradation-ladder hook: after an OOM'd lane run, lanes rebuild
        at half width. Halves once per lane incident: every resident job's
        collector reports the same failure."""
        with self._lock:
            incident = self._stats.get("lanes_failed", 0)
            if incident == self._last_oom_incident:
                return
            self._last_oom_incident = incident
            keys = (set(self._lanes) | set(self._width_limits.keys())
                    | set(self._failed_lane_hints.keys()))
            for key in keys:
                cur = self._width_limits.get(key)
                if cur is None:
                    lane = self._lanes.get(key)
                    cur = (lane.width if lane is not None
                           else self._failed_lane_hints.get(key, 2))
                self._width_limits[key] = max(1, cur // 2)

    def _count(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                if v:
                    self._stats[k] += v
            self._total_steps = self._stats.get("steps_executed", 0)

    def _maybe_fault(self, lane: Lane) -> None:
        """Fault seam: raise a scripted fault inside a lane thread's loop once
        the scheduler has executed N steps in all."""
        if not self._fault:
            return
        with self._lock:
            if self._fault and self._total_steps >= self._fault[0][0]:
                _, exc = self._fault.pop(0)
                raise exc

    def inject_fault(self, after_steps: int, exc: Exception) -> None:
        with self._lock:
            self._fault.append((int(after_steps), exc))

    def stats(self) -> dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            data = dict(self._stats)
            lanes = list(self._lanes.values())
            rate = self._arrivals.rate(now)
            step_ewma = self._step_ewma
        active = sum(lane.occupancy()[0] for lane in lanes)
        width = sum(lane.occupancy()[1] for lane in lanes)
        steps_a = data.get("row_steps_active", 0)
        steps_p = data.get("row_steps_padded", 0)
        denom = max(1, steps_a + steps_p)
        data.update({
            "lanes_live": len(lanes),
            "rows_active": active,
            "lane_rows_total": width,
            "lane_occupancy": round(steps_a / denom, 4),
            "padding_waste": round(steps_p / denom, 4),
            "arrival_rate": round(rate, 4),
            "step_seconds_ewma": round(step_ewma, 6),
        })
        return data

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for every lane to go empty. True when drained."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._lock:
                lanes = list(self._lanes.values())
            if not any(lane.busy() for lane in lanes):
                return True
            time.sleep(0.01)
        return False

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Stop every lane; unfinished rows fail with :class:`LaneRetired`
        so their jobs bounce to the per-job path, never lost. Condemned
        lanes' threads are joined too, each within ``timeout_s``."""
        with self._lock:
            lanes = list(self._lanes.values()) + list(self._condemned)
        for lane in lanes:
            lane.stop()
        for lane in lanes:
            lane.join(timeout_s)


_EXIT_SCHEDULERS: weakref.WeakSet = weakref.WeakSet()
_EXIT_LOCK = threading.Lock()
_EXIT_HOOKED = False


def _register_for_exit(sched: StepScheduler) -> None:
    """Stop every lane at interpreter exit: a daemon lane thread still
    launching kernels during teardown can abort the process."""
    global _EXIT_HOOKED
    with _EXIT_LOCK:
        _EXIT_SCHEDULERS.add(sched)
        if not _EXIT_HOOKED:
            atexit.register(_stop_all_lanes)
            _EXIT_HOOKED = True


def _stop_all_lanes() -> None:
    for scheduler in list(_EXIT_SCHEDULERS):
        try:
            scheduler.shutdown(timeout_s=2.0)
        except Exception:  # teardown must never raise
            log.exception("lane shutdown at exit failed")


def aggregate_stats(steppers) -> dict[str, Any]:
    """Merge several schedulers' stats (one per slot): counters sum, the
    occupancy and waste ratios recompute from the summed row-step totals."""
    total: collections.Counter = collections.Counter()
    rate = step_ewma = 0.0
    for stepper in steppers:
        for key, value in stepper.stats().items():
            if key == "arrival_rate":
                rate = max(rate, value)  # EWMAs do not sum
            elif key == "step_seconds_ewma":
                step_ewma = max(step_ewma, value)
            elif key not in ("lane_occupancy", "padding_waste"):
                total[key] += value
    steps_a = total.get("row_steps_active", 0)
    steps_p = total.get("row_steps_padded", 0)
    denom = max(1, steps_a + steps_p)
    data = dict(total)
    data["lane_occupancy"] = round(steps_a / denom, 4)
    data["padding_waste"] = round(steps_p / denom, 4)
    data["arrival_rate"] = round(rate, 4)
    data["step_seconds_ewma"] = round(step_ewma, 6)
    return data


def retire_lanes_for_owner(owner_id: int) -> int:
    """Process-wide eviction -> lane retire: every scheduler's lanes built
    on the components object, or keyed by the ControlNet bundle, with
    ``id == owner_id`` retire at drain. The residency ledger calls it when
    it evicts a model or a bundle (``serving/residency.py``)."""
    return sum(sched.retire_lanes_for_owner(owner_id)
               for sched in list(_EXIT_SCHEDULERS))


_ATTACH_LOCK = threading.Lock()


def get_stepper(slot: Any) -> StepScheduler:
    """The slot's resident StepScheduler (created on first use). Lane
    traffic does not go through ``DeviceSlot.__call__`` (one job at a
    time): the lanes serialize it; the slot is consulted for its width."""
    with _ATTACH_LOCK:
        stepper = getattr(slot, "_stepper", None)
        if stepper is None:
            stepper = StepScheduler(slot)
            slot._stepper = stepper
        return stepper
