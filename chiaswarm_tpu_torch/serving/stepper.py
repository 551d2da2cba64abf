"""Continuous step-level batching, counterpart of
``chiaswarm_tpu/serving/stepper.py``: the UNet step is the scheduling
quantum.

One resident **lane** per (pipeline, bucketed size, sampler) runs ONE
denoise step per dispatch over a row file of fixed width. A job
arriving while the lane steps splices into free rows at the next step
boundary; a finished row retires, decodes and goes back to its job while
the others keep stepping. Each row carries its own ladder, step index,
guidance, multistep history and noise generator, so every row walks its
solo trajectory (``pipelines/diffusion.py::stepper_step``;
``tests/test_torch_stepper.py`` holds the splice against the solo path).
Lanes are the default engine, as in the JAX package: ``CHIASWARM_STEPPER=0``
opts out and the executor runs every job on the solo path.

Lane width is a closed loop (:class:`LaneWidthController`, copied with its
defaults): it grows when pending rows cannot fit, doubles under sustained
occupancy with arrivals flowing, halves under trickle, only at step
boundaries and only onto the power-of-two lattice. A failed lane fails every
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

Not here yet (``ROADMAP.md``): checkpoints and resume, the hang watchdog
and lane condemnation, the overload admission cap and poll hints, metrics,
the image-mode row state (img2img, inpaint, ControlNet) and DeepCache
reuse lanes.
"""

from __future__ import annotations

import atexit
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
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.pipelines.diffusion import PendingImages
from chiaswarm_tpu_torch.schedulers import (
    FEWSTEP_KINDS,
    NOISY_KINDS,
    make_sampling_schedule,
    resolve,
)
from chiaswarm_tpu_torch.serving.residency import ArrivalEwma

log = logging.getLogger("chiaswarm_torch.stepper")

ENV_ENABLE = "CHIASWARM_STEPPER"
ENV_LANE_WIDTH = "CHIASWARM_STEPPER_LANE_WIDTH"
ENV_ADAPTIVE = "CHIASWARM_STEPPER_ADAPTIVE"
ENV_MIN_WIDTH = "CHIASWARM_STEPPER_MIN_WIDTH"
ENV_MAX_WIDTH = "CHIASWARM_STEPPER_MAX_WIDTH"
ENV_ROW_DEADLINE = "CHIASWARM_STEPPER_ROW_DEADLINE_S"
ENV_IDLE_S = "CHIASWARM_STEPPER_IDLE_S"

_OFF = ("0", "false", "off", "no")


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
    generators: list[torch.Generator]  # one per row: the noise carry
    x0: torch.Tensor            # (n, C, h, w) initial latents
    deadline: float             # absolute time.monotonic() cutoff
    future: Future = dataclasses.field(default_factory=Future)
    admitted_at_step: int = -1
    slots: list[int] = dataclasses.field(default_factory=list)
    submitted_t: float = dataclasses.field(default_factory=time.perf_counter)
    admitted_t: float = 0.0


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
                 width_bounds: tuple[int, int] | None = None) -> None:
        self._sched = sched
        self.key = key
        self.pipe = pipe
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
        self._gens: list[torch.Generator | None] = [None] * w

    def _mirrors(self) -> tuple:
        return (self._h_start, self._h_idx, self._h_sig, self._h_ts,
                self._h_guid, self._h_active)

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
                    rate = self._sched.arrival_rate()
                    with self._cond:
                        while True:
                            if self._stop:
                                raise LaneRetired("lane stopped")
                            self._resize_locked(width_limit, rate)
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
            "idx": torch.zeros(w, dtype=torch.int64, device=self.device),
            "ctx_u": torch.zeros((w,) + tuple(job.ctx_u.shape[1:]),
                                 dtype=job.ctx_u.dtype, device=self.device),
            "ctx_c": torch.zeros((w,) + tuple(job.ctx_c.shape[1:]),
                                 dtype=job.ctx_c.dtype, device=self.device),
        }
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

    def _admit_locked(self) -> None:
        """Splice pending jobs into free row slots: the step boundary is
        wherever the lane thread is between dispatches. Admission is FIFO; the
        job's tensors were queued by the submitting thread on the same
        stream, so they are ready before anything queued here reads them."""
        free = [s for s in range(self.width) if self._rows[s] is None]
        while self._pending and self._pending[0].n_rows <= len(free):
            job = self._pending.popleft()
            if job.future.cancelled():
                continue
            slots, free = free[:job.n_rows], free[job.n_rows:]
            if self._dev is None:
                self._alloc_dev(job)
            mid_flight = bool(self._h_active.any())
            sel = self._index(slots)
            dev = self._dev
            dev["x"].index_copy_(0, sel, job.x0)
            dev["old"].index_fill_(0, sel, 0.0)
            dev["idx"].index_fill_(0, sel, 0)  # txt2img rows start at 0
            dev["ctx_u"].index_copy_(0, sel, job.ctx_u)
            dev["ctx_c"].index_copy_(0, sel, job.ctx_c)
            self._h_idx[slots] = 0
            self._h_start[slots] = 0
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
                rows_admitted_txt2img=job.n_rows))

    def _resize_locked(self, width_limit: int | None, rate: float) -> None:
        """Adaptive capacity, applied only here: between dispatches, under
        ``self._cond``."""
        if not self._adaptive:
            return
        occupied = sum(r is not None for r in self._rows)
        pending = sum(j.n_rows for j in self._pending
                      if not j.future.cancelled())
        target = self._ctl.decide(self.width, occupied, pending, rate,
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
        log.info("lane %d %s %d -> %d rows (%d resident)", self.lane_id,
                 "grows" if self.width > old_width else "shrinks", old_width,
                 self.width, len(occupied))
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

            for name in ("x", "old", "idx", "ctx_u", "ctx_c"):
                self._dev[name] = remap(self._dev[name])
            self._sync_tables()

    def _dispatch_step(self) -> None:
        dev = self._dev
        t0 = time.perf_counter()
        gens: list[torch.Generator | None] = [None] * self.width
        if self.sampler.kind in NOISY_KINDS:
            gens = [self._gens[s] if self._h_active[s] else None
                    for s in range(self.width)]
        dev["x"], dev["idx"], dev["old"] = self.pipe.stepper_step(
            sampler=self.sampler, ctx_u=dev["ctx_u"], ctx_c=dev["ctx_c"],
            x=dev["x"], idx=dev["idx"], start_idx=dev["start"],
            sigmas=dev["sig"], timesteps=dev["ts"], guidance=dev["guid"],
            old_denoised=dev["old"], active=dev["active"], generators=gens)
        # throttle: at most two dispatched steps in flight, so the host
        # cannot run away from the device and execution errors surface
        # here, inside the lane thread's containment try
        self._window.append(self._mark())
        if len(self._window) > 2:
            event = self._window.popleft()
            if event is not None:
                event.synchronize()
        active = int(self._h_active.sum())
        self._h_idx[self._h_active] += 1
        self.steps_executed += 1
        self._sched._count(steps_executed=1, row_steps_active=active,
                           row_steps_padded=self.width - active)
        # the lane's first step pays cuDNN's and the allocator's warm-up:
        # it does not feed the EWMA
        if self.steps_executed > 1:
            self._sched.note_step_seconds(time.perf_counter() - t0)

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
                "resume_step": 0,  # resume is not ported (ROADMAP)
                "splice_wait_s": round(
                    max(0.0, job.admitted_t - job.submitted_t), 6)
                if job.admitted_t else 0.0,
            }
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

    def _flush_handoff(self, block: bool) -> None:
        """Resolve retired rows whose decoded images are resident. With
        ``block=False`` (rows still stepping) in-flight decodes stay queued
        and resolve at a later boundary; with ``block=True`` (lane idle)
        the lane thread waits them out."""
        while self._handoff:
            job, pending, info, event = self._handoff[0]
            if event is not None:
                if block:
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
            self._gens[s] = None
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
        self._arrivals = ArrivalEwma()
        self._step_ewma = 0.0
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
        with self._lock:
            self._arrivals.note(int(rows), time.monotonic())

    def arrival_rate(self, now: float | None = None) -> float:
        """The arrival-rate EWMA in rows/s, read by the lane threads."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._arrivals.rate(now)

    def width_limit_for(self, key: tuple) -> int | None:
        """The OOM-halving width cap for ``key`` (:meth:`note_oom`), read by
        the lane thread before each boundary."""
        with self._lock:
            return self._width_limits.get(key)

    def note_step_seconds(self, seconds: float) -> None:
        """Lane threads feed each step's wall time (throttle included)."""
        with self._lock:
            self._step_ewma = (float(seconds) if self._step_ewma <= 0.0
                               else self._step_ewma + 0.25 * (
                                   float(seconds) - self._step_ewma))

    # ---- submission ----

    def submit_request(self, pipe, *, prompt: str, negative_prompt: str = "",
                       steps: int = 30, guidance_scale: float = 7.5,
                       height: int | None = None, width: int | None = None,
                       rows: int = 1, seed: int = 0,
                       scheduler: str | None = None,
                       deadline_s: float | None = None,
                       job_id: Any = None) -> Future:
        """Prepare a txt2img job's rows (tokenize, encode, ladder, initial
        noise) and hand them to the matching lane. Returns a Future of
        ``(PendingImages, lane_info)``; raises :class:`LaneReject` when the
        job cannot ride a lane."""
        fam = pipe.c.family
        if fam.kind != "sd" or fam.image_conditioned:
            raise LaneReject(f"family {fam.name!r} does not ride lanes")
        sampler = resolve(scheduler, prediction_type=fam.prediction_type)
        if float(guidance_scale) <= 1.0 and sampler.kind not in FEWSTEP_KINDS:
            raise LaneReject("guidance <= 1 runs the solo (no-CFG) path")
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
        # the pipeline itself keys the lane: held by reference, never id()
        key = (pipe, height, width, sampler)
        lane_rows = self.initial_width(rows, height, width)
        limit = self.width_limit_for(key)
        if limit is not None and limit < lane_rows:
            lane_rows = max(rows, limit)
        self._note_arrival(rows)

        with obs_trace.span("encode", rows=rows, steps=steps):
            sched = make_sampling_schedule(pipe.noise_schedule, steps,
                                           sampler)
            eb = bucket_batch(rows)
            ids = pipe._tokenize([prompt or ""] * eb)
            neg = pipe._tokenize([negative_prompt or ""] * eb)
            ctx_u, ctx_c = pipe.stepper_encode(ids, neg)
            # one generator per row, the solo path's (seed, row) pairs
            generators = row_generators([(int(seed), r)
                                         for r in range(rows)])
            x0 = pipe.stepper_row_init(generators, sched.sigmas[0],
                                       height, width)
        job = _RowJob(
            job_id=job_id, n_rows=rows, steps=steps,
            guidance=float(guidance_scale),
            sigmas=sched.sigmas.numpy(), timesteps=sched.timesteps.numpy(),
            ctx_u=ctx_u[:rows], ctx_c=ctx_c[:rows], generators=generators,
            x0=x0,
            deadline=time.monotonic() + (deadline_s if deadline_s is not None
                                         else self.row_deadline_s()))
        self._enqueue(key, pipe, job, lane_rows, height, width, sampler,
                      bounds)
        return job.future

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
                            width_bounds=bounds)
                self._lanes[key] = lane
                created = True
                if not lane.try_enqueue(job):
                    raise LaneRetired("fresh lane refused the job")
        if created:  # outside the lock: _count takes it too
            self._count(lanes_created=1)

    # ---- lifecycle / observability ----

    def retire_lanes_for_owner(self, owner_id: int) -> int:
        """Ask every lane built on the components object with
        ``id == owner_id`` to retire as soon as its rows drain (idle lanes
        on the lane thread's next wakeup). Returns the number asked."""
        with self._lock:
            lanes = [lane for key, lane in self._lanes.items()
                     if id(key[0].c) == owner_id]
        for lane in lanes:
            lane.request_retire()
        return len(lanes)

    def _lane_done(self, lane: Lane) -> None:
        with self._lock:
            if self._lanes.get(lane.key) is lane:
                del self._lanes[lane.key]

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
        so their jobs bounce to the per-job path, never lost."""
        with self._lock:
            lanes = list(self._lanes.values())
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
    on the components object ``id(c) == owner_id`` retire at drain. The
    residency ledger calls it when it evicts a model
    (``serving/residency.py``)."""
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
