"""The worker daemon: poll the hive, run jobs on the port's slots, upload
the results. The counterpart of ``chiaswarm_tpu/node/worker.py``
(``_burst_key`` :122, ``Worker`` :178, ``run_worker`` :2171, ``main``
:2180), with the same wire, the same burst drain and the same fault
handling:

- every burst runs under a per-workflow **deadline** (``settings.py``:
  ``deadline_for``); a timed-out or crashed job uploads a structured error
  envelope through the normal result path;
- the **retry ladder**: transient faults and device OOM re-run locally with
  capped backoff and jitter (an OOM'd burst splits and re-runs serially),
  and a per-model **circuit breaker** quarantines a model after K
  consecutive permanent failures (its state file sits beside the
  dead-letter spool and survives restarts);
- **graceful drain**: SIGTERM/SIGINT stop polling first, in-flight bursts
  and the result queue drain (bounded by the drain timeouts), and results
  that exhaust their upload retries spool to a **dead-letter** directory
  that replays on the next start;
- the **gray-failure guard** (``serving/guard.py``; JAX :259-276,
  :1165, :1324-1406): a ``DeviceGuard`` built from the ``guard_*``
  settings is set on every slot as ``slot._guard`` and seeded with its
  devices; lanes and the solo watchdog feed it hangs, slow steps and
  invalid outputs, and every poll applies the rungs it queued:
  ``cache_flush``, ``device_quarantine`` (a slot's data mesh shrinks to its
  healthy cards; a slot of one card declines, and the ladder escalates),
  ``restart`` (the graceful drain, then exit code 73 from ``run_worker``
  and ``main``). With ``guard_enabled`` false the guard counts events and
  applies no rung.

Jobs go through the port's executor (``node/executor.py``): lanes first, as
the executor routes them. A slot keeps up to ``slot.depth`` bursts in
flight, so a burst handed out while a lane steps splices into it
(``core/chip_pool.py`` says how a slot runs solo jobs at that depth).

Models load from ``<settings root>/models/<name>`` (diffusers layout,
``node/registry.py``) through the registry's residency ledger: the worker
applies ``residency_budget_bytes`` and ``residency_prefetch`` to it, its
mesh policy reads the ledger's measured footprints before the family
estimates, and an empty poll lets the ledger prefetch (``note_idle``).

Left for the next worker slice, and refused when a setting asks for them
(``heartbeat_s``, ``health_port``, ``overload_control``, several hive uris,
``hive_front_uri``): the heartbeat loop with checkpoints and resume (and
the placement hints its acks carry, ``note_placement``), the health server
and ``/metrics``, the overload controller, federation over hive shards.

``python -m chiaswarm_tpu_torch.node.worker`` runs one worker on the
machine's CUDA cards. There is no CPU fallback: pass ``pool=`` and
``registry=`` built on the CPU to run one there, as the tests do.
"""

from __future__ import annotations

import asyncio
import logging
import random
import re
import signal
import time
from pathlib import Path
from typing import Any

import aiohttp
import torch

from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.core.device import resolve_device
from chiaswarm_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    MeshSpec,
    derive_mesh_spec,
)
from chiaswarm_tpu_torch.node.executor import (
    do_work,
    do_work_batch,
    error_result,
    job_rows,
    rows_cap,
    single_chip_rows,
)
from chiaswarm_tpu_torch.node.hive import BadWorkerError, HiveClient
from chiaswarm_tpu_torch.node.logging_setup import setup_logging
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.node.resilience import (
    BREAKER_KINDS,
    RETRYABLE_KINDS,
    Backoff,
    BreakerBoard,
    DeadLetterSpool,
    HiveSession,
    ResilienceStats,
    backoff_delay,
    classify_exception,
    classify_result,
    hive_reachable_error,
)
from chiaswarm_tpu_torch.node.settings import (
    Settings,
    load_file,
    load_settings,
    settings_root,
)
from chiaswarm_tpu_torch.obs import metrics as obs_metrics
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.serving import guard as _guard

log = logging.getLogger("chiaswarm_torch.worker")

_LATER = "the next worker slice of chiaswarm_tpu_torch"


def _burst_key(job: dict) -> tuple | None:
    """Cheap raw-job coalescability key (None = never coalesce): jobs with
    identical static fields drain from the queue as one burst. The
    executor's grouping stays the authority; this keeps jobs that cannot
    share a burst on the per-job path, so their results upload as soon as
    each finishes. With the lanes on, steps, guidance and strength ride
    per row, so they leave the key."""
    if job.get("workflow") not in (None, "", "txt2img", "img2img",
                                   "inpaint"):
        return None
    if job.get("resume") is not None:
        return None
    model = str(job.get("model_name", ""))
    if model.startswith("DeepFloyd/") or "pix2pix" in model:
        return None
    params = job.get("parameters") or {}
    if params.get("controlnet") or params.get("upscale"):
        return None
    image = job.get("image")
    steps = job.get("num_inference_steps")
    guidance = job.get("guidance_scale")
    strength = job.get("strength")
    from chiaswarm_tpu_torch.serving.stepper import stepper_enabled

    if stepper_enabled():
        steps = guidance = strength = None
    return (model, job.get("height"), job.get("width"),
            steps, guidance,
            job.get("lora"), job.get("textual_inversion"),
            job.get("cross_attention_scale"),
            bool(job.get("start_image_uri") or image is not None),
            bool(job.get("mask_image_uri")
                 or job.get("mask_image") is not None),
            strength,
            None if image is None else tuple(getattr(image, "shape", ())),
            repr(sorted(params.items())))


def pool_layout(spec: MeshSpec, n_devices: int) -> tuple[int, MeshSpec]:
    """How the default pool lays ``spec`` over ``n_devices`` cards:
    ``(slots, each slot's mesh spec)``.

    - all axes 1 (one card): one slot;
    - ``seq`` alone above 1: one slot ringing over every card;
    - ``data`` above 1 (``model`` and ``seq`` 1): one slot per card. The
      port does not split rows across cards, and a slot's modules live on
      its lead card; the JAX ``ChipPool`` builds the same layout with
      ``n_slots=n``.
    - ``model`` above 1, or ``seq`` beside another axis above 1: raises;
      ROADMAP queue item 7 ports those meshes.
    """
    sizes = spec.resolve(n_devices)
    data, model, seq = (sizes.get(a, 1) for a in
                        (DATA_AXIS, MODEL_AXIS, SEQ_AXIS))
    if model > 1 or (seq > 1 and data > 1):
        raise NotImplementedError(
            f"the default pool derived the mesh {sizes} on {n_devices} "
            "card(s); tensor-parallel and data x seq meshes are not ported "
            "yet (ROADMAP queue item 7); set mesh_shape to a data-only or "
            "seq-only mesh")
    if seq > 1:
        return 1, MeshSpec({SEQ_AXIS: seq})
    return n_devices, MeshSpec({DATA_AXIS: 1})


class Worker:
    """One node process: one task per slot, plus the poll and upload tasks.

    ``pool``, ``registry``, ``hive`` and ``executor`` are seams: ``hive`` is
    a client with ``get_work``/``post_result``, ``executor`` an object with
    async ``do_work(job, slot, registry)`` and ``do_work_batch(jobs, slot,
    registry)`` (the JAX package's ``node/chaos.py`` injects scripted faults
    through it)."""

    def __init__(self, settings: Settings | None = None,
                 pool: ChipPool | None = None,
                 registry: ModelRegistry | None = None,
                 hive: HiveClient | None = None,
                 executor: Any | None = None) -> None:
        self.settings = settings or load_settings()
        self._refuse_later_parts()
        # registry first: its catalog feeds the default mesh policy
        self.registry = registry or ModelRegistry(
            catalog=load_file("models.json") or [])
        self.mesh_spec: MeshSpec | None = None
        self.pool = pool if pool is not None else self._default_pool()
        self.hive = hive if hive is not None else HiveClient(
            self.settings.hive_uri, self.settings.hive_token,
            self.settings.worker_name)
        self._executor = executor
        # queue bound = total in-flight capacity: per slot, the larger of
        # its depth and its data-axis width
        self.work_queue: asyncio.Queue = asyncio.Queue(
            maxsize=sum(
                max(getattr(slot, "depth", 1), slot.data_width)
                for slot in self.pool))
        self.result_queue: asyncio.Queue = asyncio.Queue()
        self._stop = asyncio.Event()
        self._draining = asyncio.Event()
        self.jobs_done = 0
        # slots currently blocked on work_queue.get(): the burst drain
        # leaves this many jobs queued so one slot never starves another
        self._hungry_slots = 0
        # per-worker registry and trace ring: hermetic test workers must
        # not bleed counters into each other
        self.metrics = obs_metrics.Registry()
        self.traces = obs_trace.TraceRing()
        self._job_seconds = self.metrics.histogram(
            "chiaswarm_job_seconds",
            "end-to-end job wall time (poll receipt -> upload settled)")
        self._phase_seconds = self.metrics.histogram(
            "chiaswarm_job_phase_seconds",
            "per-phase job wall time from the trace spans",
            labelnames=("phase",))
        self._jobs_total = self.metrics.counter(
            "chiaswarm_jobs_total",
            "jobs settled (uploaded or dead-lettered), by final outcome",
            labelnames=("outcome",))
        self.stats = ResilienceStats(self.metrics)
        # the per-worker device-health ledger and healing ladder; always
        # built (its chiaswarm_guard_* families read 0 from the start),
        # its rungs applied only with guard_enabled
        self.guard = _guard.DeviceGuard(
            enabled=self.settings.guard_enabled,
            cache_flush_after=self.settings.guard_cache_flush_after,
            quarantine_after=self.settings.guard_quarantine_after,
            restart_after=self.settings.guard_restart_after,
            metrics_registry=self.metrics)
        for slot in self.pool:
            slot._guard = self.guard
            self.guard.seed_devices(_guard._slot_devices(slot))
        # 0, or GUARD_RESTART_EXIT_CODE after the restart rung's drain
        self.exit_code = 0
        self._retry_rng = random.Random(
            f"retry:{self.settings.worker_name}")
        # breaker state persists NEXT TO the dead-letter spool and reloads
        # here: a model quarantined before a restart stays quarantined
        self.breakers = BreakerBoard(
            threshold=self.settings.breaker_threshold,
            cooldown_s=self.settings.breaker_cooldown_s,
            on_open=getattr(self.registry, "quarantine", None),
            on_close=getattr(self.registry, "unquarantine", None),
            on_probe=getattr(self.registry, "unquarantine", None),
            persist_path=self._breaker_state_path())
        self.hive_session = HiveSession(
            outage_after=self.settings.hive_outage_after)
        self.dead_letters = DeadLetterSpool(self._dead_letter_dir())
        self._poll_backoff = Backoff(
            base=self.settings.poll_backoff_base_s,
            cap=self.settings.poll_backoff_cap_s,
            seed=f"poll:{self.settings.worker_name}")
        # dead-letter files currently riding the result queue: a live
        # replay must never enqueue a spooled envelope twice
        self._replayed_paths: set[str] = set()
        self._dl_replayed = obs_metrics.dead_letter_replayed_counter(
            self.metrics)
        for when in obs_metrics.DEAD_LETTER_REPLAY_WHEN:
            self._dl_replayed.inc(0, when=when)
        # jobs between poll receipt and settled upload
        self._inflight: dict[Any, float] = {}
        # the operator's residency settings, pushed into the registry's
        # ledger: an explicit budget, and the prefetch toggle (idle polls
        # start demand-driven warm loads, _ask_for_work)
        residency = getattr(self.registry, "residency", None)
        if residency is not None:
            if int(self.settings.residency_budget_bytes or 0) > 0:
                residency.set_budget(
                    int(self.settings.residency_budget_bytes))
            residency.prefetch_enabled = bool(
                self.settings.residency_prefetch
                and residency.prefetch_enabled)

    def _refuse_later_parts(self) -> None:
        s = self.settings
        asked = []
        if float(s.heartbeat_s or 0) > 0:
            asked.append("heartbeat_s > 0 (lease heartbeats, checkpoints "
                         "and resume)")
        if int(s.health_port or 0) > 0 or s.health_bind_ephemeral:
            asked.append("health_port (the health server and /metrics)")
        if s.overload_control:
            asked.append("overload_control (the overload controller)")
        if len(s.hive_uris()) > 1:
            asked.append("several hive uris (federation over hive shards)")
        if str(s.hive_front_uri or "").strip():
            asked.append("hive_front_uri (federation bootstrap)")
        if asked:
            raise ValueError(
                f"settings ask for {'; '.join(asked)}, which {_LATER} "
                "ports; unset them to run this worker")

    def _spool_dirname(self) -> str:
        return re.sub(r"[^A-Za-z0-9._-]+", "_",
                      self.settings.worker_name or "worker")

    def _breaker_state_path(self) -> Path:
        spool = self._dead_letter_dir()
        # sibling FILE, not inside the spool: replay() globs *.json there
        return spool.parent / f"{spool.name}.breakers.json"

    def _dead_letter_dir(self) -> Path:
        if self.settings.dead_letter_dir:
            return Path(self.settings.dead_letter_dir).expanduser()
        # namespaced by worker name: workers sharing one settings root
        # must never replay (and then delete) each other's results
        return settings_root() / "dead_letter" / self._spool_dirname()

    # ---- the default pool ----

    def _default_pool_plan(self) -> tuple[MeshSpec, int, MeshSpec]:
        """(the node's mesh spec, slots, each slot's spec) for the cards
        ``torch.cuda.device_count()`` reports. An explicit ``mesh_shape``
        setting wins; otherwise the spec derives from the card count and
        the heaviest catalog family (``core/mesh.py::derive_mesh_spec``)."""
        n = torch.cuda.device_count()
        if self.settings.mesh_shape:
            spec = MeshSpec(dict(self.settings.mesh_shape))
        else:
            spec = derive_mesh_spec(n, self._heaviest_catalog_bytes(),
                                    latency=self.settings.latency_mode)
        n_slots, slot_spec = pool_layout(spec, n)
        return spec, n_slots, slot_spec

    def _default_pool(self) -> ChipPool:
        resolve_device(None)  # no card: raises, there is no CPU fallback
        spec, n_slots, slot_spec = self._default_pool_plan()
        self.mesh_spec = spec
        log.info("derived default mesh: %s", spec.shape)
        return ChipPool(n_slots=n_slots, mesh_spec=slot_spec)

    def _heaviest_catalog_bytes(self) -> int | None:
        """Footprint of the heaviest model the catalog serves (None =
        empty catalog or no estimate): the ledger's measured footprint
        (persisted across restarts in ``residency.json``) where there is
        one, else the family's bf16 estimate."""
        try:
            from chiaswarm_tpu_torch.models.configs import get_family
            from chiaswarm_tpu_torch.pipelines.components import (
                estimate_family_bytes,
            )

            names = self.registry.known_models()
            if not names:
                return None
            residency = getattr(self.registry, "residency", None)
            measured = (residency.measured_footprints()
                        if residency is not None else {})
            heaviest = 0
            for name in names:
                nbytes = measured.get(name)
                if nbytes is None:
                    nbytes = estimate_family_bytes(get_family(name).name)
                heaviest = max(heaviest, int(nbytes))
            return heaviest or None
        except Exception as exc:  # policy must never block startup
            log.warning("mesh policy estimate failed (%s); using dp-only",
                        exc)
            return None

    # ---- lifecycle ----

    def startup(self) -> None:
        if not len(self.pool):
            raise RuntimeError("no device slots; quitting")
        for slot in self.pool:
            device = getattr(slot, "device", None)
            if device is not None:
                resolve_device(device)  # a card that is not there raises
        setup_logging(settings_root() / "logs", self.settings.log_filename,
                      self.settings.log_level)
        cards = (torch.cuda.device_count()
                 if torch.cuda.is_available() else 0)
        log.info("worker %s: %d card(s), %d slot(s), mesh %s",
                 self.settings.worker_name, cards, len(self.pool),
                 None if self.mesh_spec is None else self.mesh_spec.shape)

    def request_stop(self) -> None:
        self._stop.set()

    def _install_signal_handlers(self, loop) -> list:
        """SIGTERM/SIGINT trigger the graceful drain instead of killing
        in-flight work."""
        if not self.settings.install_signal_handlers:
            return []
        installed = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, self.request_stop)
                installed.append(sig)
            except (NotImplementedError, RuntimeError, ValueError):
                pass  # non-main thread / non-unix loop
        return installed

    @staticmethod
    def _remove_signal_handlers(loop, installed) -> None:
        for sig in installed:
            try:
                loop.remove_signal_handler(sig)
            except (NotImplementedError, RuntimeError, ValueError):
                pass

    def _replay_dead_letters(self, when: str = "startup") -> int:
        """Re-queue spooled results for upload: at ``startup``, or
        ``live`` when the hive healed mid-run. A file is discarded only
        after ITS upload succeeds (:meth:`_deliver`)."""
        found = 0
        for path, result in self.dead_letters.replay():
            key = str(path)
            if key in self._replayed_paths:
                continue  # already riding from an earlier replay
            self._replayed_paths.add(key)
            result["_dead_letter_path"] = key
            self.result_queue.put_nowait(result)
            self.stats.results_replayed += 1
            self._dl_replayed.inc(when=when)
            found += 1
        if found:
            log.warning("replaying %d dead-letter result(s) from %s (%s)",
                        found, self.dead_letters.directory, when)
        return found

    def _note_hive_ok(self) -> None:
        """A poll or upload reached the hive; a heal drains the
        dead-letter spool live."""
        if self.hive_session.note_success():
            log.warning("hive healed after %.1fs outage; replaying its "
                        "dead-letter spool live",
                        self.hive_session.last_outage_s)
            self._replay_dead_letters(when="live")

    def _note_hive_failure(self, source: str, exc: Exception) -> None:
        """A poll or upload could not reach the hive. An HTTP 4xx is
        excluded: the hive answered."""
        if hive_reachable_error(exc):
            return
        if self.hive_session.note_failure(source):
            assumed = len(self._inflight)
            self.stats.hive_outages += 1
            if assumed:
                self.stats.leases_assumed_lost += assumed
            log.error(
                "hive OUTAGE after %d consecutive %s failure(s); %d "
                "in-flight lease(s) assumed lost — work rides through, "
                "results spool to dead-letter and replay on heal",
                self.hive_session.consecutive_failures, source, assumed)

    async def run(self) -> None:
        self.startup()
        self._replay_dead_letters()
        loop = asyncio.get_running_loop()
        signals = self._install_signal_handlers(loop)
        slot_tasks = [
            asyncio.create_task(self._slot_worker(slot), name=f"slot{i}")
            for i, slot in enumerate(self.pool)
        ]
        result_task = asyncio.create_task(self._result_worker(),
                                          name="results")
        poll_task = asyncio.create_task(self._poll_loop(), name="poll")
        tasks = slot_tasks + [result_task, poll_task]
        try:
            await self._stop.wait()
            await self._shutdown(poll_task, slot_tasks, result_task)
        finally:
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            # anything still queued embodies paid chip time: spool it
            self._spool_unsent_results()
            # refresh persisted breaker cooldowns (they survive restarts)
            self.breakers.save()
            self._remove_signal_handlers(loop, signals)

    async def _shutdown(self, poll_task, slot_tasks, result_task) -> None:
        """Graceful drain: polling halts first, in-flight slots finish,
        queued results upload, each phase bounded by its timeout."""
        log.info("stopping: polling halts; %d queued job(s) + in-flight "
                 "work drain, then %d pending result(s) upload",
                 self.work_queue.qsize(), self.result_queue.qsize())
        poll_task.cancel()
        await asyncio.gather(poll_task, return_exceptions=True)
        self._draining.set()
        try:
            await asyncio.wait_for(
                asyncio.gather(*slot_tasks, return_exceptions=True),
                timeout=self.settings.drain_timeout_s)
        except asyncio.TimeoutError:
            log.error("slot drain exceeded %.0fs; cancelling in-flight "
                      "jobs (the hive recovers them via its timeout "
                      "detector)", self.settings.drain_timeout_s)
            for task in slot_tasks:
                task.cancel()
            await asyncio.gather(*slot_tasks, return_exceptions=True)
        # retire the lanes: drained bursts already collected their rows;
        # rows of abandoned executor threads fall back to the per-job path
        for slot in self.pool:
            stepper = getattr(slot, "_stepper", None)
            if stepper is not None:
                stepper.shutdown()
        try:
            await asyncio.wait_for(
                self.result_queue.join(),
                timeout=self.settings.result_drain_timeout_s)
        except asyncio.TimeoutError:
            log.error("result drain exceeded %.0fs; unsent results spool "
                      "to the dead-letter directory",
                      self.settings.result_drain_timeout_s)
        result_task.cancel()
        await asyncio.gather(result_task, return_exceptions=True)

    def _spool_unsent_results(self) -> None:
        """Shutdown durability: whatever the result worker never got to
        goes to disk."""
        while True:
            try:
                result = self.result_queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            trace = obs_trace.detach(result)  # never serializes to disk
            spooled = result.pop("_dead_letter_path", None)
            if spooled is None:  # replayed results already have a file
                self.dead_letters.spool(result)
                self.stats.results_dead_lettered += 1
            self._settle_inflight(result)
            self._finish_trace(trace, result, settled="dead_letter")
            self.result_queue.task_done()

    # ---- the healing ladder (serving/guard.py) ----

    def _apply_heal_rungs(self) -> None:
        """Apply the rungs the device guard queued since the last poll (JAX
        :1324-1365), and mirror the lanes' guard counters into the worker's
        registry. The lane rebuild happened lane-side at condemnation.

        - ``cache_flush``: the port keeps no executable cache to drop, so
          the rung re-colds what warm-up built: every lane's warm widths
          and the solo watchdog's warm keys (``note_cache_flush``; each
          lane clears its widths at its next dispatch), so the next calls
          run under the ceiling budget. Host state only: no
          ``torch.cuda.empty_cache()`` or synchronize here, since either
          would block the poll loop on a wedged card.
        - ``device_quarantine``: :meth:`_quarantine_device`.
        - ``restart``: the graceful drain, then exit code
          ``GUARD_RESTART_EXIT_CODE``."""
        self._mirror_lane_counters()
        if not self.settings.guard_enabled:
            return
        for action in self.guard.take_actions():
            if action.rung == "cache_flush":
                _guard.note_cache_flush()
                log.error("guard heal: lanes and solo keys re-colded, "
                          "flush epoch %d (%s)", _guard.flush_epoch(),
                          action.reason)
            elif action.rung == "device_quarantine":
                self._quarantine_device(action.device, action.reason)
            elif action.rung == "restart":
                log.error("guard heal: self-restart requested (%s); "
                          "draining gracefully, exit code %d",
                          action.reason, _guard.GUARD_RESTART_EXIT_CODE)
                self.exit_code = _guard.GUARD_RESTART_EXIT_CODE
                self.request_stop()

    def _quarantine_device(self, device: str, reason: str) -> None:
        """Shrink every slot mesh holding ``device`` to its healthy devices
        (JAX :1367-1406): data-axis meshes only. The slot's lanes retire
        first (their rows bounce to the per-job path). A slot that cannot
        shrink (its only device, or another axis above 1) declines, and
        the ladder escalates to restart."""
        from chiaswarm_tpu_torch.core.mesh import build_mesh

        for slot in self.pool:
            devices = _guard._slot_devices(slot)
            if device not in devices:
                continue
            healthy = [torch.device(d) for d in devices if d != device]
            shape = slot.mesh.shape
            others = 1
            for name, size in shape.items():
                if name != DATA_AXIS:
                    others *= int(size)
            if not healthy or others != 1:
                log.error("guard heal: cannot quarantine device %s out of "
                          "slot %s (mesh %s, devices %s); the ladder "
                          "escalates to restart instead", device,
                          slot.index, shape, devices)
                continue
            stepper = getattr(slot, "_stepper", None)
            if stepper is not None:
                stepper.shutdown(timeout_s=5.0)
            slot.mesh = build_mesh(MeshSpec({DATA_AXIS: len(healthy)}),
                                   healthy)
            slot.device = slot.mesh.lead
            log.error("guard heal: device %s quarantined (%s); slot %s "
                      "mesh shrunk to %d healthy device(s)", device, reason,
                      slot.index, len(healthy))

    def _mirror_lane_counters(self) -> None:
        """The guard's lane counters as ``chiaswarm_stepper_<key>_total``
        on the worker's registry (the JAX worker's collector, :1011-1025,
        for these keys)."""
        from chiaswarm_tpu_torch.serving.stepper import aggregate_stats

        steppers = [slot._stepper for slot in self.pool
                    if getattr(slot, "_stepper", None) is not None]
        totals = aggregate_stats(steppers) if steppers else {}
        for key in ("lanes_condemned", "rows_hung", "rows_invalid",
                    "steps_slow", "rows_resumed", "resumes_rejected"):
            self.metrics.counter(
                f"chiaswarm_stepper_{key}_total",
                f"step scheduler: cumulative {key}").set_to(
                    totals.get(key, 0))

    # ---- tasks ----

    async def _poll_loop(self) -> None:
        async with aiohttp.ClientSession() as session:
            while not self._stop.is_set():
                # backpressure: wait for queue space, but keep watching
                # _stop, so a full queue can never stall shutdown
                while self.work_queue.full() and not self._stop.is_set():
                    try:
                        await asyncio.wait_for(self._stop.wait(),
                                               timeout=1.0)
                    except asyncio.TimeoutError:
                        pass
                if self._stop.is_set():
                    return
                delay = await self._ask_for_work(session)
                self._apply_heal_rungs()
                try:
                    await asyncio.wait_for(self._stop.wait(), timeout=delay)
                except asyncio.TimeoutError:
                    pass

    async def _ask_for_work(self, session: aiohttp.ClientSession) -> float:
        """One poll; returns the next delay. Errors back off
        exponentially with jitter (capped at ``poll_backoff_cap_s``) and
        the schedule resets on the first successful poll."""
        t_poll = time.perf_counter()
        try:
            jobs = await self.hive.get_work(session)
        except BadWorkerError as exc:
            # the hive ANSWERED (flagged us): reachable, not an outage
            self._note_hive_ok()
            log.error("hive flagged this worker: %s", exc)
            return self._poll_backoff.next()
        except Exception as exc:
            self._note_hive_failure("poll", exc)
            log.warning("poll failed: %s", exc)
            return self._poll_backoff.next()
        self._note_hive_ok()
        self._poll_backoff.reset()
        poll_http_s = time.perf_counter() - t_poll
        for job in jobs:
            if job.get("id") in self._inflight:
                # a hive may redeliver a job back to the worker still
                # running it: the first run's upload settles it
                log.warning("job %s redelivered here while still in "
                            "flight; dropping the duplicate copy",
                            job.get("id"))
                self._inflight[job.get("id")] = time.monotonic()
                continue
            log.info("got job %s", job.get("id"))
            # the job's trace is born at hive receipt; its "poll" phase
            # covers the queue wait until a slot picks the job up
            resume = job.get("resume")
            try:
                queued_s = max(0.0, float(job.get("queued_s") or 0.0))
            except (TypeError, ValueError):
                queued_s = 0.0
            trace = obs_trace.JobTrace(
                "job", id=job.get("id"),
                model=str(job.get("model_name") or ""),
                workflow=str(job.get("workflow") or ""),
                worker=self.settings.worker_name,
                attempt=job.get("attempt") or 1,
                queued_s=round(queued_s, 4),
                resume_step=(resume.get("step", 0)
                             if isinstance(resume, dict) else 0))
            trace.phase("poll", http_s=round(poll_http_s, 6))
            obs_trace.attach(job, trace)
            self._inflight[job.get("id")] = time.monotonic()
            await self.work_queue.put(job)
        if jobs:
            return float(self.settings.poll_busy_s)
        # demand-driven prefetch: only an empty poll with nothing queued
        # lets the ledger warm-load the hottest evicted model that fits
        # the free budget (on a daemon thread)
        if not self._stop.is_set() and self.work_queue.empty():
            residency = getattr(self.registry, "residency", None)
            if residency is not None:
                try:
                    residency.note_idle()
                except Exception:  # prefetch must never stop polls
                    log.exception("residency prefetch tick failed")
        return float(self.settings.poll_idle_s)

    async def _next_job(self) -> dict | None:
        """Block for the next queued job; None once the worker is draining
        AND the queue is empty."""
        if self._draining.is_set() and self.work_queue.empty():
            return None
        get_task = asyncio.ensure_future(self.work_queue.get())
        drain_task = asyncio.ensure_future(self._draining.wait())
        try:
            await asyncio.wait({get_task, drain_task},
                               return_when=asyncio.FIRST_COMPLETED)
            while not get_task.done():
                # draining with jobs still queued: claim them, but a
                # sibling slot may win the last one, after which this get
                # can never be satisfied (polling stopped)
                if self.work_queue.empty():
                    return None
                await asyncio.wait({get_task}, timeout=0.05)
            return get_task.result()
        finally:
            # no awaits between the queue checks above and these cancels,
            # and asyncio.Queue re-wakes the next getter when a woken one
            # is cancelled: a queued job can never be lost here
            get_task.cancel()
            drain_task.cancel()
            await asyncio.gather(get_task, drain_task,
                                 return_exceptions=True)

    async def _slot_worker(self, slot) -> None:
        """Feed one slot, keeping up to ``slot.depth`` bursts in flight.
        A burst drains compatible queued jobs (``_burst_key``) up to
        ``rows_cap`` rows: the slot's data width times the rows one device
        carries profitably (``single_chip_rows``)."""
        inflight = asyncio.Semaphore(max(1, getattr(slot, "depth", 1)))
        pending: set[asyncio.Task] = set()
        base_merge = slot.data_width

        async def run_burst(burst: list[dict]) -> None:
            try:
                results = await self._execute_burst(burst, slot)
                for result in results:
                    await self.result_queue.put(result)
                    self.jobs_done += 1
            except Exception as exc:
                # a crash in the execution path never eats the burst: every
                # job reports an explicit error envelope
                log.exception("slot worker error: %s", exc)
                kind = classify_exception(exc)
                outcomes: dict[str, set[str]] = {}
                for job in burst:
                    self.stats.jobs_failed += 1
                    outcomes.setdefault(
                        str(job.get("model_name") or ""), set()).add(kind)
                    envelope = error_result(job, exc, kind=kind)
                    trace = obs_trace.detach(job)
                    if trace is not None:  # ride on to the upload phase
                        obs_trace.attach(envelope, trace)
                    await self.result_queue.put(envelope)
                    self.jobs_done += 1
                self._record_outcomes(outcomes)
            finally:
                inflight.release()
                for _ in burst:
                    self.work_queue.task_done()

        held: dict | None = None  # mismatched drain candidate, runs next
        try:
            while True:
                await inflight.acquire()
                if held is not None:
                    burst, held = [held], None
                else:
                    # a slot with work in flight must not grab a job a
                    # hungry neighbor is blocked on
                    while (pending and self._hungry_slots
                           and 0 < self.work_queue.qsize()
                           <= self._hungry_slots):
                        await asyncio.sleep(0)
                    self._hungry_slots += 1
                    try:
                        job = await self._next_job()
                    finally:
                        self._hungry_slots -= 1
                    if job is None:  # draining and the queue is dry
                        inflight.release()
                        break
                    burst = [job]
                key = _burst_key(burst[0])
                rows = rows_max = job_rows(burst[0])
                per_device = single_chip_rows(burst[0])
                max_merge = base_merge * per_device
                while key is not None and len(burst) < max_merge:
                    # fairness reserve: jobs other slots are blocked on
                    # stay queued
                    if self.work_queue.qsize() <= self._hungry_slots:
                        break
                    try:
                        candidate = self.work_queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    cand_rows = job_rows(candidate)
                    fits = rows + cand_rows <= rows_cap(
                        max(rows_max, cand_rows), base_merge, per_device)
                    if _burst_key(candidate) == key and fits:
                        burst.append(candidate)
                        rows += cand_rows
                        rows_max = max(rows_max, cand_rows)
                    else:
                        # hold the mismatch and run it as the NEXT burst
                        # (re-queueing at the tail would reorder it)
                        held = candidate
                        break
                task = asyncio.create_task(run_burst(burst))
                pending.add(task)
                task.add_done_callback(pending.discard)
            # graceful drain: in-flight bursts COMPLETE before this returns
            if pending:
                await asyncio.gather(*list(pending), return_exceptions=True)
        finally:
            # a held job was claimed but never dispatched: put it back so
            # cancellation cannot drop it
            if held is not None:
                try:
                    self.work_queue.put_nowait(held)
                except asyncio.QueueFull:
                    log.error("dropping held job %s at shutdown: queue "
                              "full (hive recovers it via timeout)",
                              held.get("id"))
                self.work_queue.task_done()
            # forced cancel: cancel in-flight bursts, then AWAIT them so
            # their finally blocks run
            for task in list(pending):
                task.cancel()
            if pending:
                await asyncio.gather(*list(pending), return_exceptions=True)

    # ---- execution with deadlines and the retry ladder ----

    async def _attempt(self, jobs: list[dict], slot) -> list[dict]:
        """One executor call under the per-workflow deadline. A timed-out
        attempt yields explicit timeout envelopes (the abandoned executor
        thread finishes in the background; its result is discarded)."""
        budget = max(self.settings.deadline_for(job.get("workflow"))
                     for job in jobs)
        for job in jobs:
            trace = obs_trace.job_trace(job)
            if trace is not None:
                trace.meta["attempt_jobs"] = len(jobs)
        executor = self._executor
        if len(jobs) == 1:
            dw = executor.do_work if executor is not None else do_work
            call = dw(jobs[0], slot, self.registry)
        else:
            dwb = (executor.do_work_batch if executor is not None
                   else do_work_batch)
            call = dwb(jobs, slot, self.registry)
        try:
            out = await asyncio.wait_for(call, timeout=budget)
        except asyncio.TimeoutError:
            self.stats.jobs_timed_out += len(jobs)
            log.error("burst %s exceeded its %.0fs deadline",
                      [job.get("id") for job in jobs], budget)
            return [error_result(
                job, f"job exceeded the node's {budget:.0f}s execution "
                     f"deadline", kind="timeout") for job in jobs]
        except Exception as exc:
            # the executor renders its own failures as envelopes, so
            # anything raising through it is a crash: one envelope a job
            log.exception("executor crashed on burst %s",
                          [job.get("id") for job in jobs])
            kind = classify_exception(exc)
            return [error_result(job, exc, kind=kind) for job in jobs]
        results = [out] if len(jobs) == 1 else list(out)
        # never let a miscounting executor silently drop a job
        while len(results) < len(jobs):
            results.append(error_result(
                jobs[len(results)], "executor returned no result for this "
                "job", kind="error"))
        return results

    async def _execute_burst(self, burst: list[dict], slot) -> list[dict]:
        """Run a burst through the degradation ladder:

        1. circuit-breaker gate: jobs for quarantined models get an
           immediate non-fatal refusal envelope;
        2. one batched attempt under the deadline;
        3. jobs that failed transiently (fetch blip, device OOM) re-run
           SOLO with capped backoff and jitter;
        4. final outcomes feed the per-model breakers.
        """
        results: list[dict | None] = [None] * len(burst)
        for job in burst:
            trace = obs_trace.job_trace(job)
            if trace is not None:  # poll phase ends, execute begins
                trace.phase("execute")
        ready: list[int] = []
        for i, job in enumerate(burst):
            model = str(job.get("model_name") or "")
            if model and not self.breakers.allow(model):
                self.stats.jobs_failed += 1
                self.stats.jobs_quarantined += 1
                results[i] = error_result(
                    job, f"model {model!r} is quarantined on this node "
                         f"(circuit breaker open)", kind="quarantined")
            else:
                ready.append(i)
        if ready:
            attempt = await self._attempt([burst[i] for i in ready], slot)
            for i, result in zip(ready, attempt):
                results[i] = result
        max_retries = max(0, int(self.settings.transient_retries))
        outcomes: dict[str, set[str]] = {}
        for i in ready:
            kind = classify_result(results[i])
            for retry in range(1, max_retries + 1):
                if kind not in RETRYABLE_KINDS:
                    break
                delay = backoff_delay(retry, self.settings.retry_backoff_s,
                                      self.settings.retry_backoff_cap_s,
                                      self._retry_rng)
                log.warning("job %s hit a %s fault; solo re-run %d/%d "
                            "in %.2fs", burst[i].get("id"), kind, retry,
                            max_retries, delay)
                self.stats.jobs_retried += 1
                await asyncio.sleep(delay)
                results[i] = (await self._attempt([burst[i]], slot))[0]
                kind = classify_result(results[i])
            if kind != "ok":
                self.stats.jobs_failed += 1
            outcomes.setdefault(
                str(burst[i].get("model_name") or ""), set()).add(kind)
        self._record_outcomes(outcomes)
        # the trace hops from the consumed job onto its result envelope
        for i, job in enumerate(burst):
            trace = obs_trace.detach(job)
            if trace is not None and results[i] is not None:
                obs_trace.attach(results[i], trace)
        return [result for result in results if result is not None]

    def _record_outcomes(self, outcomes: dict[str, set[str]]) -> None:
        """Feed the per-model circuit breakers, ONE record per model per
        burst (one burst-level incident is one consecutive failure, not
        N). ``BREAKER_KINDS`` count; fatal user-input errors and transient
        network faults do not. A success anywhere in the burst wins."""
        for model, kinds in outcomes.items():
            if not model:
                continue
            if "ok" in kinds:
                self.breakers.record(model, ok=True)
            elif kinds & BREAKER_KINDS:
                self.breakers.record(model, ok=False)
            else:
                # says nothing about the model, but frees a held probe
                self.breakers.record_inconclusive(model)

    # ---- result upload with durability ----

    async def _result_worker(self) -> None:
        async with aiohttp.ClientSession() as session:
            while True:
                result = await self.result_queue.get()
                try:
                    await self._deliver(session, result)
                finally:
                    self.result_queue.task_done()

    async def _deliver(self, session, result: dict) -> None:
        """Upload one result; exhausted retries spool it to the
        dead-letter directory for replay on the next start."""
        trace = obs_trace.detach(result)  # must never reach json.dumps
        spooled = result.pop("_dead_letter_path", None)
        # lease attribution; the reference hive ignores the extra field
        result.setdefault("worker_name", self.settings.worker_name)
        if trace is not None:
            trace.phase("upload")
        try:
            with obs_trace.activate(trace):
                uploaded = await self._upload_with_retry(session, result)
        except asyncio.CancelledError:
            # shutdown cancelled us mid-upload: persist before dying
            if spooled is None:
                self.dead_letters.spool(result)
                self.stats.results_dead_lettered += 1
            self._settle_inflight(result)
            self._finish_trace(trace, result, settled="dead_letter")
            raise
        if uploaded:
            if spooled is not None:
                self.dead_letters.discard(spooled)
                self._replayed_paths.discard(str(spooled))
        elif spooled is None:
            self.dead_letters.spool(result)
            self.stats.results_dead_lettered += 1
        else:
            # a replayed result that failed again keeps its file and
            # leaves the in-queue set, so the next heal replays it
            self._replayed_paths.discard(str(spooled))
        self._settle_inflight(result)
        self._finish_trace(trace, result,
                           settled="uploaded" if uploaded else "dead_letter")

    def _settle_inflight(self, result: dict) -> None:
        self._inflight.pop(result.get("id"), None)

    def _finish_trace(self, trace, result: dict, settled: str) -> None:
        """Close a job's span tree, publish it to the trace ring, and fold
        its phases into the latency histograms."""
        if trace is None:
            return
        outcome = classify_result(result)
        trace.meta["outcome"] = outcome
        trace.meta["settled"] = settled
        trace.finish(self.traces)
        for phase in trace.root.children:
            self._phase_seconds.observe(phase.duration_s, phase=phase.name)
        self._job_seconds.observe(trace.root.duration_s)
        self._jobs_total.inc(outcome=outcome)

    async def _upload_with_retry(self, session, result) -> bool:
        retries = max(1, int(self.settings.upload_retries))
        for attempt in range(1, retries + 1):
            try:
                response = await self.hive.post_result(session, result)
                self._note_hive_ok()
                log.info("uploaded result %s: %s", result.get("id"),
                         response)
                return True
            except Exception as exc:
                self._note_hive_failure("upload", exc)
                self.stats.upload_retries += 1
                log.warning("result upload attempt %d/%d failed: %s",
                            attempt, retries, exc)
                if self.hive_session.in_outage:
                    # during a declared outage the full ladder only delays
                    # the spool; the spool replays live on heal
                    log.warning("hive in outage; spooling result %s "
                                "after a single attempt",
                                result.get("id"))
                    return False
                if attempt < retries:
                    await asyncio.sleep(backoff_delay(
                        attempt, self.settings.upload_retry_delay_s,
                        self.settings.poll_backoff_cap_s,
                        self._retry_rng))
        return False


async def run_worker(settings: Settings | None = None) -> int:
    """Run one worker to completion; returns its exit code: 0, or
    ``GUARD_RESTART_EXIT_CODE`` (73) after the restart rung's graceful
    drain."""
    worker = Worker(settings)
    await worker.run()
    return int(worker.exit_code)


def main() -> None:  # `python -m chiaswarm_tpu_torch.node.worker`
    import sys

    try:
        resolve_device(None)
    except RuntimeError as exc:  # no card: there is no CPU fallback
        sys.exit(f"chiaswarm_tpu_torch worker: {exc}")
    sys.exit(asyncio.run(run_worker()))


if __name__ == "__main__":
    main()
