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

With a lease-aware hive (all opt-in, as in JAX):

- **Lease heartbeats** (``heartbeat_s > 0``; JAX :309-323, :681, :1408-1576):
  a ``CheckpointSpool`` under ``<root>/checkpoints/<worker>`` (cleared at
  startup) is attached to every slot, so lanes write each job's
  step-boundary state by its hive id and the solo path its phase markers.
  Every ``heartbeat_s`` a busy beat names the in-flight ids and carries each
  checkpoint changed since the last beat (read in a thread); an idle beat
  carries the metrics snapshot alone, at most every 2 s. A lease the hive
  reports lost is counted and warned once (the ``lost`` set is replaced, not
  accumulated); the ack's placement hint reaches the residency ledger
  (``note_placement``). A redelivered job's ``resume`` rides into the lanes
  (``serving/stepper.py::submit_request``), its ``attempt`` and resume step
  into its trace, and it never coalesces (``_burst_key``). An acked upload
  collects the job's checkpoint.
- **Overload control** (``overload_control``; ``node/overload.py``, JAX
  :1314, :1873-1968): before a burst runs, jobs the estimator predicts will
  miss their deadline (the lanes' step EWMA as measured on the card times
  their steps, behind the queue) are shed as non-fatal ``overloaded``
  envelopes through the normal result path, before any kernel runs; the
  poll loop waits while the queued backlog outlasts the backpressure
  budget; brownout caps lane admissions (``set_admission_cap``).
- **The health server** (``health_port`` or ``health_bind_ephemeral``; JAX
  :805-1130): ``/healthz`` (:meth:`Worker.health`, with the card's memory
  and one ``hive_shards`` entry per shard), ``/metrics`` (the worker's
  registry and the process one, Prometheus text), ``/debug/traces`` (Chrome
  events or ``?format=tree``, after ``?since=``), ``/debug/profile?seconds=N``
  (``obs/profiling.py``: a CUDA + CPU capture on a card; 409 ``busy`` while
  another runs) and ``/debug/numerics?probe=<prefix>&limit=N``
  (``obs/numerics.py``: the ring of per-probe summaries the taps around
  kernels B1, B2 and B3 and the pipelines record under
  ``CHIASWARM_NUMERICS``), with JAX's 400, 409 and 500 answers.

A journaled hive (JAX :633-658, :1243-1297, :2016-2049):

- **The epoch handshake**: the grant's ``hive_epoch`` is popped at poll
  receipt, tracked per shard (:meth:`Worker._note_hive_epoch`; a change
  counts ``hive_epoch_changes``: the shard recovered from its journal and
  its pre-recovery leases are void) and echoed on the shard's beats and on
  the job's upload, stamped before any spool so a replay after the restart
  still carries the grant's epoch (the hive counts it as epoch salvage). A
  beat that claims an old epoch is answered ``stale_epoch`` with every
  claimed job lost and the current epoch, which the next beat carries.
- **Flight trace context** (``obs/flight.py``): a grant's ``trace_ctx`` is
  joined into the job's trace, and the upload carries the trace's
  ``span_digest``.

Federation over hive shards (JAX :93-119, :370-431, :555-631, :1496-1561,
:2082-2096): the settings list several shards (``hive_shard_uris``, or
commas in ``hive_uri``) or one front (``hive_front_uri``, resolved at start
through ``GET /api/shards``, ``node/federation.py``). Each shard has its own
client, :class:`~chiaswarm_tpu_torch.node.resilience.HiveSession` (a dead
shard rides an outage alone while the others serve), poll loop and
``Backoff``, dead-letter spool (shard 0 keeps the single-hive directory,
shard i > 0 suffixes ``__shard<i>``) and epoch. A grant stamped with
``hive_shard`` belongs to that shard, whichever shard's poll delivered it (a
stolen job): its beats, upload and spool replay go to the owner, and its
upload echoes the stamp. A single-hive worker is shard 0, with the wire of
the reference hive.

``python -m chiaswarm_tpu_torch.node.worker`` runs one worker on the
machine's CUDA cards. There is no CPU fallback: pass ``pool=`` and
``registry=`` built on the CPU to run one there, as the tests do.
"""

from __future__ import annotations

import asyncio
import functools
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
from chiaswarm_tpu_torch.node.hive import (
    HIVE_EPOCH_KEY,
    HIVE_SHARD_KEY,
    BadWorkerError,
    HiveClient,
)
from chiaswarm_tpu_torch.node.logging_setup import setup_logging
from chiaswarm_tpu_torch.node.overload import OverloadController
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.node.resilience import (
    BREAKER_KINDS,
    RETRYABLE_KINDS,
    Backoff,
    BreakerBoard,
    CheckpointSpool,
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
from chiaswarm_tpu_torch.obs import flight as obs_flight
from chiaswarm_tpu_torch.obs import metrics as obs_metrics
from chiaswarm_tpu_torch.obs import numerics as obs_numerics
from chiaswarm_tpu_torch.obs import profiling as obs_profiling
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.serving import guard as _guard

log = logging.getLogger("chiaswarm_torch.worker")

#: the lanes' stats the worker mirrors into its registry (JAX :1008-1027)
_STEPPER_COUNTERS = ("steps_executed", "rows_admitted",
                     "rows_admitted_midflight", "rows_completed",
                     "rows_expired", "rows_failed", "lanes_created",
                     "lanes_failed", "row_steps_active", "row_steps_padded",
                     "rows_resumed", "resumes_rejected",
                     "checkpoints_written", "lanes_evict_retired",
                     "lanes_condemned", "rows_hung", "rows_invalid",
                     "steps_slow")
_STEPPER_GAUGES = ("lanes_live", "rows_active", "lane_rows_total",
                   "lane_occupancy", "padding_waste")


class _HiveShard:
    """One hive shard as the worker sees it (JAX :93-119): its client,
    outage session, dead-letter spool, poll backoff and the epoch last seen
    on its grants and acks (None against a journal-less shard). A
    single-hive worker holds one, shard 0."""

    def __init__(self, *, index: int, uri: str, client: Any,
                 session: HiveSession, spool: DeadLetterSpool,
                 backoff: Backoff) -> None:
        self.index = int(index)
        self.uri = str(uri)
        self.client = client
        self.session = session
        self.spool = spool
        self.backoff = backoff
        self.last_epoch: int | None = None
        # the heartbeat's metrics-snapshot throttle: each shard keeps the
        # latest snapshot of this worker for its own fleet view
        self.last_metrics = float("-inf")


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


def default_pool_plan(settings: Settings, registry: ModelRegistry
                      ) -> tuple[MeshSpec, int, MeshSpec]:
    """(the node's mesh spec, slots, each slot's spec) for the cards
    ``torch.cuda.device_count()`` reports. An explicit ``mesh_shape``
    setting wins; otherwise the spec derives from the card count and the
    heaviest catalog family (``core/mesh.py::derive_mesh_spec``). The
    worker's default pool and ``node/initialize.py``'s warm-up read it."""
    n = torch.cuda.device_count()
    if settings.mesh_shape:
        spec = MeshSpec(dict(settings.mesh_shape))
    else:
        spec = derive_mesh_spec(n, heaviest_catalog_bytes(registry),
                                latency=settings.latency_mode)
    n_slots, slot_spec = pool_layout(spec, n)
    return spec, n_slots, slot_spec


def heaviest_catalog_bytes(registry: ModelRegistry) -> int | None:
    """Footprint of the heaviest model the catalog serves (None = empty
    catalog or no estimate): the ledger's measured footprint (persisted
    across restarts in ``residency.json``) where there is one, else the
    family's bf16 estimate."""
    try:
        from chiaswarm_tpu_torch.models.configs import get_family
        from chiaswarm_tpu_torch.pipelines.components import (
            estimate_family_bytes,
        )

        names = registry.known_models()
        if not names:
            return None
        residency = getattr(registry, "residency", None)
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
        log.warning("mesh policy estimate failed (%s); using dp-only", exc)
        return None


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
        # registry first: its catalog feeds the default mesh policy
        self.registry = registry or ModelRegistry(
            catalog=load_file("models.json") or [])
        self.mesh_spec: MeshSpec | None = None
        self.pool = pool if pool is not None else self._default_pool()
        # one session bundle per hive shard; an injected client (the test
        # and chaos seam) is the whole control plane, one bundle
        self._hive_injected = hive is not None
        self.shards: list[_HiveShard] = self._build_hive_shards(hive)
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
        self.metrics.add_collector(self._collect_metrics)
        self.stats = ResilienceStats(self.metrics)
        # always built (its chiaswarm_overload_* families render zeroes from
        # the first scrape), consulted only with overload_control
        self.overload = OverloadController(
            margin=self.settings.overload_margin,
            backpressure_s=(float(self.settings.backpressure_s)
                            or self.settings.job_deadline_s / 2.0),
            brownout_sheds=self.settings.overload_brownout_sheds,
            window_s=self.settings.overload_window_s,
            cooldown_s=self.settings.overload_cooldown_s,
            admission_cap_rows=self.settings.overload_admission_cap,
            metrics_registry=self.metrics)
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
        # dead-letter files currently riding the result queue, across
        # every shard's spool: a live replay never enqueues one twice
        self._replayed_paths: set[str] = set()
        self._dl_replayed = obs_metrics.dead_letter_replayed_counter(
            self.metrics)
        for when in obs_metrics.DEAD_LETTER_REPLAY_WHEN:
            self._dl_replayed.inc(0, when=when)
        # one series per configured shard, 0 from the first scrape
        shard_gauge = obs_metrics.hive_shard_session_state_gauge(
            self.metrics)
        for shard in self.shards:
            shard_gauge.set(0, shard=str(shard.index))
        # the resume-state spool beside the dead-letter spool; attached to
        # the slots only with heartbeats on, the one path that ships a
        # checkpoint anywhere (with them off, lanes pay no spool write)
        self.checkpoints = CheckpointSpool(self._checkpoint_dir())
        if float(self.settings.heartbeat_s or 0) > 0:
            for slot in self.pool:
                slot._checkpoint_spool = self.checkpoints
        # jobs between poll receipt and settled upload: the id set the
        # heartbeat keeps leased (insertion-ordered, stable payloads)
        self._inflight: dict[Any, float] = {}
        # which shard OWNS each in-flight job's lease (a stolen grant
        # arrives through one shard's poll and belongs to another): beats
        # and uploads route by it
        self._inflight_shard: dict[Any, int] = {}
        # where the health server bound (host, port)
        self.health_address: tuple[str, int] | None = None
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

    def _spool_dirname(self) -> str:
        return re.sub(r"[^A-Za-z0-9._-]+", "_",
                      self.settings.worker_name or "worker")

    def _checkpoint_dir(self) -> Path:
        if self.settings.checkpoint_dir:
            return Path(self.settings.checkpoint_dir).expanduser()
        return settings_root() / "checkpoints" / self._spool_dirname()

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

    def _shard_dead_letter_dir(self, index: int) -> Path:
        """Shard 0 keeps the single-hive directory (the breaker file is its
        sibling); shard i > 0 suffixes ``__shard<i>``, so one shard's heal
        never replays (and deletes) envelopes owed to another."""
        base = self._dead_letter_dir()
        if index <= 0:
            return base
        return base.parent / f"{base.name}__shard{index}"

    def _build_hive_shards(self, hive: Any | None) -> list[_HiveShard]:
        uris = self.settings.hive_uris() or [self.settings.hive_uri]
        if hive is not None:
            uris = uris[:1]
        shards: list[_HiveShard] = []
        for index, uri in enumerate(uris):
            client = hive if hive is not None else HiveClient(
                uri, self.settings.hive_token, self.settings.worker_name)
            # shard 0 keeps the single-hive backoff seed, so single-hive
            # schedules reproduce; the others decorrelate from it
            seed = (f"poll:{self.settings.worker_name}" if index == 0
                    else f"poll:{self.settings.worker_name}:{index}")
            shards.append(_HiveShard(
                index=index, uri=uri, client=client,
                session=HiveSession(
                    outage_after=self.settings.hive_outage_after,
                    name=f"shard{index}" if len(uris) > 1 else ""),
                spool=DeadLetterSpool(self._shard_dead_letter_dir(index)),
                backoff=Backoff(
                    base=self.settings.poll_backoff_base_s,
                    cap=self.settings.poll_backoff_cap_s,
                    seed=seed)))
        return shards

    async def _bootstrap_from_front(self) -> None:
        """``hive_front_uri`` names one federated front: resolve it into
        the shard list (``GET /api/shards``) and rebuild the session
        bundles from it, replacing a hand-configured list. An injected hive
        client always wins. Raises on an unreachable front."""
        front = str(self.settings.hive_front_uri or "").strip()
        if not front or self._hive_injected:
            return
        from chiaswarm_tpu_torch.node.federation import bootstrap_shard_uris

        uris = await bootstrap_shard_uris(front)
        if list(uris) == self.settings.hive_uris():
            return
        log.info("bootstrapped %d shard uri(s) from front %s",
                 len(uris), front)
        self.settings.hive_shard_uris = tuple(uris)
        self.settings.hive_uri = uris[0]
        self.shards = self._build_hive_shards(None)

    # the single-hive surface: shard 0 is the worker's one hive

    @property
    def hive(self) -> Any:
        return self.shards[0].client

    @hive.setter
    def hive(self, client: Any) -> None:
        self.shards[0].client = client

    @property
    def hive_session(self) -> HiveSession:
        return self.shards[0].session

    @property
    def dead_letters(self) -> DeadLetterSpool:
        return self.shards[0].spool

    @property
    def _poll_backoff(self) -> Backoff:
        return self.shards[0].backoff

    @property
    def _last_hive_epoch(self) -> int | None:
        return self.shards[0].last_epoch

    # ---- the default pool ----

    def _default_pool(self) -> ChipPool:
        resolve_device(None)  # no card: raises, there is no CPU fallback
        spec, n_slots, slot_spec = default_pool_plan(self.settings,
                                                     self.registry)
        self.mesh_spec = spec
        log.info("derived default mesh: %s", spec.shape)
        return ChipPool(n_slots=n_slots, mesh_spec=slot_spec)

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

    def _replay_dead_letters(self, when: str = "startup",
                             shards: list[_HiveShard] | None = None
                             ) -> int:
        """Re-queue spooled results for upload: at ``startup`` every
        shard's spool, or ``live`` the spool of a shard that healed
        mid-run (envelopes owed to a shard still down stay put). A file is
        discarded only after ITS upload succeeds (:meth:`_deliver`)."""
        replayed = 0
        multiplexed = len(self.shards) > 1
        for shard in (self.shards if shards is None else shards):
            found = 0
            for path, result in shard.spool.replay():
                key = str(path)
                if key in self._replayed_paths:
                    continue  # already riding from an earlier replay
                self._replayed_paths.add(key)
                result["_dead_letter_path"] = key
                if multiplexed:
                    # the replay goes to the shard whose spool held it
                    result.setdefault(HIVE_SHARD_KEY, shard.index)
                self.result_queue.put_nowait(result)
                self.stats.results_replayed += 1
                self._dl_replayed.inc(when=when)
                found += 1
            if found:
                log.warning("replaying %d dead-letter result(s) from %s "
                            "(%s)", found, shard.spool.directory, when)
            replayed += found
        return replayed

    def _shard_label(self, shard: _HiveShard) -> str:
        return f" shard {shard.index}" if len(self.shards) > 1 else ""

    def _note_hive_ok(self, shard: _HiveShard | None = None) -> None:
        """A poll, upload or beat reached this shard; a heal drains the
        shard's dead-letter spool live."""
        shard = shard if shard is not None else self.shards[0]
        if shard.session.note_success():
            log.warning("hive%s healed after %.1fs outage; replaying its "
                        "dead-letter spool live", self._shard_label(shard),
                        shard.session.last_outage_s)
            self._replay_dead_letters(when="live", shards=[shard])

    def _note_hive_failure(self, source: str, exc: Exception,
                           shard: _HiveShard | None = None) -> None:
        """A poll, upload or beat could not reach this shard. An HTTP 4xx
        is excluded: the hive answered. An outage assumes only this
        shard's leases lost."""
        if hive_reachable_error(exc):
            return
        shard = shard if shard is not None else self.shards[0]
        if shard.session.note_failure(source):
            assumed = sum(
                1 for job_id in self._inflight
                if self._inflight_shard.get(job_id, 0) == shard.index)
            self.stats.hive_outages += 1
            if assumed:
                self.stats.leases_assumed_lost += assumed
            log.error(
                "hive%s OUTAGE after %d consecutive %s failure(s); %d "
                "in-flight lease(s) assumed lost — work rides through, "
                "results spool to dead-letter and replay on heal",
                self._shard_label(shard), shard.session.consecutive_failures,
                source, assumed)

    def _note_hive_epoch(self, raw: Any,
                         shard: _HiveShard | None = None) -> int | None:
        """Track the epoch stamped on a shard's grants and acks (JAX
        :633-658). A change means that shard recovered from its journal:
        its pre-recovery leases are void and their jobs redeliver. Epochs
        are per shard."""
        try:
            epoch = None if raw is None else int(raw)
        except (TypeError, ValueError):
            return None
        if epoch is None:
            return None
        shard = shard if shard is not None else self.shards[0]
        previous = shard.last_epoch
        if previous is not None and epoch != previous:
            self.stats.hive_epoch_changes += 1
            log.warning("hive%s epoch %d -> %d: the hive recovered from "
                        "its journal; pre-recovery leases are void and "
                        "their jobs will redeliver",
                        self._shard_label(shard), previous, epoch)
        shard.last_epoch = epoch
        return epoch

    def _note_placement(self, raw: Any) -> None:
        """Feed a heartbeat ack's ``placement`` hint (the fleet planner's
        models for this worker) into the residency ledger, whose next idle
        poll warms hinted models first. A malformed or absent hint is
        ignored: it is advisory."""
        if not isinstance(raw, (list, tuple)) or not raw:
            return
        residency = getattr(self.registry, "residency", None)
        if residency is None:
            return
        try:
            residency.note_placement([str(m) for m in raw])
        except Exception:  # stub registries
            log.debug("placement hint dropped", exc_info=True)

    async def run(self) -> None:
        await self._bootstrap_from_front()
        self.startup()
        self._replay_dead_letters()
        # a redelivered job arrives with the hive's copy of its checkpoint:
        # leftovers of an earlier run would only shadow it
        self.checkpoints.clear()
        # bind the health endpoint before any task starts: a port clash
        # fails fast instead of leaving unsupervised tasks behind
        health_runner = await self._start_health_server()
        loop = asyncio.get_running_loop()
        signals = self._install_signal_handlers(loop)
        slot_tasks = [
            asyncio.create_task(self._slot_worker(slot), name=f"slot{i}")
            for i, slot in enumerate(self.pool)
        ]
        result_task = asyncio.create_task(self._result_worker(),
                                          name="results")
        # one poll loop per shard: a dead shard slows only its own loop
        poll_tasks = [
            asyncio.create_task(self._poll_loop(shard),
                                name=(f"poll{shard.index}"
                                      if len(self.shards) > 1 else "poll"))
            for shard in self.shards
        ]
        tasks = slot_tasks + [result_task] + poll_tasks
        if float(self.settings.heartbeat_s or 0) > 0:
            # heartbeats outlive the poll loop: they keep the leases of
            # draining in-flight jobs until the final cancellation below
            tasks.append(asyncio.create_task(self._heartbeat_loop(),
                                             name="heartbeat"))
        try:
            await self._stop.wait()
            await self._shutdown(poll_tasks, slot_tasks, result_task)
        finally:
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            # anything still queued embodies paid chip time: spool it
            self._spool_unsent_results()
            # refresh persisted breaker cooldowns (they survive restarts)
            self.breakers.save()
            if health_runner is not None:
                await health_runner.cleanup()
            self._remove_signal_handlers(loop, signals)

    async def _shutdown(self, poll_tasks, slot_tasks, result_task) -> None:
        """Graceful drain: polling halts first, in-flight slots finish,
        queued results upload, each phase bounded by its timeout."""
        log.info("stopping: polling halts; %d queued job(s) + in-flight "
                 "work drain, then %d pending result(s) upload",
                 self.work_queue.qsize(), self.result_queue.qsize())
        for poll_task in poll_tasks:
            poll_task.cancel()
        await asyncio.gather(*poll_tasks, return_exceptions=True)
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
            if len(self.shards) > 1:
                # stamp the owner before serializing (these envelopes never
                # reached _deliver), so the replay routes to it
                owner = None if trace is None else trace.meta.get(
                    HIVE_SHARD_KEY)
                if owner is None:
                    owner = self._inflight_shard.get(result.get("id"))
                if owner is not None:
                    result.setdefault(HIVE_SHARD_KEY, int(owner))
            spooled = result.pop("_dead_letter_path", None)
            if spooled is None:  # replayed results already have a file
                self._result_shard(result).spool.spool(result)
                self.stats.results_dead_lettered += 1
            self._settle_inflight(result)
            self._finish_trace(trace, result, settled="dead_letter")
            self.result_queue.task_done()

    # ---- health (JAX :805-1130) ----

    def _devices(self) -> list[str]:
        """The pool's devices, de-duplicated (a one-card seq mesh is one)."""
        return sorted({d for slot in self.pool
                       for d in _guard._slot_devices(slot)})

    def _profile_device(self) -> str:
        """What ``/debug/profile`` captures: CUDA activity when the pool
        runs on a card, the CPU alone when it runs on the CPU."""
        return ("cuda" if any(d.startswith("cuda") for d in self._devices())
                else "cpu")

    def health(self) -> dict[str, Any]:
        """``/healthz``: JAX's keys, with ``hive_epoch`` (shard 0's) and
        ``hive_shards`` (each shard's index, uri, session, epoch, spool
        depth and poll error streak), and ``device_memory``, each card's
        ``memory_allocated`` and ``max_memory_allocated``."""
        from chiaswarm_tpu_torch import WORKER_VERSION

        devices = self._devices()
        data: dict[str, Any] = {
            "status": "ok",
            "worker_version": WORKER_VERSION,
            "worker_name": self.settings.worker_name,
            "backend": self._profile_device(),
            "devices": len(devices),
            "slots": len(self.pool),
            "jobs_done": self.jobs_done,
            "queue_depth": self.work_queue.qsize(),
            "results_pending": self.result_queue.qsize(),
            "breakers": self.breakers.states(),
            "dead_letter_depth": sum(shard.spool.depth()
                                     for shard in self.shards),
            "poll_consecutive_errors": max(shard.backoff.failures
                                           for shard in self.shards),
            "checkpoint_depth": self.checkpoints.depth(),
            "checkpoints_written": self.checkpoints.written,
            "checkpoints_corrupt_skipped": self.checkpoints.corrupt_skipped,
            "inflight_jobs": len(self._inflight),
            "hive_session": self.hive_session.snapshot(),
            "hive_epoch": self._last_hive_epoch,
            "hive_shards": [
                {"shard": shard.index,
                 "uri": shard.uri,
                 "session": shard.session.snapshot(),
                 "hive_epoch": shard.last_epoch,
                 "dead_letter_depth": shard.spool.depth(),
                 "poll_consecutive_errors": shard.backoff.failures}
                for shard in self.shards
            ],
        }
        data.update(self.stats.snapshot())
        data["stepper"] = self._stepper_health()
        data["guard"] = self.guard.snapshot()
        # the measured hang-budget suggestion from this process's lane
        # step-seconds histogram, beside the priors
        data["guard"]["suggested_hang_budget"] = _guard.suggest_hang_budget()
        data["chips_in_service"] = sum(
            len(_guard._slot_devices(slot)) or 1 for slot in self.pool)
        data["overload"] = dict(self.overload.snapshot(),
                                enabled=bool(self.settings.overload_control))
        residency = getattr(self.registry, "residency", None)
        if residency is not None:
            data["residency"] = residency.snapshot()
        model_states = getattr(self.registry, "model_states", None)
        if callable(model_states):
            data["models"] = model_states()
        data["device_memory"] = {
            d: {"allocated_bytes": torch.cuda.memory_allocated(d),
                "max_allocated_bytes": torch.cuda.max_memory_allocated(d)}
            for d in devices if d.startswith("cuda")}
        return data

    def _fleet_metrics(self) -> dict[str, Any]:
        """The compact snapshot a heartbeat carries (JAX :877-924): demand
        (the arrival EWMA), supply (lane occupancy, cards in service) and
        state (overload, residency). Host dicts only; a failing part leaves
        a partial snapshot."""
        data: dict[str, Any] = {
            "queue_depth": self.work_queue.qsize(),
            "inflight_jobs": len(self._inflight),
            "jobs_done": self.jobs_done,
            "jobs_shed": self.stats.jobs_shed,
            "jobs_failed": self.stats.jobs_failed,
            "chips_in_service": sum(
                len(_guard._slot_devices(slot)) or 1 for slot in self.pool),
        }
        try:
            stepper = self._stepper_health()
            data.update(
                arrival_rate_rows_s=float(
                    stepper.get("arrival_rate") or 0.0),
                lane_occupancy=float(stepper.get("lane_occupancy") or 0.0),
                padding_waste=float(stepper.get("padding_waste") or 0.0),
                lanes_live=int(stepper.get("lanes_live") or 0),
                step_seconds_ewma=float(
                    stepper.get("step_seconds_ewma") or 0.0))
        except Exception:  # lanes absent or stubbed: no demand half
            pass
        try:
            data["overload"] = self.overload.fleet_view()
        except Exception:
            pass
        residency = getattr(self.registry, "residency", None)
        if residency is not None:
            try:
                snap = residency.snapshot()
                data["residency"] = {
                    "resident_models": len(
                        snap.get("resident_models") or ()),
                    "resident_bytes": snap.get("resident_bytes", 0),
                    "budget_bytes": snap.get("budget_bytes", 0),
                    "evictions": snap.get("evictions", 0),
                }
            except Exception:  # stub registries
                pass
        return data

    def _stepper_health(self) -> dict[str, Any]:
        """The lanes' stats (JAX :926-940): occupancy against padding,
        rows spliced mid-flight, steps executed, the step EWMA."""
        from chiaswarm_tpu_torch.serving.stepper import (
            aggregate_stats,
            stepper_enabled,
        )

        steppers = [st for st in
                    (getattr(slot, "_stepper", None) for slot in self.pool)
                    if st is not None]
        data = {"enabled": stepper_enabled()}
        data.update(aggregate_stats(steppers))
        return data

    def _collect_metrics(self) -> None:
        """Scrape-time mirror of the state the registry does not see change
        (JAX :942-1030): queue depths, spools, leases, breakers, the lanes'
        stats."""
        m = self.metrics
        m.gauge("chiaswarm_work_queue_depth",
                "jobs queued and not yet claimed by a slot").set(
            self.work_queue.qsize())
        m.gauge("chiaswarm_results_pending",
                "finished results waiting for upload").set(
            self.result_queue.qsize())
        m.counter("chiaswarm_jobs_done_total",
                  "jobs that completed execution on this worker").set_to(
            self.jobs_done)
        m.gauge("chiaswarm_dead_letter_depth",
                "result envelopes spooled on disk (all shard spools)").set(
            sum(shard.spool.depth() for shard in self.shards))
        m.gauge("chiaswarm_poll_consecutive_errors",
                "current poll-loop error streak (drives the backoff; "
                "worst shard)").set(
            max(shard.backoff.failures for shard in self.shards))
        m.gauge("chiaswarm_checkpoint_depth",
                "in-flight resume checkpoints on disk").set(
            self.checkpoints.depth())
        m.counter("chiaswarm_checkpoints_written_total",
                  "lane/phase resume checkpoints written").set_to(
            self.checkpoints.written)
        m.counter("chiaswarm_checkpoints_corrupt_total",
                  "corrupt checkpoint files skipped loudly").set_to(
            self.checkpoints.corrupt_skipped)
        m.gauge("chiaswarm_inflight_jobs",
                "jobs between poll receipt and settled upload (the "
                "lease-heartbeat set)").set(len(self._inflight))
        # the unlabeled gauge is the any-shard rollup; the labeled family
        # names the shard
        obs_metrics.hive_session_state_gauge(m).set(
            1 if any(shard.session.in_outage for shard in self.shards)
            else 0)
        shard_gauge = obs_metrics.hive_shard_session_state_gauge(m)
        for shard in self.shards:
            shard_gauge.set(1 if shard.session.in_outage else 0,
                            shard=str(shard.index))
        obs_metrics.trace_spans_evicted_counter(m).set_to(
            self.traces.spans_evicted)
        state_code = {"closed": 0, "half_open": 1, "open": 2}
        breaker_state = m.gauge(
            "chiaswarm_breaker_state",
            "per-model circuit breaker (0=closed 1=half-open 2=open)",
            labelnames=("model",))
        breaker_failures = m.gauge(
            "chiaswarm_breaker_consecutive_failures",
            "per-model consecutive breaker-counted failures",
            labelnames=("model",))
        for model, snap in self.breakers.states().items():
            breaker_state.set(state_code.get(snap["state"], 2), model=model)
            breaker_failures.set(snap["consecutive_failures"], model=model)
        stepper = self._stepper_health()
        for key in _STEPPER_COUNTERS:
            m.counter(f"chiaswarm_stepper_{key}_total",
                      f"step scheduler: cumulative {key}").set_to(
                stepper.get(key, 0))
        for key in _STEPPER_GAUGES:
            m.gauge(f"chiaswarm_stepper_{key}",
                    f"step scheduler: current {key}").set(
                stepper.get(key, 0))
        m.gauge("chiaswarm_stepper_enabled",
                "1 when CHIASWARM_STEPPER lane routing is on").set(
            1 if stepper.get("enabled") else 0)

    async def _start_health_server(self):
        """Serve ``/healthz``, ``/metrics``, ``/debug/traces``,
        ``/debug/profile`` and ``/debug/numerics`` on ``health_host``
        (loopback by default) at
        ``health_port``, or an ephemeral port with ``health_bind_ephemeral``
        (``self.health_address`` says which). None when neither is set."""
        port = int(self.settings.health_port or 0)
        if port <= 0 and not self.settings.health_bind_ephemeral:
            return None
        from aiohttp import web

        async def healthz(_request):
            return web.json_response(self.health())

        async def metrics_endpoint(_request):
            body = obs_metrics.render_all([self.metrics,
                                           obs_metrics.REGISTRY])
            return web.Response(
                body=body.encode("utf-8"),
                headers={"Content-Type": obs_metrics.CONTENT_TYPE})

        async def traces_endpoint(request):
            # ?since=<seq> is the scrape cursor: only traces pushed after
            # it return, and the cursor block shows an eviction gap
            since = None
            if request.query.get("since"):
                try:
                    since = int(request.query["since"])
                except ValueError:
                    return web.json_response(
                        {"status": "error",
                         "error": "since must be an integer ring "
                                  "sequence number"}, status=400)
            cursor = self.traces.cursor()
            if request.query.get("format") == "tree":
                return web.json_response(
                    {"traces": self.traces.to_dicts(since),
                     "cursor": cursor})
            doc = self.traces.to_chrome(since)
            doc["cursor"] = cursor
            return web.json_response(doc)

        async def profile_endpoint(request):
            try:
                seconds = float(request.query.get("seconds", "5"))
            except ValueError:
                return web.json_response(
                    {"status": "error", "error": "seconds must be a "
                     "number"}, status=400)
            out = request.query.get("dir") or None
            # the capture blocks for its duration: off the event loop
            result = await asyncio.get_running_loop().run_in_executor(
                None, functools.partial(obs_profiling.capture, seconds, out,
                                        self._profile_device()))
            status = {"ok": 200, "busy": 409}.get(result.get("status"), 500)
            return web.json_response(result, status=status)

        async def numerics_endpoint(request):
            # the ring of per-probe summaries, filtered by probe prefix;
            # the payload says whether the taps are on, so "empty because
            # off" and "empty because nothing tapped" read differently.
            # Reading it copies the queued summaries off the card
            limit = None
            try:
                if request.query.get("limit"):
                    limit = int(request.query["limit"])
            except ValueError:
                return web.json_response(
                    {"status": "error",
                     "error": "limit must be an integer"}, status=400)
            payload = await asyncio.get_running_loop().run_in_executor(
                None, functools.partial(
                    obs_numerics.debug_payload,
                    probe_prefix=request.query.get("probe") or None,
                    limit=limit))
            return web.json_response(payload)

        app = web.Application()
        app.router.add_get("/healthz", healthz)
        app.router.add_get("/metrics", metrics_endpoint)
        app.router.add_get("/debug/traces", traces_endpoint)
        app.router.add_get("/debug/profile", profile_endpoint)
        app.router.add_get("/debug/numerics", numerics_endpoint)
        runner = web.AppRunner(app)
        await runner.setup()
        host = self.settings.health_host or "127.0.0.1"
        site = web.TCPSite(runner, host, max(port, 0))
        await site.start()
        bound_port = runner.addresses[0][1] if runner.addresses else port
        self.health_address = (host, bound_port)
        log.info("health endpoints on %s:%d (/healthz /metrics "
                 "/debug/traces /debug/profile /debug/numerics)", host,
                 bound_port)
        return runner

    # ---- the healing ladder (serving/guard.py) ----

    def _apply_heal_rungs(self) -> None:
        """Apply the rungs the device guard queued since the last poll (JAX
        :1324-1365). The lane rebuild happened lane-side at condemnation.

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

    # ---- tasks ----

    async def _poll_loop(self, shard: _HiveShard | None = None) -> None:
        shard = shard if shard is not None else self.shards[0]
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
                # predictive backpressure: the controller throttles intake
                # as soon as the queued backlog's drain estimate outruns
                # the budget, before the queue is full of jobs it would shed
                if self.settings.overload_control:
                    throttle = self.overload.poll_throttle(
                        self.work_queue.qsize(), len(self.pool))
                    if throttle > 0:
                        self.stats.polls_backpressured += 1
                        try:
                            await asyncio.wait_for(self._stop.wait(),
                                                   timeout=throttle)
                        except asyncio.TimeoutError:
                            pass
                        continue
                delay = await self._ask_for_work(session, shard)
                self._apply_heal_rungs()
                try:
                    await asyncio.wait_for(self._stop.wait(), timeout=delay)
                except asyncio.TimeoutError:
                    pass

    async def _ask_for_work(self, session: aiohttp.ClientSession,
                            shard: _HiveShard | None = None) -> float:
        """One poll of one shard; returns the next delay. Errors back off
        exponentially with jitter (capped at ``poll_backoff_cap_s``) and
        the schedule resets on the first successful poll. A federated
        grant may be stolen: it names its owner shard, which holds its
        lease, journal entry and epoch."""
        shard = shard if shard is not None else self.shards[0]
        t_poll = time.perf_counter()
        try:
            jobs = await shard.client.get_work(session)
        except BadWorkerError as exc:
            # the hive ANSWERED (flagged us): reachable, not an outage
            self._note_hive_ok(shard)
            log.error("hive flagged this worker: %s", exc)
            return shard.backoff.next()
        except Exception as exc:
            self._note_hive_failure("poll", exc, shard)
            log.warning("poll failed: %s", exc)
            return shard.backoff.next()
        self._note_hive_ok(shard)
        shard.backoff.reset()
        poll_http_s = time.perf_counter() - t_poll
        if jobs:
            self._note_poll(jobs)
        # the brownout cap, refreshed on every poll: it lands promptly under
        # load and lifts on the next (possibly idle) poll once cleared
        self._push_admission_caps()
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
            # covers the queue wait until a slot picks the job up. A
            # redelivered job carries its lineage: the delivery attempt and
            # the checkpoint step it resumes from
            resume = job.get("resume")
            # the hive's stamps never reach argument formatting: the trace
            # context joins the trace, the owner shard and its epoch ride
            # the trace to the upload (the epoch tracked on the owner,
            # whichever shard's poll delivered the grant)
            ctx = job.pop(obs_flight.TRACE_CTX_KEY, None)
            owner_raw = job.pop(HIVE_SHARD_KEY, None)
            try:
                owner_index = (shard.index if owner_raw is None
                               else int(owner_raw))
            except (TypeError, ValueError):
                owner_index = shard.index
            owner = (self.shards[owner_index]
                     if 0 <= owner_index < len(self.shards) else shard)
            epoch = self._note_hive_epoch(job.pop(HIVE_EPOCH_KEY, None),
                                          owner)
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
            if epoch is not None:
                trace.meta[HIVE_EPOCH_KEY] = epoch
            if owner_raw is not None:
                # only a federated grant carries a shard, and only then
                # does the upload echo one
                trace.meta[HIVE_SHARD_KEY] = owner.index
            if isinstance(ctx, dict) and ctx.get("trace_id"):
                # join the hive's trace: the upload carries a span digest
                trace.meta["trace_id"] = str(ctx.get("trace_id"))
                trace.meta["span_id"] = str(ctx.get("span_id") or "")
            trace.phase("poll", http_s=round(poll_http_s, 6))
            obs_trace.attach(job, trace)
            self._inflight[job.get("id")] = time.monotonic()
            self._inflight_shard[job.get("id")] = owner.index
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

    def _note_poll(self, jobs: list[dict]) -> None:
        """The lanes' poll hint (JAX :1198-1210): tell each slot's step
        scheduler how many rows this poll is about to submit, so an adaptive
        lane grows at its next boundary instead of queueing the burst behind
        a full lane. A hint only: it never creates a scheduler."""
        rows = sum(max(1, int(job.get("num_images_per_prompt") or 1))
                   for job in jobs)
        for slot in self.pool:
            stepper = getattr(slot, "_stepper", None)
            if stepper is not None:
                stepper.note_poll(rows)

    def _push_admission_caps(self) -> None:
        """Mirror the overload controller's brownout admission cap into
        every slot's step scheduler (None lifts it)."""
        cap = (self.overload.admission_cap()
               if self.settings.overload_control else None)
        for slot in self.pool:
            stepper = getattr(slot, "_stepper", None)
            if stepper is not None:
                stepper.set_admission_cap(cap)

    async def _heartbeat_loop(self) -> None:
        """Lease keep-alive (JAX :1408-1576): every ``heartbeat_s`` each
        shard gets a beat naming the in-flight jobs whose lease it owns,
        with each checkpoint changed since the last beat and the shard's
        epoch. A hive that reassigned a lease answers with the lost ids:
        the local run goes on (the first upload wins hive-side), the loss
        is counted and warned once. A shard with no leases here gets an
        idle beat, the metrics snapshot alone. A dead shard fails only its
        own beat."""
        interval = float(self.settings.heartbeat_s)
        # the metrics snapshot refreshes at most every ~2 s per shard:
        # leases can beat at 20 Hz, and an autoscaler reads seconds-scale
        # state
        metrics_every = max(interval, 2.0)
        pushed: dict[Any, int] = {}  # job id -> spool version last pushed
        # leases the hive already reported lost: counted once per loss
        lost_reported: set[str] = set()

        def build_jobs(ids: list) -> list[dict]:
            # in a thread: latent-sized files would stall the event loop.
            # A None checkpoint means unchanged since the last beat (the
            # hive keeps its copy)
            jobs = []
            for job_id in ids:
                version = self.checkpoints.version(job_id)
                if (version is None or pushed.get(job_id) == version
                        or str(job_id) in lost_reported):
                    # a lost lease's checkpoint custody moved with it
                    jobs.append({"id": job_id, "checkpoint": None})
                    continue
                checkpoint = self.checkpoints.load(job_id)
                if checkpoint is not None:
                    pushed[job_id] = version
                jobs.append({"id": job_id, "checkpoint": checkpoint})
            return jobs

        async def idle_beat(shard: _HiveShard) -> None:
            # no lease here: a metrics-only beat at the metrics cadence,
            # so the hive sees idle capacity too
            if time.monotonic() - shard.last_metrics < metrics_every:
                return
            payload = {
                "worker_name": self.settings.worker_name,
                "jobs": [],
                "metrics": self._fleet_metrics(),
            }
            if shard.last_epoch is not None:
                payload[HIVE_EPOCH_KEY] = shard.last_epoch
            try:
                ack = await shard.client.post_heartbeat(session, payload)
                self._note_hive_ok(shard)
                if isinstance(ack, dict):
                    self._note_hive_epoch(ack.get(HIVE_EPOCH_KEY), shard)
                    self._note_placement(ack.get("placement"))
                shard.last_metrics = time.monotonic()
            except Exception as exc:
                self._note_hive_failure("heartbeat", exc, shard)
                log.debug("idle heartbeat failed: %s", exc)

        async with aiohttp.ClientSession() as session:
            while True:
                await asyncio.sleep(interval)
                if self._stop.is_set() and not self._inflight:
                    return
                if not self._inflight:
                    pushed.clear()
                    lost_reported.clear()
                    for shard in self.shards:
                        await idle_beat(shard)
                    continue
                inflight = list(self._inflight)
                for job_id in [j for j in pushed if j not in self._inflight]:
                    pushed.pop(job_id, None)
                lost_reported &= {str(j) for j in inflight}
                by_owner: dict[int, list] = {}
                for job_id in inflight:
                    by_owner.setdefault(
                        self._inflight_shard.get(job_id, 0),
                        []).append(job_id)
                reported: set[str] = set()
                any_beat_ok = False
                for shard in self.shards:
                    owned = by_owner.get(shard.index)
                    if not owned:
                        await idle_beat(shard)
                        continue
                    payload = {
                        "worker_name": self.settings.worker_name,
                        "jobs": await asyncio.to_thread(build_jobs, owned),
                    }
                    if shard.last_epoch is not None:
                        # the epoch handshake: a recovered hive rejects a
                        # beat claiming a pre-restart epoch, and its ack
                        # hands back the current one for the next beat
                        payload[HIVE_EPOCH_KEY] = shard.last_epoch
                    if time.monotonic() - shard.last_metrics \
                            >= metrics_every:
                        payload["metrics"] = self._fleet_metrics()
                        shard.last_metrics = time.monotonic()
                    try:
                        response = await shard.client.post_heartbeat(
                            session, payload)
                        self._note_hive_ok(shard)
                        # a malformed 2xx body counts as a failed beat,
                        # never a loop exit
                        lost_raw = response.get("lost") or []
                        if not isinstance(lost_raw, list):
                            raise TypeError("non-list 'lost' in heartbeat "
                                            f"response: {lost_raw!r}")
                        reported |= {str(j) for j in lost_raw}
                        self._note_hive_epoch(
                            response.get(HIVE_EPOCH_KEY), shard)
                        self._note_placement(response.get("placement"))
                        any_beat_ok = True
                    except Exception as exc:
                        # a reference hive has no heartbeat endpoint, and
                        # a partitioned hive is exactly when beats go on
                        self._note_hive_failure("heartbeat", exc, shard)
                        log.debug("heartbeat failed: %s", exc)
                if not any_beat_ok:
                    continue
                self.stats.lease_heartbeats += 1
                reported &= {str(j) for j in inflight}
                lost = sorted(reported - lost_reported)
                # replaced, not accumulated: a job the hive stops reporting
                # lost was leased back to us, and a later loss warns anew
                lost_reported = reported
                if lost:
                    self.stats.leases_lost += len(lost)
                    log.warning("hive reassigned lease(s) for %s; local "
                                "work continues, upload will dedupe", lost)

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
            # the estimator learns the slowness a timeout proves
            self.overload.note_service(jobs[0].get("workflow"), budget)
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
        # deadline-aware admission: jobs predicted to miss their deadline
        # behind the local backlog shed before any kernel runs, as
        # non-fatal "overloaded" envelopes (capacity, not failure)
        if ready and self.settings.overload_control:
            ready = self._shed_gate(burst, results, ready)
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

    def _job_deadline_s(self, job: dict) -> float:
        """A job's end-to-end deadline (JAX :1873-1899): its own
        ``deadline_s``, else the operator's per-family override
        (``family_deadline_s``), else the per-workflow setting."""
        raw = job.get("deadline_s")
        if raw is not None:
            try:
                value = float(raw)
                if value > 0:
                    return value
            except (TypeError, ValueError):
                pass
        table = self.settings.family_deadline_s or {}
        if table:
            family = self._model_family(job.get("model_name"))
            if family is not None and family in table:
                try:
                    value = float(table[family])
                    if value > 0:
                        return value
                except (TypeError, ValueError):
                    pass
        return self.settings.deadline_for(job.get("workflow"))

    @staticmethod
    def _model_family(model_name: Any) -> str | None:
        """Catalog family of a model name (None when unresolvable)."""
        if not model_name:
            return None
        try:
            from chiaswarm_tpu_torch.models.configs import get_family

            return str(get_family(str(model_name)).name)
        except Exception:
            return None

    def _shed_gate(self, burst: list[dict], results: list,
                   ready: list[int]) -> list[int]:
        """Admission verdicts for a burst about to run (JAX :1914-1967);
        returns the indices that survive. A shed job's envelope settles
        through the normal result path."""
        now = time.monotonic()
        stepper = self._stepper_health()
        step_ewma = float(stepper.get("step_seconds_ewma") or 0.0)
        queued = self.work_queue.qsize()
        slots = len(self.pool)
        admitted: list[int] = []
        for i in ready:
            job = burst[i]
            received = self._inflight.get(job.get("id"))
            # the job's age: the hive's queue time (a lease-aware hive's
            # "queued_s" stamp) plus the local queue wait
            try:
                queued_s = max(0.0, float(job.get("queued_s") or 0.0))
            except (TypeError, ValueError):
                queued_s = 0.0
            lane_estimate = None
            if stepper.get("enabled") and step_ewma > 0.0:
                try:
                    steps = int(job.get("num_inference_steps") or 0)
                except (TypeError, ValueError):
                    steps = 0
                if steps > 0:
                    lane_estimate = steps * step_ewma
            decision = self.overload.should_shed(
                workflow=job.get("workflow"),
                waited_s=queued_s + (0.0 if received is None
                                     else max(0.0, now - received)),
                deadline_s=self._job_deadline_s(job),
                # burst mates admitted ahead of this job are backlog too
                queued_ahead=queued + len(admitted), slots=slots,
                lane_estimate_s=lane_estimate)
            if not decision.shed:
                admitted.append(i)
                continue
            self.stats.jobs_shed += 1
            log.warning("job %s shed at admission: %s", job.get("id"),
                        decision.reason)
            results[i] = error_result(
                job, f"shed by overload control on this node "
                     f"({decision.reason}); a less-loaded node may "
                     f"still serve it", kind="overloaded")
        if len(admitted) < len(ready):
            # sheds may have tripped (or extended) brownout: cap the lanes
            self._push_admission_caps()
        return admitted

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
            # the grant's epoch, owner shard and span digest go on the
            # envelope before any upload attempt, so a spooled envelope
            # keeps them for its replay; none is sent to a hive that
            # stamped none
            if trace.meta.get(HIVE_EPOCH_KEY) is not None:
                result.setdefault(HIVE_EPOCH_KEY,
                                  trace.meta[HIVE_EPOCH_KEY])
            if trace.meta.get(HIVE_SHARD_KEY) is not None:
                result.setdefault(HIVE_SHARD_KEY,
                                  trace.meta[HIVE_SHARD_KEY])
            if trace.meta.get("trace_id"):
                try:
                    result[obs_flight.SPAN_DIGEST_KEY] = \
                        obs_flight.span_digest(
                            trace, worker_name=self.settings.worker_name)
                except Exception as exc:  # telemetry never blocks upload
                    log.debug("span digest failed for %s: %s",
                              result.get("id"), exc)
        shard = self._result_shard(result)
        try:
            with obs_trace.activate(trace):
                uploaded = await self._upload_with_retry(session, result,
                                                         shard)
        except asyncio.CancelledError:
            # shutdown cancelled us mid-upload: persist before dying
            if spooled is None:
                shard.spool.spool(result)
                self.stats.results_dead_lettered += 1
            self._settle_inflight(result)
            self._finish_trace(trace, result, settled="dead_letter")
            raise
        if uploaded:
            if spooled is not None:
                shard.spool.discard(spooled)
                self._replayed_paths.discard(str(spooled))
            # the job settled: its resume checkpoint is garbage
            self.checkpoints.discard(result.get("id"))
        elif spooled is None:
            shard.spool.spool(result)
            self.stats.results_dead_lettered += 1
        else:
            # a replayed result that failed again keeps its file and
            # leaves the in-queue set, so the next heal replays it
            self._replayed_paths.discard(str(spooled))
        self._settle_inflight(result)
        self._finish_trace(trace, result,
                           settled="uploaded" if uploaded else "dead_letter")

    def _result_shard(self, result: dict) -> _HiveShard:
        """The shard an upload belongs to: the envelope's owner-shard echo
        (stamped from the grant; it survives spool and replay), else the
        in-flight routing table, else shard 0."""
        raw = result.get(HIVE_SHARD_KEY)
        if raw is None:
            raw = self._inflight_shard.get(result.get("id"))
        try:
            index = 0 if raw is None else int(raw)
        except (TypeError, ValueError):
            index = 0
        if 0 <= index < len(self.shards):
            return self.shards[index]
        return self.shards[0]

    def _settle_inflight(self, result: dict) -> None:
        """The job left this worker (uploaded or dead-lettered): its lease
        is no longer beaten."""
        self._inflight.pop(result.get("id"), None)
        self._inflight_shard.pop(result.get("id"), None)

    def _finish_trace(self, trace, result: dict, settled: str) -> None:
        """Close a job's span tree, publish it to the trace ring, and fold
        its phases into the latency histograms."""
        if trace is None:
            return
        outcome = classify_result(result)
        trace.meta["outcome"] = outcome
        trace.meta["settled"] = settled
        trace.finish(self.traces)
        service_s = 0.0
        for phase in trace.root.children:
            self._phase_seconds.observe(phase.duration_s, phase=phase.name)
            if phase.name in ("execute", "upload"):
                service_s += phase.duration_s
        self._job_seconds.observe(trace.root.duration_s)
        self._jobs_total.inc(outcome=outcome)
        if outcome == "ok" and service_s > 0.0:
            # the admission estimator's service EWMA learns a successful
            # job's worker-side cost (execute + upload), per job of the
            # attempt its execute phase spanned; failures would drag it
            # toward zero and re-admit the jobs being shed
            try:
                attempt_jobs = max(1, int(
                    trace.meta.get("attempt_jobs") or 1))
            except (TypeError, ValueError):
                attempt_jobs = 1
            self.overload.note_service(trace.meta.get("workflow"),
                                       service_s / attempt_jobs)

    async def _upload_with_retry(self, session, result,
                                 shard: _HiveShard | None = None) -> bool:
        shard = shard if shard is not None else self.shards[0]
        retries = max(1, int(self.settings.upload_retries))
        for attempt in range(1, retries + 1):
            try:
                response = await shard.client.post_result(session, result)
                self._note_hive_ok(shard)
                log.info("uploaded result %s: %s", result.get("id"),
                         response)
                return True
            except Exception as exc:
                self._note_hive_failure("upload", exc, shard)
                self.stats.upload_retries += 1
                log.warning("result upload attempt %d/%d failed: %s",
                            attempt, retries, exc)
                if shard.session.in_outage:
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
