"""Job executor: counterpart of ``chiaswarm_tpu/node/executor.py``
(``_error_payload``/``_result``/``error_result``/``_format``/``_execute``
:62-212, ``_stepper_submit``/``_stepper_collect``/``_stepper_resubmit``
:215-343, ``synchronous_do_work`` :346-367 (with ``checkpoint_scope`` :355, :589 and
``job_profile`` :179, :551), ``job_rows`` :386,
``_coalesce_key`` :370-384, ``single_chip_rows`` :397-416, ``rows_cap``
:418, ``_row_chunks`` :428-455, ``synchronous_do_work_batch`` :458-593,
and the async
``do_work``/``do_work_batch`` :47-59, which the worker awaits: each runs its
synchronous twin on a thread of the event loop's default executor).

Error taxonomy, as in the reference: argument-formatting errors and
``ValueError`` raised by callbacks are fatal (``fatal_error: True``, do not
redispatch) unless their kind is non-fatal (``model_unavailable``,
``bad_asset`` ...); a screened poisoned output uploads an ``invalid_output``
envelope; any other exception returns an error artifact without the fatal
flag so the hive may retry elsewhere. Every failure renders as an artifact.

Lanes first, as in the JAX executor: an eligible txt2img job goes to the
slot's continuous-batching scheduler (``serving/stepper.py``); a job the
lane rejects or fails takes the per-job (solo) path, the zero-loss ladder,
and so does a job whose model the residency ledger has degraded to
load-per-job (``registry.lane_resident_ok``, JAX :230-238). A model that
cannot fit even transiently raises ``ModelUnavailable``: the non-fatal
``model_unavailable`` envelope.
Both paths run on the slot's device. ``CHIASWARM_STEPPER=0`` sends every job
down the solo path.

A burst (:func:`synchronous_do_work_batch`) submits its lane jobs first;
then the rest of its compatible diffusion jobs (every one under
``CHIASWARM_STEPPER=0``; under lanes the residue they turn away, such as
guidance-1.0 jobs) are grouped by :func:`_coalesce_key`, chunked by
:func:`_row_chunks` so no program carries more rows than ``rows_cap`` allows,
and each group of two or more runs as one batched program
(``workloads/diffusion.py::diffusion_coalesced_callback``), with a
``coalesced`` span in each member's trace. A group that raises, or returns
a wrong count, falls back to per-job runs with a WARNING, as in JAX; the
singles run last.

The gray-failure guard (``serving/guard.py``): a diffusion job's solo call
runs under the hang watchdog (``watch_solo``; a hung call raises
``StepHung``, ``transient`` for the worker's retry ladder), and an
``invalid_output`` feeds the slot's device guard. A job whose lane the
watchdog condemned (``LaneHung``) is re-admitted once to a fresh lane with
the seed its first admission drew and the condemnation's checkpoint, so it
resumes at that step (the lane-rebuild rung); a second hang takes the per-job
path. A burst re-admits its condemned jobs together, in order, once every
job of the burst has left its lane, so they share a fresh lane in the slots
and at the width they held (a lane row's bits depend on both).

Durability: each job's run binds the slot's checkpoint spool (attached by a
worker with heartbeats on) with ``checkpoint_scope``, so the solo path's
phase markers land under the job's id; lanes write their own step-boundary
checkpoints. With ``CHIASWARM_PROFILE_DIR`` set, each solo call and
coalesced program records a profiler trace there (``obs/profiling.py``;
skipped while another capture holds the profiler).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Any

from chiaswarm_tpu_torch import WORKER_VERSION
from chiaswarm_tpu_torch.node.hive import HIVE_EPOCH_KEY, HIVE_SHARD_KEY
from chiaswarm_tpu_torch.node.job_args import format_args
from chiaswarm_tpu_torch.node.output_processor import (
    encode_image,
    image_from_text,
    make_result,
    make_text_result,
)
from chiaswarm_tpu_torch.node.resilience import (
    NONFATAL_KINDS,
    checkpoint_scope,
    classify_exception,
)
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.obs.flight import TRACE_CTX_KEY
from chiaswarm_tpu_torch.obs.profiling import job_profile
from chiaswarm_tpu_torch.serving.guard import (
    InvalidOutput,
    LaneHung,
    _slot_devices,
    watch_solo,
)

log = logging.getLogger("chiaswarm_torch.executor")

# what a job may carry that is never a job argument: the worker's trace,
# and the trace context, epoch and owner-shard stamps a lease-aware or
# federated hive adds. The worker pops the last three at poll receipt;
# a job handed to the executor directly still never formats them
_NOT_ARGUMENTS = (obs_trace.TRACE_KEY, TRACE_CTX_KEY, HIVE_EPOCH_KEY,
                  HIVE_SHARD_KEY)


async def do_work(job: dict[str, Any], slot, registry) -> dict:
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None, synchronous_do_work, job, slot, registry)


async def do_work_batch(jobs: list[dict[str, Any]], slot,
                        registry) -> list[dict]:
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None, synchronous_do_work_batch, jobs, slot, registry)


def _error_payload(exc: Exception, content_type: str,
                   kind: str | None = None) -> tuple[dict, dict]:
    message = str(exc.args[0] if exc.args else "error generating result")
    config = {
        "error": message,
        "error_kind": kind or classify_exception(exc),
        "error_class": type(exc).__name__,
    }
    if content_type.startswith("image/"):
        img = image_from_text(message)
        artifacts = {"primary": make_result(encode_image(img, content_type),
                                            content_type)}
    else:
        artifacts = {"primary": make_text_result(message)}
    return artifacts, config


def _result(job_id: Any, artifacts: dict, config: dict,
            fatal: bool = False) -> dict[str, Any]:
    result = {
        "id": job_id,
        "artifacts": artifacts,
        "nsfw": config.get("nsfw", False),
        "worker_version": WORKER_VERSION,
        "pipeline_config": config,
    }
    if fatal:
        result["fatal_error"] = True
    return result


def error_result(job: dict[str, Any], exc_or_message: Any, *,
                 kind: str | None = None) -> dict:
    """Structured error envelope for a job that never produced a result
    through the normal executor path: a lane deadline expiry, a poisoned
    lane row, the worker's deadline, a crashed burst or a breaker's
    refusal. Same wire shape as executor-internal failures."""
    if isinstance(exc_or_message, BaseException):
        exc: Exception = exc_or_message if isinstance(
            exc_or_message, Exception) else RuntimeError(str(exc_or_message))
    else:
        exc = RuntimeError(str(exc_or_message))
    content_type = str(job.get("content_type") or "image/jpeg")
    artifacts, config = _error_payload(exc, content_type, kind=kind)
    return _result(job.get("id"), artifacts, config)


def _format(job: dict[str, Any], registry):
    """-> ((job_id, content_type, callback, kwargs), None) or
    (None, fatal result)."""
    job = dict(job)
    for key in _NOT_ARGUMENTS:
        job.pop(key, None)
    job_id = job.pop("id", None)
    content_type = job.get("content_type", "image/jpeg")
    try:
        with obs_trace.span("format"):
            callback, kwargs = format_args(job, registry)
    except Exception as exc:
        kind = classify_exception(exc)
        fatal = kind not in NONFATAL_KINDS
        log.warning("job %s failed formatting (%s): %s", job_id, kind, exc)
        artifacts, config = _error_payload(exc, content_type, kind=kind)
        return None, _result(job_id, artifacts, config, fatal=fatal)
    return (job_id, content_type, callback, kwargs), None


def _note_invalid(slot, model: Any) -> None:
    """A poisoned output is a health event for the slot's devices."""
    guard = getattr(slot, "_guard", None)
    if guard is not None:
        guard.note_invalid_output(_slot_devices(slot), model=str(model or ""))


def _execute(job_id, content_type, callback, kwargs, slot) -> dict:
    # a diffusion job's solo denoise runs under the hang watchdog, keyed by
    # (model, height, width): each key's first watched call gets the
    # ceiling budget
    watched_steps = (kwargs.get("num_inference_steps")
                     if getattr(callback, "__name__", "")
                     == "diffusion_callback" else None)
    watch_key = (str(kwargs.get("model_name")), kwargs.get("height"),
                 kwargs.get("width"))
    try:
        with job_profile(job_id, device=getattr(slot, "device", None)), \
                watch_solo(slot, watched_steps, key=watch_key):
            artifacts, config = slot(callback, **kwargs)
    except InvalidOutput as exc:
        _note_invalid(slot, kwargs.get("model_name"))
        log.error("job %s produced invalid output (%s); envelope uploaded "
                  "instead of the poisoned image", job_id, exc)
        artifacts, config = _error_payload(exc, content_type,
                                           kind="invalid_output")
        return _result(job_id, artifacts, config)
    except ValueError as exc:  # callback-declared input error
        kind = classify_exception(exc)
        fatal = kind not in NONFATAL_KINDS
        log.warning("job %s %s: %s", job_id, "fatal" if fatal else kind, exc)
        artifacts, config = _error_payload(exc, content_type, kind=kind)
        return _result(job_id, artifacts, config, fatal=fatal)
    except Exception as exc:  # no fatal flag: the hive may retry elsewhere
        log.exception("job %s errored", job_id)
        artifacts, config = _error_payload(exc, content_type)
        return _result(job_id, artifacts, config)
    return _result(job_id, artifacts, config)


def _stepper_submit(job_id, content_type, callback, kwargs, slot, registry):
    """Submit an eligible txt2img job to the slot's step scheduler. Returns
    a ticket, or None: run the job through the per-job path instead.
    Submission failures are never terminal for the job."""
    from chiaswarm_tpu_torch.core.rng import draw_seed
    from chiaswarm_tpu_torch.serving.stepper import LaneReject
    from chiaswarm_tpu_torch.workloads.diffusion import (
        diffusion_callback,
        stepper_eligible,
        stepper_submit,
    )

    if callback is not diffusion_callback or not stepper_eligible(kwargs):
        return None
    # residency fast path: a model the ledger knows is degraded to
    # load-per-job must not pin a lane, nor pay a transient load only to
    # be refused by the lane (stepper_submit checks again after a
    # first-ever load)
    lane_ok = getattr(registry, "lane_resident_ok", None)
    if callable(lane_ok) and not lane_ok(str(kwargs.get("model_name"))):
        log.debug("job %s model degraded to load-per-job; skipping lanes",
                  job_id)
        return None
    seed = kwargs.get("seed")
    seed = draw_seed() if seed is None else int(seed)
    try:
        return stepper_submit(slot, registry, kwargs, seed, job_id=job_id)
    except LaneReject as exc:
        log.debug("job %s not lane-eligible (%s)", job_id, exc)
        return None
    except Exception as exc:  # the per-job path still serves the job
        log.warning("job %s lane submit failed (%s); per-job path",
                    job_id, exc)
        return None


def _stepper_collect(job_id, content_type, slot, ticket) -> dict | None:
    """Wait out a lane ticket. Returns the finished result, a timeout
    envelope (in-lane deadline expiry), an ``invalid_output`` envelope
    (poisoned rows), or None: the job re-runs through the per-job path (a
    lane fault; zero-loss fallback), or, when the watchdog condemned its
    lane, is re-admitted by :func:`_collect_lanes`."""
    from chiaswarm_tpu_torch.serving.stepper import LaneDeadline, get_stepper
    from chiaswarm_tpu_torch.workloads.diffusion import stepper_finish

    job = {"id": job_id, "content_type": content_type}
    try:
        artifacts, config = stepper_finish(ticket)
    except LaneDeadline as exc:
        return error_result(job, exc, kind="timeout")
    except InvalidOutput as exc:
        _note_invalid(slot, ticket.model_name)
        log.error("job %s retired invalid_output (%s); envelope uploaded "
                  "instead of a poisoned image", job_id, exc)
        return error_result(job, exc, kind="invalid_output")
    except LaneHung as exc:
        # the hang reached the device guard when the lane was condemned
        log.warning("job %s lost its lane to the watchdog (%s)", job_id, exc)
        return None
    except Exception as exc:  # the per-job path re-runs the job
        kind = classify_exception(exc)
        if kind == "oom":
            get_stepper(slot).note_oom()  # rebuild lanes narrower
        log.warning("job %s lane run failed (%s: %s); per-job path",
                    job_id, kind, exc)
        return None
    return _result(job_id, artifacts, config)


def _stepper_resubmit(job_id, slot, registry, kwargs, ticket, exc):
    """Re-admit a condemned lane's job to a fresh lane (the lane-rebuild
    rung): its kwargs, the seed its first admission drew, and the
    condemnation's checkpoint as ``resume``. Returns the new ticket, or None
    (the per-job path)."""
    from chiaswarm_tpu_torch.workloads.diffusion import stepper_submit

    retry_kwargs = dict(kwargs)
    retry_kwargs["seed"] = ticket.seed
    resume = getattr(exc, "resume", None)
    if isinstance(resume, dict):
        retry_kwargs["resume"] = resume
    else:
        retry_kwargs.pop("resume", None)
    try:
        retry = stepper_submit(slot, registry, retry_kwargs, ticket.seed,
                               job_id=job_id)
    except Exception as submit_exc:
        log.warning("job %s lane re-admission failed (%s); per-job path",
                    job_id, submit_exc)
        return None
    log.warning("job %s re-admitted to a fresh lane after condemnation%s",
                job_id, (f", resuming at step {resume.get('step')}"
                         if isinstance(resume, dict)
                         else " (no checkpoint: restarting at step 0)"))
    return retry


def _collect_lanes(tickets, slot, registry,
                   traced=lambda i: contextlib.nullcontext()) -> dict:
    """Collect lane tickets ``(i, formatted, ticket)`` in order -> {i: result
    or None (the per-job path)}. Jobs whose lane the watchdog condemned are
    re-admitted once, together and in order, after the loop: by then every
    ticket's rows have left their lanes, so the condemned jobs share a fresh
    lane in the slots and at the width they held (a lane row's bits depend
    on both). A second hang takes the per-job path."""
    results: dict[int, dict | None] = {}
    hung = []
    for i, formatted, ticket in tickets:
        with traced(i):
            results[i] = _stepper_collect(formatted[0], formatted[1], slot,
                                          ticket)
        if results[i] is None and isinstance(ticket.future.exception(),
                                             LaneHung):
            hung.append((i, formatted, ticket))
    retries = []
    for i, formatted, ticket in hung:
        with traced(i):
            retries.append(_stepper_resubmit(
                formatted[0], slot, registry, formatted[3], ticket,
                ticket.future.exception()))
    for (i, formatted, _), retry in zip(hung, retries):
        if retry is not None:
            with traced(i):
                results[i] = _stepper_collect(formatted[0], formatted[1],
                                              slot, retry)
    return results


def synchronous_do_work(job: dict[str, Any], slot, registry) -> dict[str, Any]:
    log.info("processing job %s", job.get("id"))
    # the job's span tree follows it into this thread: the format, encode,
    # step, decode and artifacts spans below attach under the worker's
    # open "execute" phase (obs/trace.py); the checkpoint scope binds the
    # worker's spool for the solo path's phase markers
    with obs_trace.activate(obs_trace.job_trace(job)), \
            checkpoint_scope(getattr(slot, "_checkpoint_spool", None),
                             job.get("id")):
        formatted, fatal = _format(job, registry)
        if formatted is None:
            return fatal
        ticket = _stepper_submit(*formatted, slot, registry)
        if ticket is not None:
            result = _collect_lanes([(0, formatted, ticket)], slot,
                                    registry)[0]
            if result is not None:
                return result
        return _execute(*formatted, slot)


def job_rows(job_or_kwargs: dict[str, Any]) -> int:
    """Batch rows one job contributes (``num_images_per_prompt``; a bad
    value surfaces per job downstream, not here). The worker's burst
    drain reads it."""
    try:
        return max(1, int(job_or_kwargs.get("num_images_per_prompt") or 1))
    except (TypeError, ValueError):
        return 1


def single_chip_rows(kwargs: dict[str, Any]) -> int:
    """How many batch rows ONE device profitably carries for this job class:
    a copy of the JAX package's rule, measured there on a TPU (512 px-class
    programs gain up to batch 4, 1024 px-class are saturated at batch 1).
    The lanes' width policy reads it; the H100's own sweep is in
    ``PERF.md``."""
    try:
        h, w = int(kwargs.get("height") or 0), int(kwargs.get("width") or 0)
    except (TypeError, ValueError):
        return 1
    if not (h and w):
        image = kwargs.get("image")
        if image is not None and getattr(image, "ndim", 0) >= 2:
            h, w = int(image.shape[0]), int(image.shape[1])
    return 4 if 0 < h * w <= 512 * 512 else 1


def rows_cap(rows_max: int, data_width: int, per_device_rows: int = 1) -> int:
    """Max total rows a burst may carry:
    dp * max(ceil(rows_max/dp), per_device_rows): per device, the larger of
    the heaviest member's own solo footprint and the profitable batch,
    never their product."""
    dw = max(1, int(data_width))
    return dw * max(-(-rows_max // dw), max(1, int(per_device_rows)))


def _coalesce_key(kwargs: dict[str, Any]) -> tuple:
    """The group of a formatted diffusion job: its model, the fetched image
    and mask shapes (an image job may carry no height/width; masks of
    another size would not stack) and the ``COALESCE_KEYS`` values."""
    import numpy as np

    from chiaswarm_tpu_torch.workloads.diffusion import COALESCE_KEYS

    image = kwargs.get("image")
    mask = kwargs.get("mask_image")
    return ((kwargs.get("model_name"),
             None if image is None else tuple(np.asarray(image).shape),
             None if mask is None else tuple(np.asarray(mask).shape))
            + tuple(repr(kwargs.get(k)) for k in COALESCE_KEYS))


def _row_chunks(group: list, data_width: int) -> list[list]:
    """Split a compatible group (items ``(i, job_id, content_type,
    kwargs)``) so no batched program carries more rows per device than its
    heaviest member's solo run or the profitable batch (:func:`rows_cap`):
    greedy, in order."""
    chunks: list[list] = []
    cur: list = []
    cur_rows = cur_max = 0
    per_device = single_chip_rows(group[0][3]) if group else 1
    for item in group:
        rows = job_rows(item[3])
        if cur and cur_rows + rows > rows_cap(max(cur_max, rows),
                                              data_width, per_device):
            chunks.append(cur)
            cur, cur_rows, cur_max = [], 0, 0
        cur.append(item)
        cur_rows += rows
        cur_max = max(cur_max, rows)
    if cur:
        chunks.append(cur)
    return chunks


def _run_group(group: list, slot, registry, results: list,
               singles: list, jobs: list[dict[str, Any]]) -> None:
    """One coalesced program for ``group`` (items ``(i, job_id,
    content_type, kwargs)``): each member's result lands in ``results``; on
    a failure, or a wrong count of results, every member goes to
    ``singles`` (JAX :521-577)."""
    from chiaswarm_tpu_torch.core.rng import draw_seed
    from chiaswarm_tpu_torch.workloads.diffusion import (
        COALESCE_KEYS,
        diffusion_callback,
        diffusion_coalesced_callback,
    )

    kwargs0 = group[0][3]
    shared = {k: kwargs0.get(k) for k in COALESCE_KEYS}
    per_job = []
    for _, _, _, kwargs in group:
        seed = kwargs.get("seed")  # 0 is a valid pinned seed
        per_job.append({
            "prompt": kwargs.get("prompt"),
            "negative_prompt": kwargs.get("negative_prompt"),
            "num_images_per_prompt": kwargs.get("num_images_per_prompt", 1),
            "seed": draw_seed() if seed is None else int(seed),
            "image": kwargs.get("image"),
            "mask_image": kwargs.get("mask_image"),
            # the solo callback's default, not the error payload's jpeg
            "content_type": kwargs.get("content_type", "image/png"),
        })
    ids = [job_id for _, job_id, _, _ in group]
    spans = []
    for i, _, _, _ in group:
        trace = obs_trace.job_trace(jobs[i])
        if trace is not None:
            spans.append(trace.tail().child("coalesced", jobs=len(group)))
    try:
        with job_profile(f"coalesced-{ids[0]}",
                         device=getattr(slot, "device", None)):
            outs = slot.call_multi(
                diffusion_coalesced_callback,
                model_name=kwargs0.get("model_name"),
                seed=per_job[0]["seed"], registry=registry, jobs=per_job,
                **shared)
        if len(outs) != len(group):  # never drop a job silently
            raise RuntimeError(f"coalesced callback returned {len(outs)} "
                               f"results for {len(group)} jobs")
        log.info("coalesced %d jobs onto one program: %s", len(group), ids)
        for (i, job_id, _, _), (artifacts, config) in zip(group, outs):
            results[i] = _result(job_id, artifacts, config)
    except Exception as exc:
        log.warning("coalesced run %s failed (%s); falling back to per-job "
                    "execution", ids, exc)
        singles.extend((i, (job_id, content_type, diffusion_callback, kwargs))
                       for i, job_id, content_type, kwargs in group)
    finally:
        for group_span in spans:
            group_span.end()


def synchronous_do_work_batch(jobs: list[dict[str, Any]], slot,
                              registry) -> list[dict]:
    """Run a burst of jobs: every lane-eligible job is submitted first, so
    their rows share the lanes' steps; compatible diffusion jobs of the rest
    run as coalesced groups (the module docstring); then the singles, and
    lane jobs the lane failed, one at a time through the per-job path.
    Results keep the jobs' order."""
    from chiaswarm_tpu_torch.workloads.diffusion import (
        coalescable,
        diffusion_callback,
    )

    if len(jobs) == 1:
        return [synchronous_do_work(jobs[0], slot, registry)]
    results: list[dict | None] = [None] * len(jobs)
    singles: list[tuple[int, tuple]] = []
    tickets: list[tuple[int, tuple, Any]] = []
    groups: dict[tuple, list[tuple[int, Any, str, dict]]] = {}

    def traced(i: int):
        return obs_trace.activate(obs_trace.job_trace(jobs[i]))

    for i, job in enumerate(jobs):
        log.info("processing job %s (burst of %d)", job.get("id"), len(jobs))
        with traced(i):
            formatted, fatal = _format(job, registry)
            if formatted is None:
                results[i] = fatal
                continue
            ticket = _stepper_submit(*formatted, slot, registry)
        if ticket is not None:
            tickets.append((i, formatted, ticket))
        elif formatted[2] is diffusion_callback and coalescable(formatted[3]):
            job_id, content_type, _, kwargs = formatted
            groups.setdefault(_coalesce_key(kwargs), []).append(
                (i, job_id, content_type, kwargs))
        else:
            singles.append((i, formatted))
    data_width = max(1, int(getattr(slot, "data_width", 1)))
    for whole in groups.values():
        for group in _row_chunks(whole, data_width):
            if len(group) == 1:
                i, job_id, content_type, kwargs = group[0]
                singles.append((i, (job_id, content_type, diffusion_callback,
                                    kwargs)))
            else:
                _run_group(group, slot, registry, results, singles, jobs)
    collected = _collect_lanes(tickets, slot, registry, traced)
    for i, formatted, _ in tickets:
        if collected[i] is not None:
            results[i] = collected[i]
        else:
            singles.append((i, formatted))
    for i, formatted in singles:
        with traced(i), checkpoint_scope(
                getattr(slot, "_checkpoint_spool", None), formatted[0]):
            results[i] = _execute(*formatted, slot)
    return [r for r in results if r is not None]
