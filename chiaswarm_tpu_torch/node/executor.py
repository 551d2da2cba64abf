"""Job executor: counterpart of ``chiaswarm_tpu/node/executor.py``
(``_error_payload``/``_result``/``error_result``/``_format``/``_execute``
:62-212, ``_stepper_submit``/``_stepper_collect`` :215-310,
``synchronous_do_work`` :346-367, ``job_rows`` :386, ``single_chip_rows``
:397-416, ``rows_cap`` :418, ``synchronous_do_work_batch`` :458-593, and
the async ``do_work``/``do_work_batch`` :47-59, which the worker awaits:
each runs its synchronous twin on a thread of the event loop's default
executor).

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
down the solo path. Coalesced bursts and the lane-rebuild rung of the hang
watchdog are later slices (``ROADMAP.md``).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from chiaswarm_tpu_torch import WORKER_VERSION
from chiaswarm_tpu_torch.node.job_args import format_args
from chiaswarm_tpu_torch.node.output_processor import (
    encode_image,
    image_from_text,
    make_result,
    make_text_result,
)
from chiaswarm_tpu_torch.node.resilience import NONFATAL_KINDS, classify_exception
from chiaswarm_tpu_torch.obs import trace as obs_trace
from chiaswarm_tpu_torch.serving.guard import InvalidOutput

log = logging.getLogger("chiaswarm_torch.executor")

# what a job may carry that is never a job argument: the worker's trace,
# and the trace context and epoch stamp a lease-aware hive adds (the JAX
# package's obs/flight.py::TRACE_CTX_KEY, node/hivelog.py::HIVE_EPOCH_KEY)
_NOT_ARGUMENTS = (obs_trace.TRACE_KEY, "trace_ctx", "hive_epoch")


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


def _execute(job_id, content_type, callback, kwargs, slot) -> dict:
    try:
        artifacts, config = slot(callback, **kwargs)
    except InvalidOutput as exc:
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
    (screened poisoned rows), or None: the job re-runs through the per-job
    path (a lane fault; zero-loss fallback)."""
    from chiaswarm_tpu_torch.serving.stepper import LaneDeadline, get_stepper
    from chiaswarm_tpu_torch.workloads.diffusion import stepper_finish

    job = {"id": job_id, "content_type": content_type}
    try:
        artifacts, config = stepper_finish(ticket)
    except LaneDeadline as exc:
        return error_result(job, exc, kind="timeout")
    except InvalidOutput as exc:
        log.error("job %s retired invalid_output (%s); envelope uploaded "
                  "instead of a poisoned image", job_id, exc)
        return error_result(job, exc, kind="invalid_output")
    except Exception as exc:  # the per-job path re-runs the job
        kind = classify_exception(exc)
        if kind == "oom":
            get_stepper(slot).note_oom()  # rebuild lanes narrower
        log.warning("job %s lane run failed (%s: %s); per-job path",
                    job_id, kind, exc)
        return None
    return _result(job_id, artifacts, config)


def synchronous_do_work(job: dict[str, Any], slot, registry) -> dict[str, Any]:
    log.info("processing job %s", job.get("id"))
    # the job's span tree follows it into this thread: the format, encode,
    # step, decode and artifacts spans below attach under the worker's
    # open "execute" phase (obs/trace.py)
    with obs_trace.activate(obs_trace.job_trace(job)):
        formatted, fatal = _format(job, registry)
        if formatted is None:
            return fatal
        job_id, content_type, _, _ = formatted
        ticket = _stepper_submit(*formatted, slot, registry)
        if ticket is not None:
            result = _stepper_collect(job_id, content_type, slot, ticket)
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


def synchronous_do_work_batch(jobs: list[dict[str, Any]], slot,
                              registry) -> list[dict]:
    """Run a burst of jobs: every lane-eligible job is submitted first, so
    their rows share the lanes' steps, then the rest run one at a time
    through the per-job path, as do lane jobs the lane fails. Results keep
    the jobs' order. Coalescing the ineligible residue into one batched
    program is a later slice (``ROADMAP.md``)."""
    if len(jobs) == 1:
        return [synchronous_do_work(jobs[0], slot, registry)]
    results: list[dict | None] = [None] * len(jobs)
    singles: list[tuple[int, tuple]] = []
    tickets: list[tuple[int, tuple, Any]] = []
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
        else:
            singles.append((i, formatted))
    for i, formatted, ticket in tickets:
        with traced(i):
            result = _stepper_collect(formatted[0], formatted[1], slot,
                                      ticket)
        if result is not None:
            results[i] = result
        else:
            singles.append((i, formatted))
    for i, formatted in singles:
        with traced(i):
            results[i] = _execute(*formatted, slot)
    return [r for r in results if r is not None]
