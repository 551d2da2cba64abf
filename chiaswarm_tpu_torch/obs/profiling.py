"""Profiler hooks: device traces on demand, named regions. The counterpart of
``chiaswarm_tpu/obs/profiling.py`` (``annotate``, ``capture``,
``job_profile``), over ``torch.profiler`` where the JAX module wraps
``jax.profiler``:

- :func:`annotate`: a ``torch.profiler.record_function`` region naming the
  serving hot paths at JAX's three points (``swarm.lane.step``,
  ``swarm.lane.decode``, ``swarm.generate``), so a timeline reads in serving
  vocabulary; free outside a recording profiler, and it never fails the work
  it wraps;
- :func:`capture`: a duration-bounded capture of CPU and CUDA activity
  behind the worker's ``/debug/profile?seconds=N``, written as a Chrome
  trace (``trace.json``, Perfetto-loadable) under :data:`PROFILE_DIR_ENV` or
  an explicit directory;
- :func:`job_profile`: the executor's per-job opt-in, when
  :data:`PROFILE_DIR_ENV` is set;
- :func:`profile`: ``torch.profiler.profile`` under the same lock, for tools
  that profile in the worker's process (``tools/torch_serve_profile.py``).

The profiler is process-global, so one lock (:data:`_CAPTURE_LOCK`) covers
all of them: a second capture answers ``"busy"``, a job that finds the
profiler held runs unprofiled, never crashed.

A capture on a CUDA device records CUDA activity, and reports an error when
the profiler offers none or the window recorded no device event: a device
trace without the device is no trace. Only a caller that asks for the CPU
(``device="cpu"``, as the CPU tests' workers do) gets a CPU-only capture.
``torch`` is imported inside the functions.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Iterator

log = logging.getLogger("chiaswarm_torch.obs.profiling")

#: directory on-demand captures (and the executor's per-job traces) write
#: under; ``/debug/profile`` falls back to it when the request names none
PROFILE_DIR_ENV = "CHIASWARM_PROFILE_DIR"

#: ceiling for ``/debug/profile?seconds=N``: a forgotten capture must not
#: trace (and slow) the worker for long
MAX_CAPTURE_S = 120.0

#: Chrome-trace categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_CAPTURE_LOCK = threading.Lock()
_CAPTURES = itertools.count(1)


class ProfilerBusy(RuntimeError):
    """Another capture holds the process-global profiler."""


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region inside a recording profiler's timeline."""
    try:
        import torch

        region = torch.profiler.record_function(name)
        region.__enter__()
    except Exception:  # profiling must never fail the work it observes
        region = None
    try:
        yield
    finally:
        if region is not None:
            try:
                region.__exit__(None, None, None)
            except Exception:
                pass


def default_profile_dir() -> str:
    return os.environ.get(PROFILE_DIR_ENV, "").strip()


def _device_type(device: Any) -> str:
    """``"cuda"`` or ``"cpu"``: the device the caller names, else the card
    when one is present."""
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def activities_for(device: Any = None) -> list:
    """The profiler activities a capture on ``device`` records: CPU and CUDA
    on a card (raises when CUDA activity is unavailable), CPU alone when the
    caller asked for the CPU."""
    import torch
    from torch.profiler import ProfilerActivity

    kind = _device_type(device)
    if kind == "cpu":
        return [ProfilerActivity.CPU]
    if kind != "cuda":
        raise RuntimeError(f"no profiler activity for device {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA capture was asked for, but no CUDA card "
                           "is available")
    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError("torch.profiler offers no CUDA activity in this "
                           "process (CUPTI unavailable)")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def trace_summary(path: str) -> dict[str, Any]:
    """Device events and distinct kernel names of a Chrome trace written by
    ``export_chrome_trace``."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    device = [e for e in events
              if isinstance(e, dict) and e.get("cat") in DEVICE_CATEGORIES]
    kernels = sorted({str(e.get("name")) for e in device
                      if e.get("cat") == "kernel"})
    return {"events": len(events), "device_events": len(device),
            "kernels": kernels}


@contextlib.contextmanager
def exclusive() -> Iterator[None]:
    """Hold the process-global profiler lock, or raise :class:`ProfilerBusy`
    at once."""
    if not _CAPTURE_LOCK.acquire(blocking=False):
        raise ProfilerBusy("another profiler capture is already running "
                           "(the profiler is process-global)")
    try:
        yield
    finally:
        _CAPTURE_LOCK.release()


@contextlib.contextmanager
def profile(**kwargs: Any):
    """``torch.profiler.profile(**kwargs)`` under the process-global lock:
    raises :class:`ProfilerBusy` while a capture or a profiled job holds
    it."""
    import torch

    with exclusive(), torch.profiler.profile(**kwargs) as prof:
        yield prof


def capture(seconds: float, out: str | None = None,
            device: Any = None) -> dict[str, Any]:
    """Record ``seconds`` of profiler activity (blocking; the worker runs it
    in a thread) and write it as ``<out>/capture-<time>-<pid>-<n>/trace.json``.

    Returns ``{"status": "ok", "dir", "trace", "seconds", "activities",
    "events", "device_events", "kernels"}``, or ``{"status": "busy"}`` while
    another capture runs, or ``{"status": "error", "error"}``: no directory,
    no CUDA activity on a card, no device event recorded on a card, or a
    failed export. Raises nothing: this backs an HTTP endpoint."""
    seconds = max(0.1, min(float(seconds), MAX_CAPTURE_S))
    out = out or default_profile_dir()
    if not out:
        return {"status": "error",
                "error": f"no capture directory: set {PROFILE_DIR_ENV} "
                         f"or pass ?dir="}
    try:
        kind = _device_type(device)
        activities = activities_for(kind)
    except Exception as exc:
        return {"status": "error", "error": str(exc)}
    try:
        with exclusive():
            import torch

            target = os.path.join(out, time.strftime(
                "capture-%Y%m%d-%H%M%S") + f"-{os.getpid()}-{next(_CAPTURES)}")
            os.makedirs(target, exist_ok=True)
            path = os.path.join(target, "trace.json")
            with torch.profiler.profile(activities=activities) as prof:
                time.sleep(seconds)
                if kind == "cuda":
                    torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            summary = trace_summary(path)
    except ProfilerBusy as exc:
        return {"status": "busy", "error": str(exc)}
    except Exception as exc:
        log.warning("profiler capture failed: %s", exc)
        return {"status": "error", "error": f"{type(exc).__name__}: {exc}"}
    result = {"status": "ok", "dir": target, "trace": path,
              "seconds": seconds,
              "activities": [a.name for a in activities], **summary}
    if kind == "cuda" and not summary["device_events"]:
        return dict(result, status="error",
                    error="the capture recorded no CUDA activity")
    log.info("profiler capture (%.1fs, %d device events) written to %s",
             seconds, summary["device_events"], target)
    return result


@contextlib.contextmanager
def job_profile(job_id: Any, profile_dir: str | None = None,
                device: Any = None) -> Iterator[bool]:
    """The executor's per-job trace when :data:`PROFILE_DIR_ENV` is set:
    ``<dir>/<job id>/trace.json``. Yields True while a trace records; a
    profiler held elsewhere, or one that cannot start, leaves the job
    unprofiled."""
    profile_dir = (default_profile_dir() if profile_dir is None
                   else profile_dir)
    if not profile_dir:
        yield False
        return
    if not _CAPTURE_LOCK.acquire(blocking=False):
        log.info("job %s not profiled: profiler busy", job_id)
        yield False
        return
    try:
        try:
            import torch

            target = os.path.join(profile_dir, str(job_id or "job"))
            os.makedirs(target, exist_ok=True)
            prof = torch.profiler.profile(activities=activities_for(device))
            prof.__enter__()
        except Exception as exc:
            log.warning("job %s profile failed to start (%s); the job runs "
                        "unprofiled", job_id, exc)
            yield False
            return
        try:
            yield True
        finally:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(target, "trace.json"))
                log.info("job %s profile written to %s", job_id, target)
            except Exception as exc:
                log.warning("job %s profile failed to finish (%s)", job_id,
                            exc)
    finally:
        _CAPTURE_LOCK.release()
