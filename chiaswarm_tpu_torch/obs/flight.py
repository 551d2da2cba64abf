"""The worker half of the cross-worker flight record: a trimmed copy of
``chiaswarm_tpu/obs/flight.py`` (``TRACE_CTX_KEY``, ``SPAN_DIGEST_KEY``,
``MAX_DIGEST_SPANS``, ``_small_meta`` and ``span_digest``, :68-167).

- **Trace context**: a hive that keeps flight records stamps
  :data:`TRACE_CTX_KEY` (``{"trace_id", "span_id", "attempt"}``) on every
  grant. The worker pops it at poll receipt and joins it: the job's
  ``JobTrace`` carries ``trace_id``/``span_id`` in its root meta, so its
  spans become that attempt's children. With no context the trace starts
  locally and nothing changes on the wire.
- **Span digest**: the upload of a job that carried a context takes a
  compact :func:`span_digest` of the worker's span tree under
  :data:`SPAN_DIGEST_KEY`, built at upload start (before any spool, so a
  replayed envelope keeps it). The hive pops it into its flight record and
  splits the worker's time into phases by span name (JAX
  ``obs/flight.py::_digest_phase_split``): the ``poll`` phase and the
  ``format`` and ``encode`` spans are admission, ``step`` spans (less their
  ``splice_wait_s``) are steps, ``decode`` spans are decode. The port's
  executor, lanes and pipelines name their spans so.

The hive half (``FlightRecorder``, ``RateEwma``, ``budget_attribution`` and
the renderers) belongs to the hive and is not ported.
"""

from __future__ import annotations

from typing import Any

#: wire field a hive stamps on every granted job: ``{"trace_id": str,
#: "span_id": str, "attempt": int}``. Popped at poll receipt; never a job
#: argument
TRACE_CTX_KEY = "trace_ctx"

#: result-envelope field carrying the worker's span digest, attached only
#: when the job carried a trace context
SPAN_DIGEST_KEY = "span_digest"

#: per-digest span cap (the digest is a summary, not the whole tree)
MAX_DIGEST_SPANS = 64


def _small_meta(meta: dict[str, Any]) -> dict[str, Any]:
    """JSON-safe scalar subset of a span's metadata (digests cross the
    wire; tensors and long strings must not)."""
    out: dict[str, Any] = {}
    for key, value in meta.items():
        if isinstance(value, bool) or isinstance(value, (int, float)):
            out[key] = value
        elif isinstance(value, str) and len(value) <= 200:
            out[key] = value
    return out


def span_digest(trace: Any, worker_name: str = "") -> dict[str, Any]:
    """Compact summary of one ``JobTrace`` for the result envelope: the
    top-level phases and the spans below them (breadth first, at most
    :data:`MAX_DIGEST_SPANS`), as offsets from the root's start on this
    worker's ``perf_counter`` clock. ``duration_s`` covers poll receipt to
    upload start."""
    root = trace.root
    meta = root.meta
    phases: list[dict[str, Any]] = []
    spans: list[dict[str, Any]] = []
    truncated = False
    for phase in root.children:
        phases.append({
            "name": phase.name,
            "t0_s": round(phase.t0 - root.t0, 6),
            "dur_s": round(phase.duration_s, 6),
        })
        queue: list[tuple[Any, str]] = [(child, phase.name)
                                        for child in phase.children]
        while queue:
            node, phase_name = queue.pop(0)
            if len(spans) >= MAX_DIGEST_SPANS:
                truncated = True
                break
            entry: dict[str, Any] = {
                "name": node.name,
                "phase": phase_name,
                "t0_s": round(node.t0 - root.t0, 6),
                "dur_s": round(node.duration_s, 6),
            }
            small = _small_meta(node.meta)
            if small:
                entry["meta"] = small
            spans.append(entry)
            queue.extend((child, phase_name) for child in node.children)
    digest: dict[str, Any] = {
        "trace_id": str(meta.get("trace_id") or ""),
        "span_id": str(meta.get("span_id") or ""),
        "attempt": int(meta.get("attempt") or 1),
        "worker": str(worker_name or meta.get("worker") or ""),
        "started_at_unix": round(float(trace.started_at_unix), 6),
        "duration_s": round(root.duration_s, 6),
        "phases": phases,
        "spans": spans,
    }
    if truncated:
        digest["spans_truncated"] = True
    for key in ("queued_s", "resume_step"):
        if meta.get(key) is not None:
            try:
                digest[key] = float(meta[key])
            except (TypeError, ValueError):
                pass
    return digest
