"""The numerics flight recorder: named probes on the tensors of the serving
path. A copy of ``chiaswarm_tpu/obs/numerics.py`` (enablement,
``NumericsRing``, ``TapRegistry``, ``tap``, ``record_host``, ``flush``,
``dump``, ``load_dump``, ``debug_payload``) for eager PyTorch.

- :func:`tap` returns its argument untouched, before touching it, unless
  ``CHIASWARM_NUMERICS`` enables the probe: with the variable unset no
  torch operation runs, so a job's bytes and its kernel launches are those
  of an untapped run. With the probe on, a handful of reductions on the
  tensor's own device (l2 norm, mean, absmax, non-finite count and a
  bitwise checksum, non-finites zeroed out of the moments) give one small
  float64 tensor, which is queued with its probe, step, shard and note.
  Nothing syncs the card per tap: the queue is copied to the host in one
  transfer per device when the ring is read (:meth:`NumericsRing.snapshot`,
  ``drain``, ``stats``, :func:`flush`) and at the lanes' checkpoint
  boundary, where the lane already waits for the card. A queue longer than
  the ring drops its oldest entries, counted as evicted.
- Probes carry a ``step`` (a loop index, or the per-call-site index of
  ``attn.*``) and a ``shard`` (a ring shard, a lane slot; -1 for a global
  value), so two runs align record for record.
- :func:`record_host` summarizes a tensor or array that is already on the
  host with the same math, so host and device streams compare directly.
- The checksum is the wrap-around uint32 sum of the float32 bit patterns,
  taken as the int32 view summed in int64 and masked with ``0xFFFFFFFF``:
  equal float32 content gives JAX's value, whatever the layout.

Enablement, read at each call:

- ``CHIASWARM_NUMERICS`` unset, empty, ``0``, ``off``, ``false``, ``no`` or
  ``none`` -> every tap is the identity (the default)
- ``CHIASWARM_NUMERICS=1`` (``true``, ``on``, ``all``) -> every probe
- ``CHIASWARM_NUMERICS=diffusion,ring_flash`` -> probes whose name starts
  with one of the comma-separated prefixes (and, both ways, family guards a
  token extends: ``attn.q`` opens the ``attn`` call site, which then records
  ``attn.q`` alone)
- ``CHIASWARM_NUMERICS_RING`` -> the ring's capacity (default 8192)

JAX counts ``traced_probes`` at trace time, once per compiled program; the
port has no trace, so :meth:`TapRegistry.traced_probes` counts the tap
calls that queued a summary, per probe, since the process started. The
ring is served at ``/debug/numerics`` (``node/worker.py``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Iterable

ENV_ENABLE = "CHIASWARM_NUMERICS"
ENV_RING = "CHIASWARM_NUMERICS_RING"

_DEFAULT_CAPACITY = 8192

#: the summary fields every record carries, in comparison order
SUMMARY_FIELDS = ("l2", "mean", "absmax", "nonfinite", "checksum")

#: values that mean OFF
_OFF_VALUES = frozenset({"", "0", "off", "false", "no", "none"})


def _raw() -> str:
    raw = os.environ.get(ENV_ENABLE, "").strip()
    return "" if raw.lower() in _OFF_VALUES else raw


def enabled() -> bool:
    """True when ANY probe is enabled."""
    return bool(_raw())


def fingerprint() -> str:
    """The raw enablement value (empty when off)."""
    return _raw()


def enabled_for(probe: str) -> bool:
    """The bidirectional prefix filter: token ``attn`` enables ``attn.q``,
    and token ``attn.q`` also opens the family guard
    ``enabled_for("attn")``."""
    raw = _raw()
    if not raw:
        return False
    if raw.lower() in ("1", "true", "on", "all"):
        return True
    return any(probe.startswith(tok) or tok.startswith(probe)
               for tok in (t.strip() for t in raw.split(",")) if tok)


def summarize(value: Any):
    """-> (float64 tensor [l2, mean, absmax, nonfinite, checksum] on the
    value's device, element count). Moments over the float32 view with
    non-finites zeroed, summed in float64."""
    import numpy as np
    import torch

    x = value.detach() if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.array(value))
    size = int(x.numel())
    xf = x.float()
    finite = torch.isfinite(xf)
    xz = torch.where(finite, xf, torch.zeros((), dtype=torch.float32,
                                             device=xf.device))
    xd = xz.double()
    zero = torch.zeros((), dtype=torch.float64, device=xf.device)
    absmax = xz.abs().amax().double() if size else zero
    checksum = (xz.view(torch.int32).sum(dtype=torch.int64)
                & 0xFFFFFFFF).double()
    summary = torch.stack([
        torch.sqrt((xd * xd).sum()), xd.sum() / max(size, 1), absmax,
        (~finite).sum().double(), checksum])
    return summary, size


class NumericsRing:
    """Bounded ring of per-probe summary records (oldest evicted), with the
    queue of summaries still on a device. Thread-safe: lanes, the solo
    executor and the health server's reads meet here. Each record is a
    plain dict."""

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is None:
            try:
                capacity = int(os.environ.get(ENV_RING, "") or
                               _DEFAULT_CAPACITY)
            except ValueError:
                capacity = _DEFAULT_CAPACITY
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        # held across a whole materialization, so records keep queue order
        self._flush_lock = threading.Lock()
        self._records: collections.deque[dict] = collections.deque(
            maxlen=self.capacity)
        self._pending: collections.deque[tuple[dict, Any]] = \
            collections.deque()
        self._seq = 0
        self.total = 0      # records ever appended (or queued)
        self.evicted = 0    # records pushed out by the bound

    def _append_locked(self, rec: dict) -> dict:
        rec["seq"] = self._seq
        self._seq += 1
        if len(self._records) == self.capacity:
            self.evicted += 1
        self._records.append(rec)
        return rec

    def record(self, probe: str, *, step: int = -1, shard: int = -1,
               l2: float = 0.0, mean: float = 0.0, absmax: float = 0.0,
               nonfinite: int = 0, checksum: int = 0, size: int = 0,
               note: str | None = None) -> dict:
        rec = {
            "probe": str(probe), "step": int(step), "shard": int(shard),
            "l2": float(l2), "mean": float(mean), "absmax": float(absmax),
            "nonfinite": int(nonfinite), "checksum": int(checksum),
            "size": int(size), "t": time.time(),
        }
        if note is not None:
            rec["note"] = str(note)
        self.materialize()  # queued records come first
        with self._lock:
            self.total += 1
            return self._append_locked(rec)

    def defer(self, meta: dict, summary: Any) -> None:
        """Queue one summary tensor (still on its device) with its record's
        other fields; past ``capacity`` queued, the oldest is dropped and
        counted as evicted."""
        with self._lock:
            self.total += 1
            self._pending.append((meta, summary))
            if len(self._pending) > self.capacity:
                self._pending.popleft()
                self.evicted += 1

    def materialize(self) -> int:
        """Copy the queued summaries to the host (one transfer per device)
        and append their records in queue order. Returns how many."""
        with self._flush_lock:
            with self._lock:
                pending = list(self._pending)
                self._pending.clear()
            if not pending:
                return 0
            import torch

            by_device: dict[Any, list[int]] = {}
            for i, (_, summary) in enumerate(pending):
                by_device.setdefault(summary.device, []).append(i)
            values: list[list[float] | None] = [None] * len(pending)
            for indices in by_device.values():
                host = torch.stack([pending[i][1] for i in indices]).cpu()
                for i, row in zip(indices, host.tolist()):
                    values[i] = row
            with self._lock:
                for (meta, _), row in zip(pending, values):
                    rec = dict(meta)
                    rec.update(l2=float(row[0]), mean=float(row[1]),
                               absmax=float(row[2]),
                               nonfinite=int(row[3]), checksum=int(row[4]))
                    self._append_locked(rec)
            return len(pending)

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def snapshot(self, probe_prefix: str | None = None,
                 limit: int | None = None) -> list[dict]:
        self.materialize()
        with self._lock:
            records = list(self._records)
        if probe_prefix:
            records = [r for r in records
                       if r["probe"].startswith(probe_prefix)]
        if limit is not None and limit >= 0:
            # records[-0:] is the WHOLE list: limit=0 means none
            records = records[-limit:] if limit else []
        return records

    def drain(self) -> list[dict]:
        """Snapshot AND clear (a run's capture)."""
        self.materialize()
        with self._lock:
            records = list(self._records)
            self._records.clear()
        return records

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._pending.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records) + len(self._pending)

    def stats(self) -> dict[str, int]:
        self.materialize()
        with self._lock:
            return {"capacity": self.capacity, "depth": len(self._records),
                    "total": self.total, "evicted": self.evicted}


class TapRegistry:
    """Named probe points and the ring their summaries land in."""

    def __init__(self, ring: NumericsRing | None = None) -> None:
        self.ring = ring if ring is not None else NumericsRing()
        self._lock = threading.Lock()
        self._traced: dict[str, int] = {}
        self._trace_seq: dict[str, int] = {}

    # -- bookkeeping -------------------------------------------------------

    def note_traced(self, probe: str) -> None:
        with self._lock:
            self._traced[probe] = self._traced.get(probe, 0) + 1

    def traced_probes(self) -> dict[str, int]:
        """Tap calls that queued a summary, per probe (JAX counts traces)."""
        with self._lock:
            return dict(self._traced)

    def trace_seq(self, name: str) -> int:
        """The next call-site index of counter ``name`` (``attn``: one per
        attention call). JAX takes it at trace time, so each run of a
        compiled program records 0..N-1; the port takes it per call, and
        resets it where one JAX program run begins (the solo generate, one
        lane step, one decode, one encode) and rewinds it at each step of
        the solo loop, whose body JAX traces once."""
        with self._lock:
            n = self._trace_seq.get(name, 0)
            self._trace_seq[name] = n + 1
            return n

    def peek_trace_seq(self, name: str) -> int:
        with self._lock:
            return self._trace_seq.get(name, 0)

    def rewind_trace_seq(self, name: str, value: int) -> None:
        with self._lock:
            self._trace_seq[name] = int(value)

    def reset_trace_seq(self) -> None:
        with self._lock:
            self._trace_seq.clear()

    # -- the device tap ----------------------------------------------------

    def tap(self, probe: str, value: Any, *, step: Any = None,
            shard: Any = None, note: str | None = None) -> Any:
        """Queue a summary of ``value`` (a tensor) and return ``value``
        unchanged; the identity, touching nothing, unless ``probe`` is
        enabled."""
        if not enabled_for(probe):
            return value
        self.note_traced(probe)
        summary, size = summarize(value)
        meta = {"probe": str(probe),
                "step": -1 if step is None else int(step),
                "shard": -1 if shard is None else int(shard),
                "size": size, "t": time.time()}
        if note is not None:
            meta["note"] = str(note)
        self.ring.defer(meta, summary)
        return value

    # -- the host-side twin ------------------------------------------------

    def record_host(self, probe: str, array: Any, *, step: int = -1,
                    shard: int = -1, note: str | None = None) -> dict | None:
        """Summarize a host tensor or array with the tap's math and record
        it now."""
        if not enabled_for(probe):
            return None
        summary, size = summarize(array)
        l2, mean, absmax, nonfinite, checksum = summary.cpu().tolist()
        return self.ring.record(
            probe, step=step, shard=shard, l2=l2, mean=mean, absmax=absmax,
            nonfinite=int(nonfinite), checksum=int(checksum), size=size,
            note=note)


#: the process-wide recorder: the serving taps and /debug/numerics share it
RING = NumericsRing()
TAPS = TapRegistry(RING)


def tap(probe: str, value: Any, *, step: Any = None, shard: Any = None,
        note: str | None = None) -> Any:
    """:meth:`TapRegistry.tap` on the global :data:`TAPS`."""
    return TAPS.tap(probe, value, step=step, shard=shard, note=note)


def record_host(probe: str, array: Any, *, step: int = -1, shard: int = -1,
                note: str | None = None) -> dict | None:
    return TAPS.record_host(probe, array, step=step, shard=shard, note=note)


def begin_program() -> bool:
    """Where one JAX program run begins (the solo generate, a lane step, a
    decode, an encode): the ``attn`` call-site index restarts at 0 while
    its probes are on. Returns whether they are."""
    if not enabled_for("attn"):
        return False
    TAPS.reset_trace_seq()
    return True


def flush() -> None:
    """Bring every queued summary into the ring (JAX's barrier for its
    unordered callbacks)."""
    RING.materialize()


def dump(path: str, records: Iterable[dict] | None = None) -> int:
    """Write records (default: the live ring) to a JSONL run file; returns
    the record count."""
    records = list(RING.snapshot() if records is None else records)
    with open(path, "w", encoding="utf-8") as fh:
        for rec in records:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return len(records)


def load_dump(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def debug_payload(probe_prefix: str | None = None,
                  limit: int | None = None) -> dict:
    """The ``/debug/numerics`` body: enablement, ring stats, the per-probe
    tap census and the (filtered) records."""
    return {
        "enabled": enabled(),
        "filter": fingerprint(),
        "ring": RING.stats(),
        "traced_probes": TAPS.traced_probes(),
        "records": RING.snapshot(probe_prefix, limit),
    }
