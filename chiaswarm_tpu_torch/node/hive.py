"""Hive protocol client, the HTTP control plane to the job queue: a copy of
``chiaswarm_tpu/node/hive.py`` (``HiveClient`` with ``post_heartbeat``
:150-168, ``BadWorkerError`` and the poll-constant re-exports). The wire is the JAX worker's, so a node switched
from one package to the other needs no hive change:

- ``GET  {uri}/api/work``    poll for jobs (``worker_version`` and
  ``worker_name`` as query parameters)
- ``POST {uri}/api/results`` upload artifact envelopes
- ``GET  {uri}/api/models``  model catalog
- ``POST {uri}/api/heartbeat`` lease keep-alive with the in-flight ids and
  their latest checkpoints: not part of the reference wire, called only
  with ``heartbeat_s > 0`` against a lease-aware hive, and any failure is
  tolerated by the worker

Two wire keys beyond the reference's (copies of
``chiaswarm_tpu/node/hivelog.py:65,75``): a journaled hive stamps
:data:`HIVE_EPOCH_KEY` on every grant and its heartbeat acks, and the worker
echoes it on its beats and uploads (a beat claiming an older epoch is
answered ``stale_epoch`` with every claimed job ``lost`` and the current
epoch); a hive shard of a federation stamps :data:`HIVE_SHARD_KEY`, the
owning shard's index, and the worker echoes it on the upload. Neither is
sent to a hive that sent none.

Bearer-token auth and the ``chiaSWARM.worker/<version>`` user agent, with
``WORKER_VERSION`` from ``chiaswarm_tpu_torch/__init__.py``. A 400 from the
work endpoint is the hive flagging this worker: it raises
:class:`BadWorkerError` whatever its body, JSON or not. The client is
``aiohttp``'s, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Any

import aiohttp

from chiaswarm_tpu_torch import WORKER_VERSION
from chiaswarm_tpu_torch.obs.metrics import REGISTRY
from chiaswarm_tpu_torch.obs.trace import span

# the adaptive poll cadence: 1 s after work, 11 s idle, and the 121 s cap
# of the worker's exponential error backoff (node/resilience.py::Backoff)
from chiaswarm_tpu_torch.node.settings import (  # noqa: F401
    POLL_BUSY_S,
    POLL_ERROR_S,
    POLL_IDLE_S,
)

log = logging.getLogger("chiaswarm_torch.hive")

#: the journal generation a journaled hive stamps on grants and acks, and
#: the worker echoes on beats and uploads
HIVE_EPOCH_KEY = "hive_epoch"

#: the owning shard's index a federated hive shard stamps on grants, and
#: the worker echoes on the upload (routing it to that shard)
HIVE_SHARD_KEY = "hive_shard"

# control-plane request accounting (process-global: the HTTP client is
# worker-agnostic; worker-scoped health lives on the worker's registry)
_REQUESTS = REGISTRY.counter(
    "chiaswarm_hive_requests_total",
    "hive API requests by endpoint and coarse result",
    labelnames=("endpoint", "result"))
_REQUEST_SECONDS = REGISTRY.histogram(
    "chiaswarm_hive_request_seconds",
    "hive API request latency",
    labelnames=("endpoint",))


@contextlib.contextmanager
def _observe(endpoint: str):
    """Count and time one hive API request."""
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        _REQUESTS.inc(endpoint=endpoint, result="error")
        raise
    else:
        _REQUESTS.inc(endpoint=endpoint, result="ok")
    finally:
        _REQUEST_SECONDS.observe(time.perf_counter() - t0,
                                 endpoint=endpoint)


class BadWorkerError(RuntimeError):
    """HTTP 400 from the hive: this worker is misbehaving (for example not
    returning results in time)."""


class HiveClient:
    def __init__(self, uri: str, token: str, worker_name: str) -> None:
        self.api = f"{uri.rstrip('/')}/api"
        self.token = token
        self.worker_name = worker_name

    def _headers(self) -> dict[str, str]:
        return {
            "Content-type": "application/json",
            "Authorization": f"Bearer {self.token}",
            "user-agent": f"chiaSWARM.worker/{WORKER_VERSION}",
        }

    async def get_work(self, session: aiohttp.ClientSession) -> list[dict]:
        """Fetch queued jobs; raises on non-200 (the caller backs off)."""
        with _observe("work"):
            async with session.get(
                f"{self.api}/work",
                params={
                    "worker_version": WORKER_VERSION,
                    "worker_name": self.worker_name,
                },
                headers=self._headers(),
                timeout=aiohttp.ClientTimeout(total=10),
            ) as response:
                if response.status == 200:
                    payload = await response.json()
                    return list(payload.get("jobs", []))
                if response.status == 400:
                    # a misbehaving-worker signal stays a BadWorkerError
                    # even with a non-JSON body (a proxy's HTML page)
                    message = "bad worker"
                    try:
                        payload = await response.json(content_type=None)
                        if isinstance(payload, dict):
                            message = str(payload.get("message", message))
                    except Exception:
                        try:
                            body = (await response.text()).strip()
                            if body:
                                message = body[:200]
                        except Exception:
                            pass
                    raise BadWorkerError(message)
                response.raise_for_status()
                return []

    async def post_result(self, session: aiohttp.ClientSession,
                          result: dict[str, Any]) -> dict[str, Any]:
        # the span lands under the job's "upload" phase when the worker
        # delivers with the trace active (node/worker.py::_deliver)
        with _observe("results"), span("upload.http"):
            async with session.post(
                f"{self.api}/results",
                data=json.dumps(result),
                headers=self._headers(),
                timeout=aiohttp.ClientTimeout(total=60),
            ) as response:
                if response.status >= 400:
                    log.error("hive rejected result (%s): %s",
                              response.status, response.reason)
                    response.raise_for_status()
                try:
                    return await response.json()
                except Exception:  # non-JSON 2xx body: the upload landed
                    return {"status": response.status}

    async def post_heartbeat(self, session: aiohttp.ClientSession,
                             payload: dict[str, Any]) -> dict[str, Any]:
        """Lease keep-alive for a lease-aware hive: ``payload`` carries the
        worker name, its in-flight job ids and their latest resume
        checkpoints (``node/worker.py::_heartbeat_loop``)."""
        with _observe("heartbeat"):
            async with session.post(
                f"{self.api}/heartbeat",
                data=json.dumps(payload),
                headers=self._headers(),
                timeout=aiohttp.ClientTimeout(total=10),
            ) as response:
                response.raise_for_status()
                try:
                    return await response.json()
                except Exception:  # non-JSON 2xx: the beat still landed
                    return {"status": response.status}

    async def get_models(self, session: aiohttp.ClientSession) -> list[dict]:
        async with session.get(
            f"{self.api}/models",
            headers=self._headers(),
            timeout=aiohttp.ClientTimeout(total=30),
        ) as response:
            response.raise_for_status()
            payload = await response.json()
            return payload.get("models", payload) if isinstance(payload, dict) \
                else payload
