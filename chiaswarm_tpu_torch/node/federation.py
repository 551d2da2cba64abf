"""The worker half of a federated hive: :func:`bootstrap_shard_uris`, a
copy of ``chiaswarm_tpu/node/federation.py:749-771``.

A federation splits the job space over several hive shards, each with its
own journal, epoch and leases. The worker dials every shard directly, one
session bundle each (``node/worker.py::_HiveShard``). Its settings either
list the shards (``hive_shard_uris``, or commas in ``hive_uri``) or name
one front (``hive_front_uri``), which the worker resolves at startup with
``GET /api/shards``. The hive side (``ShardHive``, ``FederatedHive``,
``ShardRouter``) is the hive's and is not ported.
"""

from __future__ import annotations


async def bootstrap_shard_uris(front_uri: str, *,
                               timeout_s: float = 10.0
                               ) -> tuple[str, ...]:
    """Resolve a federated front address into the shard uri list through
    ``GET /api/shards``. Raises on an unreachable front or a body with no
    shards: serving a guessed control plane is worse than failing loudly."""
    import aiohttp

    url = front_uri.rstrip("/") + "/api/shards"
    timeout = aiohttp.ClientTimeout(total=max(0.1, float(timeout_s)))
    async with aiohttp.ClientSession(timeout=timeout) as session:
        async with session.get(url) as response:
            response.raise_for_status()
            body = await response.json()
    uris = tuple(str(u) for u in (body.get("shards") or ()) if u)
    if not uris:
        raise RuntimeError(
            f"front {front_uri} returned no shard uris: {body!r}")
    return uris
