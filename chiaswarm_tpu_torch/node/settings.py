"""Layered node configuration: a copy of ``chiaswarm_tpu/node/settings.py``
(every field, the env overrides and their precedence, ``deadline_for``,
``hive_uris``, the legacy JSON round trip and the file helpers), so a
``settings.json`` written for the JAX worker loads unchanged.
``tests/test_torch_worker.py`` pins it to the source.

Capability parity with the reference's config system (swarm/settings.py:7-69):
a JSON settings file under a configurable root directory, overridden by
environment variables, with helpers to persist auxiliary files (e.g. the
hive model catalog). Wire-compatible field names and env vars are kept so a
chiaSWARM operator can point this worker at the same hive unchanged.

Precedence (lowest to highest): built-in defaults < settings.json < env vars.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any

# the hive protocol's adaptive poll cadence (the reference's constants,
# swarm/worker.py). They live HERE — the pure-config module — so hive.py
# (which needs aiohttp) can re-export them without config depending on an
# HTTP client: 1 s after work, 11 s idle; 121 s is the reference's flat
# error delay, kept as the CAP of the worker's exponential error backoff
# (node/resilience.py::Backoff).
POLL_BUSY_S = 1
POLL_IDLE_S = 11
POLL_ERROR_S = 121

_ENV_OVERRIDES = {
    # reference env vars (swarm/settings.py:36-38) kept for drop-in parity
    "SDAAS_URI": "hive_uri",
    "SDAAS_TOKEN": "hive_token",
    "SDAAS_WORKERNAME": "worker_name",
    # native names
    "SWARM_TPU_URI": "hive_uri",
    "SWARM_TPU_TOKEN": "hive_token",
    "SWARM_TPU_WORKERNAME": "worker_name",
    "SWARM_TPU_FRONT_URI": "hive_front_uri",
    "SWARM_TPU_LOG_LEVEL": "log_level",
}

_ROOT_ENV_VARS = ("SWARM_TPU_ROOT", "SDAAS_ROOT")


@dataclasses.dataclass
class Settings:
    """Node settings.

    Field names mirror the reference settings file (swarm/settings.py:7-15)
    via ``to_legacy_json``/``from_json`` so existing ``settings.json`` files
    keep working.
    """

    hive_uri: str = "https://chiaswarm.ai"
    # a federated control plane is a LIST of shard
    # uris — explicit here, or packed comma-separated into hive_uri
    # (which keeps single-uri plumbing like the loadgen worker factory
    # working unchanged). Empty = un-federated; hive_uris() resolves.
    hive_shard_uris: tuple = ()
    # ONE federated-front address to
    # bootstrap the shard list from (GET /api/shards) at startup —
    # overrides any stale hand-configured hive_shard_uris. Empty =
    # no bootstrap; the explicit list / hive_uri plumbing is used.
    hive_front_uri: str = ""
    hive_token: str = ""
    worker_name: str = "tpu-worker"
    log_level: str = "INFO"
    log_filename: str = "swarm-tpu.log"
    huggingface_token: str = ""
    # TPU-native additions
    mesh_shape: dict[str, int] | None = None  # e.g. {"data": 8} ; None = auto
    # auto-mesh policy: True gives leftover chips to the ``seq`` axis
    # (ring attention shortens each job) instead of ``data`` (coalescing
    # raises job throughput) — see core/mesh.py::derive_mesh_spec
    latency_mode: bool = False
    precision: str = "bfloat16"
    use_flash_attention: bool = True
    compile_cache_size: int = 4
    max_image_size: int = 1024
    default_steps: int = 30
    health_port: int = 0  # >0 serves GET /healthz (SURVEY.md §5 gap fix)
    health_host: str = "127.0.0.1"  # loopback by default (observability)
    health_bind_ephemeral: bool = False  # tests: bind port 0, read address
    # adaptive poll cadence (protocol congestion control; defaults are
    # THE protocol constants from node/hive.py — overridable so hermetic
    # chaos runs can poll fast)
    poll_busy_s: float = float(POLL_BUSY_S)
    poll_idle_s: float = float(POLL_IDLE_S)
    # ---- fault tolerance (node/resilience.py, node/worker.py) ----
    # per-job execution budget; a timed-out job uploads a structured error
    # envelope instead of silently eating the hive's patience
    job_deadline_s: float = 600.0
    # per-workflow overrides, e.g. {"txt2vid": 1800, "img2vid": 1800};
    # the "default" key (if present) replaces job_deadline_s
    workflow_deadline_s: dict[str, float] = dataclasses.field(
        default_factory=dict)
    transient_retries: int = 2          # local re-runs for transient/oom
    retry_backoff_s: float = 0.5        # ladder backoff base
    retry_backoff_cap_s: float = 30.0   # ladder backoff cap
    breaker_threshold: int = 3          # consecutive failures -> quarantine
    breaker_cooldown_s: float = 300.0   # open -> half-open probe window
    poll_backoff_base_s: float = 2.0    # poll-error backoff base
    # backoff cap = the reference's flat error delay (hive.POLL_ERROR_S)
    poll_backoff_cap_s: float = float(POLL_ERROR_S)
    upload_retries: int = 3             # result upload attempts
    upload_retry_delay_s: float = 5.0   # upload backoff base
    drain_timeout_s: float = 30.0       # shutdown: in-flight job drain
    result_drain_timeout_s: float = 20.0  # shutdown: upload-queue drain
    dead_letter_dir: str = ""           # default <settings root>/dead_letter
    install_signal_handlers: bool = True  # SIGTERM/SIGINT -> graceful stop
    # ---- fleet / lease participation (node/minihive.py) ----
    # >0: POST /api/heartbeat every N seconds with the in-flight job ids
    # and their latest resume checkpoints, so a lease-aware hive keeps
    # this worker's leases alive and can redeliver-with-resume if the
    # worker dies. The reference hive has no heartbeat endpoint — leave
    # 0 there (its timeout detector stays the only failure story).
    heartbeat_s: float = 0.0
    checkpoint_dir: str = ""            # default <root>/checkpoints/<worker>
    # hive-outage ride-through (node/resilience.py::
    # HiveSession): this many CONSECUTIVE poll/upload/heartbeat
    # failures flip the session to OUTAGE — leases assumed lost,
    # in-flight work completes, results spool after one upload attempt,
    # and the spool replays LIVE the moment the hive heals
    hive_outage_after: int = 3
    # ---- HBM model residency (the JAX serving/residency.py) ----
    # explicit resident-param budget in bytes; 0 = auto (the
    # CHIASWARM_RESIDENCY_BUDGET env var, else the classic HBM fraction
    # from core/mesh.py as the initial no-model-loaded fallback)
    residency_budget_bytes: int = 0
    # demand-driven prefetch: idle polls warm-load the hottest evicted
    # model back into free budget (CHIASWARM_RESIDENCY_PREFETCH=0 and
    # this flag both disable it)
    residency_prefetch: bool = True
    # ---- overload control (the JAX node/overload.py) ----
    # deadline-aware admission shedding + queue-depth backpressure +
    # the brownout rung. OFF by default for reference-hive parity:
    # sheds upload as non-fatal "overloaded" envelopes only a
    # lease-aware hive redispatches (node/minihive.py) — the reference
    # hive would settle them as plain errors. The swarmload harness
    # (node/loadgen.py) and lease-aware fleets turn it on.
    overload_control: bool = False
    # shed when predicted completion > margin x remaining deadline
    # budget (job "deadline_s" field, else deadline_for(workflow))
    overload_margin: float = 1.0
    # poll-loop backpressure: stop asking for work once the queued
    # backlog's drain estimate exceeds this many seconds (0 = derive
    # half the default job deadline)
    backpressure_s: float = 0.0
    # brownout rung: this many sheds inside overload_window_s tighten
    # the margin and cap lane admissions per step boundary
    overload_brownout_sheds: int = 6
    overload_window_s: float = 10.0
    overload_cooldown_s: float = 5.0
    overload_admission_cap: int = 2
    # ---- gray-failure guard (the JAX serving/guard.py) ----
    # the self-healing ladder: hang/slow-step/invalid-output events
    # grow a per-device sickness streak (hang weighs 2, the rest 1; an
    # OK event decays 1); crossing each threshold queues one rung —
    # executable-cache flush, device quarantine (slot mesh shrinks to
    # the healthy chips), graceful self-restart (exit code
    # guard.GUARD_RESTART_EXIT_CODE for supervisors). The watchdog and
    # validation knobs are env vars (CHIASWARM_GUARD*), like the
    # stepper's.
    guard_enabled: bool = True
    guard_cache_flush_after: int = 3
    guard_quarantine_after: int = 5
    guard_restart_after: int = 7
    # per-model-family deadline overrides: {"sdxl": 45.0, ...} —
    # consulted between a job's explicit deadline_s field and the
    # per-workflow table
    family_deadline_s: dict[str, float] = dataclasses.field(
        default_factory=dict)

    def deadline_for(self, workflow: str | None) -> float:
        """Execution budget (seconds) for one job of ``workflow`` (None /
        "" = the plain stable-diffusion path)."""
        table = self.workflow_deadline_s or {}
        default = float(table.get("default", self.job_deadline_s))
        if not workflow:
            return default
        return float(table.get(str(workflow), default))

    def hive_uris(self) -> list[str]:
        """The control-plane uris this worker multiplexes across: the
        explicit shard list when set, else ``hive_uri`` split on commas. A plain single uri yields a
        one-element list — the un-federated wire behavior."""
        if self.hive_shard_uris:
            return [str(uri).strip() for uri in self.hive_shard_uris
                    if str(uri).strip()]
        return [part.strip() for part in str(self.hive_uri).split(",")
                if part.strip()]

    @staticmethod
    def _legacy_key_map() -> dict[str, str]:
        return {
            "sdaas_uri": "hive_uri",
            "sdaas_token": "hive_token",
        }

    @classmethod
    def from_json(cls, data: dict[str, Any]) -> "Settings":
        legacy = cls._legacy_key_map()
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for key, value in data.items():
            key = legacy.get(key, key)
            if key in fields:
                kwargs[key] = value
        return cls(**kwargs)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_legacy_json(self) -> dict[str, Any]:
        """Emit the reference's field names for round-trip compatibility."""
        data = self.to_json()
        data["sdaas_uri"] = data.pop("hive_uri")
        data["sdaas_token"] = data.pop("hive_token")
        return data


def settings_root() -> Path:
    """Resolve the settings directory (reference: swarm/settings.py:53-64)."""
    for var in _ROOT_ENV_VARS:
        root = os.environ.get(var)
        if root:
            return Path(root).expanduser()
    return Path.home() / ".swarm-tpu"


def settings_path() -> Path:
    return settings_root() / "settings.json"


def load_settings() -> Settings:
    """Load settings.json (if present) and apply env overrides."""
    path = settings_path()
    if path.exists():
        with open(path, "r", encoding="utf-8") as fh:
            settings = Settings.from_json(json.load(fh))
    else:
        settings = Settings()
    for env, field in _ENV_OVERRIDES.items():
        value = os.environ.get(env)
        if value:
            setattr(settings, field, value)
    return settings


def save_settings(settings: Settings) -> Path:
    root = settings_root()
    root.mkdir(parents=True, exist_ok=True)
    path = settings_path()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(settings.to_json(), fh, indent=2)
    return path


def save_file(data: Any, filename: str) -> Path:
    """Persist an auxiliary JSON document under the settings root
    (reference: swarm/settings.py:67-69, used for the hive model catalog)."""
    root = settings_root()
    root.mkdir(parents=True, exist_ok=True)
    path = root / filename
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2)
    return path


def load_file(filename: str) -> Any | None:
    path = settings_root() / filename
    if not path.exists():
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)
