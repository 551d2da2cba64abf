"""Node bootstrap, the local half of ``chiaswarm_tpu/node/initialize.py``:
configure the hive credentials, cache the hive's model catalog, report the
catalog models this node holds no weights for, and optionally warm each
local model so the worker's first job pays no first use.

    python -m chiaswarm_tpu_torch.cli init                    # prompts
    python -m chiaswarm_tpu_torch.cli init --silent --warm-compile

- ``prompt_settings`` and ``--reset`` / ``--silent`` (JAX :38-50, :260-292):
  with no hive token, or with ``--reset``, the hive uri, token and worker
  name are asked for; ``--silent`` never asks. The settings are saved under
  the settings root (``node/settings.py``).
- :func:`fetch_model_catalog` (JAX :51-58): ``GET /api/models`` through the
  port's ``HiveClient.get_models`` (the first hive of a federated list),
  cached as ``models.json``; an unreachable hive falls back to the cached
  file.
- :func:`prefetch_checkpoints` is JAX's prefetch as it runs without hub
  access (JAX :61-97): it downloads nothing, and logs, for each catalog
  model with no directory under ``model_dir``, the directory it would need
  (``--no-prefetch`` skips it). The hub downloads themselves (checkpoints,
  the safety checker and the annotators' weights, JAX :61-204) are not
  ported: the port reads weights an operator puts under ``model_dir``.
- :func:`warm_compile` (JAX :206-257, ``--warm-compile``): each catalog
  model with a local directory runs its default bucket for 2 steps on the
  worker's default slot (``node/worker.py::default_pool_plan``), through
  the registry that serving uses, so the kernels are built (``nvcc`` at
  first use, ``ops/kernels.py``) and the model's ledger entry is the one
  the worker's jobs hit. A model that fails to warm logs a warning and the
  others go on, as in JAX.

Entry points run on ``cuda`` unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Any

import aiohttp

from chiaswarm_tpu_torch.node.hive import HiveClient
from chiaswarm_tpu_torch.node.logging_setup import setup_logging
from chiaswarm_tpu_torch.node.registry import model_dir
from chiaswarm_tpu_torch.node.settings import (
    Settings,
    load_file,
    load_settings,
    save_file,
    save_settings,
    settings_root,
)

log = logging.getLogger("chiaswarm_torch.init")

#: steps each local model's warm-up runs
WARM_STEPS = 2


def prompt_settings(settings: Settings) -> Settings:
    uri = input(f"hive uri [{settings.hive_uri}]: ").strip()
    token = input("hive token (blank keeps current): ").strip()
    name = input(f"worker name [{settings.worker_name}]: ").strip()
    if uri:
        settings.hive_uri = uri
    if token:
        settings.hive_token = token
    if name:
        settings.worker_name = name
    return settings


async def fetch_model_catalog(settings: Settings) -> list[dict[str, Any]]:
    hive = HiveClient(settings.hive_uris()[0], settings.hive_token,
                      settings.worker_name)
    async with aiohttp.ClientSession() as session:
        models = await hive.get_models(session)
    save_file(models, "models.json")
    log.info("cached %d models from the hive catalog", len(models))
    return models


def _name(model: dict[str, Any]) -> str | None:
    return model.get("name") or model.get("model_name")


def prefetch_checkpoints(models: list[dict[str, Any]]) -> list[str]:
    """Log each preloadable catalog model that has no directory under
    :func:`model_dir`, and return their names. Nothing is downloaded."""
    missing = []
    for model in models:
        name = _name(model)
        if not name or not model.get("parameters", {}).get("can_preload",
                                                           True):
            continue
        target = model_dir(name)
        if not target.exists():
            log.info("no weights for %s: put its checkpoint at %s", name,
                     target)
            missing.append(name)
    return missing


def warm_slot(settings: Settings, registry, device: str | None):
    """The slot the worker's first slot would be: the default pool's plan
    on the cards (``node/worker.py::default_pool_plan``), or one slot on
    ``device`` when it is the CPU."""
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.device import resolve_device
    from chiaswarm_tpu_torch.node.worker import default_pool_plan

    if resolve_device(device).type != "cuda":
        return ChipPool(device=device).slots[0]
    _, n_slots, slot_spec = default_pool_plan(settings, registry)
    return ChipPool(n_slots=n_slots, mesh_spec=slot_spec).slots[0]


def warm_compile(models: list[dict[str, Any]], settings: Settings,
                 device: str | None = None) -> dict[str, str]:
    """Run each local catalog model's default bucket for
    :data:`WARM_STEPS` steps on the worker's default slot, through the
    registry serving uses. Returns ``{name: "warmed" | error}``."""
    import numpy as np

    from chiaswarm_tpu_torch.node.registry import ModelRegistry
    from chiaswarm_tpu_torch.pipelines.diffusion import GenerateRequest
    from chiaswarm_tpu_torch.pipelines.tts import is_tts_model

    registry = ModelRegistry(catalog=models, allow_random=False,
                             device=device)
    mesh = warm_slot(settings, registry, device).mesh
    outcome = {}
    for model in models:
        name = _name(model)
        if not name or not model_dir(name).exists():
            continue
        try:
            workflow = str((model.get("parameters") or {})
                           .get("workflow", ""))
            # bark outranks the txt2audio tag: the hive serves bark under
            # txt2audio, so the name gate must win
            if is_tts_model(name):
                registry.tts_pipeline(name, mesh=mesh)("warmup",
                                                       duration_s=0.5)
            elif name.startswith("DeepFloyd/"):
                registry.cascade_pipeline(name, mesh=mesh)(
                    "warmup", steps=WARM_STEPS, sr_steps=WARM_STEPS)
            elif workflow == "txt2audio" or "audioldm" in name.lower():
                registry.audio_pipeline(name, mesh=mesh)(
                    "warmup", steps=WARM_STEPS, duration_s=1.0)
            elif workflow == "img2txt" or "blip" in name.lower():
                registry.caption_pipeline(name, mesh=mesh)(
                    np.zeros((64, 64, 3), np.uint8))
            else:
                pipe = registry.pipeline(name, mesh=mesh)
                size = pipe.c.family.default_size
                pipe(GenerateRequest(prompt="warmup", steps=WARM_STEPS,
                                     height=size, width=size, seed=0))
            log.info("warmed %s", name)
            outcome[name] = "warmed"
        except Exception as exc:
            log.warning("warm-up of %s failed: %s", name, exc)
            outcome[name] = f"{type(exc).__name__}: {exc}"
    return outcome


async def init(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reset", action="store_true",
                        help="re-prompt for hive uri/token")
    parser.add_argument("--silent", action="store_true",
                        help="no prompts; use existing/env settings")
    parser.add_argument("--no-prefetch", action="store_true")
    parser.add_argument("--warm-compile", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device of the warm-up (default: cuda)")
    args = parser.parse_args(argv)

    settings = load_settings()
    setup_logging(settings_root() / "logs", settings.log_filename,
                  settings.log_level)
    if args.reset or (not settings.hive_token and not args.silent):
        settings = prompt_settings(settings)
    save_settings(settings)

    try:
        models = await fetch_model_catalog(settings)
    except Exception as exc:
        log.warning("could not reach the hive (%s); using cached catalog",
                    exc)
        models = load_file("models.json") or []

    if not args.no_prefetch:
        prefetch_checkpoints(models)
    if args.warm_compile:
        warm_compile(models, settings, args.device)
    log.info("init complete: settings at %s", settings_root())
    return 0


def main() -> None:
    raise SystemExit(asyncio.run(init()))


if __name__ == "__main__":
    main()
