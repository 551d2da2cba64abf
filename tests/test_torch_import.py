"""The PyTorch port stands alone: no module of ``chiaswarm_tpu_torch``
imports ``jax``, ``flax`` or anything of ``chiaswarm_tpu``.

Two checks: every module imports in a subprocess where those packages are
poisoned in ``sys.modules``, and a scan of each source file's import
statements finds none of them.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "chiaswarm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "chiaswarm_tpu")

SOURCES = sorted(PACKAGE.rglob("*.py"))


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in SOURCES]
    script = "\n".join([
        "import sys",
        *[f"sys.modules[{name!r}] = None" for name in FORBIDDEN],
        "import importlib",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('imported', len(" + repr(modules) + "))",
    ])
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"imported {len(modules)}" in proc.stdout


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_has_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_package_has_the_slice_modules():
    """The layer names mirror the JAX package's."""
    names = {_module_name(p) for p in SOURCES}
    for layer in ("core.rng", "core.chip_pool", "core.buckets",
                  "ops.attention", "ops.flash_attention", "models.configs",
                  "models.tokenizer", "models.clip", "models.unet",
                  "models.vae", "schedulers.common", "schedulers.sampling",
                  "convert.from_jax", "pipelines.components",
                  "pipelines.diffusion", "workloads.diffusion",
                  "node.output_processor", "node.registry", "node.job_args",
                  "node.executor", "node.smoke", "core.mesh",
                  "parallel.context", "parallel.ring_attention",
                  "ops.ring_flash_attention", "serving.guard",
                  "serving.stepper", "node.settings", "node.logging_setup",
                  "node.resilience", "node.hive", "node.worker",
                  "obs.metrics", "obs.trace", "convert.safetensors_io",
                  "convert.checkpoint", "serving.residency",
                  "models.controlnet", "workloads.safety",
                  "workloads.controlnet", "workloads.stitch",
                  "models.blip", "pipelines.caption", "workloads.caption",
                  "models.clap", "models.vocoder", "pipelines.audio",
                  "workloads.audio", "models.gpt", "models.codec",
                  "pipelines.tts", "models.video_unet", "pipelines.video",
                  "workloads.video", "models.t5", "pipelines.cascade",
                  "workloads.cascade", "workloads.ade_palette",
                  "models.annotator", "models.hed", "models.lineart",
                  "models.mlsd", "models.openpose", "models.dpt",
                  "models.upernet"):
        assert f"chiaswarm_tpu_torch.{layer}" in names
    assert (PACKAGE / "csrc" / "flash_attention.cu").exists()
    for source in ("ring_flash_hop.cu", "ring_flash_fused.cu",
                   "ring_flash_common.cuh"):
        assert (PACKAGE / "csrc" / source).exists()
