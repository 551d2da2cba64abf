"""The port's operator CLI (``chiaswarm_tpu_torch/cli.py``), its smoke
harness (``node/smoke.py``) and the local half of its bootstrap
(``node/initialize.py``), on the CPU:

- subcommand dispatch to init, worker, smoke and info, and ``bench``'s exit
  2 with its one line;
- ``info --device cpu``;
- ``smoke --all --device cpu --random-weights`` over the JAX harness's ten
  workflows with the tiny families, every envelope error-free; the jobs
  are the JAX harness's;
- ``init --silent`` writing ``models.json`` and ``settings.json`` from a
  local hive, the missing models logged and nothing downloaded;
- ``init --silent --warm-compile --device cpu`` warming a tiny checkpoint
  the test writes, with no warning.
"""

from __future__ import annotations

import asyncio
import json
import logging

import pytest
import torch

from chiaswarm_tpu.node.smoke import SMOKE_JOBS as JAX_SMOKE_JOBS
from chiaswarm_tpu_torch import WORKER_VERSION, cli
from chiaswarm_tpu_torch.node import smoke
from chiaswarm_tpu_torch.node.registry import model_dir
from tests.fake_hive import FakeHive


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tmp_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("CHIASWARM_RESIDENCY_BUDGET", raising=False)
    for var in ("SDAAS_URI", "SDAAS_TOKEN", "SWARM_TPU_URI",
                "SWARM_TPU_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


@pytest.fixture(autouse=True)
def _root_logging():
    """``init`` installs root logging (a file under the settings root and
    the console): take its handlers out again after each test."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for handler in list(root.handlers):
        if handler not in handlers:
            root.removeHandler(handler)
            handler.close()
    root.setLevel(level)


# ---------------------------------------------------------------------------
# dispatch


@pytest.mark.parametrize("command", ["init", "worker", "smoke"])
def test_subcommands_dispatch_with_their_arguments(command, monkeypatch):
    from chiaswarm_tpu_torch.node import initialize, worker

    seen = {}

    async def fake_init(argv):
        seen["init"] = argv
        return 5

    async def fake_run_worker():
        seen["worker"] = []
        return 73

    def fake_smoke(argv):
        seen["smoke"] = argv
        return 7

    monkeypatch.setattr(initialize, "init", fake_init)
    monkeypatch.setattr(worker, "run_worker", fake_run_worker)
    monkeypatch.setattr(smoke, "main", fake_smoke)
    # the worker's no-CPU-fallback gate, as on a machine with a card
    monkeypatch.setattr("chiaswarm_tpu_torch.core.device.resolve_device",
                        lambda device=None: torch.device("cpu"))
    args = {"init": ["--silent", "--warm-compile"], "worker": [],
            "smoke": ["--all", "--device", "cpu"]}[command]
    code = cli.main([command, *args])
    assert seen == {command: args}
    # each subcommand's exit code passes through: the worker's 73 is the
    # guard's restart rung
    assert code == {"init": 5, "worker": 73, "smoke": 7}[command]


def test_worker_without_a_card_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["worker"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_bench_exits_2_with_one_line(capsys):
    assert cli.main(["bench"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and out.err.strip() == cli.BENCH_NOT_PORTED
    assert len(out.err.strip().splitlines()) == 1


def test_an_unknown_subcommand_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve"])
    assert exc.value.code == 2


def test_info_on_the_cpu(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["worker_version"] == WORKER_VERSION
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert info["slots"]["platform"] == "cpu"
    assert info["slots"]["mesh_devices"] == ["cpu"]


# ---------------------------------------------------------------------------
# smoke over the ten workflows


def test_smoke_jobs_are_the_jax_harness_jobs():
    assert smoke.WORKFLOWS == tuple(JAX_SMOKE_JOBS)
    for workflow, theirs in JAX_SMOKE_JOBS.items():
        mine = smoke.SMOKE_JOBS[workflow]
        for key, value in theirs.items():
            if workflow in smoke.SD_WORKFLOWS and key in (
                    "model_name", "num_inference_steps", "height", "width"):
                continue  # --model, --steps and --size choose them
            assert mine[key] == value, (workflow, key)


@pytest.fixture(scope="module")
def smoke_all_lines(tmp_path_factory):
    """``smoke --all --device cpu --random-weights`` once, its lines by
    workflow."""
    import contextlib
    import io
    import os

    root = tmp_path_factory.mktemp("smoke_root")
    before = os.environ.get("SWARM_TPU_ROOT")
    os.environ["SWARM_TPU_ROOT"] = str(root)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            code = cli.main(["smoke", "--all", "--device", "cpu",
                             "--random-weights"])
    finally:
        if before is None:
            os.environ.pop("SWARM_TPU_ROOT", None)
        else:
            os.environ["SWARM_TPU_ROOT"] = before
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    return code, {line["workflow"]: line for line in lines}


@pytest.mark.parametrize("workflow", list(JAX_SMOKE_JOBS))
def test_smoke_all_serves_every_workflow(workflow, smoke_all_lines):
    code, lines = smoke_all_lines
    assert set(lines) == set(JAX_SMOKE_JOBS)
    line = lines[workflow]
    assert line["status"] == "ok", line
    assert not line["fatal"] and "primary" in line["artifacts"], line
    assert code == 0


# ---------------------------------------------------------------------------
# init


def _serve_hive(models: list[dict], argv: list[str], monkeypatch) -> int:
    """``cli init`` with ``argv`` against a local hive listing ``models``."""

    async def scenario():
        hive = FakeHive()
        uri = await hive.start()
        hive.models = models
        monkeypatch.setenv("SDAAS_URI", uri)
        monkeypatch.setenv("SDAAS_TOKEN", "token")
        try:
            return await asyncio.to_thread(cli.main, ["init", *argv])
        finally:
            await hive.stop()

    return asyncio.run(scenario())


def test_init_silent_writes_the_catalog_and_settings(tmp_path, monkeypatch,
                                                     caplog):
    models = [{"name": "local/tiny", "family": "tiny"},
              {"name": "missing/sd15", "family": "sd15"},
              {"name": "missing/never", "family": "tiny",
               "parameters": {"can_preload": False}}]
    model_dir("local/tiny").mkdir(parents=True)
    with caplog.at_level(logging.INFO, logger="chiaswarm_torch.init"):
        assert _serve_hive(models, ["--silent"], monkeypatch) == 0
    assert json.loads((tmp_path / "models.json").read_text()) == models
    settings = json.loads((tmp_path / "settings.json").read_text())
    assert settings["hive_token"] == "token"
    missing = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("no weights for")]
    assert len(missing) == 1 and "missing/sd15" in missing[0]
    assert str(model_dir("missing/sd15")) in missing[0]
    assert not model_dir("missing/sd15").exists()  # nothing downloaded


def test_init_falls_back_to_the_cached_catalog(tmp_path, monkeypatch):
    from chiaswarm_tpu_torch.node import initialize
    from chiaswarm_tpu_torch.node.settings import save_file

    save_file([{"name": "cached/tiny", "family": "tiny"}], "models.json")
    monkeypatch.setenv("SDAAS_URI", "http://127.0.0.1:9")
    seen = {}
    monkeypatch.setattr(initialize, "prefetch_checkpoints",
                        lambda models: seen.setdefault("models", models))
    assert cli.main(["init", "--silent"]) == 0
    assert seen["models"] == [{"name": "cached/tiny", "family": "tiny"}]


def _write_tiny_checkpoint(name: str) -> None:
    from chiaswarm_tpu_torch.convert.safetensors_io import save_file
    from chiaswarm_tpu_torch.pipelines.components import Components
    from tests.test_torch_checkpoint import write_vocab

    src = Components.random("tiny", seed=3, device="cpu")
    root = model_dir(name)
    for sub, module in {"unet": src.unet, "vae": src.vae,
                        "text_encoder": src.text_encoders[0]}.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.float() for k, v in module.state_dict().items()},
                  root / sub / "model.safetensors")
    write_vocab(root / "tokenizer")


def test_init_warm_compile_warms_each_local_model(monkeypatch, caplog):
    from chiaswarm_tpu_torch.node import initialize
    from chiaswarm_tpu_torch.pipelines import diffusion

    _write_tiny_checkpoint("local/tiny")
    models = [{"name": "local/tiny", "family": "tiny"},
              {"name": "missing/tiny", "family": "tiny"}]
    calls = []
    real_call = diffusion.DiffusionPipeline.__call__

    def recording_call(self, req):
        calls.append((self.c.model_name, req.steps, req.height, req.width,
                      str(self.c.device)))
        return real_call(self, req)

    monkeypatch.setattr(diffusion.DiffusionPipeline, "__call__",
                        recording_call)
    outcomes = {}
    real_warm = initialize.warm_compile
    monkeypatch.setattr(
        initialize, "warm_compile",
        lambda *a, **kw: outcomes.update(real_warm(*a, **kw)) or outcomes)
    with caplog.at_level(logging.INFO):
        code = _serve_hive(models, ["--silent", "--warm-compile", "--device",
                                    "cpu"], monkeypatch)
    assert code == 0
    assert outcomes == {"local/tiny": "warmed"}
    # its default bucket (64 px for tiny) for 2 steps, on the slot's device
    assert calls == [("local/tiny", initialize.WARM_STEPS, 64, 64, "cpu")]
    assert "warmed local/tiny" in caplog.text
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]


def test_a_model_that_fails_to_warm_warns_and_the_rest_go_on(monkeypatch,
                                                              caplog):
    from chiaswarm_tpu_torch.node import initialize
    from chiaswarm_tpu_torch.node.settings import load_settings

    _write_tiny_checkpoint("local/tiny")
    model_dir("broken/tiny").mkdir(parents=True)  # no module directories
    models = [{"name": "broken/tiny", "family": "tiny"},
              {"name": "local/tiny", "family": "tiny"}]
    with caplog.at_level(logging.WARNING, logger="chiaswarm_torch.init"):
        outcome = initialize.warm_compile(models, load_settings(), "cpu")
    assert outcome["local/tiny"] == "warmed"
    assert outcome["broken/tiny"] != "warmed"
    assert any("warm-up of broken/tiny failed" in r.getMessage()
               for r in caplog.records)
