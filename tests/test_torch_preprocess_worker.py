"""The worker path of the port's ControlNet detectors on the CPU: one job
per detector family (HED's softedge, M-LSD, lineart, DPT's depth, UperNet's
seg, openpose) on the ``tiny`` family, its picture fetched from a local
server, through ``format_args`` (the registry's device reaches the
detector) and ``synchronous_do_work`` on the solo path, against the JAX
executor with its detector caches holding the same weights: error-free
envelopes with the same config keys and stamps, and the same
``preprocessed_input`` echo: bit for bit for the threshold maps (mlsd, seg,
openpose), within one uint8 level for the continuous ones (softedge,
lineart, depth), whose float32 network outputs differ by a few 1e-6 and
may round a pixel to the next level. The detectors run at 64 px
canvases (DPT and UperNet at their tiny configs), their weights seeded
under the published names."""

from __future__ import annotations

import base64
import copy
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_preprocessors import (
    CONTINUOUS,
    SPECS,
    Twins,
    picture,
    published,
)

from chiaswarm_tpu.workloads import controlnet as jcontrol
from chiaswarm_tpu_torch.core.chip_pool import ChipPool
from chiaswarm_tpu_torch.models import dpt as tdpt
from chiaswarm_tpu_torch.models import upernet as tupernet
from chiaswarm_tpu_torch.node import executor
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.serving.stepper import get_stepper
from chiaswarm_tpu_torch.workloads import controlnet as tcontrol

CN = "test/controlnet"
FAMILY_MODES = {"hed": "softedge", "mlsd": "mlsd", "lineart": "lineart",
                "dpt": "depth", "upernet": "seg", "openpose": "openpose"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _root(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_STEPPER", "0")


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """Each family's detectors in both packages over one set of weights
    (DPT's and UperNet's drawn under the port's own names, which are
    transformers' less the keys both converters drop)."""
    root = tmp_path_factory.mktemp("detectors")
    own = {"dpt": lambda: published(tdpt.DPTDepth(tdpt.DPT_TINY), 5),
           "upernet": lambda: published(
               tupernet.UperNetSeg(tupernet.UPERNET_TINY), 6)}
    return {name: Twins(name, root, own[name]() if name in own else None)
            for name in FAMILY_MODES}


class _Picture(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.do_GET()

    def do_GET(self):
        buf = io.BytesIO()
        Image.fromarray(picture(21, (64, 96))).save(buf, format="PNG")
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)


@pytest.fixture(scope="module")
def picture_url():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Picture)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}/picture.png"
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def executors():
    """(JAX's slot and registry, the port's) for the tiny family, kept
    across the jobs."""
    from chiaswarm_tpu.core.chip_pool import ChipPool as JaxPool
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry

    catalog = [{"name": "tiny", "family": "tiny"}]
    slot = ChipPool(device="cpu").slots[0]
    yield ((JaxPool(n_slots=1).slots[0],
            JaxRegistry(catalog=catalog, allow_random=True)),
           (slot, ModelRegistry(catalog=catalog, allow_random=True,
                                device="cpu")))
    get_stepper(slot).shutdown()


def _decoded(blob: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(blob))))


@pytest.mark.parametrize("name", FAMILY_MODES)
def test_detector_jobs_match_the_jax_executor(twins, picture_url, executors,
                                              name, monkeypatch):
    from chiaswarm_tpu.node.executor import synchronous_do_work as jax_do_work

    t = twins[name]
    monkeypatch.setattr(jcontrol, SPECS[name][4], [t.jax])
    monkeypatch.setitem(tcontrol._DETECTORS, (name, "cpu"), t.from_file)
    mode = FAMILY_MODES[name]
    job = {"id": f"pre-{name}", "model_name": "tiny", "prompt": "a harbor",
           "num_inference_steps": 2, "seed": 8, "content_type": "image/png",
           "start_image_uri": picture_url, "controlnet_scale": 0.6,
           "parameters": {"controlnet": {
               "controlnet_model_name": CN, "preprocess": True,
               "type": mode}}}
    (jax_slot, jax_registry), (slot, registry) = executors
    ref = jax_do_work(copy.deepcopy(job), jax_slot, jax_registry)
    got = executor.synchronous_do_work(copy.deepcopy(job), slot, registry)
    cfg, ref_cfg = got["pipeline_config"], ref["pipeline_config"]
    assert "error" not in cfg and "error" not in ref_cfg, (cfg, ref_cfg)
    assert set(cfg) == set(ref_cfg)
    for key in ("controlnet", "controlnet_scale", "mode", "size", "steps"):
        assert cfg[key] == ref_cfg[key], key
    assert set(got["artifacts"]) == set(ref["artifacts"]) == {
        "primary", "preprocessed_input"}
    echo = _decoded(got["artifacts"]["preprocessed_input"]["blob"])
    want = _decoded(ref["artifacts"]["preprocessed_input"]["blob"])
    assert echo.shape == want.shape == (64, 96, 3)
    if mode in CONTINUOUS:
        assert np.abs(echo.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(echo, want)
    assert list(tcontrol._DETECTORS) == [(name, "cpu")]
