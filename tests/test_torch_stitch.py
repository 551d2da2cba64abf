"""The port's stitch workflow against the JAX package's, on the CPU.

- ``stitch_callback`` with injected images: the same JPEG bytes, thumbnail,
  hash and ``image_map`` as JAX's, for grids of one to five pictures of
  mixed sizes and modes.
- The routing of a ``stitch`` job equals JAX's.
- The fetch of each ``resultUri`` from a local ``http.server``: the same
  collage as JAX's; a result past the 3 MiB input cap (the system's own
  upscaled outputs) is fetched, since stitch caps at 32 MiB; a result past
  the stitch cap is refused as JAX refuses it (``bad_asset``).
"""

from __future__ import annotations

import base64
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from chiaswarm_tpu.node import job_args as jargs
from chiaswarm_tpu.node import resilience as jres
from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
from chiaswarm_tpu.workloads import stitch as jstitch
from chiaswarm_tpu_torch.node import job_args as targs
from chiaswarm_tpu_torch.node import resilience as tres
from chiaswarm_tpu_torch.node.registry import ModelRegistry
from chiaswarm_tpu_torch.workloads import stitch as tstitch


def _picture(seed: int, size: tuple[int, int], mode: str = "RGB") -> Image.Image:
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    return Image.fromarray(pixels).convert(mode)


def _png(image: Image.Image) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("sizes", [
    [(512, 512)],
    [(512, 512), (300, 700), (1024, 256), (64, 64)],
    [(200, 200)] * 5,
])
def test_injected_images_give_jax_bytes(sizes):
    images = [_picture(i, size, "RGB" if i % 2 else "RGBA")
              for i, size in enumerate(sizes)]
    jobs = [{"resultUri": f"https://results.example/{i}.png",
             "model_name": f"model-{i}", "fileName": f"f{i}.png"}
            for i in range(len(sizes) - 1)]  # the last image has no job
    got = tstitch.stitch_callback(None, "stitch", seed=1, jobs=jobs,
                                  images=images)
    want = jstitch.stitch_callback(None, "stitch", seed=1, jobs=jobs,
                                   images=images)
    assert got == want
    artifact = got[0]["primary"]
    assert artifact["content_type"] == "image/jpeg"
    side = 144 * int(np.ceil(np.sqrt(len(sizes))))
    assert Image.open(io.BytesIO(
        base64.b64decode(artifact["blob"]))).size == (side, side)
    assert [m["alt"] for m in got[1]["image_map"]][-1] == f"Image {len(sizes)}"


def test_routing_matches_jax():
    job = {"workflow": "stitch", "model_name": "stitch", "id": "s-1",
           "jobs": [{"resultUri": "http://x/1.png"}], "content_type": "image/jpeg"}
    callback, kwargs = targs.format_args(dict(job), ModelRegistry(device="cpu"))
    j_callback, j_kwargs = jargs.format_args(dict(job), JaxRegistry())
    assert callback is tstitch.stitch_callback
    assert j_callback is jstitch.stitch_callback
    assert {k: v for k, v in kwargs.items() if k != "registry"} == \
        {k: v for k, v in j_kwargs.items() if k != "registry"}


class _Results(BaseHTTPRequestHandler):
    """``/<name>.png`` from ``files``."""

    files: dict[str, bytes] = {}

    def log_message(self, *args) -> None:
        pass

    def do_GET(self) -> None:
        body = self.files.get(self.path.lstrip("/"))
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def results_server():
    # a noise picture's PNG passes the 3 MiB input cap
    big = _png(_picture(9, (1100, 1100)))
    assert len(big) > 3 * 1048576
    _Results.files = {"a.png": _png(_picture(1, (320, 200))),
                      "b.png": _png(_picture(2, (90, 160))),
                      "big.png": big}
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Results)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def test_fetched_results_give_jax_bytes(results_server):
    assert tstitch.MAX_RESULT_BYTES == jstitch.MAX_RESULT_BYTES == 32 * 1048576
    jobs = [{"resultUri": f"{results_server}/{name}.png", "model_name": name}
            for name in ("a", "b", "big")]
    got = tstitch.stitch_callback(None, "stitch", seed=1, jobs=jobs)
    want = jstitch.stitch_callback(None, "stitch", seed=1, jobs=jobs)
    assert got == want
    assert [m["href"] for m in got[1]["image_map"]] == \
        [job["resultUri"] for job in jobs]


def test_a_result_past_the_stitch_cap_is_refused_as_jax_refuses_it(
        results_server, monkeypatch):
    monkeypatch.setattr(tstitch, "MAX_RESULT_BYTES", 3 * 1048576)
    monkeypatch.setattr(jstitch, "MAX_RESULT_BYTES", 3 * 1048576)
    jobs = [{"resultUri": f"{results_server}/big.png"}]
    kinds = []
    for mod, res in ((tstitch, tres), (jstitch, jres)):
        with pytest.raises(Exception) as info:
            mod.stitch_callback(None, "stitch", seed=1, jobs=jobs)
        assert "Max size is 3145728 bytes" in str(info.value)
        kinds.append(res.classify_exception(info.value))
    assert kinds == ["bad_asset", "bad_asset"]
