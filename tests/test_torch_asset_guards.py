"""The port's guarded input-image fetch (``chiaswarm_tpu_torch/node/
job_args.py``: ``get_image``, ``download_image``) against the JAX package's
(``chiaswarm_tpu/node/job_args.py``), on the hostile fixtures of
``tests/test_asset_guards.py`` served by a real local ``http.server``.

The port fetches with the standard library's ``urllib.request``, the JAX
package with ``requests``: for every fixture the two raise errors of the
same failure kind (``node/resilience.py::classify_exception``), a guard
violation ``bad_asset`` and a network fault ``transient``. Two more fixtures
answer the HEAD cleanly and the GET with a 503 or a 404: ``transient`` and
``fatal`` in both packages, which holds the port's ``classify_exception``
reading ``urllib.error.HTTPError.code``.

Only http and https images are fetched: a ``file:``, ``ftp:`` or ``data:``
URL, one with no scheme, and a redirect to a ``file:`` URL are refused
before anything is read, and classify as the JAX package classifies
``requests``' ``InvalidSchema``/``MissingSchema``.
"""

from __future__ import annotations

import base64
import threading
import urllib.error
from http.server import ThreadingHTTPServer

import pytest
import requests

from chiaswarm_tpu.node import job_args as jargs
from chiaswarm_tpu.node import resilience as jres
from chiaswarm_tpu_torch.node import job_args as targs
from chiaswarm_tpu_torch.node import resilience as tres
from tests.test_asset_guards import _BOMB_PNG, _OK_PNG, _HostileHandler


class _Handler(_HostileHandler):
    """The JAX tests' hostile fixtures plus GETs that answer 503, 404 or a
    redirect to the ``file:`` URL in ``redirect_to`` after a clean HEAD."""

    redirect_to = ""

    def do_GET(self, head: bool = False):
        status = {"/unavailable.png": 503, "/gone.png": 404,
                  "/to-file.png": 302}.get(self.path)
        if status is None:
            return super().do_GET(head)
        if self.command == "HEAD":
            return self._send(b"", "image/png")
        self.send_response(status)
        if status == 302:
            self.send_header("Location", self.redirect_to)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture(scope="module")
def hostile_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def _kind(pkg, fn, *args) -> tuple[str, BaseException | None]:
    classify = {"jax": jres, "torch": tres}[pkg].classify_exception
    try:
        fn(*args)
    except Exception as exc:  # the kind is the assertion
        return classify(exc), exc
    return "ok", None


def test_happy_path_fetches_the_same_pixels(hostile_server):
    url = f"{hostile_server}/ok.png"
    got, ref = targs.get_image(url, None), jargs.get_image(url, None)
    assert got.mode == ref.mode == "RGB" and got.size == ref.size == (32, 32)
    assert got.tobytes() == ref.tobytes()
    assert targs.download_image(url).tobytes() == ref.tobytes()


@pytest.mark.parametrize("path,fetch,kind", [
    ("/not-an-image", "get_image", "bad_asset"),
    ("/liar-head", "get_image", "bad_asset"),
    ("/huge-header", "get_image", "bad_asset"),
    ("/oversized-stream", "download_image", "bad_asset"),
    ("/bomb.png", "download_image", "bad_asset"),
    ("/bomb.png", "get_image", "bad_asset"),
    ("/unavailable.png", "get_image", "transient"),
    ("/gone.png", "get_image", "fatal"),
    ("/no-such-asset", "get_image", "bad_asset"),
])
def test_hostile_asset_classifies_as_in_jax(hostile_server, path, fetch, kind):
    url = f"{hostile_server}{path}"
    args = (url, None) if fetch == "get_image" else (url,)
    t_kind, t_exc = _kind("torch", getattr(targs, fetch), *args)
    j_kind, _ = _kind("jax", getattr(jargs, fetch), *args)
    assert t_kind == j_kind == kind, (t_kind, j_kind, t_exc)
    if kind == "bad_asset":
        assert isinstance(t_exc, tres.BadAssetError)


def test_guard_messages_name_the_guard(hostile_server):
    with pytest.raises(tres.BadAssetError, match="exceeded the cap"):
        targs.download_image(f"{hostile_server}/oversized-stream")
    with pytest.raises(tres.BadAssetError, match="decompression-bomb"):
        targs.download_image(f"{hostile_server}/bomb.png")
    with pytest.raises(tres.BadAssetError, match="too large"):
        targs.get_image(f"{hostile_server}/huge-header", None)
    assert len(_BOMB_PNG) < 64 * 1024 and len(_OK_PNG) < targs.MAX_IMAGE_BYTES


def test_guard_limits_are_the_jax_packages():
    for name in ("MAX_SIZE", "MAX_IMAGE_BYTES", "MAX_IMAGE_PIXELS",
                 "CONNECT_TIMEOUT_S", "READ_TIMEOUT_S", "DEFAULT_STEPS"):
        assert getattr(targs, name) == getattr(jargs, name), name


def test_read_timeout_classifies_transient(hostile_server, monkeypatch):
    """A stalling asset host trips the read timeout in both packages."""
    monkeypatch.setattr(targs, "READ_TIMEOUT_S", 0.3)
    monkeypatch.setattr(jargs, "READ_TIMEOUT_S", 0.3)
    url = f"{hostile_server}/slow"
    t_kind, t_exc = _kind("torch", targs.download_image, url)
    j_kind, _ = _kind("jax", jargs.download_image, url)
    assert t_kind == j_kind == "transient", t_exc
    assert not isinstance(t_exc, tres.BadAssetError)


def test_closed_port_classifies_transient():
    """Nothing listens on port 1 of this host: a refused connection."""
    t_kind, _ = _kind("torch", targs.get_image, "http://127.0.0.1:1/a.png",
                      None)
    j_kind, _ = _kind("jax", jargs.get_image, "http://127.0.0.1:1/a.png",
                      None)
    assert t_kind == j_kind == "transient"


@pytest.mark.parametrize("status,kind", [(503, "transient"), (502, "transient"),
                                         (404, "fatal"), (400, "fatal")])
def test_http_error_status_classifies_in_both_packages(status, kind):
    """An asset host's 5xx is retried, its 4xx is not: ``urllib``'s
    ``HTTPError`` (``.code``, text "HTTP Error 503: ...") in the port,
    ``requests``' (``.response.status_code``) in both."""
    url_error = urllib.error.HTTPError("http://h/500x500/a.png", status,
                                       "reason", {}, None)
    assert str(url_error).startswith(f"HTTP Error {status}")
    response = requests.Response()
    response.status_code = status
    requests_error = requests.HTTPError(f"{status} Client Error",
                                        response=response)
    assert tres.classify_exception(url_error) == kind
    assert tres.classify_exception(requests_error) == kind
    assert jres.classify_exception(requests_error) == kind


def test_bad_asset_is_nonfatal_in_the_format_path(hostile_server):
    """A bomb fetched through ``start_image_uri`` envelopes as the non-fatal
    ``bad_asset`` kind in both executors' format step."""
    from chiaswarm_tpu.node.executor import _format as jax_format
    from chiaswarm_tpu.node.registry import ModelRegistry as JaxRegistry
    from chiaswarm_tpu_torch.node.executor import _format
    from chiaswarm_tpu_torch.node.registry import ModelRegistry

    job = {"id": "bomb-1", "model_name": "tiny", "prompt": "p",
           "start_image_uri": f"{hostile_server}/bomb.png",
           "content_type": "application/json"}
    for fmt, registry in ((_format, ModelRegistry(
            catalog=[], allow_random=True, device="cpu")),
            (jax_format, JaxRegistry(catalog=[], allow_random=True))):
        formatted, result = fmt(dict(job), registry)
        assert formatted is None
        assert "fatal_error" not in result
        assert result["pipeline_config"]["error_kind"] == "bad_asset"


def test_fetched_image_is_thumbnailed_like_jax(hostile_server):
    """A size smaller than the image thumbnails it (LANCZOS), as in JAX."""
    url = f"{hostile_server}/ok.png"
    got, ref = targs.get_image(url, (16, 24)), jargs.get_image(url, (16, 24))
    assert got.size == ref.size == (16, 16)
    assert got.tobytes() == ref.tobytes()


@pytest.fixture(scope="module")
def local_png(tmp_path_factory):
    """An image file on this host's disk, a fetch must never read it."""
    path = tmp_path_factory.mktemp("assets") / "photo.png"
    path.write_bytes(_OK_PNG)
    return path


@pytest.mark.parametrize("form", ["file", "file-localhost", "ftp", "data",
                                  "no-scheme"])
def test_only_http_and_https_are_fetched(local_png, form):
    """A non-http URL is refused before any read, of the kind the JAX
    package's ``requests`` gives it (its ``InvalidSchema``/``MissingSchema``
    are ``OSError``s: ``transient``)."""
    url = {"file": local_png.as_uri(),
           "file-localhost": f"file://localhost{local_png}",
           "ftp": "ftp://127.0.0.1:1/photo.png",
           "data": "data:image/png;base64,"
                   + base64.b64encode(_OK_PNG).decode(),
           "no-scheme": "127.0.0.1:1/photo.png"}[form]
    for fetch, args in ((targs.get_image, (url, None)),
                        (targs.download_image, (url,))):
        t_kind, t_exc = _kind("torch", fetch, *args)
        j_kind, j_exc = _kind("jax", getattr(jargs, fetch.__name__), *args)
        assert isinstance(t_exc, targs.InvalidSchema), (fetch, t_exc)
        assert isinstance(j_exc, (requests.exceptions.InvalidSchema,
                                  requests.exceptions.MissingSchema,
                                  requests.exceptions.InvalidURL)), j_exc
        assert t_kind == j_kind == "transient", (t_kind, j_kind)


def test_redirect_to_a_local_file_is_refused(hostile_server, local_png,
                                             monkeypatch):
    """A clean HEAD, then a GET redirected to ``file:``: both packages
    refuse to follow it, with the same kind."""
    monkeypatch.setattr(_Handler, "redirect_to", local_png.as_uri())
    url = f"{hostile_server}/to-file.png"
    t_kind, t_exc = _kind("torch", targs.get_image, url, None)
    j_kind, j_exc = _kind("jax", jargs.get_image, url, None)
    assert isinstance(t_exc, targs.InvalidSchema), t_exc
    assert isinstance(j_exc, requests.exceptions.InvalidSchema), j_exc
    assert t_kind == j_kind == "transient"
