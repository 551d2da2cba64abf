"""Job routing, argument normalization and the guarded input-image fetch:
counterpart of ``chiaswarm_tpu/node/job_args.py`` (``format_args`` :53-112,
``_format_audio_args`` :127-135, ``_format_txt2vid_args`` :138-146,
:149-205; ``get_image``/``download_image`` and their guards :32-48,
:205-305).

A hive job dict maps to ``(callback, kwargs)``, as in the JAX package:

- ``stitch`` goes to ``workloads/stitch.py::stitch_callback``;
- ``img2txt`` fetches ``start_image_uri`` through the guarded
  :func:`get_image` into ``image`` (an array) and goes to
  ``workloads/caption.py::caption_callback``;
- ``txt2audio`` with a TTS model name (``pipelines/tts.py::
  is_tts_model``, the one copy of the gate) goes to
  ``workloads/audio.py::tts_callback`` with its arguments as they are
  (JAX :61-68); any other model to ``txt2audio_callback`` through
  :func:`_format_audio_args`: 20 steps unless the job names a count,
  ``scheduler_type`` from the ``parameters`` block, server-listed
  unsupported arguments stripped;
- ``vid2vid`` goes to ``workloads/video.py::vid2vid_callback`` with its
  arguments as they are; ``txt2vid`` to ``txt2vid_callback`` through
  :func:`_format_txt2vid_args` (25 steps unless the job names a count,
  ``num_images_per_prompt`` dropped, ``scheduler_type`` from the
  ``parameters`` block, server-listed unsupported arguments stripped);
  ``img2vid`` to ``img2vid_callback`` with the same ``parameters``
  handling, ``prompt`` dropped (no text tower) and ``start_image_uri``
  fetched through :func:`get_image` into ``image`` (JAX :85-105, :138-146);
- ``DeepFloyd/`` models go to ``workloads/cascade.py::cascade_callback``
  with their arguments as they are (JAX :107-110);
- every other workflow (none, ``txt2img``, ``img2img``, ``inpaint``, any
  other name) goes to the stable-diffusion formatter: the 1024-pixel size
  cap, the server's ``parameters`` block unpacked (scheduler class name,
  ``upscale``, ``reuse_schedule``), default steps, server-listed
  unsupported arguments stripped, and the input images
  (``start_image_uri``, ``mask_image_uri``) fetched into ``image`` and
  ``mask_image``. A ``parameters.controlnet`` block (JAX :163-176) makes the
  job a ControlNet job: ``controlnet_model_name`` (default
  ``lllyasviel/control_v11p_sd15_canny``), ``save_preprocessed_input`` from
  its ``preprocess`` flag, and the fetched image through
  ``workloads/controlnet.py::preprocess_image`` (off unless the job asks),
  any detector on the registry's device, the slot's card.
  A ``timbrooks/instruct-pix2pix`` job with an input image conditions on
  ``image_guidance_scale`` = strength x 5 (strength defaults to 0.6 and is
  dropped), JAX :177-180. ``lora``, ``cross_attention_scale`` and
  ``textual_inversion`` ride through as job arguments.

A refusal is a ``ValueError``, which the executor turns into a fatal
bad-request envelope, as it does for any malformed job.

The fetch crosses an open-network trust boundary: HEAD, then a streamed GET
with connect and read timeouts, the content type checked on both, the body
cut off past :data:`MAX_IMAGE_BYTES` whatever its Content-Length claimed,
the decoded dimensions capped at :data:`MAX_IMAGE_PIXELS` before any pixel
is decoded (a decompression bomb), EXIF orientation applied and the image
thumbnailed to the requested or the maximum size. A guard violation raises
``BadAssetError`` (a non-fatal ``bad_asset`` envelope); network faults
classify ``transient`` (``node/resilience.py``). The JAX package fetches
with ``requests``; the port uses the standard library's ``urllib.request``,
since the card's machine does not promise ``requests``. Only http and https
are fetched, redirects included: ``requests`` has no adapter for any other
scheme, and ``urllib``'s defaults would read ``file:``, ``ftp:`` and
``data:`` URLs (a job could have the worker upload a near copy of a file on
the node's disk). Any other scheme, or none, raises :class:`InvalidSchema`,
an ``OSError`` as ``requests``' own is, so it classifies as in the JAX
package.
"""

from __future__ import annotations

import functools
import http.client
import io
import ssl
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable

import numpy as np
from PIL import Image, ImageOps

from chiaswarm_tpu_torch.node.resilience import BadAssetError

MAX_SIZE = 1024
MAX_IMAGE_BYTES = 3 * 1048576   # the input cap
DEFAULT_STEPS = 30
CONNECT_TIMEOUT_S = 10.0
READ_TIMEOUT_S = 60.0
HEAD_READ_TIMEOUT_S = 30.0
MAX_IMAGE_PIXELS = 16 * 1024 * 1024  # 16 Mpx; the served maximum is ~1 Mpx

FormatResult = tuple[Callable[..., tuple[dict, dict]], dict[str, Any]]


def format_args(job: dict[str, Any], registry) -> FormatResult:
    """Route one hive job. Raises on malformed or unserved input."""
    args = dict(job)
    args["registry"] = registry
    workflow = args.pop("workflow", None)

    if workflow == "txt2audio":
        from chiaswarm_tpu_torch.pipelines.tts import is_tts_model
        from chiaswarm_tpu_torch.workloads.audio import tts_callback

        if is_tts_model(str(args.get("model_name", ""))):
            return tts_callback, args
        return _format_audio_args(args)

    if workflow == "stitch":
        from chiaswarm_tpu_torch.workloads.stitch import stitch_callback

        return stitch_callback, args

    if workflow == "img2txt":
        from chiaswarm_tpu_torch.workloads.caption import caption_callback

        if "start_image_uri" in args:
            args["image"] = np.asarray(
                get_image(args.pop("start_image_uri"), None))
        return caption_callback, args

    if workflow == "vid2vid":
        from chiaswarm_tpu_torch.workloads.video import vid2vid_callback

        return vid2vid_callback, args

    if workflow == "img2vid":
        from chiaswarm_tpu_torch.workloads.video import img2vid_callback

        parameters = _pop_parameters(args)
        args.pop("prompt", None)  # image-conditioned: no text tower
        args["scheduler_type"] = parameters.pop("scheduler_type", None)
        _strip_unsupported(args, parameters)
        if "start_image_uri" in args:
            args["image"] = np.asarray(
                get_image(args.pop("start_image_uri"), None))
        return img2vid_callback, args

    if workflow == "txt2vid":
        return _format_txt2vid_args(args)

    if str(args.get("model_name", "")).startswith("DeepFloyd/"):
        from chiaswarm_tpu_torch.workloads.cascade import cascade_callback

        return cascade_callback, args
    return _format_stable_diffusion_args(args)


def _pop_parameters(args: dict[str, Any]) -> dict[str, Any]:
    parameters = args.pop("parameters", {}) or {}
    args.setdefault("prompt", "")
    return parameters


def _strip_unsupported(args: dict[str, Any], parameters: dict[str, Any]) -> None:
    """Server-driven capability negotiation."""
    for name in parameters.get("unsupported_pipeline_arguments", []):
        args.pop(name, None)


def _format_audio_args(args: dict[str, Any]) -> FormatResult:
    from chiaswarm_tpu_torch.workloads.audio import txt2audio_callback

    parameters = _pop_parameters(args)
    # AudioLDM's default is 20 steps (swarm/audio/audioldm.py:15-16)
    args.setdefault("num_inference_steps", 20)
    args["scheduler_type"] = parameters.pop("scheduler_type", None)
    _strip_unsupported(args, parameters)
    return txt2audio_callback, args


def _format_txt2vid_args(args: dict[str, Any]) -> FormatResult:
    from chiaswarm_tpu_torch.workloads.video import txt2vid_callback

    parameters = _pop_parameters(args)
    args.setdefault("num_inference_steps", 25)
    args.pop("num_images_per_prompt", None)
    args["scheduler_type"] = parameters.pop("scheduler_type", None)
    _strip_unsupported(args, parameters)
    return txt2vid_callback, args


def _format_stable_diffusion_args(args: dict[str, Any]) -> FormatResult:
    from chiaswarm_tpu_torch.workloads.diffusion import diffusion_callback

    size = None
    if "height" in args and "width" in args:
        size = (int(args["height"]), int(args["width"]))
        if size[0] > MAX_SIZE or size[1] > MAX_SIZE:
            raise ValueError(
                f"The max image size is ({MAX_SIZE}, {MAX_SIZE}); "
                f"got ({size[0]}, {size[1]}).")

    parameters = _pop_parameters(args)
    args["upscale"] = parameters.get("upscale", False)

    if "start_image_uri" in args:
        args.pop("height", None)
        args.pop("width", None)
        controlnet = parameters.get("controlnet")
        image = get_image(args.pop("start_image_uri"), size)
        if controlnet is not None:
            from chiaswarm_tpu_torch.workloads.controlnet import (
                preprocess_image,
            )

            # a detector runs on the slot's card
            image = preprocess_image(image, controlnet,
                                     getattr(args["registry"], "device", None))
            args["controlnet_model_name"] = controlnet.get(
                "controlnet_model_name", "lllyasviel/control_v11p_sd15_canny")
            args["save_preprocessed_input"] = controlnet.get("preprocess",
                                                             False)
        args["image"] = np.asarray(image)
        if args.get("model_name") == "timbrooks/instruct-pix2pix":
            # pix2pix conditions on image guidance (1-5); the hive sends
            # strength (0-1), as swarm/job_arguments.py:128-131 remaps it
            args["image_guidance_scale"] = args.pop("strength", 0.6) * 5

    if "mask_image_uri" in args:
        args.pop("height", None)
        args.pop("width", None)
        args["mask_image"] = np.asarray(get_image(args.pop("mask_image_uri"),
                                                  size))

    args.setdefault("num_inference_steps", DEFAULT_STEPS)
    args["scheduler_type"] = parameters.pop("scheduler_type", None)
    reuse = parameters.pop("reuse_schedule", None)
    if reuse is not None:
        args["reuse_schedule"] = (tuple(reuse)
                                  if isinstance(reuse, (list, tuple))
                                  else reuse)
    _strip_unsupported(args, parameters)
    return diffusion_callback, args


# ---- the input-image fetch and its guards ---------------------------------

_SCHEMES = ("http", "https")


class InvalidSchema(OSError, ValueError):
    """An input-image URL (or a redirect) whose scheme is not http or
    https: refused before any request, as ``requests.InvalidSchema`` and
    ``requests.MissingSchema`` refuse it (both ``OSError`` and
    ``ValueError``, so ``classify_exception`` reads them alike)."""


def _check_scheme(url: str) -> None:
    scheme = urllib.parse.urlsplit(url).scheme.lower()
    if scheme not in _SCHEMES:
        raise InvalidSchema(f"No connection adapters were found for {url!r}"
                            " (only http and https images are fetched)")


def _connection(base: type, read_timeout_s: float) -> type:
    """``base`` with ``read_timeout_s`` on every read once connected
    (``urlopen``'s own timeout then bounds only the connect)."""

    class Connection(base):
        def connect(self) -> None:
            super().connect()
            self.sock.settimeout(read_timeout_s)

    return Connection


class _HTTPHandler(urllib.request.HTTPHandler):
    def __init__(self, read_timeout_s: float) -> None:
        super().__init__()
        self._conn = _connection(http.client.HTTPConnection, read_timeout_s)

    def http_open(self, req):
        return self.do_open(self._conn, req)


@functools.cache
def _tls_context() -> ssl.SSLContext:
    """One TLS context for every fetch: loading the system's certificates
    takes tens of milliseconds, too much to pay per request."""
    return ssl.create_default_context()


class _HTTPSHandler(urllib.request.HTTPSHandler):
    def __init__(self, read_timeout_s: float) -> None:
        super().__init__(context=_tls_context())
        self._conn = _connection(http.client.HTTPSConnection, read_timeout_s)

    def https_open(self, req):
        return self.do_open(self._conn, req, context=self._context)


class _RedirectHandler(urllib.request.HTTPRedirectHandler):
    """Redirects followed to http and https only; any other target raises
    :class:`InvalidSchema` (``urllib`` itself would follow one to ftp)."""

    def http_error_302(self, req, fp, code, msg, headers):
        target = headers.get("location") or headers.get("uri")
        if target is not None:
            try:
                _check_scheme(urllib.parse.urljoin(req.full_url, target))
            except InvalidSchema:
                fp.close()
                raise
        return super().http_error_302(req, fp, code, msg, headers)

    http_error_301 = http_error_303 = http_error_307 = http_error_302
    http_error_308 = http_error_302


def _open(url: str, method: str, read_timeout_s: float):
    """An open response (redirects followed; a 4xx or 5xx raises
    ``urllib.error.HTTPError``) with a connect timeout of
    :data:`CONNECT_TIMEOUT_S` and ``read_timeout_s`` on every read. The
    opener holds the http and https handlers and nothing that opens another
    scheme (``build_opener``'s defaults add file, ftp and data)."""
    _check_scheme(url)
    opener = urllib.request.OpenerDirector()
    for handler in (urllib.request.ProxyHandler(),
                    urllib.request.UnknownHandler(),
                    _HTTPHandler(read_timeout_s),
                    _HTTPSHandler(read_timeout_s),
                    urllib.request.HTTPDefaultErrorHandler(),
                    _RedirectHandler(),
                    urllib.request.HTTPErrorProcessor()):
        opener.add_handler(handler)
    return opener.open(urllib.request.Request(url, method=method),
                       timeout=CONNECT_TIMEOUT_S)


def _read_capped(response, cap: int) -> bytes:
    """Stream a response body up to ``cap`` bytes; one byte more is a
    :class:`BadAssetError`, raised before the body is buffered past the
    cap."""
    chunks: list[bytes] = []
    total = 0
    while True:
        chunk = response.read(65536)
        if not chunk:
            return b"".join(chunks)
        total += len(chunk)
        if total > cap:
            raise BadAssetError(
                f"Input image too large.\nMax size is {cap} bytes.\n"
                f"Stream exceeded the cap at {total} bytes.")
        chunks.append(chunk)


def _check_decoded_dims(image: Image.Image) -> None:
    """Decompression-bomb guard: PIL knows the claimed dimensions before it
    decodes a pixel, so the bomb is refused while it is still a few KB."""
    pixels = int(image.size[0]) * int(image.size[1])
    if pixels > MAX_IMAGE_PIXELS:
        raise BadAssetError(
            f"Input image decodes to {image.size[0]}x{image.size[1]} "
            f"({pixels} pixels), over the {MAX_IMAGE_PIXELS}-pixel cap "
            f"(decompression-bomb guard).")


def _check_content_type(content_type: str, allow_empty: bool) -> None:
    if (content_type or not allow_empty) and \
            not content_type.startswith("image"):
        raise BadAssetError("Input does not appear to be an image.\n"
                            f"Content type was {content_type}.")


def download_image(url: str, max_bytes: int = MAX_IMAGE_BYTES) -> Image.Image:
    """Guarded GET of an image: the GET's own content type checked (a host
    whose HEAD looked clean may switch), the body streamed and capped, the
    decoded dimensions capped, EXIF orientation applied; RGB."""
    with _open(url, "GET", READ_TIMEOUT_S) as response:
        _check_content_type(response.headers.get("Content-Type", ""),
                            allow_empty=True)
        data = _read_capped(response, max_bytes)
    image = Image.open(io.BytesIO(data))
    _check_decoded_dims(image)
    image = ImageOps.exif_transpose(image)
    return image.convert("RGB")


def get_image(uri: str, size: tuple[int, int] | None) -> Image.Image:
    """Fetch an input image behind the guards: a HEAD first (an image
    content type, a Content-Length within the cap), then
    :func:`download_image`, then a LANCZOS thumbnail down to ``size`` (H, W)
    or to :data:`MAX_SIZE`. (JAX's ``get_image`` also preprocesses a
    ControlNet job's image; the port's formatter does that after the fetch,
    with the slot's device.)"""
    try:
        head = _open(uri, "HEAD", HEAD_READ_TIMEOUT_S)
    except urllib.error.HTTPError as exc:
        # the HEAD's status is not checked, as in the JAX package: its
        # headers are (a 5xx or 4xx says so at the GET)
        head = exc
    with head:
        content_type = head.headers.get("Content-Type", "")
        content_length = int(head.headers.get("Content-Length", 0) or 0)
    _check_content_type(content_type, allow_empty=False)
    if content_length > MAX_IMAGE_BYTES:
        raise BadAssetError(
            f"Input image too large.\nMax size is {MAX_IMAGE_BYTES} bytes.\n"
            f"Image was {content_length}.")

    image = download_image(uri)
    if size is not None and (image.height > size[0] or image.width > size[1]):
        # PIL's thumbnail takes (max_width, max_height); size is (H, W)
        image.thumbnail((size[1], size[0]), Image.Resampling.LANCZOS)
    elif image.height > MAX_SIZE or image.width > MAX_SIZE:
        image.thumbnail((MAX_SIZE, MAX_SIZE), Image.Resampling.LANCZOS)
    return image
