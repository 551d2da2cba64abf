"""int8 weights (``CHIASWARM_WEIGHTS=int8``) and activation fake-quant
(``CHIASWARM_ACTIVATIONS=int8|fp8``), a copy of
``chiaswarm_tpu/convert/quantize.py`` in PyTorch idiom.

Weights. A big float leaf (ndim >= 2 and at least :data:`MIN_QUANT_SIZE`
elements) is stored as int8 codes in [-127, 127] plus one float32 scale per
output channel (absmax over every other axis / 127, round half to even) and
dequantized AT USE into its original dtype (``q * scale``, then the cast, as
``Int8Param.dequantize``). Here a quantized leaf is a parametrization of the
module attribute that held it (:class:`Int8Weight`, registered with
``torch.nn.utils.parametrize``): the module keeps its codes and scales as
``parametrizations.<name>.original0`` / ``original1`` and every read of
``module.<name>`` dequantizes, so the forward code is unchanged and the
bytes the card holds are the int8 ones. The cost is the dequant launches of
every read, one product and one cast a leaf (``PERF.md``).

The scale axis follows the JAX twin of each leaf, not the torch layout: JAX
scales per LAST axis of its Flax leaf. Dense kernels ``(in, out)`` and NHWC
convs ``(kh, kw, in, out)`` become torch's ``(out, in)`` and ``(out, in, kh,
kw)`` (``convert/from_jax.py`` transposes them), so their output channel is
axis 0 here; embedding tables keep JAX's ``(vocab, dim)``, so their scale runs
along the embedding dim, the last axis here too (:func:`jax_last_axis`).

Scope as in JAX: diffusion families (``kind == "sd"``) and their ControlNet
bundles, after every adapter merge and before placement
(``node/registry.py``); a placement over more than one device declines with
JAX's warning.

Activations. :func:`fake_quant_activation` quantizes one tensor per tensor
(absmax of the live values in float32) and dequantizes back into its dtype:
int8 onto [-127, 127], fp8 through ``torch.float8_e4m3fn`` with the absmax
at 448. ``ops/attention.py`` applies it to q, k and v before any route, the
solo program to the text context once and the UNet input each step
(``pipelines/diffusion.py``), as JAX does. fp8 degrades to int8 with one
warning where :func:`fp8_supported` is false.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Iterable

import torch
from torch import nn
from torch.nn.utils import parametrize

log = logging.getLogger("chiaswarm_torch.quantize")

ENV_WEIGHTS = "CHIASWARM_WEIGHTS"
ENV_ACTIVATIONS = "CHIASWARM_ACTIVATIONS"

#: leaves smaller than this many elements stay float (biases, norms)
MIN_QUANT_SIZE = 4096

#: int8 symmetric code range and the float8_e4m3fn finite max
_INT8_MAX = 127.0
_FP8_E4M3_MAX = 448.0

_warned_fp8 = False


def weights_format() -> str:
    """Serving weight format: ``bf16`` (the default) or ``int8``."""
    raw = os.environ.get(ENV_WEIGHTS, "").strip().lower()
    return raw or "bf16"


def int8_enabled() -> bool:
    return weights_format() == "int8"


def bytes_per_param() -> int:
    """Planning density for footprint estimates: 1 byte a parameter under
    int8 (scales are negligible), else bf16's 2."""
    return 1 if int8_enabled() else 2


def fp8_supported() -> bool:
    """The copy of JAX's ``core/compat.py::fp8_supported`` (:251-268): the
    dtype exists, and where a card is visible it has fp8 units (compute
    capability 8.9 or later). The CPU counts as supported: its casts are
    emulated, which is what the parity tests need."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    if torch.cuda.is_available():
        return torch.cuda.get_device_capability() >= (8, 9)
    return True


def activations_format() -> str:
    """Activation precision: ``off`` (the default), ``int8`` or ``fp8``.
    fp8 degrades to int8 (one warning) where :func:`fp8_supported` is
    false; an unknown value is off, with a warning."""
    global _warned_fp8
    raw = os.environ.get(ENV_ACTIVATIONS, "").strip().lower()
    if raw in ("", "0", "off", "none", "bf16", "fp32"):
        return "off"
    if raw == "fp8":
        if not fp8_supported():
            if not _warned_fp8:
                _warned_fp8 = True
                log.warning(
                    "%s=fp8 requested but this backend has no fp8 "
                    "support (compat.fp8_supported() is False); "
                    "degrading to int8 activations", ENV_ACTIVATIONS)
            return "int8"
        return "fp8"
    if raw == "int8":
        return "int8"
    log.warning("%s=%r not understood (off|int8|fp8); activations stay fp",
                ENV_ACTIVATIONS, raw)
    return "off"


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device: PyTorch's CUDA
    kernel multiplies by the reciprocal of a Python scalar divisor, one bit
    off the CPU's (and XLA's) division, so the divisor rides as a tensor."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def fake_quant_activation(x: Any, fmt: str | None = None,
                          tag: str | None = None) -> Any:
    """Per-tensor dynamic-absmax quantize and dequantize of one activation,
    back in its dtype. Identity when the knob is off or ``x`` is not a
    float tensor. ``fmt`` overrides the environment (the callers read it
    once per call site). With ``tag``, the numerics probe ``act.<tag>``
    records the dequantized tensor (JAX ``:150-155``)."""
    fmt = activations_format() if fmt is None else fmt
    if fmt == "off" or not isinstance(x, torch.Tensor) \
            or not x.is_floating_point():
        return x
    xf = x.float()
    absmax = xf.abs().max()
    if fmt == "int8":
        scale = _div(absmax.clamp_min(1e-12), _INT8_MAX)
        q = torch.clamp(torch.round(xf / scale), -_INT8_MAX, _INT8_MAX)
        out = (q.to(torch.int8).float() * scale).to(x.dtype)
    else:
        scale = _div(absmax.clamp_min(1e-12), _FP8_E4M3_MAX)
        out = ((xf / scale).to(torch.float8_e4m3fn).float()
               * scale).to(x.dtype)
    if tag is not None:
        from chiaswarm_tpu_torch.obs import numerics as _numerics

        if _numerics.enabled_for("act"):
            out = _numerics.tap(f"act.{tag}", out)
    return out


# ---------------------------------------------------------------- weights


def jax_last_axis(module: nn.Module) -> int:
    """The torch axis of a module's ``weight`` that is the LAST axis of its
    JAX twin's leaf: the embedding dim of a table, else the output
    channel."""
    return -1 if isinstance(module, nn.Embedding) else 0


def quantize_leaf(w: torch.Tensor, axis: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """One weight -> (int8 codes, float32 scales keeping dims), scaled per
    index of ``axis`` (the JAX leaf's last axis in this layout); None for a
    leaf that stays float (not floating, ndim < 2, or below
    :data:`MIN_QUANT_SIZE`). |dequant - w| <= scale / 2 elementwise."""
    if not _big_float(w):
        return None
    axis = axis % w.ndim
    wf = w.detach().float()
    others = tuple(d for d in range(w.ndim) if d != axis)
    absmax = wf.abs().amax(dim=others, keepdim=True)
    scale = _div(absmax.clamp_min(1e-12), _INT8_MAX)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


class Int8Weight(nn.Module):
    """The parametrization of one quantized leaf: ``right_inverse`` stores
    the codes and scales, ``forward`` dequantizes them into ``dtype``."""

    def __init__(self, axis: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.axis = axis
        self.dtype = dtype

    def forward(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        # int8 x float32 promotes to float32 exactly: q.float() * scale
        return (q * scale).to(self.dtype)

    def right_inverse(self, w: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        q, scale = quantize_leaf(w, self.axis)
        return q, scale


def _big_float(p: torch.Tensor) -> bool:
    return p.is_floating_point() and p.ndim >= 2 and \
        p.numel() >= MIN_QUANT_SIZE


def _quantizable(module: nn.Module) -> Iterable[tuple[nn.Module, str, int]]:
    """(owner module, attribute, axis) for every leaf that quantizes."""
    for m in module.modules():
        if isinstance(m, parametrize.ParametrizationList):
            continue
        for name, p in list(m.named_parameters(recurse=False)):
            if _big_float(p):
                yield m, name, jax_last_axis(m)


@torch.no_grad()
def quantize_module_(module: nn.Module) -> int:
    """Quantize every big float leaf of ``module`` in place; returns how
    many leaves it quantized."""
    n = 0
    for owner, name, axis in list(_quantizable(module)):
        p = getattr(owner, name)
        p.requires_grad_(False)
        parametrize.register_parametrization(
            owner, name, Int8Weight(axis, p.dtype), unsafe=True)
        n += 1
    return n


def int8_leaves(module: nn.Module) -> dict[str, tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """``{"<module path>.<attr>": (codes, scales)}`` of every quantized
    leaf under ``module``."""
    out = {}
    for path, m in module.named_modules():
        if not parametrize.is_parametrized(m):
            continue
        for name, plist in m.parametrizations.items():
            if any(isinstance(p, Int8Weight) for p in plist):
                key = f"{path}.{name}" if path else name
                out[key] = (plist.original0, plist.original1)
    return out


def quantized_leaf_count(modules: nn.Module | Iterable[nn.Module]) -> int:
    if isinstance(modules, nn.Module):
        modules = [modules]
    return sum(len(int8_leaves(m)) for m in modules)


def _mesh_devices(mesh: Any) -> int:
    return 1 if mesh is None else len(mesh.device_list)


def int8_wanted(family: Any, mesh: Any = None) -> bool:
    """Does a load of ``family`` for a slot of ``mesh`` take int8 weights?
    ``CHIASWARM_WEIGHTS=int8``, a diffusion (``"sd"``) family, one device
    (JAX :572-573). The registry keys its ledger entries by it."""
    return (int8_enabled() and getattr(family, "kind", "sd") == "sd"
            and _mesh_devices(mesh) <= 1)


def maybe_quantize_(modules: Iterable[nn.Module], *, family: Any = None,
                    mesh: Any = None) -> int:
    """The registry's load-time gate (JAX ``maybe_quantize_params``):
    quantize ``modules`` in place when :func:`int8_wanted`; a placement over
    several devices declines with JAX's warning. Returns the number of
    quantized leaves (0 when it declines)."""
    if not int8_wanted(family, mesh):
        if int8_enabled() and _mesh_devices(mesh) > 1:
            log.warning("CHIASWARM_WEIGHTS=int8 skipped for a %d-chip "
                        "placement (sharding specs are fp-tree-shaped); "
                        "params stay %s", _mesh_devices(mesh), "bf16/fp32")
        return 0
    n = sum(quantize_module_(m) for m in modules)
    log.info("quantized %d weight leaves to int8 scale-per-channel", n)
    return n
