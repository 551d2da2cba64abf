"""LoRA adapters merged at load, counterpart of ``chiaswarm_tpu/convert/lora.py``
(``load_lora``, ``_collect_pairs``, ``merge_lora``).

The reference loads a per-job LoRA with ``unet.load_attn_procs`` and scales
it at run time (``cross_attention_kwargs={"scale": s}``). Here, as in the
JAX package, the scaled deltas merge into the UNet's projections once, when
the registry builds the adapter's own pipeline: W <- W + scale * (up @
down), on the port's ``nn.Linear`` layout (out, in) (JAX transposes for its
Flax kernels). Generation then runs the unmodified UNet, B1 included, and
each (adapter, scale) is a ledger entry of its own.

The merge runs in float32 on the host and casts the sum to the weight's
serving dtype before it goes back to the weight's device, as JAX merges
before it places the params: the card's weights equal the CPU merge bit for
bit, and a scale of 0 leaves every weight as it was.

Formats, matched on the UNet's diffusers names (a leading ``unet.`` is
dropped):

- diffusers attn-procs: ``<base>.processor.to_q_lora.down.weight`` / ``.up``;
- peft: ``<base>.to_q.lora_A.weight`` / ``lora_B`` (``to_out.0`` too);
- kohya-style halves: ``lora_down`` / ``lora_up``.

A file is read through ``convert/textual_inversion.py::pick_adapter_file``
and ``_read_raw``; an unreadable one, one without tensors, or one that
matches no projection raises ``ValueError`` (fatal). Unmatched pairs are
counted and logged, never dropped silently.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Mapping

import torch
from torch import nn

log = logging.getLogger("chiaswarm_torch.lora")


def load_lora(path: str | Path) -> dict[str, torch.Tensor]:
    """A LoRA adapter file or directory -> its tensors by key (float32,
    CPU); non-tensor entries are dropped."""
    from chiaswarm_tpu_torch.convert.textual_inversion import (
        _read_raw,
        _to_tensor,
        pick_adapter_file,
    )

    path = pick_adapter_file(path, "LoRA adapter")
    try:
        state = _read_raw(path)
    except Exception as exc:
        raise ValueError(f"unreadable LoRA adapter {path}: {exc}")
    out = {str(key): _to_tensor(tensor) for key, tensor in state.items()
           if not isinstance(tensor, (str, dict, int, float))}
    if not out:
        raise ValueError(f"LoRA adapter {path} contains no tensors")
    return out


_PAIR_RES = (
    # diffusers attn-procs
    re.compile(r"^(?P<base>.+)\.processor\.(?P<proj>to_q|to_k|to_v|to_out)"
               r"_lora\.(?P<half>down|up)\.weight$"),
    # peft and kohya-style halves
    re.compile(r"^(?P<base>.+)\.(?P<proj>to_q|to_k|to_v|to_out)(?:\.0)?"
               r"\.lora_(?P<half>A|B|down|up)\.weight$"),
)

_HALF_DOWN = {"down", "A"}


def _collect_pairs(state: Mapping[str, torch.Tensor]
                   ) -> dict[tuple[str, str], dict[str, torch.Tensor]]:
    """-> ``{(base, proj): {"down": (r, in), "up": (out, r)}}``."""
    pairs: dict[tuple[str, str], dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        clean = key[5:] if key.startswith("unet.") else key
        for pattern in _PAIR_RES:
            m = pattern.match(clean)
            if m:
                half = "down" if m.group("half") in _HALF_DOWN else "up"
                pairs.setdefault((m.group("base"), m.group("proj")), {})[
                    half] = value.to(torch.float32)
                break
    return pairs


@torch.no_grad()
def merge_lora(unet: nn.Module, lora_state: Mapping[str, torch.Tensor],
               scale: float = 1.0) -> int:
    """Merge ``scale * (up @ down)`` into each matched projection of
    ``unet`` in place (float32 on the host, cast to the weight's dtype).
    Returns the number of projections merged; raises ``ValueError`` when
    none matched."""
    weights = dict(unet.named_parameters())
    merged = 0
    missed = []
    for (base, proj), halves in _collect_pairs(lora_state).items():
        if "down" not in halves or "up" not in halves:
            missed.append(base)
            continue
        name = f"{base}.{proj}{'.0' if proj == 'to_out' else ''}.weight"
        weight = weights.get(name)
        down, up = halves["down"], halves["up"]
        if weight is None or weight.shape != (up.shape[0], down.shape[1]):
            missed.append(f"{base}.{proj}")
            continue
        host = weight.detach().to("cpu", torch.float32)
        weight.copy_((host + (up @ down) * float(scale)).to(weight.dtype))
        merged += 1
    if missed:
        log.warning("lora: %d projections did not match the unet (e.g. %s)",
                    len(missed), missed[0])
    if merged == 0:
        raise ValueError("LoRA file matched no UNet projections "
                         "(incompatible adapter)")
    return merged
