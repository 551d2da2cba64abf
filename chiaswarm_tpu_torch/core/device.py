"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU. No code
path moves to the CPU because it found no GPU: asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device that is not available raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run chiaswarm_tpu_torch on the CPU")
    return dev


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """CPU tensor ``t`` on ``device``, without waiting on the device's queue:
    to a card it is copied from pinned memory, queued on the current stream
    (PyTorch's pinned-memory cache keeps the buffer until the copy has run).
    A plain ``.to(device)`` from pageable memory would wait for every kernel
    queued before it, which stalls a thread that prepares work while another
    keeps the card busy. A pageable ``t`` is copied before this returns, on
    the CPU too, so the caller may mutate it at once."""
    if torch.device(device).type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)
