"""Textual inversion, counterpart of
``chiaswarm_tpu/convert/textual_inversion.py`` (``_read_raw``,
``pick_adapter_file``, ``load_embeddings``, ``apply_textual_inversion``).

The reference calls ``pipeline.load_textual_inversion(name)`` per job and
treats an incompatible embedding as fatal (a ``ValueError``, so the hive
stops retrying). Here, as in the JAX package, the learned vectors are
appended once, at load, as new rows of the text towers' private
token-embedding tables, and the placeholder registers with each tower's
tokenizer (``models/tokenizer.py::AddedTokenMixin``); a vector set of n rows
gives the token n ids. The registry builds such a pipeline from its own
``Components``, never from the base model's.

Formats: the diffusers ``learned_embeds`` dict ``{"<token>": (D,) | (n, D)}``
and the A1111 ``.pt`` layout ``{"string_to_param": {"*": tensor}, "name":
...}``. Safetensors files are read through ``convert/safetensors_io.py``
(no ``safetensors`` package), pickles through ``torch.load(weights_only=
True)``.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from chiaswarm_tpu_torch.convert.safetensors_io import SafetensorsFile

log = logging.getLogger("chiaswarm_torch.textual_inversion")


def _read_raw(path: Path) -> Mapping[str, Any]:
    """One adapter file's entries; an A1111 ``.pt`` carries nested dicts
    and strings beside its tensors."""
    if path.suffix == ".safetensors":
        return dict(SafetensorsFile(path).tensors())
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _to_tensor(t: Any) -> torch.Tensor:
    """A float32 CPU tensor of ``t`` (a tensor or an array)."""
    if isinstance(t, np.ndarray):
        return torch.from_numpy(np.asarray(t, np.float32).copy())
    return t.detach().to("cpu", torch.float32)


def pick_adapter_file(path: str | Path, what: str) -> Path:
    """A file-or-directory adapter path -> one weights file: safetensors
    first, then ``.bin``/``.pt`` by name. A directory with none raises
    ``ValueError`` (fatal). Shared with ``convert/lora.py``."""
    path = Path(path)
    if not path.is_dir():
        return path
    files = (sorted(path.glob("*.safetensors"))
             or sorted(list(path.glob("*.bin")) + list(path.glob("*.pt"))))
    if not files:
        raise ValueError(f"no {what} files under {path}")
    return files[0]


def load_embeddings(path: str | Path) -> dict[str, torch.Tensor]:
    """A textual-inversion file or directory -> ``{token: (n, D)}`` float32.
    A malformed file raises ``ValueError`` (fatal)."""
    path = pick_adapter_file(path, "embedding")
    try:
        state = _read_raw(path)
    except Exception as exc:
        raise ValueError(f"unreadable textual inversion {path}: {exc}")

    if "string_to_param" in state:  # A1111 .pt layout
        token = str(state.get("name", "<concept>"))
        tensor = _to_tensor(list(state["string_to_param"].values())[0])
        return {token: torch.atleast_2d(tensor)}

    out: dict[str, torch.Tensor] = {}
    for token, tensor in state.items():
        if token.startswith("string_to_") or isinstance(
                tensor, (str, dict, int, float)):
            continue
        vectors = _to_tensor(tensor)
        if vectors.ndim in (1, 2):
            out[token] = torch.atleast_2d(vectors)
    if not out:
        raise ValueError(f"no embeddings found in {path}")
    return out


@torch.no_grad()
def apply_textual_inversion(components, embeddings: Mapping[str, Any]
                            ) -> list[str]:
    """Append each token's rows to every text tower's token-embedding
    table and register the token with that tower's tokenizer (one id per
    vector). Mutates ``components`` in place: the caller owns a private
    bundle. A vector width other than a tower's is a ``ValueError``
    (fatal), as in the reference. Returns the tokens added."""
    added: list[str] = []
    for token, vectors in embeddings.items():
        vectors = torch.atleast_2d(_to_tensor(vectors))
        for i, te in enumerate(components.text_encoders):
            emb = te.text_model.embeddings
            table = emb.token_embedding.weight
            if vectors.shape[1] != table.shape[1]:
                raise ValueError(
                    f"textual inversion {token!r} has dimension "
                    f"{vectors.shape[1]}, but the text encoder embeds at "
                    f"{table.shape[1]} — incompatible with this model")
            start = table.shape[0]
            grown = nn.Embedding(start + vectors.shape[0], table.shape[1],
                                 device=table.device, dtype=table.dtype)
            grown.weight.copy_(torch.cat(
                [table, vectors.to(table.device, table.dtype)]))
            grown.requires_grad_(False)
            emb.token_embedding = grown
            te.config = dataclasses.replace(te.config,
                                            vocab_size=grown.num_embeddings)
            components.tokenizers[i].add_token(
                token, list(range(start, grown.num_embeddings)))
        added.append(token)
        log.info("textual inversion %r registered (%d vector(s))",
                 token, vectors.shape[0])
    return added
