"""Prompt tokenizers: a trimmed copy of ``chiaswarm_tpu/models/tokenizer.py``.

Kept: the :class:`Tokenizer` protocol, :class:`AddedTokenMixin` (:35-62,
the placeholder registry textual inversion will fill),
:class:`ClipBpeTokenizer` (:76-156, CLIP byte-pair encoding over a
checkpoint's ``vocab.json`` + ``merges.txt``), :class:`HashTokenizer`
(:284, the deterministic vocab-file-free tokenizer of random-weight
models, CLIP's specials: BOS = EOS - 1, padding with EOS) and
:func:`load_tokenizer` (:378-408). The byte-level BPE of the audio
families and the ``tokenizer.json`` wrapper of the T5 families wait for
those families: :func:`load_tokenizer` refuses their files. The ids are
the JAX package's for the same text and files, so a prompt conditions
both backends identically.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Protocol, Sequence

import numpy as np


class Tokenizer(Protocol):
    max_length: int

    def encode(self, text: str) -> list[int]: ...

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray: ...


class AddedTokenMixin:
    """Placeholder-token registry for textual inversion: a registered token
    string maps to one or more embedding ids (multi-vector concepts) and is
    extracted from the prompt before normal tokenization."""

    _added: dict[str, list[int]]

    def add_token(self, token: str, ids: list[int]) -> None:
        if not hasattr(self, "_added"):
            self._added = {}
        self._added[token] = list(ids)

    def _split_added(self, text: str) -> list[str | list[int]]:
        """Split the prompt into plain-text spans and added-token id runs."""
        if not getattr(self, "_added", None):
            return [text]
        pattern = "|".join(re.escape(t) for t in
                           sorted(self._added, key=len, reverse=True))
        parts: list[str | list[int]] = []
        pos = 0
        for m in re.finditer(pattern, text):
            if m.start() > pos:
                parts.append(text[pos:m.start()])
            parts.append(self._added[m.group(0)])
            pos = m.end()
        if pos < len(text):
            parts.append(text[pos:])
        return parts


_WORD_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+", re.IGNORECASE
)


def _basic_tokens(text: str) -> list[str]:
    text = re.sub(r"\s+", " ", text.strip().lower())
    return _WORD_RE.findall(text)


class ClipBpeTokenizer(AddedTokenMixin):
    """CLIP BPE over ``vocab.json``/``merges.txt`` (openai/clip format).

    ASCII-oriented pre-tokenization (the CLIP regex's unicode classes
    reduced to ASCII letter/digit classes); non-ASCII characters fall
    through as single-symbol tokens and map to byte-level entries when the
    vocab has them.
    """

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77) -> None:
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.bos_id = vocab.get("<|startoftext|>", 49406)
        self.eos_id = vocab.get("<|endoftext|>", 49407)
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_dir(cls, path: str | Path,
                 max_length: int = 77) -> "ClipBpeTokenizer":
        path = Path(path)
        with open(path / "vocab.json", encoding="utf-8") as fh:
            vocab = json.load(fh)
        merges: list[tuple[str, str]] = []
        with open(path / "merges.txt", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, max_length)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            a, b = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids = [self.bos_id]
        for span in self._split_added(text):
            if isinstance(span, list):  # textual-inversion placeholder run
                ids.extend(span)
            else:
                for tok in _basic_tokens(span):
                    for piece in self._bpe(tok):
                        pid = self.vocab.get(piece)
                        # drop unknown pieces: mapping them to eos would
                        # hijack the first-EOS pooled readout
                        if pid is not None:
                            ids.append(pid)
                    if len(ids) >= self.max_length - 1:
                        break
            if len(ids) >= self.max_length - 1:
                break
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_id)
        ids += [self.eos_id] * (self.max_length - len(ids))  # CLIP pads w/ eos
        return ids

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(t) for t in texts], dtype=np.int32)


class HashTokenizer(AddedTokenMixin):
    """Deterministic, vocab-file-free tokenizer for random-weight models."""

    def __init__(self, vocab_size: int = 1000, max_length: int = 77,
                 eos_id: int | None = None) -> None:
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.eos_id = eos_id if eos_id is not None else vocab_size - 1
        self.bos_id = self.eos_id - 1
        # hashed ids never collide with the specials: masks and pooled
        # readouts are derived from exact id equality
        specials = {self.eos_id, self.bos_id}
        self._lo = max((s + 1 for s in specials if s < vocab_size // 2),
                       default=0)
        self._hi = min((s for s in specials if s >= vocab_size // 2),
                       default=vocab_size)

    def tokenize(self, text: str) -> list[int]:
        """Raw hashed ids — no bos/eos/pad."""
        vspan = max(self._hi - self._lo, 1)
        ids: list[int] = []
        for part in self._split_added(text):
            if isinstance(part, list):
                ids.extend(part)
                continue
            for tok in _basic_tokens(part):
                # FNV-1a: platform-stable hashing (hash() is salted)
                h = 2166136261
                for ch in tok.encode("utf-8"):
                    h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
                ids.append(self._lo + h % vspan)
        return ids

    def encode(self, text: str) -> list[int]:
        """bos + tokenize() body (truncated) + eos, padded with eos."""
        ids = [self.bos_id] + self.tokenize(text)[: self.max_length - 2]
        ids.append(self.eos_id)
        ids += [self.eos_id] * (self.max_length - len(ids))
        return ids[: self.max_length]

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(t) for t in texts], dtype=np.int32)


def _vocab_is_byte_level(vocab_path: Path) -> bool:
    """vocab.json + merges.txt is both CLIP's format and GPT-2/RoBERTa's.
    CLIP vocabs mark word-final pieces with a ``</w>`` suffix; byte-level
    vocabs carry the space as a leading ``Ġ`` instead."""
    with open(vocab_path, encoding="utf-8") as fh:
        keys = json.load(fh).keys()
    return any(k.startswith("Ġ") for k in keys) and not any(
        k.endswith("</w>") for k in keys)


def load_tokenizer(checkpoint_dir: str | Path | None, vocab_size: int = 49408,
                   eos_id: int = 49407, max_length: int = 77) -> Tokenizer:
    """:class:`ClipBpeTokenizer` when CLIP vocab files exist under the
    checkpoint (itself, ``tokenizer/`` or ``text_encoder/``), else
    :class:`HashTokenizer`. Falling back on a REAL checkpoint is loud:
    hash-bucketed ids next to loaded weights would condition on noise.
    A byte-level vocab or a ``tokenizer.json`` (the audio and T5 families)
    raises, worded for the executor's non-fatal ``model_unavailable``
    kind: their tokenizers are not ported yet."""
    if checkpoint_dir is not None:
        path = Path(checkpoint_dir)
        for sub in ("", "tokenizer", "text_encoder"):
            cand = path / sub if sub else path
            if (cand / "vocab.json").exists() and (cand / "merges.txt").exists():
                if _vocab_is_byte_level(cand / "vocab.json"):
                    raise ValueError(
                        f"the byte-level BPE tokenizer of {cand} is not "
                        "available on this node (chiaswarm_tpu_torch does "
                        "not port it yet)")
                return ClipBpeTokenizer.from_dir(cand, max_length)
        for sub in ("", "tokenizer"):
            if ((path / sub if sub else path) / "tokenizer.json").exists():
                raise ValueError(
                    f"the tokenizer.json tokenizer of {path} is not "
                    "available on this node (chiaswarm_tpu_torch does not "
                    "port it yet)")
        if path.exists():
            logging.getLogger("chiaswarm_torch.tokenizer").warning(
                "checkpoint %s has no recognized tokenizer files "
                "(vocab.json+merges.txt or tokenizer.json); falling back to "
                "HashTokenizer — generations will NOT match the reference "
                "model", path)
    return HashTokenizer(vocab_size, max_length, eos_id)
