"""Tokenizers: a copy of ``chiaswarm_tpu/models/tokenizer.py``.

- :class:`Tokenizer` protocol and :class:`AddedTokenMixin` (:35-62, the
  placeholder registry textual inversion fills);
- :class:`ClipBpeTokenizer` (:76-156), CLIP byte-pair encoding over a
  checkpoint's ``vocab.json`` + ``merges.txt``, sharing its file reader
  and merge loop with the byte-level class (``_BpeTokenizer``);
- :class:`ByteLevelBpeTokenizer` (:159-275), GPT-2/RoBERTa byte-level BPE
  over the same file names, AudioLDM's CLAP tokenizer;
- :class:`HashTokenizer` (:278-337), the deterministic vocab-file-free
  tokenizer of random-weight models, with the specials of CLIP (BOS =
  EOS - 1, padding with EOS), of a RoBERTa tower (its own BOS and pad) or
  of T5 (``add_bos=False``, padding with id 0);
- :class:`HFTokenizer` (:339-365), a serialized HuggingFace
  ``tokenizer.json`` (the T5 snapshots of the DeepFloyd cascade) through
  the ``tokenizers`` package, padded and cut to a static length;
- :func:`load_tokenizer` (:368-408), which tells a byte-level vocab from
  CLIP's by its pieces (:func:`_vocab_is_byte_level`) and reads a
  ``tokenizer.json`` when no vocab files are found;
- :class:`WordPieceTokenizer` (:411-491), BERT WordPiece over a
  ``vocab.txt``, which also decodes: BLIP's captions come back as ids.

The ids are the JAX package's for the same text and files, so a prompt
conditions both backends identically. Where the ``tokenizers`` package is
not installed, a snapshot whose only tokenizer is a ``tokenizer.json``
raises ``ModelUnavailable`` naming the package (the executor's non-fatal
``model_unavailable`` kind): a real checkpoint's prompts are never hashed.
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


class _BpeTokenizer(AddedTokenMixin):
    """What CLIP's and the byte-level BPE share: the ``vocab.json`` +
    ``merges.txt`` reader, the rank-ordered merge loop and the batch
    encode. ``end_of_word`` is the suffix the last symbol of a word
    carries before merging (CLIP's ``</w>``; none for byte-level BPE)."""

    end_of_word = ""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77) -> None:
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_length = max_length
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_dir(cls, path: str | Path, max_length: int = 77):
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
        word = list(token[:-1]) + [token[-1] + self.end_of_word]
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

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(t) for t in texts], dtype=np.int32)


class ClipBpeTokenizer(_BpeTokenizer):
    """CLIP BPE over ``vocab.json``/``merges.txt`` (openai/clip format).

    ASCII-oriented pre-tokenization (the CLIP regex's unicode classes
    reduced to ASCII letter/digit classes); non-ASCII characters fall
    through as single-symbol tokens and map to byte-level entries when the
    vocab has them.
    """

    end_of_word = "</w>"

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77) -> None:
        super().__init__(vocab, merges, max_length)
        self.bos_id = vocab.get("<|startoftext|>", 49406)
        self.eos_id = vocab.get("<|endoftext|>", 49407)

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


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table (the byte-level
    BPE alphabet RoBERTa-family vocab.json files are written in)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# the GPT-2/RoBERTa pre-tokenization pattern: unicode letter and number
# classes through the ``regex`` package, and the JAX package's ``re``
# approximation where it is missing
try:
    import regex as _regex

    _GPT2_WORD_RE = _regex.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
        r"|\s+(?!\S)|\s+"
    )
except ImportError:  # pragma: no cover
    _GPT2_WORD_RE = re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"
        r"|\s+(?!\S)|\s+"
    )


class ByteLevelBpeTokenizer(_BpeTokenizer):
    """GPT-2/RoBERTa byte-level BPE over ``vocab.json``/``merges.txt`` (the
    CLAP tower's RobertaTokenizer): case-sensitive, bytes mapped through the
    GPT-2 unicode table, the space carried as a leading ``Ġ`` on a piece,
    RoBERTa's ``<s>``/``</s>``/``<pad>`` specials; unknown pieces map to
    ``<unk>``."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77) -> None:
        super().__init__(vocab, merges, max_length)
        self.byte_map = _bytes_to_unicode()
        self.bos_id = vocab.get("<s>", vocab.get("<|endoftext|>", 0))
        self.eos_id = vocab.get("</s>", vocab.get("<|endoftext|>", 2))
        self.pad_id = vocab.get("<pad>", 1)
        self.unk_id = vocab.get("<unk>", self.eos_id)

    def encode(self, text: str) -> list[int]:
        ids = [self.bos_id]
        for span in self._split_added(text):
            if isinstance(span, list):  # textual-inversion placeholder run
                ids.extend(span)
                continue
            for tok in _GPT2_WORD_RE.findall(span):
                mapped = "".join(self.byte_map[b] for b in
                                 tok.encode("utf-8"))
                for piece in self._bpe(mapped):
                    ids.append(self.vocab.get(piece, self.unk_id))
                if len(ids) >= self.max_length - 1:
                    break
            if len(ids) >= self.max_length - 1:
                break
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_id)
        ids += [self.pad_id] * (self.max_length - len(ids))
        return ids


class HashTokenizer(AddedTokenMixin):
    """Deterministic, vocab-file-free tokenizer for random-weight models.
    CLIP's convention by default (BOS = EOS - 1, padding with EOS); a
    RoBERTa-family tower (CLAP) passes its own ``bos_id`` and ``pad_id``;
    T5 passes ``add_bos=False`` and ``pad_id=0``."""

    def __init__(self, vocab_size: int = 1000, max_length: int = 77,
                 eos_id: int | None = None, bos_id: int | None = None,
                 pad_id: int | None = None, add_bos: bool = True) -> None:
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.eos_id = eos_id if eos_id is not None else vocab_size - 1
        self.bos_id = bos_id if bos_id is not None else self.eos_id - 1
        self.pad_id = pad_id if pad_id is not None else self.eos_id
        self.add_bos = add_bos
        # hashed ids never collide with the specials: masks and pooled
        # readouts are derived from exact id equality. Specials sit at the
        # bottom (CLAP 0/1/2) or the top (CLIP) of the vocab; ids hash into
        # the range between them
        specials = {self.eos_id, self.bos_id, self.pad_id}
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
        """[bos +] tokenize() body (truncated) + eos, padded with pad_id."""
        head = [self.bos_id] if self.add_bos else []
        ids = head + self.tokenize(text)[: self.max_length - len(head) - 1]
        ids.append(self.eos_id)
        ids += [self.pad_id] * (self.max_length - len(ids))
        return ids[: self.max_length]

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(t) for t in texts], dtype=np.int32)


class HFTokenizer(AddedTokenMixin):
    """A serialized HuggingFace ``tokenizer.json`` through the ``tokenizers``
    package (imported here, so a node without it can still import this
    module): the tokenizer's own ids (its post-processor adds T5's EOS), cut
    and padded with ``pad_id`` to a static length."""

    def __init__(self, tokenizer_file: str | Path, max_length: int = 77,
                 pad_id: int = 0) -> None:
        try:
            from tokenizers import Tokenizer as _Tok
        except ImportError as exc:
            from chiaswarm_tpu_torch.serving.residency import ModelUnavailable

            raise ModelUnavailable(
                f"the tokenizer.json tokenizer at {tokenizer_file} is not "
                "available on this node (it needs the 'tokenizers' package, "
                "which is not installed)") from exc
        self._tok = _Tok.from_file(str(tokenizer_file))
        self.max_length = max_length
        self.pad_id = pad_id

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for span in self._split_added(text):
            if isinstance(span, list):  # textual-inversion placeholder run
                ids.extend(span)
            else:
                ids.extend(self._tok.encode(span).ids)
        ids = ids[: self.max_length]
        ids += [self.pad_id] * (self.max_length - len(ids))
        return ids

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
                   eos_id: int = 49407, max_length: int = 77,
                   bos_id: int | None = None,
                   pad_id: int | None = None,
                   add_bos: bool = True) -> Tokenizer:
    """:class:`ClipBpeTokenizer` or :class:`ByteLevelBpeTokenizer` when
    vocab files exist under the checkpoint (itself, ``tokenizer/`` or
    ``text_encoder/``), told apart by their pieces; then
    :class:`HFTokenizer` over a ``tokenizer.json`` (itself or
    ``tokenizer/``: the T5 snapshots); else :class:`HashTokenizer`.
    Falling back on a REAL checkpoint is loud: hash-bucketed ids next to
    loaded weights would condition on noise."""
    if checkpoint_dir is not None:
        path = Path(checkpoint_dir)
        for sub in ("", "tokenizer", "text_encoder"):
            cand = path / sub if sub else path
            if (cand / "vocab.json").exists() and (cand / "merges.txt").exists():
                if _vocab_is_byte_level(cand / "vocab.json"):
                    return ByteLevelBpeTokenizer.from_dir(cand, max_length)
                return ClipBpeTokenizer.from_dir(cand, max_length)
        for sub in ("", "tokenizer"):
            cand = (path / sub if sub else path) / "tokenizer.json"
            if cand.exists():
                return HFTokenizer(cand, max_length)
        if path.exists():
            logging.getLogger("chiaswarm_torch.tokenizer").warning(
                "checkpoint %s has no recognized tokenizer files "
                "(vocab.json+merges.txt or tokenizer.json); falling back to "
                "HashTokenizer — generations will NOT match the reference "
                "model", path)
    return HashTokenizer(vocab_size, max_length, eos_id, bos_id=bos_id,
                         pad_id=pad_id, add_bos=add_bos)


class WordPieceTokenizer:
    """BERT WordPiece over a ``vocab.txt`` (BLIP's text side): lowercase
    basic tokenization, greedy longest match with ``##`` continuation
    pieces. It also decodes: captions come back as ids. BLIP's ``[DEC]``
    and ``[ENC]`` are registered after a stock 30,522-line BERT vocab when
    the file lacks them."""

    def __init__(self, vocab: dict[str, int], max_length: int = 64) -> None:
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.max_length = max_length
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get("[UNK]", 100)
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        if "[DEC]" not in self.vocab:
            for extra in ("[DEC]", "[ENC]"):
                idx = len(self.vocab)
                self.vocab[extra] = idx
                self.ids_to_tokens[idx] = extra
        self.bos_id = self.vocab["[DEC]"]

    @classmethod
    def from_vocab_file(cls, path: str | Path,
                        max_length: int = 64) -> "WordPieceTokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, max_length)

    def _wordpiece(self, word: str) -> list[int]:
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _basic_tokens(text):
            ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """[CLS] tokens [SEP] + [PAD] fill, fixed length."""
        n = max_length or self.max_length
        ids = [self.cls_id] + self.tokenize(text)[: n - 2] + [self.sep_id]
        return ids + [self.pad_id] * (n - len(ids))

    def decode(self, ids: Sequence[int]) -> str:
        words: list[str] = []
        stop = {self.pad_id, self.cls_id, self.sep_id, self.bos_id}
        for i in ids:
            i = int(i)
            if i == self.sep_id:
                break
            if i in stop:
                continue
            tok = self.ids_to_tokens.get(i, "")
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(w for w in words if w)
