"""In-repo CLIP byte-level BPE tokenizer — no `transformers` dependency.

A copy of ``animate_anything_tpu/models/clip_tokenizer.py``, which imports
only the standard library and numpy; the PyTorch port carries its own so
that it never imports the JAX package.

The upstream training code tokenizes prompts with HF ``CLIPTokenizer``.
This module reimplements that tokenizer from its on-disk assets
(``vocab.json`` + ``merges.txt`` inside a checkpoint's ``tokenizer/`` dir) so
a deployment without ``transformers`` tokenizes real checkpoints correctly
instead of silently falling back to a hash vocab.

Algorithm (OpenAI CLIP ``SimpleTokenizer``, which HF wraps):
- clean: html-unescape twice, strip, collapse whitespace, lowercase;
- pre-tokenize with the CLIP regex (special tokens | contractions |
  letter-runs | single digits | punctuation-runs);
- byte-level encode each pre-token through the GPT-2 bytes↔unicode table;
- BPE with ``</w>`` appended to the last character of each word, merging the
  lowest-ranked pair from ``merges.txt`` until no ranked pair remains.

Interface matches what the rest of the repo (datasets, pipelines,
textual-inversion wrapper) already expects of a tokenizer: ``__call__``
returning ``.input_ids``, ``encode``/``decode``, ``model_max_length``,
``vocab_size``.
"""

from __future__ import annotations

import functools
import html
import json
import os

import numpy as np

try:  # regex ships as a transformers dependency; stdlib `re` lacks \p{L}
    import regex as _re

    _PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - the fallback scanner below
    _PATTERN = None

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _scan_fallback(text: str):
    """Manual scanner equivalent to the CLIP regex (used only if the `regex`
    package is unavailable; stdlib `re` cannot express \\p{L}/\\p{N})."""
    import unicodedata

    def cat(ch):
        return unicodedata.category(ch)[0]

    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        for sp in ("<|startoftext|>", "<|endoftext|>"):
            if text.startswith(sp, i):
                out.append(sp)
                i += len(sp)
                break
        else:
            for con in _CONTRACTIONS:
                if text.startswith(con, i):
                    out.append(con)
                    i += len(con)
                    break
            else:
                if cat(ch) == "L":
                    j = i + 1
                    while j < n and cat(text[j]) == "L":
                        j += 1
                    out.append(text[i:j])
                    i = j
                elif cat(ch) == "N":
                    out.append(ch)
                    i += 1
                else:
                    j = i + 1
                    while (j < n and not text[j].isspace()
                           and cat(text[j]) not in ("L", "N")
                           and not any(text.startswith(c, j) for c in _CONTRACTIONS)):
                        j += 1
                    out.append(text[i:j])
                    i = j
    return out


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2 byte↔printable-unicode bijection (the byte-level alphabet)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class CLIPBPETokenizer:
    """CLIP BPE tokenizer loaded from ``vocab.json`` + ``merges.txt``."""

    def __init__(self, vocab_file: str, merges_file: str,
                 model_max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if l and len(l.split()) == 2]
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.unk_token = "<|endoftext|>"
        self.pad_token = "<|endoftext|>"  # HF CLIPTokenizer pads with eos
        self.bos_token_id = self.encoder.get(self.bos_token, len(self.encoder) - 2)
        self.eos_token_id = self.encoder.get(self.eos_token, len(self.encoder) - 1)
        self.pad_token_id = self.eos_token_id
        self.unk_token_id = self.eos_token_id
        self._bpe_cache: dict[str, str] = {
            self.bos_token: self.bos_token, self.eos_token: self.eos_token}

    @classmethod
    def from_pretrained(cls, path: str, model_max_length: int = 77):
        """Load from a tokenizer dir (a diffusers checkpoint's ``tokenizer/``).

        Honors ``model_max_length`` plus bos/eos/unk/pad special-token
        overrides from ``tokenizer_config.json`` / ``special_tokens_map.json``
        (the latter wins, matching HF precedence). SD2.x checkpoints — the
        target family here (cross_attention_dim=1024) — set ``pad_token: "!"``
        (id 0), NOT eos; the upstream training code pads every prompt to
        model_max_length and feeds all 77 positions to
        cross-attention, so the pad id changes conditioning features.
        """
        vocab = os.path.join(path, "vocab.json")
        merges = os.path.join(path, "merges.txt")
        special: dict[str, str] = {}

        def _token_str(v):
            # entries are either plain strings or AddedToken dicts
            if isinstance(v, dict):
                v = v.get("content")
            return v if isinstance(v, str) else None

        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cfg_path):
            try:
                with open(cfg_path, encoding="utf-8") as f:
                    cfg = json.load(f)
                model_max_length = int(cfg.get("model_max_length",
                                               model_max_length))
                for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                    tok = _token_str(cfg.get(key))
                    if tok is not None:
                        special[key] = tok
            except Exception:
                pass
        map_path = os.path.join(path, "special_tokens_map.json")
        if os.path.isfile(map_path):
            try:
                with open(map_path, encoding="utf-8") as f:
                    smap = json.load(f)
                for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                    tok = _token_str(smap.get(key))
                    if tok is not None:
                        special[key] = tok
            except Exception:
                pass
        self = cls(vocab, merges, model_max_length=model_max_length)
        self._apply_special_tokens(special)
        return self

    def _apply_special_tokens(self, special: dict) -> None:
        """Apply bos/eos/unk/pad overrides, resolving ids via the vocab.
        A pad/unk token missing from the vocab falls back to eos (HF behavior
        for unknown special strings is an added token; here the vocab is
        closed, so eos is the safe in-vocab fallback)."""
        if "bos_token" in special and special["bos_token"] in self.encoder:
            self.bos_token = special["bos_token"]
            self.bos_token_id = self.encoder[self.bos_token]
        if "eos_token" in special and special["eos_token"] in self.encoder:
            self.eos_token = special["eos_token"]
            self.eos_token_id = self.encoder[self.eos_token]
        # unk/pad default to eos unless explicitly (and resolvably) overridden
        self.unk_token = special.get("unk_token", self.eos_token)
        self.unk_token_id = self.encoder.get(self.unk_token, self.eos_token_id)
        self.pad_token = special.get("pad_token", self.eos_token)
        self.pad_token_id = self.encoder.get(self.pad_token, self.eos_token_id)
        self._bpe_cache.setdefault(self.bos_token, self.bos_token)
        self._bpe_cache.setdefault(self.eos_token, self.eos_token)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # --- BPE core -----------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        text = _whitespace_clean(html.unescape(html.unescape(text)).strip()).lower()
        pre = (_PATTERN.findall(text) if _PATTERN is not None
               else _scan_fallback(text))
        bpe_tokens: list[str] = []
        for token in pre:
            if token in (self.bos_token, self.eos_token):
                bpe_tokens.append(token)
                continue
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self._bpe(token).split(" "))
        return bpe_tokens

    def convert_tokens_to_ids(self, tokens) -> list[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.encoder.get(t, self.unk_token_id) for t in tokens]

    # --- HF-compatible surface ---------------------------------------------
    def encode(self, text: str) -> list[int]:
        """BOS + bpe ids + EOS (shape-compatible with CLIPTokenizer.encode)."""
        return ([self.bos_token_id]
                + self.convert_tokens_to_ids(self.tokenize(text))
                + [self.eos_token_id])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = np.atleast_1d(np.asarray(ids)).tolist()
        skip = {self.bos_token_id, self.eos_token_id} if skip_special_tokens else set()
        text = "".join(self.decoder.get(int(i), "") for i in ids if int(i) not in skip)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, text, padding=None, truncation=True, max_length=None,
                 return_tensors="np", **kw):
        texts = [text] if isinstance(text, str) else list(text)
        max_length = min(max_length or self.model_max_length,
                         self.model_max_length)
        batch = []
        for t in texts:
            ids = self.encode(t)
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            if padding in ("max_length", True):
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            batch.append(ids)
        if padding not in ("max_length", True):
            width = max(len(i) for i in batch)
            batch = [i + [self.pad_token_id] * (width - len(i)) for i in batch]

        class _Out:
            input_ids = np.asarray(batch, np.int32)

        return _Out()
