"""The asset-free tokenizer — the port of
``animate_anything_tpu/models/factory.py::HashTokenizer``.

Words hash (md5) into the CLIP vocab range, with BOS/EOS at its last two
ids, so a pipeline runs end to end without tokenizer files. The JAX package
falls back to it when a run has no ``tokenizer/`` directory; the ids equal
JAX's. Checkpoints with tokenizer files use ``clip_tokenizer.CLIPBPETokenizer``.
``decode`` is the best-effort inverse: the words it has hashed.
"""

from __future__ import annotations

import hashlib

import numpy as np


class HashTokenizer:
    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self._id2word: dict = {}

    def _word_id(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2)
        self._id2word[h] = w
        return h

    def encode(self, text: str) -> list[int]:
        """BOS + per-word ids + EOS (CLIPTokenizer.encode-compatible shape)."""
        bos, eos = self.vocab_size - 2, self.vocab_size - 1
        return [bos] + [self._word_id(w) for w in text.lower().split()] + [eos]

    def decode(self, ids) -> str:
        """The words seen for ``ids``, space-separated ("" for unseen ids)."""
        return " ".join(self._id2word.get(int(i), "") for i in np.atleast_1d(np.asarray(ids)))

    def __call__(self, text, padding=None, truncation=True, max_length=77,
                 return_tensors="np", **kw):
        """Pads with EOS to ``min(max_length, model_max_length)``; returns an
        object with ``input_ids`` (batch, length) int32."""
        texts = [text] if isinstance(text, str) else list(text)
        max_length = min(max_length or self.model_max_length, self.model_max_length)
        bos, eos = self.vocab_size - 2, self.vocab_size - 1
        batch = []
        for t in texts:
            ids = [bos] + [self._word_id(w) for w in t.lower().split()[: max_length - 2]]
            ids.append(eos)
            ids += [eos] * (max_length - len(ids))
            batch.append(ids[:max_length])

        class _Out:
            input_ids = np.asarray(batch, np.int32)

        return _Out()
