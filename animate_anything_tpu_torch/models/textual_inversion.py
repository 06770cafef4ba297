"""Textual-inversion embeddings — the port of
``animate_anything_tpu/models/textual_inversion.py``.

Learned-token embedding files (AUTOMATIC1111 ``string_to_param`` and
diffusers ``learned_embeds`` layouts, ``.safetensors`` or torch ``.pt`` /
``.bin``) grow the CLIP text model's ``token_embedding`` by one row a
vector, and ``TokenizerWithPlaceholders`` maps each placeholder word to its
new ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def load_embedding_file(path: str) -> Dict[str, np.ndarray]:
    """→ {token: (n_vectors, dim)} fp32."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        data = dict(load_file(path))
    else:
        raw = torch.load(path, map_location="cpu", weights_only=False)
        if "string_to_param" in raw:  # A1111
            name = raw.get("name", "token")
            vecs = next(iter(raw["string_to_param"].values()))
            return {name: np.atleast_2d(np.asarray(vecs.float(), np.float32))}
        data = {k: v.float().numpy() for k, v in raw.items() if hasattr(v, "numpy")}
    return {k: np.atleast_2d(np.asarray(v, np.float32)) for k, v in data.items()}


def inject_embeddings(text_model, tokenizer, embeddings: Dict[str, np.ndarray]
                      ) -> Tuple[nn.Module, "TokenizerWithPlaceholders", int]:
    """Append the embeddings' rows to ``text_model``'s token embedding, in
    place: the model's config grows by the added vocabulary and its
    ``token_embedding`` becomes a new ``nn.Embedding`` with the old rows
    first, in the table's dtype and on its device. → (the model, a tokenizer
    that resolves each placeholder to its new ids, rows added)."""
    emb = text_model.text_model.embeddings.token_embedding
    table = emb.weight.detach()
    placeholder_ids: Dict[str, list[int]] = {}
    rows = [table]
    next_id = table.shape[0]
    for token, vecs in embeddings.items():
        if vecs.shape[1] != table.shape[1]:
            raise ValueError(f"embedding dim {vecs.shape[1]} != text model dim {table.shape[1]}")
        placeholder_ids[token] = list(range(next_id, next_id + len(vecs)))
        rows.append(torch.as_tensor(vecs, dtype=table.dtype, device=table.device))
        next_id += len(vecs)
    new_table = torch.cat(rows, dim=0)
    num_added = new_table.shape[0] - table.shape[0]
    grown = nn.Embedding(new_table.shape[0], new_table.shape[1], device=table.device,
                         dtype=table.dtype)
    with torch.no_grad():
        grown.weight.copy_(new_table)
    grown.weight.requires_grad_(emb.weight.requires_grad)
    text_model.text_model.embeddings.token_embedding = grown
    text_model.config = dataclasses.replace(text_model.config, vocab_size=new_table.shape[0])
    return text_model, TokenizerWithPlaceholders(tokenizer, placeholder_ids), num_added


class TokenizerWithPlaceholders:
    """Wraps any tokenizer; placeholder words expand to their learned ids."""

    def __init__(self, base, placeholder_ids: Dict[str, list[int]]):
        self._base = base
        self.placeholder_ids = placeholder_ids
        self.model_max_length = getattr(base, "model_max_length", 77)

    def __call__(self, text, **kw):
        texts = [text] if isinstance(text, str) else list(text)
        out = self._base(texts, **kw)
        ids = np.asarray(out.input_ids).copy()
        # splice the placeholder ids in by re-tokenizing each prompt word-wise
        for bi, t in enumerate(texts):
            cursor = 1  # after BOS
            for word in t.split():
                if word in self.placeholder_ids:
                    for pid in self.placeholder_ids[word]:
                        if cursor < ids.shape[1] - 1:
                            ids[bi, cursor] = pid
                            cursor += 1
                else:
                    wids = np.asarray(
                        self._base(word, padding="max_length",
                                   max_length=self.model_max_length,
                                   truncation=True).input_ids
                    )[0]
                    bos, eos = wids[0], wids[-1]
                    n = int(((wids != bos) & (wids != eos)).sum()) or 1
                    cursor += n

        class _Out:
            input_ids = ids

        return _Out()
