"""Plain float32 CLIP text encoder (causal transformer, final LayerNorm; the
SD 2.x / ModelScope text tower) on the HF ``CLIPTextModel`` keys, and the
asset-free hash tokenizer that the configuration states: each lower-cased
word's md5 modulo ``vocab - 2``, BOS and EOS the last two ids, EOS-padded to
77."""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics, layer_norm


def hash_token_ids(texts: list[str], vocab: int, length: int = 77) -> torch.Tensor:
    bos, eos = vocab - 2, vocab - 1
    rows = []
    for text in texts:
        words = text.lower().split()[:length - 2]
        ids = [bos] + [int(hashlib.md5(w.encode()).hexdigest(), 16) % (vocab - 2)
                       for w in words] + [eos]
        rows.append(ids + [eos] * (length - len(ids)))
    return torch.tensor(rows, dtype=torch.long)


class CLIPText:
    def __init__(self, P: dict, cfg: dict, num: Numerics):
        self.P, self.cfg, self.num = P, cfg, num

    def lin(self, x, key):
        return self.num.linear(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"])

    def ln(self, x, key):
        return layer_norm(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"])

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        """(b, 77) ids → (b, 77, hidden) last hidden state."""
        P, pre = self.P, "text_model"
        b, s = ids.shape
        heads = self.cfg["num_attention_heads"]
        x = (P[f"{pre}.embeddings.token_embedding.weight"].float()[ids]
             + P[f"{pre}.embeddings.position_embedding.weight"].float()[:s][None])
        hid = x.shape[-1]
        for i in range(self.cfg["num_hidden_layers"]):
            key = f"{pre}.encoder.layers.{i}"
            h = self.ln(x, f"{key}.layer_norm1")
            q, k, v = (self.lin(h, f"{key}.self_attn.{n}").reshape(b, s, heads, hid // heads)
                       for n in ("q_proj", "k_proj", "v_proj"))
            o = self.num.attention(q, k, v, causal=True).reshape(b, s, hid)
            x = x + self.lin(o, f"{key}.self_attn.out_proj")
            h = self.ln(x, f"{key}.layer_norm2")
            x = x + self.lin(F.gelu(self.lin(h, f"{key}.mlp.fc1")), f"{key}.mlp.fc2")
        return self.ln(x, f"{pre}.final_layer_norm")
