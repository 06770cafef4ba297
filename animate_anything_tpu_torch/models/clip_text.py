"""CLIP text encoder — the port of ``animate_anything_tpu/models/clip_text.py``.

A causal transformer over BPE token ids with a final LayerNorm; its
``last_hidden_state`` conditions the UNet's cross-attention. The default
config is the SD 2.x / ModelScope text tower (hidden 1024, 23 layers, 16
heads, exact-erf GELU). LayerNorms run in fp32 and store in the layer's
compute dtype, as the flax modules with ``dtype=float32`` norms do; the
causal self-attention takes JAX's ``impl="xla"`` (``ops/attention.xla_attention``:
SDPA on the card, the plain version on the CPU).

Parameter names follow the HF ``CLIPTextModel`` key layout
(``text_model.encoder.layers.0.self_attn.q_proj.weight``), so a JAX param
tree exported by ``utils/convert.py::clip_text_state_dict`` loads with
``strict=True``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.models.layers import Linear, layer_norm
from animate_anything_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"  # SD2.x; SD1.x uses quick_gelu

    @classmethod
    def tiny(cls, **kw) -> "CLIPTextConfig":
        d = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=16)
        d.update(kw)
        return cls(**d)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj, self.v_proj = Linear(h, h), Linear(h, h), Linear(h, h)
        self.out_proj = Linear(h, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, hid = x.shape
        shape = (b, s, self.heads, hid // self.heads)
        q, k, v = (p(x).reshape(shape) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(q, k, v, impl="xla", is_causal=True).reshape(b, s, hid))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.mlp.fc1.weight.dtype
        x = x + self.self_attn(layer_norm(x, self.layer_norm1, dt))
        return x + self.mlp(layer_norm(x, self.layer_norm2, dt))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (b, seq) int → last_hidden_state (b, seq, hidden), fp32."""
        tm = self.text_model
        x = tm.embeddings(input_ids.long())
        for layer in tm.encoder.layers:
            x = layer(x)
        return layer_norm(x, tm.final_layer_norm, torch.float32)
