"""CLIP vision encoder with projection (the SVD image embedding) — the port
of ``animate_anything_tpu/models/clip_vision.py``.

A 224×224 image → one projected token (b, projection_dim) for the UNet's
cross-attention. The default config is the laion ViT-H/14 tower (1280 wide,
32 layers, 16 heads, exact-erf GELU, projection 1024). The residual stream
runs in fp32 from ``pre_layrnorm`` on, each LayerNorm in fp32 stored in the
layer's compute dtype, as the flax modules with ``dtype=float32`` norms do.
Self-attention (``clip_text.CLIPAttention`` unmasked) takes JAX's
``impl="xla"`` (``ops/attention.xla_attention``: SDPA on the card, the plain
version on the CPU); no kernel of the port runs here.

Parameter names follow HF ``CLIPVisionModelWithProjection``
(``vision_model.encoder.layers.0.self_attn.q_proj.weight``,
``visual_projection.weight``), so ``utils/convert.py::clip_vision_state_dict``
loads with ``strict=True``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.models.clip_text import CLIPEncoderLayer
from animate_anything_tpu_torch.models.layers import Linear, layer_norm

# HF CLIPImageProcessor's normalisation
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    hidden_act: str = "gelu"  # laion ViT-H; HF's generic default is quick_gelu

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        d = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                 image_size=32, patch_size=8, projection_dim=32)
        d.update(kw)
        return cls(**d)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) → (b, 1 + patches, hidden) in the patch kernel's dtype."""
        dt = self.patch_embedding.weight.dtype
        b = pixel_values.shape[0]
        x = F.conv2d(pixel_values.to(dt).permute(0, 3, 1, 2), self.patch_embedding.weight,
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos).to(dt)[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class _Encoder(nn.Module):
    """The text tower's layers (their MLP takes ``clip_text._act``'s GELU
    forms) without the causal mask."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, causal=False)
                                     for _ in range(cfg.num_layers)])


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (b, H, W, 3) normalised → image_embeds (b,
        projection_dim) in the compute dtype."""
        vm = self.vision_model
        x = layer_norm(vm.embeddings(pixel_values), vm.pre_layrnorm, torch.float32)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = layer_norm(x[:, 0], vm.post_layernorm, torch.float32)
        return self.visual_projection(pooled)


def preprocess_clip_image(image: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 RGB (h, w, 3) → normalised (1, size, size, 3) float32: PIL's
    bicubic resize, then CLIP's mean and std."""
    from PIL import Image

    img = Image.fromarray(image).resize((size, size), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr[None]
