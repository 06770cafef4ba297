"""Transparent (RGBA) VAE pair, LayerDiffuse style — the port of
``animate_anything_tpu/models/transparent_vae.py``:

- ``LatentTransparencyOffsetEncoder``: eight 3×3 convs with SiLU (three of
  them stride 2) and a zero-initialised last conv, mapping RGBA pixels to a
  4-channel latent OFFSET added to the premultiplied-RGB SD latent (a no-op
  at init);
- ``UNet384``: a timestep-free 2D UNet (32/64/128/256 channels, GroupNorm(4),
  multi-head attention of head dim 8 at the deepest level) decoding (decoded
  RGB, latent) → RGBA; the latent enters through a zero-initialised 1×1
  conv added before the 4th down block.

Channels-last; frames ride the batch axis. Parameter names are the
reference's torch keys (``blocks.N.``, ``down_blocks.N.resnets.M.``,
``mid_block.attentions.0.``, ``latent_conv_in``, …), so the published
``vae_alpha_encoder.pth`` / ``vae_alpha_decoder.pth`` state dicts load with
``strict=True``, and JAX's ``convert_offset_encoder`` / ``convert_unet384``
turn this module's ``state_dict`` into the flax tree. The attention runs
through SDPA and the convs and GroupNorms are plain torch, as JAX leaves
them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.models.layers import (Conv2d, Downsample2D, ResnetBlock2D,
                                                      Upsample2D)
from animate_anything_tpu_torch.models.svd_unet import BlockContainers, group_norm_fp32
from animate_anything_tpu_torch.models.vae import VAEAttentionBlock, encode_video

# (out channels, stride) of the offset encoder's convs before the last
OFFSET_SPECS = ((32, 1), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1))


class LatentTransparencyOffsetEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        layers, cin = [], 4
        for cout, stride in OFFSET_SPECS:
            layers += [Conv2d(cin, cout, 3, stride=stride, padding=1), nn.SiLU()]
            cin = cout
        layers.append(Conv2d(cin, 4, 3, padding=1))
        self.blocks = nn.Sequential(*layers)

    def forward(self, rgba: torch.Tensor) -> torch.Tensor:
        """(b, h, w, 4) RGBA in [-1, 1] → (b, h/8, w/8, 4) latent offset."""
        return self.blocks(rgba)


@dataclasses.dataclass(frozen=True)
class UNet384Config:
    in_channels: int = 3
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (32, 64, 128, 256)
    layers_per_block: int = 2
    norm_num_groups: int = 4
    norm_eps: float = 1e-5
    attention_head_dim: int = 8

    @classmethod
    def tiny(cls, **kw) -> "UNet384Config":
        """JAX's ``cli_stage2.build_transparent_vae(model_size="tiny")`` sizes."""
        d = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=4, norm_num_groups=2)
        d.update(kw)
        return cls(**d)


class UNet384(nn.Module):
    """Timestep-free decoder UNet: (rgb image, sd latent) → RGBA."""

    def __init__(self, config: UNet384Config = UNet384Config()):
        super().__init__()
        cfg = self.config = config
        g, eps, hd = cfg.norm_num_groups, cfg.norm_eps, cfg.attention_head_dim
        ch = cfg.block_out_channels
        n = len(ch)

        def res(cin, cout):
            return ResnetBlock2D(cin, cout, None, g, eps, impl="composite")

        def attn(c):
            return VAEAttentionBlock(c, g, eps, head_dim=hd)

        self.latent_conv_in = Conv2d(4, ch[2], 1)
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skip_ch, prev = [ch[0]], ch[0]
        for i in range(n):
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(res(prev, ch[i]))
                if i == n - 1:                      # AttnDownBlock2D only at the deepest level
                    attentions.append(attn(ch[i]))
                prev = ch[i]
                skip_ch.append(prev)
            down = Downsample2D(prev) if i < n - 1 else None
            if down is not None:
                skip_ch.append(prev)
            self.down_blocks.append(BlockContainers(resnets, attentions, downsample=down))

        self.mid_block = BlockContainers([res(ch[-1], ch[-1]), res(ch[-1], ch[-1])],
                                         [attn(ch[-1])])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i in range(n):
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(res(prev + skip_ch.pop(), rev[i]))
                if i == 0:                          # AttnUpBlock2D first
                    attentions.append(attn(rev[i]))
                prev = rev[i]
            up = Upsample2D(prev) if i < n - 1 else None
            self.up_blocks.append(BlockContainers(resnets, attentions, upsample=up))

        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=eps)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        """x (n, h, w, 3) decoded RGB in [-1, 1], latent (n, h/8, w/8, 4)
        unscaled → (n, h, w, 4)."""
        sample_latent = self.latent_conv_in(latent)
        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            if i == 3:
                h = h + sample_latent               # the 8×-downsampled latent injection
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h)
                if len(blk.attentions):
                    h = blk.attentions[j](h)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=-1))
                if len(blk.attentions):
                    h = blk.attentions[j](h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, tuple(skips[-1].shape[1:3]) if skips else None)

        return self.conv_out(F.silu(group_norm_fp32(h, self.conv_norm_out)))


def build_rgba_latents(vae: nn.Module, rgba_pixels: torch.Tensor,
                       offset_encoder: LatentTransparencyOffsetEncoder) -> torch.Tensor:
    """RGBA video (b, f, h, w, 4) in [-1, 1] (alpha too) → the scaled SD
    latents of its RGB premultiplied against black, plus the transparency
    offset."""
    rgb = rgba_pixels[..., :3]
    alpha01 = (rgba_pixels[..., 3:] + 1.0) / 2.0
    latents = encode_video(vae, rgb * alpha01)
    b, f, h, w, c = latents.shape
    offset = offset_encoder(rgba_pixels.reshape(b * f, *rgba_pixels.shape[2:]))
    return latents + offset.reshape(b, f, h, w, c)


def decode_rgba_video(unet384: UNet384, decoded_rgb: torch.Tensor,
                      latents: torch.Tensor) -> torch.Tensor:
    """Per-frame transparent decode → (b, f, h, w, 4) fp32 RGBA on a 0..255
    scale: the colour rescaled from [-1, 1] and clipped, alpha binarised at
    127 (in the decoder's dtype, as JAX's)."""
    b, f, h, w, _ = decoded_rgb.shape
    rgba = unet384(decoded_rgb.reshape(b * f, h, w, 3),
                   latents.reshape(b * f, *latents.shape[2:])).reshape(b, f, h, w, 4)
    alpha = torch.where(rgba[..., 3:] * 255.0 > 127.0, 255.0, 0.0).float()
    fg = ((rgba[..., :3] + 1.0) * 127.5).clamp(0, 255)
    return torch.cat([fg.float(), alpha], dim=-1)
