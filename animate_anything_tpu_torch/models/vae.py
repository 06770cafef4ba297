"""SD VAE (AutoencoderKL), pixel ↔ latent 8× codec — the port of
``animate_anything_tpu/models/vae.py``. Plain torch by default, as in the
JAX package (its mid-block attention takes JAX's ``impl="xla"``:
``ops/attention.xla_attention``, SDPA on the card). Under
``set_default_norm_impl("pallas")`` every GroupNorm here (widths 128, 256
and 512) runs kernel 7 (``ops/streaming_group_norm.py``), as JAX's runs its
streaming Pallas kernel.

Channels-last (n, h, w, c); ``encode_video`` / ``decode_video`` fold the
frame axis into the batch. Keys follow the diffusers AutoencoderKL layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.models.layers import Conv1x1, Conv2d, FusedGroupNorm, Linear
from animate_anything_tpu_torch.ops.attention import attention
from animate_anything_tpu_torch.utils.tracing import traced


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        d = dict(block_out_channels=(16, 32, 32, 32), norm_num_groups=4)
        d.update(kw)
        return cls(**d)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = FusedGroupNorm(in_channels, groups, eps=1e-6, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = FusedGroupNorm(out_channels, groups, eps=1e-6, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv1x1(in_channels, out_channels)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Self-attention over h·w with a GroupNorm in front and a residual.
    ``head_dim=None``: one head over all channels (the SD VAE mid-block);
    ``head_dim=d``: c/d heads of width d (``UNet384`` passes 8), which
    changes both the scores' shape and the softmax scale, as diffusers'
    ``attention_head_dim`` does. SDPA either way (JAX's ``impl="xla"``)."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6,
                 head_dim: Optional[int] = None):
        super().__init__()
        self.heads = 1 if head_dim is None else channels // head_dim
        self.group_norm = FusedGroupNorm(channels, groups, eps=eps)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        shape = (b, hh * ww, self.heads, c // self.heads)
        h = self.group_norm(x).reshape(b, hh * ww, c)
        out = attention(self.to_q(h).reshape(shape), self.to_k(h).reshape(shape),
                        self.to_v(h).reshape(shape), impl="xla")
        return x + self.to_out[0](out.reshape(b, hh * ww, c)).reshape(b, hh, ww, c)


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, groups)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _Sampler(nn.Module):
    """Holds the resample conv under the diffusers key ``*samplers.0.conv``."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=stride, padding=0 if stride == 2 else 1)


class _EncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(cin if j == 0 else cout, cout, groups)
                                      for j in range(layers)])
        self.downsamplers = nn.ModuleList([_Sampler(cout, 2)]) if down else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            h = r(h)
        if self.downsamplers is not None:
            # diffusers VAE downsample: asymmetric pad (0, 1) on h and w, stride 2
            h = self.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        return h


class _DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int, up: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(cin if j == 0 else cout, cout, groups)
                                      for j in range(layers)])
        self.upsamplers = nn.ModuleList([_Sampler(cout, 1)]) if up else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            h = r(h)
        if self.upsamplers is not None:
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = self.upsamplers[0].conv(h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [_EncoderBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g, i < len(ch) - 1)
             for i in range(len(ch))])
        self.mid_block = _MidBlock(ch[-1], g)
        self.conv_norm_out = FusedGroupNorm(ch[-1], g, eps=1e-6, silu=True)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(self.mid_block(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        rev = list(reversed(ch))
        self.conv_in = Conv2d(cfg.latent_channels, ch[-1], 3, padding=1)
        self.mid_block = _MidBlock(ch[-1], g)
        self.up_blocks = nn.ModuleList(
            [_DecoderBlock(rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1, g,
                           i < len(rev) - 1) for i in range(len(rev))])
        self.conv_norm_out = FusedGroupNorm(ch[0], g, eps=1e-6, silu=True)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv1x1(2 * config.latent_channels, 2 * config.latent_channels)
        self.post_quant_conv = Conv1x1(config.latent_channels, config.latent_channels)

    def encode_moments(self, x: torch.Tensor):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Posterior mode (no generator) or a sample, times scaling_factor."""
        mean, logvar = self.encode_moments(x)
        z = mean
        if generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
            z = mean + torch.exp(0.5 * logvar) * eps
        return z * self.config.scaling_factor

    def decode(self, z: torch.Tensor, unscale: bool = False) -> torch.Tensor:
        if unscale:
            z = z / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode_moments(x)[0])


@traced("encode")
def encode_video(vae: AutoencoderKL, pixels: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(b, f, h, w, 3) in [-1, 1] → (b, f, h/8, w/8, 4) scaled latents."""
    b, f, h, w, c = pixels.shape
    z = vae.encode(pixels.reshape(b * f, h, w, c), generator)
    return z.reshape(b, f, h // 8, w // 8, z.shape[-1])


@traced("decode")
def decode_video(vae: AutoencoderKL, latents: torch.Tensor,
                 chunk_size: Optional[int] = None) -> torch.Tensor:
    """(b, f, h, w, 4) scaled latents → (b, f, 8h, 8w, 3) pixels in [-1, 1].
    chunk_size bounds peak decoder memory by decoding frames in groups."""
    b, f, h, w, c = latents.shape
    flat = latents.reshape(b * f, h, w, c)
    if chunk_size and chunk_size < b * f:
        out = torch.cat([vae.decode(z, unscale=True) for z in flat.split(chunk_size)])
    else:
        out = vae.decode(flat, unscale=True)
    return out.reshape(b, f, h * 8, w * 8, -1)
