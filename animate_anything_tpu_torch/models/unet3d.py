"""Mask + motion-strength conditioned 3D UNet — the port of
``animate_anything_tpu/models/unet3d.py``.

Conditioning as in the reference:
- the first-frame latent joins along the FRAME axis and the output strips
  frame 0 (``condition_mode="frame_concat"``, the default); under
  ``"channel_concat"`` (the stage-2 9-channel model) it is broadcast over
  the frames and joins along the CHANNEL axis, and the output keeps every
  frame;
- the motion mask joins along the CHANNEL axis (mask first) into a 5-channel
  input consumed by ``conv_in2``;
- scalar motion strength is embedded by the sinusoidal projector and fed as
  the time embedding's condition projection;
- text states are repeated per frame for cross-attention.

Layout: input (b, f, h, w, c); the fused (b·(f+1), h, w, c) spatial batch
inside. CFG is an ordinary batch doubling by the caller.

``UNet3DConfig.attn_impl`` picks JAX's configuration: ``"pallas"`` (kernels
1–5, the GroupNorm sums threaded between them), ``"xla"`` (the composite
modules, SDPA for attention) or ``"packed"`` (``"xla"`` with kernel 9 for the
frame attention). The parameters are the same in all three. The default,
``None``, means ``"xla"`` as in JAX (``ops/attention.py``'s process default
there); callers that want the kernels pass ``"pallas"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from animate_anything_tpu_torch.models.attention import TemporalTransformer
from animate_anything_tpu_torch.models.layers import (Conv2d, FusedGroupNorm, TimestepEmbedding,
                                                      timestep_embedding)
from animate_anything_tpu_torch.models.unet3d_blocks import (CrossAttnDownBlock3D,
                                                             CrossAttnUpBlock3D, DownBlock3D,
                                                             UNetMidBlock3DCrossAttn, UpBlock3D)
from animate_anything_tpu_torch.utils.ptp import tag_attention_paths


ATTN_IMPLS = ("pallas", "xla", "packed")
CONDITION_MODES = ("frame_concat", "channel_concat")


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "DownBlock3D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    motion_mask: bool = False
    motion_strength: bool = False
    # "frame_concat" | "channel_concat" (module docstring)
    condition_mode: str = "frame_concat"
    # "pallas" | "xla" | "packed" | None, which means "xla" (module docstring)
    attn_impl: Optional[str] = None
    # per-sub-layer activation checkpointing while autograd records
    # (unet3d_blocks.run_layer); JAX's per-sub-layer nn.remat
    gradient_checkpointing: bool = False

    def __post_init__(self):
        if self.attn_impl is not None and self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"UNet3DConfig.attn_impl must be None or one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")
        if self.condition_mode not in CONDITION_MODES:
            raise ValueError(f"UNet3DConfig.condition_mode must be one of {CONDITION_MODES}, "
                             f"got {self.condition_mode!r}")

    @property
    def impl(self) -> str:
        """The configuration ``attn_impl`` names: ``None`` reads as ``"xla"``."""
        return self.attn_impl or "xla"

    @classmethod
    def tiny(cls, **kw) -> "UNet3DConfig":
        """Test-size config (same graph, narrower)."""
        defaults = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32,
                        attention_head_dim=8, norm_num_groups=8)
        defaults.update(kw)
        return cls(**defaults)


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNet3DConfig):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        ch0, temb = ch[0], ch[0] * 4
        g, eps, hd, xd = cfg.norm_num_groups, cfg.norm_eps, cfg.attention_head_dim, \
            cfg.cross_attention_dim
        remat, impl = cfg.gradient_checkpointing, cfg.impl

        self.time_embedding = TimestepEmbedding(ch0, temb, ch0 if cfg.motion_strength else None)
        # the channel concat doubles the latent channels; the mask comes first
        cin = cfg.in_channels * (2 if cfg.condition_mode == "channel_concat" else 1)
        if cfg.motion_mask:
            self.conv_in2 = Conv2d(cin + 1, ch0, 3, padding=1)
        else:
            self.conv_in = Conv2d(cin, ch0, 3, padding=1)
        self.transformer_in = TemporalTransformer(ch0, 8, hd, attn_impl=impl)

        self.down_blocks = nn.ModuleList()
        prev = ch0
        for i, kind in enumerate(cfg.down_block_types):
            last = i == len(ch) - 1
            if kind == "CrossAttnDownBlock3D":
                blk = CrossAttnDownBlock3D(prev, ch[i], temb, cfg.layers_per_block, hd, xd, g, eps,
                                           add_downsample=not last, remat=remat, attn_impl=impl)
            elif kind == "DownBlock3D":
                blk = DownBlock3D(prev, ch[i], temb, cfg.layers_per_block, g, eps,
                                  add_downsample=not last, remat=remat, attn_impl=impl)
            else:
                raise ValueError(kind)
            self.down_blocks.append(blk)
            prev = ch[i]

        self.mid_block = UNetMidBlock3DCrossAttn(ch[-1], temb, 1, hd, xd, g, eps, remat=remat,
                                                 attn_impl=impl)

        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        n_layers = cfg.layers_per_block + 1
        for i, kind in enumerate(cfg.up_block_types):
            skip_in = rev[min(i + 1, len(ch) - 1)]
            last = i == len(cfg.up_block_types) - 1
            if kind == "CrossAttnUpBlock3D":
                blk = CrossAttnUpBlock3D(skip_in, prev, rev[i], temb, n_layers, hd, xd, g, eps,
                                         add_upsample=not last, remat=remat, attn_impl=impl)
            elif kind == "UpBlock3D":
                blk = UpBlock3D(skip_in, prev, rev[i], temb, n_layers, g, eps,
                                add_upsample=not last, remat=remat, attn_impl=impl)
            else:
                raise ValueError(kind)
            self.up_blocks.append(blk)
            prev = rev[i]

        self.conv_norm_out = FusedGroupNorm(ch0, g, eps, silu=True)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)
        tag_attention_paths(self)

    def with_attn_impl(self, attn_impl: str) -> "UNet3DConditionModel":
        """This UNet under another ``attn_impl``: the parameters are the same
        in every configuration, and the new module shares them (no copy)."""
        with torch.device("meta"):
            other = UNet3DConditionModel(dataclasses.replace(self.config, attn_impl=attn_impl))
        other.load_state_dict(self.state_dict(), strict=True, assign=True)
        return other.train(self.training)

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                condition_latent: torch.Tensor, mask: Optional[torch.Tensor] = None,
                motion: Optional[torch.Tensor] = None, pab=None) -> torch.Tensor:
        """sample (b, f, h, w, c_in), timestep () or (b,), encoder_hidden_states
        (b, seq, cross_dim), condition_latent (b, 1, h, w, c_in), mask
        (b, 1, h, w, 1) with 1 = may move, motion (b,) → (b, f, h, w, c_out).
        ``pab``: this step's ``models/pab.PABStep`` (``{"spatial",
        "temporal"}`` flags), or None for the exact forward."""
        cfg = self.config
        ch0 = cfg.block_out_channels[0]
        dt = self.time_embedding.linear_1.weight.dtype
        dev = sample.device

        # 1. frame-axis condition concat: f → f+1, the output strips frame 0;
        # or the condition broadcast over the frames, channels first
        frame_concat = cfg.condition_mode == "frame_concat"
        if frame_concat:
            sample = torch.cat([condition_latent.to(sample.dtype), sample], dim=1)
        elif condition_latent is not None:
            cond = condition_latent.to(sample.dtype).expand(*sample.shape[:-1],
                                                            condition_latent.shape[-1])
            sample = torch.cat([cond, sample], dim=-1)
        b, nf, hh, ww, _ = sample.shape

        # 2. time (+ motion-strength) embedding, fp32 sinusoids
        timesteps = torch.as_tensor(timestep, device=dev).reshape(-1).expand(b)
        t_emb = timestep_embedding(timesteps, ch0).to(dt)
        cond = None
        if cfg.motion_strength and motion is not None:
            m = torch.as_tensor(motion, device=dev).reshape(-1).expand(b)
            cond = timestep_embedding(m, ch0).to(dt)
        emb = self.time_embedding(t_emb, cond).repeat_interleave(nf, dim=0)
        context = encoder_hidden_states.to(dt).repeat_interleave(nf, dim=0)

        # 3. input conv (mask channel first → conv_in2)
        if cfg.motion_mask:
            if mask is None:
                raise ValueError("motion_mask model requires a mask (all-ones animates "
                                 "everything)")
            mk = mask.to(sample.dtype).expand(b, nf, *mask.shape[2:])
            x = torch.cat([mk, sample], dim=-1).reshape(b * nf, hh, ww, -1)
            x = self.conv_in2(x)
        else:
            x = self.conv_in(sample.reshape(b * nf, hh, ww, -1))

        cur_sums = None
        if nf > 1:
            x, cur_sums = self.transformer_in(x, nf, None, pab)

        # 4. down
        skips, skip_sums = [x], [cur_sums]
        for blk in self.down_blocks:
            if isinstance(blk, CrossAttnDownBlock3D):
                x, outs, outs_sums, cur_sums = blk(x, emb, context, nf, cur_sums, pab)
            else:
                x, outs, outs_sums, cur_sums = blk(x, emb, nf, cur_sums)
            skips.extend(outs)
            skip_sums.extend(outs_sums)

        # 5. mid
        x, cur_sums = self.mid_block(x, emb, context, nf, cur_sums, pab)

        # 6. up; the upsample size follows the skip stack
        n_layers = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            block_skips, block_sums = skips[-n_layers:], skip_sums[-n_layers:]
            del skips[-n_layers:], skip_sums[-n_layers:]
            size = tuple(skips[-1].shape[1:3]) if skips else None
            if isinstance(blk, CrossAttnUpBlock3D):
                x, cur_sums = blk(x, block_skips, emb, context, nf, cur_sums, block_sums, size,
                                 pab)
            else:
                x, cur_sums = blk(x, block_skips, emb, nf, cur_sums, block_sums, size)

        # 7. out
        x = self.conv_out(self.conv_norm_out(x, cur_sums))
        x = x.reshape(b, nf, x.shape[1], x.shape[2], cfg.out_channels)
        return x[:, 1:] if frame_concat else x
