"""Building-block layers for the video UNet in channels-last, frame-major
layout — the port of ``animate_anything_tpu/models/layers.py``.

Spatial tensors ride a fused (b·f, h, w, c) batch. Convolutions permute to
NCHW views for cuDNN: ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
already a channels_last NCHW tensor, so no copy is made. Parameter names are
the diffusers keys, so ``utils/convert.py`` state dicts load strictly.
Layers compute in their weight's dtype and cast inputs and biases to it
(flax ``dtype=`` semantics; see ``core/dtypes.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.ops.group_norm import group_norm_silu, local_sums
from animate_anything_tpu_torch.parallel import frame
from animate_anything_tpu_torch.ops.spatial_conv import SPATIAL_CONV_OPTIN, gn_silu_spatial_conv
from animate_anything_tpu_torch.ops.temporal_conv import gn_silu_tap_conv, pack_taps


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in its weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.weight.dtype
        return F.linear(x.to(dt), self.weight, _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last (n, h, w, c) tensors, its weight held
    channels_last too: casts, ``load_state_dict`` and in-place updates keep
    the layout, cuDNN takes the weight without a copy, and kernel 8 reads it
    in place as its (cout, 9·cin) operand (``ops/spatial_conv.pack_weight``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.weight.data = self.weight.data.contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.weight.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight, _cast(self.bias, dt),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class Conv1x1(nn.Module):
    """1×1 conv as a matmul on the channel axis, with the (O, I, 1, 1) conv
    weight of the checkpoint layout."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.weight.dtype
        return F.linear(x.to(dt), self.weight[:, :, 0, 0], _cast(self.bias, dt))


class FusedGroupNorm(nn.Module):
    """GroupNorm (+ optional SiLU) on (n, ..., c), statistics in fp32,
    optionally from precomputed per-(n, c) sums (ops/group_norm.py).
    ``stats="pallas"`` sends this norm's statistics through kernel 6."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5, silu: bool = False,
                 stats: Optional[str] = None):
        super().__init__()
        self.groups, self.eps, self.silu, self.stats = groups, eps, silu, stats
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor, sums=None, rows=None) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.groups, self.eps, self.silu,
                               stats=self.stats, sums=sums, rows=rows)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in fp32 (flax ``LayerNorm(dtype=float32)``), stored in dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding (diffusers ``Timesteps``), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """MLP over the sinusoidal embedding, with the optional condition
    projection that carries motion strength; ``out_dim`` (default
    ``time_embed_dim``) is linear_2's width, as diffusers' ``out_dim``."""

    def __init__(self, in_dim: int, time_embed_dim: int, cond_proj_dim: Optional[int] = None,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.cond_proj = Linear(cond_proj_dim, in_dim, bias=False) if cond_proj_dim else None
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor, condition: Optional[torch.Tensor] = None):
        if condition is not None:
            if self.cond_proj is None:
                raise ValueError("condition passed but cond_proj_dim not set")
            sample = sample.to(self.linear_1.weight.dtype) + self.cond_proj(condition)
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    """GN→SiLU→conv3x3 ×2 with time-embedding bias and 1×1 shortcut on the
    fused (b·f, h, w, c) batch (diffusers ResnetBlock2D). With ``impl ==
    "pallas"`` and ``SPATIAL_CONV_OPTIN()`` both stages run kernel 8 (JAX's
    ``AA_SPATIAL_CONV`` branch of its ``impl="pallas"`` resnet)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 groups: int = 32, eps: float = 1e-5, impl: str = "pallas"):
        super().__init__()
        self.impl = impl
        self.norm1 = FusedGroupNorm(in_channels, groups, eps, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = FusedGroupNorm(out_channels, groups, eps, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv1x1(in_channels, out_channels)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                norm1_sums=None) -> torch.Tensor:
        if self.impl == "pallas" and SPATIAL_CONV_OPTIN():
            return self._fused(x, temb)
        h = self.conv1(self.norm1(x, sums=norm1_sums))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _fused(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        """Two fused stages on the same parameters: the time-embedding
        projection folds into stage 1's per-sample bias, the shortcut into
        stage 2's residual. Statistics come from ``group_affine``: like
        JAX's branch, this one takes no producer sums and returns none."""
        teb = None if temb is None else self.time_emb_proj(F.silu(temb))
        h = gn_silu_spatial_conv(x.to(self.conv1.weight.dtype), self.norm1.weight,
                                 self.norm1.bias, self.conv1.weight, self.conv1.bias,
                                 groups=self.norm1.groups, eps=self.norm1.eps, extra_bias=teb)
        shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return gn_silu_spatial_conv(h, self.norm2.weight, self.norm2.bias, self.conv2.weight,
                                    self.conv2.bias, groups=self.norm2.groups,
                                    eps=self.norm2.eps, residual=shortcut)


class TemporalTapConv(nn.Conv3d):
    """Frame-axis conv (kernel (3, 1, 1), zero frames past the ends) on
    (b, f, s, c) as three shifted matmuls (JAX's ``TemporalTapConv``), kept
    in the Conv3d parameter layout: one GEMM over the taps side by side
    ``[prev ‖ h ‖ next]``, fp32 accumulation rounded once to the weight's
    dtype, then the bias."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(in_dim, out_dim, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.weight.dtype
        h = h.to(dt)
        prev = F.pad(h[:, :-1], (0, 0, 0, 0, 1, 0))
        nxt = F.pad(h[:, 1:], (0, 0, 0, 0, 0, 1))
        w = pack_taps(self.weight).reshape(self.out_channels, -1)
        return F.linear(torch.cat([prev, h, nxt], -1), w) + self.bias.to(dt)


class TemporalConvLayer(nn.Module):
    """Pseudo-3D temporal conv: four GN→SiLU→conv(3,1,1) stages, residual;
    the last conv starts at zero (identity at init). Under ``impl="pallas"``
    every stage runs kernel 3 (ops/temporal_conv.py), each stage's output
    sums feeding the next stage's GroupNorm. Otherwise JAX's composite path:
    ``FusedGroupNorm`` with SiLU (stage 1 on the producer's sums, when
    there are any) and ``TemporalTapConv``, no output sums. Submodules keep
    the diffusers ``nn.Sequential`` indices (conv1 = [norm, SiLU, conv],
    conv2..4 = [norm, SiLU, dropout, conv]). The dropout modules are never
    called, in training too: JAX's train step applies the UNet with
    ``deterministic=True``."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None, groups: int = 32,
                 impl: str = "pallas"):
        super().__init__()
        out_dim = out_dim or in_dim
        self.groups, self.impl = groups, impl

        def stage(cin, cout, dropout):
            mods = [nn.GroupNorm(groups, cin), nn.SiLU()]
            if dropout:
                mods.append(nn.Dropout(0.1))
            mods.append(TemporalTapConv(cin, cout))
            return nn.Sequential(*mods)

        self.conv1 = stage(in_dim, out_dim, False)
        self.conv2 = stage(out_dim, in_dim, True)
        self.conv3 = stage(in_dim, in_dim, True)
        self.conv4 = stage(in_dim, in_dim, True)

    def forward(self, x: torch.Tensor, num_frames: int, in_sums=None):
        """x (b·f, h, w, c) → (y, entry_sums) with entry_sums the per-(b·f, c)
        fp32 (Σy, Σy²) of the output, for the next module's GroupNorm (None
        off ``"pallas"``). ``in_sums``: the per-(b·f, c) sums of x from its
        producer, for stage 1's GroupNorm (its gradient flows back into the
        producer's sums). Under a frame split (``parallel/frame.active``) x
        holds this rank's frames of ``num_frames``: the stages run on all
        frames of a slice of positions between two all-to-alls, every
        GroupNorm's sums and kernel 3's output sums summed over the frame
        group."""
        shard = frame.active()
        nf = frame.local_frames(num_frames)
        bf, hh, ww, c = x.shape
        b, s = bf // nf, hh * ww
        h = x.reshape(b, nf, s, c)
        sums = None if in_sums is None else tuple(
            t.reshape(b, nf, c).sum(1) for t in in_sums)
        rows = None
        if shard is not None:
            h = shard.to_positions(h)
            rows = num_frames * s
        identity = h

        def stage_sums(h, sums):
            # per-(b, c) sums of h over the whole frame group's rows
            if shard is None:
                return sums
            if sums is None:
                sums = local_sums(h.reshape(b, -1, h.shape[-1]))
            return shard.reduce(*sums)

        stages = (self.conv1, self.conv2, self.conv3, self.conv4)
        if self.impl != "pallas":
            for idx, seq in enumerate(stages, start=1):
                norm, conv = seq[0], seq[-1]
                h = group_norm_silu(h, norm.weight, norm.bias, self.groups, 1e-5,
                                    sums=stage_sums(h, sums if idx == 1 else None), rows=rows)
                h = conv(h)
            h = identity + h
            if shard is not None:
                h = shard.to_frames(h, s)
            return h.reshape(bf, hh, ww, c), None
        for idx, seq in enumerate(stages, start=1):
            norm, conv = seq[0], seq[-1]
            h, stats = gn_silu_tap_conv(
                h.to(conv.weight.dtype), norm.weight, norm.bias, conv.weight, conv.bias,
                groups=self.groups, eps=1e-5, residual=identity if idx == 4 else None,
                sums=stage_sums(h, sums) if idx == 1 else sums, rows=rows)
            if shard is not None:   # kernel 3's per-(b, f, c) sums over this rank's positions
                stats = shard.reduce(*stats)
            sums = (stats[0].sum(1), stats[1].sum(1))   # per-(b, c) for the next GN
        if shard is not None:
            h = shard.to_frames(h, s)
            stats = tuple(t[:, shard.lo:shard.hi] for t in stats)
        return h.reshape(bf, hh, ww, c), (stats[0].reshape(bf, c), stats[1].reshape(bf, c))


class Downsample2D(nn.Module):
    """conv3x3 stride 2 (diffusers Downsample2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def resize_nearest(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """Nearest resize of (n, h, w, c) to size (h', w'); source index
    floor((i + 0.5)·h/h') in fp32, as ``jax.image.resize(method="nearest")``."""
    for axis, (m, n) in ((1, (x.shape[1], size[0])), (2, (x.shape[2], size[1]))):
        if m == n:
            continue
        if n == 2 * m:
            x = x.repeat_interleave(2, dim=axis)
            continue
        pos = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
        x = x.index_select(axis, torch.floor(pos).long().to(x.device))
    return x


class Upsample2D(nn.Module):
    """nearest 2× (or to an explicit size) + conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[tuple] = None) -> torch.Tensor:
        size = tuple(output_size) if output_size is not None else (x.shape[1] * 2, x.shape[2] * 2)
        return self.conv(resize_nearest(x, size))
