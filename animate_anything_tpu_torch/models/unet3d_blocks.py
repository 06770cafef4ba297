"""Down/mid/up blocks of the mask-conditioned 3D UNet — the port of
``animate_anything_tpu/models/unet3d_blocks.py``.

Block graphs as in the reference:
- CrossAttnDownBlock3D / CrossAttnUpBlock3D: [resnet → temp_conv →
  spatial-attn → temporal-attn] per layer;
- UNetMidBlock3DCrossAttn: resnet → temp_conv, then [attn → temp_attn →
  resnet → temp_conv];
- DownBlock3D / UpBlock3D: [resnet → temp_conv];
- temporal modules are skipped when num_frames == 1.

``pab`` (a ``models/pab.PABStep``, JAX's ``pab_reuse`` with the request's
cache) reaches every spatial and temporal transformer of the cross-attention
blocks.

GroupNorm sums thread between producers and consumers: under
``attn_impl="pallas"`` each kernel epilogue (temporal conv, transformer
output projection) hands per-(b·f, c) (Σ, Σ²) to the next GroupNorm,
including across the skip concatenations. Off ``"pallas"`` no producer
emits sums, as in JAX, and every GroupNorm computes its own statistics.

Gradient checkpointing (``remat=True``, JAX's ``_sub_layers``) wraps each
sub-layer call (resnet, temp_conv, spatial transformer, temporal
transformer) in ``torch.utils.checkpoint`` while autograd records: only the
sub-layers' inputs and outputs, the GroupNorm sums that cross a boundary
among them, stay alive until the backward, which re-runs one sub-layer's
forward (its kernels included) at a time.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from animate_anything_tpu_torch.models.attention import SpatialTransformer, TemporalTransformer
from animate_anything_tpu_torch.models.layers import (Downsample2D, ResnetBlock2D,
                                                      TemporalConvLayer, Upsample2D)
from animate_anything_tpu_torch.parallel import frame


def _fold_frames(sums, nf: int):
    """Per-(b·f, c) (Σ, Σ²) → per-(b, c), over this rank's frames of ``nf``
    under a frame split (``parallel/frame.py``; the temporal transformer sums
    them over the group)."""
    if sums is None:
        return None
    nf = frame.local_frames(nf)
    s1, s2 = sums
    n, c = s1.shape
    return s1.reshape(n // nf, nf, c).sum(1), s2.reshape(n // nf, nf, c).sum(1)


def _concat_sums(a, b):
    """Sums of a channel concat are the parts' sums side by side."""
    if a is None or b is None:
        return None
    return torch.cat([a[0], b[0]], dim=1), torch.cat([a[1], b[1]], dim=1)


def run_layer(remat: bool, layer: nn.Module, *args):
    """``layer(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
    return layer(*args)


class _Layered(nn.Module):
    """Shared constructor pieces: resnets, temp_convs and, for cross-attention
    blocks, attentions and temp_attentions."""

    def _build(self, ins: list, out_channels: int, temb: int, groups: int, eps: float,
               head_dim: Optional[int], cross_dim: Optional[int], attn_impl: str):
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin, out_channels, temb, groups, eps, impl=attn_impl) for cin in ins])
        self.temp_convs = nn.ModuleList(
            [TemporalConvLayer(out_channels, impl=attn_impl) for _ in ins])
        if head_dim is not None:
            heads = out_channels // head_dim
            self.attentions = nn.ModuleList(
                [SpatialTransformer(out_channels, heads, head_dim, cross_dim, groups=groups,
                                    attn_impl=attn_impl) for _ in ins])
            self.temp_attentions = nn.ModuleList(
                [TemporalTransformer(out_channels, heads, head_dim, groups=groups,
                                     attn_impl=attn_impl) for _ in ins])


class CrossAttnDownBlock3D(_Layered):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, head_dim: int = 64, cross_attention_dim: int = 1024,
                 groups: int = 32, eps: float = 1e-5, add_downsample: bool = True,
                 remat: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        self.remat = remat
        ins = [in_channels] + [out_channels] * (num_layers - 1)
        self._build(ins, out_channels, temb_channels, groups, eps, head_dim,
                    cross_attention_dim, attn_impl)
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels)]) if add_downsample else None

    def forward(self, x, temb, context, num_frames: int, in_sums=None, pab=None):
        outputs, out_sums, cur = [], [], in_sums
        for resnet, tconv, attn, tattn in zip(self.resnets, self.temp_convs, self.attentions,
                                              self.temp_attentions):
            x = run_layer(self.remat, resnet, x, temb, cur)
            entry = None
            if num_frames > 1:
                x, entry = run_layer(self.remat, tconv, x, num_frames)
            x, sp = run_layer(self.remat, attn, x, context, entry, pab)
            cur = sp
            if num_frames > 1:
                x, cur = run_layer(self.remat, tattn, x, num_frames,
                                   _fold_frames(sp, num_frames), pab)
            outputs.append(x)
            out_sums.append(cur)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
            out_sums.append(None)
            cur = None
        return x, outputs, out_sums, cur


class DownBlock3D(_Layered):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, groups: int = 32, eps: float = 1e-5,
                 add_downsample: bool = True, remat: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        self.remat = remat
        ins = [in_channels] + [out_channels] * (num_layers - 1)
        self._build(ins, out_channels, temb_channels, groups, eps, None, None, attn_impl)
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels)]) if add_downsample else None

    def forward(self, x, temb, num_frames: int, in_sums=None):
        outputs, out_sums, cur = [], [], in_sums
        for resnet, tconv in zip(self.resnets, self.temp_convs):
            x = run_layer(self.remat, resnet, x, temb, cur)
            cur = None
            if num_frames > 1:
                x, cur = run_layer(self.remat, tconv, x, num_frames)
            outputs.append(x)
            out_sums.append(cur)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
            out_sums.append(None)
            cur = None
        return x, outputs, out_sums, cur


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, num_layers: int = 1,
                 head_dim: int = 64, cross_attention_dim: int = 1024, groups: int = 32,
                 eps: float = 1e-5, remat: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        self.remat = remat
        heads = in_channels // head_dim
        n = num_layers + 1
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels, in_channels, temb_channels, groups, eps, impl=attn_impl)
             for _ in range(n)])
        self.temp_convs = nn.ModuleList(
            [TemporalConvLayer(in_channels, impl=attn_impl) for _ in range(n)])
        self.attentions = nn.ModuleList(
            [SpatialTransformer(in_channels, heads, head_dim, cross_attention_dim, groups=groups,
                                attn_impl=attn_impl) for _ in range(num_layers)])
        self.temp_attentions = nn.ModuleList(
            [TemporalTransformer(in_channels, heads, head_dim, groups=groups, attn_impl=attn_impl)
             for _ in range(num_layers)])

    def forward(self, x, temb, context, num_frames: int, in_sums=None, pab=None):
        x = run_layer(self.remat, self.resnets[0], x, temb, in_sums)
        entry = None
        if num_frames > 1:
            x, entry = run_layer(self.remat, self.temp_convs[0], x, num_frames)
        cur = entry
        for i, (attn, tattn) in enumerate(zip(self.attentions, self.temp_attentions)):
            x, sp = run_layer(self.remat, attn, x, context, entry, pab)
            cur = sp
            if num_frames > 1:
                x, cur = run_layer(self.remat, tattn, x, num_frames,
                                   _fold_frames(sp, num_frames), pab)
            x = run_layer(self.remat, self.resnets[i + 1], x, temb, cur)
            entry = None
            if num_frames > 1:
                x, entry = run_layer(self.remat, self.temp_convs[i + 1], x, num_frames)
            cur = entry
        return x, cur


class CrossAttnUpBlock3D(_Layered):
    def __init__(self, in_channels: int, prev_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, head_dim: int = 64,
                 cross_attention_dim: int = 1024, groups: int = 32, eps: float = 1e-5,
                 add_upsample: bool = True, remat: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        self.remat = remat
        ins = [(prev_channels if i == 0 else out_channels)
               + (in_channels if i == num_layers - 1 else out_channels)
               for i in range(num_layers)]
        self._build(ins, out_channels, temb_channels, groups, eps, head_dim,
                    cross_attention_dim, attn_impl)
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, skips, temb, context, num_frames: int, in_sums=None, skip_sums=None,
                output_size=None, pab=None):
        cur = in_sums
        for resnet, tconv, attn, tattn in zip(self.resnets, self.temp_convs, self.attentions,
                                              self.temp_attentions):
            sk_sums = skip_sums.pop() if skip_sums else None
            x = torch.cat([x, skips.pop()], dim=-1)
            x = run_layer(self.remat, resnet, x, temb, _concat_sums(cur, sk_sums))
            entry = None
            if num_frames > 1:
                x, entry = run_layer(self.remat, tconv, x, num_frames)
            x, sp = run_layer(self.remat, attn, x, context, entry, pab)
            cur = sp
            if num_frames > 1:
                x, cur = run_layer(self.remat, tattn, x, num_frames,
                                   _fold_frames(sp, num_frames), pab)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, output_size)
            cur = None
        return x, cur


class UpBlock3D(_Layered):
    def __init__(self, in_channels: int, prev_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, groups: int = 32, eps: float = 1e-5,
                 add_upsample: bool = True, remat: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        self.remat = remat
        ins = [(prev_channels if i == 0 else out_channels)
               + (in_channels if i == num_layers - 1 else out_channels)
               for i in range(num_layers)]
        self._build(ins, out_channels, temb_channels, groups, eps, None, None, attn_impl)
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, skips, temb, num_frames: int, in_sums=None, skip_sums=None,
                output_size=None):
        cur = in_sums
        for resnet, tconv in zip(self.resnets, self.temp_convs):
            sk_sums = skip_sums.pop() if skip_sums else None
            x = torch.cat([x, skips.pop()], dim=-1)
            x = run_layer(self.remat, resnet, x, temb, _concat_sums(cur, sk_sums))
            cur = None
            if num_frames > 1:
                x, cur = run_layer(self.remat, tconv, x, num_frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, output_size)
            cur = None
        return x, cur
