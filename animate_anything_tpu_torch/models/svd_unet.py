"""Spatio-temporal UNet of Stable Video Diffusion — the port of
``animate_anything_tpu/models/svd_unet.py``.

- every resnet is a ``SpatioTemporalResBlock``: the spatial resnet, a
  frame-axis resnet (two GroupNorm → SiLU → (3, 1, 1)-conv stages), and a
  learned ``AlphaBlender`` mix;
- every transformer is a ``TransformerSpatioTemporalModel``: the spatial
  block, then a temporal block over the frames (with a frame-position
  embedding) mixed back in by an ``AlphaBlender``, both cross-attending to
  the per-batch CLIP image embedding;
- the micro-conditioning ``added_time_ids`` (fps − 1, motion bucket, noise
  augmentation) enters through a second embedding added to the time
  embedding; the timestep is continuous (0.25·log σ) and stays fp32 up to
  its sinusoids;
- channels 320/640/1280/1280, heads 5/10/20/20 (head dim 64), cross dim
  1024, 8 input channels or 9 with the motion mask FIRST.

Layout: input (b, f, h, w, c), the fused (b·f, h, w, c) spatial batch
inside; CFG is an ordinary batch doubling by the caller.

Under ``attn_impl="pallas"`` the forward runs kernel 1 (spatial
self-attention where s ≥ 128), kernel 2 (the spatial block's tail and the
temporal block's ``ff_in`` and ``ff``), kernel 3 (both stages of every
temporal resnet, GroupNorm eps 1e-6, stage 2 with the residual) and kernel 5
(the temporal block's norm1 + attn1 where JAX's ``fused_ok`` holds).
Nothing else is a kernel: the entry and output GroupNorms are flax's plain
fp32 ``nn.GroupNorm``, ``proj_in`` / ``proj_out`` plain Linears, the
spatial resnets composite (JAX builds them without ``impl``, so kernel 8
never runs here), the temporal cross-attention plain einsums. Under
``"xla"`` and ``"packed"``: the composite modules, SDPA for the spatial
attention, kernel 9 for the frame attention under ``"packed"``.

Parameter names are the diffusers keys that JAX's ``export_svd_unet``
writes (``utils/convert.py::svd_unet_state_dict``), so they load with
``strict=True``. ``gradient_checkpointing`` recomputes each
``SpatioTemporalResBlock`` and ``TransformerSpatioTemporalModel`` in the
backward while autograd records (JAX's per-sub-layer ``nn.remat``).
``pab`` (a ``models/pab.PABStep`` with one flag) reaches every
``TransformerSpatioTemporalModel``: on a reuse step it adds its cached
residual delta and runs nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.models.attention import (BasicTransformerBlock, GEGLUFeedForward,
                                                         HeadsSite, TemporalSelfAttention)
from animate_anything_tpu_torch.models.layers import (Conv2d, Downsample2D, Linear,
                                                      ResnetBlock2D, TemporalTapConv,
                                                      TimestepEmbedding, Upsample2D, layer_norm,
                                                      timestep_embedding)
from animate_anything_tpu_torch.models.unet3d import ATTN_IMPLS
from animate_anything_tpu_torch.models.unet3d_blocks import run_layer
from animate_anything_tpu_torch.ops.group_norm import group_norm_silu
from animate_anything_tpu_torch.ops.temporal_block import fused_ok, kernel_ok, temporal_block
from animate_anything_tpu_torch.ops.temporal_conv import gn_silu_tap_conv
from animate_anything_tpu_torch.parallel.tensor import copy_to, row_parallel
from animate_anything_tpu_torch.utils.ptp import tag_attention_paths
from animate_anything_tpu_torch.utils.tracing import traced


@dataclasses.dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8                      # 9 with the motion mask
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    projection_class_embeddings_input_dim: int = 768  # 3 ids × 256
    addition_time_embed_dim: int = 256
    norm_eps: float = 1e-5
    # "pallas" | "xla" | "packed" | None, which means "xla" (as UNet3DConfig)
    attn_impl: Optional[str] = None
    gradient_checkpointing: bool = False

    def __post_init__(self):
        if self.attn_impl is not None and self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"SVDUNetConfig.attn_impl must be None or one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")

    @property
    def impl(self) -> str:
        return self.attn_impl or "xla"

    @classmethod
    def tiny(cls, **kw) -> "SVDUNetConfig":
        d = dict(block_out_channels=(32, 64, 64, 64), num_attention_heads=(2, 4, 4, 4),
                 cross_attention_dim=32, addition_time_embed_dim=8,
                 projection_class_embeddings_input_dim=24)
        d.update(kw)
        return cls(**d)


def group_norm_fp32(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``nn.GroupNorm(dtype=float32)`` on (n, ..., c): statistics per
    sample over every other axis, output in fp32."""
    n, c, g = x.shape[0], x.shape[-1], norm.num_groups
    xf = x.float().reshape(n, -1, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    return y * norm.weight.float() + norm.bias.float()


class AlphaBlender(nn.Module):
    """α·spatial + (1 − α)·temporal with α = sigmoid(mix_factor) in the
    inputs' dtype (diffusers ``merge_strategy="learned"``)."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float()[0]).to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class TemporalResnetBlock(nn.Module):
    """Two GroupNorm(32, eps 1e-6) → SiLU → (3, 1, 1)-conv stages over the
    frames, statistics pooled over (f, h·w) per batch, the per-(b, f) time
    bias between them, the input added after the second. Under ``"pallas"``
    each stage is kernel 3 (``ops/temporal_conv.gn_silu_tap_conv``, stage 2
    with the residual), otherwise the composite GroupNorm + ``TemporalTapConv``."""

    def __init__(self, channels: int, temb_channels: int, impl: str):
        super().__init__()
        self.impl = impl
        self.norm1 = nn.GroupNorm(32, channels, eps=1e-6)
        self.conv1 = TemporalTapConv(channels, channels)
        self.time_emb_proj = Linear(temb_channels, channels)
        self.norm2 = nn.GroupNorm(32, channels, eps=1e-6)
        self.conv2 = TemporalTapConv(channels, channels)

    def _stage(self, h, norm, conv, residual=None):
        if self.impl == "pallas":
            return gn_silu_tap_conv(h, norm.weight, norm.bias, conv.weight, conv.bias,
                                    groups=norm.num_groups, eps=norm.eps, residual=residual)[0]
        y = conv(group_norm_silu(h, norm.weight, norm.bias, norm.num_groups, norm.eps))
        return y if residual is None else y + residual

    def forward(self, x: torch.Tensor, temb: torch.Tensor, num_frames: int) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        b = bf // num_frames
        h = x.reshape(b, num_frames, hh * ww, c).to(self.conv1.weight.dtype)
        identity = h
        h = self._stage(h, self.norm1, self.conv1)
        h = h + self.time_emb_proj(F.silu(temb)).reshape(b, num_frames, 1, -1)
        h = self._stage(h, self.norm2, self.conv2, residual=identity)
        return h.reshape(bf, hh, ww, c)


class SpatioTemporalResBlock(nn.Module):
    """The spatial resnet, then (for more than one frame) the temporal one
    mixed in. The spatial resnet is JAX's, built without ``impl``: always
    the composite path, so kernel 8 never runs under any switch."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, eps: float,
                 impl: str):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, temb_channels,
                                               eps=eps, impl="composite")
        self.temporal_res_block = TemporalResnetBlock(out_channels, temb_channels, impl)
        self.time_mixer = AlphaBlender()

    def forward(self, x: torch.Tensor, temb: torch.Tensor, num_frames: int) -> torch.Tensor:
        h = self.spatial_res_block(x, temb)
        if num_frames > 1:
            h = self.time_mixer(h, self.temporal_res_block(h, temb, num_frames))
        return h


class BroadcastCrossAttention(HeadsSite):
    """Cross-attention from (b, f, s, c) queries to a per-batch context
    (b, L, ctx): every frame and location of batch b attends to b's L
    tokens, fp32 scores and softmax, probabilities in v's dtype. Plain torch,
    no layout transpose; keys as ``CrossAttention``. (diffusers 0.24
    flattens the queries (hw, b)-major instead, which pairs other contexts
    with other rows at b > 1; the port follows JAX.)"""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x, context = copy_to(x, self.tp), copy_to(context, self.tp)
        b, f, s, _ = x.shape
        hd = (self.local_heads, self.head_dim)
        q = self.to_q(x).reshape(b, f, s, *hd)
        k = self.to_k(context).reshape(b, -1, *hd)
        v = self.to_v(context).reshape(b, -1, *hd)
        scores = torch.einsum("bfshd,blhd->bfshl", q.float(), k.float()) * self.head_dim ** -0.5
        probs = scores.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bfshl,blhd->bfshd", probs.float(), v.float()).to(x.dtype)
        return row_parallel(self.to_out[0], out.reshape(b, f, s, -1), self.tp)


class TemporalBasicTransformerBlock(nn.Module):
    """ff_in → self-attention over the frames → cross-attention to the
    context → ff, on the (b, f, h·w, c) view, each with its residual. Under
    ``"pallas"``: norm_in + ff_in and norm3 + ff through kernel 2 (tanh
    GELU), norm1 + attn1 through kernel 5 where JAX's ``fused_ok`` holds
    (else its composite, as JAX's). Otherwise the exact-erf GEGLU and
    ``TemporalSelfAttention(attn_impl)``, kernel 9 under ``"packed"``."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int, attn_impl: str):
        super().__init__()
        self.attn_impl = attn_impl
        self.norm_in = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = GEGLUFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = TemporalSelfAttention(dim, heads, head_dim, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = BroadcastCrossAttention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        _, f, _, c = x.shape
        a1 = self.attn1
        dt = a1.to_q.weight.dtype
        pallas = self.attn_impl == "pallas"
        if pallas:
            x = self.ff_in.fused_tail(x.to(dt), self.norm_in)
        else:
            x = x + self.ff_in(layer_norm(x, self.norm_in, dt))
        inner = a1.heads * a1.head_dim
        if pallas and fused_ok(f, inner, a1.heads, a1.head_dim) and inner == c \
                and kernel_ok(f, c, a1.heads):
            x = a1.fused_block(x.to(dt), self.norm1, temporal_block)
        else:
            x = x + a1(layer_norm(x, self.norm1, dt))
        x = x + self.attn2(layer_norm(x, self.norm2, dt), context)
        if pallas:
            return self.ff.fused_tail(x.to(dt), self.norm3)
        return x + self.ff(layer_norm(x, self.norm3, dt))


class TransformerSpatioTemporalModel(nn.Module):
    """The entry GroupNorm (32, eps 1e-6, fp32, per frame) → proj_in → the
    spatial block (context repeated per frame) → the temporal block on
    (b, f, h·w, inner) plus the frame-position embedding, mixed back in by
    ``time_mixer`` → proj_out, + x."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 attn_impl: str):
        super().__init__()
        inner = heads * head_dim
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim, attn_impl=attn_impl)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, head_dim, context_dim, attn_impl)])
        self.time_pos_embed = TimestepEmbedding(inner, inner * 4, out_dim=inner)
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor, num_frames: int,
                pab=None) -> torch.Tensor:
        """x (b·f, h, w, c), context (b, L, ctx) → (b·f, h, w, c); under
        ``pab`` the residual delta is cached or computed by its flag."""
        if pab is None:
            return self._delta(x, context, num_frames) + x
        delta = pab.cache.delta(self, x, pab.flag("spatial"), self.proj_out.weight.dtype,
                                lambda: self._delta(x, context, num_frames))
        return delta + x

    def _delta(self, x: torch.Tensor, context: torch.Tensor, num_frames: int) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        f = num_frames
        b = bf // f
        dt = self.proj_in.weight.dtype
        inner = self.proj_in.out_features
        h = self.proj_in(group_norm_fp32(x, self.norm).reshape(bf, hh * ww, c))
        context = context.to(dt)
        f_emb = timestep_embedding(torch.arange(f, dtype=torch.float32, device=x.device),
                                   inner).to(dt)
        f_emb = self.time_pos_embed(f_emb)
        h = self.transformer_blocks[0](h, context.repeat_interleave(f, dim=0))
        if f > 1:
            hm = h.reshape(b, f, hh * ww, inner) + f_emb[None, :, None, :]
            hm = self.temporal_transformer_blocks[0](hm, context)
            h = self.time_mixer(h, hm.reshape(bf, hh * ww, inner))
        return self.proj_out(h).reshape(bf, hh, ww, c)


class BlockContainers(nn.Module):
    """A diffusers block's containers: ``resnets``, ``attentions`` (empty
    where the block has none) and its down- or upsampler."""

    def __init__(self, resnets, attentions, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, config: SVDUNetConfig):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        ch0, temb = ch[0], ch[0] * 4
        heads = cfg.num_attention_heads
        impl, xd, eps = cfg.impl, cfg.cross_attention_dim, cfg.norm_eps
        n = len(ch)

        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)

        def res(cin, cout):
            return SpatioTemporalResBlock(cin, cout, temb, eps, impl)

        def attn(i):
            return TransformerSpatioTemporalModel(ch[i], heads[i], ch[i] // heads[i], xd, impl)

        self.down_blocks = nn.ModuleList()
        skip_ch, prev = [ch0], ch0
        for i in range(n):
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(res(prev, ch[i]))
                if i < n - 1:
                    attentions.append(attn(i))
                prev = ch[i]
                skip_ch.append(prev)
            down = Downsample2D(prev) if i < n - 1 else None
            if down is not None:
                skip_ch.append(prev)
            self.down_blocks.append(BlockContainers(resnets, attentions, downsample=down))

        self.mid_block = BlockContainers([res(ch[-1], ch[-1]), res(ch[-1], ch[-1])],
                                         [attn(n - 1)])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i in range(n):
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(res(prev + skip_ch.pop(), rev[i]))
                if i > 0:
                    attentions.append(attn(n - 1 - i))
                prev = rev[i]
            up = Upsample2D(prev) if i < n - 1 else None
            self.up_blocks.append(BlockContainers(resnets, attentions, upsample=up))

        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=eps)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)
        # JAX names the mid transformer ``mid_attentions_0``: no "mid" place
        tag_attention_paths(self, {"mid_block": "mid_attentions"})

    def with_attn_impl(self, attn_impl: str) -> "UNetSpatioTemporalConditionModel":
        """This UNet under another ``attn_impl``, sharing its parameters."""
        with torch.device("meta"):
            other = UNetSpatioTemporalConditionModel(
                dataclasses.replace(self.config, attn_impl=attn_impl))
        other.load_state_dict(self.state_dict(), strict=True, assign=True)
        return other.train(self.training)

    @traced("unet")
    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                added_time_ids: torch.Tensor, pab=None) -> torch.Tensor:
        """sample (b, f, h, w, in_channels), timestep () or (b,) continuous
        (never rounded), encoder_hidden_states (b, L, cross_dim),
        added_time_ids (b, 3) → (b, f, h, w, out_channels). ``pab``: this
        step's ``models/pab.PABStep`` (one flag), or None."""
        cfg = self.config
        b, f, hh, ww, _ = sample.shape
        ch0 = cfg.block_out_channels[0]
        dt = self.time_embedding.linear_1.weight.dtype
        dev = sample.device

        t = torch.as_tensor(timestep, dtype=torch.float32, device=dev).reshape(-1).expand(b)
        emb = self.time_embedding(timestep_embedding(t, ch0).to(dt))
        add = timestep_embedding(added_time_ids.reshape(-1).float(), cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(add.reshape(b, -1).to(dt))
        emb = emb.repeat_interleave(f, dim=0)
        ctx = encoder_hidden_states

        x = self.conv_in(sample.reshape(b * f, hh, ww, cfg.in_channels))
        remat = cfg.gradient_checkpointing
        skips = [x]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = run_layer(remat, resnet, x, emb, f)
                if len(blk.attentions):
                    x = run_layer(remat, blk.attentions[j], x, ctx, f, pab)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = run_layer(remat, mid.resnets[0], x, emb, f)
        x = run_layer(remat, mid.attentions[0], x, ctx, f, pab)
        x = run_layer(remat, mid.resnets[1], x, emb, f)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = run_layer(remat, resnet, torch.cat([x, skips.pop()], dim=-1), emb, f)
                if len(blk.attentions):
                    x = run_layer(remat, blk.attentions[j], x, ctx, f, pab)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x, tuple(skips[-1].shape[1:3]))

        x = self.conv_out(F.silu(group_norm_fp32(x, self.conv_norm_out)))
        return x.reshape(b, f, hh, ww, cfg.out_channels)
