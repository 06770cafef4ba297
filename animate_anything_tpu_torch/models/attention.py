"""Spatial and temporal transformer modules — the port of
``animate_anything_tpu/models/attention.py``. Every module takes JAX's
``attn_impl`` (the UNet's default, ``None``, reaches them as ``"xla"``).

Under ``attn_impl="pallas"``:

- spatial: seq = h·w per frame, batch = b·f; self-attention through kernel
  1 (ops/attention.py), cross-attention over the text tokens plain; the
  feed-forward tail through kernel 2; the output projection + residual +
  GroupNorm sums through kernel 4.
- temporal: seq = f per spatial location on the (b, f, h·w, inner) view,
  inner = heads·head_dim. JAX's gate ``fused_ok(f, inner, heads, head_dim)``
  picks the branch, as in its ``TemporalTransformer._hidden``: the fused
  branch runs norm1+attn1 and norm2+attn2 each as kernel 5 and the
  norm3+feed-forward tail as kernel 2 (tanh GELU); the composite branch
  runs the frame attention and the exact-erf GEGLU feed-forward in plain
  torch. At full width every temporal transformer takes the fused branch,
  ``transformer_in`` (inner = 8 × 64 = 512 on 320 channels) included. Where
  JAX's gate admits a head dim kernel 5 does not take (d > 256,
  ``temporal_block.kernel_ok``; no configuration of the repo has one), the
  fused branch runs each LN + frame attention + out-projection + residual
  as the composite does, the same function as JAX's fused block, and keeps
  kernel 2's tail: a shape gate on both devices, not a fallback. The
  output projection runs kernel 4.

Under a PAB cache (``pab=``, ``models/pab.py``) both transformers return
``delta + x`` with the delta from the cache or from their body with a plain
``proj_out``, and no output sums, as JAX's ``pab_reuse`` branch does.

Under ``attn_impl="xla"`` or ``"packed"`` (JAX's composite configuration):
all attention goes to ``ops/attention.xla_attention`` (SDPA on the card),
the feed-forward is norm3 + the exact-erf GEGLU, the output projection a
plain Linear + residual with no output sums, and every temporal transformer
takes the composite branch, whose frame attention is
``ops/temporal_attention.temporal_attention(impl=attn_impl)``: the einsum
form under ``"xla"``, kernel 9 under ``"packed"`` where JAX's gate admits it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.models.layers import FusedGroupNorm, Linear, layer_norm
from animate_anything_tpu_torch.ops.attention import attention
from animate_anything_tpu_torch.ops.geglu import ln_geglu_ff
from animate_anything_tpu_torch.ops.proj_residual import proj_residual_stats
from animate_anything_tpu_torch.ops.temporal_attention import temporal_attention
from animate_anything_tpu_torch.ops.temporal_block import fused_ok, kernel_ok, temporal_block


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None. Keys:
    to_q/to_k/to_v (no bias), to_out.0 (bias). ``path``: the module path a
    UNet gives it (``utils/ptp.tag_attention_paths``), tagged on every call
    with whether it attends to a context, as JAX's ``tag``."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int] = None,
                 attn_impl: str = "pallas"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.attn_impl = heads, head_dim, attn_impl
        self.path: tuple = ()
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x).reshape(b, sq, self.heads, self.head_dim)
        k = self.to_k(ctx).reshape(b, sk, self.heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, sk, self.heads, self.head_dim)
        out = attention(q, k, v, impl=self.attn_impl, tag=(self.path, context is not None))
        out = out.reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP (diffusers FeedForward, mult 4), exact-erf GELU. Keys
    net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))

    def fused_tail(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        """x + FF(LayerNorm(x)) through kernel 2 (tanh GELU)."""
        proj, out = self.net[0].proj, self.net[2]
        return ln_geglu_ff(x, norm.weight, norm.bias, proj.weight, proj.bias, out.weight,
                           out.bias, eps=norm.eps)


class BasicTransformerBlock(nn.Module):
    """Pre-LN block: self-attn → cross-attn → GEGLU feed-forward; under
    ``attn_impl="pallas"`` the tail LN + FF + residual is fused in kernel 2
    (tanh GELU), otherwise it is norm3 + the exact-erf feed-forward."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.attn_impl = attn_impl
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, head_dim, attn_impl=attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim=context_dim,
                                    attn_impl=attn_impl)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = self.attn1.to_q.weight.dtype
        x = x + self.attn1(layer_norm(x, self.norm1, dt))
        x = x + self.attn2(layer_norm(x, self.norm2, dt), context)
        if self.attn_impl == "pallas":
            return self.ff.fused_tail(x.to(dt), self.norm3)
        return x + self.ff(layer_norm(x, self.norm3, dt))


class SpatialTransformer(nn.Module):
    """Transformer2DModel over the h·w sequence of each frame, linear
    proj_in/proj_out; under ``attn_impl="pallas"`` proj_out + residual +
    output sums run kernel 4, otherwise a plain Linear + residual."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 num_layers: int = 1, groups: int = 32, attn_impl: str = "pallas"):
        super().__init__()
        inner = heads * head_dim
        self.attn_impl = attn_impl
        self.norm = FusedGroupNorm(channels, groups, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim, attn_impl=attn_impl)
             for _ in range(num_layers)])
        self.proj_out = Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor, entry_sums=None, pab=None):
        """x (b·f, h, w, c), context (b·f, seq, ctx_dim) → (y, out_sums) with
        out_sums the per-(b·f, c) fp32 (Σy, Σy²), None off ``"pallas"`` and
        under ``pab`` (a ``models/pab.PABStep``: the delta cached or
        computed by its ``"spatial"`` flag)."""
        bf, hh, ww, c = x.shape
        if pab is not None:
            delta = pab.cache.delta(self, x, pab.flag("spatial"), self.proj_out.weight.dtype,
                                    lambda: self._delta(x, context, entry_sums))
            return delta + x, None
        h = self._hidden(x, context, entry_sums)
        if self.attn_impl != "pallas":
            return self.proj_out(h).reshape(bf, hh, ww, c) + x, None
        dt = self.proj_out.weight.dtype
        y, sums = proj_residual_stats(h.to(dt), self.proj_out.weight, self.proj_out.bias,
                                      x.reshape(bf, hh * ww, c).to(dt))
        return y.reshape(bf, hh, ww, c), sums

    def _hidden(self, x, context, entry_sums=None):
        """The entry GroupNorm, proj_in and the blocks: (b·f, h·w, inner)."""
        bf, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x, sums=entry_sums).reshape(bf, hh * ww, c))
        for block in self.transformer_blocks:
            h = block(h, context)
        return h

    def _delta(self, x, context, entry_sums=None):
        """The residual delta, ``proj_out`` a plain Linear (JAX's ``_delta``)."""
        return self.proj_out(self._hidden(x, context, entry_sums)).reshape(x.shape)


class TemporalSelfAttention(nn.Module):
    """Self-attention over the FRAME axis of a (b, f, s, c) tensor, no layout
    transpose. Keys as CrossAttention."""

    def __init__(self, dim: int, heads: int, head_dim: int, attn_impl: str = "pallas"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.attn_impl = heads, head_dim, attn_impl
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, s, _ = x.shape
        shape = (b, f, s, self.heads, self.head_dim)
        q, k, v = (proj(x).reshape(shape) for proj in (self.to_q, self.to_k, self.to_v))
        out = temporal_attention(q, k, v, impl=self.attn_impl).to(x.dtype)
        return self.to_out[0](out.reshape(b, f, s, self.heads * self.head_dim))


class TemporalBasicBlock(nn.Module):
    """Double-self-attention block on (b, f, s, c): LN → frame attention ×2 →
    LN → GEGLU feed-forward, each with a residual. Keys as
    BasicTransformerBlock. ``fused``: each LN + attention through kernel 5
    (or, where ``kernel5`` is False, through ``TemporalSelfAttention``), the
    tail through kernel 2 (tanh GELU); otherwise plain torch with the
    exact-erf GELU around ``TemporalSelfAttention``."""

    def __init__(self, dim: int, heads: int, head_dim: int, attn_impl: str = "pallas"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = TemporalSelfAttention(dim, heads, head_dim, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = TemporalSelfAttention(dim, heads, head_dim, attn_impl)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, h: torch.Tensor, fused: bool, kernel5: bool) -> torch.Tensor:
        dt = self.attn1.to_q.weight.dtype
        if fused:
            for norm, attn in ((self.norm1, self.attn1), (self.norm2, self.attn2)):
                if kernel5:
                    h = temporal_block(h.to(dt), norm.weight, norm.bias, attn.to_q.weight,
                                       attn.to_k.weight, attn.to_v.weight,
                                       attn.to_out[0].weight, attn.to_out[0].bias,
                                       heads=attn.heads, eps=norm.eps)
                else:
                    h = h + attn(layer_norm(h, norm, dt))
            return self.ff.fused_tail(h.to(dt), self.norm3)
        h = h + self.attn1(layer_norm(h, self.norm1, dt))
        h = h + self.attn2(layer_norm(h, self.norm2, dt))
        return h + self.ff(layer_norm(h, self.norm3, dt))


class TemporalTransformer(nn.Module):
    """TransformerTemporalModel: attention over the frame axis per spatial
    location, on the (b, f, h·w, c) view; under ``attn_impl="pallas"``
    proj_out + residual + output sums run kernel 4, otherwise a plain
    Linear + residual."""

    def __init__(self, channels: int, heads: int, head_dim: int, num_layers: int = 1,
                 groups: int = 32, attn_impl: str = "pallas"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.attn_impl = heads, head_dim, attn_impl
        self.norm = FusedGroupNorm(channels, groups, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [TemporalBasicBlock(inner, heads, head_dim, attn_impl) for _ in range(num_layers)])
        self.proj_out = Linear(inner, channels)

    def forward(self, x: torch.Tensor, num_frames: int, entry_sums=None, pab=None):
        """x (b·f, h, w, c) → (y, out_sums), out_sums None off ``"pallas"``
        and under ``pab`` (its ``"temporal"`` flag; see SpatialTransformer).
        entry_sums: per-(b, c) sums for the entry GroupNorm, whose statistics
        pool over (f, h, w) per batch (torch GroupNorm on (b, c, f, h, w))."""
        bf, hh, ww, c = x.shape
        if pab is not None:
            delta = pab.cache.delta(self, x, pab.flag("temporal"), self.proj_out.weight.dtype,
                                    lambda: self._delta(x, num_frames, entry_sums))
            return delta + x, None
        h = self._hidden(x, num_frames, entry_sums)
        if self.attn_impl != "pallas":
            return self.proj_out(h).reshape(bf, hh, ww, c) + x, None
        dt = self.proj_out.weight.dtype
        y, sums = proj_residual_stats(h.reshape(bf, hh * ww, -1).to(dt), self.proj_out.weight,
                                      self.proj_out.bias, x.reshape(bf, hh * ww, c).to(dt))
        return y.reshape(bf, hh, ww, c), sums

    def _hidden(self, x, num_frames: int, entry_sums=None):
        """The entry GroupNorm, proj_in and the blocks on the (b, f, h·w,
        inner) view."""
        bf, hh, ww, c = x.shape
        b = bf // num_frames
        h = self.norm(x.reshape(b, num_frames, hh, ww, c), sums=entry_sums)
        h = self.proj_in(h.reshape(b, num_frames, hh * ww, c))
        inner = self.heads * self.head_dim
        fused = self.attn_impl == "pallas" and fused_ok(num_frames, inner, self.heads,
                                                        self.head_dim)
        kernel5 = kernel_ok(num_frames, inner, self.heads)
        for block in self.transformer_blocks:
            h = block(h, fused, kernel5)
        return h

    def _delta(self, x, num_frames: int, entry_sums=None):
        """The residual delta, ``proj_out`` a plain Linear (JAX's ``_delta``)."""
        return self.proj_out(self._hidden(x, num_frames, entry_sums)).reshape(x.shape)
