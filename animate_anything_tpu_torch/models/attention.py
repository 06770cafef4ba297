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

Under tensor parallelism (``parallel/tensor.shard_model``) an attention
site whose heads the axis divides holds its rank's heads (``local_heads``)
and a feed-forward its rank's hidden columns; their outputs are summed over
the axis before the bias and the residual are added once (kernels 2 and 5
in their ``partial`` mode). Kernels 1 and 9 and the flash backward run
unchanged on the local heads.

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
from animate_anything_tpu_torch.ops.group_norm import local_sums
from animate_anything_tpu_torch.ops.attention import attention
from animate_anything_tpu_torch.ops.geglu import ln_geglu_ff
from animate_anything_tpu_torch.ops.proj_residual import proj_residual_stats
from animate_anything_tpu_torch.ops.temporal_attention import temporal_attention
from animate_anything_tpu_torch.ops.temporal_block import fused_ok, kernel_ok, temporal_block
from animate_anything_tpu_torch.parallel import frame
from animate_anything_tpu_torch.parallel.tensor import add_once, copy_to, row_parallel


class HeadsSite(nn.Module):
    """An attention site: ``heads`` heads of ``head_dim``, of which this
    rank holds ``local_heads`` under a tensor axis (``tp``)."""
    tp = None

    @property
    def local_heads(self) -> int:
        return self.heads // (1 if self.tp is None else self.tp.size)


class CrossAttention(HeadsSite):
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
        x = copy_to(x, self.tp)
        ctx = x if context is None else copy_to(context, self.tp)
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        heads = self.local_heads
        q = self.to_q(x).reshape(b, sq, heads, self.head_dim)
        k = self.to_k(ctx).reshape(b, sk, heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, sk, heads, self.head_dim)
        out = attention(q, k, v, impl=self.attn_impl, tag=(self.path, context is not None))
        return row_parallel(self.to_out[0], out.reshape(b, sq, heads * self.head_dim), self.tp)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP (diffusers FeedForward, mult 4), exact-erf GELU. Keys
    net.0.proj, net.2. Under a tensor axis (``tp``) net.0.proj holds the
    val and gate rows of its rank's hidden columns side by side, so the
    halves of its output are the rank's values and their gates."""
    tp = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.net[0].proj(copy_to(x, self.tp)).chunk(2, dim=-1)
        return row_parallel(self.net[2], h * F.gelu(gate), self.tp)

    def fused_tail(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        """x + FF(LayerNorm(x)) through kernel 2 (tanh GELU); under a
        tensor axis its partial mode, summed over the axis."""
        proj, out = self.net[0].proj, self.net[2]
        if self.tp is None:
            return ln_geglu_ff(x, norm.weight, norm.bias, proj.weight, proj.bias, out.weight,
                               out.bias, eps=norm.eps)
        # the fused LN's inputs, x and its affine, feed every rank's slice
        x_in, s, b = (copy_to(t, self.tp) for t in (x, norm.weight, norm.bias))
        y = ln_geglu_ff(x_in, s, b, proj.weight, proj.bias, out.weight, None, eps=norm.eps,
                        partial=True)
        return add_once(y, out.bias, x, self.tp)


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


class TemporalSelfAttention(HeadsSite):
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
        x = copy_to(x, self.tp)
        b, f, s, _ = x.shape
        heads = self.local_heads
        shape = (b, f, s, heads, self.head_dim)
        q, k, v = (proj(x).reshape(shape) for proj in (self.to_q, self.to_k, self.to_v))
        out = temporal_attention(q, k, v, impl=self.attn_impl).to(x.dtype)
        return row_parallel(self.to_out[0], out.reshape(b, f, s, heads * self.head_dim), self.tp)

    def fused_block(self, h: torch.Tensor, norm: nn.LayerNorm, kernel=None) -> torch.Tensor:
        """h + attn(LN(h)) through kernel 5 (``kernel``: its wrapper as the
        caller's module names it); under a tensor axis on the rank's heads
        in its partial mode, summed over the axis."""
        run = temporal_block if kernel is None else kernel
        out = self.to_out[0]
        w = (self.to_q.weight, self.to_k.weight, self.to_v.weight, out.weight)
        if self.tp is None:
            return run(h, norm.weight, norm.bias, *w, out.bias, heads=self.heads, eps=norm.eps)
        # the fused LN's inputs, h and its affine, feed every rank's heads
        h_in, s, b = (copy_to(t, self.tp) for t in (h, norm.weight, norm.bias))
        y = run(h_in, s, b, *w, None, heads=self.local_heads, eps=norm.eps, partial=True)
        return add_once(y, out.bias, h, self.tp)


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
                    h = attn.fused_block(h.to(dt), norm)
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
        inner) view. Under a frame split (``parallel/frame.active``) x holds
        this rank's frames: the norm (its sums summed over the frame group),
        proj_in and the blocks run on all frames of a slice of positions
        between two all-to-alls, and the result is this rank's frames again."""
        shard = frame.active()
        nf = frame.local_frames(num_frames)
        bf, hh, ww, c = x.shape
        b, s = bf // nf, hh * ww
        h = x.reshape(b, nf, s, c)
        rows = None
        if shard is not None:
            h = shard.to_positions(h)
            if entry_sums is None:
                entry_sums = local_sums(h.reshape(b, -1, c))
            entry_sums = shard.reduce(*entry_sums)
            rows = num_frames * s
        h = self.proj_in(self.norm(h, sums=entry_sums, rows=rows))
        inner = self.heads * self.head_dim
        fused = self.attn_impl == "pallas" and fused_ok(num_frames, inner, self.heads,
                                                        self.head_dim)
        kernel5 = kernel_ok(num_frames, inner, self.heads)
        for block in self.transformer_blocks:
            h = block(h, fused, kernel5)
        return h if shard is None else shard.to_frames(h, s)

    def _delta(self, x, num_frames: int, entry_sums=None):
        """The residual delta, ``proj_out`` a plain Linear (JAX's ``_delta``)."""
        return self.proj_out(self._hidden(x, num_frames, entry_sums)).reshape(x.shape)
