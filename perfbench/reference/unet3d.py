"""Plain float32 forward of the mask + motion-strength 3D UNet
(AnimateAnything's ``UNet3DConditionModel``: the ModelScope text-to-video
UNet with a mask channel in front of ``conv_in2`` and the motion strength as
the time embedding's condition), written from the architecture on the
diffusers state-dict keys.

Channels-last throughout: a video is (b, f, h, w, c), the spatial layers run
on the (b·f, h, w, c) batch. The first-frame condition latent joins along
the frame axis and the output drops it. The feed-forwards of the spatial
and temporal transformers use the tanh form of GELU, as the configuration's
``attn_impl="pallas"`` states; the text encoder's is the exact form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.numerics import Numerics, group_norm, layer_norm


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoids [cos ‖ sin] (diffusers ``Timesteps``, flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    emb = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class UNet3D:
    """``P``: the state dict (any float dtype; read as float32); ``cfg``: the
    configuration file's ``unet`` group; ``remat``: each sub-layer
    recomputed in the backward (``torch.utils.checkpoint``) while autograd
    records, so that a float32 backward fits."""

    def __init__(self, P: dict, cfg: dict, num: Numerics, remat: bool = False):
        self.P, self.cfg, self.num, self.remat = P, cfg, num, remat
        self.groups = cfg["norm_num_groups"]
        self.eps = cfg["norm_eps"]
        self.head_dim = cfg["attention_head_dim"]

    def sub(self, fn, *args):
        """A sub-layer's call, recomputed in the backward under ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- layers -------------------------------------------------------------

    def lin(self, x, key, bias=True):
        P = self.P
        return self.num.linear(x, P[f"{key}.weight"], P[f"{key}.bias"] if bias else None)

    def conv(self, x, key, stride=1, padding=1):
        P = self.P
        return self.num.conv2d(x, P[f"{key}.weight"], P[f"{key}.bias"], stride, padding)

    def gn(self, x, key, eps, silu=False):
        return group_norm(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"], self.groups, eps,
                          silu)

    def ln(self, x, key):
        return layer_norm(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"])

    def resnet(self, x, temb, key):
        h = self.conv(self.gn(x, f"{key}.norm1", self.eps, True), f"{key}.conv1")
        h = h + self.lin(F.silu(temb), f"{key}.time_emb_proj")[:, None, None, :]
        h = self.conv(self.gn(h, f"{key}.norm2", self.eps, True), f"{key}.conv2")
        if f"{key}.conv_shortcut.weight" in self.P:
            x = self.num.conv2d(x, self.P[f"{key}.conv_shortcut.weight"],
                                self.P[f"{key}.conv_shortcut.bias"], 1, 0)
        return x + h

    def temporal_conv(self, x, nf, key):
        """Four GroupNorm → SiLU → conv(3, 1, 1) stages over the frame axis
        (zero frames past the ends), GroupNorm statistics per sample over
        (frames, positions) in 32 groups whatever the UNet's own, and the
        residual."""
        bf, hh, ww, c = x.shape
        h = x.reshape(bf // nf, nf, hh * ww, c)
        identity = h
        for i in range(1, 5):
            seq = f"{key}.conv{i}"
            h = group_norm(h, self.P[f"{seq}.0.weight"], self.P[f"{seq}.0.bias"], 32, 1e-5,
                           silu=True)
            w = self.P[f"{seq}.{2 if i == 1 else 3}.weight"]
            bias = self.P[f"{seq}.{2 if i == 1 else 3}.bias"]
            prev = F.pad(h[:, :-1], (0, 0, 0, 0, 1, 0))
            nxt = F.pad(h[:, 1:], (0, 0, 0, 0, 0, 1))
            h = (self.num.linear(prev, w[:, :, 0, 0, 0]) + self.num.linear(h, w[:, :, 1, 0, 0])
                 + self.num.linear(nxt, w[:, :, 2, 0, 0]) + bias.float())
        return (identity + h).reshape(bf, hh, ww, c)

    def attn(self, x, key, heads, context=None):
        b, sq, _ = x.shape
        ctx = x if context is None else context
        d = self.head_dim
        q = self.lin(x, f"{key}.to_q", False).reshape(b, sq, heads, d)
        k = self.lin(ctx, f"{key}.to_k", False).reshape(b, ctx.shape[1], heads, d)
        v = self.lin(ctx, f"{key}.to_v", False).reshape(b, ctx.shape[1], heads, d)
        o = self.num.attention(q, k, v)
        return self.lin(o.reshape(b, sq, heads * d), f"{key}.to_out.0")

    def frame_attn(self, x, key, heads):
        """Self-attention over the frame axis of (b, f, s, c)."""
        b, f, s, _ = x.shape
        d = self.head_dim

        def proj(name):
            t = self.lin(x, f"{key}.{name}", False).reshape(b, f, s, heads, d)
            return t.permute(0, 2, 1, 3, 4).reshape(b * s, f, heads, d)

        o = self.num.attention(proj("to_q"), proj("to_k"), proj("to_v"))
        o = o.reshape(b, s, f, heads * d).permute(0, 2, 1, 3)
        return self.lin(o, f"{key}.to_out.0")

    def geglu(self, x, key):
        h, gate = self.lin(x, f"{key}.net.0.proj").chunk(2, dim=-1)
        return self.lin(h * F.gelu(gate, approximate="tanh"), f"{key}.net.2")

    def spatial_transformer(self, x, context, key, heads):
        bf, hh, ww, c = x.shape
        h = self.gn(x, f"{key}.norm", 1e-6).reshape(bf, hh * ww, c)
        h = self.lin(h, f"{key}.proj_in")
        blk = f"{key}.transformer_blocks.0"
        h = h + self.attn(self.ln(h, f"{blk}.norm1"), f"{blk}.attn1", heads)
        h = h + self.attn(self.ln(h, f"{blk}.norm2"), f"{blk}.attn2", heads, context)
        h = h + self.geglu(self.ln(h, f"{blk}.norm3"), f"{blk}.ff")
        return self.lin(h, f"{key}.proj_out").reshape(bf, hh, ww, c) + x

    def temporal_transformer(self, x, nf, key, heads, groups=None):
        bf, hh, ww, c = x.shape
        h = x.reshape(bf // nf, nf, hh * ww, c)
        h = group_norm(h, self.P[f"{key}.norm.weight"], self.P[f"{key}.norm.bias"],
                       groups or self.groups, 1e-6)
        h = self.lin(h, f"{key}.proj_in")
        blk = f"{key}.transformer_blocks.0"
        h = h + self.frame_attn(self.ln(h, f"{blk}.norm1"), f"{blk}.attn1", heads)
        h = h + self.frame_attn(self.ln(h, f"{blk}.norm2"), f"{blk}.attn2", heads)
        h = h + self.geglu(self.ln(h, f"{blk}.norm3"), f"{blk}.ff")
        return self.lin(h, f"{key}.proj_out").reshape(bf, hh, ww, c) + x

    def layer(self, x, temb, context, nf, key, i, heads):
        """One [resnet → temporal conv → spatial → temporal transformer] layer
        (the transformers only where the block has them)."""
        x = self.sub(self.resnet, x, temb, f"{key}.resnets.{i}")
        x = self.sub(self.temporal_conv, x, nf, f"{key}.temp_convs.{i}")
        if heads:
            x = self.sub(self.spatial_transformer, x, context, f"{key}.attentions.{i}", heads)
            x = self.sub(self.temporal_transformer, x, nf, f"{key}.temp_attentions.{i}", heads)
        return x

    # -- the model ------------------------------------------------------------

    def __call__(self, sample, t, text, condition, mask, motion):
        """sample (b, f, h, w, 4), t a timestep or (b,) timesteps, text (b, 77,
        d), condition (b, 1, h, w, 4), mask (b, 1, h, w, 1), motion (b,) →
        (b, f, h, w, 4)."""
        cfg = self.cfg
        ch = cfg["block_out_channels"]
        sample = torch.cat([condition.float(), sample.float()], dim=1)
        b, nf, hh, ww, _ = sample.shape
        dev = sample.device
        ts = torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(-1).expand(b)
        emb = timestep_embedding(ts, ch[0])
        emb = emb + self.lin(timestep_embedding(motion.float().reshape(b), ch[0]),
                             "time_embedding.cond_proj", False)
        emb = self.lin(F.silu(self.lin(emb, "time_embedding.linear_1")),
                       "time_embedding.linear_2").repeat_interleave(nf, dim=0)
        context = text.float().repeat_interleave(nf, dim=0)
        mk = mask.float().expand(b, nf, hh, ww, 1)
        x = self.conv(torch.cat([mk, sample], dim=-1).reshape(b * nf, hh, ww, -1), "conv_in2")
        x = self.sub(self.temporal_transformer, x, nf, "transformer_in", 8, 32)

        skips = [x]
        n_down = len(cfg["down_block_types"])
        for i, kind in enumerate(cfg["down_block_types"]):
            heads = ch[i] // self.head_dim if kind == "CrossAttnDownBlock3D" else 0
            for j in range(cfg["layers_per_block"]):
                x = self.layer(x, emb, context, nf, f"down_blocks.{i}", j, heads)
                skips.append(x)
            if i < n_down - 1:
                x = self.conv(x, f"down_blocks.{i}.downsamplers.0.conv", stride=2)
                skips.append(x)

        heads = ch[-1] // self.head_dim
        x = self.sub(self.resnet, x, emb, "mid_block.resnets.0")
        x = self.sub(self.temporal_conv, x, nf, "mid_block.temp_convs.0")
        x = self.sub(self.spatial_transformer, x, context, "mid_block.attentions.0", heads)
        x = self.sub(self.temporal_transformer, x, nf, "mid_block.temp_attentions.0", heads)
        x = self.sub(self.resnet, x, emb, "mid_block.resnets.1")
        x = self.sub(self.temporal_conv, x, nf, "mid_block.temp_convs.1")

        rev = list(reversed(ch))
        n_up = len(cfg["up_block_types"])
        for i, kind in enumerate(cfg["up_block_types"]):
            heads = rev[i] // self.head_dim if kind == "CrossAttnUpBlock3D" else 0
            for j in range(cfg["layers_per_block"] + 1):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = self.layer(x, emb, context, nf, f"up_blocks.{i}", j, heads)
            if i < n_up - 1:
                size = skips[-1].shape[1:3]
                x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                                  mode="nearest").permute(0, 2, 3, 1)
                x = self.conv(x, f"up_blocks.{i}.upsamplers.0.conv")

        x = self.conv(self.gn(x, "conv_norm_out", self.eps, True), "conv_out")
        return x.reshape(b, nf, hh, ww, -1)[:, 1:]
