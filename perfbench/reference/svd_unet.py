"""Plain float32 forward of Stable Video Diffusion's spatio-temporal UNet
(``UNetSpatioTemporalConditionModel``, stabilityai/stable-video-diffusion
``unet/config.json``) with AnimateAnything's ninth input channel, the motion
mask, first; and the CLIP ViT-H image tower with its projection.

Each resnet is the spatial resnet mixed with a frame-axis resnet by a
learned α = sigmoid(mix_factor); each transformer is the spatial block and
a temporal block over the frames (with a frame-position embedding) mixed
the same way, both attending to the per-batch image embedding. The
feed-forwards of both blocks use the tanh GELU, as the configuration's
``attn_impl="pallas"`` states; the CLIP tower's MLP the exact form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics, group_norm, layer_norm
from perfbench.reference.unet3d import UNet3D, timestep_embedding

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class SVDUNet(UNet3D):
    """``cfg``: the configuration file's ``unet`` group."""

    def __init__(self, P: dict, cfg: dict, num: Numerics):
        self.P, self.cfg, self.num, self.remat = P, cfg, num, False
        self.groups = 32
        self.eps = cfg["norm_eps"]
        self.head_dim = cfg["block_out_channels"][0] // cfg["num_attention_heads"][0]

    def embed(self, x, key):
        return self.lin(F.silu(self.lin(x, f"{key}.linear_1")), f"{key}.linear_2")

    def mix(self, key, spatial, temporal):
        a = torch.sigmoid(self.P[f"{key}.mix_factor"].float()[0])
        return a * spatial + (1.0 - a) * temporal

    def tap_stage(self, h, key_norm, key_conv):
        h = group_norm(h, self.P[f"{key_norm}.weight"], self.P[f"{key_norm}.bias"], 32, 1e-6,
                       silu=True)
        w, bias = self.P[f"{key_conv}.weight"], self.P[f"{key_conv}.bias"]
        prev = F.pad(h[:, :-1], (0, 0, 0, 0, 1, 0))
        nxt = F.pad(h[:, 1:], (0, 0, 0, 0, 0, 1))
        return (self.num.linear(prev, w[:, :, 0, 0, 0]) + self.num.linear(h, w[:, :, 1, 0, 0])
                + self.num.linear(nxt, w[:, :, 2, 0, 0]) + bias.float())

    def st_resnet(self, x, temb, nf, key):
        h = self.resnet(x, temb, f"{key}.spatial_res_block")
        bf, hh, ww, c = h.shape
        t = h.reshape(bf // nf, nf, hh * ww, c)
        tk = f"{key}.temporal_res_block"
        y = self.tap_stage(t, f"{tk}.norm1", f"{tk}.conv1")
        y = y + self.lin(F.silu(temb), f"{tk}.time_emb_proj").reshape(bf // nf, nf, 1, c)
        y = self.tap_stage(y, f"{tk}.norm2", f"{tk}.conv2") + t
        return self.mix(f"{key}.time_mixer", h, y.reshape(bf, hh, ww, c))

    def broadcast_attn(self, x, context, key, heads):
        """(b, f, s, c) queries to each batch's own (b, L, ctx) tokens."""
        b, f, s, _ = x.shape
        d = self.head_dim
        q = self.lin(x, f"{key}.to_q", False).reshape(b, f * s, heads, d)
        k = self.lin(context, f"{key}.to_k", False).reshape(b, -1, heads, d)
        v = self.lin(context, f"{key}.to_v", False).reshape(b, -1, heads, d)
        o = self.num.attention(q, k, v).reshape(b, f, s, heads * d)
        return self.lin(o, f"{key}.to_out.0")

    def st_transformer(self, x, context, nf, key, heads):
        bf, hh, ww, c = x.shape
        b = bf // nf
        inner = heads * self.head_dim
        h = group_norm(x, self.P[f"{key}.norm.weight"], self.P[f"{key}.norm.bias"], 32, 1e-6)
        h = self.lin(h.reshape(bf, hh * ww, c), f"{key}.proj_in")
        blk = f"{key}.transformer_blocks.0"
        ctx = context.float().repeat_interleave(nf, dim=0)
        h = h + self.attn(self.ln(h, f"{blk}.norm1"), f"{blk}.attn1", heads)
        h = h + self.attn(self.ln(h, f"{blk}.norm2"), f"{blk}.attn2", heads, ctx)
        h = h + self.geglu(self.ln(h, f"{blk}.norm3"), f"{blk}.ff")
        f_emb = self.embed(timestep_embedding(torch.arange(nf, device=x.device), inner),
                           f"{key}.time_pos_embed")
        t = h.reshape(b, nf, hh * ww, inner) + f_emb[None, :, None, :]
        tb = f"{key}.temporal_transformer_blocks.0"
        t = t + self.geglu(self.ln(t, f"{tb}.norm_in"), f"{tb}.ff_in")
        t = t + self.frame_attn(self.ln(t, f"{tb}.norm1"), f"{tb}.attn1", heads)
        t = t + self.broadcast_attn(self.ln(t, f"{tb}.norm2"), context.float(), f"{tb}.attn2",
                                    heads)
        t = t + self.geglu(self.ln(t, f"{tb}.norm3"), f"{tb}.ff")
        h = self.mix(f"{key}.time_mixer", h, t.reshape(bf, hh * ww, inner))
        return self.lin(h, f"{key}.proj_out").reshape(bf, hh, ww, c) + x

    def __call__(self, sample, t, context, added):
        """sample (b, f, h, w, 9) [mask ‖ scaled latents ‖ condition], t the
        continuous timestep, context (b, L, 1024), added (b, 3) → (b, f, h, w, 4)."""
        cfg = self.cfg
        ch, heads = cfg["block_out_channels"], cfg["num_attention_heads"]
        b, nf, hh, ww, cin = sample.shape
        dev = sample.device
        emb = self.embed(timestep_embedding(torch.full((b,), float(t), device=dev), ch[0]),
                         "time_embedding")
        add = timestep_embedding(added.float().reshape(-1), cfg["addition_time_embed_dim"])
        emb = emb + self.embed(add.reshape(b, -1), "add_embedding")
        emb = emb.repeat_interleave(nf, dim=0)
        x = self.conv(sample.float().reshape(b * nf, hh, ww, cin), "conv_in")
        n = len(ch)
        skips = [x]
        for i in range(n):
            for j in range(cfg["layers_per_block"]):
                x = self.st_resnet(x, emb, nf, f"down_blocks.{i}.resnets.{j}")
                if i < n - 1:
                    x = self.st_transformer(x, context, nf, f"down_blocks.{i}.attentions.{j}",
                                            heads[i])
                skips.append(x)
            if i < n - 1:
                x = self.conv(x, f"down_blocks.{i}.downsamplers.0.conv", stride=2)
                skips.append(x)
        x = self.st_resnet(x, emb, nf, "mid_block.resnets.0")
        x = self.st_transformer(x, context, nf, "mid_block.attentions.0", heads[-1])
        x = self.st_resnet(x, emb, nf, "mid_block.resnets.1")
        for i in range(n):
            for j in range(cfg["layers_per_block"] + 1):
                x = self.st_resnet(torch.cat([x, skips.pop()], dim=-1), emb, nf,
                                   f"up_blocks.{i}.resnets.{j}")
                if i > 0:
                    x = self.st_transformer(x, context, nf, f"up_blocks.{i}.attentions.{j}",
                                            heads[n - 1 - i])
            if i < n - 1:
                size = tuple(skips[-1].shape[1:3])
                x = F.interpolate(x.permute(0, 3, 1, 2), size=size,
                                  mode="nearest").permute(0, 2, 3, 1)
                x = self.conv(x, f"up_blocks.{i}.upsamplers.0.conv")
        x = self.conv(self.gn(x, "conv_norm_out", self.eps, True), "conv_out")
        return x.reshape(b, nf, hh, ww, -1)


def clip_pixels(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 RGB (h, w, 3) → (1, size, size, 3): PIL's bicubic resize, then
    CLIP's mean and standard deviation."""
    from PIL import Image

    arr = np.asarray(Image.fromarray(image).resize((size, size), Image.BICUBIC),
                     np.float32) / 255.0
    return ((arr - CLIP_MEAN) / CLIP_STD)[None]


class CLIPVision:
    def __init__(self, P: dict, cfg: dict, num: Numerics):
        self.P, self.cfg, self.num = P, cfg, num

    def lin(self, x, key, bias=True):
        return self.num.linear(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"] if bias else None)

    def ln(self, x, key):
        return layer_norm(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"])

    def __call__(self, pixels: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) normalised → (b, projection_dim) image embeddings."""
        P, pre, cfg = self.P, "vision_model", self.cfg
        p = cfg["patch_size"]
        x = self.num.conv2d(pixels.float(), P[f"{pre}.embeddings.patch_embedding.weight"], None,
                            p, 0)
        b = x.shape[0]
        x = x.reshape(b, -1, x.shape[-1])
        cls = P[f"{pre}.embeddings.class_embedding"].float().expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + P[f"{pre}.embeddings.position_embedding.weight"].float()[:x.shape[1]][None]
        x = self.ln(x, f"{pre}.pre_layrnorm")
        heads, hid = cfg["num_attention_heads"], x.shape[-1]
        for i in range(cfg["num_hidden_layers"]):
            key = f"{pre}.encoder.layers.{i}"
            h = self.ln(x, f"{key}.layer_norm1")
            q, k, v = (self.lin(h, f"{key}.self_attn.{n}").reshape(b, -1, heads, hid // heads)
                       for n in ("q_proj", "k_proj", "v_proj"))
            o = self.num.attention(q, k, v).reshape(b, -1, hid)
            x = x + self.lin(o, f"{key}.self_attn.out_proj")
            h = self.ln(x, f"{key}.layer_norm2")
            x = x + self.lin(F.gelu(self.lin(h, f"{key}.mlp.fc1")), f"{key}.mlp.fc2")
        pooled = self.ln(x[:, 0], f"{pre}.post_layernorm")
        return self.lin(pooled, "visual_projection", bias=False)
