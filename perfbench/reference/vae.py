"""Plain float32 SD VAE (``AutoencoderKL``, 8× down, 4 latent channels)
on the diffusers state-dict keys, channels-last: the posterior mode times the
scaling factor on the way in, the decoder on the way out."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics, group_norm


class VAE:
    def __init__(self, P: dict, cfg: dict, num: Numerics):
        self.P, self.cfg, self.num = P, cfg, num
        self.groups = cfg["norm_num_groups"]
        self.scale = cfg["scaling_factor"]

    def conv(self, x, key, stride=1, padding=1):
        return self.num.conv2d(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"], stride,
                               padding)

    def gn(self, x, key, silu=True):
        return group_norm(x, self.P[f"{key}.weight"], self.P[f"{key}.bias"], self.groups, 1e-6,
                          silu)

    def resnet(self, x, key):
        h = self.conv(self.gn(x, f"{key}.norm1"), f"{key}.conv1")
        h = self.conv(self.gn(h, f"{key}.norm2"), f"{key}.conv2")
        if f"{key}.conv_shortcut.weight" in self.P:
            x = self.conv(x, f"{key}.conv_shortcut", padding=0)
        return x + h

    def attention(self, x, key):
        b, hh, ww, c = x.shape
        h = self.gn(x, f"{key}.group_norm", silu=False).reshape(b, hh * ww, c)
        q, k, v = (self.num.linear(h, self.P[f"{key}.{n}.weight"], self.P[f"{key}.{n}.bias"])
                   .reshape(b, hh * ww, 1, c) for n in ("to_q", "to_k", "to_v"))
        o = self.num.attention(q, k, v).reshape(b, hh * ww, c)
        o = self.num.linear(o, self.P[f"{key}.to_out.0.weight"], self.P[f"{key}.to_out.0.bias"])
        return x + o.reshape(b, hh, ww, c)

    def mid(self, h, key):
        h = self.resnet(h, f"{key}.resnets.0")
        h = self.attention(h, f"{key}.attentions.0")
        return self.resnet(h, f"{key}.resnets.1")

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        """(n, h, w, 3) in [-1, 1] → (n, h/8, w/8, 4): the posterior mean
        times the scaling factor."""
        ch = self.cfg["block_out_channels"]
        h = self.conv(pixels.float(), "encoder.conv_in")
        for i in range(len(ch)):
            for j in range(self.cfg["layers_per_block"]):
                h = self.resnet(h, f"encoder.down_blocks.{i}.resnets.{j}")
            if i < len(ch) - 1:  # asymmetric pad (0, 1), stride 2
                h = self.conv(F.pad(h, (0, 0, 0, 1, 0, 1)),
                              f"encoder.down_blocks.{i}.downsamplers.0.conv", 2, 0)
        h = self.mid(h, "encoder.mid_block")
        h = self.conv(self.gn(h, "encoder.conv_norm_out"), "encoder.conv_out")
        moments = self.conv(h, "quant_conv", padding=0)
        return moments[..., :self.cfg["latent_channels"]] * self.scale

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(n, h, w, 4) scaled latents → (n, 8h, 8w, 3)."""
        ch = self.cfg["block_out_channels"]
        h = self.conv(z.float() / self.scale, "post_quant_conv", padding=0)
        h = self.mid(self.conv(h, "decoder.conv_in"), "decoder.mid_block")
        for i in range(len(ch)):
            for j in range(self.cfg["layers_per_block"] + 1):
                h = self.resnet(h, f"decoder.up_blocks.{i}.resnets.{j}")
            if i < len(ch) - 1:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = self.conv(h, f"decoder.up_blocks.{i}.upsamplers.0.conv")
        return self.conv(self.gn(h, "decoder.conv_norm_out"), "decoder.conv_out")

    def decode_video(self, latents: torch.Tensor, chunk: int = 4) -> torch.Tensor:
        """(b, f, h, w, 4) → (b, f, 8h, 8w, 3), ``chunk`` frames at a time."""
        b, f, h, w, c = latents.shape
        flat = latents.reshape(b * f, h, w, c)
        out = torch.cat([self.decode(z) for z in flat.split(chunk)])
        return out.reshape(b, f, 8 * h, 8 * w, -1)
