"""LaMa large-mask inpainting (Fourier convolutions) for watermark removal —
the port of ``animate_anything_tpu/models/lama.py``.

The big-lama FFC generator (Suvorov et al., arXiv 2109.07161): a fast
Fourier convolution splits its channels into a local part (spatial convs)
and a global part (a spectral transform over the whole image), and the
generator inpaints the masked region of each frame. Used offline to scrub
watermarks from training videos.

NCHW throughout. The Fourier unit is ``torch.fft.rfft2(norm="ortho")`` →
a 1×1 conv on the (re, im) channels → inference BatchNorm → ReLU →
``irfft2(s=(h, w))``, in fp32 as JAX computes it. FFT, convs and BatchNorm
are work that JAX leaves to XLA, so they run as cuFFT and cuDNN calls here.

The modules keep the published generator's key layout: the Sequential
``model.N.*`` of the reference, ``ffc.convl2l`` / ``convl2g`` / ``convg2l`` /
``convg2g`` where each channel split is non-zero, ``bn_l`` / ``bn_g``, the
spectral transform's ``conv1.0`` / ``conv1.1`` / ``fu.conv_layer`` /
``fu.bn`` / ``conv2``, and the Fourier unit's interleaved channels
(c0_re, c0_im, c1_re, …). So a ``best.ckpt`` generator state dict loads
with ``strict=True`` once its ``generator.`` prefix is stripped
(``load_generator_state``); no download is built in.

``inpaint_video`` runs on the card (JAX pins its tool to the CPU because
its TPU platform has no FFT); it raises without a GPU unless
``device="cpu"`` is passed. The CLI::

    python -m animate_anything_tpu_torch.models.lama <video> <mask.png> <ckpt> [--out]
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn


class FourierUnit(nn.Module):
    """rfft2 → 1×1 conv on the interleaved (re, im) channels → BN → ReLU →
    irfft2, in fp32."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(in_channels * 2, out_channels * 2, 1, bias=False)
        self.bn = nn.BatchNorm2d(out_channels * 2)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        f = torch.fft.rfft2(x.float(), norm="ortho")                 # (n, c, h, w/2+1)
        f = torch.stack((f.real, f.imag), dim=2).reshape(n, 2 * c, h, f.shape[-1])
        f = self.relu(self.bn(self.conv_layer(f)))
        f = f.reshape(n, -1, 2, h, f.shape[-1])
        out = torch.fft.irfft2(torch.complex(f[:, :, 0], f[:, :, 1]), s=(h, w), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    """(2× average pool at stride 2) → 1×1 conv / BN / ReLU → Fourier unit →
    1×1 conv of the sum."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.downsample = nn.AvgPool2d(2, 2) if stride == 2 else nn.Identity()
        half = out_channels // 2
        self.conv1 = nn.Sequential(nn.Conv2d(in_channels, half, 1, bias=False),
                                   nn.BatchNorm2d(half), nn.ReLU(inplace=True))
        self.fu = FourierUnit(half, half)
        self.conv2 = nn.Conv2d(half, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.downsample(x))
        return self.conv2(h + self.fu(h))


def _split(channels: int, ratio: float) -> Tuple[int, int]:
    """(local, global) channel counts."""
    g = int(channels * ratio)
    return channels - g, g


class FFC(nn.Module):
    """Fast Fourier convolution: the l2l, g2l and l2g paths are reflect-padded
    convs, g2g a spectral transform; each exists only where its input and
    output splits are non-zero."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float = 0.0, ratio_gout: float = 0.0, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        in_cl, in_cg = _split(in_channels, ratio_gin)
        out_cl, out_cg = _split(out_channels, ratio_gout)

        def conv(cin, cout):
            return nn.Conv2d(cin, cout, kernel_size, stride, padding, bias=False,
                             padding_mode="reflect")

        self.convl2l = conv(in_cl, out_cl) if in_cl and out_cl else None
        self.convg2l = conv(in_cg, out_cl) if in_cg and out_cl else None
        self.convl2g = conv(in_cl, out_cg) if in_cl and out_cg else None
        self.convg2g = SpectralTransform(in_cg, out_cg, stride) if in_cg and out_cg else None

    def forward(self, x):
        x_l, x_g = x if isinstance(x, tuple) else (x, None)
        out_l = out_g = None
        if self.convl2l is not None:
            out_l = self.convl2l(x_l)
        if self.convg2l is not None:
            g2l = self.convg2l(x_g)
            out_l = g2l if out_l is None else out_l + g2l
        if self.convl2g is not None:
            out_g = self.convl2g(x_l)
        if self.convg2g is not None:
            g2g = self.convg2g(x_g)
            out_g = g2g if out_g is None else out_g + g2g
        return out_l, out_g


class FFCBnAct(nn.Module):
    """FFC → BatchNorm → ReLU on each non-empty branch (the reference's
    ``FFC_BN_ACT``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float = 0.0, ratio_gout: float = 0.0, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        out_cl, out_cg = _split(out_channels, ratio_gout)
        self.ffc = FFC(in_channels, out_channels, kernel_size, ratio_gin, ratio_gout, stride,
                       padding)
        self.bn_l = nn.BatchNorm2d(out_cl) if out_cl else None
        self.bn_g = nn.BatchNorm2d(out_cg) if out_cg else None
        self.act = nn.ReLU(inplace=True)

    def forward(self, x):
        x_l, x_g = self.ffc(x)
        if x_l is not None:
            x_l = self.act(self.bn_l(x_l))
        if x_g is not None:
            x_g = self.act(self.bn_g(x_g))
        return x_l, x_g


class FFCResnetBlock(nn.Module):
    """Two 3×3 ``FFCBnAct`` with the residual added to each branch."""

    def __init__(self, dim: int, ratio: float = 0.75):
        super().__init__()
        self.conv1 = FFCBnAct(dim, dim, 3, ratio, ratio, padding=1)
        self.conv2 = FFCBnAct(dim, dim, 3, ratio, ratio, padding=1)

    def forward(self, x):
        x_l, x_g = x
        h_l, h_g = self.conv2(self.conv1((x_l, x_g)))
        return x_l + h_l, x_g + h_g


class ConcatTupleLayer(nn.Module):
    def forward(self, x):
        x_l, x_g = x
        return x_l if x_g is None else torch.cat([x_l, x_g], dim=1)


@dataclasses.dataclass(frozen=True)
class LamaConfig:
    input_nc: int = 4
    output_nc: int = 3
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 18
    max_features: int = 1024


class LargeMaskInpainting(nn.Module):
    """The big-lama generator. ``forward(img, mask)``: img (n, 3, h, w) in
    [0, 1], mask (n, 1, h, w) in {0, 1} → mask·pred + (1 − mask)·img."""

    def __init__(self, cfg: LamaConfig = LamaConfig()):
        super().__init__()
        self.cfg = c = cfg
        layers = [nn.ReflectionPad2d(3), FFCBnAct(c.input_nc, c.ngf, 7)]
        for i in range(c.n_downsampling):
            mult = 2 ** i
            gout = 0.75 if i == c.n_downsampling - 1 else 0.0
            layers.append(FFCBnAct(min(c.max_features, c.ngf * mult),
                                   min(c.max_features, c.ngf * mult * 2), 3,
                                   ratio_gout=gout, stride=2, padding=1))
        dim = min(c.max_features, c.ngf * 2 ** c.n_downsampling)
        layers += [FFCResnetBlock(dim) for _ in range(c.n_blocks)]
        layers.append(ConcatTupleLayer())
        for i in range(c.n_downsampling):
            mult = 2 ** (c.n_downsampling - i)
            cin = min(c.max_features, c.ngf * mult)
            cout = min(c.max_features, c.ngf * mult // 2)
            layers += [nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1),
                       nn.BatchNorm2d(cout), nn.ReLU(inplace=True)]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(c.ngf, c.output_nc, 7), nn.Sigmoid()]
        self.model = nn.Sequential(*layers)

    def forward(self, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        masked = img * (1.0 - mask)
        pred = self.model(torch.cat([masked, mask], dim=1))
        return mask * pred + (1.0 - mask) * img


def load_generator_state(path: str) -> dict:
    """A ``best.ckpt`` (``{"state_dict": {"generator.model.…": …}}``) or a
    bare generator state dict → the generator's keys, prefix stripped."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    state = state.get("state_dict", state)
    if any(k.startswith("generator.") for k in state):
        state = {k[len("generator."):]: v for k, v in state.items()
                 if k.startswith("generator.")}
    return state


@torch.no_grad()
def inpaint_video(frames: np.ndarray, mask: np.ndarray, module: LargeMaskInpainting,
                  chunk: int = 8, device="cuda") -> np.ndarray:
    """Inpaint an (f, h, w, 3) uint8 video under an (h, w) {0, 255} mask
    (≥ 0.5 after /255 is inpainted), ``chunk`` frames a forward, on
    ``device`` (the card unless ``device="cpu"``); → uint8, clipped to [0, 1]
    then ×255 and truncated, as JAX's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("inpaint_video: no CUDA device (pass device='cpu' for the CPU)")
    module = module.to(dev).eval()
    m = torch.as_tensor((np.asarray(mask, np.float32) / 255.0 >= 0.5).astype(np.float32),
                        device=dev)[None, None]
    outs = []
    for i in range(0, frames.shape[0], chunk):
        batch = torch.as_tensor(np.ascontiguousarray(frames[i:i + chunk]), device=dev)
        imgs = (batch.float() / 255.0).permute(0, 3, 1, 2)
        out = module(imgs, m.expand(imgs.shape[0], -1, -1, -1))
        outs.append((out.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu())
    return torch.cat(outs).numpy()


def _main(argv=None, cfg: LamaConfig = LamaConfig()) -> str:
    """python -m animate_anything_tpu_torch.models.lama <video> <mask.png>
    <ckpt> [--out PATH] [--device cpu]: offline watermark removal; prints and
    returns the written path (``save_video`` writes a gif when no mp4 writer
    exists). ``cfg``: the generator's config, the published big-lama's by
    default."""
    import argparse

    from PIL import Image

    from animate_anything_tpu_torch.utils.media import load_video_frames, save_video

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("video")
    ap.add_argument("mask", help="grayscale png; white = region to inpaint")
    ap.add_argument("checkpoint", help="big-lama best.ckpt (torch)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    module = LargeMaskInpainting(cfg)
    module.load_state_dict(load_generator_state(args.checkpoint), strict=True)
    frames = load_video_frames(args.video)
    mask = np.asarray(Image.open(args.mask).convert("L"))
    out = inpaint_video(frames, mask, module, device=args.device)
    dst = args.out or (args.video.rsplit(".", 1)[0] + "_inpainted.mp4")
    path = save_video(dst, out)
    print(path)
    return path


if __name__ == "__main__":
    _main()
