"""The masked SVD image-to-video request in plain PyTorch: the CLIP image
embedding (the unconditional half zeros), the noise-augmented image through
the VAE encoder over the scaling factor, repeated per frame (the
unconditional half zeros), the mask channel first, the micro-conditioning
ids (fps − 1, motion bucket, augmentation), a per-frame guidance ramp, Euler
steps over Karras σ with the EDM parameterisation, the VAE decode.

``check`` judges a program's record of one request; ``run`` is the whole
flow in the given numerics, recording the same things.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.checks import rel_rms, worst
from perfbench.reference.numerics import Numerics
from perfbench.reference.svd_unet import CLIPVision, SVDUNet, clip_pixels
from perfbench.reference.vae import VAE


def karras(cfg: dict, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(σ_0 … σ_{n−1}, 0) and the continuous timesteps 0.25·log σ, float64
    rounded to float32."""
    ramp = np.linspace(0, 1, steps)
    lo, hi, rho = cfg["sigma_min"] ** (1 / cfg["rho"]), cfg["sigma_max"] ** (1 / cfg["rho"]), \
        cfg["rho"]
    sig = (hi + ramp * (lo - hi)) ** rho
    ts = (0.25 * np.log(sig)).astype(np.float32)
    return np.concatenate([sig, [0.0]]).astype(np.float32), ts


def euler(x, out, sigma: float, sigma_next: float):
    x = x.float()
    x0 = out.float() * (-sigma / (sigma ** 2 + 1) ** 0.5) + x / (sigma ** 2 + 1)
    return x + (x - x0) / sigma * (sigma_next - sigma)


class Request:
    def __init__(self, weights: dict, cfg: dict, num: Numerics):
        self.cfg = cfg
        self.unet = SVDUNet(weights["unet"], cfg["unet"], num)
        self.vae = VAE(weights["vae"], cfg["vae"], num)
        self.image = CLIPVision(weights["image_encoder"], cfg["image_encoder"], num)
        self.num = num

    def conditions(self, req: dict, device) -> dict:
        size = self.cfg["image_encoder"]["image_size"]
        emb = self.image(torch.as_tensor(clip_pixels(req["image"], size), device=device))
        pixels = torch.as_tensor(np.asarray(req["image"]), device=device).float() / 127.5 - 1.0
        pixels = pixels[None] + req["noise_aug"] * req["aug_noise"].to(device).float()[0]
        cond = self.vae.encode(pixels)[:, None] / self.cfg["vae"]["scaling_factor"]
        f = req["frames"]
        sig, ts = karras(self.cfg["sampler"], req["steps"])
        added = torch.tensor([[req["fps"] - 1, req["motion_bucket"], req["noise_aug"]]] * 2,
                             dtype=torch.float32, device=device)
        start = req["noise"].to(device).float() * float((float(sig[0]) ** 2 + 1) ** 0.5)
        return dict(embeds=torch.cat([torch.zeros_like(emb), emb])[:, None],
                    cond=cond.expand(-1, f, -1, -1, -1), mask=req["mask"].to(device).float(),
                    added=added, sigmas=sig, ts=ts, start=start,
                    guidance=torch.linspace(req["min_guidance"], req["max_guidance"], f,
                                            device=device).reshape(1, f, 1, 1, 1))

    def unet_input(self, c: dict, x: torch.Tensor, i: int) -> torch.Tensor:
        b, f = x.shape[:2]
        s = float(c["sigmas"][i])
        scaled = torch.cat([x, x]).float() / (s * s + 1) ** 0.5
        cond2 = torch.cat([torch.zeros_like(c["cond"]), c["cond"]])
        m = c["mask"].expand(b, f, *c["mask"].shape[2:])
        return torch.cat([torch.cat([m, m]), scaled, cond2], dim=-1)

    def forward(self, c: dict, x: torch.Tensor, i: int) -> torch.Tensor:
        return self.unet(self.unet_input(c, x, i), float(c["ts"][i]), c["embeds"], c["added"])

    @staticmethod
    def guided(c: dict, out: torch.Tensor) -> torch.Tensor:
        b = out.shape[0] // 2
        u, cnd = out[:b].float(), out[b:].float()
        return u + c["guidance"] * (cnd - u)

    def run(self, req: dict, device) -> dict:
        c = self.conditions(req, device)
        x = self.num.state(c["start"])
        rec = dict(embeds=c["embeds"], added=c["added"], t=[], x=[], out=[],
                   input0=self.unet_input(c, x, 0))
        for i in range(req["steps"]):
            out = self.forward(c, x, i)
            rec["t"].append(float(c["ts"][i]))
            rec["x"].append(x)
            rec["out"].append(out)
            x = self.num.state(euler(x, self.guided(c, out), float(c["sigmas"][i]),
                                     float(c["sigmas"][i + 1])))
        rec["latents"] = x
        rec["video"] = self.vae.decode_video(x)
        return rec


def check(ref: Request, req: dict, rec: dict, steps_checked, device) -> dict:
    """The gaps between a program's record of one request and the reference:
    relative RMS of the image embedding, the condition latents, the start
    latents, the UNet at ``steps_checked`` (on the program's own latents),
    every Euler step and the decode; the count of mask elements,
    micro-conditioning ids and timesteps that differ."""
    c = ref.conditions(req, device)
    n = req["steps"]
    if len(rec["x"]) != n:
        raise ValueError(f"the program ran {len(rec['x'])} UNet steps of {n}")
    inp0 = rec["input0"]
    b = inp0.shape[0] // 2
    want0 = ref.unet_input(c, c["start"], 0)
    nums = {
        "image_rel": rel_rms(rec["embeds"][b:], c["embeds"][b:]),
        "encode_rel": rel_rms(inp0[b:, ..., 5:], want0[b:, ..., 5:]),
        "start_rel": rel_rms(rec["x"][0], c["start"]),
        "inputs_diff": float((inp0[..., :1].float() != want0[..., :1]).sum()
                             + (inp0[:b, ..., 5:] != 0).sum()
                             + (rec["embeds"][:b] != 0).sum()
                             + (rec["added"].float().to(device) != c["added"]).sum()
                             + sum(float(a) != float(w) for a, w in zip(rec["t"], c["ts"]))),
    }
    nums["unet_rel"] = worst(rel_rms(rec["out"][k % n], ref.forward(c, rec["x"][k % n].float(),
                                                                   k % n))
                             for k in steps_checked)
    steps = []
    for i in range(n):
        nxt = euler(rec["x"][i], ref.guided(c, rec["out"][i]), float(c["sigmas"][i]),
                    float(c["sigmas"][i + 1]))
        steps.append(rel_rms(rec["x"][i + 1] if i + 1 < n else rec["latents"], nxt))
    nums["step_rel"] = worst(steps)
    nums["decode_rel"] = rel_rms(rec["video"], ref.vae.decode_video(rec["latents"].float()))
    return nums
