"""The mask + motion request in plain PyTorch: the prompt and the empty
negative prompt through the text encoder, the image through the VAE encoder,
the mask snapped to the latent grid, the start latents noised under the
mask, DPM-Solver++ over the classifier-free-guided UNet, the VAE decode.

``check`` judges what a program produced for one request against this flow;
``run`` is the whole flow in the given numerics, recording the same things
(the control runs it in fp8).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.checks import rel_rms, worst
from perfbench.reference.clip_text import CLIPText, hash_token_ids
from perfbench.reference.dpm import DPMSolverPP, alphas_cumprod, dpmpp_timesteps, start_latents
from perfbench.reference.numerics import Numerics
from perfbench.reference.unet3d import UNet3D
from perfbench.reference.vae import VAE


def latent_mask(mask_img: np.ndarray, h8: int, w8: int, device) -> torch.Tensor:
    """(h, w) uint8, 255 = may move → (1, 1, h8, w8, 1) in {0, 1}: the pixel at
    floor((i + ½)·h / h8) of each latent row and column, at least ½."""
    m = torch.as_tensor(np.asarray(mask_img, np.float32) / 255.0, device=device)
    rows = torch.floor((torch.arange(h8, dtype=torch.float32) + 0.5) * m.shape[0] / h8).long()
    cols = torch.floor((torch.arange(w8, dtype=torch.float32) + 0.5) * m.shape[1] / w8).long()
    m = m.index_select(0, rows.to(device)).index_select(1, cols.to(device))
    return (m >= 0.5).float()[None, None, :, :, None]


def latent_mask_batch(masks: torch.Tensor, h8: int, w8: int) -> torch.Tensor:
    """(b, H, W) in 0..255 → (b, 1, h8, w8, 1) in {0, 1}, as ``latent_mask``."""
    m = masks.float() / 255.0
    dev = m.device
    rows = torch.floor((torch.arange(h8, dtype=torch.float32) + 0.5) * m.shape[1] / h8).long()
    cols = torch.floor((torch.arange(w8, dtype=torch.float32) + 0.5) * m.shape[2] / w8).long()
    m = m.index_select(1, rows.to(dev)).index_select(2, cols.to(dev))
    return (m >= 0.5).float()[:, None, :, :, None]


class Request:
    """The plain models of one configuration over its fp32 weights."""

    def __init__(self, weights: dict, cfg: dict, num: Numerics):
        self.cfg = cfg
        self.unet = UNet3D(weights["unet"], cfg["unet"], num)
        self.vae = VAE(weights["vae"], cfg["vae"], num)
        self.text = CLIPText(weights["text_encoder"], cfg["text_encoder"], num)
        self.ac = alphas_cumprod(cfg["scheduler"])
        self.num = num

    def conditions(self, req: dict, device) -> dict:
        """Everything the reference derives from the request before the loop."""
        tcfg = self.cfg["text_encoder"]
        ids = hash_token_ids([req["prompt"], ""], tcfg["vocab_size"],
                             tcfg["max_position_embeddings"]).to(device)
        emb = self.text(ids)
        pixels = torch.as_tensor(np.asarray(req["image"]), device=device).float() / 127.5 - 1.0
        cond = self.vae.encode(pixels[None])[:, None]
        h8, w8 = cond.shape[2], cond.shape[3]
        mask = latent_mask(req["mask"], h8, w8, device)
        ts = dpmpp_timesteps(self.cfg["scheduler"], req["steps"])
        x = start_latents(self.ac, cond, mask, req["noise"].to(device), req["frames"], int(ts[0]))
        motion = torch.tensor([float(req["strength"])], device=device)
        return dict(text=torch.cat([emb[1:], emb[:1]]), cond=cond, mask=mask, ts=ts, start=x,
                    motion=motion)

    def forward(self, c: dict, x: torch.Tensor, t: int) -> torch.Tensor:
        """The UNet on the CFG pair [negative, positive] of x: (2b, f, h, w, 4)."""
        two = lambda t_: torch.cat([t_, t_])  # noqa: E731
        return self.unet(two(x), t, c["text"], two(c["cond"]), two(c["mask"]), two(c["motion"]))

    @staticmethod
    def guided(out: torch.Tensor, scale: float) -> torch.Tensor:
        b = out.shape[0] // 2
        u, c = out[:b].float(), out[b:].float()
        return u + scale * (c - u)

    def run(self, req: dict, device) -> dict:
        """The whole request; the record holds what ``check`` reads."""
        c = self.conditions(req, device)
        dpm = DPMSolverPP(self.ac, c["ts"])
        x, prev = self.num.state(c["start"]), None
        rec = dict(text=c["text"], cond=torch.cat([c["cond"], c["cond"]]), mask=c["mask"],
                   motion=c["motion"], t=[], x=[], out=[])
        for i, t in enumerate(c["ts"]):
            out = self.forward(c, x, int(t))
            rec["t"].append(int(t))
            rec["x"].append(x)
            rec["out"].append(out)
            x, prev = dpm.step(i, x, self.guided(out, req["guidance"]), prev)
            x = self.num.state(x)
        rec["latents"] = x
        rec["video"] = self.vae.decode_video(x)
        return rec


def check(ref: Request, req: dict, rec: dict, steps_checked, device) -> dict:
    """The gaps between a program's record of one request and the reference:
    relative RMS of the text states, the image latent, the start latents, the
    UNet at ``steps_checked`` (on the program's own latents), every sampler
    step (from the program's latents and UNet outputs) and the decode (of the
    program's last latents); and the count of mask elements, strengths and
    timesteps that differ."""
    c = ref.conditions(req, device)
    ts = c["ts"]
    n = len(ts)
    if len(rec["x"]) != n:
        raise ValueError(f"the program ran {len(rec['x'])} UNet steps of {n}")
    nums = {
        "text_rel": rel_rms(rec["text"], c["text"]),
        "encode_rel": rel_rms(rec["cond"][:1], c["cond"]),
        "start_rel": rel_rms(rec["x"][0], c["start"]),
        "inputs_diff": float((rec["mask"][:1].float().to(device) != c["mask"]).sum()
                             + (rec["motion"][:1].float().to(device) != c["motion"]).sum()
                             + sum(int(a) != int(b) for a, b in zip(rec["t"], ts))),
    }
    nums["unet_rel"] = worst(
        rel_rms(rec["out"][k % n], ref.forward(c, rec["x"][k % n].float(), int(ts[k % n])))
        for k in steps_checked)
    dpm = DPMSolverPP(ref.ac, ts)
    steps, prev = [], None
    for i in range(n):
        nxt, prev = dpm.step(i, rec["x"][i].float(), ref.guided(rec["out"][i], req["guidance"]),
                             prev)
        steps.append(rel_rms(rec["x"][i + 1] if i + 1 < n else rec["latents"], nxt))
    nums["step_rel"] = worst(steps)
    nums["decode_rel"] = rel_rms(rec["video"], ref.vae.decode_video(rec["latents"].float()))
    return nums
