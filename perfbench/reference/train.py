"""The mask + motion finetune step in plain PyTorch, float32: the frozen VAE
encode of the clips and text encode of the prompts, the clip frozen outside
the motion mask, the latent motion score, noising at the drawn timesteps
under the zero-terminal-SNR schedule, the v-prediction MSE plus 0.001 × the
motion-score loss, the backward through the UNet (each sub-layer
recomputed), the global-norm clip and AdamW on the float32 parameters.

The batch's rows run one at a time and their gradients add up: the loss is
the mean of the rows' losses, every row the same size.

The parameters are float32 and the optimizer updates them; the forward
reads each one as the configuration stores its working copy (``dtypes``:
the matrices and kernels in bf16, rounded from the float32 value, the
gradient passing the rounding unchanged), as the mixed-precision policy
states. The arithmetic is float32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.clip_text import CLIPText
from perfbench.reference.latent2video import latent_mask_batch
from perfbench.reference.numerics import Numerics
from perfbench.reference.unet3d import UNet3D
from perfbench.reference.vae import VAE


def zero_snr_alphas_cumprod(cfg: dict) -> np.ndarray:
    """Scaled-linear betas shifted so that the last ᾱ is exactly 0 (Lin et al.
    2023), float64."""
    n = cfg["num_train_timesteps"]
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    a = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = a[0].copy(), a[-1].copy()
    a = (a - aT) * a0 / (a0 - aT)
    return a ** 2


def motion_score(latents: torch.Tensor) -> torch.Tensor:
    """(b, f, h, w, c) → (b,): 10 × Σ_c of the mean |frame-to-frame change|."""
    return (latents[:, 1:] - latents[:, :-1]).abs().mean(dim=(1, 2, 3)).sum(-1) * 10.0


class TrainStep:
    """``weights``: component → float32 state dict (the UNet's are the
    trained parameters, every one); ``train``: the configuration's
    ``train`` group."""

    def __init__(self, weights: dict, cfg: dict, num: Numerics, dtypes: dict):
        self.cfg, self.tc, self.num = cfg, cfg["train"], num
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in weights["unet"].items()}
        self.dtypes = dtypes
        self.unet = UNet3D(self.params, cfg["unet"], num, remat=True)
        self.vae = VAE(weights["vae"], cfg["vae"], num)
        self.text = CLIPText(weights["text_encoder"], cfg["text_encoder"], num)
        ac = zero_snr_alphas_cumprod(cfg["scheduler"]).astype(np.float32).astype(np.float64)
        self.sa = torch.tensor(np.sqrt(ac), dtype=torch.float32)
        self.sb = torch.tensor(np.sqrt(1.0 - ac), dtype=torch.float32)
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def inputs(self, batch: dict) -> tuple:
        """The frozen encodes: (latents, condition, mask, motion, text states,
        empty-prompt states)."""
        px = batch["pixel_values"].float()
        b, f = px.shape[:2]
        z = torch.cat([self.vae.encode(clip) for clip in px.reshape(b * f, *px.shape[2:])
                       .split(8)])
        latents = z.reshape(b, f, *z.shape[1:])
        cond = latents[:, :1]
        mask = latent_mask_batch(batch["mask"], latents.shape[2], latents.shape[3])
        latents = cond.expand_as(latents) * (1.0 - mask) + latents * mask
        return (latents, cond, mask, motion_score(latents), self.text(batch["prompt_ids"]),
                self.text(batch["uncond_ids"]))

    def draws(self, gen: torch.Generator, shape: tuple, device) -> tuple:
        """A step's noise, timesteps and text-dropout flag, in the order the
        configuration's step draws them from its generator."""
        noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        t = torch.randint(0, self.cfg["scheduler"]["num_train_timesteps"], (shape[0],),
                          generator=gen, device=device)
        drop = bool(torch.rand((), generator=gen, device=device) < self.tc["text_dropout"])
        return noise, t, drop

    def working(self) -> dict:
        """The parameters as the forward reads them: each rounded to its
        working dtype, its gradient the identity."""
        out = {}
        for k, p in self.params.items():
            dt = self.dtypes.get(k, torch.float32)
            out[k] = p if dt == torch.float32 else p + (p.detach().to(dt).float() - p.detach())
        return out

    def loss_and_grads(self, batch: dict, gen: torch.Generator) -> float:
        latents, cond, mask, motion, text, uncond = self.inputs(batch)
        b = latents.shape[0]
        noise, t, drop = self.draws(gen, tuple(latents.shape), latents.device)
        embeds = uncond if drop else text
        sa = self.sa.to(latents.device)[t].reshape(b, 1, 1, 1, 1)
        sb = self.sb.to(latents.device)[t].reshape(b, 1, 1, 1, 1)
        noisy = sa * latents + sb * noise
        target = sa * noise - sb * latents
        total = 0.0
        for i in range(b):
            r = slice(i, i + 1)
            self.unet.P = self.working()
            pred = self.unet(noisy[r], t[r], embeds[r], cond[r], mask[r], motion[r])
            mse = (pred - target[r]).square().mean()
            x0 = sa[r] * noisy[r] - sb[r] * pred
            mloss = (motion[r] - motion_score(x0)).square().mean()
            loss = (mse + self.tc["motion_loss_weight"] * mloss) / b
            loss.backward()
            total += float(loss.detach())
        self.unet.P = self.params
        return total

    @torch.no_grad()
    def update(self) -> dict:
        """The global-norm clip and one AdamW step; → the clipped gradients."""
        tc = self.tc
        grads = {k: p.grad for k, p in self.params.items()}
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        clip = 1.0 if float(norm) < tc["max_grad_norm"] else tc["max_grad_norm"] / float(norm)
        self.count += 1
        b1, b2 = tc["adam_beta1"], tc["adam_beta2"]
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        out = {}
        for k, p in self.params.items():
            g = grads[k] * clip
            out[k] = g
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + tc["adam_eps"])
            if tc["adam_weight_decay"]:
                upd = upd + tc["adam_weight_decay"] * p
            p.sub_(tc["learning_rate"] * upd)
            p.grad = None
        return out

    def step(self, batch: dict, gen: torch.Generator) -> tuple:
        loss = self.loss_and_grads(batch, gen)
        return loss, self.update()
