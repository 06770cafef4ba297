"""The discrete diffusion schedule (SD's scaled-linear betas, 1000 steps,
ε prediction), the forward noising of the first-frame latent into the start
latents under the motion mask, and DPM-Solver++ (2M multistep, diffusers'
``DPMSolverMultistepScheduler`` defaults): float64 tables, float32 steps."""

from __future__ import annotations

import numpy as np


def alphas_cumprod(cfg: dict) -> np.ndarray:
    n = cfg["num_train_timesteps"]
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def dpmpp_timesteps(cfg: dict, steps: int) -> np.ndarray:
    n = cfg["num_train_timesteps"]
    return np.linspace(0, n - 1, steps + 1).round()[::-1][:-1].astype(np.int64)


def start_latents(ac: np.ndarray, image_latent, mask, noise, frames: int, t0: int):
    """image_latent (b, 1, h, w, 4), mask (b, 1, h, w, 1), noise (b, f, h, w, 4)
    → where the mask is 1 the latent noised to t0, elsewhere the latent."""
    video = image_latent.float().expand(-1, frames, -1, -1, -1)
    a = float(np.sqrt(ac[t0]))
    s = float(np.sqrt(1.0 - ac[t0]))
    noised = a * video + s * noise.float()
    return mask * noised + (1.0 - mask) * video


class DPMSolverPP:
    """Second-order multistep DPM-Solver++ over ``timesteps`` (the first step,
    and the last under 15 steps, first order)."""

    def __init__(self, ac: np.ndarray, timesteps: np.ndarray):
        knots = np.concatenate([ac[timesteps], ac[:1]])
        self.ts = timesteps
        self.alpha = np.sqrt(knots)
        self.sigma = np.sqrt(1.0 - knots)
        self.lam = np.log(self.alpha) - np.log(np.maximum(self.sigma, 1e-10))

    def x0(self, i: int, sample, eps):
        return (sample.float() - float(self.sigma[i]) * eps.float()) / float(self.alpha[i])

    def step(self, i: int, sample, eps, prev_x0=None):
        """x_{i+1} from x_i and the guided ε at step i; ``prev_x0``: step i − 1's
        x̂0 (None at i = 0). Returns (x_{i+1}, x̂0_i)."""
        n = len(self.ts)
        x0 = self.x0(i, sample, eps)
        h = self.lam[i + 1] - self.lam[i]
        ratio = float(self.sigma[i + 1] / self.sigma[i])
        coef = float(self.alpha[i + 1] * np.expm1(-h))
        if i == 0 or (n < 15 and i == n - 1):
            return ratio * sample.float() - coef * x0, x0
        r0 = float((self.lam[i] - self.lam[i - 1]) / h)
        d1 = (x0 - prev_x0.float()) / r0
        return ratio * sample.float() - coef * (x0 + 0.5 * d1), x0
