"""Continuous-σ (EDM) schedule for the SVD workload — the port of
``animate_anything_tpu/diffusion/euler_edm.py``: EulerDiscrete sampling over
Karras σ in [0.002, 700] with continuous timesteps 0.25·log σ, and the EDM
training preconditioning (c_skip, c_out, c_in, c_noise, λ(σ)).

σ spans about e^±6, so every coefficient and every update is fp32; the
sample keeps its own dtype between steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    sigmas: torch.Tensor      # (n + 1,) fp32, descending, the last 0
    timesteps: torch.Tensor   # (n,) fp32, the model's continuous 0.25·log σ

    @property
    def init_noise_sigma(self) -> torch.Tensor:
        """sqrt(σ_max² + 1): the start noise's scale."""
        return torch.sqrt(self.sigmas[0] ** 2 + 1.0)


def karras_sigmas(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, n)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def make_euler_schedule(num_inference_steps: int, sigma_min: float = 0.002,
                        sigma_max: float = 700.0, rho: float = 7.0,
                        device="cpu") -> EulerSchedule:
    """Karras σ in float64, then fp32 as JAX stores them."""
    sig = karras_sigmas(num_inference_steps, sigma_min, sigma_max, rho)
    timesteps = 0.25 * np.log(sig)
    sig = np.concatenate([sig, [0.0]])
    return EulerSchedule(
        sigmas=torch.tensor(sig, dtype=torch.float32, device=device),
        timesteps=torch.tensor(timesteps, dtype=torch.float32, device=device))


def scale_model_input(sample: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return (sample.float() / torch.sqrt(sigma ** 2 + 1.0)).to(sample.dtype)


def euler_step(sample: torch.Tensor, model_output: torch.Tensor, sigma: torch.Tensor,
               sigma_next: torch.Tensor) -> torch.Tensor:
    """One Euler step of the ODE with the EDM parameterisation: the model's
    output through c_skip / c_out to x̂0, then the step from σ to σ_next."""
    sample32 = sample.float()
    out32 = model_output.float()
    x0 = out32 * (-sigma / torch.sqrt(sigma ** 2 + 1.0)) + sample32 / (sigma ** 2 + 1.0)
    d = (sample32 - x0) / sigma
    return (sample32 + d * (sigma_next - sigma)).to(sample.dtype)


@dataclasses.dataclass(frozen=True)
class EdmCoeffs:
    sigma: torch.Tensor       # (b, 1, 1, 1, 1)
    c_skip: torch.Tensor
    c_out: torch.Tensor
    c_in: torch.Tensor
    c_noise: torch.Tensor     # (b,)
    loss_weight: torch.Tensor


def edm_sample_sigmas(batch: int, generator: Optional[torch.Generator] = None,
                      p_mean: float = 0.7, p_std: float = 1.6, device="cpu") -> torch.Tensor:
    """Training σ ~ LogNormal(P_mean, P_std), shaped (b, 1, 1, 1, 1), fp32."""
    z = torch.randn((batch, 1, 1, 1, 1), generator=generator, dtype=torch.float32,
                    device=device)
    return torch.exp(z * p_std + p_mean)


def edm_precondition(sigma: torch.Tensor) -> EdmCoeffs:
    sigma = sigma.float()
    return EdmCoeffs(
        sigma=sigma,
        c_skip=1.0 / (sigma ** 2 + 1.0),
        c_out=-sigma / torch.sqrt(sigma ** 2 + 1.0),
        c_in=1.0 / torch.sqrt(sigma ** 2 + 1.0),
        c_noise=(torch.log(sigma) / 4.0).reshape(sigma.shape[0]),
        loss_weight=(sigma ** 2 + 1.0) / sigma ** 2)
