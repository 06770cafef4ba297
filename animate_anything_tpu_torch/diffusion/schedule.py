"""Discrete diffusion noise schedule and forward process — the port of
``animate_anything_tpu/diffusion/schedule.py``.

Schedule tables are fp32 CPU tensors; per-sample values are gathered and
moved to the sample's device. Random noise comes from an explicit
``torch.Generator``, or is handed in as ``noise`` (the tests feed the JAX
side's noise to both).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

BetaScheduleName = Literal["linear", "scaled_linear", "squaredcos_cap_v2"]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int
    betas: torch.Tensor            # [T] fp32
    alphas_cumprod: torch.Tensor   # [T] fp32
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample

    @property
    def sqrt_alphas_cumprod(self) -> torch.Tensor:
        return torch.sqrt(self.alphas_cumprod)

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> torch.Tensor:
        return torch.sqrt(1.0 - self.alphas_cumprod)


def _make_betas(name: str, num_train_timesteps: int, beta_start: float,
                beta_end: float) -> np.ndarray:
    if name == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if name == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if name == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_train_timesteps, dtype=np.float64)
        return np.minimum(1.0 - alpha_bar((ts + 1) / num_train_timesteps)
                          / alpha_bar(ts / num_train_timesteps), 0.999)
    raise ValueError(f"unknown beta schedule {name}")


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_schedule: BetaScheduleName = "scaled_linear",
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    prediction_type: str = "epsilon",
    rescale_betas_zero_snr: bool = False,
) -> DiffusionSchedule:
    betas = _make_betas(beta_schedule, num_train_timesteps, beta_start, beta_end)
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        num_train_timesteps=num_train_timesteps,
        betas=torch.tensor(betas, dtype=torch.float32),
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32),
        prediction_type=prediction_type,
    )


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift the schedule so terminal SNR is exactly zero (Lin et al. 2023)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0 = alphas_bar_sqrt[0].copy()
    aT = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def _extract(table: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
    """Gather per-sample fp32 schedule values, shaped to broadcast over like."""
    idx = torch.as_tensor(t, dtype=torch.long, device=like.device)
    vals = table.to(like.device)[idx].float()
    return vals.reshape(vals.shape + (1,) * (like.ndim - vals.ndim))


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(ā_t)·x0 + sqrt(1 - ā_t)·ε, fp32 coefficients."""
    sa = _extract(schedule.sqrt_alphas_cumprod, t, x0)
    sb = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x0)
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)


def get_velocity(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 t) -> torch.Tensor:
    """The v-prediction target sqrt(ā_t)·ε − sqrt(1 − ā_t)·x0, in x0's dtype."""
    sa = _extract(schedule.sqrt_alphas_cumprod, t, x0)
    sb = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x0)
    return (sa * noise.float() - sb * x0.float()).to(x0.dtype)


def pred_x0(schedule: DiffusionSchedule, model_output: torch.Tensor, sample: torch.Tensor,
            t) -> torch.Tensor:
    """x̂0 from the model output under the schedule's prediction type."""
    sample = sample.float()
    model_output = model_output.float()
    sa = _extract(schedule.sqrt_alphas_cumprod, t, sample)
    sb = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, sample)
    if schedule.prediction_type == "epsilon":
        return (sample - sb * model_output) / sa
    if schedule.prediction_type == "v_prediction":
        return sa * sample - sb * model_output
    if schedule.prediction_type == "sample":
        return model_output
    raise ValueError(schedule.prediction_type)


def pred_epsilon(schedule: DiffusionSchedule, model_output: torch.Tensor,
                 sample: torch.Tensor, t) -> torch.Tensor:
    """ε̂ from the model output under the schedule's prediction type, fp32."""
    sample = sample.float()
    model_output = model_output.float()
    sa = _extract(schedule.sqrt_alphas_cumprod, t, sample)
    sb = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, sample)
    if schedule.prediction_type == "epsilon":
        return model_output
    if schedule.prediction_type == "v_prediction":
        return sa * model_output + sb * sample
    if schedule.prediction_type == "sample":
        return (sample - sa * model_output) / sb
    raise ValueError(schedule.prediction_type)


def sample_noise(shape: tuple, offset_noise_strength: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None,
                 normals: Optional[tuple] = None) -> torch.Tensor:
    """Gaussian noise of ``shape`` (b, f, h, w, c), fp32, plus offset noise
    shared across f, h, w per (sample, channel) when
    ``offset_noise_strength`` is set. ``normals``: the two draws (the full
    normal and the (b, 1, 1, 1, c) offset normal) handed in instead of drawn
    from ``generator``, as the tests feed JAX's."""
    if normals is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        offset = None
        if offset_noise_strength:
            offset = torch.randn((shape[0], 1, 1, 1, shape[-1]), generator=generator,
                                 device=device, dtype=torch.float32)
    else:
        noise, offset = normals
    if offset_noise_strength:
        noise = noise + offset_noise_strength * offset
    return noise


def ddpm_forward_timesteps(schedule: DiffusionSchedule, x0: torch.Tensor, num_frames: int,
                           timesteps, generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image → noised video latents at timesteps[0]: repeat the image latent
    along the frame axis, then add noise. x0 (b, f0, h, w, c) →
    (b, num_frames, h, w, c). ``noise`` (fp32, the video's shape) overrides
    drawing from ``generator``."""
    video = x0.repeat_interleave(num_frames // x0.shape[1], dim=1)
    if noise is None:
        noise = torch.randn(video.shape, generator=generator, device=video.device,
                            dtype=torch.float32)
    t0 = torch.full((video.shape[0],), int(np.asarray(timesteps)[0]), dtype=torch.long)
    return add_noise(schedule, video, noise.to(video.device), t0)


def ddpm_forward_mask(schedule: DiffusionSchedule, x0: torch.Tensor, mask: torch.Tensor,
                      num_frames: int, timesteps, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Freeze/move blend: where mask is 1 the latents start from the noised
    video, elsewhere exactly at the repeated image latent."""
    noised = ddpm_forward_timesteps(schedule, x0, num_frames, timesteps, generator, noise)
    frozen = x0.repeat_interleave(num_frames // x0.shape[1], dim=1)
    return mask * noised + (1.0 - mask) * frozen
