"""DPM-Solver++ (2M multistep) — the port of the dpmpp half of
``animate_anything_tpu/diffusion/samplers.py``: the same coefficient tables
and step function, with the denoise loop as a plain Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from animate_anything_tpu_torch.diffusion.schedule import DiffusionSchedule, pred_x0


def dpmpp_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """diffusers DPMSolverMultistep default ('linspace'):
    linspace(0, T-1, n+1).round()[::-1][:-1]."""
    return (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
            .round()[::-1][:-1].astype(np.int64))


@dataclasses.dataclass(frozen=True)
class SamplerState:
    sample: torch.Tensor
    aux: torch.Tensor | None = None   # previous x0 estimate


@dataclasses.dataclass(frozen=True)
class DpmppTables:
    """Per-step fp32 tables (descending t); alpha/sigma/lam have a final knot."""
    timesteps: np.ndarray
    alpha: torch.Tensor
    sigma: torch.Tensor
    lam: torch.Tensor


def dpmpp_init(schedule: DiffusionSchedule, timesteps: np.ndarray) -> DpmppTables:
    ac = schedule.alphas_cumprod.numpy()
    knot_ac = np.concatenate([ac[np.asarray(timesteps)], ac[:1]])
    alpha = np.sqrt(knot_ac)
    sigma = np.sqrt(1.0 - knot_ac)
    lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-10))
    f32 = torch.float32
    return DpmppTables(timesteps=np.asarray(timesteps),
                       alpha=torch.tensor(alpha, dtype=f32),
                       sigma=torch.tensor(sigma, dtype=f32),
                       lam=torch.tensor(lam, dtype=f32))


def dpmpp_step(schedule: DiffusionSchedule, tables: DpmppTables, state: SamplerState,
               model_output: torch.Tensor, i: int) -> SamplerState:
    """One DPM-Solver++ multistep update at step index i. The first step is
    1st order; the last one too for schedules under 15 steps (diffusers'
    lower_order_final). σ math in fp32."""
    n = len(tables.timesteps)
    sample = state.sample.float()
    x0 = pred_x0(schedule, model_output, sample, int(tables.timesteps[i]))
    a_t, s_s, s_t = tables.alpha[i + 1], tables.sigma[i], tables.sigma[i + 1]
    h = tables.lam[i + 1] - tables.lam[i]
    ratio = s_t / s_s
    phi = torch.expm1(-h)
    first_order = i == 0 or (n < 15 and i == n - 1)
    if first_order:
        prev = ratio * sample - a_t * phi * x0
    else:
        r0 = (tables.lam[i] - tables.lam[i - 1]) / h
        d1 = (x0 - state.aux.float()) / r0
        prev = ratio * sample - a_t * phi * (x0 + 0.5 * d1)
    dt = state.sample.dtype
    return SamplerState(sample=prev.to(dt), aux=x0.to(dt))


def sample_loop(schedule: DiffusionSchedule, latents: torch.Tensor, timesteps: np.ndarray,
                model_fn: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    """Run the DPM-Solver++ denoise loop; model_fn(latents, t) → model output."""
    ts = np.asarray(timesteps)
    tables = dpmpp_init(schedule, ts)
    state = SamplerState(sample=latents, aux=torch.zeros_like(latents))
    for i in range(len(ts)):
        out = model_fn(state.sample, int(ts[i]))
        state = dpmpp_step(schedule, tables, state, out, i)
    return state.sample
