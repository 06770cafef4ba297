"""DDIM and DPM-Solver++ (2M multistep) — the port of
``animate_anything_tpu/diffusion/samplers.py``: the same timestep grids,
coefficient tables and step functions, with the denoise loop as a plain
Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from animate_anything_tpu_torch.diffusion.schedule import DiffusionSchedule, pred_x0
from animate_anything_tpu_torch.utils.tracing import span, traced


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   spacing: str = "leading", steps_offset: int = 1) -> np.ndarray:
    """Descending int timestep grid (diffusers ``DDIMScheduler.set_timesteps``):
    ``leading``, ``linspace`` or ``trailing`` spacing."""
    if spacing == "leading":
        ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        return ts + steps_offset
    if spacing == "linspace":
        return (np.linspace(0, num_train_timesteps - 1, num_inference_steps)
                .round()[::-1].astype(np.int64))
    if spacing == "trailing":
        ts = np.arange(num_train_timesteps, 0, -num_train_timesteps / num_inference_steps)
        return (ts.round() - 1).astype(np.int64)
    raise ValueError(spacing)


def dpmpp_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """diffusers DPMSolverMultistep default ('linspace'):
    linspace(0, T-1, n+1).round()[::-1][:-1]."""
    return (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
            .round()[::-1][:-1].astype(np.int64))


@dataclasses.dataclass(frozen=True)
class SamplerState:
    sample: torch.Tensor
    aux: torch.Tensor | None = None   # previous x0 estimate


def ddim_step(schedule: DiffusionSchedule, sample: torch.Tensor, model_output: torch.Tensor,
              t: int, t_prev: int) -> torch.Tensor:
    """One deterministic DDIM update x_t → x_{t_prev} (η = 0), fp32 math,
    the result in the sample's dtype. ``t_prev < 0`` is the final step: ᾱ_prev
    is ᾱ_0 (diffusers' ``set_alpha_to_one=False``)."""
    ac = schedule.alphas_cumprod
    a_t = ac[int(t)]
    a_prev = ac[int(t_prev)] if t_prev >= 0 else ac[0]
    sample32 = sample.float()
    x0 = pred_x0(schedule, model_output, sample32, int(t))
    # ε re-derived from x0, as diffusers does
    eps = (sample32 - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
    prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return prev.to(sample.dtype)


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


@traced("denoise")
def sample_loop(schedule: DiffusionSchedule, latents: torch.Tensor, timesteps: np.ndarray,
                model_fn: Callable, sampler: str = "dpmpp", model_state=None) -> torch.Tensor:
    """Run the denoise loop; model_fn(latents, t) → model output. DDIM steps
    from each t to t − T // len(timesteps), as JAX's loop does, also on a
    truncated grid whose own spacing is wider (ROADMAP queue 3).

    ``model_state``: an optional carry threaded through the loop: when given,
    ``model_fn(latents, t, i, state)`` → ``(out, state)`` (step-dependent
    model behaviour: the PAB delta cache, ``models/pab.py``)."""
    ts = np.asarray(timesteps)
    carry = model_state

    def call(x, i):
        nonlocal carry
        if model_state is None:
            return model_fn(x, int(ts[i]))
        out, carry = model_fn(x, int(ts[i]), i, carry)
        return out

    if sampler == "dpmpp":
        tables = dpmpp_init(schedule, ts)
        state = SamplerState(sample=latents, aux=torch.zeros_like(latents))
        for i in range(len(ts)):
            with span("step"):
                state = dpmpp_step(schedule, tables, state, call(state.sample, i), i)
        return state.sample
    if sampler == "ddim":
        step_gap = schedule.num_train_timesteps // len(ts) if len(ts) else 0
        sample = latents
        for i, t in enumerate(ts):
            with span("step"):
                sample = ddim_step(schedule, sample, call(sample, i), int(t), int(t) - step_gap)
        return sample
    raise ValueError(f"unknown sampler {sampler}")
