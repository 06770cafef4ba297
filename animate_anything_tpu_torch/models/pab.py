"""Pyramid-Attention-Broadcast step caching (arXiv 2408.12588) — the port of
the ``pab_reuse`` branches of ``animate_anything_tpu/models/attention.py``,
``models/svd_unet.py`` and the step schedules of
``pipelines/latent2video.py`` and ``pipelines/svd.py``.

Between the warm-up steps and the last ``tail`` steps of a denoise loop,
each transformer recomputes its residual delta (its output minus its input)
only on every rate-th step and adds the delta it cached on the others:
attention deltas drift slowly across adjacent steps.

The state is a ``PABCache``, one per request, made and threaded through the
sampler by the pipeline (JAX's ``"pab"`` variable collection in the scan
carry): each transformer's last delta, kept by module, zeros before the
first. A reuse step never calls the transformer's body, so none of its
kernels launch (JAX's ``nn.cond`` runs only the reuse branch, whose
``_delta`` call XLA drops). Under a cache the transformers also skip
kernel 4: the delta is ``proj_out(h)`` alone, and ``y = delta + x`` has no
output sums, so the next GroupNorm computes its own, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch
from torch import nn


class PABCache:
    """The per-request delta cache: one delta of the transformer input's
    shape, in the transformer's compute dtype, per transformer."""

    def __init__(self):
        self.deltas: dict = {}

    def delta(self, module: nn.Module, x: torch.Tensor, reuse: bool, dtype: torch.dtype,
              compute: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``module``'s delta this step: the cached one where ``reuse`` (zeros
        of x's shape in ``dtype`` before any was computed), else
        ``compute()``, which replaces it."""
        if reuse:
            cached = self.deltas.get(module)
            if cached is None:
                cached = torch.zeros(x.shape, dtype=dtype, device=x.device)
            return cached
        out = compute()
        self.deltas[module] = out
        return out


@dataclasses.dataclass(frozen=True)
class PABStep:
    """One step's PAB arguments to a UNet: the request's cache and JAX's
    ``pab_reuse``, ``{"spatial": bool, "temporal": bool}`` for the UNet3D
    or one bool for the SVD UNet."""
    cache: PABCache
    reuse: Union[dict, bool]

    def flag(self, kind: str) -> bool:
        return bool(self.reuse if isinstance(self.reuse, bool) else self.reuse[kind])


def reuse_flags(steps: int, rate: int, warmup: int, tail: int) -> np.ndarray:
    """Per-step reuse flags: True between ``warmup`` and the last ``tail``
    steps on every step whose index is no multiple of ``rate``; all False
    for a rate of 1 or less."""
    idx = np.arange(steps)
    if rate <= 1:
        return np.zeros(steps, bool)
    return (idx >= warmup) & (idx < steps - tail) & (idx % rate != 0)


def unet3d_flags(pab: dict, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """The mask+motion pipeline's spatial and temporal flags from its PAB
    config (``spatial_rate`` 2, ``temporal_rate`` 3, ``warmup`` 4, ``tail``
    1 by default)."""
    warm, tail = int(pab.get("warmup", 4)), int(pab.get("tail", 1))
    return (reuse_flags(steps, int(pab.get("spatial_rate", 2)), warm, tail),
            reuse_flags(steps, int(pab.get("temporal_rate", 3)), warm, tail))


def svd_flags(pab: dict, steps: int) -> np.ndarray:
    """The SVD pipeline's one flag a step (``rate`` 2, ``warmup`` 4,
    ``tail`` 1 by default)."""
    return reuse_flags(steps, int(pab.get("rate", 2)), int(pab.get("warmup", 4)),
                       int(pab.get("tail", 1)))
