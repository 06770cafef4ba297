"""Mixed-precision policy — the port of ``animate_anything_tpu/core/dtypes.py``.

Compute runs in bfloat16. LayerNorm and GroupNorm parameters, biases, the
diffusion σ/ᾱ math and every kernel statistic (row moments, Σ/Σ² epilogues)
stay fp32. ``cast_module_`` applies that split to a module's parameters:
matrices and conv kernels (ndim ≥ 2) take the compute dtype, vectors (norm
scales, biases) stay fp32. Layers compute in the dtype of their weight,
casting inputs and biases to it, as flax modules with ``dtype=`` do.
"""

from __future__ import annotations

import torch

COMPUTE_DTYPE = torch.bfloat16


def cast_module_(module: torch.nn.Module) -> torch.nn.Module:
    """Cast ``module``'s parameters in place to the policy; return it."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(COMPUTE_DTYPE if p.ndim >= 2 else torch.float32)
    return module
