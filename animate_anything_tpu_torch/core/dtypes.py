"""Mixed-precision policy — the port of ``animate_anything_tpu/core/dtypes.py``.

Compute runs in bfloat16. LayerNorm and GroupNorm parameters, biases, the
diffusion σ/ᾱ math and every kernel statistic (row moments, Σ/Σ² epilogues)
stay fp32. ``cast_module_`` applies that split to a module's parameters:
matrices and conv kernels (ndim ≥ 2) take the compute dtype, vectors (norm
scales, biases) stay fp32. Layers compute in the dtype of their weight,
casting inputs and biases to it, as flax modules with ``dtype=`` do.

Training (JAX's ``Policy``: fp32 parameters, bf16 compute) keeps two copies:
the fp32 masters that the optimizer updates (``master_params``) and the
working module in the policy's dtypes that the kernels read. After each
optimizer step ``copy_masters_`` rounds the masters into the working module.
A weight's gradient comes out of a bf16 product in JAX too, where the cast
of the fp32 parameter to bf16 sits inside the differentiated function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Policy:
    """JAX's ``Policy`` (its parameters are fp32 in both): a module computes
    in ``compute_dtype``, bf16 after ``cast_module_``."""
    compute_dtype: torch.dtype = torch.float32


def policy_from_string(name: Optional[str]) -> Policy:
    """A config's ``mixed_precision`` ('no' / 'fp32' / 'fp16' / 'bf16', JAX's
    names) → its policy; half precision is bf16 either way, as in JAX."""
    if name in (None, "no", "fp32", "float32"):
        return Policy(torch.float32)
    if name in ("fp16", "bf16", "bfloat16", "float16"):
        return Policy(COMPUTE_DTYPE)
    raise ValueError(f"unknown mixed_precision: {name}")


def cast_module_(module: torch.nn.Module) -> torch.nn.Module:
    """Cast ``module``'s parameters in place to the policy; return it."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(COMPUTE_DTYPE if p.ndim >= 2 else torch.float32)
    return module


def master_params(module: torch.nn.Module,
                  names: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """fp32 copies of ``module``'s parameters (only ``names``, if given), in
    the contiguous layout whatever the parameter's (a ZeRO slice of a master
    is a view of its flat range)."""
    keep = None if names is None else set(names)
    return {name: p.detach().float().clone(memory_format=torch.contiguous_format)
            for name, p in module.named_parameters() if keep is None or name in keep}


@torch.no_grad()
def copy_masters_(module: torch.nn.Module, masters: Dict[str, torch.Tensor]) -> None:
    """Round each master into the working parameter of the same name."""
    for name, p in module.named_parameters():
        if name in masters:
            p.copy_(masters[name])
