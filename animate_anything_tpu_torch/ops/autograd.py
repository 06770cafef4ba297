"""Gradients for the fused kernels that have no backward kernel.

Kernels 2–5 (LN+GEGLU, the temporal block, the tap conv, the projection
with its sums) have no Pallas backward in the JAX package either: each
``jax.custom_vjp`` saves only its inputs and takes the vjp of an XLA twin.
``Recompute`` is that pattern as a ``torch.autograd.Function``: its forward
runs the kernel (or, for CPU tensors, the plain version) and saves only
the tensor inputs; its backward re-runs a differentiable torch twin of the
same function on those inputs and returns the twin's gradients. Without
it, a kernel's output (written through ``data_ptr()`` into a fresh tensor)
would carry no ``grad_fn`` and every parameter upstream would silently get
no gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable


class Recompute(torch.autograd.Function):
    """``Recompute.apply(run, twin, *args)``: ``run(*args)`` in the forward,
    gradients of ``twin(*args)`` in the backward. Both return one tensor or
    a flat tuple of tensors; non-tensor ``args`` (eps, head counts) and
    ``None`` pass through unchanged."""

    @staticmethod
    def forward(ctx, run: Callable, twin: Callable, *args):
        is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.twin = twin
        ctx.is_tensor = is_tensor
        ctx.constants = [None if flag else a for a, flag in zip(args, is_tensor)]
        ctx.save_for_backward(*[a for a, flag in zip(args, is_tensor) if flag])
        return run(*args)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = []
            for flag, const, need in zip(ctx.is_tensor, ctx.constants, needs):
                args.append(next(saved).detach().requires_grad_(need) if flag else const)
            outs = ctx.twin(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [a for a, need in zip(args, needs) if need]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True))
        return (None, None, *[next(got) if need else None for need in needs])


def flat_stats(fn: Callable) -> Callable:
    """``fn`` returning ``(y, (Σy, Σy²))`` → the same function returning the
    flat ``(y, Σy, Σy²)`` that ``Recompute`` takes."""
    def run(*args):
        y, (s1, s2) = fn(*args)
        return y, s1, s2
    return run
