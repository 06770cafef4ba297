"""Kernel 7: one-pass GroupNorm (+SiLU) of an (n, s, c) tensor with the
affine applied in fp32 (``csrc/group_norm.cu``).

Replaces ``animate_anything_tpu/ops/attic/streaming_group_norm.py::
_pallas_group_norm``, which ``group_norm_silu`` reaches under
``set_default_norm_impl("pallas")`` past JAX's gate
(``ops/group_norm.streaming_ok``). Statistics are per (sample, group) in
fp32 over (s, c/groups); the output is y = x·a + b in fp32, then y·sigmoid(y)
in fp32 when ``silu``, then one rounding to x's dtype. The TPU kernel runs
one program per sample; the CUDA one is kernel 6's two sum passes, a fold
into per-(sample, channel) (a, b) and one apply pass over every block: four
launches, counted here as one call.

No gradient: JAX's kernel has no VJP, so neither the JAX package nor the
port can train through it. The wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.group_norm import channel_sums, group_affine, sums_args

launches = 0  # calls of the kernel-7 entry point (three launches each)


def group_norm_stream_reference(x2, scale, bias, groups: int, eps: float, silu: bool):
    """Plain version: the fp32 (a, b) of ``group_affine`` on the plain
    channel sums, the affine and SiLU in fp32, one rounding."""
    a, b = group_affine(x2, scale, bias, groups, eps, sums=channel_sums(x2))
    y = x2.float() * a[:, None, :] + b[:, None, :]
    if silu:
        y = F.silu(y)
    return y.to(x2.dtype)


def _launch(x2, scale, bias, groups: int, eps: float, silu: bool):
    n, s, c = x2.shape
    if c % 8 or c % groups:
        raise ValueError(f"group_norm_stream: c={c} must be a multiple of 8 and of {groups}")
    cuda_lib.check_cuda("group_norm_stream x", x2, torch.bfloat16, (n, s, c))
    cuda_lib.check_cuda("group_norm_stream scale", scale, torch.float32, (c,))
    cuda_lib.check_cuda("group_norm_stream bias", bias, torch.float32, (c,))
    plan, tk = sums_args(x2)
    work = torch.empty(2 * n * plan["chunks"] * c + 4 * n * c, device=x2.device,
                       dtype=torch.float32)
    y = torch.empty_like(x2)
    cuda_lib.call("aat_group_norm", x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  work.data_ptr(), tk.data_ptr(), y.data_ptr(), n, s, c, groups, plan["ct"],
                  plan["threads"], plan["chunks"], plan["rows"], eps, int(silu))
    global launches
    launches += 1
    return y


def group_norm_stream(x2, scale, bias, groups: int, eps: float = 1e-5,
                      silu: bool = True) -> torch.Tensor:
    """GroupNorm (+SiLU) of x2 (n, s, c) with per-channel scale and bias:
    kernel 7 for a CUDA tensor, its plain version for a CPU tensor."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x2, scale, bias)):
        raise RuntimeError(
            "group_norm_stream has no backward (the JAX package's streaming GroupNorm "
            "kernel has no VJP): call it under torch.no_grad(), or train with "
            "set_default_norm_impl('xla')")
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    run = group_norm_stream_reference if x2.device.type == "cpu" else _launch
    return run(x2, scale, bias, groups, eps, silu)
