"""GroupNorm as a per-(batch, channel) affine, with optional precomputed
sums — the port of ``animate_anything_tpu/ops/group_norm.py``
(``group_affine`` and the composite ``group_norm_silu``).

Statistics are per-channel fp32 Σx, Σx² over the row axis, combined into
per-group moments on the small (n, c) result. A producer kernel that already
emitted the sums of its output (kernels 3 and 4) hands them in as ``sums``
and the norm then costs only the ``a·x + b`` apply. The JAX package's
channel-sums Pallas kernel is opt-in there (off by default) and is not part
of this port's main path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def channel_sums(x2: torch.Tensor):
    """Per-(n, c) fp32 (Σx, Σx²) of x2 (n, s, c)."""
    xf = x2.float()
    return xf.sum(1), xf.square().sum(1)


def group_affine(x2, scale, bias, groups: int, eps: float, sums=None):
    """fp32 (a, b), each (n, c), such that ``a·x + b`` is GroupNorm(+scale,
    bias) of x2 (n, s, c), statistics pooled over s and each group's
    channels."""
    n, s, c = x2.shape
    s1, s2 = channel_sums(x2) if sums is None else (sums[0].float(), sums[1].float())
    g1 = s1.reshape(n, groups, c // groups).sum(-1)
    g2 = s2.reshape(n, groups, c // groups).sum(-1)
    cnt = float(s * (c // groups))
    mean = g1 / cnt
    var = g2 / cnt - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)
    mean_c = mean.repeat_interleave(c // groups, dim=1)
    a = inv_c * scale.float()[None, :]
    b = bias.float()[None, :] - mean_c * a
    return a, b


def group_norm_silu(x, scale, bias, groups: int, eps: float = 1e-5, silu: bool = True,
                    sums=None) -> torch.Tensor:
    """GroupNorm over the last axis of x (n, ..., c), statistics pooled over
    every non-batch axis (torch GroupNorm semantics), optionally with SiLU.
    The affine is applied in x's dtype."""
    shape = x.shape
    x2 = x.reshape(shape[0], -1, shape[-1])
    a, b = group_affine(x2, scale, bias, groups, eps, sums=sums)
    y = x2 * a[:, None, :].to(x2.dtype) + b[:, None, :].to(x2.dtype)
    if silu:
        # the JAX package's tanh identity y·(1 + tanh(y/2))/2 has the same
        # value; torch's CPU tanh runs through MKL VML, whose threaded calls
        # were seen to return whole chunks off by ~1e-4, so SiLU goes direct
        y = F.silu(y)
    return y.reshape(shape)
