"""The reference's arithmetic: every product of the plain models goes
through one ``Numerics`` object, so the same model code runs in float32
(TF32 off: the reference) or with its products' operands rounded to fp8
e4m3 (the control, the precision step below the configuration's bf16).

Plain PyTorch only: nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor
    (its largest magnitude maps to 448), returned in float32."""
    t = t.float()
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """``mode``: ``"fp32"`` or ``"fp8"`` (operands of every linear, conv
    and attention product rounded through e4m3, accumulation in fp32, and
    the sampler's latents rounded through e4m3 between steps)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return to_fp8(t) if self.mode == "fp8" else t.float()

    def state(self, t: torch.Tensor) -> torch.Tensor:
        """A sampler's latents as they are carried from one step to the next."""
        return self._q(t)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        return F.linear(self._q(x), self._q(w), None if b is None else b.float())

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
               padding: int = 1) -> torch.Tensor:
        """x (n, h, w, c) channels-last; w (cout, cin, kh, kw)."""
        y = F.conv2d(self._q(x).permute(0, 3, 1, 2), self._q(w),
                     None if b is None else b.float(), stride, padding)
        return y.permute(0, 2, 3, 1)

    def attention(self, q, k, v, causal: bool = False, block: int = 1024) -> torch.Tensor:
        """Softmax attention over (B, S, H, D), fp32 scores, in blocks of
        queries so that a (B·H, 1024, S) score block is the most held."""
        b, sq, h, d = q.shape
        q, k, v = (self._q(t).permute(0, 2, 1, 3) for t in (q, k, v))
        out = torch.empty_like(q)
        scale = d ** -0.5
        for i in range(0, sq, block):
            s = torch.matmul(q[:, :, i:i + block], k.transpose(-1, -2)) * scale
            if causal:
                rows = torch.arange(i, min(i + block, sq), device=q.device)[:, None]
                cols = torch.arange(k.shape[2], device=q.device)[None, :]
                s = s.masked_fill(cols > rows, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[:, :, i:i + block] = torch.matmul(self._q(p), v)
        return out.permute(0, 2, 1, 3)


def group_norm(x: torch.Tensor, w, b, groups: int, eps: float, silu: bool = False):
    """GroupNorm over the last axis of (n, ..., c), statistics per sample and
    group over every other axis, float32."""
    shape = x.shape
    n, c = shape[0], shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape) * w.float() + b.float()
    return F.silu(y) if silu else y


def layer_norm(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
