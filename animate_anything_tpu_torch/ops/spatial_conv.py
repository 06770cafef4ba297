"""Kernel 8: one resnet stage, GroupNorm-affine (+SiLU) → 3×3 conv with zero
padding → + per-sample bias (+ residual) (``csrc/spatial_conv.cu``).

The port of ``animate_anything_tpu/ops/attic/spatial_conv.py``
(``gn_silu_spatial_conv``, replacing its ``_pallas_stage``) and of the entry
of ``animate_anything_tpu/ops/attic/conv3x3.py`` (``gn_silu_conv3x3``, the
same function without the residual, replacing its ``_pallas_stage``). The
GroupNorm statistics fold stays in ``group_affine``, so under the stats
switch they come from kernel 6. JAX's dispatcher sends most sites to its
exact twin ``_reference_stage`` (a VMEM gate, and a platform check off the
TPU); the twin computes the same numbers, so the kernel runs at every site.

``ResnetBlock2D`` takes this path when ``SPATIAL_CONV_OPTIN()`` holds.
Gradients: ``ops/autograd.Recompute`` differentiates
``spatial_conv_reference`` (JAX's ``_reference_stage``, the custom VJP's
twin).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops import group_norm as gn
from animate_anything_tpu_torch.ops.autograd import Recompute

K_CHUNK = 16  # the kernel's channel chunk: cin must be a multiple

launches = 0  # kernel launches by spatial_conv


def SPATIAL_CONV_OPTIN() -> bool:
    """Whether ``ResnetBlock2D`` runs both stages through kernel 8:
    ``AA_SPATIAL_CONV=1``, read at call time as in the JAX package (off by
    default)."""
    return os.environ.get("AA_SPATIAL_CONV", "") == "1"


@contextlib.contextmanager
def opt_in_config():
    """The JAX package's opt-in GroupNorm and resnet-conv configuration for
    the duration of the block: ``set_default_norm_impl("pallas")``,
    ``set_default_stats_impl("pallas")`` and ``AA_SPATIAL_CONV=1``; the
    previous settings come back on exit."""
    impl, stats = gn._DEFAULT_IMPL, gn._DEFAULT_STATS
    env = os.environ.get("AA_SPATIAL_CONV")
    gn.set_default_norm_impl("pallas")
    gn.set_default_stats_impl("pallas")
    os.environ["AA_SPATIAL_CONV"] = "1"
    try:
        yield
    finally:
        gn.set_default_norm_impl(impl)
        gn.set_default_stats_impl(stats)
        if env is None:
            os.environ.pop("AA_SPATIAL_CONV", None)
        else:
            os.environ["AA_SPATIAL_CONV"] = env


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """Conv2d weight (cout, cin, 3, 3) → (cin / 16, cout, 9, 16), tap
    3·dy + dx: the kernel's (N, K) operand cut into 16-channel chunks, each
    chunk's rows contiguous."""
    cout, cin = w.shape[:2]
    return (w.reshape(cout, cin // K_CHUNK, K_CHUNK, 9).permute(1, 0, 3, 2)
            .contiguous())


def spatial_conv_reference(x, a, b, w, bias, residual, silu: bool):
    """Plain version: x (n, H, W, cin), a/b (n, cin) fp32, w the Conv2d
    weight (cout, cin, 3, 3), bias (n, cout) fp32, residual (n, H, W, cout)
    or None. act = SiLU(a·x + b) in fp32 rounded to x's dtype; the conv in
    fp32 with zero padding (after the activation), + bias + residual in
    fp32, one rounding."""
    act = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if silu:
        act = F.silu(act)
    act = act.to(x.dtype).float().permute(0, 3, 1, 2)
    y = F.conv2d(act, w.float(), padding=1).permute(0, 2, 3, 1) + bias[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _launch(x, a, b, w, bias, residual, silu: bool):
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if cin % K_CHUNK or cout % 8:
        raise ValueError(f"spatial_conv: cin={cin} must be a multiple of {K_CHUNK}, "
                         f"cout={cout} of 8")
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("spatial_conv x", x, bf, (n, h, wd, cin))
    cuda_lib.check_cuda("spatial_conv a", a, f32, (n, cin))
    cuda_lib.check_cuda("spatial_conv b", b, f32, (n, cin))
    cuda_lib.check_cuda("spatial_conv w", w, bf, (cout, cin, 3, 3))
    cuda_lib.check_cuda("spatial_conv bias", bias, f32, (n, cout))
    if residual is not None:
        cuda_lib.check_cuda("spatial_conv residual", residual, bf, (n, h, wd, cout))
    wp = pack_weight(w)
    y = torch.empty((n, h, wd, cout), device=x.device, dtype=bf)
    cuda_lib.call("aat_spatial_conv", x.data_ptr(), a.data_ptr(), b.data_ptr(), wp.data_ptr(),
                  bias.data_ptr(), None if residual is None else residual.data_ptr(),
                  y.data_ptr(), n, h, wd, cin, cout, int(silu))
    global launches
    launches += 1
    return y


def spatial_conv(x, a, b, w, bias, residual=None, silu: bool = True) -> torch.Tensor:
    """One fused stage on the folded affine: see ``spatial_conv_reference``."""
    dt = x.dtype
    args = (x.contiguous(), a.float().contiguous(), b.float().contiguous(),
            w.to(dt).contiguous(), bias.float().contiguous(),
            None if residual is None else residual.to(dt).contiguous(), silu)
    run = spatial_conv_reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, spatial_conv_reference, *args)


def gn_silu_spatial_conv(x, gn_scale, gn_bias, w, bias, *, groups: int, eps: float = 1e-5,
                         silu: bool = True, extra_bias=None, residual=None) -> torch.Tensor:
    """One resnet stage: GroupNorm → SiLU → conv3×3 (+ per-sample bias,
    + optional residual). x (n, H, W, cin); w the Conv2d weight (cout, cin,
    3, 3); bias (cout,); extra_bias (n, cout), e.g. the time embedding;
    statistics per (sample, group) over (H, W, cin/groups)."""
    n, h, wd, cin = x.shape
    a, b = gn.group_affine(x.reshape(n, h * wd, cin), gn_scale, gn_bias, groups, eps)
    bias_pb = bias.float()[None, :].expand(n, -1)
    if extra_bias is not None:
        bias_pb = bias_pb + extra_bias.float()
    return spatial_conv(x, a, b, w, bias_pb, residual, silu)


def gn_silu_conv3x3(x, gn_scale, gn_bias, w, bias, *, groups: int, eps: float = 1e-5,
                    extra_bias=None) -> torch.Tensor:
    """GroupNorm → SiLU → conv3×3 + per-sample bias: the port of
    ``ops/attic/conv3x3.py::gn_silu_conv3x3``, run by kernel 8 with no
    residual."""
    return gn_silu_spatial_conv(x, gn_scale, gn_bias, w, bias, groups=groups, eps=eps,
                                extra_bias=extra_bias)
