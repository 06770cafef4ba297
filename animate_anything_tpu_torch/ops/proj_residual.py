"""Kernel 4: transformer output projection + residual + GroupNorm-stats
epilogue (``csrc/proj_residual.cu``).

Replaces ``animate_anything_tpu/ops/proj_residual.py::_pallas_proj``:
``y = h·Wᵀ + bias + residual`` with per-(n, c) fp32 (Σy, Σy²) of the STORED
y, which the consumer GroupNorm takes through ``group_affine(sums=)``, added
in one fixed order (``temporal_conv.sums_scratch``), so identical calls
return identical bits. The
weight is the torch Linear layout (c, k). The kernel is the slab form of
``csrc/gemm.cuh``'s persistent TMA + wgmma residual GEMM (kernel 2's second
GEMM); design note in the source header. ``launch_plan`` picks the tile
width, ring depth, grid and shared memory, on any machine.

Gradients: ``ops/autograd.Recompute`` differentiates ``proj_residual_twin``
(JAX's ``_reference``, the custom_vjp's remat target) with all three
cotangents: the sums feed the next GroupNorm, so theirs is not zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib, geglu
from animate_anything_tpu_torch.ops.autograd import Recompute, flat_stats
from animate_anything_tpu_torch.ops.temporal_conv import sums_scratch

SUB_ROWS = 64  # a sub-tile: 64 rows of one slab, one warpgroup's; two make a tile
TILE_WIDTHS = geglu.OUT_BN  # output columns a tile: the residual GEMM's instantiations
MAX_STAGES = 6  # as many as fit: 5 at 160 columns, where 4 were 5 % slower at s = 4096

launches = 0  # kernel launches by proj_residual_stats


def launch_plan(n: int, s: int, k: int, c: int, sms: int = 132) -> dict:
    """The kernel's tiles for n slabs of s rows on a card of ``sms`` SMs,
    without the card: 64-row sub-tiles of each slab paired into 128-row
    tiles; ``bn`` output columns a tile by ``geglu.pick_width``; the ring as
    deep as fits (at most ``MAX_STAGES``), persistent grid and shared-memory
    bytes (``GemmLayout::smem``)."""
    if min(n, s) < 1 or k < 8 or k % 8 or c < 8 or c % 8:
        raise ValueError(f"proj_residual_stats: n={n}, s={s} ≥ 1, k={k} and c={c} "
                         "multiples of 8 needed")
    subs = n * -(-s // SUB_ROWS)
    pairs = -(-subs // 2)
    bn = geglu.pick_width(pairs, c, TILE_WIDTHS, sms)
    tiles = pairs * -(-c // bn)
    per_stage = geglu._gemm_smem(bn, 1, bn) - geglu._gemm_smem(bn, 0, bn)
    stages = min(MAX_STAGES, (geglu.SMEM_LIMIT - geglu._gemm_smem(bn, 0, bn)) // per_stage)
    return dict(bn=bn, stages=stages, grid=min(tiles, sms), smem=geglu._gemm_smem(bn, stages, bn),
                subs=subs, tiles=tiles)


def proj_residual_reference(h, w, bias, residual):
    """Plain version: fp32 accumulation, one rounding of y, sums of the
    rounded y."""
    y = h.float() @ w.float().t() + bias.float() + residual.float()
    yc = y.to(h.dtype)
    yf = yc.float()
    return yc, (yf.sum(1), yf.square().sum(1))


def proj_residual_twin(h, w, bias, residual):
    """Differentiable twin of JAX's ``_reference`` in h's dtype, flat
    ``(y, Σy, Σy²)``: the product on h-dtype operands with fp32
    accumulation, bias and residual added in fp32, sums of the rounded y."""
    y = F.linear(h, w).float() + bias.float() + residual.float()
    yc = y.to(h.dtype)
    yf = yc.float()
    return yc, yf.sum(1), yf.square().sum(1)


def _launch(h, w, bias, residual):
    n, s, k = h.shape
    c = w.shape[0]
    bf = torch.bfloat16
    cuda_lib.check_cuda("proj_residual h", h, bf, (n, s, k))
    cuda_lib.check_cuda("proj_residual w", w, bf, (c, k))
    cuda_lib.check_cuda("proj_residual bias", bias, torch.float32, (c,))
    cuda_lib.check_cuda("proj_residual residual", residual, bf, (n, s, c))
    plan = launch_plan(n, s, k, c, cuda_lib.sm_count(h.device))
    y = torch.empty_like(residual)
    s1, s2, part, tk = sums_scratch(n, s, c, -(-c // plan["bn"]), h.device)
    cuda_lib.call("aat_proj_residual", h.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  residual.data_ptr(), y.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                  None if part is None else part.data_ptr(), tk.data_ptr(), n, s, k, c,
                  plan["bn"], plan["stages"], plan["grid"], plan["smem"])
    global launches
    launches += 1
    return y, (s1, s2)


def proj_residual_stats(h, w, bias, residual):
    """h (n, s, k), w (c, k), bias (c,), residual (n, s, c) →
    ``(y, (Σy, Σy²))`` with the sums per (n, c) in fp32."""
    dt = h.dtype
    args = (h, w.to(dt).contiguous(), bias.float().contiguous(), residual.to(dt))
    run = proj_residual_reference if h.device.type == "cpu" else _launch
    y, s1, s2 = Recompute.apply(flat_stats(run), proj_residual_twin, *args)
    return y, (s1, s2)
