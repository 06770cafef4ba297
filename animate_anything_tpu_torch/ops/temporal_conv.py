"""Kernel 3: GroupNorm-apply → SiLU → 3-tap frame conv (+ residual) with a
per-(batch, frame, channel) stats epilogue (``csrc/temporal_conv.cu``), a
persistent TMA + wgmma GEMM with K = 3·cin over the packed taps.

Replaces ``animate_anything_tpu/ops/temporal_conv.py::_pallas_stage``. The
GroupNorm statistics fold stays plain torch through ``group_affine``, as in
JAX; the kernel takes the folded (a, b). Unlike the TPU path (gated to
c ≤ 640 by VMEM) the kernel runs at every width, and it always emits the
stats of its stored output, in one fixed order of additions (per-sub-tile
partials folded in sub-tile order: ``sums_scratch``), so identical calls
return identical bits. Design note in the source header;
``launch_plan`` picks the tiles, ring depth, grid and shared memory, on any
machine.

Gradients: ``ops/autograd.Recompute`` differentiates ``tap_conv_twin`` (JAX's
``_reference_stage_stats``, the custom_vjp's remat target) with all three
cotangents (y, Σy, Σy²): the sums feed the next stage's GroupNorm, and
through ``group_affine`` the folded (a, b) get their gradients too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib, geglu, group_norm
from animate_anything_tpu_torch.ops.autograd import Recompute, flat_stats
from animate_anything_tpu_torch.ops.group_norm import group_affine

CIN_MULTIPLE = 32   # the kernel's reach: cin % 32 == 0, cout % 8 == 0
SUB_ROWS = 64       # a sub-tile: 64 rows of one (batch, frame) slab, one warpgroup's
TILE_WIDTHS = (320, 256)  # output columns a tile: 2 accumulators of 160 or 128
MAX_STAGES = 4
SMEM_LIMIT = geglu.SMEM_LIMIT

launches = 0  # kernel launches by tap_conv


# Output columns a tile → those of one accumulator (``TapLayout``'s NB).
_ACC_WIDTH = {320: 160, 256: 128}


def _smem(bn: int, stages: int) -> int:
    """Dynamic shared bytes of a block (``TapLayout::smem`` in the source):
    1024 for the swizzle alignment, per stage the two 64-row A sub-tiles
    (128 x 64 bf16), the bn x 64 bf16 B tile and two mbarriers, then the two
    warpgroups' 64-row output tiles of one accumulator's columns."""
    return 1024 + stages * (128 * 64 * 2 + bn * 64 * 2 + 16) + 2 * 64 * _ACC_WIDTH[bn] * 2


def launch_plan(bsz: int, f: int, s: int, cin: int, cout: int, sms: int = 132) -> dict:
    """The kernel's tiles for one stage on a card of ``sms`` SMs, without
    the card: ``bn`` output columns a tile (320, or 256 where 320-column
    tiles would leave SMs idle: the UNet's s = 64 site), 64-row sub-tiles
    of each (batch, frame) slab paired into 128-row tiles, the ring depth
    (as many stages as fit, at most 4), the persistent grid and the
    shared-memory bytes."""
    if cin % CIN_MULTIPLE or cin < CIN_MULTIPLE or cout % 8 or cout < 8 or min(bsz, f, s) < 1:
        raise ValueError(f"tap_conv: cin={cin} must be a multiple of {CIN_MULTIPLE}, "
                         f"cout={cout} of 8")
    subs = bsz * f * -(-s // SUB_ROWS)
    bn = 320 if -(-subs // 2) * -(-cout // 320) >= sms else 256
    tiles = -(-subs // 2) * -(-cout // bn)
    stages = min(MAX_STAGES, (SMEM_LIMIT - _smem(bn, 0)) // (_smem(bn, 1) - _smem(bn, 0)))
    return dict(bn=bn, stages=stages, grid=min(tiles, sms), smem=_smem(bn, stages),
                subs=subs, tiles=tiles, k_steps=3 * -(-cin // 64))


def sums_scratch(slabs: int, s: int, cout: int, chunks: int, device) -> tuple:
    """The fixed-order sums' buffers of kernels 3 and 4 for ``slabs`` slabs
    of s rows and ``cout`` columns in ``chunks`` output chunks: Σy and Σy²
    (slabs, cout) fp32, written by the kernel; the flat fp32 scratch of the
    per-sub-tile partials and their groups' sums, None where a slab is one
    sub-tile; and the zeroed tickets of the device's current stream
    (``group_norm.tickets``), left zeroed. The library sizes the scratch
    (``cuda_lib.slab_sums_sizes``), which owns its layout."""
    part_n, tickets_n = cuda_lib.slab_sums_sizes(slabs, s, cout, chunks)
    s1 = torch.empty((slabs, cout), device=device, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    part = torch.empty(part_n, device=device, dtype=torch.float32) if part_n else None
    return s1, s2, part, group_norm.tickets(device, tickets_n)


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (cout, cin, 3, 1, 1) → (cout, 3, cin): one (cout, cin)
    matrix per frame tap, the layout the kernel streams as a (cout, 3·cin)
    GEMM operand."""
    cout, cin = w.shape[:2]
    return w.reshape(cout, cin, 3).permute(0, 2, 1).contiguous()


def tap_conv_reference(x, a, b, w, bias, residual):
    """Plain version: x (bsz, f, s, cin), a/b (bsz, cin) fp32, w (cout, 3,
    cin), bias (cout,), residual (bsz, f, s, cout) or None →
    ``(y, (Σy, Σy²))`` with the sums per (bsz, f, cout) of the stored y."""
    act = F.silu(x.float() * a[:, None, None, :] + b[:, None, None, :])
    act = act.to(x.dtype).float()
    prev = F.pad(act[:, :-1], (0, 0, 0, 0, 1, 0))
    nxt = F.pad(act[:, 1:], (0, 0, 0, 0, 0, 1))
    # one GEMM with K = 3·cin over [prev ‖ act ‖ next], as the kernel runs it
    taps = torch.cat([prev, act, nxt], -1)
    y = taps @ w.float().reshape(w.shape[0], -1).t() + bias.float()
    if residual is not None:
        y = y + residual.float()
    yc = y.to(x.dtype)
    yf = yc.float()
    return yc, (yf.sum(2), yf.square().sum(2))


def tap_conv_twin(x, a, b, w, bias, residual):
    """Differentiable twin of ``tap_conv_reference`` in x's dtype, flat
    ``(y, Σy, Σy²)``: the taps GEMM on x-dtype operands with fp32
    accumulation, bias and residual in fp32, sums of the rounded y."""
    act = F.silu(x.float() * a[:, None, None, :] + b[:, None, None, :]).to(x.dtype)
    prev = F.pad(act[:, :-1], (0, 0, 0, 0, 1, 0))
    nxt = F.pad(act[:, 1:], (0, 0, 0, 0, 0, 1))
    y = F.linear(torch.cat([prev, act, nxt], -1), w.reshape(w.shape[0], -1)).float()
    y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    yc = y.to(x.dtype)
    yf = yc.float()
    return yc, yf.sum(2), yf.square().sum(2)


def _launch(x, a, b, w, bias, residual):
    bsz, f, s, cin = x.shape
    cout = w.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("tap_conv x", x, bf, (bsz, f, s, cin))
    cuda_lib.check_cuda("tap_conv a", a, f32, (bsz, cin))
    cuda_lib.check_cuda("tap_conv b", b, f32, (bsz, cin))
    cuda_lib.check_cuda("tap_conv w", w, bf, (cout, 3, cin))
    cuda_lib.check_cuda("tap_conv bias", bias, f32, (cout,))
    if residual is not None:
        cuda_lib.check_cuda("tap_conv residual", residual, bf, (bsz, f, s, cout))
    plan = launch_plan(bsz, f, s, cin, cout, cuda_lib.sm_count(x.device))
    y = torch.empty((bsz, f, s, cout), device=x.device, dtype=bf)
    chunks = -(-cout // plan["bn"]) * 2  # two accumulators a tile
    s1, s2, part, tk = sums_scratch(bsz * f, s, cout, chunks, x.device)
    cuda_lib.call("aat_tap_conv", x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                  bias.data_ptr(), None if residual is None else residual.data_ptr(),
                  y.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                  None if part is None else part.data_ptr(), tk.data_ptr(), bsz, f, s, cin,
                  cout, plan["bn"], plan["stages"], plan["grid"], plan["smem"])
    global launches
    launches += 1
    return y, (s1.view(bsz, f, cout), s2.view(bsz, f, cout))


def tap_conv(x, a, b, w, bias, residual=None):
    """One fused stage on the folded affine: see ``tap_conv_reference``.
    ``w`` is packed (cout, 3, cin)."""
    dt = x.dtype
    args = (x, a.float().contiguous(), b.float().contiguous(), w.to(dt).contiguous(),
            bias.float().contiguous(), None if residual is None else residual.to(dt))
    run = tap_conv_reference if x.device.type == "cpu" else _launch
    y, s1, s2 = Recompute.apply(flat_stats(run), tap_conv_twin, *args)
    return y, (s1, s2)


def gn_silu_tap_conv(x, gn_scale, gn_bias, w, bias, *, groups: int, eps: float = 1e-5,
                     residual=None, sums=None):
    """One TemporalConvLayer stage: GroupNorm(+affine) → SiLU → 3-tap frame
    conv (zero frames past the ends) → + residual.

    x (bsz, f, s, cin); w the Conv3d weight (cout, cin, 3, 1, 1); GroupNorm
    statistics per (bsz, group) over (f, s, cin/groups). ``sums``: optional
    per-(bsz, cin) fp32 (Σx, Σx²) of x from its producer. Returns
    ``(y, (Σy, Σy²))`` with the sums per (bsz, f, cout) of the stored y."""
    bsz, f, s, cin = x.shape
    a, b = group_affine(x.reshape(bsz, f * s, cin), gn_scale, gn_bias, groups, eps,
                        sums=sums)
    return tap_conv(x, a, b, pack_taps(w), bias, residual)
