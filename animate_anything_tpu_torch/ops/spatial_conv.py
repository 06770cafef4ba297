"""Kernel 8: one resnet stage, GroupNorm-affine (+SiLU) → 3×3 conv with zero
padding → + per-sample bias (+ residual) (``csrc/spatial_conv.cu``): an
activation pass into an (n, H, W, cin) bf16 buffer, then a persistent
TMA + wgmma implicit GEMM with K = 9·cin over the channels_last conv weight,
whose memory is the GEMM's (cout, 9·cin) operand (``pack_weight``); a call
is those two launches.
``launch_plan`` picks the tiles, ring depth, grid and shared memory, on any
machine.

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

from animate_anything_tpu_torch.ops import cuda_lib, geglu
from animate_anything_tpu_torch.ops import group_norm as gn
from animate_anything_tpu_torch.ops.autograd import Recompute
from animate_anything_tpu_torch.utils.tracing import traced

CIN_MULTIPLE = 16   # the kernel's reach: cin % 16 == 0, cout % 8 == 0, any H, W
SUB_PIXELS = 64     # a sub-tile: 64 pixels of one image, one warpgroup's
# Output columns a tile → (columns of one accumulator, accumulators): the
# C entry point's instantiations (``ConvLayout<NB, NACC>``). One accumulator
# runs two blocks a SM (``__launch_bounds__``), two run one.
TILE_WIDTHS = {256: (128, 2), 160: (160, 1)}
MAX_STAGES = 4
SMEM_LIMIT = geglu.SMEM_LIMIT  # a block's dynamic shared memory
SM_SMEM = 233472               # a SM's shared memory; each block reserves 1024 of it
NARROW_COUT = 640              # up to this cout, 160-column tiles at two blocks a SM

launches = 0  # spatial_conv calls on the card (each: the activation pass and the GEMM)


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


def sub_tile(w: int) -> tuple[int, int]:
    """A sub-tile's (TW, TR): TR image rows of TW = W rounded up to a power
    of two pixels where W ≤ 64 (a whole 8×8 image at W = 8), else a
    64-pixel run of one row; TW·TR = 64."""
    tw = 1
    while tw < w and tw < SUB_PIXELS:
        tw *= 2
    return tw, SUB_PIXELS // tw


def _smem(bn: int, stages: int) -> int:
    """Dynamic shared bytes of a GEMM block (``ConvLayout::smem`` in the
    source): 1024 for the swizzle alignment, per stage the two 64-pixel A
    sub-tiles (128 x 64 bf16), the bn x 64 bf16 B tile, its full barrier and
    its done-counter (8 bytes each)."""
    return 1024 + stages * (128 * 64 * 2 + bn * 64 * 2 + 16)


def launch_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int = 132) -> dict:
    """The GEMM's tiles for one stage on a card of ``sms`` SMs, without the
    card: 64-pixel sub-tiles (``sub_tile``) paired into 128-pixel tiles;
    ``bn`` output columns a tile: 160 at two blocks a SM up to cout = 640
    (the two blocks hide each other's load waits), else 256
    at one block a SM (at 16² and 8², 272 and 68 tiles of 320 columns
    would take three waves or leave half the SMs idle); ring depth (as many
    stages as fit in the block's share of the SM, at most 4), persistent
    grid (a block for every slot) and shared-memory bytes."""
    if cin % CIN_MULTIPLE or cin < CIN_MULTIPLE or cout % 8 or cout < 8 or min(n, h, w) < 1:
        raise ValueError(f"spatial_conv: cin={cin} must be a multiple of {CIN_MULTIPLE}, "
                         f"cout={cout} of 8")
    tw, tr = sub_tile(w)
    subs = n * -(-h // tr) * -(-w // tw)
    pairs = -(-subs // 2)
    bn = 160 if cout <= NARROW_COUT else 256
    blocks = 2 if TILE_WIDTHS[bn][1] == 1 else 1  # blocks a SM
    fit = min(SMEM_LIMIT, SM_SMEM // blocks - 1024)
    tiles = pairs * -(-cout // bn)
    stages = min(MAX_STAGES, (fit - _smem(bn, 0)) // (_smem(bn, 1) - _smem(bn, 0)))
    return dict(bn=bn, stages=stages, grid=min(tiles, blocks * sms), smem=_smem(bn, stages),
                blocks=blocks, tw=tw, tr=tr, subs=subs, tiles=tiles, k_steps=9 * -(-cin // 64))


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """Conv2d weight (cout, cin, 3, 3) → (cout, 9·cin), column (3·dy + dx)·cin
    + ci: the GEMM's B operand, K-major. For a channels_last weight (the
    port's ``Conv2d`` keeps its weight so) this is a view of its memory, so
    the kernel reads the weight in place: nothing is packed or cached, and
    an in-place update is seen by the next call."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def activation(x, a, b, silu: bool) -> torch.Tensor:
    """Plain version of the first launch: act = SiLU(a·x + b) (or a·x + b)
    in fp32, rounded once to x's dtype; x (n, H, W, cin), a/b (n, cin)."""
    act = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if silu:
        act = F.silu(act)
    return act.to(x.dtype)


def tap_gemm_reference(act, wp, bias, residual) -> torch.Tensor:
    """Plain version of the second launch, the kernel's arithmetic: one GEMM
    with K = 9·cin of the nine shifted windows of act, zero-padded by one
    pixel, against the packed weight ``wp`` (cout, 9·cin), in fp32, +
    bias (n, cout) (+ residual), one rounding."""
    n, h, w, _ = act.shape
    pad = F.pad(act.float(), (0, 0, 1, 1, 1, 1))
    taps = torch.cat([pad[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1)
    y = taps @ wp.float().t() + bias[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    return y.to(act.dtype)


def spatial_conv_reference(x, a, b, w, bias, residual, silu: bool):
    """Plain version: x (n, H, W, cin), a/b (n, cin) fp32, w the Conv2d
    weight (cout, cin, 3, 3), bias (n, cout) fp32, residual (n, H, W, cout)
    or None. ``activation``, then the conv in fp32 with zero padding (after
    the activation), + bias + residual in fp32, one rounding."""
    act = activation(x, a, b, silu).float().permute(0, 3, 1, 2)
    y = F.conv2d(act, w.float(), padding=1).permute(0, 2, 3, 1) + bias[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _launch(x, a, b, w, bias, residual, silu: bool):
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("spatial_conv x", x, bf, (n, h, wd, cin))
    cuda_lib.check_cuda("spatial_conv a", a, f32, (n, cin))
    cuda_lib.check_cuda("spatial_conv b", b, f32, (n, cin))
    wp = pack_weight(w)
    cuda_lib.check_cuda("spatial_conv w", wp, bf, (cout, 9 * cin))
    if wp.data_ptr() != w.data_ptr():
        raise ValueError("spatial_conv w: expected a channels_last weight (cout, cin, 3, 3)")
    cuda_lib.check_cuda("spatial_conv bias", bias, f32, (n, cout))
    if residual is not None:
        cuda_lib.check_cuda("spatial_conv residual", residual, bf, (n, h, wd, cout))
    plan = launch_plan(n, h, wd, cin, cout, cuda_lib.sm_count(x.device))
    act = torch.empty_like(x)   # SiLU(a·x + b) in bf16, read back by the GEMM's TMA
    y = torch.empty((n, h, wd, cout), device=x.device, dtype=bf)
    cuda_lib.call("aat_spatial_conv", x.data_ptr(), a.data_ptr(), b.data_ptr(), wp.data_ptr(),
                  bias.data_ptr(), None if residual is None else residual.data_ptr(),
                  act.data_ptr(), y.data_ptr(), n, h, wd, cin, cout, int(silu), plan["bn"],
                  plan["stages"], plan["grid"], plan["smem"])
    global launches
    launches += 1
    return y


@traced("op.spatial_conv")
def spatial_conv(x, a, b, w, bias, residual=None, silu: bool = True) -> torch.Tensor:
    """One fused stage on the folded affine: see ``spatial_conv_reference``.
    A channels_last ``w`` goes to the kernel as it is; any other is copied
    into that layout first."""
    dt = x.dtype
    args = (x.contiguous(), a.float().contiguous(), b.float().contiguous(),
            w.to(dt).contiguous(memory_format=torch.channels_last), bias.float().contiguous(),
            None if residual is None else residual.to(dt).contiguous(), silu)
    run = spatial_conv_reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, spatial_conv_reference, *args)


@traced("op.gn_silu_spatial_conv")
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
