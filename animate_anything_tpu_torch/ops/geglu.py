"""Kernel 2: LayerNorm → GEGLU feed-forward → residual
(``csrc/geglu.cu``).

Replaces ``animate_anything_tpu/ops/geglu.py::_pallas_ln_geglu`` (c ≤ 640)
and ``::_pallas_ln_geglu_wide`` (c = 1280) with one Hopper code path for
every width. GELU is the tanh form, the JAX package's default
(``_GELU_IMPL``). A call is three launches: the LayerNorm pass and two
TMA + wgmma GEMMs, the first with the GEGLU epilogue, the second
with the bias and residual; the (n, 4c) bf16 GEGLU product goes through
device memory between them. The design note is in the source's header;
``launch_plan`` picks the tiles, ring depth, grid and shared memory, on any
machine.

Weights arrive in the torch Linear layout: ``w1`` (8c, c) with the val rows
first and the gate rows second (diffusers ``GEGLU.proj``), ``w2`` (c, 4c).

Gradients: ``ops/autograd.Recompute`` saves the inputs and differentiates
``ln_geglu_twin``, the torch twin of JAX's ``_reference_lean`` (the
custom_vjp's remat target), as JAX has no backward kernel here either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute

MAX_C = 1280
SMEM_LIMIT = 232448        # dynamic shared memory a block may use on the H100
GEMM_BM, GEMM_BK = 128, 64  # tile rows (two warpgroups of 64); K step
GEGLU_BN = (256, 128)       # GEMM 1 tile widths: half val, half gate columns
OUT_BN = (256, 160, 128, 64)  # GEMM 2 tile widths the kernel instantiates
MAX_STAGES = 4

launches = 0  # ln_geglu_ff calls on the card (each: the LN pass and two GEMMs)


def _gemm_smem(bn: int, stages: int, out: int) -> int:
    """Dynamic shared bytes of a GEMM block (``GemmLayout::smem`` in the
    source): 1024 for the swizzle alignment; per stage the A (128 x 64) and
    B (bn x 64) bf16 tiles and two mbarriers; the two warpgroups' 64 x
    ``out`` bf16 output tiles and their residual mbarriers."""
    return 1024 + stages * (2 * GEMM_BK * (GEMM_BM + bn) + 16) + 2 * 64 * out * 2 + 16


def _stages(bn: int, out: int) -> int:
    fit = (SMEM_LIMIT - _gemm_smem(bn, 0, out)) // (2 * GEMM_BK * (GEMM_BM + bn) + 16)
    return min(MAX_STAGES, fit)


def _out_bn(n_out: int) -> int:
    """The residual GEMM's tile width: the widest that wastes the fewest
    output columns."""
    return min(OUT_BN, key=lambda bn: (-(-n_out // bn) * bn, -bn))


# A tile's fixed cost (ring fill, epilogue, store) in output columns of its
# mainloop, for ``pick_width``.
TILE_OVERHEAD_COLS = 64


def pick_width(row_tiles: int, n_out: int, widths, sms: int = 132) -> int:
    """The output-column tile width of a persistent GEMM over ``row_tiles``
    128-row tiles on ``sms`` SMs: the fewest waves of tiles times a tile's
    work (its columns plus ``TILE_OVERHEAD_COLS``), then the widest. The
    waves count the tail: 272 tiles take three waves of 132."""
    def cost(bn: int) -> tuple:
        tiles = row_tiles * -(-n_out // bn)
        return -(-tiles // sms) * (bn + TILE_OVERHEAD_COLS), -bn
    return min(widths, key=cost)


def gemm_plan(m: int, n_out: int, k: int, sms: int = 132) -> dict:
    """The residual GEMM ``y (m, n_out) = a (m, k)·wᵀ + bias + res``
    (``gemm.cuh::gemm_bias_residual``, kernel 2's GEMM 2, which kernel 5's
    out-projection shares): tile width, ring depth, persistent grid and
    shared-memory bytes on a card of ``sms`` SMs."""
    if m < 1 or n_out < 8 or n_out % 8 or k < 8 or k % 8:
        raise ValueError(f"gemm: m={m} ≥ 1, n={n_out} and k={k} multiples of 8 needed")
    bn = _out_bn(n_out)
    tiles = -(-m // GEMM_BM) * -(-n_out // bn)
    stages = _stages(bn, bn)
    return dict(bn=bn, stages=stages, grid=min(tiles, sms), smem=_gemm_smem(bn, stages, bn),
                tiles=tiles)


def launch_plan(n: int, c: int, sms: int = 132) -> dict:
    """The kernels' tiles for (n, c) rows on a card of ``sms`` SMs, without
    the card: GEMM 1 (``bn1`` accumulator columns, ``bn1 / 2`` of act a
    tile: val columns [j, j + bn1/2) from W1 rows j.. and the gate columns
    from rows ``gate_row0`` + j..), GEMM 2 (``bn2`` output columns), each
    with its ring depth, persistent grid and shared-memory bytes."""
    if c % 16 or not 0 < c <= MAX_C or n < 1:
        raise ValueError(f"ln_geglu_ff: c={c} must be a multiple of 16 in (0, {MAX_C}], "
                         f"n={n} ≥ 1")
    inner = 4 * c
    row_tiles = -(-n // GEMM_BM)
    bn1 = next(bn for bn in GEGLU_BN if inner % (bn // 2) == 0)
    tiles1 = row_tiles * inner // (bn1 // 2)
    st1 = _stages(bn1, bn1 // 2)
    g2 = gemm_plan(n, c, inner, sms)
    return dict(bn1=bn1, stages1=st1, grid1=min(tiles1, sms),
                smem1=_gemm_smem(bn1, st1, bn1 // 2),
                bn2=g2["bn"], stages2=g2["stages"], grid2=g2["grid"], smem2=g2["smem"],
                gate_row0=inner, tiles1=tiles1, tiles2=g2["tiles"])


def ln_geglu_reference(x2, s, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Plain version on (n, c) rows, the arithmetic of the kernel: LN in fp32
    stored in x's dtype, both products with fp32 accumulation, the GEGLU
    product rounded to x's dtype before the down-projection."""
    xf = x2.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()).to(x2.dtype)
    h = ln.float() @ w1.float().t() + b1.float()
    val, gate = h.chunk(2, dim=-1)
    act = (val * F.gelu(gate, approximate="tanh")).to(x2.dtype)
    y = act.float() @ w2.float().t() + b2.float() + xf
    return y.to(x2.dtype)


def ln_geglu_twin(x2, s, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Differentiable twin of JAX's ``_reference_lean`` in x2's dtype: LN in
    fp32 stored in x's dtype; both products on x-dtype operands with fp32
    accumulation; the (n, 8c) hidden h stored in x's dtype; tanh GELU in
    fp32. In fp32 it is ``ln_geglu_reference``."""
    dt = x2.dtype
    xf = x2.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()).to(dt)
    h = F.linear(ln, w1, b1.to(dt))
    val, gate = h.chunk(2, dim=-1)
    act = (val.float() * F.gelu(gate.float(), approximate="tanh")).to(dt)
    y = F.linear(act, w2).float() + b2.float() + xf
    return y.to(dt)


def _launch(x2, s, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    n, c = x2.shape
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("ln_geglu x", x2, bf, (n, c))
    cuda_lib.check_cuda("ln_geglu ln scale", s, f32, (c,))
    cuda_lib.check_cuda("ln_geglu ln bias", b, f32, (c,))
    cuda_lib.check_cuda("ln_geglu w1", w1, bf, (8 * c, c))
    cuda_lib.check_cuda("ln_geglu b1", b1, f32, (8 * c,))
    cuda_lib.check_cuda("ln_geglu w2", w2, bf, (c, 4 * c))
    cuda_lib.check_cuda("ln_geglu b2", b2, f32, (c,))
    plan = launch_plan(n, c, torch.cuda.get_device_properties(x2.device).multi_processor_count)
    y = torch.empty_like(x2)
    ln = torch.empty_like(x2)                          # LN(x) in bf16
    act = torch.empty((n, 4 * c), device=x2.device, dtype=bf)  # val ⊙ gelu(gate) in bf16
    cuda_lib.call("aat_ln_geglu", x2.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(),
                  b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), ln.data_ptr(),
                  act.data_ptr(), n, c, eps, plan["bn1"], plan["stages1"], plan["grid1"],
                  plan["smem1"], plan["bn2"], plan["stages2"], plan["grid2"], plan["smem2"],
                  plan["gate_row0"])
    global launches
    launches += 1
    return y


def ln_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5) -> torch.Tensor:
    """``x + GEGLU_FF(LayerNorm(x))`` over the last axis of x (..., c)."""
    shape = x.shape
    c = shape[-1]
    x2 = x.reshape(-1, c)
    dt = x.dtype
    args = (x2, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            w1.to(dt).contiguous(), b1.float().contiguous(), w2.to(dt).contiguous(),
            b2.float().contiguous())
    run = ln_geglu_reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, ln_geglu_twin, *args, eps).reshape(shape)
