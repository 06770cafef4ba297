"""Kernel 2: LayerNorm → GEGLU feed-forward → residual
(``csrc/geglu.cu``).

Replaces ``animate_anything_tpu/ops/geglu.py::_pallas_ln_geglu`` (c ≤ 640)
and ``::_pallas_ln_geglu_wide`` (128-aligned c from 768 to 2432) with one
Hopper code path for every width up to ``MAX_C`` = 4096 (``kernel_ok``): the
kernel takes c % 8 == 0 (TMA's 16-byte row strides), and the wrapper runs
any other c zero-padded to the next multiple of 8 (``pad_operands``). Past
``MAX_C`` the card runs ``ln_geglu_twin``, JAX's lean composite, which is
what JAX runs at every c > 2432. GELU is the tanh form, the JAX package's default
(``_GELU_IMPL``). A call is three launches: the LayerNorm pass and two
TMA + wgmma GEMMs, the first with the GEGLU epilogue, the second
with the bias and residual; the (n, 4c) bf16 GEGLU product goes through
device memory between them. The design note is in the source's header;
``launch_plan`` picks the tiles, ring depth, grid and shared memory, on any
machine.

Weights arrive in the torch Linear layout: ``w1`` (8c, c) with the val rows
first and the gate rows second (diffusers ``GEGLU.proj``), ``w2`` (c, 4c).

Tensor parallelism (``parallel/tensor.py``): a rank holds the val rows and
the gate rows of one range of the 4c hidden columns, paired as the kernel
pairs them (``w1`` (2·inner, c), ``b1`` (2·inner,), ``w2`` (c, inner), inner
= 4c/T), and ``partial=True`` runs GEMM 2 without b2 and the residual: the
rank's share of W2·act in x's dtype, which the caller sums over the ranks
before adding b2 and x once.

Gradients: ``ops/autograd.Recompute`` saves the inputs and differentiates
``ln_geglu_twin``, the torch twin of JAX's ``_reference_lean`` (the
custom_vjp's remat target), as JAX has no backward kernel here either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute
from animate_anything_tpu_torch.utils.tracing import traced

MAX_C = 4096              # the LayerNorm pass holds a row in a warp's registers
SMEM_LIMIT = 232448        # dynamic shared memory a block may use on the H100
GEMM_BM, GEMM_BK = 128, 64  # tile rows (two warpgroups of 64); K step
GEGLU_BN = (256, 128)       # GEMM 1 tile widths: half val, half gate columns
OUT_BN = (256, 160, 128, 64)  # GEMM 2 tile widths the kernel instantiates
MAX_STAGES = 4

launches = 0  # ln_geglu_ff calls on the card (each: the LN pass and two GEMMs)
partial_launches = 0  # those of them in the partial mode (a tensor-parallel rank's share)


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


def kernel_ok(c: int) -> bool:
    """Kernel 2's reach: 0 < c ≤ ``MAX_C`` (``launch_plan`` takes exactly
    these). It holds wherever JAX runs one of its kernels (its fused kernel
    at c ≤ 640, its wide kernel at 128-aligned c up to 2432); past it the
    port runs ``ln_geglu_twin``, JAX's ``_reference_lean``, as JAX does."""
    return 0 < c <= MAX_C


def padded_width(c: int) -> int:
    """The width kernel 2 runs a c-wide call at: c rounded up to 8."""
    return -(-c // 8) * 8


def launch_plan(n: int, c: int, sms: int = 132, inner: int = None) -> dict:
    """The kernels' tiles for (n, c) rows on a card of ``sms`` SMs, without
    the card, at the padded width ``cp``: GEMM 1 (``bn1`` accumulator
    columns, ``bn1 / 2`` of act a tile: val columns [j, j + bn1/2) from W1
    rows j.. and the gate columns from rows ``gate_row0`` + j..; the last
    tile's columns past 4·cp are not stored), GEMM 2 (``bn2`` output
    columns), each with its ring depth, persistent grid and shared-memory
    bytes. ``inner``: the hidden columns a call computes (4·cp, or a
    tensor-parallel rank's share, a multiple of 8)."""
    if not kernel_ok(c) or n < 1:
        raise ValueError(f"ln_geglu_ff: c={c} must be in (0, {MAX_C}], n={n} ≥ 1")
    cp = padded_width(c)
    if inner is None:
        inner = 4 * cp
    elif inner % 8 or not 8 <= inner <= 4 * cp:
        raise ValueError(f"ln_geglu_ff: inner={inner} must be a multiple of 8 up to 4c")
    row_tiles = -(-n // GEMM_BM)
    bn1 = min(GEGLU_BN, key=lambda bn: (-(-inner // (bn // 2)) * (bn // 2), -bn))
    tiles1 = row_tiles * -(-inner // (bn1 // 2))
    st1 = _stages(bn1, bn1 // 2)
    g2 = gemm_plan(n, cp, inner, sms)
    return dict(cp=cp, inner=inner, bn1=bn1, stages1=st1, grid1=min(tiles1, sms),
                smem1=_gemm_smem(bn1, st1, bn1 // 2),
                bn2=g2["bn"], stages2=g2["stages"], grid2=g2["grid"], smem2=g2["smem"],
                gate_row0=inner, tiles1=tiles1, tiles2=g2["tiles"])


def pad_operands(x2, s, b, w1, b1, w2, b2, cp: int) -> tuple:
    """The operands of a c-wide call zero-padded to width cp ≥ c: x2, the LN
    scale and bias and b2 to cp columns; W1's val and gate halves each to
    (4cp, cp) and b1's each to 4cp; W2 to (cp, 4cp). The padded act and y
    columns come out zero, and y's first c columns are the call's."""
    p = cp - x2.shape[-1]
    halves = w1.shape[0] // 2
    w1 = torch.cat([F.pad(h, (0, p, 0, 4 * p)) for h in w1.split(halves)])
    b1 = torch.cat([F.pad(h, (0, 4 * p)) for h in b1.split(halves)])
    return (F.pad(x2, (0, p)), F.pad(s, (0, p)), F.pad(b, (0, p)), w1, b1,
            F.pad(w2, (0, 4 * p, 0, p)), F.pad(b2, (0, p)))


def ln_geglu_reference(x2, s, b, w1, b1, w2, b2, eps: float, partial: bool = False):
    """Plain version on (n, c) rows, the arithmetic of the kernel: LN in fp32
    stored in x's dtype, both products with fp32 accumulation, the GEGLU
    product rounded to x's dtype before the down-projection; ``partial``:
    without b2 and x."""
    xf = x2.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()).to(x2.dtype)
    h = ln.float() @ w1.float().t() + b1.float()
    val, gate = h.chunk(2, dim=-1)
    act = (val * F.gelu(gate, approximate="tanh")).to(x2.dtype)
    y = act.float() @ w2.float().t()
    if not partial:
        y = y + b2.float() + xf
    return y.to(x2.dtype)


def ln_geglu_twin(x2, s, b, w1, b1, w2, b2, eps: float, partial: bool = False):
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
    y = F.linear(act, w2).float()
    if not partial:
        y = y + b2.float() + xf
    return y.to(dt)


def _launch(x2, s, b, w1, b1, w2, b2, eps: float, partial: bool = False) -> torch.Tensor:
    n, c = x2.shape
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("ln_geglu x", x2, bf, (n, c))
    inner = w1.shape[0] // 2
    if partial and (c % 8 or inner % 8):
        raise ValueError(f"ln_geglu_ff partial: c={c} and inner={inner} must be multiples of 8")
    plan = launch_plan(n, c, cuda_lib.sm_count(x2.device),
                       inner=None if inner == 4 * c else inner)
    cp, inner = plan["cp"], plan["inner"]
    if cp != c:
        x2, s, b, w1, b1, w2, b2 = pad_operands(x2, s, b, w1, b1, w2, b2, cp)
    cuda_lib.check_cuda("ln_geglu ln scale", s, f32, (cp,))
    cuda_lib.check_cuda("ln_geglu ln bias", b, f32, (cp,))
    cuda_lib.check_cuda("ln_geglu w1", w1, bf, (2 * inner, cp))
    cuda_lib.check_cuda("ln_geglu b1", b1, f32, (2 * inner,))
    cuda_lib.check_cuda("ln_geglu w2", w2, bf, (cp, inner))
    if not partial:
        cuda_lib.check_cuda("ln_geglu b2", b2, f32, (cp,))
    y = torch.empty_like(x2)
    ln = torch.empty_like(x2)                          # LN(x) in bf16
    act = torch.empty((n, inner), device=x2.device, dtype=bf)  # val ⊙ gelu(gate) in bf16
    cuda_lib.call("aat_ln_geglu", x2.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(),
                  b1.data_ptr(), w2.data_ptr(), None if partial else b2.data_ptr(), y.data_ptr(),
                  ln.data_ptr(), act.data_ptr(), n, cp, c, inner, int(partial), eps, plan["bn1"],
                  plan["stages1"], plan["grid1"],
                  plan["smem1"], plan["bn2"], plan["stages2"], plan["grid2"], plan["smem2"],
                  plan["gate_row0"])
    global launches, partial_launches
    launches += 1
    partial_launches += int(partial)
    return y if cp == c else y[:, :c].contiguous()


@traced("op.ln_geglu_ff")
def ln_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5,
                partial: bool = False) -> torch.Tensor:
    """``x + GEGLU_FF(LayerNorm(x))`` over the last axis of x (..., c): kernel
    2 for a CUDA tensor up to ``MAX_C``, past it ``ln_geglu_twin`` in x's
    dtype, JAX's lean composite at those widths; the plain version for a
    CPU tensor. ``partial``: a tensor-parallel rank's W2·act alone (no b2,
    no x; module docstring)."""
    shape = x.shape
    c = shape[-1]
    x2 = x.reshape(-1, c)
    dt = x.dtype
    args = (x2, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            w1.to(dt).contiguous(), b1.float().contiguous(), w2.to(dt).contiguous(),
            None if partial else b2.float().contiguous())
    if x.device.type == "cpu":
        run = ln_geglu_reference
    elif kernel_ok(c):
        run = _launch
    else:
        return ln_geglu_twin(*args, eps, partial).reshape(shape)
    return Recompute.apply(run, ln_geglu_twin, *args, eps, partial).reshape(shape)
