"""Kernel 5: the fused temporal-attention block (``csrc/temporal_block.cu``).

Replaces both JAX entry points of ``animate_anything_tpu/ops/temporal_block.py``:
``fused_temporal_block_bfsc`` (``_build_bfsc``, the natural (b, f, s, c)
layout) and ``fused_temporal_attn_block`` (``_build`` on the packed token
layout, with the head-group split of ``_build_vjp`` at c = 1280). On real
rows both compute the same function; packing rows into 128-row tiles and
splitting heads to fit VMEM are facts of the TPU, so the port has one entry
point on the natural layout. The design note (locations per block, the
ragged edge) is in the source's header. A call is three launches: kernel
2's LayerNorm pass, the q/k/v + frame-attention kernel, and kernel 2's
residual GEMM as the out-projection; ``launch_plan`` picks their tiles on
any machine.

Weights arrive in the torch Linear layout (out, in): ``to_q``, ``to_k``,
``to_v`` (no bias) and ``to_out.0`` of a ``TemporalSelfAttention``.

``fused_ok`` is the JAX gate (:579) between this block and the composite
temporal path. It decides the GELU form of the block's feed-forward (tanh on
the fused path, exact erf on the composite one), so the port keeps it as it
is for every shape, not only for the shapes the kernel takes.

Gradients: ``ops/autograd.Recompute`` differentiates ``temporal_block_twin``
(JAX's ``_reference_bfsc``, the custom_vjp's remat target); one Function
covers the three launches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib, geglu
from animate_anything_tpu_torch.ops.autograd import Recompute

MAX_FRAMES = 128    # a row tile holds one location's frames at least
MAX_HEAD_DIM = 256  # four 64-column chunks of q, k, v in shared memory
MAX_C = 2048        # the LayerNorm pass holds a row in a warp's registers
TILE_ROWS = 128     # rows of a row tile: ⌊128/f⌋ locations x f frames
SMEM_LIMIT = geglu.SMEM_LIMIT
MAX_STAGES = 4
_STAGE = 128 * 128 + 3 * 64 * 128  # the LN tile's and three weight boxes' 64-column step
_TILE = 128 * 128                  # q, k or one v chunk: 128 rows x 64 columns

launches = 0  # temporal_block calls on the card (each: LN pass, attention, out-projection)


def _n_head_groups(c: int, heads: int) -> int:
    """The JAX head-group count (``ops/temporal_block.py:497``), needed only
    by the gate: c ≤ 1024 → 1; c = 1280 (20 heads) → 2."""
    ngroups = 1
    while 4 * c * (c // ngroups) * 2 > 8 * 2**20:
        ngroups += 1
    while heads % ngroups:
        ngroups += 1
    return ngroups


def fused_ok(f: int, c: int, heads: int, head_dim: int) -> bool:
    """The JAX geometry gate of the fused temporal path (``:579``)."""
    if not (2 <= f <= 128 and heads * head_dim == c and head_dim % 8 == 0):
        return False
    if c <= 1024:
        return True
    return c <= 2048 and heads % _n_head_groups(c, heads) == 0


def kernel_ok(f: int, c: int, heads: int) -> bool:
    """The kernel's reach, checked before every launch: 1 ≤ f ≤ 128, heads
    dividing c, a head dim d % 8 == 0 up to 256, c ≤ 2048. It covers every
    shape ``fused_ok`` admits with d ≤ 256."""
    if heads < 1 or c % heads:
        return False
    d = c // heads
    return 1 <= f <= MAX_FRAMES and d % 8 == 0 and 0 < d <= MAX_HEAD_DIM and c <= MAX_C


def _check_reach(f: int, c: int, heads: int) -> None:
    if not kernel_ok(f, c, heads):
        raise ValueError(f"temporal_block: needs 1 ≤ f ≤ {MAX_FRAMES}, heads dividing c ≤ "
                         f"{MAX_C} and a head dim d % 8 == 0 ≤ {MAX_HEAD_DIM}; got f={f} c={c} "
                         f"heads={heads}")


def launch_plan(b: int, f: int, s: int, c: int, heads: int, sms: int = 132) -> dict:
    """The three launches' tiles on a card of ``sms`` SMs, without the card:
    ``L`` locations a row tile (L·f ≤ 128 rows, frame-major), the head's
    64-column ``chunks``, the attention kernel's ring depth, persistent grid
    over (row tile, head) items and shared-memory bytes (1024 alignment;
    per stage the 128 x 64 LN tile and three 64 x 64 weight boxes, two
    mbarriers; q, k and every v chunk, 128 x 64 bf16 each), and the
    out-projection's (kernel 2's residual GEMM, ``geglu.gemm_plan``)."""
    _check_reach(f, c, heads)
    if min(b, s) < 1:
        raise ValueError(f"temporal_block: empty input b={b} s={s}")
    d = c // heads
    L = min(TILE_ROWS // f, s)
    chunks = -(-d // 64)
    fixed = 1024 + (2 + chunks) * _TILE
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (_STAGE + 16))
    loc_tiles = -(-s // L)
    items = b * loc_tiles * heads
    out = geglu.gemm_plan(b * f * s, c, c, sms)
    return dict(L=L, chunks=chunks, stages=stages, grid=min(items, sms),
                smem=fixed + stages * (_STAGE + 16), items=items, loc_tiles=loc_tiles,
                bn_out=out["bn"], stages_out=out["stages"], grid_out=out["grid"],
                smem_out=out["smem"])


def ln_stage(x, ln_scale, ln_bias, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the first launch: LN over the last axis in fp32,
    stored in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(x.dtype)


def attention_stage(ln, wq, wk, wv, *, heads: int) -> torch.Tensor:
    """Plain version of the second launch on LN(x) (b, f, s, c): each
    projection with fp32 accumulation rounded to ln's dtype, fp32 scores ×
    1/√d and softmax over the f frames of each (b, s, head), probabilities in
    v's dtype, the attention output o rounded to ln's dtype."""
    b, f, s, c = ln.shape
    d = c // heads
    dt = ln.dtype

    def proj(w):
        return (ln.float() @ w.float().t()).to(dt).reshape(b, f, s, heads, d)

    q, k, v = proj(wq), proj(wk), proj(wv)
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * (1.0 / math.sqrt(d))
    probs = scores.softmax(dim=-1).to(v.dtype)
    o = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float()).to(dt)
    return o.reshape(b, f, s, c)


def out_stage(o, wo, bo, x) -> torch.Tensor:
    """Plain version of the third launch: o·Woᵀ in fp32 plus bo and x,
    stored in x's dtype."""
    return (o.float() @ wo.float().t() + bo.float() + x.float()).to(x.dtype)


def temporal_block_reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """Plain version on (b, f, s, c), the arithmetic of JAX's
    ``_reference_bfsc`` and the kernel's three launches in turn: LN in fp32
    stored in x's dtype; each projection with fp32 accumulation rounded to
    x's dtype; fp32 scores × 1/√d and softmax over the f frames;
    probabilities in v's dtype; the attention output rounded to x's dtype;
    out-projection in fp32 plus bo and x."""
    o = attention_stage(ln_stage(x, ln_scale, ln_bias, eps), wq, wk, wv, heads=heads)
    return out_stage(o, wo, bo, x)


def temporal_block_twin(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int,
                        eps: float) -> torch.Tensor:
    """Differentiable twin of JAX's ``_reference_bfsc`` in x's dtype: the
    four projections on x-dtype operands with fp32 accumulation, the
    17-frame attention in fp32 as in ``temporal_block_reference`` (which it
    is, in fp32)."""
    b, f, s, c = x.shape
    d = c // heads
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)
    q, k, v = (F.linear(ln, w).reshape(b, f, s, heads, d) for w in (wq, wk, wv))
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * (1.0 / math.sqrt(d))
    probs = scores.softmax(dim=-1).to(dt)
    o = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float()).to(dt)
    out = F.linear(o.reshape(b, f, s, c), wo).float() + bo.float() + xf
    return out.to(dt)


def _launch(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int, eps: float) -> torch.Tensor:
    b, f, s, c = x.shape
    _check_reach(f, c, heads)  # before the device checks: the reach is the shape's
    bf, f32 = torch.bfloat16, torch.float32
    cuda_lib.check_cuda("temporal_block x", x, bf, (b, f, s, c))
    for name, t in (("ln scale", ln_scale), ("ln bias", ln_bias), ("bo", bo)):
        cuda_lib.check_cuda(f"temporal_block {name}", t, f32, (c,))
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        cuda_lib.check_cuda(f"temporal_block {name}", w, bf, (c, c))
    plan = launch_plan(b, f, s, c, heads,
                       torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty_like(x)
    ln = torch.empty_like(x)  # LN(x) in bf16
    o = torch.empty_like(x)   # the attention output in bf16, before the out-projection
    cuda_lib.call("aat_temporal_block", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                  wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                  ln.data_ptr(), o.data_ptr(), y.data_ptr(), b, f, s, c, heads, eps, plan["L"],
                  plan["stages"], plan["grid"], plan["smem"], plan["bn_out"],
                  plan["stages_out"], plan["grid_out"], plan["smem_out"])
    global launches
    launches += 1
    return y


def temporal_block(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads: int,
                   eps: float = 1e-5) -> torch.Tensor:
    """``x + bo + Wo·attn(LN(x))`` on x (b, f, s, c), attention over the f
    frames of each (b, s, head)."""
    dt = x.dtype
    args = (x, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            wq.to(dt).contiguous(), wk.to(dt).contiguous(), wv.to(dt).contiguous(),
            wo.to(dt).contiguous(), bo.float().contiguous())
    run = _reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, temporal_block_twin, *args, heads, eps)


def _reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int, eps: float):
    return temporal_block_reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads=heads,
                                    eps=eps)
