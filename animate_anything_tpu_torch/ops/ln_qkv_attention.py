"""LayerNorm → q/k/v projections → self-attention — the port of
``animate_anything_tpu/ops/attic/ln_qkv_attention.py``.

Its Pallas kernel ``_pallas_fwd`` computes the whole function in one
program. Here it is two hand-written kernels: kernel 11
(``csrc/ln_qkv.cu``) takes each row's LayerNorm statistics in fp32 and
projects the rows, normalised on their way into the tensor cores, to q, k
and v in one persistent TMA + wgmma GEMM that reads the weights where they
lie (``launch_plan``), q pre-scaled by log2 e/√d and rounded to bf16 as the
TPU kernel's ``_kernel`` :79-82 does; kernel 1 (``csrc/flash_attention.cu``,
told that q is pre-scaled) then runs the exp2-domain attention on them in
the ``(b, s, h·d)`` layout. The normalised rows never reach device memory.

``ln_qkv_attention(..., impl="pallas")`` keeps JAX's domain gate
(``ln_qkv_attention_ok``: head_dim 64, s ≥ 256) without its VMEM clause.
The plain version is JAX's composite twin ``_reference`` (LN in fp32 stored
in x's dtype, projections in x's dtype, softmax attention in fp32), which
every other case runs and whose gradient ``ops/autograd.Recompute`` takes,
as JAX's custom VJP does. No model path of the JAX package calls it.

Weights keep the JAX layout: ``wq``, ``wk``, ``wv`` are (c, heads·head_dim).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute
from animate_anything_tpu_torch.ops.flash_attention import (LOG2E, attention_reference,
                                                            flash_forward_with_lse)
from animate_anything_tpu_torch.ops.geglu import pick_width
from animate_anything_tpu_torch.utils.tracing import traced

HEAD_DIM = 64
MIN_SEQ = 256

launches = 0  # kernel-11 calls by ln_qkv_attention (each: the statistics pass and the GEMM)

# The GEMM's tiles (``csrc/ln_qkv.cu``): 128 rows (two warpgroups of 64) ×
# BN columns of one of q, k, v, BN dividing heads·head_dim; K steps of 64;
# per stage the x tile and BN/64 weight chunks of 64 x 64; four 64 x 64
# output chunks (two a warpgroup).
GEMM_BM, GEMM_BK = 128, 64
TILE_WIDTHS = (320, 256, 192, 128, 64)
SMEM_LIMIT = 232448
MAX_STAGES = 4
MAX_C = 4096  # the statistics pass holds a row in a warp's registers


def _smem(bn: int, stages: int, c: int) -> int:
    """Dynamic shared bytes of a GEMM block (``Layout::smem`` in the
    source): 1024 for the swizzle alignment; per stage the x tile (128 x 64)
    and the weight tile (64 x bn) in bf16 and two mbarriers; four 64 x 64
    bf16 output chunks; the LayerNorm scale and bias over c rounded up to 64
    in fp32."""
    kpad = -(-c // GEMM_BK) * GEMM_BK
    return (1024 + stages * (2 * GEMM_BK * (GEMM_BM + bn) + 16) + 4 * 64 * 64 * 2
            + 2 * kpad * 4)


def launch_plan(n: int, c: int, hd: int, sms: int = 132) -> dict:
    """Kernel 11's GEMM for n rows of width c onto three hd-wide outputs on
    a card of ``sms`` SMs, without the card: the tile width ``bn`` (a width
    of ``TILE_WIDTHS`` dividing hd, so no tile straddles q, k and v; the
    fewest waves of tile work by ``geglu.pick_width``), the ring depth (as
    many stages as fit, at most ``MAX_STAGES``), the persistent grid and the
    shared bytes."""
    if n < 1 or c < 8 or c % 8 or c > MAX_C or hd < 64 or hd % 64:
        raise ValueError(f"ln_qkv: c={c} must be a multiple of 8 up to {MAX_C}, "
                         f"heads·head_dim={hd} a multiple of 64")
    row_tiles = -(-n // GEMM_BM)
    bn = pick_width(row_tiles, 3 * hd, [w for w in TILE_WIDTHS if hd % w == 0], sms)
    stages = max(s for s in range(2, MAX_STAGES + 1) if _smem(bn, s, c) <= SMEM_LIMIT) \
        if _smem(bn, 2, c) <= SMEM_LIMIT else 0
    if not stages:
        raise ValueError(f"ln_qkv: c={c} leaves no room for two stages")
    tiles = row_tiles * 3 * hd // bn
    return dict(bn=bn, stages=stages, grid=min(tiles, sms), smem=_smem(bn, stages, c),
                tiles=tiles, row_tiles=row_tiles, per_w=hd // bn)


def ln_qkv_attention_ok(s: int, head_dim: int) -> bool:
    """JAX's ``ln_qkv_attention_ok`` without its VMEM budget."""
    return head_dim == HEAD_DIM and s >= MIN_SEQ


def ln_qkv_attention_reference(x, ln_scale, ln_bias, wq, wk, wv, heads: int, head_dim: int,
                               eps: float) -> torch.Tensor:
    """Plain version, JAX's ``_reference``: x (b, s, c) → (b, s, heads·d)."""
    b, s, c = x.shape
    dt = x.dtype
    ln = F.layer_norm(x.float(), (c,), ln_scale.float(), ln_bias.float(), eps).to(dt)
    q, k, v = ((ln @ w.to(dt)).reshape(b, s, heads, head_dim) for w in (wq, wk, wv))
    return attention_reference(q, k, v).reshape(b, s, heads * head_dim)


def _launch(x, ln_scale, ln_bias, wq, wk, wv, heads: int, head_dim: int, eps: float):
    b, s, c = x.shape
    hd = heads * head_dim
    bf = torch.bfloat16
    plan = launch_plan(b * s, c, hd, cuda_lib.sm_count(x.device))
    cuda_lib.check_cuda("ln_qkv x", x, bf, (b, s, c))
    cuda_lib.check_cuda("ln_qkv ln scale", ln_scale, torch.float32, (c,))
    cuda_lib.check_cuda("ln_qkv ln bias", ln_bias, torch.float32, (c,))
    wts = [w.to(bf) for w in (wq, wk, wv)]  # read in place: (c, hd), hd along the row
    for name, w in zip("qkv", wts):
        cuda_lib.check_cuda(f"ln_qkv w{name}", w, bf, (c, hd))
    q, k, v = (torch.empty((b, s, heads, head_dim), device=x.device, dtype=bf)
               for _ in range(3))
    stats = torch.empty((b * s, 2), device=x.device, dtype=torch.float32)
    cuda_lib.call("aat_ln_qkv", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                  wts[0].data_ptr(), wts[1].data_ptr(), wts[2].data_ptr(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), stats.data_ptr(), b * s, c, hd, eps,
                  LOG2E / math.sqrt(head_dim), plan["bn"], plan["stages"], plan["grid"],
                  plan["smem"])
    global launches
    launches += 1
    out, _ = flash_forward_with_lse(q, k, v, with_lse=False, prescaled=True)
    return out.reshape(b, s, hd)


@traced("op.ln_qkv_attention")
def ln_qkv_attention(x, ln_scale, ln_bias, wq, wk, wv, *, heads: int, head_dim: int,
                     eps: float = 1e-5, impl: str | None = None) -> torch.Tensor:
    """norm1 → to_q/k/v → self-attention of x (b, s, c); returns (b, s,
    heads·head_dim). Kernels 11 and 1 under ``impl="pallas"`` past the gate
    on CUDA tensors, else the plain version."""
    args = (x, ln_scale.float().contiguous(), ln_bias.float().contiguous(), wq, wk, wv,
            heads, head_dim, eps)
    if impl != "pallas" or not ln_qkv_attention_ok(x.shape[1], head_dim):
        return ln_qkv_attention_reference(*args)
    run = ln_qkv_attention_reference if x.device.type == "cpu" else _launch
    return Recompute.apply(run, ln_qkv_attention_reference, *args)
