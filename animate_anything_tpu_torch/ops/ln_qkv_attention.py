"""LayerNorm → q/k/v projections → self-attention — the port of
``animate_anything_tpu/ops/attic/ln_qkv_attention.py``.

Its Pallas kernel ``_pallas_fwd`` computes the whole function in one
program. Here it is two hand-written kernels: kernel 11
(``csrc/ln_qkv.cu``) normalises the rows in fp32 and projects them to q, k
and v on the tensor cores, q pre-scaled by log2 e/√d and rounded to bf16 as
the TPU kernel's ``_kernel`` :79-82 does; kernel 1 (``csrc/flash_attention.cu``,
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

HEAD_DIM = 64
MIN_SEQ = 256

launches = 0  # kernel-11 launches by ln_qkv_attention


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
    if c % 8 or hd % 64:
        raise ValueError(f"ln_qkv_attention: c={c} must be a multiple of 8, "
                         f"heads·head_dim={hd} of 64")
    bf = torch.bfloat16
    cuda_lib.check_cuda("ln_qkv x", x, bf, (b, s, c))
    cuda_lib.check_cuda("ln_qkv ln scale", ln_scale, torch.float32, (c,))
    cuda_lib.check_cuda("ln_qkv ln bias", ln_bias, torch.float32, (c,))
    # the kernel streams each weight as (hd, c) rows: one output channel a row
    wts = [w.to(bf).t().contiguous() for w in (wq, wk, wv)]
    for name, w in zip("qkv", wts):
        cuda_lib.check_cuda(f"ln_qkv w{name}", w, bf, (hd, c))
    q, k, v = (torch.empty((b, s, heads, head_dim), device=x.device, dtype=bf)
               for _ in range(3))
    cuda_lib.call("aat_ln_qkv", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                  wts[0].data_ptr(), wts[1].data_ptr(), wts[2].data_ptr(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), b * s, c, hd, eps, LOG2E / math.sqrt(head_dim))
    global launches
    launches += 1
    out, _ = flash_forward_with_lse(q, k, v, with_lse=False, prescaled=True)
    return out.reshape(b, s, hd)


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
