"""Residual add with the per-(n, c) sums of its output — the port of
``animate_anything_tpu/ops/attic/add_stats.py``; kernel 10 in
``csrc/group_norm.cu`` replaces its ``_pallas_add``.

``add_with_stats(x, r, impl="pallas")`` returns ``(y, (Σy, Σy²))`` with
y = x + r added in fp32 and rounded to x's dtype, and the fp32 sums taken of
the stored y over the row axis. The kernel is kernel 6 with the add in
front (one launch; the last block of each slab adds the chunks' partials in
a fixed order), so the sums are the same from run to run. It runs at every shape (JAX's ``_pick_chunk``
VMEM gate is TPU arithmetic). Off ``"pallas"`` the function is a plain add
with no sums, as in JAX. No model path of the JAX package calls it.
"""

from __future__ import annotations

import torch

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute, flat_stats
from animate_anything_tpu_torch.ops.group_norm import sums_args
from animate_anything_tpu_torch.utils.tracing import traced

launches = 0  # kernel launches by add_with_stats


def add_stats_reference(x, r):
    """Plain version, JAX's ``_reference``: ``(y, (Σy, Σy²))`` for x, r
    (n, s, c)."""
    y = (x.float() + r.float()).to(x.dtype)
    yf = y.float()
    return y, (yf.sum(1), yf.square().sum(1))


def _launch(x, r):
    n, s, c = x.shape
    if c % 8:
        raise ValueError(f"add_with_stats: c={c} must be a multiple of 8")
    cuda_lib.check_cuda("add_with_stats x", x, torch.bfloat16, (n, s, c))
    cuda_lib.check_cuda("add_with_stats r", r, torch.bfloat16, (n, s, c))
    plan, tk = sums_args(x)
    y = torch.empty_like(x)
    work = torch.empty(2 * n * plan["chunks"] * c, device=x.device, dtype=torch.float32)
    s1 = torch.empty((n, c), device=x.device, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    cuda_lib.call("aat_add_stats", x.data_ptr(), r.data_ptr(), y.data_ptr(), work.data_ptr(),
                  tk.data_ptr(), s1.data_ptr(), s2.data_ptr(), n, s, c, plan["ct"],
                  plan["threads"], plan["chunks"], plan["rows"])
    global launches
    launches += 1
    return y, (s1, s2)


@traced("op.add_with_stats")
def add_with_stats(x: torch.Tensor, r: torch.Tensor, impl: str | None = None):
    """``y = x + r`` over (n, s, c), with the per-(n, c) fp32 (Σy, Σy²) under
    ``impl="pallas"`` (kernel 10 for CUDA tensors, the plain version for CPU
    tensors); otherwise ``(x + r, None)``."""
    if impl != "pallas":
        return x + r.to(x.dtype), None
    r = r.to(x.dtype)
    run = add_stats_reference if x.device.type == "cpu" else _launch
    y, s1, s2 = Recompute.apply(flat_stats(run), flat_stats(add_stats_reference), x, r)
    return y, (s1, s2)
