"""Attention over the frame axis — the port of
``animate_anything_tpu/ops/temporal_attention.py``, with kernel 9
(``csrc/temporal_attention.cu``) in place of its packed Pallas kernel
(``_packed_forward``).

q/k/v are (b, f, s, h, d); each (b, s, h) location attends over its f
frames: fp32 scores and softmax, probabilities rounded to v's dtype before
the second product, output in q's dtype.

``temporal_attention(..., impl)`` keeps JAX's gate: only ``impl="packed"``
with 2 ≤ f ≤ 128, d % 8 == 0 and at least 512 locations·heads reaches the
kernel, and only on the device the kernel was written for (the TPU there, a
CUDA tensor here). One clause is the port's own: d ≤ 256, the kernel's
largest head; above it JAX runs its packed kernel and the port the einsum
form, the same function. Every other case runs the einsum form
``temporal_attention_reference``, which is also the kernel's plain version
and, through ``ops/autograd.Recompute``, its backward, as JAX's custom VJP
takes the vjp of ``_einsum_reference``.
"""

from __future__ import annotations

import functools
import math

import torch

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute
from animate_anything_tpu_torch.utils.tracing import traced

MAX_FRAMES = 128   # JAX's _LANE: the most frames one packed tile holds
MIN_LOCS = 512     # below this many b·s·h locations JAX keeps the einsum form
MAX_HEAD_DIM = 256  # the kernel's; JAX's gate admits any d % 8 == 0

# Kernel 9's launch plan (``csrc/temporal_attention.cu``): a persistent grid
# of one block a SM, MAX_WARPS consumer warps and a producer warp, a ring of
# up to MAX_STAGES tiles of (L locations x HB heads) in shared memory.
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on the H100
MAX_WARPS = 8
MAX_STAGES = 4
STAGING = 32 * 128    # a consumer warp's output staging: 32 rows x 64 bf16


launches = 0  # kernel launches by packed_temporal_attention


def temporal_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version: JAX's ``_einsum_reference``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bfshd,bgshd->bshfg", q.float(), k.float()) * scale
    probs = scores.softmax(dim=-1).to(v.dtype)
    out = torch.einsum("bshfg,bgshd->bfshd", probs.float(), v.float())
    return out.to(q.dtype)


def packed_ok(shape, impl: str, on_cuda: bool) -> bool:
    """JAX's gate (``temporal_attention`` :160-170), with "the tensor is on
    CUDA" for its platform check, and d ≤ ``MAX_HEAD_DIM``."""
    b, f, s, h, d = shape
    return (impl == "packed" and 2 <= f <= MAX_FRAMES and d % 8 == 0 and d <= MAX_HEAD_DIM
            and b * s * h >= MIN_LOCS and on_cuda)


def smem_bytes(f: int, d: int, L: int, HB: int, stages: int, warps: int) -> int:
    """Dynamic shared bytes of a block (``smem_bytes`` in the source): 1024
    for the swizzle alignment; per stage q, k and v as HB·⌈d/64⌉ chunks of
    L·f rows of 128 bytes (rounded up to 8 rows, a swizzle atom) and two
    mbarriers; the consumer warps' staging."""
    stage = 3 * HB * -(-d // 64) * -(-L * f // 8) * 1024
    return 1024 + stages * (stage + 16) + warps * STAGING


def items_per_unit(f: int) -> int:
    """A (location, head)'s items: both 16-row query tiles at f ≤ 32, else
    one item a query tile."""
    return 1 if f <= 32 else -(-f // 16)


def _divisors(h: int) -> list[int]:
    return [x for x in range(1, h + 1) if h % x == 0]


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, f: int, s: int, h: int, d: int, sms: int = 132) -> dict:
    """Kernel 9's plan for (b, f, s, h, d) on a card of ``sms`` SMs, without
    the card. A tile is L locations x HB heads of one batch element (HB
    divides h); its items are its (location, head)s at f ≤ 32, else its
    (location, head, 16 query rows). The tile is one with the fewest items
    that still give each of the MAX_WARPS consumer warps one and whose ring
    holds two stages, and of those the fewest bytes a stage (at f = 17,
    d = 64: 8 locations of one head); the ring takes as many tiles as fit,
    up to MAX_STAGES. Where no such tile exists, the one with the most
    items and two stages; where no tile has two (f > 88 with d > 128,
    f > 64 with d > 192), one (location, head) in one stage."""
    if not (2 <= f <= MAX_FRAMES and d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM
            and min(b, s, h) >= 1):
        raise ValueError(f"temporal_attention: f={f} must be in [2, {MAX_FRAMES}] and "
                         f"d={d} a multiple of 8 in [8, {MAX_HEAD_DIM}]")
    per_unit = items_per_unit(f)

    def plan(L: int, HB: int) -> dict:
        items = L * HB * per_unit
        warps = min(MAX_WARPS, items)
        fixed, stage = smem_bytes(f, d, L, HB, 0, warps), smem_bytes(f, d, L, HB, 1, 0) - 1024
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
        tiles = b * -(-s // L) * (h // HB)
        return dict(L=L, HB=HB, stages=stages, warps=warps, items=items, tiles=tiles,
                    grid=min(tiles, sms), stage=stage,
                    smem=smem_bytes(f, d, L, HB, max(stages, 1), warps))

    cands = [plan(L, hb) for hb in _divisors(h) for L in range(1, min(s, MAX_WARPS) + 1)]
    two = [c for c in cands if c["stages"] >= 2]
    full = [c for c in two if c["items"] >= MAX_WARPS]
    if full:
        return min(full, key=lambda c: (c["items"], c["stage"]))
    if two:
        return max(two, key=lambda c: c["items"])
    one = plan(1, 1)
    if one["stages"] < 1:
        raise ValueError(f"temporal_attention: f={f}, d={d} do not fit one stage")
    return one


def _launch(q, k, v) -> torch.Tensor:
    b, f, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda(f"temporal_attention {name}", t, torch.bfloat16, (b, f, s, h, d))
    plan = launch_plan(b, f, s, h, d, cuda_lib.sm_count(q.device))
    o = torch.empty_like(q)
    cuda_lib.call("aat_temporal_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, f, s, h, d, plan["L"], plan["HB"], plan["stages"],
                  plan["warps"], plan["grid"], plan["smem"])
    global launches
    launches += 1
    return o


@traced("op.packed_temporal_attention")
def packed_temporal_attention(q, k, v) -> torch.Tensor:
    """Kernel 9 for CUDA tensors, its plain version for CPU tensors; the
    gradient is that of ``temporal_attention_reference``."""
    run = temporal_attention_reference if q.device.type == "cpu" else _launch
    return Recompute.apply(run, temporal_attention_reference, q, k, v)


def temporal_attention(q, k, v, impl: str = "xla") -> torch.Tensor:
    """Attention over axis 1 (frames) of (b, f, s, h, d) tensors."""
    if packed_ok(q.shape, impl, q.device.type == "cuda"):
        return packed_temporal_attention(q, k, v)
    return temporal_attention_reference(q, k, v)
