"""GroupNorm as a per-(batch, channel) affine, with optional precomputed
sums — the port of ``animate_anything_tpu/ops/group_norm.py``.

Statistics are per-channel fp32 Σx, Σx² over the row axis, combined into
per-group moments on the small (n, c) result. A producer kernel that already
emitted the sums of its output (kernels 3 and 4) hands them in as ``sums``
and the norm then costs only the ``a·x + b`` apply.

Two switches keep the JAX package's names, values and defaults ("xla",
off); "pallas" names the hand-written CUDA kernel here:

- ``set_default_stats_impl``: statistics without producer sums go through
  kernel 6 (``stream_channel_sums``, ``csrc/group_norm.cu``, replacing
  ``_pallas_channel_sums``); a call can ask for it with ``stats="pallas"``.
- ``set_default_norm_impl``: every GroupNorm that JAX's gate admits runs the
  one-pass kernel 7 (``ops/streaming_group_norm.py``), whose affine is
  applied in fp32 with one rounding; the others keep the composite form,
  whose (a, b) are rounded to x's dtype before the apply.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.autograd import Recompute

_DEFAULT_IMPL = "xla"
_DEFAULT_STATS = "xla"

launches = 0  # kernel launches by stream_channel_sums


def set_default_norm_impl(impl: str) -> None:
    """"pallas": GroupNorms that pass JAX's gate run kernel 7 (for CUDA
    tensors; its plain version for CPU tensors); "xla": the composite form."""
    global _DEFAULT_IMPL
    if impl not in ("xla", "pallas"):
        raise ValueError(impl)
    _DEFAULT_IMPL = impl


def set_default_stats_impl(impl: str) -> None:
    """"auto" and "pallas": GroupNorm statistics without producer sums go
    through kernel 6 for CUDA tensors and its plain version for CPU tensors
    (JAX's "auto" takes the composite reduction off the TPU: the same
    numbers up to summation order); "xla": the composite reduction."""
    global _DEFAULT_STATS
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(impl)
    _DEFAULT_STATS = impl


def _largest_aligned_divisor(s: int, limit: int) -> int:
    best, d = 0, 1
    while d * d <= s:
        if s % d == 0:
            for cand in (d, s // d):
                if cand % 8 == 0 and best < cand <= limit:
                    best = cand
        d += 1
    return best


def _pick_chunk(s: int, c: int) -> int:
    """JAX's row chunk of the one-pass kernel: the largest divisor of s
    (a multiple of 8) whose fp32 chunk fits ~2 MB; 0 if none. Part of the
    gate only: the CUDA kernel does not chunk by it."""
    return _largest_aligned_divisor(s, max(8, (2**21) // (4 * c)))


def _stats_chunk(s: int, c: int, itemsize: int) -> int:
    """JAX's row chunk of the channel-sums kernel (≤ ~1 MB); 0 if none."""
    return _largest_aligned_divisor(s, max(8, (2**20) // (itemsize * c)))


def stats_ok(x2) -> bool:
    """Channel-sums kernel eligibility, JAX's gate: the stats switch is on
    and the row count splits into aligned chunks."""
    if _DEFAULT_STATS == "xla":
        return False
    _, s, c = x2.shape
    return _stats_chunk(s, c, x2.element_size()) >= 8


def channel_sums(x2: torch.Tensor):
    """Per-(n, c) fp32 (Σx, Σx²) of x2 (n, s, c): the composite reduction,
    and kernel 6's plain version."""
    xf = x2.float()
    return xf.sum(1), xf.square().sum(1)


# Kernel 6's plan (``csrc/group_norm.cu::channel_sums_kernel``): a block is
# one chunk of rows of one slab of CT column threads, each one 16-byte
# vector of 8 channels (CT divides c/8, MIN_COLS ≤ CT ≤ MAX_COLS where c
# allows), times RT row lanes, at most SUMS_THREADS threads; BLOCKS_PER_SM
# of them fit a SM at once (the kernel's launch bounds).
SUMS_THREADS, MAX_COLS, MIN_COLS, BLOCKS_PER_SM = 320, 256, 8, 2


@functools.lru_cache(maxsize=None)
def sums_plan(n: int, s: int, c: int, sms: int = 132) -> dict:
    """Kernel 6's launch for (n, s, c) on a card of ``sms`` SMs, without the
    card: ``slabs`` of ``ct`` column threads cover the c/8 vectors of a row
    with no idle lane, ``rt`` row lanes a block, and ``chunks`` of ``rows``
    rows (a multiple of rt) cover the s rows; the grid is (slabs, chunks,
    n). The block with a (sample, slab)'s last ticket adds its chunks, so the
    chunks stay at most √s / 2 (that finish reads at most the bytes one block
    sums: 4·chunks² ≤ s). The slab width gives the most blocks that still
    run in one wave of BLOCKS_PER_SM a SM (a second, part-full wave would
    leave most of the card idle), the widest of equals."""
    if c % 8 or c < 8 or n < 1 or s < 1:
        raise ValueError(f"channel_sums: c={c} must be a positive multiple of 8")
    vecs = c // 8
    slots = BLOCKS_PER_SM * sms
    max_chunks = max(1, math.isqrt(s) // 2)
    divs = [w for w in range(min(vecs, MAX_COLS), 0, -1) if vecs % w == 0]
    best = None
    for ct in [w for w in divs if w >= MIN_COLS] or divs[:1]:
        slabs, rt = vecs // ct, max(1, SUMS_THREADS // ct)
        chunks = max(1, min(max_chunks, slots // (n * slabs), -(-s // rt)))
        per_chunk = -(-s // chunks)
        rows = -(-per_chunk // rt) * rt
        chunks = -(-s // rows)
        blocks = n * slabs * chunks
        if best is None or best["blocks"] < blocks <= slots:
            best = dict(ct=ct, rt=rt, threads=ct * rt, slabs=slabs, chunks=chunks, rows=rows,
                        blocks=blocks)
    return best


_TICKETS: dict = {}


def tickets(device: torch.device, count: int) -> torch.Tensor:
    """The per-(sample, slab) ticket counters of kernels 6 and 10, kernels 3
    and 4's sums tickets, and kernel 7's grid-barrier counts, on ``device``
    for the current stream: zeroed once here, and left zeroed by each launch
    (the last block of a slab resets its counter; kernel 7's last block, its
    counts). A launch finds them zero only if the launch before it on them
    has ended, so each stream has its own: launches on one stream run in
    turn. A device without streams (the meta device of the launch-count
    tests) keys them by the device alone."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), device=device, dtype=torch.int32)
        _TICKETS[key] = buf
    return buf


def sums_args(x2: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """The plan for x2 (n, s, c) on its device and the tickets of that
    device's current stream."""
    n, s, c = x2.shape
    plan = sums_plan(n, s, c, cuda_lib.sm_count(x2.device))
    return plan, tickets(x2.device, n * plan["slabs"])


def _launch_channel_sums(x2):
    n, s, c = x2.shape
    if c % 8:
        raise ValueError(f"channel_sums: c={c} must be a multiple of 8")
    cuda_lib.check_cuda("channel_sums x", x2, torch.bfloat16, (n, s, c))
    plan, tk = sums_args(x2)
    work = torch.empty(2 * n * plan["chunks"] * c, device=x2.device, dtype=torch.float32)
    s1 = torch.empty((n, c), device=x2.device, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    cuda_lib.call("aat_channel_sums", x2.data_ptr(), work.data_ptr(), tk.data_ptr(),
                  s1.data_ptr(), s2.data_ptr(), n, s, c, plan["ct"], plan["threads"],
                  plan["chunks"], plan["rows"])
    global launches
    launches += 1
    return s1, s2


def stream_channel_sums(x2: torch.Tensor):
    """Per-(n, c) fp32 (Σx, Σx²) of x2 (n, s, c): kernel 6 for a CUDA
    tensor, ``channel_sums`` for a CPU tensor. The gradient is JAX's custom
    VJP, dx = g1 + 2·x·g2, through ``channel_sums``."""
    run = channel_sums if x2.device.type == "cpu" else _launch_channel_sums
    s1, s2 = Recompute.apply(run, channel_sums, x2)
    return s1, s2


def group_affine(x2, scale, bias, groups: int, eps: float, stats=None, sums=None):
    """fp32 (a, b), each (n, c), such that ``a·x + b`` is GroupNorm(+scale,
    bias) of x2 (n, s, c), statistics pooled over s and each group's
    channels. ``sums``: the producer's per-(n, c) (Σx, Σx²); else kernel 6
    when ``stats="pallas"`` or the stats switch admits x2, else the
    composite reduction."""
    n, s, c = x2.shape
    force = stats == "pallas" and _stats_chunk(s, c, x2.element_size()) >= 8
    if sums is not None:
        s1, s2 = sums[0].float(), sums[1].float()
    elif force or stats_ok(x2):
        s1, s2 = stream_channel_sums(x2)
    else:
        s1, s2 = channel_sums(x2)
    g1 = s1.reshape(n, groups, c // groups).sum(-1)
    g2 = s2.reshape(n, groups, c // groups).sum(-1)
    cnt = float(s * (c // groups))
    mean = g1 / cnt
    var = g2 / cnt - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)
    mean_c = mean.repeat_interleave(c // groups, dim=1)
    a = inv_c * scale.float()[None, :]
    b = bias.float()[None, :] - mean_c * a
    return a, b


def streaming_ok(x2, groups: int, impl: str, sums) -> bool:
    """JAX's gate of the one-pass kernel (``group_norm_silu`` :297-307):
    the norm switch, no producer sums, c a multiple of 128 (and of groups)
    and an aligned row chunk. It decides where the affine is applied in
    fp32, so the port keeps it as is."""
    _, s, c = x2.shape
    return (impl == "pallas" and sums is None and c % groups == 0 and c % 128 == 0
            and _pick_chunk(s, c) >= 8)


def group_norm_silu(x, scale, bias, groups: int, eps: float = 1e-5, silu: bool = True,
                    impl: str | None = None, stats: str | None = None,
                    sums=None) -> torch.Tensor:
    """GroupNorm over the last axis of x (n, ..., c), statistics pooled over
    every non-batch axis (torch GroupNorm semantics), optionally with SiLU.
    Past ``streaming_ok``, kernel 7; else the composite form, whose affine
    is applied in x's dtype."""
    impl = impl or _DEFAULT_IMPL
    shape = x.shape
    x2 = x.reshape(shape[0], -1, shape[-1])
    if streaming_ok(x2, groups, impl, sums):
        from animate_anything_tpu_torch.ops.streaming_group_norm import group_norm_stream

        return group_norm_stream(x2, scale, bias, groups, eps, silu).reshape(shape)
    a, b = group_affine(x2, scale, bias, groups, eps, stats=stats, sums=sums)
    y = x2 * a[:, None, :].to(x2.dtype) + b[:, None, :].to(x2.dtype)
    if silu:
        # the JAX package's tanh identity y·(1 + tanh(y/2))/2 has the same
        # value; torch's CPU tanh runs through MKL VML, whose threaded calls
        # were seen to return whole chunks off by ~1e-4, so SiLU goes direct
        y = F.silu(y)
    return y.reshape(shape)
