"""Kernel 7: one-pass GroupNorm (+SiLU) of an (n, s, c) tensor with the
affine applied in fp32 (``csrc/group_norm.cu::gn_stream_kernel``).

Replaces ``animate_anything_tpu/ops/attic/streaming_group_norm.py::
_pallas_group_norm``, which ``group_norm_silu`` reaches under
``set_default_norm_impl("pallas")`` past JAX's gate
(``ops/group_norm.streaming_ok``). Statistics are per (sample, group) in
fp32 over (s, c/groups); the output is y = x·a + b in fp32, then y·sigmoid(y)
in fp32 when ``silu``, then one rounding to x's dtype. The TPU kernel runs
one program per sample and reads x twice; the CUDA one is one cooperative
launch of persistent blocks, each taking a range of rows into shared memory
by bulk copies: where the range fits, it stays there while the sums are
folded between two grid barriers and the affine is applied from there, so x
is read once; where it does not, the first rows stay and the others stream
through a ring of copies twice (``launch_plan``). The design note is in the
source.

No gradient: JAX's kernel has no VJP, so neither the JAX package nor the
port can train through it. The wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.ops import cuda_lib
from animate_anything_tpu_torch.ops.group_norm import channel_sums, group_affine, tickets
from animate_anything_tpu_torch.utils.tracing import traced

launches = 0  # kernel-7 launches (one a call)

# The kernel's block (``GN_THREADS``: c/8 column threads x 256/(c/8) row
# lanes), ``GN_BLOCKS_PER_SM`` blocks a SM, all resident; its shared memory
# in pieces of ``GN_COPY`` bytes, one bulk copy each, at most
# ``GN_MAX_COPIES``, ``RING`` of them streaming where a range does not fit.
THREADS, BLOCKS_PER_SM, COPY_BYTES, MAX_PIECES, RING = 256, 2, 16384, 8, 3
# Calls of at most this many bytes of x take one block a SM: there the two
# grid barriers and the folds over the blocks' partials, which grow with the
# blocks, cost more than the wider spread saves.
SMALL_BYTES = 8 << 20
MAX_C = 8 * THREADS
# Dynamic shared bytes a block may use with two a SM: half of the SM's
# 233472 less the 1 KB the card reserves for each block, less the static ones.
SMEM_LIMIT = 233472 // BLOCKS_PER_SM - 1024 - 256


def _fixed_smem(c: int) -> int:
    """Shared bytes besides the pieces: the row lanes' reduction buffer (2 x
    THREADS x 8 fp32: Σx and Σx²), a block's channel sums of a sample and
    the GroupNorm scale and bias (2c fp32 each)."""
    return (2 * THREADS * 8 + 4 * c) * 4


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, s: int, c: int, groups: int, sms: int = 132) -> dict:
    """Kernel 7's launch for (n, s, c) on a card of ``sms`` SMs, without the
    card: ``grid`` blocks (two a SM, one for calls of at most
    ``SMALL_BYTES``; all resident), each taking a range of ``rows_block``
    consecutive rows of the n·s into ``pieces`` pieces of ``piece_rows``
    rows. Where the range fits them (``read_once``) it is read once; else
    the first pieces hold ``held_fraction`` of it and the last ``ring``
    stream the rest, read twice."""
    if (c % 8 or not 8 <= c <= MAX_C or n < 1 or s < 1 or groups < 1 or c % groups
            or 2 * groups > 4 * THREADS or n * s >= 2**31):
        raise ValueError(f"group_norm_stream: c={c} must be a multiple of 8 and of "
                         f"groups={groups}, at most {MAX_C}")
    grid = (1 if n * s * c * 2 <= SMALL_BYTES else BLOCKS_PER_SM) * sms
    row = 2 * c
    piece_rows = COPY_BYTES // row
    pieces = min(MAX_PIECES, (SMEM_LIMIT - _fixed_smem(c)) // (piece_rows * row))
    rows_block = -(-n * s // grid)
    fit = pieces * piece_rows
    read_once = rows_block <= fit
    held = rows_block if read_once else (pieces - RING) * piece_rows
    # each block's rows past its held pieces, read twice (a short last range
    # may fit where the others do not)
    lengths = (min(n * s, (b + 1) * rows_block) - min(n * s, b * rows_block) for b in range(grid))
    twice = sum(0 if k <= fit else k - held for k in lengths)
    return dict(grid=grid, threads=THREADS, ct=c // 8, rt=THREADS // (c // 8), pieces=pieces,
                ring=RING, piece_rows=piece_rows, rows_block=rows_block,
                smem=pieces * piece_rows * row + _fixed_smem(c), read_once=read_once,
                held_fraction=held / rows_block, rows_read_twice=twice)


def group_norm_stream_reference(x2, scale, bias, groups: int, eps: float, silu: bool):
    """Plain version: the fp32 (a, b) of ``group_affine`` on the plain
    channel sums, the affine and SiLU in fp32, one rounding."""
    a, b = group_affine(x2, scale, bias, groups, eps, sums=channel_sums(x2))
    y = x2.float() * a[:, None, :] + b[:, None, :]
    if silu:
        y = F.silu(y)
    return y.to(x2.dtype)


def _launch(x2, scale, bias, groups: int, eps: float, silu: bool):
    n, s, c = x2.shape
    cuda_lib.check_cuda("group_norm_stream x", x2, torch.bfloat16, (n, s, c))
    cuda_lib.check_cuda("group_norm_stream scale", scale, torch.float32, (c,))
    cuda_lib.check_cuda("group_norm_stream bias", bias, torch.float32, (c,))
    plan = launch_plan(n, s, c, groups, cuda_lib.sm_count(x2.device))
    work = torch.empty(n * plan["grid"] * -(-2 * groups // 4) * 4 + n * 2 * groups,
                       device=x2.device, dtype=torch.float32)
    bar = tickets(x2.device, 2)
    y = torch.empty_like(x2)
    cuda_lib.call("aat_group_norm", x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  work.data_ptr(), bar.data_ptr(), y.data_ptr(), n, s, c, groups, plan["pieces"],
                  plan["ring"], plan["grid"], plan["smem"], eps, int(silu))
    global launches
    launches += 1
    return y


@traced("op.group_norm_stream")
def group_norm_stream(x2, scale, bias, groups: int, eps: float = 1e-5,
                      silu: bool = True) -> torch.Tensor:
    """GroupNorm (+SiLU) of x2 (n, s, c) with per-channel scale and bias:
    kernel 7 for a CUDA tensor, its plain version for a CPU tensor."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x2, scale, bias)):
        raise RuntimeError(
            "group_norm_stream has no backward (the JAX package's streaming GroupNorm "
            "kernel has no VJP): call it under torch.no_grad(), or train with "
            "set_default_norm_impl('xla')")
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    run = group_norm_stream_reference if x2.device.type == "cpu" else _launch
    return run(x2, scale, bias, groups, eps, silu)
