"""The frame axis: a request's frames split over the ranks of the mesh's
``frame`` axis — what JAX's ``latent2video.shard`` asks of XLA with a
``P("data", "frame")`` constraint on the latents.

Frames are independent through conv_in / conv_out, the resnets, the
spatial transformers and the down/up samplers: each rank runs them on its
own frames. Two kinds of layer need the whole frame group: every
``TemporalConvLayer`` (GroupNorm over (c/g, f, h, w), then a 3-tap conv
over frames) and every temporal transformer (GroupNorm over (c/g, f, h, w),
then attention over the frames at each position). Around those the port
does what JAX's docstring (``latent2video.py:56-61``) says XLA inserts: an
all-to-all from frame-sharded (b, f_r, s, c) to position-sharded
(b, f, s_r, c) and back. In the position-sharded layout every position
holds all its frames, so kernel 3's tap conv, kernel 5's frame attention
and the composite temporal path run unchanged on a slice of positions,
and no padding frame exists anywhere. Their GroupNorm statistics, and
kernel 3's Σ/Σ² epilogue, are partial over positions: ``reduce`` sums them
over the group (fp32, a few hundred KB at most) before the affine is
formed, so each norm pools the whole (f, h, w).

The split is uneven where it has to be. The mask+motion UNet prepends the
condition latent (``models/unet3d.py``), so a 16-frame request is 17 frames
inside the UNet; rank 0 holds the condition frame and its share of the
request's frames (9 + 8 over two ranks, 5 + 4 + 4 + 4 over four). The
all-to-alls carry explicit split sizes (``all_to_all_single`` on flat
buffers), so counts and positions need not divide.

``sharded_frames(shard)`` makes a ``FrameShard`` the active one for the
calls inside it (a thread's own, as ``utils/ptp``'s controller); the
temporal layers read it with ``active()``. Frame sharding is an inference
layout, as in JAX, whose train step places the batch over ``data`` alone:
these collectives have no backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from animate_anything_tpu_torch.core.mesh import AXIS_FRAME, CollectiveTimer, Mesh

# time in the frame axis's collectives while ``on`` (chip_smoke's frame phase)
COLLECTIVES = CollectiveTimer()


def split_counts(total: int, parts: int) -> tuple:
    """``total`` items over ``parts`` ranks in rank order: ⌈total/parts⌉ to
    the first ``total % parts`` ranks, ⌊total/parts⌋ to the rest."""
    base, extra = divmod(total, parts)
    return tuple(base + (r < extra) for r in range(parts))


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's frames of a frame-sharded tensor: ``counts[r]`` frames on
    rank r of ``group`` (the frame axis's subgroup), in frame order."""
    counts: tuple
    rank: int = 0
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.counts)

    @property
    def total(self) -> int:
        return sum(self.counts)

    @property
    def lo(self) -> int:
        return sum(self.counts[:self.rank])

    @property
    def local(self) -> int:
        return self.counts[self.rank]

    @property
    def hi(self) -> int:
        return self.lo + self.local

    def leading(self, extra: int) -> "FrameShard":
        """The same split with ``extra`` frames in front, on rank 0 (the
        UNet's condition frame)."""
        return dataclasses.replace(self, counts=(self.counts[0] + extra,) + self.counts[1:])

    def _a2a(self, send: torch.Tensor, out_splits: Sequence[int],
             in_splits: Sequence[int]) -> torch.Tensor:
        recv = send.new_empty(sum(out_splits))
        COLLECTIVES(dist.all_to_all_single, recv, send.reshape(-1), list(out_splits),
                    list(in_splits), group=self.group)
        return recv

    def to_positions(self, x: torch.Tensor) -> torch.Tensor:
        """(b, f_r, s, c) frame-sharded → (b, f, s_r, c) position-sharded,
        the s positions split by ``split_counts``."""
        b, fr, s, c = x.shape
        assert fr == self.local, (fr, self.counts)
        sc = split_counts(s, self.size)
        sr = sc[self.rank]
        send = x.permute(2, 0, 1, 3).contiguous()           # (s, b, f_r, c)
        recv = self._a2a(send, [sr * b * fq * c for fq in self.counts],
                         [sq * b * fr * c for sq in sc])
        parts = [p.view(sr, b, fq, c)
                 for p, fq in zip(recv.split([sr * b * fq * c for fq in self.counts]),
                                  self.counts)]
        return torch.cat(parts, 2).permute(1, 2, 0, 3).contiguous()

    def to_frames(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """(b, f, s_r, c) position-sharded → (b, f_r, s, c) frame-sharded."""
        b, f, sr, c = x.shape
        assert f == self.total, (f, self.counts)
        sc = split_counts(s, self.size)
        fr = self.local
        send = x.permute(1, 0, 2, 3).contiguous()           # (f, b, s_r, c)
        recv = self._a2a(send, [fr * b * sq * c for sq in sc],
                         [fq * b * sr * c for fq in self.counts])
        parts = [p.view(fr, b, sq, c)
                 for p, sq in zip(recv.split([fr * b * sq * c for sq in sc]), sc)]
        return torch.cat(parts, 2).transpose(0, 1).contiguous()

    def reduce(self, *tensors: torch.Tensor) -> tuple:
        """Each fp32 tensor summed over the group (one all-reduce)."""
        flat = torch.cat([t.float().reshape(-1) for t in tensors])
        COLLECTIVES(dist.all_reduce, flat, group=self.group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
        return tuple(out)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's frames of ``x`` (this rank's along ``dim``) joined in
        frame order, on every rank."""
        pad = max(self.counts) - self.local
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        COLLECTIVES(dist.all_gather, parts, x.contiguous(), group=self.group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, self.counts)], dim)


def mesh_shard(mesh: Optional[Mesh], frames: int) -> Optional[FrameShard]:
    """The split of ``frames`` over ``mesh``'s frame axis by JAX's rule
    (``latent2video.shard``): sharded only where the axis divides
    ``frames``; None otherwise (the frames stay whole on every rank), and
    None where the mesh has no process group or names no frame axis. A
    frame axis of size 1 that the mesh names gives a one-rank split, whose
    collectives are copies: the same values as no split."""
    if mesh is None or mesh.device_mesh is None or AXIS_FRAME not in mesh.axes:
        return None
    n = mesh.size(AXIS_FRAME)
    if frames % n:
        return None
    return FrameShard(split_counts(frames, n), mesh.rank(AXIS_FRAME), mesh.group(AXIS_FRAME))


_STATE = threading.local()


def active() -> Optional[FrameShard]:
    """The frame split the calling thread's UNet runs under, or None."""
    return getattr(_STATE, "shard", None)


@contextlib.contextmanager
def sharded_frames(shard: Optional[FrameShard]):
    """Run the calls inside under ``shard`` (None: the frames are whole)."""
    prev = active()
    _STATE.shard = shard
    try:
        yield shard
    finally:
        _STATE.shard = prev


def local_frames(num_frames: int) -> int:
    """This rank's count of a ``num_frames``-frame tensor under the active
    split (``num_frames`` itself without one)."""
    shard = active()
    if shard is None:
        return num_frames
    if shard.total != num_frames:
        raise ValueError(f"frame split {shard.counts} does not cover {num_frames} frames")
    return shard.local
