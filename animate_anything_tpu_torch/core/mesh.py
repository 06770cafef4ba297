"""The device mesh on ``torch.distributed`` — the port of
``animate_anything_tpu/core/mesh.py``.

JAX names three mesh axes: ``data`` (batch data parallelism), ``frame``
(video frames sharded across devices) and ``tensor`` (attention heads and
MLP columns). The port carries the data axis: one process a GPU under
``torchrun``, NCCL between them (gloo for an explicit ``device="cpu"``),
the batch split by rows. The frame and tensor axes reach into the fused
kernels (kernel 3's Σ/Σ² and kernel 5's frame attention need every frame;
kernels 2, 4 and 5 fuse the residual into the GEMM a row-parallel split
would cut), so each needs its own design: an axis above 1 raises
``NotImplementedError`` naming its ROADMAP item (queue F, 21b and 21c).

``create_mesh(shape)`` resolves the axis sizes exactly as JAX does against
the world size of the default process group (1 without one): by default
everything on ``data``, one ``-1`` absorbing the rest, the same
``ValueError``s. With a process group it holds a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks; at
world size 1 with no launcher there is no group and nothing communicates,
so the one-card path stays as it was.

In eager torch a value sharded over ``data`` is held as this rank's rows:
``shard_batch`` takes them, ``gather_rows`` joins them again. JAX's
``named_sharding``, ``constrain`` and ``local_mesh_axes`` place values on
the frame and tensor axes and come with them (ROADMAP queue F, 21b / 21c).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import time
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FRAME = "frame"
AXIS_TENSOR = "tensor"

NOT_PORTED = {AXIS_FRAME: "ROADMAP queue F, item 21b (the frame axis)",
              AXIS_TENSOR: "ROADMAP queue F, item 21c (the tensor axis)"}

# A collective that does not finish in this time fails instead of hanging.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def init_distributed(device="cuda") -> int:
    """Start the default process group where a launcher asks for one, and
    return the world size. Under ``torchrun`` (``WORLD_SIZE`` / ``RANK`` /
    ``LOCAL_RANK`` in the environment) it joins the group through the
    environment's rendezvous: NCCL on the card (each process on GPU
    ``LOCAL_RANK``), gloo for ``device="cpu"``. A group that already exists is
    kept. With no launcher it starts nothing: world size 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ:
        return 1
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device (pass device='cpu' for gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", timeout=DEFAULT_TIMEOUT)
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that logs and writes."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def resolve_mesh_shape(shape: Optional[Mapping[str, int]], n: int) -> dict:
    """Axis name → size over ``n`` devices, as JAX's ``create_mesh`` resolves
    it: ``None`` puts every device on ``data``; one ``-1`` absorbs what the
    other axes leave; two ``-1``s, a count the others do not divide, or a
    mesh larger than ``n`` raise ``ValueError``."""
    if shape is None:
        shape = {AXIS_DATA: n}
    names = list(shape.keys())
    sizes = [int(s) for s in shape.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    want = math.prod(sizes)
    if want > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {want} > {n} devices")
    return dict(zip(names, sizes))


def mesh_shape_from_config(mesh_cfg: Optional[Mapping[str, Any]], default_data: int) -> dict:
    """A config's ``mesh`` → the shape JAX's entry points ask for: ``data``
    (``default_data`` when absent), and ``frame`` / ``tensor`` only where
    they are not 1."""
    mesh_cfg = dict(mesh_cfg or {})
    shape = {AXIS_DATA: int(mesh_cfg.get(AXIS_DATA, default_data))}
    for ax in (AXIS_FRAME, AXIS_TENSOR):
        if int(mesh_cfg.get(ax, 1)) != 1:
            shape[ax] = int(mesh_cfg[ax])
    return shape


class AxisNotPorted(NotImplementedError, ValueError):
    """A mesh axis the port does not run (a ``NotImplementedError``, and a
    ``ValueError`` as every other bad mesh)."""


def refuse_unported_axes(shape: Mapping[str, int]) -> None:
    """Raise ``AxisNotPorted`` for a frame or tensor axis above 1."""
    for ax, item in NOT_PORTED.items():
        if int(shape.get(ax, 1)) > 1:
            raise AxisNotPorted(
                f"mesh {ax}={shape[ax]}: the {ax} axis is not ported ({item}); "
                "only the data axis runs")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axis sizes, and the ``DeviceMesh`` over the default group's ranks
    when a process group exists (None at world size 1 without a launcher)."""
    axes: dict
    device_mesh: Any = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    def size(self, axis: str = AXIS_DATA) -> int:
        return int(self.axes.get(axis, 1))

    def group(self, axis: str = AXIS_DATA):
        """The process group of ``axis`` (None without a process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str = AXIS_DATA) -> int:
        """This process's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))


def create_mesh(shape: Optional[Mapping[str, int]] = None) -> Mesh:
    """Build the mesh over the default process group's ranks (one device
    without a group). Sizes resolve as in JAX; a frame or tensor axis above 1
    raises ``NotImplementedError``; under a process group the mesh must use
    every rank (a rank outside it would have no work)."""
    n = world_size()
    if shape is not None:
        refuse_unported_axes(shape)
    try:
        axes = resolve_mesh_shape(shape, n)
    except ValueError as e:
        raise ValueError(f"{e}: start one process a device, e.g. torchrun --nproc_per_node N "
                         "(ROADMAP queue F, item 21a)") from e
    refuse_unported_axes(axes)
    want = math.prod(axes.values())
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axes)
    if want != n:
        raise ValueError(f"mesh {axes} uses {want} of the {n} ranks; launch {want} processes")
    from torch.distributed.device_mesh import DeviceMesh

    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(tuple(axes.values()))
    return Mesh(axes, DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes)))


def row_range(b: int, mesh: Mesh, axis: str = AXIS_DATA) -> tuple:
    """This rank's rows ``[lo, hi)`` of a ``b``-row global batch: rank r holds
    rows r·b/n … (r+1)·b/n − 1, as JAX's ``P("data", ...)`` places them."""
    n = mesh.size(axis)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {axis}={n}")
    per = b // n
    r = mesh.rank(axis)
    return r * per, (r + 1) * per


def shard_batch(batch, mesh: Mesh, axis: str = AXIS_DATA):
    """This rank's rows of a global batch (a dict of tensors, arrays and
    lists; 0-d values are kept whole)."""
    if mesh.size(axis) == 1:
        return batch

    def take(v):
        if isinstance(v, (list, tuple)) or getattr(v, "ndim", 0):
            lo, hi = row_range(len(v), mesh, axis)
            return v[lo:hi]
        return v

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


@dataclasses.dataclass
class CollectiveTimer:
    """Time spent in the data axis's collectives while ``on`` (off by
    default, so a long run keeps no events): CUDA events on the issuing
    stream, read once after the work, or host seconds for gloo."""
    on: bool = False
    events: list = dataclasses.field(default_factory=list)
    host_s: float = 0.0

    def __call__(self, fn, *args, **kw):
        if not self.on:
            return fn(*args, **kw)
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if t is not None and t.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.host_s += time.perf_counter() - t0
        return out

    def ms(self) -> float:
        """Milliseconds so far (syncs the card once), then zero the tally."""
        total = self.host_s * 1e3
        if self.events:
            self.events[-1][1].synchronize()
            total += sum(s.elapsed_time(e) for s, e in self.events)
        self.events, self.host_s = [], 0.0
        return total


COLLECTIVES = CollectiveTimer()


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_DATA) -> torch.Tensor:
    """Join every rank's rows of ``x`` (equal counts) in rank order: the
    global value on every rank."""
    if mesh.size(axis) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    COLLECTIVES(dist.all_gather, parts, x, group=mesh.group(axis))
    return torch.cat(parts)
