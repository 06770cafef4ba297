"""The device mesh on ``torch.distributed`` — the port of
``animate_anything_tpu/core/mesh.py``.

JAX names three mesh axes: ``data`` (batch data parallelism), ``frame``
(video frames sharded across devices) and ``tensor`` (attention heads and
MLP columns). The port runs one process a GPU under ``torchrun``, NCCL
between them (gloo for an explicit ``device="cpu"``), and lays the ranks out
as JAX lays out its devices: ``np.asarray(devices).reshape(sizes)``,
row-major over the axes in the order the shape names them. Each axis has
its own process subgroup (``Mesh.group``), the ranks that differ only in
that axis's index.

``create_mesh(shape)`` resolves the axis sizes exactly as JAX does against
the world size of the default process group (1 without one): by default
everything on ``data``, one ``-1`` absorbing the rest, the same
``ValueError``s. With a process group it holds a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks with a
named dimension for each of the three axes (an axis the shape leaves out
has size 1); at world size 1 with no launcher there is no group and
nothing communicates, so the one-card path stays as it was.

JAX places values with ``named_sharding`` and ``constrain`` and lets XLA
insert the collectives. Eager torch holds a sharded value as this rank's
part and moves the parts itself, so neither has a counterpart here:
``shard_batch`` / ``gather_rows`` take and join a batch's rows over
``data``, ``parallel/frame.py`` splits frames over ``frame`` and moves them
around the temporal layers, and ``parallel/tensor.py`` slices the attention
and feed-forward weights over ``tensor``. JAX's ``local_mesh_axes`` (axis
name → size) is ``Mesh.axes``.
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
ALL_AXES = (AXIS_DATA, AXIS_FRAME, AXIS_TENSOR)

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
    without a group). Sizes resolve as in JAX; under a process group the
    mesh must use every rank (a rank outside it would have no work)."""
    n = world_size()
    try:
        axes = resolve_mesh_shape(shape, n)
    except ValueError as e:
        raise ValueError(f"{e}: start one process a device, e.g. torchrun --nproc_per_node N "
                         "(ROADMAP queue F, item 21a)") from e
    want = math.prod(axes.values())
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axes)
    if want != n:
        raise ValueError(f"mesh {axes} uses {want} of the {n} ranks; launch {want} processes")
    from torch.distributed.device_mesh import DeviceMesh

    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    # JAX's row-major layout over the named axes; an axis left out is a
    # trailing dimension of size 1, which changes no rank's place
    names = tuple(axes) + tuple(a for a in ALL_AXES if a not in axes)
    ranks = torch.arange(n).reshape(tuple(axes.values()) + (1,) * (len(names) - len(axes)))
    return Mesh(axes, DeviceMesh(device_type, ranks, mesh_dim_names=names))


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
