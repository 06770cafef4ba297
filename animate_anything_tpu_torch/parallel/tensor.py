"""The tensor axis: Megatron-style tensor parallelism over the mesh's
``tensor`` axis — the port of JAX's ``param_partition_spec`` placement
(``parallel/partition.py``), which shards the attention projections and the
GEGLU feed-forward and lets XLA insert the collectives.

Eager torch inserts them itself, with Megatron's two conjugate functions
over the ``tensor`` subgroup:

- ``copy_to``: identity forward, all-reduce backward, at the input of a
  column-parallel projection (to_q / to_k / to_v, net.0.proj): each rank's
  slice of the product sees the whole input, and the input's gradient is
  the sum of the ranks' parts;
- ``reduce_from``: all-reduce forward, identity backward, at the output of
  a row-parallel one (to_out.0, net.2), in fp32. The bias and the residual
  are added once, after the sum: kernels 2 and 5 run their ``partial``
  mode (the row-parallel GEMM without bias and residual) on every rank.

``shard_model(model, mesh)`` slices a module's parameters in place and
marks its sites:

- an attention site (``CrossAttention``, ``TemporalSelfAttention``, the SVD
  UNet's ``BroadcastCrossAttention``) splits by whole heads: rank r holds
  heads [r·h/T, (r+1)·h/T), the rows of to_q / to_k / to_v and the columns
  of to_out.0 that carry them. Where T does not divide the site's heads
  (the flagship's 5-head 320-wide sites at T = 2 and 4, its 10-head sites
  at T = 4) the site stays replicated: JAX's column split cuts a head in
  two there, which XLA's partitioner absorbs and kernels 1 and 5, which
  hold a head whole, cannot; the numbers are the same either way;
- a feed-forward (``GEGLUFeedForward``) splits its 4c hidden columns: rank r
  holds hidden columns [r·4c/T, (r+1)·4c/T) of both halves, the val rows
  and the gate rows of that range of net.0.proj (and of its bias) side by
  side, as kernel 2 pairs value j with gate j in one tile, and the same
  columns of net.2. JAX's contiguous split of the 8c columns would hand
  rank 0 all the values and rank 1 all the gates;
- kernel 4's ``proj_out``, the norms, the convolutions and the embeddings
  stay replicated, as JAX leaves them.

``partition.param_partition_spec`` is JAX's rule itself on the port's
parameter names; ``placement`` is where the port puts each parameter, and
differs from it exactly at the cases above (ROADMAP queue 3). A sliced
parameter keeps its local gradient; a replicated one gets the same gradient
on every tensor rank (the conjugate functions make it so), and is counted
once in the gradient norm (``train/trainer.py``). ``gather_full`` /
``local_slice`` move a parameter between a rank's slice and the one-device
layout (``train/checkpoint.py``).

LoRA at tensor > 1 runs the model replicated, as JAX does: no rule matches
an adapter's path, so ``cli.main`` does not call ``shard_model``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from animate_anything_tpu_torch.core.mesh import AXIS_TENSOR, CollectiveTimer, Mesh

# time in the tensor axis's collectives while ``on``
COLLECTIVES = CollectiveTimer()


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """This rank's place on the tensor axis."""
    size: int
    rank: int = 0
    group: Any = None


def _all_reduce(t: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    if tp.size > 1:
        COLLECTIVES(dist.all_reduce, t, group=tp.group)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.float(), ctx.tp).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tp):
        return _all_reduce(y.float().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """Identity forward, gradient all-reduced over the tensor axis."""
    return x if tp is None else _CopyTo.apply(x, tp)


def reduce_from(y: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """fp32 sum over the tensor axis forward, identity backward."""
    return y.float() if tp is None else _ReduceFrom.apply(y, tp)


def row_parallel(linear: nn.Linear, h: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``linear(h)`` in the weight's dtype; under ``tp`` the rank's columns
    of the weight against its slice of h, summed over the axis in fp32, the
    bias added once."""
    if tp is None:
        return linear(h)
    dt = linear.weight.dtype
    y = reduce_from(F.linear(h.to(dt), linear.weight), tp)
    return (y + linear.bias.float()).to(dt)


def add_once(partial: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
             tp: TPGroup) -> torch.Tensor:
    """A kernel's ``partial`` output summed over the axis, then the bias and
    the residual, in fp32, rounded once to x's dtype."""
    return (reduce_from(partial, tp) + bias.float() + x.float()).to(x.dtype)


# -- the placement ------------------------------------------------------------

def _heads_site(module) -> bool:
    from animate_anything_tpu_torch.models.attention import CrossAttention, TemporalSelfAttention
    from animate_anything_tpu_torch.models.svd_unet import BroadcastCrossAttention

    return isinstance(module, (CrossAttention, TemporalSelfAttention, BroadcastCrossAttention))


def _ff_site(module) -> bool:
    from animate_anything_tpu_torch.models.attention import GEGLUFeedForward

    return isinstance(module, GEGLUFeedForward)


def site_splits(module: nn.Module, tensor: int) -> bool:
    """Whether ``module`` (an attention or feed-forward site) splits over a
    tensor axis of ``tensor``: whole heads for attention, the 4c hidden
    columns for the feed-forward (c a multiple of 8, kernel 2's partial
    mode)."""
    if tensor <= 1:
        return False
    if _heads_site(module):
        return module.heads % tensor == 0
    if _ff_site(module):
        c = module.net[2].out_features
        return c % 8 == 0 and (4 * c) % (8 * tensor) == 0
    return False


def placement(model: nn.Module, tensor: int) -> Dict[str, tuple]:
    """Parameter name → (torch dim, paired) of every parameter the port
    splits over a tensor axis of ``tensor``: JAX's rule
    (``partition.param_partition_spec``) at the sites that split, and
    net.0.proj's bias with its rows (paired: net.0.proj's val and gate
    halves, split range by range); the rest are replicated."""
    from animate_anything_tpu_torch.parallel.partition import param_partition_spec

    out = {}
    for path, m in model.named_modules():
        if not site_splits(m, tensor):
            continue
        for name, p in m.named_parameters(prefix=path):
            dim = param_partition_spec(name, tuple(p.shape), tensor)
            if dim is not None:
                out[name] = (dim, name.endswith("net.0.proj.weight"))
        if _ff_site(m):
            out[f"{path}.net.0.proj.bias" if path else "net.0.proj.bias"] = (0, True)
    return out


def local_slice(full: torch.Tensor, dim: int, paired: bool, tp: TPGroup) -> torch.Tensor:
    """Rank ``tp.rank``'s slice of a one-device parameter."""
    if not paired:
        return full.chunk(tp.size, dim)[tp.rank]
    halves = full.chunk(2, dim)
    return torch.cat([h.chunk(tp.size, dim)[tp.rank] for h in halves], dim)


def join_slices(parts, dim: int, paired: bool) -> torch.Tensor:
    """Every rank's slice (rank order) → the one-device parameter, the
    val/gate pairing undone."""
    if not paired:
        return torch.cat(parts, dim)
    halves = [p.chunk(2, dim) for p in parts]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim)


def gather_full(local: torch.Tensor, dim: int, paired: bool,
                tp: TPGroup) -> Optional[torch.Tensor]:
    """The one-device parameter from every rank's slice, on the axis's rank
    0 (None on the others). A collective over the axis."""
    local = local.contiguous()
    main = tp.rank == 0
    parts = [torch.empty_like(local) for _ in range(tp.size)] if main else None
    COLLECTIVES(dist.gather, local, parts, dst=dist.get_global_rank(tp.group, 0),
                group=tp.group)
    return join_slices(parts, dim, paired) if main else None


def full_weights(model: nn.Module, weights: Dict[str, torch.Tensor]) -> Optional[dict]:
    """``weights`` (parameter name → this rank's tensor) with every tensor-
    split parameter whole (on the host), on the tensor axis's rank 0; None
    on its other ranks; ``weights`` itself for a model with no tensor axis.
    A collective over the axis."""
    tp, plan = model_plan(model)
    if tp is None:
        return weights
    dev = next(model.parameters()).device
    out = {}
    for n, t in weights.items():
        if n in plan:
            t = gather_full(t.to(dev), *plan[n], tp)
            t = None if t is None else t.cpu()
        out[n] = t
    return out if tp.rank == 0 else None


def mesh_group(mesh: Optional[Mesh]) -> Optional[TPGroup]:
    """The tensor axis of ``mesh`` above 1 under a process group, or None."""
    if mesh is None or mesh.device_mesh is None or mesh.size(AXIS_TENSOR) == 1:
        return None
    return TPGroup(mesh.size(AXIS_TENSOR), mesh.rank(AXIS_TENSOR), mesh.group(AXIS_TENSOR))


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, tuple]:
    """Slice ``model``'s parameters over ``mesh``'s tensor axis in place
    (each rank keeps its slice, ``placement``) and mark each site that
    splits with the axis (``module.tp``); → the placement, also kept as
    ``model.tp_plan`` (with ``model.tp``). Nothing changes without a tensor
    axis above 1."""
    tp = mesh_group(mesh)
    if tp is None:
        return {}
    plan = placement(model, tp.size)
    params = dict(model.named_parameters())
    for name, (dim, paired) in plan.items():
        p = params[name]
        p.data = local_slice(p.data, dim, paired, tp).contiguous()
    for _, m in model.named_modules():
        if site_splits(m, tp.size):
            m.tp = tp
    model.tp, model.tp_plan = tp, plan
    return plan


def model_plan(model: Optional[nn.Module]) -> tuple:
    """(the tensor axis, the placement) a ``shard_model``-ed model carries, or
    (None, {})."""
    if model is None:
        return None, {}
    return getattr(model, "tp", None), getattr(model, "tp_plan", {})
