"""Parameter and optimizer-state partitioning over the mesh — the port of
``animate_anything_tpu/parallel/partition.py``.

- **Data parallelism**: each rank of the ``data`` axis computes the loss of
  its rows of the global batch; the gradients are averaged over the axis
  (``ZeroPlan.reduce_mean_``, an all-reduce in fp32). At one rank nothing
  is communicated: every collective of the plan returns at once, so
  ``torchrun --nproc_per_node 1`` runs the one-device step.
- **ZeRO**: the optimizer state (AdamW's moments, the ``MultiSteps``
  accumulator, the 8-bit moments and their block scales) is split over
  ``data``; each rank updates its part of the fp32 masters, and the masters
  are all-gathered after the update. Arrays under ``min_shard_size``
  elements stay replicated, and so do the parameters, as in JAX.

The cut differs from JAX's (its largest divisible axis), which changes
where a value lives and no result: each array's flattened range is split
into contiguous slices aligned to 256 elements, the 8-bit AdamW's block
(``ops/adam8bit.BLOCK``), so a rank holds whole quantization blocks and
their scales and the 8-bit update equals the unsharded one. Rank r owns
``[r·c, (r+1)·c)`` of an array of n elements (clipped to n) with
``c = ⌈⌈n/256⌉/ranks⌉·256``; the last ranks may own less, or nothing.

- **TP**: ``param_partition_spec`` is JAX's rule (``_TP_RULES``) on the
  port's diffusers parameter names; ``parallel/tensor.py`` places the
  parameters by it, with the whole-head and GEGLU-pairing differences its
  docstring names. The ZeRO plan then runs over the ``data`` subgroup on
  each rank's local (tensor-sliced) arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional

import torch
import torch.distributed as dist

from animate_anything_tpu_torch.core.mesh import AXIS_DATA, COLLECTIVES, Mesh

MIN_SHARD_SIZE = 2 ** 14

# name suffix → the torch dim JAX's rule splits over 'tensor'. A flax Dense
# kernel is (in, out) and a torch Linear weight (out, in): JAX's columns
# (-1) are torch dim 0 and its rows (0) torch dim 1.
_TP_RULES = (
    ("to_q.weight", 0),
    ("to_k.weight", 0),
    ("to_v.weight", 0),
    ("to_out.0.weight", 1),
    ("net.0.proj.weight", 0),
    ("net.2.weight", 1),
)


def param_partition_spec(name: str, shape, tensor: int) -> Optional[int]:
    """JAX's ``param_partition_spec`` for the parameter ``name`` of
    ``shape`` on a tensor axis of ``tensor``: the torch dim it splits, or
    None (replicated). It splits wherever a rule matches and the dim
    divides."""
    if tensor > 1:
        for pat, dim in _TP_RULES:
            if name.endswith(pat) and shape[dim] % tensor == 0:
                return dim
    return None
BLOCK = 256                 # the 8-bit AdamW's quantization block
BUCKET = 1 << 26            # elements a rank sends in one collective


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class ZeroPlan:
    """Which slice of each optimizer array this rank owns, and the
    collectives over the data axis. ``chunks[name]``: elements a rank owns
    of a sharded array (a multiple of ``BLOCK``); names absent from it are
    replicated."""
    numels: Dict[str, int]
    chunks: Dict[str, int]
    ranks: int
    rank: int
    group: Any = None

    def sharded(self, name: str) -> bool:
        return name in self.chunks

    def range(self, name: str, r: Optional[int] = None) -> tuple:
        """Rank ``r``'s (default: this rank's) slice [lo, hi) of ``name``."""
        r = self.rank if r is None else r
        c, n = self.chunks[name], self.numels[name]
        return min(r * c, n), min((r + 1) * c, n)

    def owns_all(self, name: str) -> bool:
        """Whether this rank updates the whole array (a replicated one, or
        every array at one rank)."""
        return not self.sharded(name) or self.range(name) == (0, self.numels[name])

    def view(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The part of a full-shaped ``t`` that this rank updates: its flat
        slice of a sharded array (a view where ``t`` is contiguous), or ``t``
        itself where the rank owns all of it, so one rank computes exactly
        what the one-device optimizer does."""
        if self.owns_all(name):
            return t
        lo, hi = self.range(name)
        return t.reshape(-1)[lo:hi]

    def block_view(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's part of a per-block array (the 8-bit scales)."""
        if self.owns_all(name):
            return t
        lo, hi = self.range(name)
        return t[lo // BLOCK:lo // BLOCK + _ceil(hi - lo, BLOCK)]

    # -- collectives (none at one rank) -------------------------------------

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        if self.ranks > 1:
            COLLECTIVES(dist.all_reduce, t, group=self.group)
        return t

    def reduce_mean_(self, tensors: List[torch.Tensor]) -> None:
        """Average ``tensors`` in place over the data axis, in fp32 (each cast
        back to its dtype once), in flat buckets of ``BUCKET`` elements."""
        if self.ranks == 1:
            return
        for bucket in _buckets(tensors, {id(t): t.numel() for t in tensors}, key=id):
            flat = torch.cat([t.reshape(-1).float() for t in bucket])
            self.all_reduce_sum_(flat)
            flat.div_(self.ranks)
            i = 0
            for t in bucket:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()

    @staticmethod
    def _pack(parts: List[torch.Tensor], sizes: List[int]) -> torch.Tensor:
        """``parts`` flat in one buffer, each zero-padded to its entry of
        ``sizes``."""
        local = torch.zeros(sum(sizes), dtype=parts[0].dtype, device=parts[0].device)
        i = 0
        for p, s in zip(parts, sizes):
            local[i:i + p.numel()] = p.reshape(-1)
            i += s
        return local

    def all_gather_(self, full: Dict[str, torch.Tensor], names: Iterable[str]) -> None:
        """Make every rank's slice of each sharded array in ``full`` (full
        shapes, this rank's slice up to date) whole on every rank."""
        if self.ranks == 1:
            return
        names = [n for n in names if self.sharded(n)]
        for bucket in _buckets(names, self.chunks):
            sizes = [self.chunks[n] for n in bucket]
            local = self._pack([self.view(full[n], n) for n in bucket], sizes)
            got = [torch.empty_like(local) for _ in range(self.ranks)]
            COLLECTIVES(dist.all_gather, got, local, group=self.group)
            for r, flat in enumerate(got):
                i = 0
                for n, s in zip(bucket, sizes):
                    lo, hi = self.range(n, r)
                    full[n].view(-1)[lo:hi] = flat[i:i + hi - lo]
                    i += s

    def gather_to_main(self, items: Mapping[Any, tuple]) -> Optional[dict]:
        """Whole arrays on the host of the data axis's rank 0, from every
        rank's slices: ``items`` maps a key to (array name, this rank's
        tensor, the whole shape, whether it holds one value a block); →
        key → whole host tensor on rank 0, None on the other ranks. The
        slices go to rank 0 alone (``gather``), in buckets of one dtype. A
        collective: every rank calls it with the same keys."""
        main = self.rank == 0
        out = {}
        by_dtype: Dict[torch.dtype, list] = {}
        for key, (name, local, shape, _) in items.items():
            if self.ranks == 1 or not self.sharded(name):
                if main:
                    out[key] = local.reshape(shape).to("cpu")
            else:
                by_dtype.setdefault(local.dtype, []).append(key)
        dst = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        for keys in by_dtype.values():
            sizes = {k: self.chunks[items[k][0]] // (BLOCK if items[k][3] else 1) for k in keys}
            for bucket in _buckets(keys, sizes):
                local = self._pack([items[k][1] for k in bucket], [sizes[k] for k in bucket])
                got = [torch.empty_like(local) for _ in range(self.ranks)] if main else None
                COLLECTIVES(dist.gather, local, got, dst=dst, group=self.group)
                if not main:
                    continue
                got = [g.to("cpu") for g in got]
                i = 0
                for k in bucket:
                    name, _, shape, blocks = items[k]
                    total = _ceil(self.numels[name], BLOCK) if blocks else self.numels[name]
                    whole = torch.cat([g[i:i + sizes[k]] for g in got])[:total]
                    out[k] = whole.reshape(shape)
                    i += sizes[k]
        return out if main else None


def _buckets(items, sizes: Mapping[Any, int], key=lambda it: it):
    """Consecutive groups of ``items`` of about ``BUCKET`` elements each
    (``sizes[key(item)]`` an item)."""
    bucket, total = [], 0
    for it in items:
        bucket.append(it)
        total += sizes[key(it)]
        if total >= BUCKET:
            yield bucket
            bucket, total = [], 0
    if bucket:
        yield bucket


def zero_plan(numels: Mapping[str, int], mesh: Optional[Mesh],
              min_shard_size: int = MIN_SHARD_SIZE) -> Optional[ZeroPlan]:
    """The ZeRO split of arrays of ``numels`` elements over ``mesh``'s data
    axis, or None without a process group (one device, nothing to split or
    reduce). Arrays under ``min_shard_size`` elements stay replicated."""
    if mesh is None or mesh.device_mesh is None:
        return None
    n = mesh.size(AXIS_DATA)
    return ZeroPlan(dict(numels), zero_chunks(numels, n, min_shard_size), n,
                    mesh.rank(AXIS_DATA), mesh.group(AXIS_DATA))


def zero_chunks(numels: Mapping[str, int], ranks: int,
                min_shard_size: int = MIN_SHARD_SIZE) -> Dict[str, int]:
    """Elements a rank owns of each array that is split over ``ranks``: its
    256-element blocks shared out evenly, the last ranks taking what is
    left; arrays under ``min_shard_size`` elements are absent (replicated)."""
    return {name: _ceil(_ceil(size, BLOCK), ranks) * BLOCK for name, size in numels.items()
            if size >= min_shard_size}
