"""Batching and the host-to-card prefetch — the port of
``animate_anything_tpu/data/loader.py``.

``DataLoader``: a thread assembles numpy batches while the card computes;
the order is a numpy permutation seeded ``seed + epoch``, as in JAX. Under
data parallelism (``mesh=``) every rank walks the same order and decodes
only its rows of each global batch. ``device_prefetch``: the next batch's
copy to the card runs on a side CUDA stream from pinned host buffers while
the current batch computes; the consumer's stream waits on the copy's event
before it reads the batch, so no kernel reads a batch before its copy
lands.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from animate_anything_tpu_torch.core.mesh import (AXIS_DATA, Mesh, create_mesh,
                                                  mesh_shape_from_config, row_range)


def collate(items: list) -> Dict[str, Any]:
    """Stack dict items; strings become lists."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Shuffled, batched, background-threaded loader over any indexable
    dataset of dicts. ``batch_size`` is the global batch; with a ``mesh``
    whose data axis is above 1 each rank decodes and yields only its rows
    of every global batch, in the same order on every rank; the ranks that
    differ only on the ``frame`` and ``tensor`` axes read the same rows, as
    JAX places the batch over ``data`` alone."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 mesh: Optional[Mesh] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.mesh = mesh if mesh is not None and mesh.size(AXIS_DATA) > 1 else None
        if self.mesh is not None:
            row_range(batch_size, self.mesh)        # the batch must split evenly
        self._epoch = 0
        n = len(dataset)
        if n == 0 or (drop_last and n < batch_size):
            raise ValueError(
                f"dataset yields no batches ({n} items, batch_size={batch_size}"
                f"{', drop_last' if drop_last else ''}) — check train_data.path "
                "and dataset_types; an empty loader would loop forever making "
                "no training steps"
            )

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._index_order()
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def rows(idx):
            """Decode a global batch's indices: all, or this rank's rows."""
            if self.mesh is None:
                return collate([self.dataset[int(i)] for i in idx])
            lo, hi = row_range(len(idx), self.mesh)
            return collate([self.dataset[int(i)] for i in idx[lo:hi]])

        def worker():
            try:
                for start in range(0, len(order), self.batch_size):
                    if stop.is_set():
                        return
                    idx = order[start:start + self.batch_size]
                    if len(idx) == self.batch_size or not self.drop_last:
                        q.put(rows(idx))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def check_mesh(mesh, default_data: int = -1) -> Mesh:
    """The mesh a config's ``mesh`` asks for (``data`` ``default_data`` when
    absent), checked: the axes must come to the world size (``data`` -1
    absorbing what ``frame`` and ``tensor`` leave; 1 without a launcher),
    else ``ValueError``."""
    return create_mesh(mesh_shape_from_config(mesh, default_data))


def device_prefetch(iterator, device="cuda", mesh=None, size: int = 1):
    """Wrap a host-batch iterator: each array becomes a tensor on ``device``
    (strings stay lists), the copies of up to ``size`` batches ahead running
    on a side stream (pinned host buffers, ``non_blocking``) while the
    current batch computes. A yielded batch's tensors are ready on the
    current stream: it waits on the batch's copy event, and the tensors are
    recorded on it so their memory is not reused early. ``mesh`` (a
    ``core/mesh.Mesh``, or a config's ``mesh`` mapping, ``check_mesh``-ed)
    is only checked: under data parallelism the batches are already this
    rank's rows, as a ``DataLoader(..., mesh=)`` yields them. On the CPU
    (``device="cpu"``) the tensors wrap the host arrays. Raises without CUDA
    unless ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch: no CUDA device (pass device='cpu' for the CPU)")
    if mesh is not None and not isinstance(mesh, Mesh):
        check_mesh(mesh)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        out, event = {}, None
        if stream is None:
            for k, v in batch.items():
                out[k] = v if isinstance(v, list) else torch.from_numpy(np.asarray(v))
            return out, event
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if isinstance(v, list):
                    out[k] = v
                    continue
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def ready(item):
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        return batch

    buf = []
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > size:
            yield ready(buf.pop(0))
    for item in buf:
        yield ready(item)
