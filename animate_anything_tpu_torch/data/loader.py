"""Batching and the host-to-card prefetch — the port of
``animate_anything_tpu/data/loader.py``.

``DataLoader``: a thread assembles numpy batches while the card computes;
the order is a numpy permutation seeded ``seed + epoch``, as in JAX.
``device_prefetch``: the next batch's copy to the card runs on a side CUDA
stream from pinned host buffers while the current batch computes; the
consumer's stream waits on the copy's event before it reads the batch, so
no kernel reads a batch before its copy lands.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch


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
    dataset of dicts."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
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

        def worker():
            batch = []
            try:
                for i in order:
                    if stop.is_set():
                        return
                    batch.append(self.dataset[int(i)])
                    if len(batch) == self.batch_size:
                        q.put(collate(batch))
                        batch = []
                if batch and not self.drop_last:
                    q.put(collate(batch))
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


def check_mesh(mesh) -> None:
    """A config's ``mesh`` must ask for one device: every axis 1, or the data
    axis -1 (all devices: one card); more raise (ROADMAP queue F, item 21)."""
    for axis, n in dict(mesh or {}).items():
        if int(n) != 1 and not (axis == "data" and int(n) == -1):
            raise ValueError(f"mesh {axis}={n} asks for more than one device; data, frame and "
                             "tensor parallelism are not ported (ROADMAP queue F, item 21)")


def device_prefetch(iterator, device="cuda", mesh=None, size: int = 1):
    """Wrap a host-batch iterator: each array becomes a tensor on ``device``
    (strings stay lists), the copies of up to ``size`` batches ahead running
    on a side stream (pinned host buffers, ``non_blocking``) while the
    current batch computes. A yielded batch's tensors are ready on the
    current stream: it waits on the batch's copy event, and the tensors are
    recorded on it so their memory is not reused early. ``mesh`` is JAX's
    data sharding: one card takes ``{"data": 1}`` or ``{"data": -1}``; more
    devices raise (ROADMAP queue F, item 21). On the CPU (``device="cpu"``)
    the tensors wrap the host arrays. Raises without CUDA unless
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch: no CUDA device (pass device='cpu' for the CPU)")
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
