"""Metric logging — a copy of ``animate_anything_tpu/utils/logging_util.py``:
an append-only jsonl file (the source of truth) and stdout, mirrored to
TensorBoard where ``tensorboardX`` imports, as in JAX.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, output_dir: str, name: str = "train"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}_log.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:  # the optional mirror
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        except Exception:
            pass
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, float], echo: bool = True) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 2)}
        record.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))
        if echo:
            parts = " ".join(f"{k}={float(v):.5g}" for k, v in metrics.items())
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A logger that writes nothing: the data-parallel ranks but rank 0."""

    def log(self, step: int, metrics: Mapping[str, float], echo: bool = True) -> None:
        pass

    def close(self) -> None:
        pass


def run_logger(output_dir: str, name: str = "train"):
    """``MetricLogger`` on the process that writes (rank 0), else a
    ``NullLogger``."""
    from animate_anything_tpu_torch.core.mesh import is_main_process

    return MetricLogger(output_dir, name) if is_main_process() else NullLogger()
