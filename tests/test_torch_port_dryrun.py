"""The port's multi-device dry run (``animate_anything_tpu_torch/dryrun.py``,
JAX's ``__graft_entry__.dryrun_multichip``) in 2 spawned gloo ranks, its
refusal to drop to the CPU, and the slice's modules importing no JAX."""

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_dryrun_multichip_on_two_gloo_ranks():
    from animate_anything_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(2, device="cpu", timeout=300.0)
    assert out["mesh"] == {"data": 2}
    assert math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])
    assert out["video"] == [2, 4, 64, 64, 3]
    assert out["optimizer_bytes"] > 0


def test_dryrun_multichip_needs_the_gpus_it_names(monkeypatch):
    from animate_anything_tpu_torch import dryrun

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs"):
        dryrun.dryrun_multichip(2)


def test_the_slice_modules_import_no_jax():
    code = (
        "import sys\n"
        "import animate_anything_tpu_torch.models.lama, animate_anything_tpu_torch.compress_video\n"
        "import animate_anything_tpu_torch.core.mesh, animate_anything_tpu_torch.parallel\n"
        "import animate_anything_tpu_torch.dryrun, animate_anything_tpu_torch.cli\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'animate_anything_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
