"""The port's multi-device dry run (``animate_anything_tpu_torch/dryrun.py``,
JAX's ``__graft_entry__.dryrun_multichip``) in 2 and 4 spawned gloo ranks
(8 in the slow tier), its mesh factored as JAX's, its refusal to drop to the
CPU, and the slice's modules importing no JAX."""

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
    assert out["mesh"] == {"data": 1, "frame": 2, "tensor": 1}
    assert math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])
    assert out["video"] == [2, 4, 64, 64, 3]
    assert out["optimizer_bytes"] > 0


def test_dryrun_mesh_factors_as_jax():
    """``__graft_entry__.py:97-101``: tensor 2 when 8 | n, frame 2 when 2 |
    n/tensor, the rest data."""
    from animate_anything_tpu_torch.dryrun import mesh_factors

    assert mesh_factors(1) == {"data": 1, "frame": 1, "tensor": 1}
    assert mesh_factors(4) == {"data": 2, "frame": 2, "tensor": 1}
    assert mesh_factors(8) == {"data": 2, "frame": 2, "tensor": 2}
    for n in range(1, 33):
        tensor = 2 if n % 8 == 0 else 1
        frame = 2 if (n // tensor) % 2 == 0 else 1
        assert mesh_factors(n) == {"data": n // (tensor * frame), "frame": frame,
                                   "tensor": tensor}


@pytest.mark.parametrize("n", [4, pytest.param(8, marks=pytest.mark.slow)])
def test_dryrun_multichip_on_four_and_eight_gloo_ranks(n):
    """{data: 2, frame: 2} at 4 ranks; {data: 2, frame: 2, tensor: 2} at 8
    (the UNet tensor-split for the step and the request)."""
    from animate_anything_tpu_torch.dryrun import dryrun_multichip, mesh_factors

    out = dryrun_multichip(n, device="cpu", timeout=300.0)
    assert out["mesh"] == mesh_factors(n)
    assert math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])
    assert out["video"] == [2, 4, 64, 64, 3]


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
        "import animate_anything_tpu_torch.parallel.frame, animate_anything_tpu_torch.parallel.tensor\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'animate_anything_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
