"""The run's surroundings: the checkout-local cache directories, the card
(none means no result), its identity, and the rule that the process holds
no JAX and nothing of the JAX package once the window has closed."""

from __future__ import annotations

import os
import subprocess
import sys

from perfbench.harness.registry import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "animate_anything_tpu")
CACHE = REPO / "build" / "perfbench_cache"


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own library builds into ``build/torch_kernels/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``animate_anything_tpu_torch`` is neither)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"perfbench: the cell needs {count} cards, "
                         f"{torch.cuda.device_count()} found")


def smi(fields: str = "power.limit") -> str:
    """``nvidia-smi``'s reading of the first card's ``fields``."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20,
                             check=False).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out[0].strip() if out else "unknown"


def power_limit() -> str:
    return smi("power.limit")


def card_state() -> str:
    return smi("clocks.sm,power.draw,temperature.gpu")


def device_record(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes), "power_limit": power_limit()}
