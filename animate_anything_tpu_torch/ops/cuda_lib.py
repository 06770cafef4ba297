"""Build and load the port's hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, bound with ``ctypes``. The build happens at
first use, into ``build/torch_kernels/`` at the repository root, and is
redone whenever the sources' hash changes. Nothing here runs at import time:
the CPU tests import every module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, b, sq, sk, heads, d, scale, exp2_scale, stream
    "aat_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # q, k, v, o, dout, lse, rows, qhat, dq, dk, dv, b, sq, sk, heads, d, scale, stream
    "aat_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _P],
    # x, ln_s, ln_b, w1, b1, w2, b2, y, ln, act, n, c, cs, eps, bn1, stages1, grid1, smem1,
    # bn2, stages2, grid2, smem2, gate_row0, stream
    "aat_ln_geglu": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _P],
    # x, a, b, w, bias, res, y, s1, s2, part, tickets, bsz, f, s, cin, cout, bn, stages, grid,
    # smem, stream
    "aat_tap_conv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P],
    # h, w, bias, res, y, s1, s2, part, tickets, n, s, k, c, bn, stages, grid, smem, stream
    "aat_proj_residual": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # x, ln_s, ln_b, wq, wk, wv, wo, bo, ln, o, y, b, f, s, c, heads, eps, L, stages, grid,
    # smem, bn_out, stages_out, grid_out, smem_out, stream
    "aat_temporal_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, work, tickets, s1, s2, n, s, c, ct, threads, chunks, rows, stream
    "aat_channel_sums": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, r, y, work, tickets, s1, s2, n, s, c, ct, threads, chunks, rows, stream
    "aat_add_stats": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, scale, bias, work, bar, y, n, s, c, groups, pieces, ring, grid, smem, eps, silu, stream
    "aat_group_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, a, b, w (packed), bias, res, act, y, n, h, w, cin, cout, silu, bn, stages, grid,
    # smem, stream
    "aat_spatial_conv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    # q, k, v, o, b, f, s, heads, d, L, HB, stages, warps, grid, smem, stream
    "aat_temporal_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, ln_s, ln_b, wq, wk, wv, q, k, v, stats, n, c, hd, eps, qscale, bn, stages, grid, smem,
    # stream
    "aat_ln_qkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I,
                   _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libaat_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is missing:
    one ``nvcc -c`` per source, all started together, then one link. The
    ptxas report (registers, shared memory, spills) lands beside the library
    as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    compile_flags = [fl for fl in NVCC_FLAGS if fl != "-shared"]
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode})")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *[str(o) for o, _ in jobs]],
                              capture_output=True, text=True, check=False)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{log[-8000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            sizes = ctypes.POINTER(ctypes.c_longlong)
            lib.aat_slab_sums_sizes.argtypes = [_I, _I, _I, _I, sizes, sizes]
            lib.aat_slab_sums_sizes.restype = None
            lib.aat_error_string.argtypes = [ctypes.c_int]
            lib.aat_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Launch ``name`` on the current stream; raise if the launch failed."""
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.aat_error_string(err).decode()}")


@functools.lru_cache(maxsize=None)
def slab_sums_sizes(slabs: int, s: int, n: int, chunks: int) -> tuple[int, int]:
    """The fp32 elements of kernels 3 and 4's sums scratch and the ints of
    its tickets, for ``slabs`` slabs of s rows and n columns in ``chunks``
    output chunks, from the library (``csrc/gemm.cuh``'s
    ``slab_sums_sizes``, the layout's one owner)."""
    part, tickets = ctypes.c_longlong(), ctypes.c_longlong()
    library().aat_slab_sums_sizes(slabs, s, n, chunks, ctypes.byref(part), ctypes.byref(tickets))
    return part.value, tickets.value


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once: the launch
    plans ask on every call)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 32:  # TMA maps and vector loads need 16-byte alignment; held to 32
        raise ValueError(f"{name}: data pointer is not 32-byte aligned")
