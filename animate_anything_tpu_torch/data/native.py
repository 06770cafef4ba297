"""ctypes bindings for the native host helpers (``data/motionkit.cpp``) — the
port of ``animate_anything_tpu/data/native.py``.

The shared library is built at first use with the host compiler (``c++``,
JAX's flags) into ``build/motionkit/`` of the checkout, named by the
source's hash. As in JAX, every entry point returns None when it cannot be
built or loaded, and
``metrics/motion.py`` then takes its numpy route: the helper only keeps the
per-sample mask and score work off the training path's critical time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "motionkit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "motionkit"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmotionkit_{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["c++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
                            "-o", str(tmp), str(SOURCE)], capture_output=True, timeout=120,
                           check=True)
            tmp.replace(path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.moved_area_mask.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.motion_score.restype = ctypes.c_int64
    lib.motion_score.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.resize_bilinear_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def moved_area_mask(frames: np.ndarray, move_th: float = 5.0,
                    area_th: int = 0) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, np.uint8)
    f, h, w, _ = frames.shape
    out = np.zeros((h, w), np.uint8)
    lib.moved_area_mask(_u8ptr(frames), f, h, w, ctypes.c_float(move_th), int(area_th),
                        _u8ptr(out))
    return out


def motion_score(frames: np.ndarray) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, np.uint8)
    f, h, w, _ = frames.shape
    return int(lib.motion_score(_u8ptr(frames), f, h, w))


def resize_bilinear(frame: np.ndarray, oh: int, ow: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    frame = np.ascontiguousarray(frame, np.uint8)
    h, w, _ = frame.shape
    out = np.zeros((oh, ow, 3), np.uint8)
    lib.resize_bilinear_u8(_u8ptr(frame), h, w, _u8ptr(out), oh, ow)
    return out
