"""ctypes bindings and lazy build of the native preprocessing library.

Counterpart of `lanedetection_end2end_tpu/data/native.py`, on the port's
copy of the C++ source (`native/laneops.cpp`): the PIL-equivalent
triangle-filter ("bilinear") resize fused with the normalization to
[0, 1], the nearest-neighbour mask resize, and the uint8 -> float32
normalize with an optional mirror. The library is built with g++ on first
use into the package's ignored `_build/` directory (named by a hash of the
source and the flags), never beside the source. A failed build raises: the
port has no other resampler to turn to.

ctypes calls release the GIL, so the loader's decode threads scale across
cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SRC = PKG / "native" / "laneops.cpp"
BUILD_DIR = PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
             "-std=c++17")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liblaneops_{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("g++ failed to build the native "
                               f"preprocessing library:\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resample_to_f32.argtypes = [u8p] + [ctypes.c_int] * 3 + [f32p] + \
        [ctypes.c_int] * 3
    lib.resample_to_f32.restype = None
    lib.resize_nearest_u8.argtypes = [u8p] + [ctypes.c_int] * 2 + [u8p] + \
        [ctypes.c_int] * 3
    lib.resize_nearest_u8.restype = None
    lib.u8_to_unit_f32.argtypes = [u8p] + [ctypes.c_int] * 3 + [f32p,
                                                                ctypes.c_int]
    lib.u8_to_unit_f32.restype = None
    return lib


def _get() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build()
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample_to_f32(src: np.ndarray, dh: int, dw: int,
                    flip: bool = False) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1], PIL-BILINEAR-equivalent."""
    lib = _get()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    sh, sw, ch = src.shape
    out = np.empty((dh, dw, ch), dtype=np.float32)
    lib.resample_to_f32(_u8(src), sh, sw, ch, _f32(out), dh, dw, int(flip))
    return out


def u8_to_unit_f32(src: np.ndarray, flip: bool = False) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1], optionally mirrored."""
    lib = _get()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    h, w, ch = src.shape
    out = np.empty((h, w, ch), dtype=np.float32)
    lib.u8_to_unit_f32(_u8(src), h, w, ch, _f32(out), int(flip))
    return out


def resize_nearest_u8(src: np.ndarray, dh: int, dw: int,
                      flip: bool = False) -> np.ndarray:
    """uint8 HW -> uint8 HW nearest-neighbour resize (the mask path)."""
    lib = _get()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    sh, sw = src.shape
    out = np.empty((dh, dw), dtype=np.uint8)
    lib.resize_nearest_u8(_u8(src), sh, sw, _u8(out), dh, dw, int(flip))
    return out
