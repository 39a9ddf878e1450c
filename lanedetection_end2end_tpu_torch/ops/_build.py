"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, loaded through ctypes. The
libraries go to `_build/` beside the package (listed in .gitignore), named
by a hash of their sources and flags, so an edited source rebuilds and an
unchanged one is reused. `build()` starts one nvcc per missing library, all
at once. Nothing is built or loaded at import time: the wrappers call
`kernel()` on their first launch.

A debug variant is built only on request, into its own subdirectory of
`_build/` with its own flags (VARIANTS): "defer" compiles the cp.async
helpers of `csrc/tc_common.cuh` with -DLD_DEFER_CP_ASYNC, so a copy's data
lands only at its group's wait and a stage read before it reads NaN.
`with variant("defer"):` makes the wrappers' `kernel()` lookups load that
build; outside it they load the normal one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("nb1d", "downsampler", "upsampler", "head_rowsums",
           "nb_half_fwd", "nb_half_bwd", "channel_sums", "downsampler_op",
           "lane_maps_op", "head_rowsums_op", "nb1d_chain", "wls_moments",
           "packed_conv", "encoder_fused", "decoder_fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# debug variants: name -> the flags added to NVCC_FLAGS
VARIANTS = {"defer": ("-DLD_DEFER_CP_ASYNC",)}
_variant = None  # the variant `kernel()` loads; None: the normal build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _flags(variant=None) -> tuple:
    return NVCC_FLAGS + (VARIANTS[variant] if variant else ())


def _target(name: str, variant=None) -> Path:
    h = hashlib.sha256(" ".join(_flags(variant)).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    where = BUILD_DIR / variant if variant else BUILD_DIR
    return where / f"lib{name}_{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path, variant=None) -> list:
    """The nvcc command line that builds library `name` of `variant`."""
    return [_nvcc(), *_flags(variant), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Sequence[str] = SOURCES, variant=None) -> Dict[str, str]:
    """Compile every missing library of `variant` (None: the normal
    build), one nvcc process per source, all started together. Returns
    {name: compiler log} for the ones built; raises with the logs if any
    compile fails."""
    if variant is not None and variant not in VARIANTS:
        raise KeyError(f"unknown build variant {variant!r}")
    jobs = {}
    for name in names:
        out = _target(name, variant)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        jobs[name] = (subprocess.Popen(nvcc_command(name, tmp, variant),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def _library(name: str, variant=None) -> ctypes.CDLL:
    path = _target(name, variant)
    if not path.exists():
        build([name], variant)
    return ctypes.CDLL(str(path))


@contextlib.contextmanager
def variant(name):
    """Within the block, `kernel()` loads the libraries of build variant
    `name` (a key of VARIANTS; None: the normal build)."""
    global _variant
    if name is not None and name not in VARIANTS:
        raise KeyError(f"unknown build variant {name!r}")
    before, _variant = _variant, name
    try:
        yield
    finally:
        _variant = before


_VP, _INT = ctypes.c_void_p, ctypes.c_int


def kernel(name: str, symbol: str, signature: str):
    """The C entry `symbol` of library `name` in the current build variant;
    `signature` spells the arguments, 'p' for a pointer or the stream, 'i'
    for an int."""
    return _entry(name, symbol, signature, _variant)


@functools.lru_cache(maxsize=None)
def _entry(name: str, symbol: str, signature: str, variant):
    fn = getattr(_library(name, variant), symbol)
    fn.argtypes = [_VP if ch == "p" else _INT for ch in signature]
    fn.restype = _INT
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """Call a C entry on `device`'s current stream (appended to `args`) and
    raise on a non-zero cudaGetLastError()."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


# the C entry suffix of a kernel that takes planes of either dtype
PLANE_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32"}


def plane_symbol(symbol: str, dtype: torch.dtype) -> str:
    """The C entry of a training kernel for planes of `dtype`: `symbol`
    for bfloat16, `symbol + '_f32'` for float32; TypeError for any other
    dtype."""
    if dtype not in PLANE_SUFFIX:
        raise TypeError(f"{symbol}: the kernel takes bfloat16 or float32 "
                        f"planes, got {dtype}")
    return symbol + PLANE_SUFFIX[dtype]


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape=None,
               name: str = "tensor") -> int:
    """Validate what a kernel takes; returns the data pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    return t.data_ptr()
