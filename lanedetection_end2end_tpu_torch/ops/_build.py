"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, loaded through ctypes. The
libraries go to `_build/` beside the package (listed in .gitignore), named
by a hash of their sources and flags, so an edited source rebuilds and an
unchanged one is reused. `build()` starts one nvcc per missing library, all
at once. Nothing is built or loaded at import time: the wrappers call
`kernel()` on their first launch.
"""

from __future__ import annotations

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
           "packed_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns {name: compiler log} for the ones built;
    raises with the logs if any compile fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
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
def _library(name: str) -> ctypes.CDLL:
    path = _target(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))


_VP, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel(name: str, symbol: str, signature: str):
    """The C entry `symbol` of library `name`; `signature` spells the
    arguments, 'p' for a pointer or the stream, 'i' for an int."""
    fn = getattr(_library(name), symbol)
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


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape=None,
               name: str = "tensor") -> int:
    """Validate what a kernel takes; returns the data pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        hint = ""
        if dtype == torch.bfloat16 and t.dtype == torch.float32:
            hint = (": this kernel takes bfloat16 planes; the float32 "
                    "instantiation is not written yet for the fused "
                    "training kernels K6-K10 (nb_half_a, nb_half_b, "
                    "downsampler_op, lane_maps_op, head_rowsums_op). To "
                    "train in float32 on the card pass fused_blocks=False "
                    "(K11 packed_conv_act and channel_sums take float32), "
                    "or use compute_dtype='bfloat16'")
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}{hint}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    return t.data_ptr()
