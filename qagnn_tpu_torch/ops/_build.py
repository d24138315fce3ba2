"""Build and load the hand-written CUDA kernels of qagnn_tpu_torch/csrc.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with nvcc for sm_90a into its own shared library under `build/kernels/` at
the repository root (listed in .gitignore), then loaded with ctypes. The
library's file name carries a hash of its source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an unchanged
one is reused.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launches; `check` raises when that is
not 0. Launches are counted per kernel in `LAUNCHES` (only where a kernel
is launched, never on the plain path), and for an entry point with more than
one route also per (kernel, route) in `ROUTES`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()
ROUTES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    ROUTES.clear()


def count_launch(kernel: str, route: int | None = None) -> None:
    LAUNCHES[kernel] += 1
    if route is not None:
        ROUTES[kernel, route] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in parts)
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: list[str] | None = None, verbose: bool = False) -> float:
    """Compile every missing library, one nvcc per source, all started
    together. Returns the wall seconds spent. Raises on a failed build."""
    names = sources() if names is None else names
    todo = [n for n in names if not _target(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            continue
        if verbose and out:
            print(out, flush=True)
        os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use, with
    `argtypes` set from `signatures` (entry point -> ctypes types) and an
    int return type for every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def require(t, name: str, dtype, shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape:
    what every kernel takes."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
