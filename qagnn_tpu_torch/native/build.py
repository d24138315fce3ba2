"""Build and load the C++ edge packer, `native/packer.cc`.

Counterpart of qagnn_tpu/native/build.py. The library is compiled on first
use with g++ into `build/native/` at the repository root (listed in
.gitignore), under a file name that carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one reused. The
flags name no host CPU (no `-march=native`), so a build directory carried
to another host still runs there. Processes that build at once each write
a file of their own and move it into place. A failed build raises with
g++'s output: nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "packer.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def target() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpacker.{digest}.so"


def build_library() -> Path:
    """The library's path, compiled first if it is not there yet."""
    out = target()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the edge packer "
                           f"({SOURCE}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_packer() -> ctypes.CDLL:
    """The loaded library, built on first use, with its argument types
    set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            ptrs = ctypes.c_void_p
            lib.pack_edges_rows.argtypes = [
                ptrs, ptrs, ptrs, ptrs, ctypes.c_int64, ctypes.c_int64,
                ptrs, ptrs, ptrs, ptrs]
            lib.pack_edges_rows.restype = ctypes.c_int64
            _LIB = lib
        return _LIB
