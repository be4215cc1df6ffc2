"""Build and load the datapath kernels (``csrc/*.cu``) at first use.

One ``nvcc`` call compiles every source in ``csrc/`` for ``sm_90a`` into one
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout; :func:`load` opens it with ``ctypes``. The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time:
the CPU tests import every module of the package on a machine with no
``nvcc``.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``, and returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "libra_selective_copy": [_P] * 7 + [_I] * 6 + [_P],
    "libra_selective_gather": [_P] * 5 + [_I] * 4 + [_P],
    "libra_policy_match": [_P] * 10 + [_I] * 5 + [_P],
    "libra_fused_round": [_P] * 15 + [_I] * 8 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA datapath kernels are "
                           "built from csrc/ at first use and need the CUDA "
                           "toolkit")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdatapath_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into one shared library (skipped when the
    library for these sources already exists). Raises on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    if verbose:   # ptxas register / spill report
        print(res.stdout + res.stderr, file=sys.stderr)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The datapath kernels' library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.libra_error_string.argtypes = [ctypes.c_int]
        lib.libra_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().libra_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
