"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

One ``nvcc`` per source in ``csrc/``, all started together, compiles each
for ``sm_90a``; one more links the objects into one shared library with a
plain C interface, under ``build/kernels/`` at the root of the checkout.
:func:`load` opens it with ``ctypes``. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing here runs at import time: the CPU tests import every
module of the package on a machine with no ``nvcc``.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``, and returns ``cudaGetLastError()``.

Worker threads (``ClusterRuntime.run_parallel(threads=True)``) may reach
their first launch together: :func:`load` builds and opens the library
once under a lock, and :func:`count_launch` bumps the wrappers' launch
counts under another.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "libra_selective_copy": [_P] * 7 + [_I] * 6 + [_P],
    "libra_selective_gather": [_P] * 5 + [_I] * 4 + [_P],
    "libra_policy_match": [_P] * 10 + [_I] * 5 + [_P],
    "libra_fused_round": [_P] * 15 + [_I] * 9 + [_P],
    "libra_paged_attention": [_P] * 8 + [_I] * 7 + [_P],
    "libra_flash_attention": [_P] * 4 + [_I] * 8 + [_P],
    "libra_mlstm_scan": [_P] * 9 + [_I] * 4 + [_P],
    "libra_ktls_attention": [_P] * 4 + [_I] * 6 + [_P],
    "libra_ktls_dequant": [_P] * 3 + [_I] * 2 + [_P],
    "libra_linear_f32": [_P] * 3 + [_I] * 3 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdatapath_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into one shared library (skipped when the
    library for these sources already exists), one ``nvcc`` process per
    source, all running at once. Raises on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(tmp) / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
            jobs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, report = [], []
        for name, _obj, proc in jobs:     # wait for every compiler
            log, _ = proc.communicate()
            report.append(f"== {name}\n{log}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = str(Path(tmp) / out.name)
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib,
                              *(obj for _n, obj, _p in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:   # ptxas register / spill report
            print("".join(report), file=sys.stderr)
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The datapath kernels' library, built on first call."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
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


def count_launch(counts: dict, name: str) -> None:
    """Add one to ``counts[name]``, exact when several threads launch."""
    with _COUNT_LOCK:
        counts[name] += 1


def reset_counts(counts: dict) -> None:
    """Set every launch count of ``counts`` to 0."""
    with _COUNT_LOCK:
        for k in counts:
            counts[k] = 0


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().libra_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def launch(name: str, dev, *args) -> None:
    """Call the C entry point ``libra_<name>`` with ``args`` and ``dev``'s
    current stream, and raise if the launch was refused."""
    fn = getattr(load(), f"libra_{name}")
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, name)


def check_tensor(name: str, t: Optional[torch.Tensor],
                 shape: Optional[Sequence[int]] = None, *,
                 dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape``, on ``device``, where given). ``None`` passes: an absent
    optional operand."""
    if t is None:
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
