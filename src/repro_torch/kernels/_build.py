"""Build and load the port's hand-written CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
named by a hash of its sources and flags, under ``build/repro_torch/``
at the repository root (listed in ``.gitignore``), and loaded with
``ctypes``. Building happens at first use (or all at once, in parallel,
through :func:`build_all`); importing this module builds nothing, so
the CPU tests import every module freely. A failed build raises — no
kernel ever falls back to its plain torch version.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`StageContext.launch
<repro_torch.axe.program.StageContext.launch>` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("matmul", "rmsnorm", "flash_attention", "moe_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: dtype codes of the C entries (csrc/common.cuh, ``repro::DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64,
           "f": ctypes.c_float}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ``ptxas`` resource report (registers, shared memory, spills) of each
#: library this process built, keyed by source name
BUILD_LOG: Dict[str, str] = {}


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise BuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "built only where the CUDA toolkit is installed"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, target) or
    None when the library for these sources is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    BUILD_LOG[name] = out
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all() -> float:
    """Build every kernel library, one ``nvcc`` per source, all started
    together; returns the seconds it took (~0 when all were built)."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in SOURCES if n not in _libs}
        for n, s in started.items():
            _finish(n, s)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                _finish(name, _start(name))
                lib = ctypes.CDLL(str(_target(name)))
                lib.error_string.argtypes = [ctypes.c_int]
                lib.error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def function(name: str, symbol: str, signature: str) -> Callable[..., int]:
    """One C entry of library ``name`` with its ctypes argument types
    declared from ``signature`` (one code per argument: ``p`` pointer or
    stream, ``i`` int32, ``l`` int64, ``f`` float); it returns the int
    CUDA error code of its launch."""
    fn = getattr(library(name), symbol)
    fn.argtypes = [_CTYPES[c] for c in signature]
    fn.restype = ctypes.c_int
    return fn


def error_string(name: str, code: int) -> str:
    return library(name).error_string(code).decode()
