"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own, for ``sm_90a``, into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries land in ``kernels/_build/`` under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  Nothing is built at import: the first
CUDA call of a wrapper builds its library, and ``build_all`` builds every
library at once, one nvcc process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("pq_adc", "ternary_refine")

# --fmad=false: no a*b+c contraction, so the per-candidate arithmetic rounds
# like the plain PyTorch version's separate elementwise ops.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        _finish(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of ``csrc/<name>.cu`` with its argument types set
    (every pointer and the stream as ``c_void_p``, so none is cut to 32
    bits); it returns the launch's ``cudaGetLastError()``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch (a
    refused launch never runs, and a later synchronize would not say so)."""
    if status != 0:
        err = load(name).fatrq_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{err(status).decode()} ({status})")


def ptr(t) -> int | None:
    """Device address of a tensor for a ``c_void_p`` argument (None → NULL)."""
    return None if t is None else t.data_ptr()


def require(name: str, t, *, dtype, shape: tuple, device) -> None:
    """Check what a kernel takes: dtype, shape, device and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
