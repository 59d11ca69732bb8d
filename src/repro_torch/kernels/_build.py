"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` with a plain C interface, then linked into one
shared library that ``ctypes`` loads.  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so the first call after a change rebuilds and later
calls reuse it.  Nothing is built at import time: the first kernel launch
builds.

``-fmad=false`` keeps every ``a*b+c`` as two roundings, as the plain
PyTorch versions and the JAX reference compute it.

Each kernel wrapper adds one to ``launches[<kernel>]`` where it launches
its kernel and nowhere else, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()

_lib = None


def reset_launches():
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out = library_path()
    if out.exists():
        return out
    work = out.parent / (out.stem + f".tmp{os.getpid()}")
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, _obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _src, obj, _p in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def bind(name: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(rc: int, kernel: str):
    """Raise on the ``cudaGetLastError()`` a C entry point returned."""
    if rc:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc}: {msg}")


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t, name: str, dtype, ndim: int, device):
    """Wrapper-side checks before a pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
