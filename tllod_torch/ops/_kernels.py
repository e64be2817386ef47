"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, under ``build/tllod_torch_kernels/`` at the
repository root, on first use; the library name carries a hash of the
source and flags, so an edited source is rebuilt. Libraries are loaded with
``ctypes``: pointers and the stream go in as ``c_void_p``, sizes as
``c_int``, and every exported launcher returns the ``cudaError_t`` of its
launch, which :func:`check` turns into an exception.

:func:`build_all` starts one ``nvcc`` per source at once and waits for all,
so the build takes as long as the slowest file.

``launches`` counts kernel launches by wrapper name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tllod_torch_kernels")

# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# where its plain PyTorch version does (the NMS keep decisions compare an
# IoU against a threshold and must not move by an ulp).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("roi_align", "nms", "roi_pool", "roi_crop")

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every source not yet built, all at once; returns seconds.
    Processes that build at once (the ranks of a process group) take
    turns on a file lock in the build directory, so one runs ``nvcc`` and
    the others find its libraries."""
    import fcntl

    t0 = time.time()
    if all(os.path.exists(_lib_path(n)) for n in names):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_missing(names)
    return time.time() - t0


def _build_missing(names: Iterable[str]) -> None:
    jobs = []
    try:
        for name in names:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            with open(out[:-3] + ".log", "w") as log:
                proc = subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                     os.path.join(CSRC, name + ".cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((proc, name, tmp, out))
        for proc, name, tmp, out in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                                   f"{build_log(name)}")
            os.replace(tmp, out)
    finally:
        for proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build_log(name: str) -> str:
    """What nvcc and ptxas said (registers, shared memory, spills)."""
    path = _lib_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            lib.tllod_error_string.restype = ctypes.c_char_p
            lib.tllod_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        msg = lib.tllod_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({status}): {msg}")
