"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, keyed by a
hash of the source and the compiler flags, so an edited source is rebuilt
and a stale library is never loaded.  The compile writes a temporary file
that is renamed into place under an ``fcntl`` lock: concurrent processes
(test workers, several scripts) either build once or load the finished
library, never a half-written one.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float       # compile time; 0.0 when a finished library was loaded
    log: str             # nvcc/ptxas output (registers, spills) of the compile


_LOADED: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds, log = 0.0, ""
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                t0 = time.perf_counter()
                try:
                    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                       capture_output=True, text=True)
                    if r.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {src}:\n"
                                           f"{r.stdout}{r.stderr}")
                    os.rename(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                seconds = time.perf_counter() - t0
                log = r.stdout + r.stderr
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    built = Built(lib=ctypes.CDLL(out), path=out, seconds=seconds, log=log)
    _LOADED[name] = built
    return built
