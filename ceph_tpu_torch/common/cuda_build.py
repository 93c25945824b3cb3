"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source, ``ceph_tpu_torch/csrc/<name>.cu``, with a
plain C interface.  It is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``ceph_tpu_torch/_build/`` at first use and
loaded with ``ctypes``.  The library's file name carries a hash of the
source and the flags, so an edited source builds anew and an unchanged
one loads the library already built.  Nothing here runs at import: the
tests import every module on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """A loaded kernel library and how it was built."""
    name: str
    lib: ctypes.CDLL
    path: str             # the shared library's file
    seconds: float        # nvcc wall time; 0.0 when an earlier build was loaded
    ptxas: str            # nvcc's -Xptxas -v report (registers, shared memory)


_lock = threading.Lock()                  # guards the two dicts below
_name_locks: Dict[str, threading.Lock] = {}
_built: Dict[str, Built] = {}


def nvcc_path() -> str:
    """``nvcc`` from CUDA_HOME / CUDA_PATH, else from PATH, else the
    toolkit's usual install location."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(name: str) -> Built:
    """Compile (once per process and source) and load ``csrc/<name>.cu``.
    Builds of different sources may run at the same time (one nvcc
    each, from separate threads); one source builds once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _built:
            return _built[name]
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        log = path + ".log"
        seconds = 0.0
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            with open(log, "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        with open(log) as f:
            ptxas = f.read()
        built = Built(name, ctypes.CDLL(path), path, seconds, ptxas)
        with _lock:
            _built[name] = built
        return built
