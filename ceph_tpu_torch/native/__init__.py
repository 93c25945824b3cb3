"""ctypes bindings for the native host kernels (src/native.cc).

The port's copy of ``ceph_tpu.native``, with the same public functions
and the same contract: every caller tolerates ``available() == False``
(no C++ compiler on the host) and then takes its numpy or pure-Python
path, which gives the same results.  These are host kernels, not device
kernels: the EC batch queue's small lone requests
(``osd/ec_queue.py``), the CRUSH host engine's straw2 draws
(``ops/crush_kernel.py``) and the digests of ``common/crc.py`` and
``common/xxhash.py``.

The library is built lazily, on the first ``available()`` or call, never
at import: ``g++ -O3 -march=native -fopenmp -shared -fPIC`` into
``ceph_tpu_torch/_build/``.  Its file name carries a hash of the source,
the flags and the host CPU's model and flags (``-march=native`` code may
not run on another CPU), so an edited source or another host builds
anew and an unchanged one loads the library already built.  Nothing is
written into the package's own directories and nothing prebuilt is
shipped.

The library initialises its GF(2^8) and crc32c tables and its GFNI
self-check on first use, in shared state that two Python threads could
enter together (ctypes releases the GIL).  The loader runs those first
uses itself, under its lock, before it publishes the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "src", "native.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: how the library came to be loaded: its path, the g++ wall time (0.0
#: when an earlier build was loaded) and g++'s message when it failed
build_info = {"path": None, "seconds": 0.0, "error": None}


def _host_cpu() -> str:
    """The host CPU's model name and feature flags, as -march=native
    sees them (the first processor's lines of /proc/cpuinfo)."""
    seen = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in seen:
                    seen[key] = val.strip()
                if len(seen) == 2:
                    break
    except OSError:
        pass
    return f"{platform.machine()} {seen.get('model name')} {seen.get('flags')}"


def library_path() -> str:
    """Where the library for this source, these flags and this host CPU
    is (or would be) built."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS).encode()
            + _host_cpu().encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libceph_tpu_native-{digest}.so")


def _build(path: str) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        build_info["error"] = "g++ not found"
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_info["error"] = f"g++ did not run: {e}"
        return False
    build_info["seconds"] = time.perf_counter() - t0
    if proc.returncode != 0:
        build_info["error"] = (f"g++ exit {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        return False
    # another process may have built the same file meanwhile: the
    # rename replaces it with identical bytes
    os.replace(tmp, path)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _tried = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            build_info["error"] = f"cannot load {path}: {e}"
            _tried = True
            return None
        build_info["path"] = path
        bound = _bind(lib)
        _tried = True
        return bound


def _bind(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    global _lib
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    try:
        lib.ceph_crc32c.restype = ctypes.c_uint32
        lib.ceph_crc32c.argtypes = [ctypes.c_uint32, u8p, ctypes.c_uint64]
        lib.ceph_rjenkins3.restype = ctypes.c_uint32
        lib.ceph_rjenkins3.argtypes = [ctypes.c_uint32] * 3
        lib.ceph_rjenkins3_batch.restype = None
        lib.ceph_rjenkins3_batch.argtypes = [
            u32p, ctypes.c_uint32, ctypes.c_uint32, u32p, ctypes.c_uint64]
        lib.ceph_gf_matrix_apply.restype = None
        lib.ceph_gf_matrix_apply.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_uint64]
        lib.ceph_gf_matrix_apply_scalar.restype = None
        lib.ceph_gf_matrix_apply_scalar.argtypes = \
            lib.ceph_gf_matrix_apply.argtypes
        lib.ceph_gf_simd_available.restype = ctypes.c_int
        lib.ceph_gf_simd_available.argtypes = []
        lib.ceph_region_xor.restype = None
        lib.ceph_region_xor.argtypes = [u8p, u8p, u8p, ctypes.c_uint64]
        lib.ceph_straw2_winner_rows.restype = None
        lib.ceph_straw2_winner_rows.argtypes = [
            i32p, i64p, ctypes.c_int64, ctypes.c_int32, u32p, u32p, i64p,
            i32p]
        lib.ceph_straw2_winner_shared.restype = None
        lib.ceph_straw2_winner_shared.argtypes = [
            i32p, i64p, ctypes.c_int32, u32p, u32p, ctypes.c_int64, i64p,
            i32p]
        lib.ceph_straw2_winner_rows_indexed.restype = None
        lib.ceph_straw2_winner_rows_indexed.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int32, u32p,
            u32p, i64p, i32p]
        lib.ceph_xxh32.restype = ctypes.c_uint32
        lib.ceph_xxh32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.ceph_xxh64.restype = ctypes.c_uint64
        lib.ceph_xxh64.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64]
    except AttributeError as e:
        build_info["error"] = f"library lacks a symbol: {e}"
        return None
    # the lazy first uses, here under the loader's lock and not in two
    # racing callers: crc32c's tables, the GF(2^8) log/exp tables and
    # the GFNI orientation self-check
    one = np.ones(1, np.uint8)
    lib.ceph_crc32c(0, _ptr(one), 0)
    lib.ceph_gf_matrix_apply_scalar(_ptr(one), 1, 1, _ptr(one),
                                    _ptr(np.empty(1, np.uint8)), 1)
    lib.ceph_gf_simd_available()
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built (or was built earlier) and loaded."""
    return _load() is not None


def _require(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native {what} unavailable (check available(): "
                           f"{build_info['error']})")
    return lib


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crc32c(data: bytes, crc: int = 0) -> int:
    """Castagnoli CRC (reference common/crc32c.h semantics)."""
    lib = _require("crc32c")
    buf = np.frombuffer(data, np.uint8)
    return int(lib.ceph_crc32c(crc, _ptr(buf), buf.size))


def xxh32(data: bytes, seed: int = 0) -> int:
    lib = _require("xxh32")
    buf = np.frombuffer(data, np.uint8)
    return int(lib.ceph_xxh32(_ptr(buf), buf.size, seed & 0xFFFFFFFF))


def xxh64(data: bytes, seed: int = 0) -> int:
    lib = _require("xxh64")
    buf = np.frombuffer(data, np.uint8)
    return int(lib.ceph_xxh64(_ptr(buf), buf.size,
                              seed & 0xFFFFFFFFFFFFFFFF))


def rjenkins3(a: int, b: int, c: int) -> int:
    lib = _require("rjenkins3")
    return int(lib.ceph_rjenkins3(a & 0xFFFFFFFF, b & 0xFFFFFFFF,
                                  c & 0xFFFFFFFF))


def rjenkins3_batch(a: np.ndarray, b: int, c: int) -> np.ndarray:
    """Vector hash32_3(a[i], b, c)."""
    lib = _require("rjenkins3_batch")
    a = np.ascontiguousarray(a, np.uint32)
    out = np.empty_like(a)
    lib.ceph_rjenkins3_batch(_ptr(a, ctypes.c_uint32), b & 0xFFFFFFFF,
                             c & 0xFFFFFFFF, _ptr(out, ctypes.c_uint32),
                             a.size)
    return out


def gf_matrix_apply(mat: np.ndarray, chunks: np.ndarray,
                    force_scalar: bool = False) -> np.ndarray:
    """Host GF(2^8) matrix apply: out[r, L] = mat @ chunks.

    Dispatches to the GFNI/AVX-512 kernel when the host supports it (the
    isa-l-class SIMD path); force_scalar pins the jerasure-style table
    sweep for comparison."""
    lib = _require("gf_matrix_apply")
    mat = np.ascontiguousarray(mat, np.uint8)
    chunks = np.ascontiguousarray(chunks, np.uint8)
    if mat.ndim != 2 or chunks.ndim != 2 or chunks.shape[0] != mat.shape[1]:
        raise ValueError(f"gf_matrix_apply: mat {mat.shape} does not "
                         f"apply to chunks {chunks.shape}")
    r, k = mat.shape
    out = np.empty((r, chunks.shape[1]), np.uint8)
    fn = (lib.ceph_gf_matrix_apply_scalar if force_scalar
          else lib.ceph_gf_matrix_apply)
    fn(_ptr(mat), r, k, _ptr(chunks), _ptr(out), chunks.shape[1])
    return out


def gf_simd_available() -> bool:
    """True when gf_matrix_apply runs the GFNI/AVX-512 SIMD kernel."""
    lib = _load()
    return bool(lib is not None and lib.ceph_gf_simd_available())


def region_xor(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _require("region_xor")
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.size != b.size:
        raise ValueError(f"region_xor: sizes {a.size} and {b.size} differ")
    out = np.empty_like(a)
    lib.ceph_region_xor(_ptr(a), _ptr(b), _ptr(out), a.size)
    return out


def _draw_args(xs, rs, ln_tab):
    xs = np.ascontiguousarray(xs, np.uint32)
    rs = np.ascontiguousarray(rs, np.uint32)
    ln_tab = np.ascontiguousarray(ln_tab, np.int64)
    if rs.shape != xs.shape or ln_tab.shape != (65536,):
        raise ValueError(f"straw2: xs {xs.shape}, rs {rs.shape} and "
                         f"ln_tab {ln_tab.shape} (want [65536])")
    return xs, rs, ln_tab


def straw2_winner_rows(items: np.ndarray, weights: np.ndarray,
                       xs: np.ndarray, rs: np.ndarray,
                       ln_tab: np.ndarray) -> np.ndarray:
    """Row-wise batched straw2 argmax (the CRUSH host engine's draw,
    ops/crush_kernel.py).  items/weights [X, I], xs/rs [X], ln_tab
    [65536] int64 -> winning index [X]."""
    lib = _require("straw2_winner_rows")
    items = np.ascontiguousarray(items, np.int32)
    weights = np.ascontiguousarray(weights, np.int64)
    xs, rs, ln_tab = _draw_args(xs, rs, ln_tab)
    X, I = items.shape
    if weights.shape != items.shape or xs.shape != (X,):
        raise ValueError(f"straw2_winner_rows: items {items.shape}, "
                         f"weights {weights.shape}, xs {xs.shape}")
    out = np.empty(X, np.int32)
    lib.ceph_straw2_winner_rows(
        _ptr(items, ctypes.c_int32), _ptr(weights, ctypes.c_int64), X, I,
        _ptr(xs, ctypes.c_uint32), _ptr(rs, ctypes.c_uint32),
        _ptr(ln_tab, ctypes.c_int64), _ptr(out, ctypes.c_int32))
    return out.astype(np.int64)


def straw2_winner_rows_indexed(items_tab: np.ndarray,
                               weights_tab: np.ndarray,
                               rows: np.ndarray, xs: np.ndarray,
                               rs: np.ndarray,
                               ln_tab: np.ndarray) -> np.ndarray:
    """Level-table straw2 argmax: items/weights [N, I] shared table,
    rows [X] lane->row indices -> chosen ITEM ids [X].  Skips the [X, I]
    gather of the plain rows kernel (the multi-level descent's draw,
    ops/crush_kernel._level_draw)."""
    lib = _require("straw2_winner_rows_indexed")
    items_tab = np.ascontiguousarray(items_tab, np.int32)
    weights_tab = np.ascontiguousarray(weights_tab, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    xs, rs, ln_tab = _draw_args(xs, rs, ln_tab)
    n, I = items_tab.shape
    X = len(rows)
    if (weights_tab.shape != items_tab.shape or xs.shape != (X,)
            or (X and (rows.min() < 0 or rows.max() >= n))):
        raise ValueError(f"straw2_winner_rows_indexed: table "
                         f"{items_tab.shape}, weights {weights_tab.shape}, "
                         f"rows {rows.shape}, xs {xs.shape}")
    out = np.empty(X, np.int32)
    lib.ceph_straw2_winner_rows_indexed(
        _ptr(items_tab, ctypes.c_int32), _ptr(weights_tab, ctypes.c_int64),
        _ptr(rows, ctypes.c_int64), X, I, _ptr(xs, ctypes.c_uint32),
        _ptr(rs, ctypes.c_uint32), _ptr(ln_tab, ctypes.c_int64),
        _ptr(out, ctypes.c_int32))
    return out.astype(np.int64)


def straw2_winner_shared(items: np.ndarray, weights: np.ndarray,
                         xs: np.ndarray, rs: np.ndarray,
                         ln_tab: np.ndarray) -> np.ndarray:
    """Shared-bucket batched straw2 argmax: items/weights [I] drawn by
    every lane (the root bucket), no [X, I] materialisation."""
    lib = _require("straw2_winner_shared")
    items = np.ascontiguousarray(items, np.int32)
    weights = np.ascontiguousarray(weights, np.int64)
    xs, rs, ln_tab = _draw_args(xs, rs, ln_tab)
    if items.ndim != 1 or weights.shape != items.shape:
        raise ValueError(f"straw2_winner_shared: items {items.shape}, "
                         f"weights {weights.shape}")
    out = np.empty(len(xs), np.int32)
    lib.ceph_straw2_winner_shared(
        _ptr(items, ctypes.c_int32), _ptr(weights, ctypes.c_int64),
        items.size, _ptr(xs, ctypes.c_uint32), _ptr(rs, ctypes.c_uint32),
        len(xs), _ptr(ln_tab, ctypes.c_int64), _ptr(out, ctypes.c_int32))
    return out.astype(np.int64)
