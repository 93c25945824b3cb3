"""The port's native host library (ceph_tpu_torch/native) against the JAX
package's.

``tests/test_native.py``'s six cases run on the port; ``gf_matrix_apply``
is held both ways (GFNI/AVX-512 where the host has it, and the scalar
table sweep) against both packages' ``gf256.host_apply``; the straw2
draws against the port's numpy draw; the digests against the reference's
pure-Python ``crc`` and ``xxhash``.  Wherever ``g++`` is on the PATH the
library must build: the tests assert ``available()`` and skip only on a
host without a compiler.  Every result is an integer: no tolerance.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ceph_tpu.common import crc as ref_crc
from ceph_tpu.common import xxhash as ref_xxhash
from ceph_tpu.crush.hashfn import hash32_3 as ref_hash32_3
from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu_torch import native
from ceph_tpu_torch.common import crc, xxhash
from ceph_tpu_torch.crush.hashfn import hash32_3
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ops import crush_kernel as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native library cannot build")
    assert native.available(), native.build_info
    return native


def test_builds_into_the_build_directory(lib):
    path = lib.build_info["path"]
    assert path == lib.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "ceph_tpu_torch",
                                                 "_build")
    # the name carries a hash of the source, the flags and the host CPU
    assert os.path.basename(path).startswith("libceph_tpu_native-")
    # nothing is written beside the package's own sources
    assert not [f for f in os.listdir(os.path.dirname(native.SRC))
                if f.endswith(".so")]
    assert not [f for f in os.listdir(os.path.dirname(native.__file__))
                if f.endswith(".so")]


def test_import_builds_nothing():
    code = ("import ceph_tpu_torch.native as n, ceph_tpu_torch.ops."
            "crush_kernel as ck, ceph_tpu_torch.osd.ec_queue\n"
            "assert n._lib is None and not n._tried, 'built at import'\n"
            "assert ck._native_mod is None\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_crc32c_check_vectors(lib):
    assert lib.crc32c(b"123456789") == 0xE3069283
    assert lib.crc32c(b"") == 0
    whole = lib.crc32c(b"hello world")
    assert whole == lib.crc32c(b" world", lib.crc32c(b"hello"))
    raw = np.frombuffer(bytes(range(256)) * 3, np.uint8)
    c_lib = lib._load()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for off in range(1, 9):
        view = raw[off:]
        aligned = view.copy()
        assert lib.crc32c(view.tobytes()) == lib.crc32c(aligned.tobytes())
        # the C pointer-alignment head loop, through an offset view
        got = c_lib.ceph_crc32c(0, view.ctypes.data_as(u8p), view.size)
        assert got == lib.crc32c(aligned.tobytes())


def test_rjenkins_matches_python(lib):
    rng = np.random.default_rng(0)
    for _ in range(100):
        a, b, c = (int(x) for x in rng.integers(0, 2**32, 3))
        assert lib.rjenkins3(a, b, c) == hash32_3(a, b, c) \
            == ref_hash32_3(a, b, c)


def test_rjenkins_batch_matches_scalar(lib):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, 64, dtype=np.uint32)
    out = lib.rjenkins3_batch(a, 7, 123456)
    assert out.dtype == np.uint32
    for i in range(a.size):
        assert out[i] == hash32_3(int(a[i]), 7, 123456)


@pytest.mark.parametrize("force_scalar", [False, True],
                         ids=["dispatch", "scalar"])
def test_gf_matrix_apply_matches_both_host_applies(lib, force_scalar):
    rng = np.random.default_rng(1)
    for (r, k, L) in [(1, 2, 64), (4, 8, 1000), (2, 3, 7), (4, 8, 1 << 16),
                      (3, 5, 63), (2, 8, 100001)]:
        mat = rng.integers(0, 256, (r, k)).astype(np.uint8)
        chunks = rng.integers(0, 256, (k, L)).astype(np.uint8)
        got = lib.gf_matrix_apply(mat, chunks, force_scalar=force_scalar)
        assert np.array_equal(got, gf256.host_apply(mat, chunks)), (r, k, L)
        assert np.array_equal(got, ref_gf256.host_apply(mat, chunks))


def test_gf_simd_matches_scalar(lib):
    # the GFNI/AVX-512 kernel (when the host has it) against the table
    # sweep, the scalar tail included
    if not lib.gf_simd_available():
        pytest.skip("no GFNI/AVX-512 on this host")
    rng = np.random.default_rng(2)
    for (r, k, L) in [(4, 8, 1 << 16), (2, 8, 100001), (3, 5, 63)]:
        mat = rng.integers(0, 256, (r, k)).astype(np.uint8)
        chunks = rng.integers(0, 256, (k, L)).astype(np.uint8)
        got = lib.gf_matrix_apply(mat, chunks)
        want = lib.gf_matrix_apply(mat, chunks, force_scalar=True)
        assert np.array_equal(got, want), (r, k, L)


def test_gf_matrix_apply_rejects_mismatched_shapes(lib):
    with pytest.raises(ValueError):
        lib.gf_matrix_apply(np.ones((2, 3), np.uint8),
                            np.ones((4, 8), np.uint8))


def test_region_xor(lib):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, 1000).astype(np.uint8)
    b = rng.integers(0, 256, 1000).astype(np.uint8)
    assert np.array_equal(lib.region_xor(a, b), a ^ b)


def test_first_use_from_many_threads_agrees():
    """The library's lazy tables and GFNI self-check are shared state; the
    loader runs them under its lock, so threads that race into the first
    call in a fresh process all get the scalar's answer."""
    code = (
        "import threading, numpy as np\n"
        "from ceph_tpu_torch import native\n"
        "from ceph_tpu_torch.ec import gf256\n"
        "rng = np.random.default_rng(5)\n"
        "mat = rng.integers(0, 256, (4, 8), dtype=np.uint8)\n"
        "ch = rng.integers(0, 256, (8, 70000), dtype=np.uint8)\n"
        "want = gf256.host_apply(mat, ch)\n"
        "res = [None] * 16\n"
        "def go(i):\n"
        "    res[i] = (native.gf_matrix_apply(mat, ch),\n"
        "              native.crc32c(b'123456789'))\n"
        "ts = [threading.Thread(target=go, args=(i,)) for i in range(16)]\n"
        "[t.start() for t in ts]\n"
        "[t.join(60) for t in ts]\n"
        "assert not any(t.is_alive() for t in ts)\n"
        "assert all(np.array_equal(r[0], want) and r[1] == 0xE3069283\n"
        "           for r in res), 'a racing first call disagreed'\n")
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native library cannot build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr


DATA = [b"", b"a", b"abc", b"123456789", bytes(range(256)) * 3,
        np.random.default_rng(4).integers(0, 256, 1031,
                                          dtype=np.uint8).tobytes()]


@pytest.mark.parametrize("idx", range(len(DATA)))
def test_digests_match_the_pure_python_reference(lib, monkeypatch, idx):
    data = DATA[idx]
    # the reference's pure-Python forms: its native library switched off
    import ceph_tpu.native as ref_native
    monkeypatch.setattr(ref_native, "available", lambda: False)
    for seed in (0, 1, 0x9E3779B1):
        assert lib.xxh32(data, seed) == ref_xxhash.xxh32(data, seed) \
            == ref_xxhash._py_xxh32(data, seed)
        assert lib.xxh64(data, seed) == ref_xxhash.xxh64(data, seed) \
            == ref_xxhash._py_xxh64(data, seed)
        assert lib.crc32c(data, seed) == ref_crc.crc32c(data, seed)
        # the port's callers: native dispatch, then their own fallback
        assert xxhash.xxh32(data, seed) == lib.xxh32(data, seed)
        assert xxhash.xxh64(data, seed) == lib.xxh64(data, seed)
        assert crc.crc32c(data, seed) == lib.crc32c(data, seed)
    monkeypatch.setattr(native, "available", lambda: False)
    for seed in (0, 7):
        assert xxhash.xxh32(data, seed) == ref_xxhash._py_xxh32(data, seed)
        assert xxhash.xxh64(data, seed) == ref_xxhash._py_xxh64(data, seed)
        assert crc.crc32c(data, seed) == ref_crc.crc32c(data, seed)


def _numpy_draw(monkeypatch, *args):
    monkeypatch.setattr(ck, "_native_mod", False)
    return ck._straw2_draw(*args)


@pytest.mark.parametrize("n_items", [1, 3, 128])
def test_straw2_draws_match_the_numpy_draw(lib, monkeypatch, n_items):
    rng = np.random.default_rng(n_items)
    X = 5000                           # past the library's omp threshold
    xs = rng.integers(0, 2**32, X, dtype=np.int64)
    rs = rng.integers(0, 8, X, dtype=np.int64)
    items = rng.integers(0, 1 << 20, n_items, dtype=np.int64)
    weights = rng.integers(0, 0x30000, n_items, dtype=np.int64)
    weights[rng.random(n_items) < 0.2] = 0
    ln = ck._ln()
    # one bucket shared by every lane
    want = _numpy_draw(monkeypatch, items, weights, xs, rs)
    assert np.array_equal(lib.straw2_winner_shared(items, weights, xs, rs,
                                                   ln), want)
    # a row per lane: the rows kernel, and the indexed kernel over a table
    table_items = rng.integers(0, 1 << 20, (7, n_items), dtype=np.int64)
    table_w = rng.integers(0, 0x30000, (7, n_items), dtype=np.int64)
    table_w[rng.random((7, n_items)) < 0.2] = 0
    table_w[3] = 0                     # an all-zero row picks index 0
    rows = rng.integers(0, 7, X, dtype=np.int64)
    want = _numpy_draw(monkeypatch, table_items[rows], table_w[rows], xs,
                       rs)
    assert np.array_equal(lib.straw2_winner_rows(
        table_items[rows], table_w[rows], xs, rs, ln), want)
    got = lib.straw2_winner_rows_indexed(
        table_items.astype(np.int32), table_w, rows, xs, rs, ln)
    assert np.array_equal(got, table_items[rows, want])
    with pytest.raises(ValueError):
        lib.straw2_winner_rows_indexed(table_items.astype(np.int32),
                                       table_w, rows + 7, xs, rs, ln)
