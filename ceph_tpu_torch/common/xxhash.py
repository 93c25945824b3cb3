"""xxHash32/64 — the reference's bundled fast non-crypto hash.

The port's copy of ``ceph_tpu.common.xxhash``.

Reference parity: the xxhash submodule wired at src/common (BlueStore
csum_type xxhash32/xxhash64, os/bluestore/bluestore_types.h
Checksummer) — reimplemented from the public algorithm spec (XXH32 /
XXH64 round functions), not ported from the vendored C.  The native
module accelerates the bulk loop when built; this pure-Python form is
the portable ground truth the tests pin.
"""

from __future__ import annotations

_P32_1 = 2654435761
_P32_2 = 2246822519
_P32_3 = 3266489917
_P32_4 = 668265263
_P32_5 = 374761393
_M32 = 0xFFFFFFFF

_P64_1 = 11400714785074694791
_P64_2 = 14029467366897019727
_P64_3 = 1609587929392839161
_P64_4 = 9650029242287828579
_P64_5 = 2870177450012600261
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _py_xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P32_1 + _P32_2) & _M32
        v2 = (seed + _P32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P32_1) & _M32
        while i <= n - 16:
            lane = int.from_bytes(data[i:i + 4], "little")
            v1 = (_rotl32((v1 + lane * _P32_2) & _M32, 13) * _P32_1) \
                & _M32
            lane = int.from_bytes(data[i + 4:i + 8], "little")
            v2 = (_rotl32((v2 + lane * _P32_2) & _M32, 13) * _P32_1) \
                & _M32
            lane = int.from_bytes(data[i + 8:i + 12], "little")
            v3 = (_rotl32((v3 + lane * _P32_2) & _M32, 13) * _P32_1) \
                & _M32
            lane = int.from_bytes(data[i + 12:i + 16], "little")
            v4 = (_rotl32((v4 + lane * _P32_2) & _M32, 13) * _P32_1) \
                & _M32
            i += 16
        acc = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
               + _rotl32(v4, 18)) & _M32
    else:
        acc = (seed + _P32_5) & _M32
    acc = (acc + n) & _M32
    while i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        acc = (_rotl32((acc + lane * _P32_3) & _M32, 17) * _P32_4) \
            & _M32
        i += 4
    while i < n:
        acc = (_rotl32((acc + data[i] * _P32_5) & _M32, 11) * _P32_1) \
            & _M32
        i += 1
    acc ^= acc >> 15
    acc = (acc * _P32_2) & _M32
    acc ^= acc >> 13
    acc = (acc * _P32_3) & _M32
    acc ^= acc >> 16
    return acc


def _round64(acc: int, lane: int) -> int:
    return (_rotl64((acc + lane * _P64_2) & _M64, 31) * _P64_1) & _M64


def _merge64(acc: int, val: int) -> int:
    acc ^= _round64(0, val)
    return (acc * _P64_1 + _P64_4) & _M64


def _py_xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P64_1 + _P64_2) & _M64
        v2 = (seed + _P64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P64_1) & _M64
        while i <= n - 32:
            v1 = _round64(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = _round64(v2,
                          int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = _round64(v3,
                          int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = _round64(v4,
                          int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        acc = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
               + _rotl64(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            acc = _merge64(acc, v)
    else:
        acc = (seed + _P64_5) & _M64
    acc = (acc + n) & _M64
    while i <= n - 8:
        acc ^= _round64(0, int.from_bytes(data[i:i + 8], "little"))
        acc = (_rotl64(acc, 27) * _P64_1 + _P64_4) & _M64
        i += 8
    if i <= n - 4:
        acc ^= (int.from_bytes(data[i:i + 4], "little") * _P64_1) \
            & _M64
        acc = (_rotl64(acc, 23) * _P64_2 + _P64_3) & _M64
        i += 4
    while i < n:
        acc ^= (data[i] * _P64_5) & _M64
        acc = (_rotl64(acc, 11) * _P64_1) & _M64
        i += 1
    acc ^= acc >> 33
    acc = (acc * _P64_2) & _M64
    acc ^= acc >> 29
    acc = (acc * _P64_3) & _M64
    acc ^= acc >> 32
    return acc


def xxh32(data: bytes, seed: int = 0) -> int:
    """Native C when built (~GB/s), pure-python ground truth
    otherwise (~5 MB/s — fine for tests, not for a data-path csum)."""
    from ceph_tpu_torch import native
    if native.available():
        return native.xxh32(data, seed)
    return _py_xxh32(data, seed)


def xxh64(data: bytes, seed: int = 0) -> int:
    from ceph_tpu_torch import native
    if native.available():
        return native.xxh64(data, seed)
    return _py_xxh64(data, seed)
