"""Robert Jenkins 32-bit integer mix hash, CRUSH flavor.

Reference parity: crush/hash.c:12-90 (crush_hashmix / crush_hash32_N,
seed 1315423911).  Two implementations share one algorithm description:
a scalar python-int version (host mapper) and a numpy-vectorized version
(batch verification + table generation); the batched engines of
ops/crush_kernel.py (numpy, plain torch, and the CUDA kernels of
csrc/crush_map.cu) are required to stay bit-equal to these.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
HASH_SEED = 1315423911


def _mix(a: int, b: int, c: int):
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 13
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 8)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 13
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 12
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 16)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 5
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 3
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 10)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 15
    return a, b, c


def hash32(a: int) -> int:
    a &= M32
    h = HASH_SEED ^ a
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash32_2(a: int, b: int) -> int:
    a &= M32; b &= M32
    h = HASH_SEED ^ a ^ b
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a: int, b: int, c: int) -> int:
    a &= M32; b &= M32; c &= M32
    h = HASH_SEED ^ a ^ b ^ c
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32
    h = HASH_SEED ^ a ^ b ^ c ^ d
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32; e &= M32
    h = HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


# ---------------------------------------------------------------------------
# numpy-vectorized (arrays of uint32, broadcasting)

def _np_mix(a, b, c):
    a = (a - b); a = (a - c); a = a ^ (c >> np.uint32(13))
    b = (b - c); b = (b - a); b = b ^ (a << np.uint32(8))
    c = (c - a); c = (c - b); c = c ^ (b >> np.uint32(13))
    a = (a - b); a = (a - c); a = a ^ (c >> np.uint32(12))
    b = (b - c); b = (b - a); b = b ^ (a << np.uint32(16))
    c = (c - a); c = (c - b); c = c ^ (b >> np.uint32(5))
    a = (a - b); a = (a - c); a = a ^ (c >> np.uint32(3))
    b = (b - c); b = (b - a); b = b ^ (a << np.uint32(10))
    c = (c - a); c = (c - b); c = c ^ (b >> np.uint32(15))
    return a, b, c


def np_hash32_3(a, b, c):
    a = np.asarray(a, np.uint32); b = np.asarray(b, np.uint32)
    c = np.asarray(c, np.uint32)
    h = np.uint32(HASH_SEED) ^ a ^ b ^ c
    x = np.full_like(h, 231232); y = np.full_like(h, 1232)
    a, b, h = _np_mix(a, b, h)
    c, x, h = _np_mix(c, x, h)
    y, a, h = _np_mix(y, a, h)
    b, x, h = _np_mix(b, x, h)
    y, c, h = _np_mix(y, c, h)
    return h


def np_hash32_2(a, b):
    a = np.asarray(a, np.uint32); b = np.asarray(b, np.uint32)
    h = np.uint32(HASH_SEED) ^ a ^ b
    x = np.full_like(h, 231232); y = np.full_like(h, 1232)
    a, b, h = _np_mix(a, b, h)
    x, a, h = _np_mix(x, a, h)
    b, y, h = _np_mix(b, y, h)
    return h


def ceph_str_hash_rjenkins(data: bytes) -> int:
    """Jenkins string hash for object-name -> placement seed.

    Reference parity: common/ceph_hash.cc ceph_str_hash_rjenkins — golden
    ratio init, 12-byte mixing blocks, length folded into c.  Bit-exact.
    """
    length = len(data)
    a = b = 0x9E3779B9
    c = 0
    k = 0
    rem = length
    while rem >= 12:
        a = (a + (data[k] | data[k+1] << 8 | data[k+2] << 16
                  | data[k+3] << 24)) & M32
        b = (b + (data[k+4] | data[k+5] << 8 | data[k+6] << 16
                  | data[k+7] << 24)) & M32
        c = (c + (data[k+8] | data[k+9] << 8 | data[k+10] << 16
                  | data[k+11] << 24)) & M32
        a, b, c = _mix(a, b, c)
        k += 12
        rem -= 12
    c = (c + length) & M32
    # trailing bytes; first byte of c is reserved for the length
    for idx, sh in ((10, 24), (9, 16), (8, 8)):
        if rem >= idx + 1:
            c = (c + (data[k + idx] << sh)) & M32
    for idx, sh in ((7, 24), (6, 16), (5, 8), (4, 0)):
        if rem >= idx + 1:
            b = (b + (data[k + idx] << sh)) & M32
    for idx, sh in ((3, 24), (2, 16), (1, 8), (0, 0)):
        if rem >= idx + 1:
            a = (a + (data[k + idx] << sh)) & M32
    a, b, c = _mix(a, b, c)
    return c
