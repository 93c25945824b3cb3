"""crc32c (Castagnoli) with native dispatch.

The port's copy of ``ceph_tpu.common.crc``.

Reference parity: common/crc32c.h — the digest used for chunk/object
integrity (ECBackend hash info, scrub compares).  Uses the native
slicing-by-8 kernel (ceph_tpu_torch/native/src/native.cc) when built; a table fallback
keeps pure-python environments working with identical digests.
"""

from __future__ import annotations

_TABLE = None


def _table():
    global _TABLE
    if _TABLE is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            t.append(c)
        _TABLE = t
    return _TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    from ceph_tpu_torch import native
    if native.available():
        return native.crc32c(bytes(data), crc)
    t = _table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
