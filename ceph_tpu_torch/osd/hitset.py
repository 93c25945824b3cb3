"""HitSet: compact recent-access sets for cache tiering.

Reference parity: osd/HitSet.h (TYPE_BLOOM via common/bloom_filter.hpp,
TYPE_EXPLICIT_OBJECT for small sets) and ReplicatedPG hit_set_create/
hit_set_persist.  The tier agent and the promote policy consult these
to separate hot objects (recently hit) from cold ones.

Redesign notes: the bloom filter is a numpy bit array with k hash
probes derived from two independent 32-bit jenkins hashes (the standard
double-hashing construction h1 + i*h2 — same math the reference's
compressible bloom filter uses); insert/contains are vectorizable over
object batches, which is how the agent sweeps whole PG object lists in
one shot instead of per-object python loops.

The port's copy of ``ceph_tpu.osd.hitset``.
"""

from __future__ import annotations

import math
from typing import Iterable, List

import numpy as np

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.crush.hashfn import np_hash32_2

TYPE_BLOOM = 3


def _oid_hashes(oids) -> np.ndarray:
    """Two independent 32-bit hashes per oid: [N, 2] uint32."""
    import zlib
    arr = np.asarray([(zlib.crc32(o.encode()) & 0xFFFFFFFF)
                      for o in oids], np.uint32)
    h1 = np_hash32_2(arr, np.uint32(0x9E3779B9))
    h2 = np_hash32_2(arr, np.uint32(0x85EBCA6B)) | np.uint32(1)
    return np.stack([h1, h2], axis=1)


class BloomHitSet(Encodable):
    """Sealed-size bloom filter (HitSet::Impl TYPE_BLOOM)."""

    STRUCT_V = 1

    def __init__(self, target_size: int = 1024, fpp: float = 0.05):
        target_size = max(16, int(target_size))
        # standard sizing: m = -n ln p / (ln 2)^2, k = m/n ln 2
        m = int(-target_size * math.log(max(min(fpp, 0.5), 1e-9))
                / (math.log(2) ** 2))
        self.nbits = max(64, 1 << (m - 1).bit_length())   # pow2 mask
        self.k = max(1, round(m / target_size * math.log(2)))
        self.bits = np.zeros(self.nbits // 8, np.uint8)
        self.count = 0

    # -- single + batched inserts/queries --
    def insert(self, oid: str) -> None:
        self.insert_many([oid])

    def insert_many(self, oids: Iterable[str]) -> None:
        oids = list(oids)
        if not oids:
            return
        idx = self._probe_indices(oids)            # [N, k]
        np.bitwise_or.at(self.bits, idx >> 3,
                         np.uint8(1) << (idx & 7).astype(np.uint8))
        self.count += len(oids)

    def contains(self, oid: str) -> bool:
        return bool(self.contains_many([oid])[0])

    def contains_many(self, oids: List[str]) -> np.ndarray:
        if not oids:
            return np.zeros(0, bool)
        idx = self._probe_indices(oids)
        hit = (self.bits[idx >> 3]
               >> (idx & 7).astype(np.uint8)) & 1
        return hit.all(axis=1).astype(bool)

    def _probe_indices(self, oids: List[str]) -> np.ndarray:
        h = _oid_hashes(oids).astype(np.uint64)    # [N, 2]
        i = np.arange(self.k, dtype=np.uint64)
        probes = (h[:, 0:1] + i[None, :] * h[:, 1:2]) \
            & np.uint64(self.nbits - 1)
        return probes.astype(np.int64)

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(TYPE_BLOOM).u32(self.nbits).u32(self.k)
        enc.u64(self.count).bytes_(self.bits.tobytes())

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "BloomHitSet":
        t = dec.u8()
        if t != TYPE_BLOOM:
            raise ValueError(f"unknown hitset type {t}")
        hs = cls.__new__(cls)
        hs.nbits = dec.u32()
        hs.k = dec.u32()
        hs.count = dec.u64()
        hs.bits = np.frombuffer(dec.bytes_(), np.uint8).copy()
        return hs


class HitSetTracker:
    """Rotating window of hit sets for one PG (ReplicatedPG
    hit_set_create/hit_set_trim): the current open set takes inserts;
    `archive` holds the last `count-1` sealed sets.  `contains` answers
    "was this object hit recently?" across the whole window."""

    def __init__(self, count: int = 4, target_size: int = 1024,
                 fpp: float = 0.05):
        self.count = max(1, count)
        self.target_size = target_size
        self.fpp = fpp
        self.current = BloomHitSet(target_size, fpp)
        self.archive: List[BloomHitSet] = []

    def insert(self, oid: str) -> None:
        self.current.insert(oid)

    def rotate(self) -> None:
        self.archive.insert(0, self.current)
        del self.archive[self.count - 1:]
        self.current = BloomHitSet(self.target_size, self.fpp)

    def contains(self, oid: str) -> bool:
        return bool(self.contains_many([oid])[0])

    def contains_many(self, oids: List[str]) -> np.ndarray:
        if not oids:
            return np.zeros(0, bool)
        hit = self.current.contains_many(oids)
        for hs in self.archive:
            hit = hit | hs.contains_many(oids)
        return hit
