"""Object/collection identity types for the store layer (the port's
copy of ``ceph_tpu.store.types``).

Reference parity: hobject_t/ghobject_t and coll_t (osd/osd_types.h,
common/hobject.h) — objects are addressed by (pool, namespace, name, key,
snap, hash) and live in collections (PGs or meta).  Redesigned: plain
frozen dataclass-style Encodables; the 32-bit placement hash is computed
once from (key or name) with the same rjenkins string hash the placement
layer uses, so store-level ordering matches placement ordering.
"""

from __future__ import annotations

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.crush.hashfn import ceph_str_hash_rjenkins

# snapid sentinels (include/rados.h)
SNAP_HEAD = 2**64 - 2      # CEPH_NOSNAP: the writable head object
SNAP_DIR = 2**64 - 1       # CEPH_SNAPDIR: virtual snapshot dir


class ObjectId(Encodable):
    """ghobject_t analog: fully-qualified object name.

    ``hash32`` drives PG placement and collection sort order (reference
    sorts objects bitwise-reversed by hash for split/backfill scans).
    """

    __slots__ = ("name", "key", "namespace", "pool", "snap", "hash32",
                 "shard", "generation")

    def __init__(self, name: str, key: str = "", namespace: str = "",
                 pool: int = -1, snap: int = SNAP_HEAD,
                 shard: int = -1, generation: int = 0):
        self.name = name
        self.key = key
        self.namespace = namespace
        self.pool = pool
        self.snap = snap
        self.shard = shard            # EC shard id, -1 = NO_SHARD
        self.generation = generation  # EC rollback generation
        self.hash32 = ceph_str_hash_rjenkins(
            (key or name).encode("utf-8")) & 0xFFFFFFFF

    # bitwise-reversed hash: reference's collection sort key
    # (hobject_t::get_bitwise_key, common/hobject.h)
    @property
    def reversed_hash(self) -> int:
        h, r = self.hash32, 0
        for _ in range(32):
            r = (r << 1) | (h & 1)
            h >>= 1
        return r

    def sort_key(self):
        # total order over ALL identity fields (ghobject_t comparison:
        # shard, pool, bitwise hash, nspace, key, name, snap, generation) —
        # two unequal ids must never compare equal, or listing pagination
        # with a start cursor would skip one of them.
        return (self.shard, self.pool, self.reversed_hash, self.namespace,
                self.key or self.name, self.name, self.snap,
                self.generation)

    def with_snap(self, snap: int) -> "ObjectId":
        return ObjectId(self.name, self.key, self.namespace, self.pool,
                        snap, self.shard, self.generation)

    def is_head(self) -> bool:
        return self.snap == SNAP_HEAD

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.name).string(self.key).string(self.namespace)
        enc.s64(self.pool).u64(self.snap)
        enc.s32(self.shard).u64(self.generation)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "ObjectId":
        name, key, ns = dec.string(), dec.string(), dec.string()
        pool, snap = dec.s64(), dec.u64()
        shard, gen = dec.s32(), dec.u64()
        return cls(name, key, ns, pool, snap, shard, gen)

    def __hash__(self):
        return hash((self.name, self.key, self.namespace, self.pool,
                     self.snap, self.shard, self.generation))

    def __eq__(self, other):
        return (isinstance(other, ObjectId)
                and self.name == other.name and self.key == other.key
                and self.namespace == other.namespace
                and self.pool == other.pool and self.snap == other.snap
                and self.shard == other.shard
                and self.generation == other.generation)

    def __lt__(self, other):
        return self.sort_key() < other.sort_key()

    def __repr__(self):
        s = f"{self.pool}:{self.namespace}/{self.name}"
        if self.snap != SNAP_HEAD:
            s += f"@{self.snap}"
        if self.shard >= 0:
            s += f"(s{self.shard})"
        return s


class CollectionId(Encodable):
    """coll_t analog: either a PG collection ("<pool>.<pgid>s<shard>") or a
    named meta collection."""

    __slots__ = ("name",)

    TYPE_META = 0
    TYPE_PG = 1

    def __init__(self, name: str):
        self.name = name

    @classmethod
    def meta(cls) -> "CollectionId":
        return cls("meta")

    @classmethod
    def pg(cls, pool: int, seed: int, shard: int = -1) -> "CollectionId":
        s = f"{pool}.{seed:x}"
        if shard >= 0:
            s += f"s{shard}"
        return cls(s + "_head")

    def is_pg(self) -> bool:
        return self.name.endswith("_head")

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.name)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "CollectionId":
        return cls(dec.string())

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, CollectionId) and self.name == other.name

    def __lt__(self, other):
        return self.name < other.name

    def __repr__(self):
        return f"coll({self.name})"
