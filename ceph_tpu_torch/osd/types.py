"""Core placement types: pg ids, pools, object locators.

Reference parity: osd/osd_types.{h,cc} (pg_t, spg_t, pg_pool_t with
pg_num masks and pps mapping) and include/rados.h (ceph_stable_mod).
The placement math here is bit-exact vs the reference: stable-mod PG
binning, HASHPSPOOL pps mixing via crush_hash32_2, rjenkins object-name
hashing with the 0x1f namespace separator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.crush.hashfn import ceph_str_hash_rjenkins, hash32_2

NO_SHARD = -1

# pool types (osd_types.h pg_pool_t TYPE_*)
POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

# pool flags
FLAG_HASHPSPOOL = 1
#: mon-managed: pool usage exceeds its quota — writes fail EDQUOT
#: (osd_types.h FLAG_FULL_QUOTA role)
FLAG_FULL_QUOTA = 2

# osd state bits (include/rados.h CEPH_OSD_*)
OSD_EXISTS = 1
OSD_UP = 2

OSD_IN_WEIGHT = 0x10000                # CEPH_OSD_IN
DEFAULT_PRIMARY_AFFINITY = 0x10000     # CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
MAX_PRIMARY_AFFINITY = 0x10000


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """include/rados.h:84 — stable hash binning under pg_num growth."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def _cbits(v: int) -> int:
    return v.bit_length()


class PGId(Encodable):
    """pg_t / spg_t: (pool, seed[, shard])."""

    __slots__ = ("pool", "seed", "shard")

    def __init__(self, pool: int, seed: int, shard: int = NO_SHARD):
        self.pool = pool
        self.seed = seed
        self.shard = shard

    def without_shard(self) -> "PGId":
        return PGId(self.pool, self.seed)

    def with_shard(self, shard: int) -> "PGId":
        return PGId(self.pool, self.seed, shard)

    def encode_payload(self, enc: Encoder) -> None:
        enc.s64(self.pool).u32(self.seed).s32(self.shard)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "PGId":
        return cls(dec.s64(), dec.u32(), dec.s32())

    @classmethod
    def parse(cls, s: str) -> "PGId":
        # "<pool>.<seed-hex>" or "<pool>.<seed-hex>s<shard>"
        pool_s, _, rest = s.partition(".")
        if "s" in rest:
            seed_s, _, shard_s = rest.partition("s")
            return cls(int(pool_s), int(seed_s, 16), int(shard_s))
        return cls(int(pool_s), int(rest, 16))

    def __str__(self):
        s = f"{self.pool}.{self.seed:x}"
        if self.shard != NO_SHARD:
            s += f"s{self.shard}"
        return s

    def __repr__(self):
        return f"PGId({self})"

    def __hash__(self):
        return hash((self.pool, self.seed, self.shard))

    def __eq__(self, other):
        return (isinstance(other, PGId) and self.pool == other.pool
                and self.seed == other.seed and self.shard == other.shard)

    def __lt__(self, other):
        return ((self.pool, self.seed, self.shard)
                < (other.pool, other.seed, other.shard))


class ObjectLocator(Encodable):
    """object_locator_t: pool + optional key/namespace/hash override."""

    __slots__ = ("pool", "key", "namespace", "hash_pos")

    def __init__(self, pool: int, key: str = "", namespace: str = "",
                 hash_pos: int = -1):
        self.pool = pool
        self.key = key
        self.namespace = namespace
        self.hash_pos = hash_pos

    def encode_payload(self, enc: Encoder) -> None:
        enc.s64(self.pool).string(self.key).string(self.namespace)
        enc.s64(self.hash_pos)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "ObjectLocator":
        return cls(dec.s64(), dec.string(), dec.string(), dec.s64())


class PGPool(Encodable):
    """pg_pool_t: per-pool placement + redundancy parameters + pool
    snapshots (snap_seq/snaps/removed_snaps — osd_types.h pg_pool_t
    snap state; v2) + cache tiering linkage (tier_of/read_tier/
    write_tier/cache_mode/hit-set + agent targets — osd_types.h
    pg_pool_t:1230-1234; v3) + pool quotas (quota_max_bytes/objects —
    osd_types.h pg_pool_t quota fields; v4)."""

    STRUCT_V = 4

    def __init__(self, type_: int = POOL_TYPE_REPLICATED, size: int = 3,
                 min_size: int = 0, crush_ruleset: int = 0,
                 pg_num: int = 8, pgp_num: int = 0,
                 flags: int = FLAG_HASHPSPOOL, ec_profile: str = "",
                 stripe_width: int = 0):
        self.type = type_
        self.size = size
        self.min_size = min_size or (size - size // 2)
        self.crush_ruleset = crush_ruleset
        self.pg_num = pg_num
        self.pgp_num = pgp_num or pg_num
        self.flags = flags
        self.ec_profile = ec_profile     # EC profile name (mon-managed)
        self.stripe_width = stripe_width  # bytes per full EC stripe
        self.snap_seq = 0
        self.last_change = 0             # epoch of last modification
        self.snaps: Dict[int, str] = {}  # snapid -> name (pool snaps)
        self.removed_snaps: List[int] = []   # await osd trim
        # cache tiering (pg_pool_t tier linkage)
        self.tiers: List[int] = []       # pools that tier in front of us
        self.tier_of = -1                # pool we are a cache for
        self.read_tier = -1              # overlay: reads route here
        self.write_tier = -1             # overlay: writes route here
        self.cache_mode = "none"         # none|writeback|readonly
        self.hit_set_count = 4           # retained hit sets
        self.hit_set_period = 30.0       # seconds per hit set
        self.hit_set_fpp = 0.05          # bloom false-positive rate
        self.target_max_objects = 0      # agent: object budget (0=off)
        self.cache_target_dirty_ratio = 0.4
        self.cache_target_full_ratio = 0.8
        # pool quotas (0 = unlimited); the mon flips FLAG_FULL_QUOTA
        # when PGMap usage crosses them
        self.quota_max_bytes = 0
        self.quota_max_objects = 0

    def is_tier(self) -> bool:
        return self.tier_of >= 0

    def has_tiers(self) -> bool:
        return bool(self.tiers)

    # -- masks (osd_types.cc:1193 calc_pg_masks) --
    @property
    def pg_num_mask(self) -> int:
        return (1 << _cbits(self.pg_num - 1)) - 1

    @property
    def pgp_num_mask(self) -> int:
        return (1 << _cbits(self.pgp_num - 1)) - 1

    def is_replicated(self) -> bool:
        return self.type == POOL_TYPE_REPLICATED

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def can_shift_osds(self) -> bool:
        # replicated sets compact around gaps; EC is positional
        return self.is_replicated()

    # -- placement math --
    def hash_key(self, key: str, namespace: str = "") -> int:
        """pg_pool_t::hash_key — rjenkins over ns + 0x1f + key."""
        if not namespace:
            return ceph_str_hash_rjenkins(key.encode("utf-8"))
        buf = (namespace.encode("utf-8") + b"\x1f" + key.encode("utf-8"))
        return ceph_str_hash_rjenkins(buf)

    def raw_pg_to_pg(self, pg: PGId) -> PGId:
        return PGId(pg.pool,
                    ceph_stable_mod(pg.seed, self.pg_num, self.pg_num_mask),
                    pg.shard)

    def raw_pg_to_pps(self, pg: PGId) -> int:
        """osd_types.cc:1341 — pool-mixed placement seed."""
        if self.flags & FLAG_HASHPSPOOL:
            return hash32_2(
                ceph_stable_mod(pg.seed, self.pgp_num, self.pgp_num_mask),
                pg.pool & 0xFFFFFFFF)
        return (ceph_stable_mod(pg.seed, self.pgp_num, self.pgp_num_mask)
                + pg.pool)

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.type).u32(self.size).u32(self.min_size)
        enc.s32(self.crush_ruleset).u32(self.pg_num).u32(self.pgp_num)
        enc.u32(self.flags).string(self.ec_profile)
        enc.u32(self.stripe_width).u64(self.snap_seq)
        enc.u32(self.last_change)
        enc.map_(self.snaps, lambda e, k: e.u64(k),
                 lambda e, v: e.string(v))
        enc.list_(self.removed_snaps, lambda e, v: e.u64(v))
        enc.list_(self.tiers, lambda e, v: e.s64(v))
        enc.s64(self.tier_of).s64(self.read_tier).s64(self.write_tier)
        enc.string(self.cache_mode)
        enc.u32(self.hit_set_count).f64(self.hit_set_period)
        enc.f64(self.hit_set_fpp)
        enc.u64(self.target_max_objects)
        enc.f64(self.cache_target_dirty_ratio)
        enc.f64(self.cache_target_full_ratio)
        enc.u64(self.quota_max_bytes).u64(self.quota_max_objects)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "PGPool":
        p = cls(dec.u8(), dec.u32(), dec.u32(), dec.s32(), dec.u32(),
                dec.u32(), dec.u32(), dec.string(), dec.u32())
        p.snap_seq = dec.u64()
        p.last_change = dec.u32()
        if struct_v >= 2:
            p.snaps = dec.map_(lambda d: d.u64(), lambda d: d.string())
            p.removed_snaps = dec.list_(lambda d: d.u64())
        if struct_v >= 3:
            p.tiers = dec.list_(lambda d: d.s64())
            p.tier_of = dec.s64()
            p.read_tier = dec.s64()
            p.write_tier = dec.s64()
            p.cache_mode = dec.string()
            p.hit_set_count = dec.u32()
            p.hit_set_period = dec.f64()
            p.hit_set_fpp = dec.f64()
            p.target_max_objects = dec.u64()
            p.cache_target_dirty_ratio = dec.f64()
            p.cache_target_full_ratio = dec.f64()
        if struct_v >= 4:
            p.quota_max_bytes = dec.u64()
            p.quota_max_objects = dec.u64()
        return p


class OSDInfo(Encodable):
    """osd_info_t: liveness epochs used by peering.  v2 adds lost_at —
    the epoch an operator declared the osd's data unrecoverable
    (`osd lost`), which unblocks PriorSet waits (osd_types.h
    osd_info_t::lost_at)."""

    STRUCT_V = 2

    __slots__ = ("up_from", "up_thru", "down_at", "last_clean_begin",
                 "last_clean_end", "lost_at")

    def __init__(self, up_from: int = 0, up_thru: int = 0, down_at: int = 0,
                 last_clean_begin: int = 0, last_clean_end: int = 0,
                 lost_at: int = 0):
        self.up_from = up_from
        self.up_thru = up_thru
        self.down_at = down_at
        self.last_clean_begin = last_clean_begin
        self.last_clean_end = last_clean_end
        self.lost_at = lost_at

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.up_from).u32(self.up_thru).u32(self.down_at)
        enc.u32(self.last_clean_begin).u32(self.last_clean_end)
        enc.u32(self.lost_at)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "OSDInfo":
        o = cls(dec.u32(), dec.u32(), dec.u32(), dec.u32(), dec.u32())
        if struct_v >= 2:
            o.lost_at = dec.u32()
        return o
