"""OSDMap: the epoch-versioned cluster map + placement pipeline.

Reference parity: osd/OSDMap.{h,cc} — osd liveness/weights/addresses,
pools, the CRUSH map, pg_temp/primary_temp overrides, primary affinity,
and the pure placement pipeline `object_locator_to_pg` → `raw_pg_to_pps`
→ `crush do_rule` → `_raw_to_up_osds` → `_apply_primary_affinity` →
`_get_temp_osds` (OSDMap.cc:1470-1739).  Identical math runs in clients
(Objecter), OSDs and the monitor — placement is computed, never looked
up.  Mutation happens only through Incrementals committed by the monitor
(Paxos), exactly like the reference's inc maps.

The port's copy of ``ceph_tpu.osd.osdmap``: the same wire encoding (a map
encoded by either package decodes in the other and re-encodes to the same
bytes) and the same placements.  The batched entries (``prime_pgs``,
``map_objects_batch``, ``map_pgs_batch``) take the CRUSH ``engine``
("device", the default, "host" or "auto") and its ``device`` (default
``cuda``) through to ``ops/crush_kernel.batch_do_rule``.  The scalar
lookup ``pg_to_up_acting_osds`` primes a small pool on the host engine,
as the reference does: it runs on the event loop and must not wait for a
kernel build.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.device import DEFAULT_DEVICE, DeviceLike
from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
from ceph_tpu_torch.crush.hashfn import hash32_2
from ceph_tpu_torch.crush.mapper import do_rule
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.msg.types import EntityAddr
from ceph_tpu_torch.osd.types import (
    DEFAULT_PRIMARY_AFFINITY, MAX_PRIMARY_AFFINITY, OSD_EXISTS, OSD_UP,
    ObjectLocator, OSDInfo, PGId, PGPool,
)

# cluster flags (OSDMap CEPH_OSDMAP_* — `osd set <flag>`)
FLAG_NOOUT = 1           # suppress automatic down->out aging
FLAG_NOSCRUB = 2         # suppress scheduled light scrubs
FLAG_NODEEP_SCRUB = 4    # suppress scheduled deep scrubs
CLUSTER_FLAGS = {"noout": FLAG_NOOUT, "noscrub": FLAG_NOSCRUB,
                 "nodeep-scrub": FLAG_NODEEP_SCRUB}


def flag_names(flags: int) -> List[str]:
    return sorted(n for n, b in CLUSTER_FLAGS.items() if flags & b)


class Incremental(Encodable):
    """OSDMap::Incremental — the delta the monitor commits per epoch."""

    STRUCT_V = 4

    def __init__(self, epoch: int = 0):
        self.epoch = epoch
        self.fsid = ""
        self.new_max_osd = -1
        self.new_pools: Dict[int, PGPool] = {}
        self.new_pool_names: Dict[int, str] = {}
        self.old_pools: List[int] = []
        self.new_up: Dict[int, EntityAddr] = {}       # osd -> addr (boot)
        self.new_state: Dict[int, int] = {}           # osd -> XOR state bits
        self.new_weight: Dict[int, int] = {}
        self.new_primary_affinity: Dict[int, int] = {}
        self.new_up_thru: Dict[int, int] = {}
        self.new_pg_temp: Dict[PGId, List[int]] = {}  # [] = remove
        self.new_primary_temp: Dict[PGId, int] = {}   # -1 = remove
        self.new_crush: Optional[CrushMap] = None
        # name -> {k,m,plugin,...}; reference OSDMap::Incremental
        # new_erasure_code_profiles / old_erasure_code_profiles
        self.new_ec_profiles: Dict[str, Dict[str, str]] = {}
        self.old_ec_profiles: List[str] = []
        # v3: `osd lost` declarations (osd -> epoch of the declaration)
        self.new_lost: Dict[int, int] = {}
        # v4: cluster flag replacement (-1 = unchanged) — `osd set
        # noout` etc. (OSDMap::Incremental new_flags)
        self.new_flags = -1

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.epoch).string(self.fsid).s32(self.new_max_osd)
        enc.map_(self.new_pools, lambda e, k: e.s64(k),
                 lambda e, v: e.struct(v))
        enc.map_(self.new_pool_names, lambda e, k: e.s64(k),
                 lambda e, v: e.string(v))
        enc.list_(self.old_pools, lambda e, v: e.s64(v))
        enc.map_(self.new_up, lambda e, k: e.s32(k), lambda e, v: e.struct(v))
        enc.map_(self.new_state, lambda e, k: e.s32(k), lambda e, v: e.u32(v))
        enc.map_(self.new_weight, lambda e, k: e.s32(k),
                 lambda e, v: e.u32(v))
        enc.map_(self.new_primary_affinity, lambda e, k: e.s32(k),
                 lambda e, v: e.u32(v))
        enc.map_(self.new_up_thru, lambda e, k: e.s32(k),
                 lambda e, v: e.u32(v))
        enc.u32(len(self.new_pg_temp))
        for pg in sorted(self.new_pg_temp):
            enc.struct(pg).list_(self.new_pg_temp[pg],
                                 lambda e, v: e.s32(v))
        enc.u32(len(self.new_primary_temp))
        for pg in sorted(self.new_primary_temp):
            enc.struct(pg).s32(self.new_primary_temp[pg])
        enc.opt_struct(self.new_crush)
        enc.map_(self.new_ec_profiles, lambda e, k: e.string(k),
                 lambda e, v: e.map_(v, lambda e2, k2: e2.string(k2),
                                     lambda e2, v2: e2.string(v2)))
        enc.list_(self.old_ec_profiles, lambda e, v: e.string(v))
        enc.map_(self.new_lost, lambda e, k: e.s32(k), lambda e, v: e.u32(v))
        enc.s32(self.new_flags)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "Incremental":
        inc = cls(dec.u32())
        inc.fsid = dec.string()
        inc.new_max_osd = dec.s32()
        inc.new_pools = dec.map_(lambda d: d.s64(),
                                 lambda d: d.struct(PGPool))
        inc.new_pool_names = dec.map_(lambda d: d.s64(),
                                      lambda d: d.string())
        inc.old_pools = dec.list_(lambda d: d.s64())
        inc.new_up = dec.map_(lambda d: d.s32(),
                              lambda d: d.struct(EntityAddr))
        inc.new_state = dec.map_(lambda d: d.s32(), lambda d: d.u32())
        inc.new_weight = dec.map_(lambda d: d.s32(), lambda d: d.u32())
        inc.new_primary_affinity = dec.map_(lambda d: d.s32(),
                                            lambda d: d.u32())
        inc.new_up_thru = dec.map_(lambda d: d.s32(), lambda d: d.u32())
        for _ in range(dec.u32()):
            pg = dec.struct(PGId)
            inc.new_pg_temp[pg] = dec.list_(lambda d: d.s32())
        for _ in range(dec.u32()):
            pg = dec.struct(PGId)
            inc.new_primary_temp[pg] = dec.s32()
        inc.new_crush = dec.opt_struct(CrushMap)
        if struct_v >= 2:
            inc.new_ec_profiles = dec.map_(
                lambda d: d.string(),
                lambda d: d.map_(lambda d2: d2.string(),
                                 lambda d2: d2.string()))
            inc.old_ec_profiles = dec.list_(lambda d: d.string())
        if struct_v >= 3:
            inc.new_lost = dec.map_(lambda d: d.s32(), lambda d: d.u32())
        if struct_v >= 4:
            inc.new_flags = dec.s32()
        return inc


class OSDMap(Encodable):
    STRUCT_V = 1

    def __init__(self):
        self.epoch = 0
        self.fsid = ""
        self.created = 0.0
        self.modified = 0.0
        self.flags = 0
        self.max_osd = 0
        self.osd_state: List[int] = []
        self.osd_weight: List[int] = []
        self.osd_addrs: List[Optional[EntityAddr]] = []
        self.osd_info: List[OSDInfo] = []
        self.osd_primary_affinity: List[int] = []
        self.pools: Dict[int, PGPool] = {}
        self.pool_names: Dict[int, str] = {}
        self.crush = CrushMap()
        self.pg_temp: Dict[PGId, List[int]] = {}
        self.primary_temp: Dict[PGId, int] = {}
        self.ec_profiles: Dict[str, Dict[str, str]] = {}
        # pg -> (up, up_primary, acting, acting_primary): placements
        # are pure in the map, so one scalar CRUSH walk per pg per
        # epoch suffices — every op on the client/OSD hot path asks
        # (profiled: do_rule dominated e2e writes).  Invalidated by
        # apply_incremental.
        self._acting_cache: Dict[PGId, tuple] = {}
        # pools whose pgs were bulk-primed into the cache this epoch
        self._batch_primed: set = set()

    # ---------------------------------------------------------- osd state
    def set_max_osd(self, n: int) -> None:
        while self.max_osd < n:
            self.osd_state.append(0)
            self.osd_weight.append(0)
            self.osd_addrs.append(None)
            self.osd_info.append(OSDInfo())
            self.osd_primary_affinity.append(DEFAULT_PRIMARY_AFFINITY)
            self.max_osd += 1
        if n < self.max_osd:
            del self.osd_state[n:]
            del self.osd_weight[n:]
            del self.osd_addrs[n:]
            del self.osd_info[n:]
            del self.osd_primary_affinity[n:]
            self.max_osd = n
        self.crush.max_devices = max(self.crush.max_devices, n)

    def exists(self, osd: int) -> bool:
        return (0 <= osd < self.max_osd
                and bool(self.osd_state[osd] & OSD_EXISTS))

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state[osd] & OSD_UP)

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_in(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_weight[osd] > 0

    def is_out(self, osd: int) -> bool:
        return not self.is_in(osd)

    def get_addr(self, osd: int) -> Optional[EntityAddr]:
        return self.osd_addrs[osd] if 0 <= osd < self.max_osd else None

    def get_up_osds(self) -> List[int]:
        return [o for o in range(self.max_osd) if self.is_up(o)]

    def count_up(self) -> int:
        return len(self.get_up_osds())

    def get_up_thru(self, osd: int) -> int:
        return self.osd_info[osd].up_thru if 0 <= osd < self.max_osd else 0

    def get_lost_at(self, osd: int) -> int:
        return self.osd_info[osd].lost_at if 0 <= osd < self.max_osd else 0

    # ------------------------------------------------------------- pools
    def get_pool(self, pool: int) -> Optional[PGPool]:
        return self.pools.get(pool)

    def lookup_pool(self, name: str) -> int:
        for pid, n in self.pool_names.items():
            if n == name:
                return pid
        return -1

    def pg_ids(self, pool: int) -> List[PGId]:
        p = self.pools[pool]
        return [PGId(pool, ps) for ps in range(p.pg_num)]

    # -------------------------------------------------- placement pipeline
    def object_locator_to_pg(self, name: str, loc: ObjectLocator) -> PGId:
        """OSDMap.cc:1470 — raw pg (full-precision seed)."""
        pool = self.pools[loc.pool]
        if loc.hash_pos >= 0:
            ps = loc.hash_pos
        else:
            ps = pool.hash_key(loc.key or name, loc.namespace)
        return PGId(loc.pool, ps)

    def _pg_to_raw_osds(self, pool: PGPool, pg: PGId
                        ) -> Tuple[List[int], int]:
        pps = pool.raw_pg_to_pps(pg)
        ruleno = self.crush.find_rule(pool.crush_ruleset, pool.type,
                                      pool.size)
        osds: List[int] = []
        if ruleno >= 0:
            osds = do_rule(self.crush, ruleno, pps, pool.size,
                           self.osd_weight)
        # remove nonexistent (OSDMap.cc:1504)
        if pool.can_shift_osds():
            osds = [o for o in osds if self.exists(o)]
        else:
            osds = [o if self.exists(o) else CRUSH_ITEM_NONE for o in osds]
        primary = next((o for o in osds if o != CRUSH_ITEM_NONE), -1)
        return osds, primary

    def _raw_to_up_osds(self, pool: PGPool, raw: List[int]
                        ) -> Tuple[List[int], int]:
        if pool.can_shift_osds():
            up = [o for o in raw if self.exists(o) and self.is_up(o)]
            return up, (up[0] if up else -1)
        up = [o if (o != CRUSH_ITEM_NONE and self.is_up(o))
              else CRUSH_ITEM_NONE for o in raw]
        primary = next((o for o in up if o != CRUSH_ITEM_NONE), -1)
        return up, primary

    def _apply_primary_affinity(self, seed: int, pool: PGPool,
                                osds: List[int], primary: int
                                ) -> Tuple[List[int], int]:
        """OSDMap.cc:1584 — proportional pseudo-random primary demotion."""
        if not any(o != CRUSH_ITEM_NONE
                   and self.osd_primary_affinity[o]
                   != DEFAULT_PRIMARY_AFFINITY for o in osds):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = self.osd_primary_affinity[o]
            if (a < MAX_PRIMARY_AFFINITY
                    and (hash32_2(seed, o) >> 16) >= a):
                if pos < 0:
                    pos = i    # fallback if nobody accepts
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [primary] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    def _get_temp_osds(self, pool: PGPool, pg: PGId
                       ) -> Tuple[List[int], int]:
        """OSDMap.cc:1639 — pg_temp/primary_temp overrides."""
        pg = pool.raw_pg_to_pg(pg)
        temp: List[int] = []
        for o in self.pg_temp.get(pg, []):
            if not self.exists(o) or self.is_down(o):
                if pool.can_shift_osds():
                    continue
                temp.append(CRUSH_ITEM_NONE)
            else:
                temp.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1:
            temp_primary = next(
                (o for o in temp if o != CRUSH_ITEM_NONE), -1)
        return temp, temp_primary

    def pg_to_up_acting_osds(self, pg: PGId
                             ) -> Tuple[List[int], int, List[int], int]:
        """OSDMap.cc:1700 _pg_to_up_acting_osds.
        Returns (up, up_primary, acting, acting_primary)."""
        hit = self._acting_cache.get(pg)
        if hit is not None:
            up, up_primary, acting, acting_primary = hit
            return list(up), up_primary, list(acting), acting_primary
        pool = self.pools.get(pg.pool)
        if pool is None:
            return [], -1, [], -1
        raw_pg = pool.raw_pg_to_pg(pg)
        # first touch of a pool this epoch: batch-map the WHOLE pool
        # through the vectorized host engine and prime the cache — a
        # scalar python descent costs ~1ms/pg and dominated the OSD op
        # path profile, while the batched engine amortizes to ~30us/pg
        if pg == raw_pg and pool.pg_num <= 4096 \
                and pg.pool not in self._batch_primed:
            self._batch_primed.add(pg.pool)
            # only prime when the rule actually vectorizes — the
            # batch call's scalar fallback would descend EVERY pg of
            # the pool inline, turning one lookup into a pg_num x 1ms
            # event-loop stall (_prime_batch checks compile_rule)
            if self._prime_batch(pg.pool, self.pg_ids(pg.pool),
                                 "host"):
                hit = self._acting_cache.get(pg)
                if hit is not None:
                    up, up_primary, acting, acting_primary = hit
                    return (list(up), up_primary,
                            list(acting), acting_primary)
        raw, _ = self._pg_to_raw_osds(pool, raw_pg)
        up, up_primary = self._raw_to_up_osds(pool, raw)
        up, up_primary = self._apply_primary_affinity(
            raw_pg.seed, pool, up, up_primary)
        temp, temp_primary = self._get_temp_osds(pool, raw_pg)
        acting = temp if temp else list(up)
        acting_primary = temp_primary if (temp or temp_primary != -1) \
            else up_primary
        self._acting_cache[pg] = (tuple(up), up_primary,
                                  tuple(acting), acting_primary)
        return up, up_primary, acting, acting_primary

    def pg_to_acting_osds(self, pg: PGId) -> Tuple[List[int], int]:
        _, _, acting, primary = self.pg_to_up_acting_osds(pg)
        return acting, primary

    def _finish_mapping(self, pool: PGPool, raw_pg: PGId, raw: List[int]
                        ) -> Tuple[List[int], int, List[int], int]:
        """Everything after the crush call: nonexistent removal, up
        derivation, affinity, temp overrides (shared by the scalar and
        batched paths)."""
        if pool.can_shift_osds():
            raw = [o for o in raw if self.exists(o)]
        else:
            raw = [o if self.exists(o) else CRUSH_ITEM_NONE for o in raw]
        up, up_primary = self._raw_to_up_osds(pool, raw)
        up, up_primary = self._apply_primary_affinity(
            raw_pg.seed, pool, up, up_primary)
        temp, temp_primary = self._get_temp_osds(pool, raw_pg)
        acting = temp if temp else list(up)
        acting_primary = temp_primary if (temp or temp_primary != -1) \
            else up_primary
        return up, up_primary, acting, acting_primary

    def _prime_batch(self, pool_id: int, pgs: List[PGId], engine: str,
                     device: DeviceLike = DEFAULT_DEVICE) -> bool:
        """Compute placements for `pgs` (raw pg ids of ONE pool) in a
        single batched kernel launch and prime _acting_cache.  Returns
        False — and launches nothing — when the pool's rule doesn't
        vectorize; callers then fall back to the scalar per-pg path."""
        from ceph_tpu_torch.ops import crush_kernel
        from ceph_tpu_torch.common import devstats
        pool = self.pools.get(pool_id)
        if pool is None or not pgs:
            return False
        ruleno = self.crush.find_rule(pool.crush_ruleset, pool.type,
                                      pool.size)
        if ruleno < 0 or crush_kernel.compile_rule(self.crush,
                                                   ruleno) is None:
            return False
        pps = [pool.raw_pg_to_pps(pg) for pg in pgs]
        # launch signature deliberately excludes the epoch: steady-state
        # bursts repeat (pool, rule, chunk) so the perf-smoke compile
        # plateau holds while every batch still counts as one launch
        devstats.note_launch("crush_place", (pool_id, ruleno, len(pps)))
        raws = crush_kernel.batch_do_rule(
            self.crush, ruleno, pps, pool.size, self.osd_weight,
            engine=engine, device=device)
        for pg, raw in zip(pgs, raws):
            up, upp, acting, actp = self._finish_mapping(pool, pg, raw)
            self._acting_cache[pg] = (tuple(up), upp, tuple(acting),
                                      actp)
        return True

    def prime_pgs(self, pgs: List[PGId], engine: str = "device",
                  device: DeviceLike = DEFAULT_DEVICE) -> int:
        """Placement for a whole work-list in ONE batched kernel launch
        per pool — the device-seam consumer entry (Objecter cork flush,
        OSD epoch advance, backfill planning).  Dedupes, skips pgs the
        cache already holds, groups the rest per pool.  Returns the
        number of batch launches performed (0 = everything cached or
        nothing vectorizable)."""
        by_pool: Dict[int, List[PGId]] = {}
        for pg in pgs:
            pool = self.pools.get(pg.pool)
            if pool is None:
                continue
            pg = pool.raw_pg_to_pg(pg)
            if pg in self._acting_cache:
                continue
            by_pool.setdefault(pg.pool, []).append(pg)
        launches = 0
        for pool_id, want in by_pool.items():
            if self._prime_batch(pool_id, list(dict.fromkeys(want)),
                                 engine, device):
                launches += 1
        return launches

    def map_objects_batch(self, pool_id: int, names: List[str],
                          engine: str = "device",
                          device: DeviceLike = DEFAULT_DEVICE
                          ) -> List[Tuple[PGId, List[int], int]]:
        """Batched object→placement for a whole object list (backfill
        planning maps a full listing window per pass): hash every name
        to its pg, prime all distinct pgs in one kernel launch, then
        serve from the cache.  Returns [(pg, acting, acting_primary)]
        aligned with `names`."""
        loc = ObjectLocator(pool_id)
        pool = self.pools[pool_id]
        raw = [self.object_locator_to_pg(n, loc) for n in names]
        pgs = [pool.raw_pg_to_pg(r) for r in raw]
        self.prime_pgs(pgs, engine, device)
        out = []
        for pg in pgs:
            acting, primary = self.pg_to_acting_osds(pg)
            out.append((pg, acting, primary))
        return out

    def map_pgs_batch(self, pool_id: int, engine: str = "device",
                      device: DeviceLike = DEFAULT_DEVICE
                      ) -> List[Tuple[PGId, List[int], int, List[int], int]]:
        """Map EVERY pg of a pool in one batched kernel launch
        (osdmaptool --test-map-pgs hot path; the mon's reweight and
        pg_num-growth sweeps; ops/crush_kernel.py).
        Returns [(pg, up, up_primary, acting, acting_primary)].

        The default engine is the device descent on ``device``; call
        warmup_placement() first to keep the kernel build out of the
        call.  engine="auto" never pays a cold build: it takes the device
        only once warmup_placement() has built it."""
        from ceph_tpu_torch.ops import crush_kernel
        from ceph_tpu_torch.common import devstats
        pool = self.pools[pool_id]
        pgs = self.pg_ids(pool_id)
        pps = [pool.raw_pg_to_pps(pg) for pg in pgs]
        ruleno = self.crush.find_rule(pool.crush_ruleset, pool.type,
                                      pool.size)
        if ruleno < 0:
            return [(pg, [], -1, [], -1) for pg in pgs]
        if crush_kernel.compile_rule(self.crush, ruleno) is not None:
            devstats.note_launch("crush_place", (pool_id, ruleno, len(pps)))
        raws = crush_kernel.batch_do_rule(
            self.crush, ruleno, pps, pool.size, self.osd_weight,
            engine=engine, device=device)
        return [(pg,) + self._finish_mapping(pool, pg, raw)
                for pg, raw in zip(pgs, raws)]

    def warmup_placement(self, pool_id: int,
                         device: DeviceLike = DEFAULT_DEVICE) -> bool:
        """Build the device descent for a pool's rule (the kernels'
        library and the topology on ``device``) so that subsequent
        map_pgs_batch(engine="auto") calls can use it without a build
        stall (ops/crush_kernel.warmup)."""
        from ceph_tpu_torch.ops.crush_kernel import warmup
        pool = self.pools[pool_id]
        ruleno = self.crush.find_rule(pool.crush_ruleset, pool.type,
                                      pool.size)
        if ruleno < 0:
            return False
        return warmup(self.crush, ruleno, pool.size, self.osd_weight,
                      device)

    def object_to_acting(self, name: str, loc: ObjectLocator
                         ) -> Tuple[PGId, List[int], int]:
        raw = self.object_locator_to_pg(name, loc)
        pool = self.pools[loc.pool]
        pg = pool.raw_pg_to_pg(raw)
        acting, primary = self.pg_to_acting_osds(pg)
        return pg, acting, primary

    # -------------------------------------------------------- incremental
    def apply_incremental(self, inc: Incremental) -> None:
        assert inc.epoch == self.epoch + 1, \
            f"inc epoch {inc.epoch} != {self.epoch}+1"
        self._acting_cache.clear()
        self._batch_primed.clear()
        self.epoch = inc.epoch
        if inc.fsid:
            self.fsid = inc.fsid
        if inc.new_flags >= 0:
            self.flags = inc.new_flags
        if inc.new_max_osd >= 0:
            self.set_max_osd(inc.new_max_osd)
        for pid in inc.old_pools:
            self.pools.pop(pid, None)
            self.pool_names.pop(pid, None)
        for pid, pool in inc.new_pools.items():
            pool.last_change = inc.epoch
            self.pools[pid] = pool
        self.pool_names.update(inc.new_pool_names)
        if inc.new_crush is not None:
            self.crush = inc.new_crush
            self.crush.max_devices = max(self.crush.max_devices,
                                         self.max_osd)
        for osd, addr in inc.new_up.items():
            self.osd_state[osd] |= OSD_EXISTS | OSD_UP
            self.osd_addrs[osd] = addr
            self.osd_info[osd].up_from = inc.epoch
        for osd, bits in inc.new_state.items():
            was_up = bool(self.osd_state[osd] & OSD_UP)
            self.osd_state[osd] ^= bits
            if was_up and not (self.osd_state[osd] & OSD_UP):
                self.osd_info[osd].down_at = inc.epoch
                self.osd_addrs[osd] = None
        for osd, w in inc.new_weight.items():
            self.osd_state[osd] |= OSD_EXISTS
            self.osd_weight[osd] = w
        for osd, a in inc.new_primary_affinity.items():
            self.osd_primary_affinity[osd] = a
        for osd, e in inc.new_up_thru.items():
            self.osd_info[osd].up_thru = e
        for osd, e in inc.new_lost.items():
            self.osd_info[osd].lost_at = e
        for pg, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pg] = list(osds)
            else:
                self.pg_temp.pop(pg, None)
        for pg, p in inc.new_primary_temp.items():
            if p >= 0:
                self.primary_temp[pg] = p
            else:
                self.primary_temp.pop(pg, None)
        for name, prof in inc.new_ec_profiles.items():
            self.ec_profiles[name] = dict(prof)
        for name in inc.old_ec_profiles:
            self.ec_profiles.pop(name, None)

    # ----------------------------------------------------------- encoding
    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.epoch).string(self.fsid)
        enc.f64(self.created).f64(self.modified)
        enc.u32(self.flags).s32(self.max_osd)
        enc.list_(self.osd_state, lambda e, v: e.u32(v))
        enc.list_(self.osd_weight, lambda e, v: e.u32(v))
        enc.list_(self.osd_addrs, lambda e, v: e.opt_struct(v))
        enc.list_(self.osd_info, lambda e, v: e.struct(v))
        enc.list_(self.osd_primary_affinity, lambda e, v: e.u32(v))
        enc.map_(self.pools, lambda e, k: e.s64(k), lambda e, v: e.struct(v))
        enc.map_(self.pool_names, lambda e, k: e.s64(k),
                 lambda e, v: e.string(v))
        enc.struct(self.crush)
        enc.u32(len(self.pg_temp))
        for pg in sorted(self.pg_temp):
            enc.struct(pg).list_(self.pg_temp[pg], lambda e, v: e.s32(v))
        enc.u32(len(self.primary_temp))
        for pg in sorted(self.primary_temp):
            enc.struct(pg).s32(self.primary_temp[pg])
        enc.map_(self.ec_profiles, lambda e, k: e.string(k),
                 lambda e, v: e.map_(v, lambda e2, k2: e2.string(k2),
                                     lambda e2, v2: e2.string(v2)))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "OSDMap":
        m = cls()
        m.epoch = dec.u32()
        m.fsid = dec.string()
        m.created = dec.f64()
        m.modified = dec.f64()
        m.flags = dec.u32()
        m.max_osd = dec.s32()
        m.osd_state = dec.list_(lambda d: d.u32())
        m.osd_weight = dec.list_(lambda d: d.u32())
        m.osd_addrs = dec.list_(lambda d: d.opt_struct(EntityAddr))
        m.osd_info = dec.list_(lambda d: d.struct(OSDInfo))
        m.osd_primary_affinity = dec.list_(lambda d: d.u32())
        m.pools = dec.map_(lambda d: d.s64(), lambda d: d.struct(PGPool))
        m.pool_names = dec.map_(lambda d: d.s64(), lambda d: d.string())
        m.crush = dec.struct(CrushMap)
        for _ in range(dec.u32()):
            pg = dec.struct(PGId)
            m.pg_temp[pg] = dec.list_(lambda d: d.s32())
        for _ in range(dec.u32()):
            pg = dec.struct(PGId)
            m.primary_temp[pg] = dec.s32()
        m.ec_profiles = dec.map_(
            lambda d: d.string(),
            lambda d: d.map_(lambda d2: d2.string(),
                             lambda d2: d2.string()))
        return m

    def __eq__(self, other):
        return (isinstance(other, OSDMap)
                and self.to_bytes() == other.to_bytes())

    def summary(self) -> str:
        fl = f" flags {','.join(flag_names(self.flags))}" \
            if self.flags else ""
        return (f"e{self.epoch}: {self.max_osd} osds "
                f"({self.count_up()} up, "
                f"{sum(1 for o in range(self.max_osd) if self.is_in(o))}"
                f" in), {len(self.pools)} pools{fl}")
