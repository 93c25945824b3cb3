"""Cache tiering: promote-on-miss, dirty tracking, agent flush/evict.

Reference parity: osd/ReplicatedPG.cc maybe_handle_cache (promote on
cache miss), agent_work (:12008 — flush dirty objects to the base pool,
evict cold clean ones), osd/TierAgentState.h, with pool linkage from
pg_pool_t tier_of/read_tier/write_tier (osd_types.h:1230-1234).
Scope: writeback mode (the flagship cache-tier mode); the cache pool
must be replicated (the reference enforces the same).

Redesign notes:
- The reference proxies/promotes through the Objecter embedded in the
  OSD; here a purpose-built TierClient speaks MOSDOp directly off the
  OSD's messenger + current osdmap (no separate client stack), and the
  PG worker awaits it — promotion serializes with the object's other
  ops for free.
- Dirty state is one xattr (DIRTY_XATTR) set transactionally with every
  client write on a tier PG, so it replicates with the data and
  survives failover (the reference tracks dirty in object_info_t).
- The agent runs per-PG on the primary, enqueued on the PG worker, so
  flush/evict writes serialize with client I/O; flush/evict are
  replicated internal ops (synthetic MOSDOp via the normal backend),
  never bare store mutations.
- Hot/cold comes from osd/hitset.py bloom windows; the agent sweeps
  the PG object list through contains_many in one vectorized shot.

The port's copy of ``ceph_tpu.osd.tiering``.
"""

from __future__ import annotations

import asyncio
import errno
import itertools
from typing import Dict, List, Optional

from ceph_tpu_torch.client.objecter import ObjectLocator
from ceph_tpu_torch.common.encoding import Decoder
from ceph_tpu_torch.osd.messages import (
    OP_DELETE, OP_GETXATTRS, OP_READ, OP_RMXATTR, OP_SETXATTR,
    OP_WRITEFULL, MOSDOp, MOSDOpReply, OSDOp,
)

DIRTY_XATTR = "_t_dirty"          # set with every client write in cache


def decode_xattrs(blob: bytes) -> Dict[str, bytes]:
    if not blob:
        return {}
    dec = Decoder(blob)
    raw = dec.map_(lambda d: d.bytes_(), lambda d: d.bytes_())
    return {k.decode(): v for k, v in raw.items()}


class TierClient:
    """Minimal RADOS client living inside the OSD for cross-pool ops
    (promote reads from / flush writes to the base pool)."""

    def __init__(self, osd):
        self.osd = osd
        self._tids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}

    def on_reply(self, m: MOSDOpReply) -> bool:
        fut = self._pending.pop(m.tid, None)
        if fut is not None and not fut.done():
            # loop-safe: tier ops are awaited on the PG's home shard
            # while replies dispatch on the intake loop (osd/shards.py)
            from ceph_tpu_torch.osd.shards import resolve_future
            resolve_future(fut, m)
            return True
        return False

    async def op(self, pool_id: int, oid: str, ops: List[OSDOp],
                 timeout: float = 20.0) -> MOSDOpReply:
        """Submit one op to `pool_id`'s primary; resends on EAGAIN
        (stale map) like the Objecter's resend loop.  Primary waits
        and EAGAIN resends back off under the shared policy (one
        monotonic deadline for the whole op) instead of fixed-interval
        polling that hammers a recovering map in lockstep."""
        from ceph_tpu_torch.common.backoff import Backoff, BackoffGiveUp
        bo = Backoff("tier_primary_wait", base=0.05, cap=1.0,
                     timeout=timeout,
                     perf=getattr(self.osd, "perf_recovery", None))
        while True:
            osdmap = self.osd.osdmap
            loc = ObjectLocator(pool_id)
            pg, acting, primary = osdmap.object_to_acting(oid, loc)
            if primary < 0:
                try:
                    await bo.sleep()
                except BackoffGiveUp:
                    raise TimeoutError(
                        f"tier op: no primary for {oid}") from None
                continue
            tid = next(self._tids)
            fut = asyncio.get_running_loop().create_future()
            self._pending[tid] = fut
            reqid = f"tier{self.osd.whoami:x}.{tid}"
            self.osd.send_osd(primary, MOSDOp(
                pg, oid, loc, ops, tid, osdmap.epoch, reqid))
            try:
                reply: MOSDOpReply = await bo.wait_for(fut)
            except BackoffGiveUp:
                self._pending.pop(tid, None)
                raise TimeoutError(f"tier op timeout: {oid}") from None
            if reply.result == -errno.EAGAIN:
                try:
                    await bo.sleep()
                except BackoffGiveUp:
                    raise TimeoutError(
                        f"tier op timeout: {oid}") from None
                continue
            return reply


async def maybe_promote(pg, m: MOSDOp) -> None:
    """On a cache miss, pull the object (data + xattrs) from the base
    pool and install it as a CLEAN cache object via a replicated
    internal write, then let the triggering op run against it
    (ReplicatedPG::promote_object)."""
    store = pg.osd.store
    soid = pg.object_id(m.oid)
    if store.exists(pg.cid, soid):
        return
    base_pool = pg.pool.tier_of
    try:
        reply = await pg.osd.tier_client.op(
            base_pool, m.oid,
            [OSDOp(OP_READ, offset=0, length=0),
             OSDOp(OP_GETXATTRS)])
    except TimeoutError:
        return                      # base unreachable: op sees local state
    if reply.result < 0:
        return                      # ENOENT at base too: genuine miss
    data = reply.ops[0].outdata
    xattrs = decode_xattrs(reply.ops[1].outdata)
    ops = [OSDOp(OP_WRITEFULL, data=data)]
    for k, v in xattrs.items():
        if not k.startswith("_"):   # internal markers don't propagate
            ops.append(OSDOp(OP_SETXATTR, name=k, data=v))
    await internal_write(pg, m.oid, ops)
    pg.perf_tier.inc("promotes")
    pg.perf_tier.inc("promote_bytes", len(data))


async def internal_write(pg, oid: str, ops: List[OSDOp]) -> int:
    """A replicated write originated by the OSD itself (promote /
    flush-clear / evict): rides the normal backend so replicas apply
    it too, but never marks the object dirty and answers a future
    instead of a client."""
    m = MOSDOp(pg.pgid, oid, ObjectLocator(pg.pool_id), ops,
               tid=0, map_epoch=pg.osd.osdmap.epoch,
               reqid=f"tierint{pg.osd.whoami:x}."
                     f"{next(pg.osd.tier_client._tids)}")
    m._tier_internal = True
    return await pg.backend.submit_client_write(m)


async def agent_work(pg) -> None:
    """One agent pass over a primary cache-tier PG (agent_work):
    flush dirty objects beyond the dirty ratio, evict cold clean
    objects beyond the full ratio.  Runs ON the PG worker queue so it
    serializes with client ops."""
    pool = pg.pool
    store = pg.osd.store
    target = pool.target_max_objects
    if not target:
        return
    try:
        heads = [o for o in store.collection_list(pg.cid)
                 if o.is_head()
                 and not o.name.startswith("_hitset_")
                 and o.name != "_pgmeta_"]
        # ONLY the actual internal objects are excluded — a user object
        # legitimately named "_foo" still flushes/evicts normally
    except Exception:
        return
    per_pg_target = max(1, target // max(1, pool.pg_num))
    oids = [h.name for h in heads]
    dirty = []
    for h in heads:
        try:
            store.getattr(pg.cid, h, DIRTY_XATTR)
            dirty.append(h.name)
        except Exception:
            pass
    # --- flush: dirty fraction above the dirty target ---
    n = len(oids)
    max_dirty = int(pool.cache_target_dirty_ratio * per_pg_target)
    if len(dirty) > max_dirty:
        hot = pg.hitset.contains_many(dirty)
        # cold dirty objects flush first (hot ones likely rewritten)
        order = sorted(range(len(dirty)), key=lambda i: bool(hot[i]))
        for i in order[:len(dirty) - max_dirty]:
            await flush_object(pg, dirty[i])
    # --- evict: total objects above the full target ---
    if n > int(pool.cache_target_full_ratio * per_pg_target):
        dirty_set = set(dirty)
        clean = [o for o in oids if o not in dirty_set]
        hot = pg.hitset.contains_many(clean)
        excess = n - int(pool.cache_target_full_ratio * per_pg_target)
        # evict cold first; hot clean objects only under pressure
        order = sorted(range(len(clean)), key=lambda i: bool(hot[i]))
        for i in order[:excess]:
            await evict_object(pg, clean[i])


async def flush_object(pg, oid: str) -> bool:
    """Write a dirty cache object back to the base pool, then clear
    its dirty mark (agent_maybe_flush)."""
    store = pg.osd.store
    soid = pg.object_id(oid)
    try:
        data = store.read(pg.cid, soid)
        xattrs = store.getattrs(pg.cid, soid)
    except Exception:
        return False
    ops = [OSDOp(OP_WRITEFULL, data=data)]
    for k, v in xattrs.items():
        if not k.startswith("_"):
            ops.append(OSDOp(OP_SETXATTR, name=k, data=v))
    try:
        reply = await pg.osd.tier_client.op(pg.pool.tier_of, oid, ops)
    except TimeoutError:
        return False
    if reply.result < 0:
        return False
    await internal_write(pg, oid, [OSDOp(OP_RMXATTR, name=DIRTY_XATTR)])
    pg.perf_tier.inc("flushes")
    pg.perf_tier.inc("flush_bytes", len(data))
    return True


async def evict_object(pg, oid: str) -> bool:
    """Drop a CLEAN object from the cache (agent_maybe_evict); the
    base pool still holds it, a future miss re-promotes."""
    store = pg.osd.store
    soid = pg.object_id(oid)
    try:
        store.getattr(pg.cid, soid, DIRTY_XATTR)
        return False                 # dirty: never evict unflushed data
    except Exception:
        pass
    r = await internal_write(pg, oid, [OSDOp(OP_DELETE)])
    if r == 0:
        pg.perf_tier.inc("evicts")
    return r == 0
