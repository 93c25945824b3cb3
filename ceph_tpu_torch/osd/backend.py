"""PGBackend strategies: primary-copy replication and erasure coding.

Reference parity: osd/PGBackend.h (strategy interface),
osd/ReplicatedBackend.cc (submit_transaction :592 → issue_op :633 →
sub_op_modify :205 → acks :714), osd/ECBackend.cc (submit_transaction
:1344 → ECTransaction encode → MOSDECSubOpWrite; handle_sub_write :827,
handle_sub_read :890; reads :1927 gather k shards → ECUtil::decode;
recovery :484 via minimum_to_decode), osd/ECUtil.cc (stripe math).

EC design (device-first): a full-object write is encoded in ONE shot —
the object is split into k data chunks and parity computed by the
GF(2^8) matrix-apply kernel (ec/kernel.py), then per-shard transactions
fan out.  Chunk streams are linear over GF(2^8), so recovery decodes
whole shard streams at once instead of looping stripes.  Omap is
rejected on EC pools like the reference; xattrs replicate to all shards.

The port's copy of ``ceph_tpu.osd.backend``.  Device work goes only
through the OSD's EC batch queue or, in mesh mode, the mesh executor
(``parallel/mesh_exec``), so the matrix-apply kernel on a card; the
codec's own backend stays "host".  A failed mesh program falls back to
the batch queue only when the mesh's positions are all on the CPU: off
it the error goes to the caller, where the JAX package's always falls
back.
"""

from __future__ import annotations

import asyncio
import errno
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch.osd.messages import (
    EVersion, MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDECSubOpWrite,
    MOSDECSubOpWriteReply, MOSDOp, MOSDRepOp, MOSDRepOpReply, MPGPush,
    OSDOp,
    OP_APPEND, OP_ASSERT_EXISTS, OP_CALL, OP_CMPXATTR, OP_CREATE,
    OP_DELETE,
    OP_GETXATTR, OP_GETXATTRS, OP_LIST_SNAPS, OP_NOTIFY,
    OP_OMAP_GET_HEADER, OP_OMAP_GET_VALS, OP_OMAP_RM_KEYS, OP_OMAP_SET,
    OP_OMAP_SET_HEADER, OP_PGLS, OP_READ, OP_RMXATTR, OP_ROLLBACK,
    OP_SETXATTR, OP_STAT, OP_TRUNCATE, OP_WATCH, OP_WRITE, OP_WRITEFULL,
    OP_ZERO,
)
from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
from ceph_tpu_torch.msg.payload import LazyPayload
from ceph_tpu_torch.osd import extents
from ceph_tpu_torch.osd.pglog import LOG_DELETE, LOG_MODIFY, LogEntry
from ceph_tpu_torch.store.objectstore import (
    NoSuchCollection, NoSuchObject, Transaction,
)

SIZE_XATTR = "_size"       # EC: original object length (hinfo role)
VERSION_XATTR = "_ver"     # log version of the stored object state:
#                            lets adoption scans spot STALE copies, not
#                            just absent ones, and breaks EC cohort ties


class PGIntervalChanged(Exception):
    """The PG's acting set changed while an op was in flight; the op must
    abort promptly (client retries against the new mapping)."""


class _ReplTrace:
    """Replica-side aux stage clock (op tracer): repl_apply = sub-op
    receipt -> txn queued, repl_commit = queued -> group-commit
    callback.  Both overlap the primary's replica_rtt chain stage and
    are recorded as auxiliary only."""

    __slots__ = ("hist", "t0", "t_q")

    def __init__(self, hist):
        self.hist = hist
        self.t0 = time.monotonic()
        self.t_q = 0.0

    def applied(self) -> None:
        self.t_q = time.monotonic()
        self.hist.hinc("repl_apply", self.t_q - self.t0)

    def committed(self) -> None:
        self.hist.hinc("repl_commit", time.monotonic() - self.t_q)


class PGBackend:
    def __init__(self, pg):
        self.pg = pg
        self.osd = pg.osd
        self.log_ = pg.log_
        # in-flight rep ops: tid -> (pending peer set, future)
        self._inflight: Dict[int, Tuple[set, asyncio.Future]] = {}

    def on_interval_change(self) -> None:
        """Fail every in-flight ack/read/push future: replies from the
        old acting set may never arrive, and waiting out the 20s timeout
        would freeze this PG's whole op queue (ReplicatedPG::do_request
        re-checks on every map)."""
        exc = PGIntervalChanged(f"pg {self.pg.pgid} interval changed")
        for _, fut in self._inflight.values():
            if not fut.done():
                fut.set_exception(exc)
        self._inflight.clear()
        for fut in self.pg._push_acks.values():
            if not fut.done():
                fut.set_exception(exc)

    # --- shared helpers ---
    def _ack_init(self, tid: int, peers: set) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        if not peers:
            fut.set_result(True)
        else:
            self._inflight[tid] = (set(peers), fut)
        return fut

    def _ack_rx(self, tid: int, frm) -> None:
        ent = self._inflight.get(tid)
        if ent is None:
            return
        pending, fut = ent
        pending.discard(frm)
        if not pending:
            del self._inflight[tid]
            if not fut.done():
                fut.set_result(True)

    async def _await_acks(self, fut: asyncio.Future,
                          timeout: Optional[float] = None) -> bool:
        """Await replica acks under the shared backoff policy: the
        budget comes from config (osd_recovery_push_timeout class of
        knobs), the give-up is cause-tagged and counted
        (osd.recovery backoff census) instead of a silent magic-20s
        wait_for."""
        from ceph_tpu_torch.common.backoff import Backoff, BackoffGiveUp
        bo = Backoff("repl_ack",
                     timeout=timeout if timeout is not None
                     else float(self.osd.cfg["osd_ack_timeout"]),
                     perf=getattr(self.osd, "perf_recovery", None))
        try:
            await bo.wait_for(fut)
            return True
        except (BackoffGiveUp, PGIntervalChanged):
            return False

    def _repl_trace(self, m) -> "Optional[_ReplTrace]":
        """Aux stage recorder for a traced replica sub-op, or None when
        the op is untraced / this daemon's tracing is off."""
        tr = self.osd.ctx.tracer
        if tr.enabled and m.trace_id:
            return _ReplTrace(tr.hist)
        return None

    def _queue_txn(self, txn: Transaction,
                   on_commit=None) -> asyncio.Future:
        """Queue txn on the local store; the returned future resolves
        once it is DURABLE.  The caller overlaps the replica round trip
        with the local group commit (commit pipelining) instead of
        serializing every write behind a private fsync."""
        fut = asyncio.get_running_loop().create_future()

        def _committed():
            if on_commit is not None:
                on_commit()
            if not fut.done():
                fut.set_result(True)

        self.osd.store.queue_transactions([txn], on_commit=_committed)
        return fut

    async def _await_commit(self, fut: asyncio.Future,
                            timeout: Optional[float] = None) -> bool:
        from ceph_tpu_torch.common.backoff import Backoff, BackoffGiveUp
        bo = Backoff("local_commit",
                     timeout=timeout if timeout is not None
                     else float(self.osd.cfg["osd_ack_timeout"]),
                     perf=getattr(self.osd, "perf_recovery", None))
        try:
            await bo.wait_for(fut)
            return True
        except BackoffGiveUp:
            return False

    def apply_push(self, m: MPGPush, on_commit=None) -> bool:
        """Install a pushed object (recovery receive side).  A push
        snapshotted BEFORE a concurrent client write but delivered after
        it must not regress the object: the reference orders this with
        the last_backfill cursor + per-object version checks
        (ReplicatedPG::recover_object_replicas); here the local log is
        the arbiter — never install below what we already applied
        (found by qa/rados_model: a committed write vanished when the
        stale backfill push of the same object landed after it)."""
        pg = self.pg
        local = pg.log.latest_entry_for(m.oid)
        if local is not None and m.version < local.version:
            return False
        if m.deleted and local is not None and not local.is_delete():
            # the pusher has NO copy and claims "deleted" at its log
            # head, but OUR log says this object exists — the pusher is
            # just another victim of the same missed recovery, and
            # installing its tombstone would erase committed data still
            # present elsewhere
            return False
        oid = pg.object_id(m.oid)
        txn = Transaction()
        txn.remove(pg.cid, oid)
        if not m.deleted:
            txn.write(pg.cid, oid, 0, m.data)
            if m.attrs:
                txn.setattrs(pg.cid, oid, m.attrs)
            if m.omap:
                txn.omap_setkeys(pg.cid, oid, m.omap)
            if m.omap_header:
                txn.omap_setheader(pg.cid, oid, m.omap_header)
            if local is not None and VERSION_XATTR not in m.attrs:
                txn.setattr(pg.cid, oid, VERSION_XATTR,
                            local.version.to_bytes())
        # snapshot state rides REPLICATED pushes (has_snap_state):
        # replace OUR clones/SnapSet/SnapMapper rows with the pusher's
        # (stale local clones must not survive — their ids may have
        # been trimmed at the source).  EC shard pushes don't carry
        # it, and must never DESTROY the receiver's local snap state.
        from ceph_tpu_torch.osd.snaps import (SnapSet, load_snapset, sm_key,
                                        ss_key)
        old_ss = load_snapset(self.osd.store, pg.cid, pg.meta_oid,
                              m.oid) if m.has_snap_state else None
        if old_ss is not None:
            for c in old_ss.clones:
                txn.remove(pg.cid, oid.with_snap(c))
            txn.omap_rmkeys(pg.cid, pg.meta_oid, [ss_key(m.oid)] + [
                sm_key(s, m.oid)
                for c in old_ss.clones
                for s in old_ss.clone_snaps.get(c, [])])
        if m.snapset:
            ss = SnapSet.from_bytes(m.snapset)
            sm = {}
            for c, cdata, cattrs in m.clones:
                csoid = oid.with_snap(c)
                txn.write(pg.cid, csoid, 0, cdata)
                if cattrs:
                    txn.setattrs(pg.cid, csoid, cattrs)
                for s in ss.clone_snaps.get(c, []):
                    sm[sm_key(s, m.oid)] = str(c).encode()
            txn.omap_setkeys(pg.cid, pg.meta_oid,
                             {ss_key(m.oid): m.snapset, **sm})
        # recovery landed: this object no longer gates our completeness
        pg.missing.items.pop(m.oid, None)
        if not pg.missing:
            pg.info.last_complete = pg.info.last_update
        # backfill pushes arrive in sorted-name order: advance our
        # durable cursor so a crash here resumes instead of restarting
        # (no-op once complete — LB_MAX compares above every name)
        if m.backfill_progress and \
                m.backfill_progress > pg.info.last_backfill:
            pg.info.last_backfill = m.backfill_progress
        pg.save_meta(txn)
        # recovery accounting at the LANDING site: one inc per payload
        # installed on this (target) OSD whichever path carried it —
        # primary push, backfill window, or pull-requested push.  The
        # pusher does not count; a push serves exactly one landing.
        if not m.deleted:
            nbytes = len(m.data or b"") \
                + sum(len(cd) for _, cd, _ in m.clones)
            perf = getattr(self.osd, "perf_osd", None)
            if perf is not None:
                perf.inc("recovery_bytes", nbytes)
            rec = getattr(self.osd, "perf_recovery", None)
            if rec is not None:
                rec.inc("objects_pulled")
                rec.inc("pull_bytes", nbytes)
        # the push ack (on_commit) rides the commit callback: the
        # pusher's cursor advance must vouch for DURABLE state
        self.osd.store.queue_transactions([txn], on_commit=on_commit)
        return True

    def push_object(self, peer: int, oid: str, at: EVersion,
                    progress: str = "") -> None:
        """Send full object state to peer (fire-and-forget variant).
        `progress` stamps backfill pushes so the receiver's
        last_backfill cursor advances durably.  The object's SnapSet +
        clone objects ride along, so the recovered copy serves
        reads-at-snap too (previously a documented scope limit)."""
        pg = self.pg
        soid = pg.object_id(oid)
        try:
            data = self.osd.store.read(pg.cid, soid)
            attrs = self.osd.store.getattrs(pg.cid, soid)
            hdr, omap = self.osd.store.omap_get(pg.cid, soid)
            msg = MPGPush(pg.pgid.with_shard(pg.shard_of(peer)), oid, at,
                          data, attrs, omap, hdr, self.osd.whoami)
        except (NoSuchObject, NoSuchCollection):
            msg = MPGPush(pg.pgid.with_shard(pg.shard_of(peer)), oid, at,
                          from_osd=self.osd.whoami, deleted=True)
        if not pg.pool.is_erasure():
            # REPLICATED pushes carry authoritative snap state; EC
            # shard pushes must not — a pusher's own-shard clone
            # chunks are foreign bytes on any other shard, and even an
            # empty carry would wipe the receiver's clones
            from ceph_tpu_torch.osd.snaps import load_snapset
            msg.has_snap_state = True
            ss = load_snapset(self.osd.store, pg.cid, pg.meta_oid, oid)
            if ss is not None:
                msg.snapset = ss.to_bytes()
                for c in ss.clones:
                    try:
                        csoid = soid.with_snap(c)
                        msg.clones.append(
                            (c, self.osd.store.read(pg.cid, csoid),
                             self.osd.store.getattrs(pg.cid, csoid)))
                    except (NoSuchObject, NoSuchCollection):
                        pass    # trimmed under us: receiver trims too
        msg.backfill_progress = progress
        self.osd.send_osd(peer, msg)
        return len(msg.data or b"") \
            + sum(len(c[1]) for c in msg.clones)

    async def _push_and_wait(self, peer: int, oid: str,
                             progress: str = "") -> None:
        from ceph_tpu_torch.common.backoff import Backoff
        bo = Backoff("push_ack", perf=getattr(self.osd,
                                              "perf_recovery", None),
                     timeout=float(
                         self.osd.cfg["osd_recovery_push_timeout"]))
        fut = asyncio.get_running_loop().create_future()
        self.pg._push_acks[(peer, oid)] = fut
        try:
            nbytes = self.push_object(peer, oid,
                                      self.pg.info.last_update,
                                      progress)
            await bo.wait_for(fut)
            perf = getattr(self.osd, "perf_recovery", None)
            if perf is not None:
                perf.inc("objects_pushed")
                perf.inc("push_bytes", nbytes)
        finally:
            self.pg._push_acks.pop((peer, oid), None)

    # --- interface ---
    async def submit_client_write(self, m: MOSDOp) -> int: ...
    async def do_reads(self, m: MOSDOp) -> int: ...
    async def handle_sub_message(self, m) -> None: ...

    def sub_write_fast(self, m) -> bool:
        """Synchronous replica write-sub-op apply, for the sharded
        plane's inline classify path (osd/shards.py): True when the
        message was fully handled with no suspension point.  False =
        hand it to the PG worker as usual."""
        return False

    def handle_reply(self, m) -> None:
        """Ack-type messages resolve futures the PG worker is awaiting —
        they MUST bypass the op queue (the worker is blocked on them)."""
        if isinstance(m, (MOSDRepOpReply, MOSDECSubOpWriteReply)):
            self._ack_rx(m.tid, m.from_osd)
        elif isinstance(m, MOSDECSubOpReadReply):
            ent = self._inflight.pop(m.tid, None)
            if ent is not None and not ent[1].done():
                ent[1].set_result(m)

    async def recover_object(self, peer: int, oid: str,
                             exclude=frozenset(),
                             progress: str = "") -> None:
        await self._push_and_wait(peer, oid, progress)

    async def recover_objects(self, peer: int, oids: List[str],
                              progress: str = ""
                              ) -> Tuple[List[str],
                                         Optional[BaseException]]:
        """Recover a sorted window of objects to `peer` CONCURRENTLY,
        bounded by the OSD-wide recovery budget (reservation-style cap
        on in-flight pushes, osd_recovery_max_active) so a rebuild
        storm cannot starve client ops of store/messenger time.  All
        pushes stamp the same `progress` floor — cursor ordering is
        the caller's (PG._recover) job.  Returns (oids that landed,
        first failure or None); the caller retries the failures."""
        budget = self.osd.recovery_budget() \
            if hasattr(self.osd, "recovery_budget") else None
        tr = self.osd.ctx.tracer
        rec = getattr(self.osd, "perf_recovery", None)
        tracker = getattr(self.osd, "op_tracker", None)

        async def one(oid: str) -> None:
            if budget is not None:
                await budget.acquire()
            # recovery rides the SAME slow-op machinery as client ops:
            # a push stalled behind a flapping target complains once
            # and lands its stage record in the flight recorder
            top = tracker.create(
                f"recovery_push({self.pg.pgid} {oid} -> "
                f"osd.{peer})") if tracker is not None else None
            if rec is not None:
                rec.inc("active_pulls")
            try:
                t0 = time.monotonic()
                await self.recover_object(peer, oid, progress=progress)
                if tr.enabled:
                    # aux stage: overlaps the client chain (recovery
                    # runs concurrently with ops), never summed into it
                    tr.hist.hinc("recovery_pull",
                                 time.monotonic() - t0)
            finally:
                if rec is not None:
                    rec.inc("active_pulls", -1)
                if top is not None:
                    tracker.finish(top)
                if budget is not None:
                    budget.release()

        res = await asyncio.gather(*(one(o) for o in oids),
                                   return_exceptions=True)
        done = [o for o, r in zip(oids, res)
                if not isinstance(r, BaseException)]
        err = next((r for r in res if isinstance(r, BaseException)),
                   None)
        if isinstance(err, asyncio.CancelledError):
            raise err
        return done, err

    async def pull_object(self, peer: int, oid: str, epoch: int,
                          exclude=frozenset()) -> None:
        """Primary self-heal during peering: fetch our copy from the
        authoritative peer (whole-object for replicated; ECBackend
        overrides to reconstruct its own shard).  `exclude` names shards
        known-bad (scrub) that must not feed a reconstruction."""
        await self.pg.pull_object_via_push(peer, oid, epoch)


# ===================================================================== util

def _list_snaps(pg, oid: str, op: OSDOp) -> int:
    """OP_LIST_SNAPS: the object's SnapSet as json (librados
    list_snaps / the snapdir listing role)."""
    import json
    from ceph_tpu_torch.osd import snaps as snaps_mod
    ss = snaps_mod.load_snapset(pg.osd.store, pg.cid, pg.meta_oid, oid)
    if ss is None:
        op.outdata = json.dumps({"seq": 0, "clones": []}).encode()
        return 0
    op.outdata = json.dumps({
        "seq": ss.seq,
        "clones": [{"id": c, "snaps": ss.clone_snaps.get(c, [])}
                   for c in ss.clones]}).encode()
    return 0


def _ops_materialize(ops) -> None:
    """Lane-received ops may carry extent-backed data (the zero-copy
    ring transport ships a shared-memory handle, not bytes); execution
    is the first real use, so the single copy out of shared memory is
    paid here — attributed to the extent_read stage, NOT lane_codec."""
    for op in ops:
        d = op.data
        if getattr(d, "_is_extent_ref", False):
            op.data = d.materialize()


def execute_read_op(store, cid, soid, op: OSDOp) -> int:
    """One read-class op against committed state; fills rval/outdata."""
    if getattr(op.data, "_is_extent_ref", False):
        op.data = op.data.materialize()
    try:
        if op.op == OP_ASSERT_EXISTS:
            store.stat(cid, soid)
            op.rval = 0
        elif op.op == OP_CMPXATTR:
            # guard: stored xattr equals op.data, else ECANCELED
            # (reference do_osd_ops CEPH_OSD_OP_CMPXATTR)
            store.stat(cid, soid)          # ENOENT if no object
            try:
                cur = store.getattr(cid, soid, op.name)
            except (NoSuchObject, KeyError):
                cur = None
            op.rval = 0 if cur == op.data else -errno.ECANCELED
        elif op.op == OP_READ:
            length = op.length if op.length else -1
            op.outdata = store.read(cid, soid, op.offset, length)
            op.rval = len(op.outdata)
        elif op.op == OP_STAT:
            st = store.stat(cid, soid)
            op.outdata = str(st["size"]).encode()
            op.rval = 0
        elif op.op == OP_GETXATTR:
            op.outdata = store.getattr(cid, soid, op.name)
            op.rval = len(op.outdata)
        elif op.op == OP_GETXATTRS:
            attrs = store.getattrs(cid, soid)
            from ceph_tpu_torch.common.encoding import Encoder
            enc = Encoder()
            enc.map_({k.encode(): v for k, v in attrs.items()},
                     lambda e, k: e.bytes_(k), lambda e, v: e.bytes_(v))
            op.outdata = enc.getvalue()
            op.rval = 0
        elif op.op == OP_OMAP_GET_VALS:
            if op.keys:
                # keyed read stays O(keys) down through the store — a
                # single-entry lookup must not scan the whole omap
                vals = store.omap_get_values(cid, soid, op.keys)
            else:
                vals = store.omap_get(cid, soid)[1]
            from ceph_tpu_torch.common.encoding import Encoder
            enc = Encoder()
            enc.map_(vals, lambda e, k: e.bytes_(k),
                     lambda e, v: e.bytes_(v))
            op.outdata = enc.getvalue()
            op.rval = 0
        elif op.op == OP_OMAP_GET_HEADER:
            op.outdata = store.omap_get_header(cid, soid)
            op.rval = 0
        elif op.op == OP_CALL:
            from ceph_tpu_torch import cls as cls_mod
            hctx = cls_mod.ClsContext(store, cid, soid, staged=None)
            op.rval, op.outdata = cls_mod.call(op.name, hctx, op.data)
        else:
            op.rval = -errno.EOPNOTSUPP
    except (NoSuchObject, NoSuchCollection):
        op.rval = -errno.ENOENT
    return op.rval


def build_write_txn(store, cid, soid, ops: List[OSDOp],
                    txn: Transaction) -> Tuple[int, bool]:
    """Translate write-class ops into store txn ops (do_osd_ops write
    side).  Returns (result, deletes_object)."""
    _ops_materialize(ops)
    deleted = False
    for op in ops:
        if not op.is_write():
            continue
        if op.op == OP_WRITE:
            txn.write(cid, soid, op.offset, op.data)
            deleted = False
        elif op.op == OP_WRITEFULL:
            txn.truncate(cid, soid, 0)
            txn.write(cid, soid, 0, op.data)
            deleted = False
        elif op.op == OP_APPEND:
            try:
                size = store.stat(cid, soid)["size"]
            except (NoSuchObject, NoSuchCollection):
                size = 0
            txn.write(cid, soid, size, op.data)
        elif op.op == OP_TRUNCATE:
            txn.truncate(cid, soid, op.offset)
        elif op.op == OP_ZERO:
            txn.zero(cid, soid, op.offset, op.length)
        elif op.op == OP_CREATE:
            txn.touch(cid, soid)
        elif op.op == OP_DELETE:
            txn.remove(cid, soid)
            deleted = True
        elif op.op == OP_SETXATTR:
            txn.setattr(cid, soid, op.name, op.data)
        elif op.op == OP_RMXATTR:
            txn.rmattr(cid, soid, op.name)
        elif op.op == OP_OMAP_SET:
            txn.omap_setkeys(cid, soid, op.kv)
        elif op.op == OP_OMAP_RM_KEYS:
            txn.omap_rmkeys(cid, soid, op.keys)
        elif op.op == OP_OMAP_SET_HEADER:
            txn.omap_setheader(cid, soid, op.data)
        else:
            return -errno.EOPNOTSUPP, deleted
    return 0, deleted


# ============================================================== replicated

class ReplicatedBackend(PGBackend):
    """Primary-copy replication (osd/ReplicatedBackend.cc)."""

    async def submit_client_write(self, m: MOSDOp) -> int:
        pg = self.pg
        soid = pg.object_id(m.oid)
        _ops_materialize(m.ops)
        # watch registration is primary-local state, not a store txn
        watch_ops = [op for op in m.ops if op.op == OP_WATCH]
        if watch_ops:
            for op in watch_ops:
                pg.handle_watch(m, op)
            if all(op.op == OP_WATCH for op in m.ops):
                return 0
        # read-class ops in the batch see pre-write state; guard ops
        # (cmpxattr/assert-exists) abort the whole op on mismatch
        for op in m.ops:
            if not op.is_write():
                if op.op == OP_PGLS:
                    self._do_pgls(op)
                else:
                    rv = execute_read_op(self.osd.store, pg.cid, soid, op)
                    if op.op in (OP_CMPXATTR, OP_ASSERT_EXISTS) and rv < 0:
                        return rv
        from ceph_tpu_torch.osd import snaps as snaps_mod
        txn = Transaction()
        # clone-on-write BEFORE mutations: the clone op captures
        # pre-write bytes (ReplicatedPG::make_writeable)
        snaps_mod.prepare_cow(pg, m.oid, m.snap_seq, m.snaps,
                              [(txn, pg.cid, soid)])
        rollbacks = [op for op in m.ops if op.op == OP_ROLLBACK]
        for op in rollbacks:
            try:
                src = snaps_mod.rollback_targets(pg, m.oid, soid,
                                                 op.offset)
            except KeyError:
                return -errno.ENOENT
            if src is not None:
                txn.remove(pg.cid, soid)
                txn.clone(pg.cid, src, soid)
        # object-class write methods run HERE, against committed state,
        # and their staged logical ops splice into the batch (cls)
        from ceph_tpu_torch import cls as cls_mod
        rv, batch_ops = cls_mod.expand_write_calls(
            self.osd.store, pg.cid, soid,
            [op for op in m.ops if op.op not in (OP_ROLLBACK, OP_WATCH)])
        if rv < 0:
            return rv
        result, deletes = build_write_txn(
            self.osd.store, pg.cid, soid, batch_ops, txn)
        if result < 0:
            return result
        # object digest (data_digest role): full-object writes record the
        # crc scrub verifies against; partial mutations invalidate it
        # (empty marker) exactly like the reference drops data_digest
        from ceph_tpu_torch.common.crc import crc32c
        from ceph_tpu_torch.osd.scrub import CRC_XATTR
        digest_ops = {OP_WRITEFULL: None, OP_WRITE: b"", OP_APPEND: b"",
                      OP_TRUNCATE: b"", OP_ZERO: b""}
        # over batch_ops (post cls-expansion), not m.ops: a cls method
        # staging write_full must refresh the digest too
        for op in batch_ops:
            if not op.is_write() or op.op not in digest_ops:
                continue
            if op.op == OP_WRITEFULL:
                txn.setattr(pg.cid, soid, CRC_XATTR,
                            str(crc32c(op.data)).encode())
            else:
                txn.setattr(pg.cid, soid, CRC_XATTR, b"")
        if (pg.pool.is_tier() and pg.pool.cache_mode == "writeback"
                and not deletes
                and not getattr(m, "_tier_internal", False)):
            # cache-tier dirty mark rides the same replicated txn as
            # the data (object_info_t dirty flag role); the agent
            # clears it after flushing to the base pool
            from ceph_tpu_torch.osd.tiering import DIRTY_XATTR
            txn.setattr(pg.cid, soid, DIRTY_XATTR, b"1")
        # op tracing: the chain cursor last cut at dep_wait/queue_wait —
        # everything up to here (guards, cow, cls, txn build) is the
        # `prepare` stage; cuts below are synchronous, so the submit
        # section stays await-free
        span = m._span
        th = self.osd.ctx.tracer.hist if span is not None else None
        if span is not None:
            span.cut("prepare", th)
        # SUBMIT SECTION — await-free from version assignment through
        # the fan-out sends below: under the per-PG op window this is
        # what keeps pglog versions dense/ordered across concurrent
        # ops and queue_transactions order == pglog order (the
        # in-order commit callbacks ride that).  Machine-checked: the
        # invariant lint (devtools rule AF01) fails on any suspension
        # point between the sentinels.
        # awaitfree:begin replicated-submit
        version = pg.next_version()
        entry = LogEntry(LOG_DELETE if deletes else LOG_MODIFY, m.oid,
                         version, pg.info.last_update, m.reqid)
        if not deletes:
            txn.setattr(pg.cid, soid, VERSION_XATTR, version.to_bytes())
        pg.append_log(txn, entry)
        # seal the txn + entry into lazy payloads: freezes the txn (no
        # further sender mutation) and shares ONE encoder cache across
        # the whole fan-out — bytes materialize only if a peer hop
        # actually crosses a TCP socket (msg/payload.py)
        txn_payload = LazyPayload.seal(txn)
        log_payload = LazyPayload.seal(entry)
        # local apply now (memory is immediately readable); durability
        # rides the commit thread CONCURRENTLY with the replica round
        # trip — pglog last_complete advances from the commit callback
        commit_fut = self._queue_txn(
            txn, on_commit=lambda: pg.complete_to(version))
        if span is not None:
            span.cut("store_apply", th)
        # fan out to acting AND up: an up-but-not-acting member (pg_temp
        # backfill target) must see every write or its copy stales
        peers = {o for o in set(pg.acting) | set(pg.up)
                 if o != self.osd.whoami and o >= 0
                 and o != CRUSH_ITEM_NONE}
        tid = self.osd.next_tid()
        fut = self._ack_init(tid, peers)
        for p in peers:
            rep = MOSDRepOp(pg.pgid, tid, txn_payload, log_payload,
                            version, self.osd.osdmap.epoch)
            if span is not None:
                # propagate the trace so replica-side stage records
                # land under the client's trace (wire: payload fields)
                rep.trace_id, rep.span_id = span.trace_id, span.span_id
            self.osd.send_osd(p, rep)
        if span is not None:
            span.cut("submit", th)
        # awaitfree:end replicated-submit
        if not await self._await_acks(fut):
            self._inflight.pop(tid, None)
            return -errno.EAGAIN   # interval change in flight: client resends
        if span is not None:
            span.cut("replica_rtt", th)
        if not await self._await_commit(commit_fut):
            return -errno.EAGAIN   # local store wedged: client resends
        if span is not None:
            span.cut("commit_wait", th)
        return 0

    async def do_reads(self, m: MOSDOp) -> int:
        pg = self.pg
        from ceph_tpu_torch.osd import snaps as snaps_mod
        head = pg.object_id(m.oid)
        soid = head
        if m.snapid:
            soid = snaps_mod.resolve_read(pg, m.oid, head, m.snapid)
        result = 0
        for op in m.ops:
            if op.op == OP_PGLS:
                self._do_pgls(op)
            elif op.op == OP_NOTIFY:
                op.rval = await pg.handle_notify(m, op)
                if op.rval < 0 and result == 0:
                    result = op.rval
            elif op.op == OP_LIST_SNAPS:
                op.rval = _list_snaps(pg, m.oid, op)
            elif soid is None:
                op.rval = -errno.ENOENT
                if result == 0:
                    result = op.rval
            else:
                rv = execute_read_op(self.osd.store, pg.cid, soid, op)
                if rv < 0 and result == 0:
                    result = rv
        return result

    def _do_pgls(self, op: OSDOp) -> None:
        names = [o.name for o in
                 self.osd.store.collection_list(self.pg.cid)
                 if o.name != self.pg.meta_oid.name and o.is_head()]
        op.outdata = b"\x00".join(n.encode() for n in names)
        op.rval = len(names)

    async def handle_sub_message(self, m) -> None:
        if isinstance(m, MOSDRepOp):
            self._apply_rep_write(m)

    def sub_write_fast(self, m) -> bool:
        if isinstance(m, MOSDRepOp):
            self._apply_rep_write(m)
            return True
        return False

    def _apply_rep_write(self, m) -> None:
        """Replica write sub-op apply: SYNCHRONOUS by contract (no
        suspension point), so the sharded plane's classify seam may
        run it inline off the shard ring (sub_write_fast) without a
        queue/worker hop when nothing is queued ahead."""
        pg = self.pg
        if m.map_epoch < pg.info.same_interval_since:
            # stale-interval sub-op (found by the schedule
            # explorer / rule EPOCH10): a primary of a CLOSED
            # interval fanned this out before it learned the new
            # map.  Applying it would graft a divergent entry onto
            # a log the new interval's peering has already judged;
            # drop it — the old primary's in-flight ack wait aborts
            # on its own interval change and the client resends.
            # A dropped sub-op still owns its extent slots: release
            # here or they leak until the lane-death sweep
            extents.release_message(m)
            return
        rt = self._repl_trace(m)
        # copy discipline: txn() is OUR mutable copy (save_meta
        # appends below must never reach the sender or a sibling
        # replica); the log entry is immutable and shared as-is
        txn = m.txn()
        entry = m.log_entry()
        advance = None
        if pg.log.head < entry.version:
            pg.log.append(entry)
            pg.note_reqid(entry)
            pg.info.last_update = entry.version
            if not pg.missing:
                # a copy still owed recovery pushes must keep its
                # honest last_complete cursor, or the gap hides
                advance = entry.version
        pg.save_meta_log(txn, entry)
        src = int(m.src_name.id)
        reply = MOSDRepOpReply(pg.pgid, m.tid, 0, True,
                               self.osd.whoami)
        if rt is not None:
            rt.applied()

        def _committed():
            # last_complete and the repop ack advance TOGETHER from
            # the commit callback — the ack can never outrun the
            # durability of the pglog entry it vouches for, and the
            # PG worker is already applying the next sub-op while
            # this one's group commits (commit pipelining).  The op's
            # extent slots retire with the same durability point, and
            # the ack rides the per-connection cork: the commit thread
            # runs a drained group's callbacks in ONE loop callback,
            # so every ack of the burst coalesces into one frame
            extents.release_message(m)
            if advance is not None:
                pg.complete_to(advance)
            if rt is not None:
                rt.committed()
            self.osd.queue_rep_ack(src, reply)

        self.osd.store.queue_transactions([txn],
                                          on_commit=_committed)


# ================================================================= erasure

class ECBackend(PGBackend):
    """Erasure-coded strategy (osd/ECBackend.cc) with one-shot device encode.

    Append-only like the reference at this version (ECBackend.cc:1418):
    supported object writes are full-object replace, create, delete and
    xattrs; partial overwrites and omap return -EOPNOTSUPP
    (ReplicatedPG rejects omap on EC pools too)."""

    def __init__(self, pg):
        super().__init__(pg)
        from ceph_tpu_torch.ec.registry import factory
        stored = self.osd.osdmap.ec_profiles.get(pg.pool.ec_profile)
        if stored is None:
            # a silently-defaulted k/m would run with different fault
            # tolerance than the admin configured — refuse
            raise RuntimeError(
                f"pg {pg.pgid}: EC profile {pg.pool.ec_profile!r} not in "
                f"osdmap e{self.osd.osdmap.epoch} ec_profiles")
        profile = dict(stored)
        # same defaults the monitor materializes at profile-set/pool-create
        # time, so geometry can never disagree across daemons
        profile.setdefault("k", "4")
        profile.setdefault("m", "2")
        # The codec's own backend stays "host": direct codec calls happen
        # inline in the event loop, where a per-op device dispatch would
        # stall everything (SURVEY §7 hard part).  Device encodes instead
        # ride the OSD-wide cross-PG batch collector (osd/ec_queue.py)
        # via _encode_object/_decode_chunks below, which fold concurrent
        # stripes into single launches.
        profile.setdefault("backend", "host")
        plugin = profile.pop("plugin", "rs")
        self.codec = factory(plugin, profile, device=self.osd.device)
        self.k = self.codec.get_data_chunk_count()
        self.n = self.codec.get_chunk_count()
        # oid -> (interval_epoch, raw snapset) from _authoritative_ss
        self._ss_cache: Dict[str, Tuple[int, bytes]] = {}

    async def _encode_object(self, data: bytes) -> Dict[int, np.ndarray]:
        """Full-object encode, batched across PGs on the device queue
        when the codec exposes a plain generator matrix (rs/jerasure/isa
        family); codec host path otherwise (lrc/shec layering).  In
        mesh mode the encode runs as ONE sharded device program where
        each mesh device computes its own shard (all_gather over the
        shard axis = the fan-out hop)."""
        gen = getattr(self.codec, "generator", None)
        ex = getattr(self.osd, "mesh_exec", None)
        if ex is not None and gen is not None:
            try:
                return await ex.encode_object(self.codec, data)
            except Exception as e:
                if not ex.host_fallback:
                    # off the CPU no other path may hide a failed launch
                    self.log_.error(f"mesh encode failed: {e}")
                    raise
                self.log_.warning(f"mesh encode failed ({e}); "
                                  f"falling back to batch queue")
        # per-loop collector: under threaded shards the daemon-wide
        # queue's wake event belongs to another loop (osd/shards.py)
        q = self.osd.ec_batch_queue() \
            if hasattr(self.osd, "ec_batch_queue") \
            else getattr(self.osd, "ec_queue", None)
        if gen is None or q is None:
            return self.codec.encode(set(range(self.n)), data)
        chunks = self.codec.split_data(data)
        # device-candidate:ec-encode@landed the live kernel call site: awaits
        # the cross-PG collector (LANE_BUCKETS-bucketed, executor
        # dispatch) — the loop never blocks on the device
        parity = await q.apply(gen[self.k:], chunks)
        out = {i: chunks[i] for i in range(self.k)}
        out.update({self.k + i: parity[i]
                    for i in range(self.n - self.k)})
        return out

    async def _decode_shards(self, want, streams: Dict[int, np.ndarray]
                             ) -> Dict[int, np.ndarray]:
        """Reconstruct `want` chunk ids from gathered shard streams —
        the decode twin of _encode_object.  Concurrent degraded reads
        and rebuild decodes sharing a survivor set fold into single
        device launches via the cross-PG batch collector (the queue
        groups by matrix bytes); mesh mode runs the sharded recover
        program (parallel/mesh_exec.py) instead.  Host codec when the
        codec has no plain generator (bitmatrix/lrc layering)."""
        want = sorted(set(want))
        out = {i: np.asarray(streams[i], np.uint8)
               for i in want if i in streams}
        missing = [w for w in want if w not in streams]
        if not missing:
            return out
        present = sorted(streams)[:self.k]
        if len(present) < self.k:
            # not enough survivors gathered — fail cleanly instead of
            # letting the matrix build crash on an empty submatrix
            raise ValueError(
                f"need {self.k} shards to decode, have {len(present)}")
        lens = {len(streams[i]) for i in present}
        if len(lens) != 1:
            # mixed generations slipped past the cohort check:
            # undecodable, same contract as the host codec path
            raise ValueError(f"mixed chunk lengths {sorted(lens)}")
        gen = getattr(self.codec, "generator", None)
        mat_for = getattr(self.codec, "decode_matrix_for", None)
        t0 = time.monotonic()
        ex = getattr(self.osd, "mesh_exec", None)
        if ex is not None and gen is not None:
            try:
                rec = await ex.recover_chunks(self.codec, missing,
                                              streams)
                out.update(rec)
                self._note_decode(t0)
                return out
            except Exception as e:
                if not ex.host_fallback:
                    self.log_.error(f"mesh decode failed: {e}")
                    raise
                self.log_.warning(f"mesh decode failed ({e}); "
                                  f"falling back to batch queue")
        q = self.osd.ec_batch_queue() \
            if hasattr(self.osd, "ec_batch_queue") \
            else getattr(self.osd, "ec_queue", None)
        if gen is None or mat_for is None or q is None:
            out.update(self.codec.decode_chunks(missing, streams))
            self._note_decode(t0)
            return out
        mat = mat_for(present, missing)
        src = np.stack([np.asarray(streams[i], np.uint8)
                        for i in present])
        # device-candidate:ec-decode@landed the live degraded-read/rebuild
        # decode call site: awaits the cross-PG collector
        # (LANE_BUCKETS-bucketed, executor dispatch) like encodes do
        dec = await q.apply(mat, src)
        out.update({w: dec[j] for j, w in enumerate(missing)})
        self._note_decode(t0)
        return out

    def _note_decode(self, t0: float) -> None:
        tr = self.osd.ctx.tracer
        if tr.enabled:
            tr.hist.hinc("decode_rebuild", time.monotonic() - t0)

    @property
    def my_shard(self) -> int:
        return self.pg.pgid.shard

    # ------------------------------------------------------------- writes
    async def submit_client_write(self, m: MOSDOp) -> int:
        pg = self.pg
        soid = pg.object_id(m.oid)
        _ops_materialize(m.ops)
        watch_ops = [op for op in m.ops if op.op == OP_WATCH]
        if watch_ops:
            for op in watch_ops:
                pg.handle_watch(m, op)
            if all(op.op == OP_WATCH for op in m.ops):
                return 0
        for op in m.ops:
            if not op.is_write():
                rv = await self._read_op(m.oid, op, m.snapid)
                if rv < 0:
                    return rv
        # cls write methods: xattr reads hit the local shard (xattrs
        # replicate everywhere), object size comes from SIZE_XATTR, and
        # whole-object data reads are refused (shards hold chunks) —
        # staged ops then translate like client ops, so a method
        # staging omap gets the same EOPNOTSUPP a client would
        from ceph_tpu_torch import cls as cls_mod

        def _no_data_read(offset=0, length=-1):
            raise cls_mod._DataReadUnsupported()

        def _ec_size():
            return int(self.osd.store.getattr(pg.cid, soid, SIZE_XATTR))

        rv, batch_ops = cls_mod.expand_write_calls(
            self.osd.store, pg.cid, soid, m.ops,
            read_fn=_no_data_read, size_fn=_ec_size)
        if rv < 0:
            return rv
        writes = [op for op in batch_ops
                  if op.is_write() and op.op != OP_WATCH]
        unsupported = {OP_WRITE, OP_APPEND, OP_ZERO, OP_OMAP_SET,
                       OP_OMAP_RM_KEYS, OP_OMAP_SET_HEADER}
        if any(op.op in unsupported for op in writes):
            return -errno.EOPNOTSUPP
        deletes = any(op.op == OP_DELETE for op in writes)
        # one txn PER SHARD, addressed at that shard's own collection
        # (each shard osd stores under <pool>.<seed>s<shard>_head);
        # full-object data is encoded in one device shot
        from ceph_tpu_torch.store.types import CollectionId
        cids = {i: CollectionId.pg(pg.pool_id, pg.pgid.seed, i)
                for i in range(self.n)}
        shard_txns: Dict[int, Transaction] = {
            i: Transaction() for i in range(self.n)}
        # clone-on-write: every shard clones ITS OWN chunk object in its
        # txn — no chunk bytes travel for the snapshot itself
        from ceph_tpu_torch.osd import snaps as snaps_mod
        snaps_mod.prepare_cow(
            pg, m.oid, m.snap_seq, m.snaps,
            [(shard_txns[i], cids[i], soid) for i in range(self.n)])
        # the write may have advanced the snapset: the survey cache
        # must not serve the pre-COW row to a later read-at-snap
        self._ss_cache.pop(m.oid, None)
        for op in [o for o in writes if o.op == OP_ROLLBACK]:
            try:
                src = snaps_mod.rollback_targets(pg, m.oid, soid,
                                                 op.offset)
            except KeyError:
                return -errno.ENOENT
            if src is not None:
                for i, t in shard_txns.items():
                    t.remove(cids[i], soid)
                    t.clone(cids[i], src, soid)
        writes = [op for op in writes if op.op != OP_ROLLBACK]
        # op tracing: guards/cls/cow so far = `prepare`; the writes loop
        # below holds the encode awaits = `ec_encode`
        span = m._span
        th = self.osd.ctx.tracer.hist if span is not None else None
        if span is not None:
            span.cut("prepare", th)
        from ceph_tpu_torch.common.crc import crc32c
        from ceph_tpu_torch.osd.scrub import CRC_XATTR
        empty_crc = str(crc32c(b"")).encode()
        for op in writes:
            if op.op == OP_WRITEFULL:
                chunks = await self._encode_object(op.data)
                for i in range(self.n):
                    t = shard_txns[i]
                    chunk_bytes = chunks[i].tobytes()
                    t.truncate(cids[i], soid, 0)
                    t.write(cids[i], soid, 0, chunk_bytes)
                    t.setattr(cids[i], soid, SIZE_XATTR,
                              str(len(op.data)).encode())
                    # per-shard digest (hinfo role, ECBackend.cc:1695):
                    # scrub verifies stored bytes against this
                    t.setattr(cids[i], soid, CRC_XATTR,
                              str(crc32c(chunk_bytes)).encode())
            elif op.op == OP_CREATE:
                for i, t in shard_txns.items():
                    t.touch(cids[i], soid)
                    t.setattr(cids[i], soid, SIZE_XATTR, b"0")
                    t.setattr(cids[i], soid, CRC_XATTR, empty_crc)
            elif op.op == OP_DELETE:
                for i, t in shard_txns.items():
                    t.remove(cids[i], soid)
            elif op.op == OP_TRUNCATE and op.offset == 0:
                for i, t in shard_txns.items():
                    t.truncate(cids[i], soid, 0)
                    t.setattr(cids[i], soid, SIZE_XATTR, b"0")
                    t.setattr(cids[i], soid, CRC_XATTR, empty_crc)
            elif op.op in (OP_SETXATTR,):
                for i, t in shard_txns.items():
                    t.setattr(cids[i], soid, op.name, op.data)
            elif op.op in (OP_RMXATTR,):
                for i, t in shard_txns.items():
                    t.rmattr(cids[i], soid, op.name)
            else:
                return -errno.EOPNOTSUPP
        if span is not None:
            span.cut("ec_encode", th)
        # SUBMIT SECTION — version assignment through fan-out send is
        # await-free, which is what makes this path re-entrant under
        # the per-PG op window: concurrent ops on disjoint objects each
        # take the next version atomically with their log append, so
        # pglog versions stay dense/ordered and queue_transactions
        # submission order == pglog order (the in-order commit
        # callbacks depend on it).  The old placement — version taken
        # BEFORE the encode awaits — would hand two concurrent ops the
        # same version.  Machine-checked by devtools rule AF01.
        # awaitfree:begin ec-submit
        version = pg.next_version()
        entry = LogEntry(LOG_DELETE if deletes else LOG_MODIFY, m.oid,
                         version, pg.info.last_update, m.reqid)
        if not deletes:
            for i, t in shard_txns.items():
                t.setattr(cids[i], soid, VERSION_XATTR,
                          version.to_bytes())
        # local shard applies in memory now; its durability overlaps
        # the sub-op fan-out (commit pipelining), and pglog
        # last_complete advances from the commit callback
        my = self.my_shard
        local_txn = shard_txns.get(my, Transaction())
        pg.append_log(local_txn, entry)
        commit_fut = self._queue_txn(
            local_txn, on_commit=lambda: pg.complete_to(version))
        if span is not None:
            span.cut("store_apply", th)
        # fan out to the other shards; each position also goes to its
        # UP holder when that differs from acting (pg_temp backfill
        # target keeps current while the complete copy serves).  The
        # log-entry payload is shared across every sub-op and each
        # position's txn payload across its acting+up targets, so over
        # TCP each body encodes at most once; local hops encode nothing
        log_payload = LazyPayload.seal(entry)
        txn_payloads: Dict[int, LazyPayload] = {}
        tid = self.osd.next_tid()
        peers = set()
        sends = []
        for i, osd_id in enumerate(pg.acting):
            targets = {osd_id}
            if i < len(pg.up):
                targets.add(pg.up[i])
            for t_osd in targets:
                # NOTE: no position filter here — even at the primary's
                # own position, the up-side backfill target must get the
                # write; only self is excluded
                if t_osd == self.osd.whoami or t_osd < 0 \
                        or t_osd == CRUSH_ITEM_NONE:
                    continue
                peers.add(t_osd)
                tp = txn_payloads.get(i)
                if tp is None:
                    tp = txn_payloads[i] = LazyPayload.seal(shard_txns[i])
                sub = MOSDECSubOpWrite(
                    pg.pgid.with_shard(i), tid, tp, log_payload,
                    version, self.osd.osdmap.epoch)
                if span is not None:
                    sub.trace_id = span.trace_id
                    sub.span_id = span.span_id
                sends.append((t_osd, sub))
        fut = self._ack_init(tid, peers)
        ex = getattr(self.osd, "mesh_exec", None)
        for osd_id, msg in sends:
            # mesh mode: co-located shard OSDs take the sub-op (chunk
            # bytes included) in process; acks still ride the messenger
            if ex is not None and ex.deliver(osd_id, msg,
                                             self.osd.whoami):
                continue
            self.osd.send_osd(osd_id, msg)
        if span is not None:
            span.cut("submit", th)
        # awaitfree:end ec-submit
        if not await self._await_acks(fut):
            self._inflight.pop(tid, None)
            return -errno.EAGAIN
        if span is not None:
            span.cut("replica_rtt", th)
        if not await self._await_commit(commit_fut):
            return -errno.EAGAIN
        if span is not None:
            span.cut("commit_wait", th)
        return 0

    # -------------------------------------------------------------- reads
    async def do_reads(self, m: MOSDOp) -> int:
        result = 0
        for op in m.ops:
            if op.op == OP_PGLS:
                names = [o.name for o in
                         self.osd.store.collection_list(self.pg.cid)
                         if o.name != self.pg.meta_oid.name
                         and o.is_head()]
                op.outdata = b"\x00".join(n.encode() for n in names)
                op.rval = len(names)
                continue
            if op.op == OP_NOTIFY:
                op.rval = await self.pg.handle_notify(m, op)
                if op.rval < 0 and result == 0:
                    result = op.rval
                continue
            if op.op == OP_LIST_SNAPS:
                op.rval = _list_snaps(self.pg, m.oid, op)
                continue
            rv = await self._read_op(m.oid, op, m.snapid)
            if rv < 0 and result == 0:
                result = rv
        return result

    async def _read_op(self, oid: str, op: OSDOp, snapid: int = 0) -> int:
        pg = self.pg
        from ceph_tpu_torch.osd import snaps as snaps_mod
        head = pg.object_id(oid)
        soid = head
        snap = 0
        if snapid:
            # resolve against the ACTING SET's snapset, not only our
            # own meta: a primary that adopted this pg mid-churn can
            # be missing the row, and head-serves-the-snap from the
            # missing row would return post-snapshot data
            ss = await self._authoritative_ss(oid)
            soid = snaps_mod.resolve_read(pg, oid, head, snapid, ss=ss)
            if soid is None:
                op.rval = -errno.ENOENT
                return op.rval
            snap = 0 if soid == head else soid.snap
        if op.op == OP_CALL:
            # read-class methods: local-shard xattrs/omap + SIZE_XATTR
            # size; whole-object data reads are refused on EC
            from ceph_tpu_torch import cls as cls_mod

            def _no_data_read(offset=0, length=-1):
                raise cls_mod._DataReadUnsupported()

            hctx = cls_mod.ClsContext(
                self.osd.store, pg.cid, soid, staged=None,
                read_fn=_no_data_read,
                size_fn=lambda: int(self.osd.store.getattr(
                    pg.cid, soid, SIZE_XATTR)))
            op.rval, op.outdata = cls_mod.call(op.name, hctx, op.data)
            return op.rval
        if op.op in (OP_GETXATTR, OP_GETXATTRS, OP_STAT, OP_CMPXATTR,
                     OP_ASSERT_EXISTS):
            # xattrs are replicated on every shard; size is in SIZE_XATTR
            if op.op == OP_STAT:
                try:
                    op.outdata = self._size_xattr(soid)
                    op.rval = 0
                except (NoSuchObject, NoSuchCollection):
                    op.rval = -errno.ENOENT
                return op.rval
            return execute_read_op(self.osd.store, pg.cid, soid, op)
        if op.op != OP_READ:
            op.rval = -errno.EOPNOTSUPP
            return op.rval
        try:
            size = int(self._size_xattr(soid))
        except (NoSuchObject, NoSuchCollection):
            if snap:
                # WE may be missing the clone chunk the acting set
                # holds (adopted mid-churn): the gather inside
                # _read_object can still decode it and carries the
                # cohort's SIZE_XATTR — defer the length to it
                size = None
            else:
                op.rval = -errno.ENOENT
                return op.rval
        whole = await self._read_object(oid, size, snap)
        if whole is None:
            op.rval = -errno.EIO
            return op.rval
        # slice against the COHORT length (len(whole)), not the local
        # size hint — they differ exactly when the local xattr is stale
        length = op.length if op.length else len(whole) - op.offset
        op.outdata = whole[op.offset:op.offset + length]
        op.rval = len(op.outdata)
        return op.rval

    def _stale_shards(self, oid: str) -> Set[int]:
        """Acting positions whose osd must not feed a decode of `oid`:
        still missing it (recovery window), or mid-backfill with the
        per-object cursor short of this name — the reference routes
        reads around backfill targets the same way
        (is_backfill_target gating, ReplicatedPG.cc:1575)."""
        from ceph_tpu_torch.osd.pglog import LB_MAX
        pg = self.pg
        out = set()
        for i, osd_id in enumerate(pg.acting):
            pm = pg.peer_missing.get(osd_id)
            if pm is not None and oid in pm:
                out.add(i)
            pi = pg.peer_info.get(osd_id)
            if pi is not None and pi.last_backfill != LB_MAX \
                    and oid > pi.last_backfill:
                out.add(i)
        return out

    def _size_xattr(self, soid) -> bytes:
        """Our shard's SIZE_XATTR.  An object that a setxattr made, with
        no data written, has none: it reads as absent, as on MemStore,
        on every store (the JAX package's BlockStore raises a bare
        StoreError there, and the op fails)."""
        attrs = self.osd.store.getattrs(self.pg.cid, soid)
        if SIZE_XATTR not in attrs:
            raise NoSuchObject(f"xattr {SIZE_XATTR} on {soid}")
        return attrs[SIZE_XATTR]

    def _stray_sources(self) -> List[Tuple[int, int]]:
        """(shard, osd) pairs off the acting set that may hold a shard of
        the PG: each member of the last peering's prior set and of every
        past interval, for the position it held there; up OSDs only."""
        pg = self.pg
        seen = set()
        pairs = list(pg._probe_shards.items())
        for iv in pg.past_intervals:
            pairs += [(o, pos) for pos, o in enumerate(iv.acting)]
        for o, i in pairs:
            if (o < 0 or o == CRUSH_ITEM_NONE or o == self.osd.whoami
                    or not 0 <= i < len(pg.acting) or pg.acting[i] == o
                    or not self.osd.osdmap.is_up(o)):
                continue
            seen.add((i, o))
        return sorted(seen)

    def _auth_version(self, oid: str) -> Optional[bytes]:
        """The object's authoritative version per our log (None when the
        object predates the log window): the guard that keeps a decode
        from silently mixing or serving an older generation."""
        e = self.pg.log.latest_entry_for(oid)
        if e is None or e.is_delete():
            return None
        return e.version.to_bytes()

    async def _gather_shards(self, oid: str,
                             exclude: Set[int] = frozenset(),
                             snap: int = 0,
                             want_version: Optional[bytes] = None
                             ) -> Optional[Tuple[Dict[int, np.ndarray],
                                                 Dict[str, bytes]]]:
        """Collect >=k consistent shard streams (minimum_to_decode
        role).  First pass routes around _stale_shards (peers the
        primary BELIEVES are missing/mid-backfill); if that guess
        starves the gather below k, retry including them — the
        peer_missing set is a log-delta over-approximation and peers
        often hold the current version anyway (found by qa/rados_model:
        two shards each excluded for the other's sake deadlocked
        recovery, then reads, on a healthy object).  `want_version`
        (from the primary's log) is the stale-serve guard either way."""
        first = set(exclude) | self._stale_shards(oid)
        got = await self._gather_once(oid, first, snap, want_version)
        if got is None and first != set(exclude):
            got = await self._gather_once(oid, set(exclude), snap,
                                          want_version)
        return got

    async def _authoritative_ss(self, oid: str):
        """The object's SnapSet as the ACTING SET knows it: highest
        seq wins across our row and every reachable shard's.  A
        primary that adopted the pg mid-churn can be missing the row
        (or hold a stale one) while its peers carry the truth — and a
        head-serves-the-snap resolution from the stale row would
        return post-snapshot data (found by qa/rados_model seed 306).
        Surveyed CONCURRENTLY, cached per (oid, interval) — one survey
        per object per acting set, not per read — and self-heals our
        meta when a peer's row beats ours.  (Replicated pools don't
        need this: their COW metadata rides the replicated write txn
        itself, and MPGPush v2 carries it on every push.)"""
        from ceph_tpu_torch.osd import snaps as snaps_mod
        pg = self.pg
        epoch = pg.interval_epoch
        hit = self._ss_cache.get(oid)
        if hit is not None and hit[0] == epoch:
            raw = hit[1]
            return snaps_mod.SnapSet.from_bytes(raw) if raw else None
        local = snaps_mod.load_snapset(self.osd.store, pg.cid,
                                       pg.meta_oid, oid)
        best, best_raw = local, \
            (local.to_bytes() if local is not None else b"")

        async def ask(i: int, osd_id: int):
            tid = self.osd.next_tid()
            fut = asyncio.get_running_loop().create_future()
            self._inflight[tid] = ({osd_id}, fut)
            msg = MOSDECSubOpRead(pg.pgid.with_shard(i), tid,
                                  [(oid, 0, 0)])
            msg.want_ss = True
            self.osd.send_osd(osd_id, msg)
            try:
                return await asyncio.wait_for(fut, 5.0)
            except asyncio.TimeoutError:
                self._inflight.pop(tid, None)
                return None

        peers = [(i, o) for i, o in enumerate(pg.acting)
                 if o != CRUSH_ITEM_NONE and i != self.my_shard
                 and self.osd.osdmap.is_up(o)]
        replies = await asyncio.gather(
            *[ask(i, o) for i, o in peers], return_exceptions=True)
        for reply in replies:
            if isinstance(reply, PGIntervalChanged):
                raise reply    # stale acting snapshot: caller retries
            if isinstance(reply, BaseException) or reply is None \
                    or not reply.ss:
                continue
            cand = snaps_mod.SnapSet.from_bytes(reply.ss)
            if best is None or cand.seq > best.seq:
                best, best_raw = cand, reply.ss
        if best is not None and (local is None or local.seq < best.seq):
            txn = Transaction()
            txn.omap_setkeys(pg.cid, pg.meta_oid,
                             {snaps_mod.ss_key(oid): best_raw})
            self.osd.store.apply_transaction(txn)
        self._ss_cache[oid] = (epoch, best_raw)
        return best

    async def _gather_once(self, oid: str, exclude: Set[int],
                           snap: int,
                           want_version: Optional[bytes]
                           ) -> Optional[Tuple[Dict[int, np.ndarray],
                                               Dict[str, bytes]]]:
        pg = self.pg
        soid = pg.object_id(oid)
        if snap:
            soid = soid.with_snap(snap)
        streams: Dict[int, np.ndarray] = {}
        attrs: Dict[str, bytes] = {}
        shard_attrs: Dict[int, Dict[str, bytes]] = {}
        shard_vers: Dict[int, bytes] = {}
        my = self.my_shard
        candidates: List[int] = []
        for i, osd_id in enumerate(pg.acting):
            if osd_id == CRUSH_ITEM_NONE or i in exclude:
                continue
            if i == my:
                from ceph_tpu_torch.osd.pglog import LB_MAX
                try:
                    my_attrs = self.osd.store.getattrs(pg.cid, soid)
                    if pg.info.last_backfill != LB_MAX \
                            and oid > pg.info.last_backfill \
                            and VERSION_XATTR not in my_attrs:
                        # OUR OWN copy is mid-backfill, this name is
                        # past the durable cursor AND versionless: an
                        # untrusted half-copy — the same read gate
                        # _handle_ec_sub_read applies for peers
                        # (PG.h:1911).  A versioned row still joins
                        # the gather; the cohort check judges it.
                        continue
                    streams[i] = np.frombuffer(
                        self.osd.store.read(pg.cid, soid), np.uint8)
                    attrs = my_attrs
                    shard_attrs[i] = attrs
                    shard_vers[i] = attrs.get(VERSION_XATTR, b"")
                except (NoSuchObject, NoSuchCollection):
                    pass
            else:
                candidates.append(i)
        need = self.k - len(streams)

        async def ask_shard(i: int, osd_id: Optional[int] = None):
            if osd_id is None:
                osd_id = pg.acting[i]
            tid = self.osd.next_tid()
            fut = asyncio.get_running_loop().create_future()
            self._inflight[tid] = ({osd_id}, fut)
            self.osd.send_osd(osd_id, MOSDECSubOpRead(
                pg.pgid.with_shard(i), tid, [(oid, 0, -1)], snap=snap))
            try:
                reply: MOSDECSubOpReadReply = \
                    await asyncio.wait_for(fut, 15.0)
            except (asyncio.TimeoutError, PGIntervalChanged):
                self._inflight.pop(tid, None)
                raise
            return i, reply

        # fan out to exactly `need` candidates CONCURRENTLY — a
        # degraded k-shard read is one RTT, not k sequential ones —
        # topping up from the remaining candidates (preference order
        # preserved) as refusals and timeouts come back
        pending = list(candidates)
        while need > 0 and pending:
            wave, pending = pending[:need], pending[need:]
            replies = await asyncio.gather(
                *[ask_shard(i) for i in wave], return_exceptions=True)
            interval_err = None
            for r in replies:
                if isinstance(r, PGIntervalChanged):
                    # don't degrade the gather to EIO — abort the whole
                    # op so the caller retries under the new acting set
                    interval_err = r
                    continue
                if isinstance(r, BaseException):
                    continue
                i, reply = r
                if reply.result == 0 and reply.data:
                    streams[i] = np.frombuffer(reply.data[0], np.uint8)
                    if reply.attrs:
                        attrs = reply.attrs
                        shard_attrs[i] = reply.attrs
                        shard_vers[i] = reply.attrs.get(
                            VERSION_XATTR, b"")
                    need -= 1
            if interval_err is not None:
                raise interval_err
        if need > 0 and want_version is not None:
            # an out/in can move the acting positions off the OSDs that
            # hold the object's shards: fewer than k are left in place
            # while the earlier holders keep theirs as strays.  Ask
            # those, each for the shard it held, for exactly the version
            # the log names (the role of the stray sources in Ceph's
            # missing_loc); the JAX package asks the acting set alone,
            # and the object stays unrecoverable for good
            strays = [(i, o) for i, o in self._stray_sources()
                      if i not in streams and i not in exclude]
            replies = await asyncio.gather(
                *[ask_shard(i, o) for i, o in strays],
                return_exceptions=True)
            interval_err = None
            for r in replies:
                if isinstance(r, PGIntervalChanged):
                    interval_err = r
                    continue
                if isinstance(r, BaseException):
                    continue
                i, reply = r
                if (reply.result == 0 and reply.data and i not in streams
                        and reply.from_shard == i
                        and reply.attrs.get(VERSION_XATTR) == want_version):
                    streams[i] = np.frombuffer(reply.data[0], np.uint8)
                    attrs = reply.attrs
                    shard_attrs[i] = reply.attrs
                    shard_vers[i] = want_version
            if interval_err is not None:
                raise interval_err
        if len(streams) < self.k:
            return None
        lens = {len(s) for s in streams.values()}
        vers = {shard_vers.get(i, b"") for i in streams}
        if (want_version is not None and len(lens) == 1
                and vers == {want_version}):
            return streams, attrs        # exact generation, consistent
        if len(lens) > 1 or len(vers) > 1 or (
                want_version is not None
                and vers != {want_version}):
            # mixed generations: a shard mid-recovery (or racing an
            # overwrite) returned a stale chunk.  Length alone can't
            # detect the common fixed-block (RBD) case — a same-size
            # overwrite one shard missed yields same-length,
            # mixed-generation shards, and decoding across generations
            # reconstructs garbage SILENTLY — so the cohort must also
            # agree on VERSION_XATTR.  Pull every remaining candidate
            # and decode from the best consistent cohort.
            rest = [i for i in candidates if i not in streams]
            replies = await asyncio.gather(
                *[ask_shard(i) for i in rest], return_exceptions=True)
            interval_err = None
            for r in replies:
                if isinstance(r, PGIntervalChanged):
                    interval_err = r
                    continue
                if isinstance(r, BaseException):
                    continue
                i, reply = r
                if reply.result == 0 and reply.data:
                    streams[i] = np.frombuffer(reply.data[0], np.uint8)
                    if reply.attrs:
                        shard_attrs[i] = reply.attrs
                        shard_vers[i] = reply.attrs.get(VERSION_XATTR,
                                                        b"")
            if interval_err is not None:
                raise interval_err
            cohorts: Dict[tuple, Dict[int, np.ndarray]] = {}
            for i, s in streams.items():
                cohorts.setdefault(
                    (len(s), shard_vers.get(i, b"")), {})[i] = s
            if want_version is not None:
                # authoritative version known (primary log): ONLY that
                # generation may serve — a quorum of stale shards must
                # fail the gather, never decode as if current
                cohorts = {key: c for key, c in cohorts.items()
                           if key[1] == want_version}
                if not cohorts:
                    return None

            def cohort_score(cohort):
                # the NEWEST generation wins, cohort size breaks ties —
                # equal-sized cohorts must never resolve by dict order
                # (an acked overwrite could read back its old bytes)
                vs = [EVersion.from_bytes(shard_vers[i])
                      for i in cohort if shard_vers.get(i)]
                top = max(vs) if vs else EVersion()
                return (top, len(cohort))

            best = max(cohorts.values(), key=cohort_score)
            if len(best) < self.k:
                return None
            streams = best
        # attrs must describe the RETURNED cohort, not whichever shard
        # replied last: a stale generation's SIZE_XATTR would silently
        # truncate fresh decoded bytes downstream
        attrs = next((shard_attrs[i] for i in streams
                      if shard_attrs.get(i)), attrs)
        return streams, attrs

    async def _read_object(self, oid: str, size: Optional[int],
                           snap: int = 0) -> Optional[bytes]:
        # a gather can transiently starve while shards are down or
        # mid-recovery: WAIT like the reference (ReplicatedPG
        # wait_for_degraded_object) instead of failing the read — an
        # EIO here reads as data loss to the client during windows
        # that heal themselves in under a second
        from ceph_tpu_torch.common.backoff import Backoff, BackoffGiveUp
        pg = self.pg
        epoch = pg.interval_epoch
        bo = Backoff("degraded_read", base=0.05, cap=0.5, timeout=8.0,
                     perf=getattr(self.osd, "perf_recovery", None))
        while True:
            got = await self._gather_shards(
                oid, snap=snap,
                want_version=None if snap else self._auth_version(oid))
            if got is not None:
                break
            if epoch != pg.interval_epoch:
                raise PGIntervalChanged(
                    f"pg {pg.pgid} interval changed during read")
            try:
                await bo.sleep()
            except BackoffGiveUp:
                return None    # caller maps to EIO after the budget
        streams, gattrs = got
        from ceph_tpu_torch.ec.interface import ErasureCodeError
        try:
            # degraded-read rebuild: decode through the cross-PG batch
            # collector, so concurrent recovery-window reads fold
            # their decodes into single launches like writes do
            decoded = await self._decode_shards(range(self.k), streams)
            data = b"".join(np.asarray(decoded[i]).tobytes()
                            for i in range(self.k))
        except (ErasureCodeError, ValueError):
            # ValueError: mixed-generation chunk lengths — undecodable
            return None
        # the LOGICAL length must come from the same version-checked
        # cohort as the bytes: a primary that adopted the pg mid-churn
        # can hold a stale local SIZE_XATTR, and slicing fresh bytes
        # to a stale length returns silently truncated/padded data
        # (qa/rados_model seed 431)
        if SIZE_XATTR in gattrs:
            try:
                size = int(gattrs[SIZE_XATTR])
            except ValueError:
                pass
        if size is None:
            return None    # no length from any cohort member: EIO
        return data[:size]

    # ----------------------------------------------------------- recovery
    async def _send_push_and_wait(self, peer: int, oid: str,
                                  msg: MPGPush) -> None:
        """Send a prebuilt push and await its ack (one copy of the
        future-register/timeout/cleanup plumbing).  The wait budget is
        the shared backoff policy's (osd_recovery_push_timeout), so a
        dead target surfaces as a cause-tagged counted give-up."""
        from ceph_tpu_torch.common.backoff import Backoff
        pg = self.pg
        bo = Backoff("push_ack", perf=getattr(self.osd,
                                              "perf_recovery", None),
                     timeout=float(
                         self.osd.cfg["osd_recovery_push_timeout"]))
        fut = asyncio.get_running_loop().create_future()
        pg._push_acks[(peer, oid)] = fut
        try:
            self.osd.send_osd(peer, msg)
            await bo.wait_for(fut)
            perf = getattr(self.osd, "perf_recovery", None)
            if perf is not None:
                perf.inc("objects_pushed")
                perf.inc("push_bytes",
                         len(msg.data or b"")
                         + sum(len(c[1]) for c in msg.clones))
        finally:
            pg._push_acks.pop((peer, oid), None)

    def _txn_install_clones(self, txn, soid, clones) -> None:
        pg = self.pg
        for c, cdata, cattrs in clones:
            csoid = soid.with_snap(c)
            txn.remove(pg.cid, csoid)
            txn.write(pg.cid, csoid, 0, cdata)
            txn.setattrs(pg.cid, csoid, cattrs)

    async def _rebuild_clones(self, oid: str, target: int, exclude):
        """Reconstruct `target`'s clone chunks by decoding over the
        peers' clone chunks (the erasure relation holds per clone —
        every shard cloned its own chunk at COW).  Returns (snapset
        bytes, [(clone_id, bytes, attrs)]) — or (None, []) when the
        object has no snap state OR any clone gather failed: a partial
        claim would make the receiver's apply_push wipe clones we
        cannot replace."""
        pg = self.pg
        from ceph_tpu_torch.common.crc import crc32c
        from ceph_tpu_torch.osd.scrub import CRC_XATTR
        from ceph_tpu_torch.osd.snaps import load_snapset
        ss = load_snapset(self.osd.store, pg.cid, pg.meta_oid, oid)
        if ss is None:
            return None, []
        out = []
        for c in ss.clones:
            cgot = await self._gather_shards(
                oid, exclude={target} | set(exclude), snap=c)
            if cgot is None:
                return None, []    # incomplete: claim nothing
            cstreams, cattrs = cgot
            crebuilt = (await self._decode_shards(
                [target], cstreams))[target].tobytes()
            # keep the clone's xattrs (SIZE_XATTR drives snap reads);
            # only the per-shard digest is its own
            cattrs = dict(cattrs)
            cattrs[CRC_XATTR] = str(crc32c(crebuilt)).encode()
            out.append((c, crebuilt, cattrs))
        return ss.to_bytes(), out

    async def recover_object(self, peer: int, oid: str,
                             exclude=frozenset(),
                             progress: str = "") -> None:
        """Rebuild the peer's shard from k others and push it
        (continue_recovery_op / minimum_to_decode role).  `exclude` adds
        shards scrub found corrupt, kept out of the gather."""
        pg = self.pg
        target = pg.shard_of(peer)
        soid = pg.object_id(oid)
        # object deleted? push tombstone — but a deleted HEAD's clones
        # legitimately survive (snapdir role) and must still rebuild
        try:
            attrs = self.osd.store.getattrs(pg.cid, soid)
        except (NoSuchObject, NoSuchCollection):
            ssb, clones = await self._rebuild_clones(oid, target,
                                                     exclude)
            msg = MPGPush(pg.pgid.with_shard(target), oid,
                          pg.info.last_update,
                          from_osd=self.osd.whoami, deleted=True)
            msg.backfill_progress = progress
            if ssb is not None:
                msg.has_snap_state = True
                msg.snapset = ssb
                msg.clones = clones
            await self._send_push_and_wait(peer, oid, msg)
            return
        got = await self._gather_shards(
            oid, exclude={target} | set(exclude),
            want_version=self._auth_version(oid))
        if got is None:
            raise RuntimeError(f"{pg.pgid}: cannot reconstruct {oid} "
                               f"for shard {target}: insufficient shards")
        streams, _ = got
        # device-candidate:decode-rebuild@landed whole-PG rebuild decodes
        # through the batch collector: _recover feeds windows of
        # objects concurrently, so their decodes fold into single
        # LANE_BUCKETS launches (or the pjit recover program in mesh
        # mode) instead of one host decode per object
        rebuilt = (await self._decode_shards([target], streams))[target]
        # the digest xattr is PER SHARD: the rebuilt chunk gets its own,
        # never a copy of ours (scrub would flag it forever)
        from ceph_tpu_torch.common.crc import crc32c
        from ceph_tpu_torch.osd.scrub import CRC_XATTR
        attrs = dict(attrs)
        attrs[CRC_XATTR] = str(crc32c(rebuilt.tobytes())).encode()
        msg = MPGPush(
            pg.pgid.with_shard(target), oid, pg.info.last_update,
            rebuilt.tobytes(), attrs, {}, b"", self.osd.whoami)
        msg.backfill_progress = progress
        ssb, clones = await self._rebuild_clones(oid, target, exclude)
        if ssb is not None:
            msg.has_snap_state = True
            msg.snapset = ssb
            msg.clones = clones
        await self._send_push_and_wait(peer, oid, msg)

    async def pull_object(self, peer: int, oid: str, epoch: int,
                          exclude=frozenset()) -> None:
        """Primary self-heal: reconstruct OUR OWN shard from k peers.
        A whole-object pull would install the peer's (foreign) shard
        bytes as ours and silently corrupt every later decode."""
        pg = self.pg
        my = self.my_shard
        soid = pg.object_id(oid)
        got = await self._gather_shards(
            oid, exclude={my} | set(exclude),
            want_version=self._auth_version(oid))
        if got is None:
            latest = pg.log.latest_entry_for(oid)
            if latest is not None and latest.is_delete():
                # genuinely deleted per our log: drop the local shard.
                # `latest is None` proves NOTHING — old objects fall out
                # of the log window, and during full resync the adopted
                # log is exactly one whose window has closed.  A deleted
                # head's clones survive (snapdir role): rebuild ours too
                txn = Transaction()
                txn.remove(pg.cid, soid)
                ssb, clones = await self._rebuild_clones(
                    oid, self.my_shard, exclude)
                if ssb is not None:
                    self._txn_install_clones(txn, soid, clones)
                self.osd.store.apply_transaction(txn)
                return
            # the log says this object EXISTS: an insufficient gather is
            # a transient failure (peers down/backfilling), never a
            # license to delete — raise so the caller retries (this
            # exact confusion erased committed shards under churn;
            # qa/rados_model seed 101)
            raise RuntimeError(
                f"{pg.pgid}: cannot reconstruct {oid}: insufficient "
                f"shards (transient)")
        streams, attrs = got
        rebuilt = (await self._decode_shards([my], streams))[my]
        blob = rebuilt.tobytes()
        from ceph_tpu_torch.common.crc import crc32c
        from ceph_tpu_torch.osd.scrub import CRC_XATTR
        attrs = dict(attrs)
        attrs[CRC_XATTR] = str(crc32c(blob)).encode()
        txn = Transaction()
        txn.remove(pg.cid, soid)
        txn.write(pg.cid, soid, 0, blob)
        if attrs:
            txn.setattrs(pg.cid, soid, attrs)
        # rebuild OUR clone chunks the same way (decode over the peers'
        # clone chunks); all-or-nothing — a partial rebuild must not
        # replace clones it couldn't reconstruct
        # our SnapSet row may be missing with the object: take the acting
        # set's before rebuilding the clones it lists
        await self._authoritative_ss(oid)
        ssb, clones = await self._rebuild_clones(oid, my, exclude)
        if ssb is not None:
            self._txn_install_clones(txn, soid, clones)
        pg.save_meta(txn)
        self.osd.store.apply_transaction(txn)
        # a self-reconstructed shard IS the EC rebuild landing: count
        # it exactly like a received push (recovery_bytes accounts
        # bytes landed on the recovering OSD, whoever produced them)
        nbytes = len(blob) + sum(len(cd) for _, cd, _ in clones)
        perf = getattr(self.osd, "perf_osd", None)
        if perf is not None:
            perf.inc("recovery_bytes", nbytes)
        rec = getattr(self.osd, "perf_recovery", None)
        if rec is not None:
            rec.inc("objects_pulled")
            rec.inc("pull_bytes", nbytes)

    # ------------------------------------------------------------ sub-ops
    async def handle_sub_message(self, m) -> None:
        if isinstance(m, MOSDECSubOpWrite):
            self._apply_ec_sub_write(m)
        elif isinstance(m, MOSDECSubOpRead):
            self._handle_ec_sub_read(m)

    def sub_write_fast(self, m) -> bool:
        if isinstance(m, MOSDECSubOpWrite):
            self._apply_ec_sub_write(m)
            return True
        return False

    def _apply_ec_sub_write(self, m) -> None:
        """Shard write sub-op apply: SYNCHRONOUS by contract (no
        suspension point), so the sharded plane's classify seam may
        run it inline off the shard ring (sub_write_fast) without a
        queue/worker hop when nothing is queued ahead."""
        pg = self.pg
        if m.map_epoch < pg.info.same_interval_since:
            # stale-interval shard write: same drop rule as the
            # replicated sub-op path (see ReplicatedBackend) — a
            # closed interval's fan-out must not append to a log
            # the new interval already peered over; release its
            # extent slots like any other terminal outcome
            extents.release_message(m)
            return
        rt = self._repl_trace(m)
        # copy discipline: mutable txn copy, shared immutable entry
        # (see ReplicatedBackend.handle_sub_message)
        txn = m.txn()
        entry = m.log_entry()
        advance = None
        if pg.log.head < entry.version:
            pg.log.append(entry)
            pg.note_reqid(entry)
            pg.info.last_update = entry.version
            if not pg.missing:
                # a copy still owed recovery pushes must keep its
                # honest last_complete cursor, or the gap hides
                advance = entry.version
        pg.save_meta_log(txn, entry)
        src = int(m.src_name.id)
        reply = MOSDECSubOpWriteReply(pg.pgid, m.tid, 0,
                                      self.my_shard, self.osd.whoami)
        if rt is not None:
            rt.applied()

        def _committed():
            # EC sub-op ack + last_complete ride the commit callback
            # in submission order (see MOSDRepOp above); extents
            # retire here and the ack coalesces per drained burst
            extents.release_message(m)
            if advance is not None:
                pg.complete_to(advance)
            if rt is not None:
                rt.committed()
            self.osd.queue_rep_ack(src, reply)

        self.osd.store.queue_transactions([txn],
                                          on_commit=_committed)
    def _handle_ec_sub_read(self, m) -> None:
        from ceph_tpu_torch.osd.pglog import LB_MAX
        pg = self.pg
        data, attrs = [], {}
        result = 0
        for oid, off, ln in m.reads:
            # mid-backfill read gate (the reference's last_backfill
            # gate, PG.h:1911): past OUR durable cursor the local
            # object SET is not authoritative.  An object we hold WITH
            # a version xattr is still a coherent generation — serve
            # it and let the primary's version-cohort check judge it
            # (refusing those too deadlocks peering-time heals against
            # the backfill that would advance our cursor).  An ABSENT
            # or versionless name past the cursor answers EAGAIN, not
            # ENOENT: the primary must route around the half-copy,
            # never mistake a backfill hole for deletion.
            past_cursor = pg.info.last_backfill != LB_MAX \
                and oid > pg.info.last_backfill
            soid = pg.object_id(oid)
            if m.snap:
                soid = soid.with_snap(m.snap)
            try:
                blob = self.osd.store.read(
                    pg.cid, soid, off, ln if ln >= 0 else -1)
                oattrs = self.osd.store.getattrs(pg.cid, soid)
                if past_cursor and VERSION_XATTR not in oattrs:
                    result = -errno.EAGAIN
                    data.append(b"")
                    continue
                data.append(blob)
                attrs = oattrs
            except (NoSuchObject, NoSuchCollection):
                result = -errno.EAGAIN if past_cursor \
                    else -errno.ENOENT
                data.append(b"")
        reply = MOSDECSubOpReadReply(
            pg.pgid, m.tid, self.my_shard, result, data, attrs)
        if m.want_ss and m.reads:
            # attach OUR SnapSet row: the primary may have adopted
            # the pg without it and needs the acting set's truth
            # to resolve reads-at-snap.  A shard mid-adoption may
            # lack the meta object entirely — that's "no row", not
            # a dropped reply (the survey would eat a timeout)
            from ceph_tpu_torch.osd.snaps import ss_key
            try:
                raw = self.osd.store.omap_get_values(
                    pg.cid, pg.meta_oid, [ss_key(m.reads[0][0])])
                reply.ss = next(iter(raw.values()), b"")
            except (NoSuchObject, NoSuchCollection):
                pass
        self.osd.send_osd(int(m.src_name.id), reply)
