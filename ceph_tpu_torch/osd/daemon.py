"""OSD daemon: boot, maps, heartbeats, op routing.

Reference parity: osd/OSD.{h,cc} — boot handshake with the mon
(MOSDBoot), osdmap subscription + per-PG advance
(handle_osd_map/advance_pg), fast dispatch of client ops to PG queues
(ms_fast_dispatch :6003 → enqueue_op :8598 → ShardedOpWQ :8790 — here
each PG's asyncio worker), osd↔osd heartbeats (:4223 heartbeat,
:4009 handle_osd_ping) with failure reports to the mon
(mon/OSDMonitor.cc prepare_failure).

The port's copy of ``ceph_tpu.osd.daemon``.  An OSD takes a ``device``
(default ``cuda``; raises without a card) for its EC batch queues and its
batched CRUSH placement: on a card the epoch advance and backfill
planning launch the device descent, on the CPU they take the host engine.
PGs that miss the same full map share one fetch of it from the mon
(``ensure_map_history``), where the JAX package's fetch it once each; and
with the sharded data plane each epoch's map is a copy of its own, kept
for later interval walks, where the JAX package's shards advance against
the MonClient's map while the next incremental mutates it, and its walks
decode and prime each epoch's map anew.  An up_thru request asks for the
waiting PG's interval start, where the JAX package's asks for its current
epoch.  Scheduled scrubs take clean PGs only, where the JAX package's
scrub every active PG, recovering ones too.
With process lanes each lane worker builds its OSD on this one's device.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import errno
import threading
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          placement_engine, resolve_device)
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.msg.types import EntityAddr, EntityName
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.messages import MLog, MPGStats
from ceph_tpu_torch.mon.messages import MOSDAlive, MOSDBoot, MOSDFailure
from ceph_tpu_torch.mon.monmap import MonMap
from ceph_tpu_torch.osd.messages import (
    MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDECSubOpWrite,
    MOSDECSubOpWriteReply, MOSDOp, MOSDOpBatch, MOSDOpReply, MOSDPing,
    MOSDRepAckBatch, MOSDRepOp, MOSDRepOpReply, MPGLog, MPGLogRequest,
    MPGNotify, MPGObjectList, MPGPush, MPGPushReply, MPGQuery, MPGRemove,
    MPGScrub, MPGScrubMap, MPGScrubScan, MWatchNotifyAck,
)
from ceph_tpu_torch.osd import extents
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.pg import PG
from ceph_tpu_torch.osd.types import NO_SHARD, PGId
from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
from ceph_tpu_torch.store.objectstore import ObjectStore, Transaction


#: how many (pool, epoch) entries of interval walk rows an OSD keeps
#: (``OSD.interval_row``; twice this before it drops the older half)
INTERVAL_ROW_EPOCHS = 512

#: message classes whose handling touches PG state — classified to the
#: PG's home shard by the sharded data plane (ms_fast_dispatch ->
#: ShardedOpWQ seam); everything else is daemon-scope and stays on the
#: intake loop
_PG_BOUND = (MOSDOp, MOSDRepOp, MOSDECSubOpWrite, MOSDECSubOpRead,
             MOSDRepOpReply, MOSDECSubOpWriteReply, MOSDECSubOpReadReply,
             MPGQuery, MPGRemove, MPGNotify, MPGLogRequest, MPGLog,
             MPGPush, MPGPushReply, MPGObjectList, MWatchNotifyAck,
             MPGScrub, MPGScrubScan, MPGScrubMap)


class _ShardIntake:
    """messenger.shard_router: the intake-side classify seam.  The
    messenger calls wants()/deliver() for each inbound message; a
    PG-bound message lands on its home shard's ring WITHOUT touching
    the per-sender intake queue machinery (one batched wakeup per
    burst instead of one queue round-trip per message)."""

    __slots__ = ("osd",)

    def __init__(self, osd: "OSD"):
        self.osd = osd

    def wants(self, m: Message) -> bool:
        return isinstance(m, _PG_BOUND) or isinstance(m, MOSDOpBatch)

    def deliver(self, m: Message) -> None:
        osd = self.osd
        if osd.shards.perf is not None:
            osd.shards.perf.inc("direct_local_ops")
        if isinstance(m, MOSDOpBatch):
            osd._dispatch_op_batch(m)
        elif not osd._park_ahead_of_map(m):
            # post(), never inline: deliver() runs on the SENDER's
            # call stack (LocalConnection.send / the TCP reader) — an
            # inline dispatch would execute the receiver's apply
            # depth-first inside the sender's fan-out, serializing
            # the very pipeline the shards exist to widen.  The ring
            # pump is the execution context (where the sub-op inline
            # fast path then legally skips the PG queue hop).
            osd.shards.shard_for(m.pgid).post(osd._dispatch_pg_msg, m)


class OSD(Dispatcher):
    def __init__(self, ctx, whoami: int, store: ObjectStore,
                 messenger: Messenger, monmap: MonMap,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.ctx = ctx
        #: the device of the EC batch queues and of batched placement
        self.device = resolve_device(device)
        #: the CRUSH engine of the epoch advance and backfill planning
        self.crush_engine = placement_engine(self.device)
        #: batched placement calls by site; on a card each is one launch
        #: of the CRUSH descent kernel
        self.crush_batches = {"epoch": 0, "backfill": 0}
        self._crush_batches_lock = threading.Lock()
        self.cfg = ctx.config
        self.logger = ctx.logger("osd")
        self.whoami = whoami
        self.store = store
        self.messenger = messenger
        messenger.add_dispatcher(self)
        self.monc = MonClient(ctx, messenger, monmap)
        self.osdmap = OSDMap()
        self.pgs: Dict[PGId, PG] = {}
        # ESC12 fix: `self._tid += 1` was a read-modify-write shared
        # across shard lanes — two threaded shards could mint the SAME
        # tid (duplicate sub-op/scrub ids).  itertools.count.__next__
        # runs in C, so next() is one GIL-atomic step per caller
        import itertools
        self._tid = itertools.count(1)
        self._hb_last: Dict[int, float] = {}     # peer osd -> last reply
        self._map_cache: Dict[int, OSDMap] = {}
        # epoch -> the fetch of that full map from the mon in flight
        # (ensure_map_history); shared across PGs and shard threads
        self._map_fetches: Dict[int, concurrent.futures.Future] = {}
        self._map_fetch_lock = threading.Lock()
        self._hb_task: Optional[asyncio.Task] = None
        self._boot_task: Optional[asyncio.Task] = None
        self._waiting_maps: List[Message] = []
        # (pool, epoch) -> (pool, up_thru by OSD, {pg: (up, acting,
        # primary)}) for interval walks (interval_row)
        self._interval_rows: Dict[Tuple[int, int], tuple] = {}
        # appends land from shard pumps (threaded mode) while the
        # intake loop swaps the list per map epoch: lock the pair
        # so a racing append can never strand a message on the
        # captured old list (a dropped sub-op has no resender)
        self._wm_lock = threading.Lock()
        self.running = False
        from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
        self.ec_queue = ECBatchQueue(
            ctx, mode=self.cfg["osd_ec_batch_device"],
            window_ms=self.cfg["osd_ec_batch_window_ms"],
            min_device_bytes=self.cfg["osd_ec_batch_min_bytes"],
            flush_bytes=self.cfg["osd_ec_batch_flush_bytes"],
            device=self.device)
        self.perf_scrub = ctx.perf.create("osd_scrub")
        for key in ("scrubs_light", "scrubs_deep", "scrub_errors",
                    "scrub_repaired"):
            self.perf_scrub.add_u64(key)
        # per-PG op-window pipelining evidence, aggregated OSD-wide
        # (`perf dump` osd_op_window): inflight_depth is sampled at
        # every admission, so sum/avgcount is the achieved mean depth
        # — bench ec_e2e and test_perf_smoke read it
        self.perf_window = ctx.perf.create("osd_op_window")
        for key in ("ops_admitted", "window_drains",
                    "max_inflight_depth"):
            self.perf_window.add_u64(key)
        self.perf_window.add_avg("inflight_depth")
        self._scrub_task: Optional[asyncio.Task] = None
        # daemon-scope counters (osd.slow_ops etc — osd/OSD.cc l_osd_*)
        self.perf_osd = ctx.perf.create("osd")
        self.perf_osd.add_u64("slow_ops")
        # recovery retry rounds (PG._recover backoff loop): a storm
        # that only warn-logged was invisible in `perf dump --cluster`
        self.perf_osd.add_u64("recovery_retries")
        # payload bytes landed on THIS osd by recovery (installed
        # pushes + self-reconstructed EC shards): the numerator of
        # bench.py's rebuild MB/s axis, counted at the landing site
        self.perf_osd.add_u64("recovery_bytes")
        # recovery observability (`perf dump --cluster` osd.recovery):
        # the failure plane gets the same first-class counters the
        # write path has.  objects_pushed counts pushes WE sent as
        # primary; objects_pulled counts objects landed on THIS osd
        # (installed pushes + self-reconstructed EC shards);
        # active_pulls is the live in-flight gauge under the
        # osd_recovery_max_active budget; backoff_retries/_give_ups
        # are the shared-policy census (common/backoff.py);
        # cursor_lag is the number of objects still short of the
        # worst backfill target's cursor across this osd's primary
        # PGs (0 = every cursor at LB_MAX)
        self.perf_recovery = ctx.perf.create("recovery")
        for key in ("objects_pushed", "objects_pulled",
                    "push_bytes", "pull_bytes", "active_pulls",
                    "backoff_retries", "backoff_give_ups",
                    "cursor_lag"):
            self.perf_recovery.add_u64(key)
        # per-PG backfill shortfall feeding the cursor_lag gauge; each
        # PG reports ONLY itself from its home shard (SHARD11: no
        # cross-shard PG reads), the gauge is the sum
        self._cursor_lag: Dict = {}
        # reservation-style recovery budget: loop-local semaphores
        # capping in-flight recovery pushes (osd_recovery_max_active)
        # so a rebuild storm can't starve client ops.  Keyed per event
        # loop like the EC batch collectors — asyncio primitives are
        # loop-affine under threaded shards
        self._recovery_budgets: Dict[int, object] = {}
        from ceph_tpu_torch.common.op_tracker import OpTracker
        self.op_tracker = OpTracker(
            complaint_time=self.cfg["osd_op_complaint_time"],
            perf=self.perf_osd, logger=self.logger,
            flight_recorder_size=int(
                self.cfg["osd_flight_recorder_size"]))
        self.admin_socket = None
        self._stats_task: Optional[asyncio.Task] = None
        self.mesh_exec = None    # set when osd_mesh_mode=on (start())
        # sharded data plane (osd/shards.py): PGs hash to shards, all
        # PG-touching work routes through it.  num_shards=1 keeps the
        # plane disabled — every route() is an inline call, today's
        # single-loop behavior bit-for-bit
        from ceph_tpu_torch.osd.shards import ShardedDataPlane
        self.shards = ShardedDataPlane(self)
        # per-shard EC batch collectors (threaded mode only: the
        # daemon-wide collector's wake event is loop-affine)
        self._shard_ec_queues: Dict[int, object] = {}
        # replica commit-ack coalescer: acks produced in one drained
        # commit burst cork per target OSD and leave as ONE
        # MOSDRepAckBatch frame (the commit thread runs a burst's
        # callbacks in one loop callback, so call_soon IS the burst
        # boundary — zero added latency).  Keyed per loop id like the
        # recovery budgets: corks are loop-affine under threaded
        # shards, and the flush must drain the cork IT armed
        self._rep_ack_on = bool(self.cfg["osd_rep_ack_coalesce"])
        self._rep_ack_corks: Dict[int, Dict[int, list]] = {}
        # acks_coalesced = acks that rode a batch frame instead of
        # their own send; ack_batches = batch frames sent (the bench
        # extra row reports both — acceptance: counter-proven)
        self.perf_repack = ctx.perf.create("osd_rep_ack")
        for key in ("acks_sent", "acks_coalesced", "ack_batches"):
            self.perf_repack.add_u64(key)

    def next_tid(self) -> int:
        return next(self._tid)

    def ec_queues(self) -> dict:
        """Every EC batch queue of this OSD by name: the daemon-wide one
        ("daemon") and each shard's ("shard<i>") once it exists."""
        return {"daemon": self.ec_queue} | {
            f"shard{i}": q for i, q in sorted(self._shard_ec_queues.items())}

    def _note_crush(self, site: str, batches: int) -> None:
        with self._crush_batches_lock:
            self.crush_batches[site] += batches

    def place_objects(self, pool_id: int, names: List[str]):
        """``OSDMap.map_objects_batch`` on this OSD's CRUSH engine and
        device (backfill planning), its batches counted under
        "backfill"."""
        placed, launches = self.osdmap.map_objects_counted(
            pool_id, names, self.crush_engine, self.device)
        self._note_crush("backfill", launches)
        return placed

    def note_cursor_lag(self, pgid, lag: int) -> None:
        """One PG's backfill shortfall (objects its worst target's
        cursor is still short of).  Gauge = sum across primary PGs;
        0 = every cursor at LB_MAX."""
        # gil-atomic:begin _cursor_lag per-PG slots: each PG only ever
        # writes its OWN pgid key from its home shard, and the gauge
        # sum is a racy-read-tolerant snapshot
        if lag > 0:
            self._cursor_lag[pgid] = lag
        else:
            self._cursor_lag.pop(pgid, None)
        self.perf_recovery.set("cursor_lag",
                               sum(self._cursor_lag.values()))
        # gil-atomic:end

    def recovery_budget(self) -> asyncio.Semaphore:
        """The CURRENT loop's recovery-push reservation semaphore (the
        recovery-vs-client budget, reference AsyncReserver role): at
        most osd_recovery_max_active pushes in flight per loop, across
        every PG it runs.  Backends acquire it around each recovery
        push (PGBackend.recover_objects)."""
        loop = asyncio.get_running_loop()
        sem = self._recovery_budgets.get(id(loop))
        if sem is None:
            sem = asyncio.Semaphore(
                max(1, int(self.cfg["osd_recovery_max_active"])))
            # gil-atomic:begin _recovery_budgets lazy init: each loop
            # only ever stores its own id(loop) key, so concurrent
            # stores from shard threads never collide on a slot
            self._recovery_budgets[id(loop)] = sem
            # gil-atomic:end
        return sem

    def ec_batch_queue(self):
        """The cross-PG EC batch collector for the CURRENT loop.  The
        daemon-wide collector serves the single-loop plane; under
        THREADED shards each shard lazily gets its own (the
        collector's wake event and task are loop-affine) — it still
        batches across every PG of that shard."""
        if not (self.shards.enabled and self.shards.threaded):
            return self.ec_queue
        for shard in self.shards.shards:
            if shard.on_shard():
                q = self._shard_ec_queues.get(shard.idx)
                if q is None:
                    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
                    q = ECBatchQueue(
                        self.ctx, mode=self.cfg["osd_ec_batch_device"],
                        window_ms=self.cfg["osd_ec_batch_window_ms"],
                        min_device_bytes=self.cfg["osd_ec_batch_min_bytes"],
                        flush_bytes=self.cfg["osd_ec_batch_flush_bytes"],
                        device=self.device)
                    # gil-atomic:begin _shard_ec_queues per-shard
                    # lazy init: each shard only ever stores ITS OWN
                    # key, so concurrent stores from two shard
                    # threads never collide on a slot; the dict
                    # insert itself is one GIL-atomic step
                    self._shard_ec_queues[shard.idx] = q
                    # gil-atomic:end
                return q
        return self.ec_queue

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        # sharded-plane commit semantics: barrier-less (RAM) stores
        # ack-on-apply — the commit thread's GIL handoff is the
        # tracer's repl_commit cost, and there is no durability point
        # it buys.  shards=1 keeps today's threaded handoff.
        if self.shards.enabled:
            self.store.ack_on_apply = True
        self.store.mount()
        if self.messenger.addr.is_blank():
            await self.messenger.bind()
        # intake backpressure (OSD::client_throttler role): client op
        # bytes in flight are bounded; over budget the messenger stops
        # reading the client's socket and TCP pushes back
        from ceph_tpu_torch.common.throttle import AsyncThrottle
        self.messenger.dispatch_throttle = AsyncThrottle(
            "osd_client_bytes", self.cfg["osd_client_message_size_cap"])
        # sharded data plane: start the shard pumps (threads when
        # configured and not under the deterministic sim loop) and
        # install the intake classifier on the messenger
        self.shards.start()
        if self.shards.enabled:
            self.messenger.shard_router = _ShardIntake(self)
        if self.cfg["osd_mesh_mode"] == "on":
            # device-mesh execution mode: co-located shard OSDs share
            # one mesh; EC bulk bytes move by sharded device program +
            # in-process delivery instead of messenger sends
            from ceph_tpu_torch.parallel import mesh_exec
            self.mesh_exec = mesh_exec.enable()
            self.mesh_exec.register(self)
        await self._authenticate()
        self.monc.on_osdmap(self._on_osdmap)
        self.monc.sub_want("osdmap", 0)
        self.running = True
        # boot is RETRIED until the map shows us up (OSD::start_boot
        # role): a single fire-and-forget MOSDBoot can land on a mon
        # that has no quorum yet and is silently dropped — nothing else
        # ever re-asserts a brand-new osd (build-simple only sets
        # max_osd, so the "marked down but alive" re-boot in _on_osdmap
        # never fires for an osd with no EXISTS state)
        self._boot_task = asyncio.get_running_loop().create_task(
            self._boot_loop())
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat())
        self._scrub_task = asyncio.get_running_loop().create_task(
            self._scrub_scheduler())
        self._stats_task = asyncio.get_running_loop().create_task(
            self._report_stats())
        # cache-tier client + agent (ReplicatedPG agent_work scheduler)
        from ceph_tpu_torch.osd.tiering import TierClient
        self.tier_client = TierClient(self)
        self._tier_task = asyncio.get_running_loop().create_task(
            self._tier_agent_loop())
        # cluster log -> mon (LogClient role)
        self.ctx.cluster_log.set_sink(self._send_cluster_log)
        await self._start_admin_socket()
        self.ctx.cluster_log.info(
            f"osd.{self.whoami} boot at {self.messenger.addr}")
        self.logger.info(f"osd.{self.whoami} starting at "
                         f"{self.messenger.addr}")

    async def _authenticate(self) -> None:
        """cephx boot: prove osd.N's key to the mon, fetch the 'osd'
        service secret (rotating-key fetch role), then require + verify
        authorizers on every incoming connection and present our own on
        outgoing osd links."""
        if self.cfg["auth_supported"] != "cephx":
            return
        from ceph_tpu_torch.auth import cephx
        await self.monc.authenticate(f"osd.{self.whoami}")
        svc = self.monc.service_secrets.get("osd")
        if svc is None:
            raise RuntimeError(
                f"osd.{self.whoami}: mon did not grant the osd service "
                f"secret (entity caps missing?)")
        self.messenger.verify_authorizer_cb = (
            lambda a: cephx.verify_authorizer(svc, a))
        self.messenger.require_authorizer = True

    async def wait_for_boot(self, timeout: float = 30.0) -> None:
        from ceph_tpu_torch.common.backoff import Backoff, BackoffGiveUp
        bo = Backoff("boot_wait", base=0.02, cap=0.5, timeout=timeout)
        while not (self.osdmap.epoch and self.osdmap.is_up(self.whoami)):
            try:
                await bo.sleep()
            except BackoffGiveUp:
                raise TimeoutError(
                    f"osd.{self.whoami} failed to boot") from None

    async def shutdown(self) -> None:
        self.running = False
        if self.mesh_exec is not None:
            self.mesh_exec.unregister(self.whoami)
        if self._hb_task:
            self._hb_task.cancel()
        if self._boot_task:
            self._boot_task.cancel()
        if self._scrub_task:
            self._scrub_task.cancel()
        if self._stats_task:
            self._stats_task.cancel()
        if getattr(self, "_tier_task", None):
            self._tier_task.cancel()
        if self.admin_socket is not None:
            await self.admin_socket.stop()
        # PG teardown runs on each PG's home shard (its tasks live
        # there); post (never inline) and wait for the rings to drain
        for pg in list(self.pgs.values()):
            self.shards.post(pg.pgid, pg.stop)
        await self.shards.drain()
        self.monc.stop()
        await self.ec_queue.stop()
        # gil-atomic:begin _shard_ec_queues teardown sweep: shard
        # pumps are stopped (rings drained above), so no lazy init
        # races this; the snapshot + clear are single GIL steps
        for idx, q in list(self._shard_ec_queues.items()):
            shard = self.shards.shards[idx]
            if self.shards.threaded and shard.loop is not None:
                try:
                    fut = asyncio.run_coroutine_threadsafe(
                        q.stop(), shard.loop)
                    await asyncio.wrap_future(fut)
                except RuntimeError:
                    pass     # shard loop already gone
            else:
                await q.stop()
        self._shard_ec_queues.clear()
        # gil-atomic:end
        # drain the commit pipeline while the messenger still lives so
        # pending ack callbacks send (or no-op) instead of erroring;
        # a dead commit thread raises from sync() — teardown proceeds,
        # the loss is already surfaced to writers
        try:
            self.store.sync()
        except Exception:
            self.logger.exception("store sync failed during stop")
        await asyncio.sleep(0)
        await self.messenger.shutdown()
        await self.shards.stop()
        self.store.umount()

    # ----------------------------------------------------------------- maps
    MAP_HISTORY = 1000   # epochs of full maps kept for interval walks

    def _store_map(self, osdmap: OSDMap) -> None:
        """Persist the full map per epoch (OSD superblock map store,
        OSD::write_map) so generate_past_intervals can walk history
        after restarts."""
        from ceph_tpu_torch.store.types import CollectionId, ObjectId
        cid = CollectionId.meta()
        txn = Transaction()
        if not self.store.collection_exists(cid):
            txn.create_collection(cid)
        txn.write(cid, ObjectId(f"osdmap.{osdmap.epoch}"), 0,
                  osdmap.to_bytes())
        old = osdmap.epoch - self.MAP_HISTORY
        if old > 0 and self.store.exists(cid, ObjectId(f"osdmap.{old}")):
            txn.remove(cid, ObjectId(f"osdmap.{old}"))
        self.store.apply_transaction(txn)

    def get_map(self, epoch: int) -> Optional[OSDMap]:
        """A historical full map, if still within the kept window.
        Decoded maps are memoized: interval walks touch the same epochs
        once per PG, and a full decode per (PG, epoch) would stall the
        event loop on a wide _advance_pgs."""
        if self.osdmap is not None and epoch == self.osdmap.epoch:
            return self.osdmap
        cached = self._map_cache.get(epoch)
        if cached is not None:
            return cached
        from ceph_tpu_torch.store.types import CollectionId, ObjectId
        try:
            data = self.store.read(CollectionId.meta(),
                                   ObjectId(f"osdmap.{epoch}"))
            m = OSDMap.from_bytes(bytes(data))
        except Exception:
            return None
        self._memo_map(m)
        return m

    def interval_row(self, pool_id: int, epoch: int, pgid: PGId,
                     cur_map: OSDMap):
        """``pgid``'s (up, acting, primary) in ``epoch``'s map, with that
        map's pool min_size and up_thru by OSD, for an interval walk; None
        when the map or the pool is not there.  A map never changes once
        its epoch exists, so each (pool, epoch) is read once, all its PGs
        at once, and kept for the newest ``INTERVAL_ROW_EPOCHS`` epochs:
        under thrashing every new PG instance and every peering retry
        walks back hundreds of epochs, past the maps ``get_map`` keeps,
        and the JAX package decodes and primes each of them again.  A PG
        that epoch's pg_num does not reach (made by a later split) folds
        to its parent, as ``pg_to_up_acting_osds`` folds it."""
        key = (pool_id, epoch)
        ent = self._interval_rows.get(key)
        if ent is None:
            m = cur_map if epoch == cur_map.epoch else self.get_map(epoch)
            if m is None or pool_id not in m.pools:
                return None
            rows = {}
            for pg in m.pg_ids(pool_id):
                up, _, acting, primary = m.pg_to_up_acting_osds(pg)
                rows[pg] = (up, acting, primary)
            ent = (m.pools[pool_id],
                   [i.up_thru for i in m.osd_info], rows)
            # gil-atomic:begin _interval_rows shared by the shard lanes: a
            # racing fill of one key stores equal rows; each dict op is one
            # GIL step
            self._interval_rows[key] = ent
            if len(self._interval_rows) > 2 * INTERVAL_ROW_EPOCHS:
                for old in sorted(self._interval_rows,
                                  key=lambda k: k[1])[:INTERVAL_ROW_EPOCHS]:
                    self._interval_rows.pop(old, None)
            # gil-atomic:end
        pool, up_thru, rows = ent
        row = rows.get(pool.raw_pg_to_pg(pgid))
        if row is None:
            return None
        return row + (pool.min_size, up_thru)

    def _memo_map(self, m: OSDMap) -> None:
        """Keep ``m`` as its epoch's map for ``get_map``."""
        # gil-atomic:begin _map_cache memoized decode shared across
        # shard lanes: a racing store of the same epoch is idempotent
        # (both decoded the same committed bytes) and a racing evict
        # at worst double-decodes later; each dict op is one GIL step
        self._map_cache[m.epoch] = m
        while len(self._map_cache) > 128:
            # default=None: two lanes racing the same oldest key must
            # both succeed (the read+pop pair is two GIL steps)
            self._map_cache.pop(next(iter(self._map_cache)), None)
        # gil-atomic:end

    async def ensure_map_history(self, from_e: int, to_e: int) -> None:
        """Fill holes in the stored map history by fetching full maps
        from the mon (OSD::osdmap_subscribe catch-up role).  A hole
        appears when the mon's subscription fallback skipped >100 epochs
        with one full map; walking past intervals across such a hole
        would silently miss acting sets that accepted writes."""
        from ceph_tpu_torch.store.types import CollectionId, ObjectId
        cid = CollectionId.meta()
        for e in range(max(1, from_e), to_e):
            if self.store.exists(cid, ObjectId(f"osdmap.{e}")):
                continue
            # one fetch per missing epoch at a time, shared by every PG
            # that needs it (a new PG walks from epoch 1, and a pool's
            # PGs peer at once: each asking the mon for every epoch the
            # OSD missed before its boot floods the mon's command queue
            # past its timeout).  Shard threads share it: the future is
            # a thread-safe one
            with self._map_fetch_lock:
                fetch = self._map_fetches.get(e)
                owner = fetch is None
                if owner:
                    fetch = self._map_fetches[e] = \
                        concurrent.futures.Future()
            if not owner:
                await asyncio.wrap_future(fetch)
                continue
            try:
                try:
                    ack = await self.monc.command(
                        {"prefix": "osd getmap", "epoch": e}, timeout=15.0)
                except Exception as ex:
                    self.logger.warning(
                        f"could not backfill osdmap e{e} from mon: {ex}")
                    continue
                if ack.outbl:
                    txn = Transaction()
                    if not self.store.collection_exists(cid):
                        txn.create_collection(cid)
                    txn.write(cid, ObjectId(f"osdmap.{e}"), 0, ack.outbl)
                    self.store.apply_transaction(txn)
            finally:
                with self._map_fetch_lock:
                    del self._map_fetches[e]
                fetch.set_result(None)

    def _on_osdmap(self, osdmap: OSDMap) -> None:
        if (self.running and osdmap.exists(self.whoami)
                and not osdmap.is_up(self.whoami)):
            # falsely marked down (missed heartbeats during a stall):
            # re-assert ourselves (OSD.cc "map says i am down" re-boot)
            self.logger.warning(f"osd.{self.whoami} marked down in "
                                f"e{osdmap.epoch} but alive; re-booting")
            self.monc.messenger.send_message(
                MOSDBoot(self.whoami, self.messenger.addr),
                self.monc.monmap.addr_of_rank(self.monc.cur_mon),
                peer_type="mon")
        if self.shards.enabled:
            # the MonClient applies the next incremental to this same
            # map object in place, while the shards may still be
            # advancing PGs against it: give them a map of their own
            # for this epoch (its placement cache then stays primed).
            # It stays at its epoch, so the interval walks of PGs made
            # later read it, placements primed, from get_map: decoding
            # the stored bytes instead primes every pool again on the
            # host engine, per epoch walked (the JAX package's walks do)
            osdmap = OSDMap.from_bytes(osdmap.to_bytes())
            self._memo_map(osdmap)
        self._apply_map(osdmap)
        if self.shards.process_lanes is not None:
            # process lanes: each lane worker hosts its slice of the
            # PG registry — ship the map and let the lane-side
            # _advance_pgs run there (the parent hosts no PGs)
            self.shards.broadcast_map(osdmap)

    def _apply_map(self, osdmap: OSDMap) -> None:
        """Adopt one full map: store it, advance hosted PGs, release
        parked messages.  Shared by the daemon's mon subscription and
        the lane workers' MAP frames (osd/lanes.py)."""
        self.osdmap = osdmap
        self._store_map(osdmap)
        self._advance_pgs()
        with self._wm_lock:
            waiting, self._waiting_maps = self._waiting_maps, []
        for m in waiting:
            self.ms_dispatch(m)

    def _lane_filter(self, pgid: PGId) -> bool:
        """Which PGs THIS runtime hosts: everything for a daemon with
        in-process lanes; NOTHING for a daemon whose lanes are worker
        processes (they own the registry); lane workers override to
        their shard_index slice."""
        return self.shards.process_lanes is None

    def _advance_pgs(self) -> None:
        """Instantiate/advance PGs this osd hosts (handle_osd_map role)."""
        m = self.osdmap
        wanted: Dict[PGId, int] = {}
        # batch-compute the new epoch's placements up front: one kernel
        # launch per pool primes the acting cache the per-PG loop below
        # reads (prime_pgs no-ops per pool when the rule doesn't
        # vectorize — the loop then pays the scalar descent as before)
        self._note_crush("epoch", m.prime_pgs(
            [PGId(pool_id, ps)
             for pool_id, pool in m.pools.items()
             for ps in range(pool.pg_num)], self.crush_engine, self.device))
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                pgid = PGId(pool_id, ps)
                if not self._lane_filter(pgid):
                    continue
                up, upp, acting, actp = m.pg_to_up_acting_osds(pgid)
                if self.whoami in acting or self.whoami in up:
                    # EC shard comes from our acting OR up position: an
                    # up-only backfill target (pg_temp window) must key
                    # its PG/collection by the shard it is being filled
                    # FOR, or the pushed data lands in a NO_SHARD
                    # collection that evaporates when pg_temp clears
                    shard = NO_SHARD
                    if pool.is_erasure():
                        if self.whoami in acting:
                            shard = acting.index(self.whoami)
                        elif self.whoami in up:
                            shard = up.index(self.whoami)
                    wanted[pgid.with_shard(shard)
                           if shard != NO_SHARD else pgid] = pool_id
        # PGs we no longer host stay live as STRAYS when they hold data:
        # their copy may be the only survivor of a past interval, so they
        # must keep answering peering queries and serving log/object
        # pulls until the new primary confirms clean and sends MPGRemove
        # (PG stray role).  Empty copies are dropped immediately.
        # All per-PG work routes to the PG's home shard (SHARD11 seam);
        # shard rings are FIFO, so successive map epochs advance each
        # PG in order
        for pgid in [p for p in list(self.pgs) if p not in wanted]:
            self.shards.route(pgid, self._advance_stray, pgid, m)
        for pgid, pool_id in wanted.items():
            self.shards.route(pgid, self._advance_one, pgid, pool_id, m)

    def _advance_stray(self, pgid: PGId, m) -> None:
        """Home-shard half of _advance_pgs for a PG we no longer host."""
        pg = self.pgs.get(pgid)
        if pg is None:
            return
        if pg.info.is_empty():
            # gil-atomic:begin pgs registry drop on the PG's home
            # shard; intake-side readers iterate list() snapshots,
            # so a concurrent pop only changes WHICH snapshot they
            # got — one GIL step either way
            self.pgs.pop(pgid).stop()
            # gil-atomic:end
        else:
            if pgid.pool in m.pools:
                pg.pool = m.pools[pgid.pool]
            pg.advance_map(m)

    def _advance_one(self, pgid: PGId, pool_id: int, m) -> None:
        """Home-shard half of _advance_pgs for a hosted PG: creation
        happens HERE so the PG's tasks, futures and events all live on
        its home shard's loop."""
        if pool_id not in m.pools:
            return      # pool deleted while the advance was in flight
        pg = self.pgs.get(pgid)
        fresh = pg is None
        if fresh:
            pg = PG(self, pgid, pool_id, m.pools[pool_id])
            pg.create_onstore()
            pg.load_meta()
            pg.generate_past_intervals()
            # gil-atomic:begin pgs registry insert on the PG's home
            # shard (fully constructed first); snapshot readers on
            # other lanes see it atomically or not at all
            self.pgs[pgid] = pg
            # gil-atomic:end
            pg.start()
        pg.pool = m.pools[pool_id]
        pg.advance_map(m)
        if fresh:
            pg.ensure_peering()
        pg.maybe_trim_snaps()

    def request_up_thru(self, want: int) -> None:
        """WaitUpThru support (PG::build_prior need_up_thru): ask the
        mon to commit an up_thru of at least ``want``, the waiting PG's
        interval start (MOSDAlive; OSD::queue_want_up_thru).  Deduped
        across PGs — sent when the want rises — but re-sent on a slow
        timer so a request lost to a mon election doesn't wedge the
        waiting peering loops.  The JAX package asks for its current
        epoch once per epoch instead: while this OSD's map lags its
        grant, every other OSD's grant is a new epoch and a new request,
        and each request a new epoch (an up_thru storm)."""
        if self.osdmap.get_up_thru(self.whoami) >= want:
            return
        now = time.monotonic()
        # gil-atomic:begin _alive_want,_alive_sent_at shard threads race
        # only benignly: at worst one extra request, which the mon drops
        # as a duplicate
        if getattr(self, "_alive_want", 0) >= want \
                and now - getattr(self, "_alive_sent_at", 0.0) < 2.0:
            return
        want = self._alive_want = max(want, getattr(self, "_alive_want", 0))
        self._alive_sent_at = now
        # gil-atomic:end
        self.messenger.send_message(
            MOSDAlive(self.whoami, want),
            self.monc.monmap.addr_of_rank(self.monc.cur_mon),
            peer_type="mon")

    def note_pg_active(self, pg: PG) -> None:
        """Primary finished peering.  WaitUpThru already proved our
        up_thru covers this interval, so this asks again only when a
        later map left it behind."""
        self.request_up_thru(pg.info.same_interval_since)

    def _load_stray_pg(self, pgid: PGId):
        """A peering query arrived for a PG we are not mapped to.  If a
        previous incarnation left data on-store (e.g. we restarted while
        stray), resurrect it as a stray so the PriorSet walk can read our
        info/log instead of losing the last copy of a past interval."""
        from ceph_tpu_torch.store.types import CollectionId
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None:
            return None
        cid = CollectionId.pg(pgid.pool, pgid.seed, pgid.shard)
        if not self.store.collection_exists(cid):
            return None
        pg = PG(self, pgid, pgid.pool, pool)
        pg.load_meta()
        if pg.info.is_empty():
            return None
        # gil-atomic:begin pgs stray resurrection on the home shard
        # (peering queries route here), same snapshot discipline
        self.pgs[pgid] = pg
        # gil-atomic:end
        pg.start()
        pg.advance_map(self.osdmap)
        self.logger.info(f"resurrected stray {pgid} "
                         f"(lu {pg.info.last_update})")
        return pg

    def _pg_remove(self, m) -> None:
        """MPGRemove: the clean primary says our stray copy is garbage.
        Runs on the PG's home shard (routed by _dispatch_pg_msg)."""
        if m.epoch > self.osdmap.epoch:
            # we haven't seen the map the primary decided under: decide
            # after catching up, not against a stale mapping
            with self._wm_lock:
                self._waiting_maps.append(m)
            return
        pg = self._pg_for(m.pgid)
        if pg is None:
            return
        # judge membership from the CURRENT map, not possibly-stale pg
        # state.  Membership is per-SHARD: after an EC role change we
        # are still in acting — under the NEW shard — while the
        # old-shard instance is a removable stray; an osd-id check
        # would shield it forever
        up, _, acting, _ = self.osdmap.pg_to_up_acting_osds(
            m.pgid.without_shard())
        if self.whoami in acting or self.whoami in up:
            my_shard = NO_SHARD
            if pg.pool.is_erasure():
                if self.whoami in acting:
                    my_shard = acting.index(self.whoami)
                elif self.whoami in up:
                    my_shard = up.index(self.whoami)
            if pg.pgid.shard == my_shard or my_shard == NO_SHARD:
                self.logger.warning(
                    f"ignoring pg remove for {m.pgid}: we are in "
                    f"up/acting")
                return
        # gil-atomic:begin pgs registry drop (MPGRemove on the home
        # shard); one GIL step, snapshot readers unaffected
        self.pgs.pop(pg.pgid, None)
        # gil-atomic:end
        pg.stop()
        txn = Transaction().remove_collection(pg.cid)
        self.store.apply_transaction(txn)
        self.logger.info(f"removed stray {pg.pgid} (per osd.{m.from_osd})")

    # ------------------------------------------------------------- plumbing
    def send_osd(self, osd_id: int, msg: Message) -> None:
        addr = self.osdmap.get_addr(osd_id)
        if addr is None:
            self.logger.warning(f"no address for osd.{osd_id}; dropping "
                                f"{type(msg).__name__}")
            return
        self.messenger.send_message(msg, addr, peer_type="osd")

    def queue_rep_ack(self, osd_id: int, reply: Message) -> None:
        """Replica commit-ack send seam: corks the acks one drained
        commit burst produces (they all run in ONE loop callback —
        store/commit.py batches completion records per loop) and
        flushes them per target OSD as a single MOSDRepAckBatch.  A
        lone ack still goes out unbatched, so the coalescer adds no
        frame overhead at queue depth 1."""
        self.perf_repack.inc("acks_sent")
        if not self._rep_ack_on:
            self.send_osd(osd_id, reply)
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # off-loop caller (teardown, direct-call tests): nothing
            # to cork against — send through
            self.send_osd(osd_id, reply)
            return
        cork = self._rep_ack_corks.get(id(loop))
        if cork is None:
            # gil-atomic:begin _rep_ack_corks lazy init: each loop
            # only ever stores its own id(loop) key
            cork = self._rep_ack_corks[id(loop)] = {}
            # gil-atomic:end
        if not cork:
            loop.call_soon(self._flush_rep_acks, cork)
        cork.setdefault(osd_id, []).append(reply)

    def _flush_rep_acks(self, cork: Dict[int, list]) -> None:
        for osd_id, acks in list(cork.items()):
            if len(acks) == 1:
                self.send_osd(osd_id, acks[0])
            else:
                self.perf_repack.inc("acks_coalesced", len(acks))
                self.perf_repack.inc("ack_batches")
                self.send_osd(osd_id, MOSDRepAckBatch(acks))
        cork.clear()

    def _dispatch_rep_ack_batch(self, m: MOSDRepAckBatch) -> None:
        """Unpack a coalesced ack batch: each inner reply inherits the
        envelope's transport stamps and routes through the normal
        reply path (its own PG's home shard)."""
        for rep in m.msgs:
            rep.src_name = m.src_name
            rep.src_addr = m.src_addr
            rep.transport_id = m.transport_id
            rep.recv_stamp = m.recv_stamp
            self.shards.route(rep.pgid, self._dispatch_pg_msg, rep)

    def reply_to(self, req: Message, msg: Message) -> None:
        # the reply is the op's terminal act on this OSD: any extent
        # slots the request rode in on (lane ring transport) are done
        # now — success, error and EAGAIN-after-requeue all funnel
        # through here, so this one release balances every path
        extents.release_message(req)
        # dmClock phase echo: the queue stamped which phase served the
        # op (_qos_phase envelope attr); mirroring it onto the reply
        # feeds the client's delta/rho counters.  One seam covers
        # every MOSDOpReply construction site.
        phase = getattr(req, "_qos_phase", 0)
        if phase and isinstance(msg, MOSDOpReply):
            msg.qos_phase = phase
        peer_type = req.src_name.type if req.src_name else None
        self.messenger.send_message(msg, req.src_addr, peer_type=peer_type)

    def _pg_matches(self, pgid: PGId) -> List[PG]:
        base = pgid.without_shard()
        return [inst for p, inst in list(self.pgs.items())
                if p.without_shard() == base]

    def _pg_for(self, pgid: PGId) -> Optional[PG]:
        pg = self.pgs.get(pgid)
        if pg is None and pgid.shard != NO_SHARD:
            pg = self.pgs.get(pgid.without_shard())
        if pg is None:
            # shard-agnostic lookup (EC peers address us by shard).
            # After an EC role change this osd briefly hosts TWO
            # instances of one PG — the newborn keyed by its new shard
            # and the old-shard copy lingering as a stray — so prefer
            # the instance keyed by our CURRENT role: first-match
            # handed client ops and peering traffic to the stray and
            # starved the newborn primary (recovery-under-load wedge)
            matches = self._pg_matches(pgid)
            for inst in matches:
                if inst.pgid.shard == inst.shard_of(self.whoami):
                    return inst
            if matches:
                return matches[0]
        return pg

    def _pg_for_reply(self, pgid: PGId, waiting) -> Optional[PG]:
        """Route a request/reply-matched message to the instance that
        actually awaits it.  Replies are addressed by the REPLIER's
        shard, so with two local instances of one PG (role change) the
        addressed key can name the wrong one — the registered waiter,
        not the address, identifies the consumer."""
        for inst in self._pg_matches(pgid):
            if waiting(inst):
                return inst
        return self._pg_for(pgid)

    # ------------------------------------------------------------- dispatch
    def ms_dispatch(self, m: Message) -> bool:
        """Intake classify (ms_fast_dispatch role): PG-bound messages
        route to the PG's home shard (SHARD11 seam — this function
        must not touch PG state itself); daemon-scope messages are
        handled inline on the intake loop."""
        if isinstance(m, MOSDOpBatch):
            self._dispatch_op_batch(m)
            return True
        if isinstance(m, MOSDRepAckBatch):
            self._dispatch_rep_ack_batch(m)
            return True
        if isinstance(m, _PG_BOUND):
            if not self._park_ahead_of_map(m):
                self.shards.route(m.pgid, self._dispatch_pg_msg, m)
            return True
        if isinstance(m, MOSDPing):
            self._handle_ping(m)
            return True
        if isinstance(m, MOSDOpReply):
            # replies to the embedded tier client's cross-pool ops
            tc = getattr(self, "tier_client", None)
            if tc is not None:
                return tc.on_reply(m)
            return False
        return False

    def _park_ahead_of_map(self, m: Message) -> bool:
        """Hold a peering query or an activation sent from an epoch this
        OSD has not applied yet (OSD::require_same_or_newer_map) until
        that map's advance has made the PG instances it addresses; the
        map that reaches it dispatches it again.  Answered now, a query
        for an EC shard whose instance the advance has yet to make would
        be answered by this OSD's instance of another shard of the PG,
        complete, and the primary would push the new shard nothing.  The
        JAX package answers at once.  Runs on the intake side, where maps
        are applied, so the advance is on the shard's ring ahead of it."""
        if not (isinstance(m, MPGQuery)
                or (isinstance(m, MPGLog) and m.activate)):
            return False
        if m.epoch <= self.osdmap.epoch:
            return False
        with self._wm_lock:
            self._waiting_maps.append(m)
        return True

    def _dispatch_op_batch(self, m: MOSDOpBatch) -> None:
        """Unpack a corked client batch: one wire frame / one local
        handoff carried N MOSDOps.  The batch is a transport ENVELOPE
        (THROTTLE_SPLIT): the dispatch throttle is taken PER INNER OP
        here — never per frame, which would let an arbitrarily large
        cork ride the single-message escape hatch past the intake cap.
        Ops that fit the budget route synchronously; once the budget
        fills, the REMAINDER parks on an ordered async drain (FIFO
        with later senders via the throttle's waiter queue), so the
        byte bound and per-object order both hold."""
        ops = m.ops_list()
        if not ops:
            self.messenger.put_dispatch_throttle(m)
            return
        m.throttle_cost = 0           # per-op shares own the budget
        for op in ops:
            # the messenger stamped the ENVELOPE (the batch): each
            # inner op inherits it so replies/auth work unbatched
            op.src_name = m.src_name
            op.src_addr = m.src_addr
            op.transport_id = m.transport_id
            op.recv_stamp = m.recv_stamp
            if getattr(m, "auth_entity", None) is not None:
                op.auth_entity = m.auth_entity
                op.auth_caps = m.auth_caps
        thr = self.messenger.dispatch_throttle
        for i, op in enumerate(ops):
            cost = op.local_cost()
            if thr is None:
                self._route_batched_op(op, 0)
            elif thr.get_or_fail(cost):
                self._route_batched_op(op, cost)
            else:
                # budget full: register EVERY remaining op's waiter
                # SYNCHRONOUSLY (get_later) before yielding — a later
                # send's get_or_fail can then never overtake the
                # parked remainder, so same-object order holds across
                # batches; the drain task just awaits the grants in
                # order
                rest = [(op2, op2.local_cost()) for op2 in ops[i:]]
                grants = [(op2, c2, thr.get_later(c2))
                          for op2, c2 in rest]
                asyncio.get_running_loop().create_task(
                    self._drain_batch_rest(grants))
                return

    async def _drain_batch_rest(self, grants) -> None:
        thr = self.messenger.dispatch_throttle
        routed = 0
        try:
            for op, cost, fut in grants:
                await fut
                self._route_batched_op(op, cost)
                routed += 1
        except asyncio.CancelledError:
            # teardown: return budget that was granted to ops we
            # never routed (their futures resolved but the op died
            # with this task); un-granted waiters die with the loop
            for _op2, c2, f2 in grants[routed:]:
                if f2.done() and not f2.cancelled():
                    thr.put(c2)
            raise

    def _route_batched_op(self, op: MOSDOp, cost: int) -> None:
        op.throttle_cost = cost
        tracer = self.ctx.tracer
        # wire hop: adopt the inner op's propagated span context
        # (local delivery already carried the live spans)
        if op._span is None and tracer.enabled \
                and getattr(op, "trace_id", 0):
            op._span = tracer.adopt(op.trace_id, op.span_id,
                                    t0=op.recv_stamp)
        if op._span is not None and tracer.enabled:
            # batched delivery: transit-so-far + budget wait tile into
            # the same chain stages an unbatched op would have cut at
            # intake (_client_op drops foreign spans if tracing is off)
            op._span.cut("deliver", tracer.hist)
            op._span.cut("throttle_wait", tracer.hist)
        self.shards.route(op.pgid, self._dispatch_pg_msg, op)

    def _dispatch_pg_msg(self, m: Message) -> None:
        """Per-type PG message handling; ALWAYS runs on the PG's home
        shard (routed by ms_dispatch / the messenger's shard
        classifier), so everything it touches stays shard-local."""
        if isinstance(m, MOSDOp):
            self._client_op(m)
            return
        if isinstance(m, (MOSDRepOp, MOSDECSubOpWrite, MOSDECSubOpRead)):
            pg = self._pg_for(m.pgid)
            if pg is None:
                with self._wm_lock:
                    self._waiting_maps.append(m)
                return
            if getattr(m, "in_process", False) and pg.awaits_activation():
                # handed over in process ahead of the activation the
                # primary sent on the messenger: keep the messenger's
                # order
                pg.hold_until_active(m)
                return
            # sharded plane: write sub-ops apply INLINE off the ring
            # when nothing is queued ahead — the queue+wakeup hop is
            # the per-sub-op cost the tracer's replica_rtt carries.
            # shards=1 keeps the classic queue path bit-for-bit.
            if self.shards.enabled \
                    and isinstance(m, (MOSDRepOp, MOSDECSubOpWrite)) \
                    and pg.try_fast_sub_write(m):
                if self.shards.perf is not None:
                    self.shards.perf.inc("subop_inline")
                return
            pg.queue_op(m)
            return
        if isinstance(m, (MOSDRepOpReply, MOSDECSubOpWriteReply,
                          MOSDECSubOpReadReply)):
            # acks resolve futures the PG worker awaits: handle off
            # the op queue the worker is blocked on (the shard pump is
            # a separate task, so delivery stays prompt)
            pg = self._pg_for_reply(
                m.pgid, lambda i: m.tid in i.backend._inflight)
            if pg is not None:
                pg.backend.handle_reply(m)
            return
        if isinstance(m, MPGQuery):
            pg = self._pg_for(m.pgid) or self._load_stray_pg(m.pgid)
            if pg is not None:
                pg.on_query(m)
            else:
                # we host nothing for this pg (yet): answer with an empty
                # info rather than stalling the querier's peering — our
                # own map advance will instantiate the PG if we belong
                from ceph_tpu_torch.osd.pglog import PGInfo
                self.send_osd(m.from_osd, MPGNotify(
                    m.pgid, m.epoch, PGInfo(m.pgid), self.whoami))
            return
        if isinstance(m, MPGRemove):
            self._pg_remove(m)
            return
        if isinstance(m, MPGNotify):
            pg = self._pg_for_reply(
                m.pgid, lambda i: m.from_osd in i._notify_waiters)
            if pg is not None:
                pg.on_notify(m)
            return
        if isinstance(m, MPGLogRequest):
            pg = self._pg_for(m.pgid)
            if pg is not None:
                pg.on_log_request(m)
            return
        if isinstance(m, MPGLog):
            # activation targets the addressed shard; a GetLog reply
            # targets whichever instance asked
            pg = (self._pg_for(m.pgid) if m.activate
                  else self._pg_for_reply(
                      m.pgid, lambda i: m.from_osd in i._log_waiters))
            if pg is not None:
                pg.on_pg_log(m)
            else:
                with self._wm_lock:
                    self._waiting_maps.append(m)
            return
        if isinstance(m, MPGPush):
            from ceph_tpu_torch.osd.pg import STATE_ACTIVE
            pg = self._pg_for(m.pgid)
            if pg is not None:
                if pg._op_queue.QOS and pg.state == STATE_ACTIVE:
                    # dmClock: recovery pushes are ADMITTED by the
                    # background class's tags instead of running
                    # straight off the pump — client reservations
                    # hold during a recovery storm.  The push ACK
                    # (MPGPushReply below) stays direct: it resolves
                    # a future the primary's capped push window
                    # already awaits.  Only while ACTIVE: a peering
                    # PG's worker may be parked inline on a client op
                    # waiting-for-active, and peering's own catch-up
                    # pulls wait on these pushes — queueing one
                    # behind the park would deadlock the PG (client
                    # service is parked during peering anyway, so
                    # there is nothing to arbitrate)
                    pg.queue_op(m)
                else:
                    pg.on_push(m)
            return
        if isinstance(m, MPGPushReply):
            pg = self._pg_for_reply(
                m.pgid,
                lambda i: (m.from_osd, m.oid) in i._push_acks)
            if pg is not None:
                pg.on_push_reply(m)
            return
        if isinstance(m, MPGObjectList):
            pg = self._pg_for_reply(
                m.pgid, lambda i: m.from_osd in i._list_waiters)
            if pg is not None:
                pg.on_object_list(m)
            return
        if isinstance(m, MWatchNotifyAck):
            pg = self._pg_for(m.pgid)
            if pg is not None:
                pg.on_notify_ack(m)     # primary awaits: bypass op queue
            return
        if isinstance(m, (MPGScrub, MPGScrubScan)):
            pg = self._pg_for(m.pgid)
            if pg is not None:
                pg.queue_op(m)        # serialize with writes
            return
        if isinstance(m, MPGScrubMap):
            pg = self._pg_for(m.pgid)
            if pg is not None:
                # the primary's scrub awaits this — bypass the op queue
                fut = pg._scrub_map_waiters.get(m.tid)
                if fut is not None and not fut.done():
                    fut.set_result(m)
            return

    def _client_op(self, m: MOSDOp) -> None:
        pg = self._pg_for(m.pgid)
        if pg is None:
            self.messenger.put_dispatch_throttle(m)
            self.reply_to(m, MOSDOpReply(
                m.tid, -errno.EAGAIN, map_epoch=self.osdmap.epoch))
            return
        # per-op tracking (OpTracker; admin socket dump_ops_in_flight)
        m._tracked = self.op_tracker.create(
            f"osd_op({m.src_name} {m.oid} tid {m.tid} "
            f"{'+'.join(str(o.op) for o in m.ops)})")
        # op tracing: local delivery carried the live span; a wire hop
        # carried ids the messenger adopted into m._span.  Linking the
        # TrackedOp makes every mark() a span event (TrackedOp->blkin).
        # A daemon with tracing OFF drops the span here — per-daemon
        # enablement means no cuts, no histograms, no clock reads on
        # this host even when the CLIENT traced the op (the client's
        # chain then books the gap into ack_delivery)
        if m._span is not None:
            if not self.ctx.tracer.enabled:
                m._span = None
            else:
                m._tracked.span = m._span
                # cause-split queue_wait: classify -> here is the
                # shard handoff ring's dwell (pump not yet scheduled /
                # items ahead in the ring) — ~0 on the inline plane,
                # the named backpressure signal on thread lanes.
                # (Process lanes attributed the ipc hop as
                # ring_wait/lane_codec at envelope decode already.)
                m._span.cut("queue_wait_ring", self.ctx.tracer.hist)
        from ceph_tpu_torch.osd.messages import OP_NOTIFY
        if m.ops and all(o.op == OP_NOTIFY for o in m.ops):
            # notify gathers remote acks for seconds and touches no
            # object state: run it OFF the PG's serial worker so it
            # cannot stall client I/O behind a slow/dead watcher
            asyncio.get_running_loop().create_task(
                self._do_notify_op(pg, m))
            return
        m._tracked.mark("queued_for_pg")
        pg.queue_op(m)

    async def _do_notify_op(self, pg, m: MOSDOp) -> None:
        try:
            result = 0
            for op in m.ops:
                op.rval = await pg.handle_notify(m, op)
                if op.rval < 0 and result == 0:
                    result = op.rval
            self.reply_to(m, MOSDOpReply(m.tid, result, m.ops,
                                         self.osdmap.epoch))
        except Exception:
            self.logger.exception(f"notify op failed: {m}")
            # still answer: an unreplied op stalls the client for the
            # full objecter timeout
            try:
                self.reply_to(m, MOSDOpReply(
                    m.tid, -errno.EIO, map_epoch=self.osdmap.epoch))
            except Exception:
                pass
        finally:
            if getattr(m, "_tracked", None) is not None:
                self.op_tracker.finish(m._tracked)
            self.messenger.put_dispatch_throttle(m)

    # -------------------------------------------------------- introspection
    async def _start_admin_socket(self) -> None:
        path = self.cfg["admin_socket"]
        if not path:
            return
        from ceph_tpu_torch.common.admin_socket import AdminSocket
        sock = AdminSocket(self.ctx, self.ctx.config.expand_meta(path))
        sock.register(
            "dump_ops_in_flight",
            lambda cmd: self.op_tracker.dump_in_flight(),
            "client ops currently executing (TrackedOp)")
        sock.register(
            "dump_historic_ops",
            lambda cmd: self.op_tracker.dump_historic(),
            "recently completed client ops")
        sock.register(
            "dump_historic_slow_ops",
            lambda cmd: self._dump_historic_slow_ops(),
            "recently completed ops that exceeded "
            "osd_op_complaint_time, merged across process-lane "
            "workers (osd/OSD.cc parity)")
        sock.register(
            "dump_op_stages",
            lambda cmd: self._dump_op_stages(),
            "per-stage write-path latency breakdown "
            "(op tracer histograms: p50/p99/p999 per stage), merged "
            "across process-lane workers")
        sock.register(
            "dump_flight_recorder",
            lambda cmd: self._dump_flight_recorder(),
            "bounded ring of recent slow-op stage records "
            "(post-hoc tail attribution), merged across lanes")
        sock.register(
            "perf dump full",
            lambda cmd: self._perf_dump_full(),
            "mergeable metrics-plane snapshots (common/metrics.py): "
            "this daemon + every process-lane worker, with loud "
            "lane_dead markers")
        sock.register(
            "status", lambda cmd: {
                "whoami": self.whoami,
                "osdmap_epoch": self.osdmap.epoch,
                "num_pgs": len(self.pgs),
                "pgs": {str(pg.pgid): pg.state
                        for pg in list(self.pgs.values())},
            }, "daemon status")
        def _bench_cmd(cmd):
            # accept both k=v fields and the text protocol's
            # positional args ("bench <count> <size>")
            args = cmd.get("args") or []
            count = int(cmd.get("count") or (args[0] if args else 16))
            size = int(cmd.get("size")
                       or (args[1] if len(args) > 1 else 1 << 20))
            return self._store_bench(count, size)
        sock.register(
            "bench", _bench_cmd,
            "store write throughput (`ceph tell osd.N bench` role, "
            "osd/OSD.cc:5583); args: [count [size]]")
        await sock.start()
        self.admin_socket = sock

    async def _lane_dump_calls(self, prefix: str):
        """Fan one dump request out to every process-lane worker over
        the id-keyed FRAME_RPC path (SEAM_INVENTORY discipline: json
        command out, json reply resolved by id).  Returns
        ``([(lane_idx, reply), ...], [dead_lane_idx, ...])`` — a dead
        lane is reported LOUDLY by every consumer, never folded into
        an empty reply."""
        lanes = [lane for lane in self.shards.process_lanes or []]
        live = [lane for lane in lanes if not lane.dead]
        dead = [lane.idx for lane in lanes if lane.dead]
        # fan out CONCURRENTLY: one wedged lane costs one timeout, not
        # one per lane (an 8-lane serial sweep would outlive the admin
        # socket client's own timeout)
        results = await asyncio.gather(
            *[lane.admin_rpc({"prefix": prefix}) for lane in live],
            return_exceptions=True)
        replies = []
        for lane, r in zip(live, results):
            if isinstance(r, BaseException):
                dead.append(lane.idx)
            else:
                replies.append((lane.idx, r))
        dead.sort()
        if dead:
            self.logger.warning(
                f"admin dump '{prefix}': lane(s) {dead} are DEAD — "
                f"their ops/stages are missing from this dump")
        return replies, dead

    async def _dump_op_stages(self) -> dict:
        from ceph_tpu_torch.common import tracer as tracer_mod
        extra, dead = [], []
        if self.shards.process_lanes is not None:
            replies, dead = await self._lane_dump_calls("stage_dumps")
            extra = [r for _, r in replies]
        out = tracer_mod.stage_table(self.ctx.perf, extra_dumps=extra)
        out["op_tracing"] = bool(self.ctx.tracer.enabled)
        if self.shards.process_lanes is not None:
            out["lanes_merged"] = len(extra)
            out["lane_dead"] = dead
        return out

    async def _dump_historic_slow_ops(self) -> dict:
        out = self.op_tracker.dump_historic_slow_ops()
        if self.shards.process_lanes is not None:
            replies, dead = await self._lane_dump_calls(
                "dump_historic_slow_ops")
            for idx, r in replies:
                for o in r.get("ops", []):
                    o["lane"] = idx
                out["ops"].extend(r.get("ops", []))
                out["total_slow_ops"] += int(r.get("total_slow_ops", 0))
            out["num_ops"] = len(out["ops"])
            out["lane_dead"] = dead
        return out

    async def _dump_flight_recorder(self) -> dict:
        out = self.op_tracker.dump_flight_recorder()
        if self.shards.process_lanes is not None:
            replies, dead = await self._lane_dump_calls(
                "dump_flight_recorder")
            for idx, r in replies:
                for rec in r.get("records", []):
                    rec["lane"] = idx
                out["records"].extend(r.get("records", []))
            out["num_records"] = len(out["records"])
            out["lane_dead"] = dead
        return out

    async def _perf_dump_full(self) -> dict:
        """The per-daemon half of ``perf dump --cluster``: this
        process's mergeable snapshot plus a FRESH one from every live
        lane worker (on-demand FRAME_RPC scrape), with dead lanes
        named loudly."""
        from ceph_tpu_torch.common import metrics
        snaps = [metrics.snapshot(self.ctx,
                                  source=f"osd.{self.whoami}")]
        dead: list = []
        if self.shards.process_lanes is not None:
            dead_idx = await self.shards.fetch_lane_metrics()
            for idx, snap in sorted(
                    self.shards.lane_metric_snapshots().items()):
                if snap and idx not in dead_idx:
                    snaps.append(snap)
            dead = [f"osd.{self.whoami}/lane{i}" for i in dead_idx]
        return {"metrics_schema": metrics.METRICS_SCHEMA,
                "snapshots": snaps, "lane_dead": dead}

    async def _store_bench(self, count: int, size: int) -> dict:
        """Timed object writes straight at the ObjectStore — measures
        the local persistence path with no client/network in the way
        (OSD::bench).  Async with a yield per object so heartbeats and
        client IO on the shared event loop keep breathing; random
        payload so a compression-enabled BlockStore measures the write
        path, not the compressor.  The bench collection is destroyed
        afterwards (OP_RMCOLL drops contained objects)."""
        import os as _os
        import time as _time
        from ceph_tpu_torch.store.types import CollectionId, ObjectId
        count = max(1, min(count, 1024))
        size = max(1, min(size, 16 << 20))
        cid = CollectionId(f"bench.{self.whoami}")
        payload = _os.urandom(size)
        t = Transaction()
        if not self.store.collection_exists(cid):
            t.create_collection(cid)
        self.store.apply_transaction(t)
        t0 = _time.perf_counter()
        for i in range(count):
            t = Transaction()
            t.write(cid, ObjectId(f"bench.{i}"), 0, payload)
            # queue without waiting: the commit thread groups the whole
            # burst into shared fsyncs (the path client IO rides too)
            self.store.queue_transactions([t])
            await asyncio.sleep(0)
        self.store.sync()
        dt = _time.perf_counter() - t0
        t = Transaction()
        t.remove_collection(cid)
        self.store.apply_transaction(t)
        return {"bytes_written": count * size, "seconds": round(dt, 4),
                "bytes_per_sec": round(count * size / dt, 1)
                if dt else 0.0,
                "commit": self.store.commit_counters()}

    def _send_cluster_log(self, entry: dict) -> None:
        try:
            self.monc.messenger.send_message(
                MLog([{"stamp": entry["stamp"], "who": entry["who"],
                       "level": entry["level"],
                       "message": entry["msg"]}]),
                self.monc.monmap.addr_of_rank(self.monc.cur_mon),
                peer_type="mon")
        except Exception:
            pass

    async def _report_stats(self) -> None:
        """Periodic PG/OSD stats to the mon (MPGStats -> PGMap)."""
        interval = self.cfg["osd_mon_report_interval"]
        while self.running:
            await asyncio.sleep(interval)
            self._send_pg_stats(self._pg_stat_rows())

    def _pg_stat_rows(self) -> List[dict]:
        """One stats sweep over the hosted primaries (rows merge
        per-pgid in the mon's PGMap, so lane workers each reporting
        their slice compose).  The usage cache persists across sweeps
        on the bound method's daemon."""
        from ceph_tpu_torch.osd.pg import STATE_ACTIVE
        # pg.last_update version -> (num_objects, num_bytes): unchanged
        # PGs skip the store walk, so steady-state reporting is O(PGs)
        usage_cache: Dict[PGId, tuple] = getattr(
            self, "_usage_cache", None) or {}
        self._usage_cache = usage_cache
        rows = []
        for pg in list(self.pgs.values()):
            if not pg.is_primary():
                continue
            # a clean primary still pinned to pg_temp lost its clear
            # request (mon down / not leader at the time): re-send
            # until the map reflects it
            if (pg.is_fully_clean() and self.osdmap.pg_temp.get(
                    pg.pgid.without_shard())):
                pg.send_pg_temp([])
            ver = (pg.info.last_update.epoch,
                   pg.info.last_update.version)
            cached = usage_cache.get(pg.pgid)
            if cached is not None and cached[0] == ver:
                _, n_objs, nbytes = cached
            else:
                try:
                    from ceph_tpu_torch.osd.backend import SIZE_XATTR
                    objs = [o for o in
                            self.store.collection_list(pg.cid)
                            if o.name != pg.meta_oid.name
                            and o.is_head()]

                    def _obj_bytes(o):
                        # EC shards store chunk bytes; the LOGICAL
                        # object length rides SIZE_XATTR (hinfo
                        # role) so pool stats report what the
                        # client stored, not the shard residue.
                        # Replicated pools never carry the xattr —
                        # plain stat, no probe.
                        if not pg.pool.is_erasure():
                            return self.store.stat(pg.cid,
                                                   o)["size"]
                        try:
                            return int(self.store.getattr(
                                pg.cid, o, SIZE_XATTR))
                        except Exception:
                            return self.store.stat(pg.cid,
                                                   o)["size"]
                    nbytes = sum(_obj_bytes(o) for o in objs)
                    n_objs = len(objs)
                    # only cache a SUCCESSFUL walk: recovery pushes
                    # don't bump last_update, so caching a failed or
                    # mid-recovery count would freeze the undercount
                    # until the next client write
                    usage_cache[pg.pgid] = (ver, n_objs, nbytes)
                except Exception:
                    n_objs, nbytes = 0, 0
            state = pg.state
            if state != STATE_ACTIVE and pg.peering_blocked_by:
                # surfaced in `ceph -s` / pg dump like the reference's
                # down+peering with blocked_by
                state = "down+peering"
            if state == STATE_ACTIVE:
                state = "active+clean" if not pg.peer_missing or \
                    not any(pm.items
                            for pm in pg.peer_missing.values()) \
                    else "active+recovering"
            errors = 0
            if pg.last_scrub_result:
                errors = (pg.last_scrub_result.get("errors", 0)
                          - pg.last_scrub_result.get("repaired", 0))
            rows.append({
                "pgid": str(pg.pgid.without_shard()),
                "state": state,
                "num_objects": n_objs,
                "num_bytes": nbytes,
                "scrub_errors": max(errors, 0),
                "log_version": pg.info.last_update.version,
                "up": list(pg.up),
                "acting": list(pg.acting),
            })
        return rows

    def _send_pg_stats(self, rows: List[dict]) -> None:
        osd_stat = {"num_pgs": len(self.pgs)}
        if hasattr(self.store, "statfs"):
            # store capacity for `ceph osd df` (osd_stat_t kb/
            # kb_used role); MemStore-family reports used only.
            # hasattr (not except AttributeError): a bug INSIDE a
            # real statfs must surface, not silently zero the df
            osd_stat["statfs"] = self.store.statfs()
        try:
            self.monc.messenger.send_message(
                MPGStats(self.whoami, self.osdmap.epoch, rows,
                         osd_stat),
                self.monc.monmap.addr_of_rank(self.monc.cur_mon),
                peer_type="mon")
        except Exception:
            pass

    # ---------------------------------------------------------------- scrub
    async def _scrub_scheduler(self) -> None:
        """Periodic scrub: light every osd_scrub_interval, deep every
        osd_deep_scrub_interval, per PG we lead (PG.cc:3300 sched_scrub
        role; the `osd_scrub_interval` option finally does something)."""
        import time as _time
        light = self.cfg["osd_scrub_interval"]
        deep = self.cfg["osd_deep_scrub_interval"]
        poll = max(0.5, min(light, deep) / 4)
        from ceph_tpu_torch.osd.pg import STATE_ACTIVE
        from ceph_tpu_torch.osd.osdmap import FLAG_NODEEP_SCRUB, FLAG_NOSCRUB
        while self.running:
            await asyncio.sleep(poll)
            # compared against the PERSISTED (wall-clock) PGInfo scrub
            # stamps — see scrub.py: monotonic resets across restarts
            now = int(_time.time() * 1000)  # lint: allow[MONO05] persisted stamp
            # cluster flags gate SCHEDULED scrubs only; operator `pg
            # scrub` commands still run (OSD::sched_scrub noscrub)
            no_light = bool(self.osdmap.flags & FLAG_NOSCRUB)
            no_deep = no_light or bool(self.osdmap.flags
                                       & FLAG_NODEEP_SCRUB)
            for pg in list(self.pgs.values()):
                if not pg.is_primary() or pg.state != STATE_ACTIVE:
                    continue
                # stamp/queue decisions mutate PG state: home shard.
                # PORT13: only the ROUTING KEY crosses the seam — the
                # home lane re-resolves its own PG (a live reference
                # cannot exist in the sending process once lanes
                # split)
                self.shards.route(pg.pgid, self._sched_scrub_pg,
                                  pg.pgid, now, no_light, no_deep,
                                  light * 1000, deep * 1000)

    def _sched_scrub_pg(self, pgid: PGId, now: int, no_light: bool,
                        no_deep: bool, light_ms: float,
                        deep_ms: float) -> None:
        """Home-shard half of the scrub scheduler for one PG."""
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary():
            return      # remapped/removed while the route was in flight
        if not pg.is_fully_clean():
            # PG::sched_scrub scrubs clean PGs only: a PG that still owes
            # recovery or backfill would report the copies in flight as
            # errors and "repair" them with pushes racing the recovery's
            return
        info = pg.info
        if info.last_scrub_stamp == 0:
            # fresh PG: activation counts as scrubbed (no boot
            # storm of deep scrubs on an empty cluster)
            info.last_scrub_stamp = now
            info.last_deep_scrub_stamp = now
            return
        if pg._scrub_queued:
            return        # one in flight; stamp moves on completion
        if not no_deep and now - info.last_deep_scrub_stamp > deep_ms:
            pg._scrub_queued = True
            pg.queue_op(MPGScrub(pg.pgid, deep=True))
        elif not no_light and now - info.last_scrub_stamp > light_ms:
            pg._scrub_queued = True
            pg.queue_op(MPGScrub(pg.pgid, deep=False))

    # ----------------------------------------------------------- heartbeats
    async def _tier_agent_loop(self) -> None:
        """Periodic cache-tier agent: enqueue an agent pass on every
        primary cache-pool PG's worker (serializes with client ops)."""
        from ceph_tpu_torch.osd.pg import STATE_ACTIVE
        interval = self.cfg["osd_tier_agent_interval"]
        while self.running:
            await asyncio.sleep(interval)
            for pg in list(self.pgs.values()):
                if (pg.is_primary() and pg.pool.is_tier()
                        and pg.pool.cache_mode == "writeback"
                        and pg.state == STATE_ACTIVE):
                    # enqueue on the PG's home shard (SHARD11 seam).
                    # PORT13: the agent-pass closure is built ON the
                    # home lane (_queue_agent_pass) — shipping a
                    # lambda over the seam would capture the live PG
                    self.shards.route(pg.pgid, self._queue_agent_pass,
                                      pg.pgid)

    def _queue_agent_pass(self, pgid: PGId) -> None:
        """Home-shard half of the tier-agent tick: re-resolve the PG
        and park the agent pass on its worker queue."""
        from ceph_tpu_torch.osd import tiering
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary():
            return
        pg.queue_op(lambda: tiering.agent_work(pg))

    def _hb_peers(self) -> List[int]:
        peers = set()
        for pg in list(self.pgs.values()):
            for o in pg.acting + pg.up:
                if o != self.whoami and o != CRUSH_ITEM_NONE \
                        and self.osdmap.is_up(o):
                    peers.add(o)
        return sorted(peers)

    async def _boot_loop(self) -> None:
        """Send MOSDBoot at rotating mons until the osdmap says we're
        up.  Rotation matters: boots are leader-only intake and the osd
        doesn't know the leader, so spraying ranks guarantees one lands
        once ANY quorum exists."""
        from ceph_tpu_torch.common.backoff import Backoff
        rank = self.monc.cur_mon
        bo = Backoff("boot_resend", base=0.25, cap=2.0)
        while self.running and not self.osdmap.is_up(self.whoami):
            self.monc.messenger.send_message(
                MOSDBoot(self.whoami, self.messenger.addr),
                self.monc.monmap.addr_of_rank(rank), peer_type="mon")
            rank = (rank + 1) % self.monc.monmap.size()
            await bo.sleep()

    async def _heartbeat(self) -> None:
        interval = self.cfg["osd_heartbeat_interval"]
        grace = self.cfg["osd_heartbeat_grace"]
        while self.running:
            await asyncio.sleep(interval)
            try:
                # slow-op sweep rides the heartbeat cadence (the
                # reference's check_ops_in_flight tick)
                self.op_tracker.check_slow()
                now = time.monotonic()
                peers = self._hb_peers()
                stale = [p for p in peers
                         if now - self._hb_last.get(p, now) > grace]
                if peers and len(stale) > max(1, len(peers) // 2):
                    # more than half the cluster "failed" at once: almost
                    # certainly OUR event loop stalled, not them — reset
                    # stamps instead of mass-reporting (clock-skew guard
                    # role of the reference's heartbeat checks)
                    for p in stale:
                        self._hb_last[p] = now
                for p in peers:
                    self._hb_last.setdefault(p, now)
                    self.send_osd(p, MOSDPing(
                        MOSDPing.PING, self.whoami, self.osdmap.epoch, now))
                    if now - self._hb_last[p] > grace:
                        self.logger.warning(
                            f"osd.{p} missed heartbeats for "
                            f"{now - self._hb_last[p]:.1f}s; reporting")
                        self.messenger.send_message(
                            MOSDFailure(p, True, self.osdmap.epoch,
                                        now - self._hb_last[p]),
                            self.monc.monmap.addr_of_rank(self.monc.cur_mon),
                            peer_type="mon")
                        self._hb_last[p] = now  # rate-limit re-reports
            except Exception:
                self.logger.exception("heartbeat tick failed")

    def _handle_ping(self, m: MOSDPing) -> None:
        if m.op == MOSDPing.PING:
            self.send_osd(m.from_osd, MOSDPing(
                MOSDPing.PING_REPLY, self.whoami, self.osdmap.epoch,
                m.stamp))
        else:
            self._hb_last[m.from_osd] = time.monotonic()
