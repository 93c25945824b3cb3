"""PG: placement-group peering state machine + op execution.

Reference parity: osd/PG.{h,cc} (peering statechart PG.h:1604-2019 —
here an explicit async procedure: GetInfo → GetLog → recover-self →
activate peers → Active), osd/ReplicatedPG.cc (do_request/do_op/
execute_ctx op interpreter :1575,1716,3036,4317), with the strategy
split behind PGBackend (osd/PGBackend.h) in backend.py.

Redesign notes (vs the boost::statechart original):
- Peering probes a real PriorSet (PG::PriorSet / build_prior): the
  current up∪acting PLUS the acting members of every maybe-went-rw
  past interval since last_epoch_started (past_intervals are rebuilt
  from stored map history in generate_past_intervals, exactly the
  reference's generate_past_intervals role).  The best info (highest
  last_update, ties by longer log) becomes authoritative; peering
  BLOCKS while a maybe-rw interval has no live, non-lost member —
  stale survivors of an older interval can never serve over newer
  writes they missed (tests/test_peering.py stale-survivor cascade).
  The primary first heals itself (log merge + whole-object pulls),
  then ships logs and pushes missing objects to peers.
- Divergent local entries are rewound (PGLog.rewind_to) and the objects
  re-pulled from the authoritative peer — the reference's
  rewind_divergent_log.
- Writes to an object still missing on some replica trigger
  recover-before-write, like the reference's is_missing_object wait.
- Per-PG ordering comes from one asyncio worker per PG consuming an op
  queue — the ShardedOpWQ role (osd/OSD.h:1748); batching across PGs
  for the device happens in the EC backend.

The port's copy of ``ceph_tpu.osd.pg``.  Backfill planning places each
listing window through ``OSD.place_objects`` (the OSD's CRUSH engine and
device).  A peer's info answers the peering round that asked for it: a
notify from an earlier round is dropped, where the JAX package takes it
(after an EC shard move it describes the peer's old shard, complete, and
the new one is never filled).  A write sub-op handed over in process
(mesh mode) to a replica its primary has not activated yet waits for the
activation, where the JAX package applies it at once (the activation,
sent earlier on the messenger, then replaces the log and the write's
entry is lost).  On an EC pool peering takes as the authority no version
that fewer than k complete copies reached (``_ec_rollback_cap``): such a
write was never acked, and the primary rolls its lone entry back, where
the JAX package keeps it authoritative with fewer shards than a decode
needs.  It does so only with proof: k members of every interval that
may have taken writes since that version answered for the shard they
held there (``_rollback_proven``); else it peers from the longest log,
as the JAX package does.  Interval walks read each epoch's
mappings from the OSD (``OSD.interval_row``), so no walk decodes or
primes a map twice.  Peering waits for every up member of its prior
set, asking again each ``PEER_INFO_WAIT_S``, as Ceph's GetInfo waits,
where the JAX package fails the round after 10 s (an ERROR record) and
starts another.
"""

from __future__ import annotations

import asyncio
import errno
import time
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
from ceph_tpu_torch.osd.messages import (
    EVersion, MOSDOp, MOSDOpReply, MPGLog, MPGLogRequest, MPGNotify,
    MPGObjectList, MPGPush, MPGPushReply, MPGQuery,
)
from ceph_tpu_torch.osd.pglog import (
    LB_MAX, LogEntry, MissingSet, PastInterval, PGInfo, PGLog)
from ceph_tpu_torch.osd.types import NO_SHARD, PGId, PGPool
from ceph_tpu_torch.store.objectstore import Transaction
from ceph_tpu_torch.store.types import CollectionId, ObjectId

STATE_RESET = "reset"

#: seconds peering waits for a prior-set member's info before it asks an
#: up member again (a down one is passed over)
PEER_INFO_WAIT_S = 10.0


def _check_unfrozen(txn: Transaction) -> None:
    # copy discipline (msg/payload.py): a txn received over
    # ms_local_delivery is the SENDER'S sealed object — appending our
    # meta ops to it would leak into the primary and every sibling
    # replica.  Receivers must use m.txn() (mutable copy); a real
    # raise (not an -O-strippable assert) turns a violation into a
    # loud failure instead of silent cross-daemon corruption.
    if getattr(txn, "frozen", False):
        raise ValueError(
            "save_meta on a frozen payload-shared txn — use m.txn()")
STATE_PEERING = "peering"
STATE_ACTIVE = "active"


class _FifoQueue(asyncio.Queue):
    """osd_op_queue=fifo: plain queue ignoring the class tag."""

    QOS = False

    def put_nowait(self, item, klass: str = "client") -> None:
        super().put_nowait(item)


class PG:
    def __init__(self, osd, pgid: PGId, pool_id: int, pool: PGPool):
        self.osd = osd
        self.log_ = osd.logger
        self.pgid = pgid                    # includes our shard for EC
        self.pool_id = pool_id
        self.pool = pool
        self.cid = CollectionId.pg(pool_id, pgid.seed, pgid.shard)
        self.meta_oid = ObjectId("_pgmeta_", pool=pool_id)
        self.info = PGInfo(pgid)
        self.log = PGLog()
        self.reqids: Dict[str, EVersion] = {}   # dup-write detection
        self.missing = MissingSet()
        self.peer_info: Dict[int, PGInfo] = {}
        self.peer_missing: Dict[int, MissingSet] = {}
        self._backfilling: Set[int] = set()   # peers mid-full-resync
        # primary-side durable record of each backfill target's cursor:
        # the highest name this primary saw ACKED per target (persisted
        # in PG meta, b"peer_cursors").  On restart it caps how much of
        # a target's self-reported cursor the resume trusts — never a
        # substitute for the target's own durable PGInfo.last_backfill,
        # which rides every push txn on the target itself
        self.peer_backfill_cursors: Dict[int, str] = {}
        # closed mapping intervals since last_epoch_started
        # (PG::past_intervals) + who blocks peering (PriorSet pg_down)
        self.past_intervals: List[PastInterval] = []
        self.peering_blocked_by: List[int] = []
        self._probe_shards: Dict[int, int] = {}   # probe osd -> EC shard
        self._strays: Set[int] = set()            # probed non-members
        # current mapping
        self.up: List[int] = []
        self.acting: List[int] = []
        self.primary = -1
        self.role = -1                      # index in acting, -1 = stray
        self.state = STATE_RESET
        self.interval_epoch = 0
        self._active_event = asyncio.Event()
        self._peering_task: Optional[asyncio.Task] = None
        # op scheduler (osd_op_queue, config_opts.h:706): wpq arbitrates
        # client ops vs scrub vs tier-agent passes on the PG worker so
        # neither housekeeping class starves client latency nor a client
        # flood starves housekeeping (WeightedPriorityQueue.h role).
        # mclock swaps in the dmClock tag queue (common/qos.py) at the
        # SAME seam — the PG worker runs identically in inline, thread
        # and process lanes, so one seam covers every lane mode; wpq
        # stays bit-for-bit the pre-QoS queue (FAST_CFG determinism)
        qname = osd.cfg["osd_op_queue"]
        if qname == "mclock":
            from ceph_tpu_torch.common.qos import DmClockQueue, parse_specs
            self._op_queue = DmClockQueue(
                parse_specs(osd.cfg["osd_qos_specs"]))
        elif qname == "wpq":
            from ceph_tpu_torch.common.wpq import WeightedPriorityQueue
            self._op_queue = WeightedPriorityQueue()
        else:
            self._op_queue = _FifoQueue()
        self._worker_task: Optional[asyncio.Task] = None
        self._worker_busy = False    # worker mid-item (fast-path gate)
        # per-PG op pipelining (osd/sequencer.py): up to
        # osd_pg_max_inflight_ops client ops run concurrently as their
        # own tasks, dependency-tracked by object id; barrier-class
        # work drains the window first.  The depth counters live in
        # one OSD-wide perf group so bench/perf-smoke can read the
        # achieved pipelining without walking every PG.
        from ceph_tpu_torch.osd.sequencer import OpSequencer
        self.op_window = OpSequencer(
            osd.cfg["osd_pg_max_inflight_ops"],
            perf=getattr(osd, "perf_window", None),
            tracer=getattr(osd.ctx, "tracer", None))
        # task -> its MOSDOp: stop() must release each admitted op's
        # OSD-wide accounting (dispatch throttle, OpTracker) even when
        # the cancelled task never reached _do_client_op's finally
        self._window_tasks: Dict[asyncio.Task, MOSDOp] = {}
        # request/reply matching for peering + recovery
        self._notify_waiters: Dict[int, asyncio.Future] = {}
        self._log_waiters: Dict[int, asyncio.Future] = {}
        # write sub-ops handed over in process ahead of this replica's
        # activation (hold_until_active)
        self._held_sub_writes: List = []
        self._list_waiters: Dict[int, asyncio.Future] = {}
        self._pull_waiters: Dict[str, asyncio.Future] = {}
        self._push_acks: Dict[Tuple[int, str], asyncio.Future] = {}
        self._scrub_map_waiters: Dict[int, asyncio.Future] = {}
        self.last_scrub_result: Optional[Dict] = None
        self._scrub_queued = False      # scheduler de-dup flag
        # watch/notify (osd/Watch.h): oid -> {watcher name: client addr}.
        # Primary-local watch state; clients re-register on every new
        # osdmap (Rados._rewatch), covering primary changes, and
        # watchers that miss a notify are reaped (timeout role).
        self.watches: Dict[str, Dict[str, object]] = {}
        self._notify_acks: Dict[int, Tuple[Set[str], asyncio.Future,
                                           List]] = {}
        self._trimmed_snaps: Set[int] = set()
        # cache tiering (lazy: a pool can become a tier after creation)
        self._hitset = None
        self._perf_tier = None
        self._hitset_rotated = 0.0
        self._hitset_seq = 0
        self._hitsets_loaded = False
        self._hitset_persisting = False   # windowed-op re-entrancy guard
        from ceph_tpu_torch.osd.backend import ECBackend, ReplicatedBackend
        self.backend = (ECBackend(self) if pool.is_erasure()
                        else ReplicatedBackend(self))
        # incremental pglog persistence (osd/PGLog.cc omap-write role):
        # appends since the last full `log` blob snapshot, compacted
        # back into the blob every META_COMPACT_EVERY appends so the
        # per-entry key range stays bounded (see save_meta_log)
        self._meta_log_appends = 0

    # ----------------------------------------------------------- utilities
    def is_primary(self) -> bool:
        if self.osd.whoami != self.primary:
            return False
        # EC instances are keyed by shard (spg_t): across a role change
        # one osd briefly hosts two instances of the same PG — the
        # newborn keyed by the new shard and the old-shard copy held as
        # a stray.  Only the instance keyed by our CURRENT role is
        # primary; a shard-blind check makes both claim it, and they
        # fight over peering, activation and the op queue (the
        # recovery-under-load wedge: the stray wins the races while
        # client ops rot on the newborn)
        if self.pool.is_erasure() and self.pgid.shard != NO_SHARD:
            return self.pgid.shard == self.shard_of(self.osd.whoami)
        return True

    def actual_peers(self) -> List[int]:
        """Live members of up∪acting besides ourselves."""
        peers = []
        for o in set(self.up) | set(self.acting):
            if o != self.osd.whoami and o >= 0 and o != CRUSH_ITEM_NONE \
                    and self.osd.osdmap.is_up(o):
                peers.append(o)
        return sorted(peers)

    def shard_of(self, osd_id: int) -> int:
        """EC shard position of osd_id; NO_SHARD for replicated.  An
        up-but-not-acting member (backfill target under pg_temp) owns
        the shard of its UP position."""
        if not self.pool.is_erasure():
            return NO_SHARD
        for i, o in enumerate(self.acting):
            if o == osd_id:
                return i
        for i, o in enumerate(self.up):
            if o == osd_id:
                return i
        return NO_SHARD

    def is_fully_clean(self) -> bool:
        """Active with every copy caught up (no recovery owed)."""
        return (self.state == STATE_ACTIVE and not self._backfilling
                and not self.missing
                and not any(pm.items
                            for pm in self.peer_missing.values()))

    def send_pg_temp(self, want: List[int]) -> None:
        """Ask the mon for a pg_temp override ([] clears) —
        queue_want_pg_temp."""
        from ceph_tpu_torch.mon.messages import MPGTemp
        self.osd.monc.messenger.send_message(
            MPGTemp(self.osd.whoami, {self.pgid.without_shard(): want}),
            self.osd.monc.monmap.addr_of_rank(self.osd.monc.cur_mon),
            peer_type="mon")

    def describe(self) -> str:
        return (f"pg {self.pgid} {self.state} role {self.role} "
                f"up {self.up} acting {self.acting} "
                f"lu {self.info.last_update}")

    # --------------------------------------------------------- persistence
    #: appends between full-blob compactions: the per-entry key range
    #: holds at most this many entries beyond the `log` blob snapshot,
    #: and the O(len(log)) re-encode is amortized to O(1) per write
    META_COMPACT_EVERY = 2 * PGLog.MAX_ENTRIES

    @staticmethod
    def _log_entry_key(version: EVersion) -> bytes:
        """Sortable per-entry omap key (fixed-width hex: byte order ==
        version order, so load_meta's overlay and the compaction
        rmkeyrange both work on plain key ranges)."""
        return b"loge.%08x.%016x" % (version.epoch, version.version)

    def _loghead_bytes(self) -> bytes:
        """The small head record written on EVERY incremental append:
        authoritative (tail, head) bounds, so load_meta can trim
        entries the in-memory log dropped without the full blob ever
        being rewritten."""
        from ceph_tpu_torch.common.encoding import Encoder
        return Encoder().struct(self.log.tail).struct(
            self.log.head).getvalue()

    def save_meta(self, txn: Transaction) -> None:
        from ceph_tpu_torch.common.encoding import Encoder
        _check_unfrozen(txn)
        txn.touch(self.cid, self.meta_oid)
        # full snapshot: the per-entry append keys are superseded by
        # the fresh blob — drop the whole range so a later load can't
        # overlay stale entries a rewind/merge just removed
        txn.omap_rmkeyrange(self.cid, self.meta_oid,
                            b"loge.", b"loge.\xff")
        self._meta_log_appends = 0
        txn.omap_setkeys(self.cid, self.meta_oid, {
            b"info": self.info.to_bytes(),
            b"log": self.log.to_bytes(),
            b"loghead": self._loghead_bytes(),
            b"past_intervals": Encoder().list_(
                self.past_intervals,
                lambda e, v: e.struct(v)).getvalue(),
            # the missing set survives restarts: reconstruction from the
            # log window cannot see STALE-version objects, only absent
            # ones (pg_missing_t is likewise persisted in the reference)
            b"missing": Encoder().map_(
                dict(self.missing.items),
                lambda e, k: e.string(k),
                lambda e, v: e.struct(v)).getvalue(),
            # per-target backfill cursors (primary side): what WE saw
            # acked durably, survives a primary crash mid-backfill.
            # Legacy meta layouts simply lack the key (load tolerates)
            b"peer_cursors": Encoder().map_(
                self.peer_backfill_cursors,
                lambda e, k: e.s32(k),
                lambda e, v: e.string(v)).getvalue(),
        })

    def save_meta_log(self, txn: Transaction,
                      entry: Optional[LogEntry] = None) -> None:
        """Incremental meta persistence for the WRITE path (osd/
        PGLog.cc incremental omap writes): one per-entry key (its
        framed bytes are already cached on the entry) + the O(1)
        info/loghead head — instead of re-encoding the whole
        `log`/`missing` blobs on every write, which profiled as the
        single biggest per-op CPU slice at shards=4.  Non-log state
        (missing, past_intervals) only changes on peering/recovery
        paths, which still go through the full save_meta().

        Every META_COMPACT_EVERY appends the full snapshot is
        rewritten and the append range cleared, bounding both the
        omap key count and load_meta's overlay work."""
        if entry is None or \
                self._meta_log_appends >= self.META_COMPACT_EVERY:
            self.save_meta(txn)
            return
        _check_unfrozen(txn)
        self._meta_log_appends += 1
        txn.touch(self.cid, self.meta_oid)
        txn.omap_setkeys(self.cid, self.meta_oid, {
            self._log_entry_key(entry.version): entry.framed_bytes(),
            b"info": self.info.to_bytes(),
            b"loghead": self._loghead_bytes(),
        })

    def load_meta(self) -> None:
        try:
            _, omap = self.osd.store.omap_get(self.cid, self.meta_oid)
        except Exception:
            return
        if b"info" in omap:
            self.info = PGInfo.from_bytes(omap[b"info"])
        if b"log" in omap:
            self.log = PGLog.from_bytes(omap[b"log"])
        # overlay the incremental append keys (newer than the blob
        # snapshot; fixed-width keys sort in version order) — a store
        # written by the legacy layout simply has none
        for k in sorted(k for k in omap if k.startswith(b"loge.")):
            e = LogEntry.from_bytes(omap[k])
            if self.log.head < e.version:
                self.log.append(e)
        if b"loghead" in omap:
            from ceph_tpu_torch.common.encoding import Decoder
            d = Decoder(omap[b"loghead"])
            tail = d.struct(EVersion)
            if self.log.tail < tail:
                # the in-memory log trimmed past the blob's tail while
                # only incremental heads were written: honor the
                # recorded bound (entries <= tail are no longer owed)
                self.log.entries = [e for e in self.log.entries
                                    if tail < e.version]
                self.log.tail = tail
        if self.log.entries or b"log" in omap:
            self.reqids = self.log.reqids()
        if b"past_intervals" in omap:
            from ceph_tpu_torch.common.encoding import Decoder
            self.past_intervals = Decoder(
                omap[b"past_intervals"]).list_(
                lambda d: d.struct(PastInterval))
        if b"missing" in omap:
            from ceph_tpu_torch.common.encoding import Decoder
            for oid, v in Decoder(omap[b"missing"]).map_(
                    lambda d: d.string(),
                    lambda d: d.struct(EVersion)).items():
                self.missing.add(oid, v)
        if b"peer_cursors" in omap:
            from ceph_tpu_torch.common.encoding import Decoder
            self.peer_backfill_cursors = Decoder(
                omap[b"peer_cursors"]).map_(
                lambda d: d.s32(), lambda d: d.string())
        # belt: a crash between log advance and object pulls leaves
        # last_complete < last_update — rebuild absent objects from that
        # window too (PGLog::read_log missing reconstruction role)
        if self.info.last_complete < self.info.last_update \
                and self.log.can_catch_up_from(self.info.last_complete):
            stored = {s.name
                      for s in self.osd.store.collection_list(self.cid)}
            for oid, e in self.log.objects_since(
                    self.info.last_complete).items():
                if not e.is_delete() and oid not in stored \
                        and oid not in self.missing.items:
                    self.missing.add(oid, e.version)

    def create_onstore(self) -> None:
        if not self.osd.store.collection_exists(self.cid):
            txn = Transaction().create_collection(self.cid)
            self.save_meta(txn)
            self.osd.store.apply_transaction(txn)

    # ------------------------------------------------------------ mapping
    def start(self) -> None:
        if self._worker_task is None:
            self._worker_task = asyncio.get_running_loop().create_task(
                self._worker())

    def advance_map(self, osdmap) -> None:
        """New osdmap: recompute role; new interval restarts peering
        (PG::handle_advance_map)."""
        up, up_primary, acting, acting_primary = \
            osdmap.pg_to_up_acting_osds(self.pgid.without_shard())
        interval_changed = (acting != self.acting or up != self.up
                            or acting_primary != self.primary)
        if interval_changed and self.info.same_interval_since \
                and (self.up or self.acting):
            # close the old interval (PG::start_peering_interval ->
            # pg_interval_t::check_new_interval).  maybe_went_rw: the old
            # primary asserted up_thru into the interval and had enough
            # members to meet min_size — writes may have committed there
            old_acting = [o for o in self.acting
                          if o >= 0 and o != CRUSH_ITEM_NONE]
            went_rw = (self.primary >= 0
                       and osdmap.get_up_thru(self.primary)
                       >= self.info.same_interval_since
                       and len(old_acting) >= self.pool.min_size)
            self.past_intervals.append(PastInterval(
                self.info.same_interval_since, osdmap.epoch - 1,
                list(self.up), list(self.acting), self.primary, went_rw))
            # trim intervals fully before the last started epoch: their
            # writes are subsumed by any copy from last_epoch_started on
            self.past_intervals = [
                iv for iv in self.past_intervals
                if iv.last >= self.info.last_epoch_started]
        self.up, self.acting, self.primary = up, acting, acting_primary
        me = self.osd.whoami
        self.role = self.acting.index(me) if me in self.acting else -1
        if interval_changed:
            self.info.same_interval_since = osdmap.epoch
            self.interval_epoch = osdmap.epoch
            self.state = STATE_PEERING
            self._active_event.clear()
            # sub-ops held for the closed interval's activation are that
            # interval's: dropped, as a stale sub-op is on arrival
            self._drop_held_sub_writes()
            # acks from the old acting set can never complete: fail
            # in-flight futures now so writes abort with EAGAIN instead
            # of riding out their timeout (ReplicatedPG::do_request
            # epoch re-checks)
            self.backend.on_interval_change()
            if self._peering_task is not None:
                self._peering_task.cancel()
                self._peering_task = None
            if self.is_primary():
                self._peering_task = \
                    asyncio.get_running_loop().create_task(self._peer())
            # non-primaries wait for the primary's MPGLog(activate)

    def generate_past_intervals(self, replace: bool = False) -> None:
        """Reconstruct closed intervals from the OSD's stored map history
        (PG::generate_past_intervals): a freshly instantiated copy — new
        member or rebooted after missing epochs — must learn which acting
        sets may have accepted writes while it wasn't watching, or the
        PriorSet walk would trust an incomplete world.

        With replace=True the list is rebuilt from scratch starting at
        last_epoch_started — the authoritative pre-peering pass (holes in
        the map history must be filled first; see OSD.ensure_map_history).
        """
        cur_map = self.osd.osdmap
        if replace:
            self.past_intervals = []
            start = max(self.info.last_epoch_started, 1)
        else:
            start = max(self.info.same_interval_since, 1)
        known_to = max((iv.last for iv in self.past_intervals), default=0)
        prev = None   # [up, acting, primary, first_epoch]
        for e in range(start, cur_map.epoch + 1):
            row = self.osd.interval_row(self.pool_id, e,
                                        self.pgid.without_shard(), cur_map)
            if row is None:
                continue
            up, acting, actp, min_size, up_thru = row
            if prev is None:
                prev = [up, acting, actp, e]
                continue
            if (up, acting, actp) != (prev[0], prev[1], prev[2]):
                if e - 1 > known_to:
                    went_rw = (prev[2] >= 0
                               and 0 <= prev[2] < len(up_thru)
                               and up_thru[prev[2]] >= prev[3]
                               and len([o for o in prev[1] if o >= 0
                                        and o != CRUSH_ITEM_NONE])
                               >= min_size)
                    self.past_intervals.append(PastInterval(
                        prev[3], e - 1, list(prev[0]), list(prev[1]),
                        prev[2], went_rw))
                prev = [up, acting, actp, e]
        if prev is not None:
            # the surviving interval is the OPEN one
            self.info.same_interval_since = prev[3]
            if not self.up and not self.acting:
                # fresh instance: adopt the open interval's membership so
                # the advance_map that follows instantiation sees no
                # bogus []->acting "change" that would clobber
                # same_interval_since with the current epoch
                self.up, self.acting, self.primary = (list(prev[0]),
                                                      list(prev[1]),
                                                      prev[2])
                me = self.osd.whoami
                self.role = (self.acting.index(me) if me in self.acting
                             else -1)
                self.interval_epoch = cur_map.epoch

    def ensure_peering(self) -> None:
        """Kick peering on a freshly instantiated copy whose mapping is
        unchanged (advance_map sees no interval change then)."""
        if self.is_primary() and self._peering_task is None \
                and self.state != STATE_ACTIVE:
            self.state = STATE_PEERING
            self._active_event.clear()
            self._peering_task = asyncio.get_running_loop().create_task(
                self._peer())

    def stop(self) -> None:
        for t in (self._peering_task, self._worker_task):
            if t is not None:
                t.cancel()
        self._peering_task = self._worker_task = None
        # in-flight windowed ops: cancel their tasks AND release their
        # OSD-wide accounting here — a task cancelled while parked in
        # slot.wait() (or never scheduled at all) would otherwise leak
        # its dispatch-throttle budget and OpTracker entry forever
        # (the throttle is OSD-wide: enough leaks wedge client intake)
        for t, m in list(self._window_tasks.items()):
            t.cancel()
            self._finish_client_op(m)
        self._window_tasks.clear()
        # drain queued-but-never-run ops so their TrackedOps don't sit in
        # the OpTracker's in-flight dump forever (the client will resend
        # against the new mapping on the next map epoch)
        while not self._op_queue.empty():
            m = self._op_queue.get_nowait()
            if self.osd is not None and isinstance(m, MOSDOp):
                self._finish_client_op(m)

    # ------------------------------------------------------------- peering
    async def _peer(self) -> None:
        epoch = self.interval_epoch
        try:
            await self._peer_inner(epoch)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.log_.exception(f"peering failed for {self.pgid}; retrying")
            await asyncio.sleep(1.0)
            if epoch == self.interval_epoch:
                self._peering_task = asyncio.get_running_loop().create_task(
                    self._peer())

    def _build_prior_set(self) -> Tuple[Dict[int, int], List[int]]:
        """PriorSet (PG::PriorSet): every osd that may hold writes we
        must see — the current up∪acting plus acting members of every
        maybe-went-rw past interval since last_epoch_started.  Returns
        (probe osd -> EC shard to ask, blocked_by osds): peering must
        NOT proceed while an interval that may have gone rw has no
        live member and its down members aren't declared lost."""
        m = self.osd.osdmap
        probe: Dict[int, int] = {p: self.shard_of(p)
                                 for p in self.actual_peers()}
        blocked: List[int] = []
        for iv in self.past_intervals:
            if not iv.maybe_went_rw \
                    or iv.last < self.info.last_epoch_started:
                continue
            any_up, down_not_lost = False, []
            for pos, o in enumerate(iv.acting):
                if o < 0 or o == CRUSH_ITEM_NONE:
                    continue
                if m.is_up(o):
                    any_up = True
                    if o != self.osd.whoami:
                        shard = (pos if self.pool.is_erasure()
                                 else NO_SHARD)
                        probe.setdefault(o, shard)
                elif m.get_lost_at(o) < iv.last:
                    down_not_lost.append(o)
            if not any_up and down_not_lost:
                blocked.extend(down_not_lost)
        return probe, sorted(set(blocked))

    async def _peer_inner(self, epoch: int) -> None:
        # window-drain-on-epoch-change (ROADMAP invariant): ops admitted
        # under the old interval must finish or abort before peering
        # mutates the log/info they execute against.  on_interval_change
        # already failed their ack/read futures, so the drain completes
        # promptly; ops that arrive from here on queue behind the
        # worker's inline wait-for-active and hold no window slot.
        await self.op_window.drain()
        if epoch != self.interval_epoch:
            return   # superseded while draining
        # The interval record kept incrementally by advance_map is only a
        # cache: a full-map jump (mon's >100-epoch subscription fallback)
        # would have collapsed every missed epoch into one interval with
        # stale membership.  Fill map-history holes from the mon and
        # rebuild past_intervals authoritatively before trusting them
        await self.osd.ensure_map_history(
            max(1, self.info.last_epoch_started), self.osd.osdmap.epoch)
        if epoch != self.interval_epoch:
            return   # superseded while backfilling maps
        self.generate_past_intervals(replace=True)
        # GetInfo: query the PriorSet — current peers + past-interval
        # members that may hold newer writes (PG.h GetInfo state)
        self.peer_info.clear()
        self.peer_missing.clear()
        probe, blocked = self._build_prior_set()
        self.peering_blocked_by = blocked
        if blocked:
            # an interval that may have accepted writes has no live
            # member: serving reads/writes now could silently lose those
            # writes.  Wait for one to return or `osd lost` (PG 'down+
            # peering' state).  advance_map cancels+restarts this task
            # on any interval change; lost declarations and reboots
            # change the map, so poll it
            self.log_.warning(
                f"{self.pgid} peering blocked: down osds {blocked} from "
                f"a possibly-rw interval (mark lost to proceed)")
            warned = time.monotonic()
            while True:
                # lint: allow[RETRY19] heartbeat-scale map poll; backoff would slow `osd lost` reaction
                await asyncio.sleep(1.0)
                # advance_map cancellation is the primary exit, but don't
                # rely on it alone: bail if this PG stopped being ours
                # (pool deleted, no longer primary) or the interval moved
                if (epoch != self.interval_epoch or not self.is_primary()
                        or self.pool_id not in
                        self.osd.osdmap.pools):
                    self.peering_blocked_by = []
                    return
                probe, blocked = self._build_prior_set()
                self.peering_blocked_by = blocked
                if not blocked:
                    break
                if time.monotonic() - warned > 30.0:   # rate-limited
                    warned = time.monotonic()
                    self.log_.warning(
                        f"{self.pgid} still blocked by down osds "
                        f"{blocked}")
        peers = sorted(probe)
        self._probe_shards = probe
        self._strays = {p for p in probe
                        if p not in self.acting and p not in self.up}
        self.log_.debug(f"{self.pgid} peering e{epoch}: probing {peers}")
        infos: Dict[int, PGInfo] = {}
        if peers:
            futs = {}
            for p in peers:
                fut = asyncio.get_running_loop().create_future()
                self._notify_waiters[p] = fut
                futs[p] = fut
                self.osd.send_osd(p, MPGQuery(
                    self.pgid.with_shard(probe[p]), epoch,
                    self.osd.whoami))
            for p, fut in futs.items():
                try:
                    while True:
                        try:
                            infos[p] = await asyncio.wait_for(
                                asyncio.shield(fut), PEER_INFO_WAIT_S)
                            break
                        except asyncio.TimeoutError:
                            if not self.osd.osdmap.is_up(p):
                                raise
                        # an UP prior-set member we couldn't hear from
                        # may hold the newest writes: proceeding without
                        # it could elect a stale authority and resync
                        # its data away.  Wait on, as GetInfo does (a
                        # truly dead peer gets marked down by
                        # heartbeats, changing the interval), and ask
                        # again in case the query or its answer was
                        # lost; the round stays this one
                        self.log_.warning(
                            f"{self.pgid}: no info from UP osd.{p} in "
                            f"{PEER_INFO_WAIT_S:g} s; asking again")
                        self.osd.send_osd(p, MPGQuery(
                            self.pgid.with_shard(probe[p]), epoch,
                            self.osd.whoami))
                except asyncio.TimeoutError:
                    self.log_.warning(
                        f"{self.pgid}: no info from down osd.{p}")
                finally:
                    self._notify_waiters.pop(p, None)
        self.peer_info = infos

        # GetLog: adopt the best log (PG::choose_acting/GetLog).  A
        # half-backfilled copy claims its auth donor's last_update but is
        # missing objects — it must never outrank a complete copy
        # (reference find_best_info excludes last_backfill < MAX peers).
        # But the converse trap is worse: a fresh EMPTY copy is
        # "complete", and if it won while the only copies of newer writes
        # are mid-backfill, activation would full-resync the cluster from
        # nothing and delete real data (found by qa/rados_model under
        # out/in+kill churn).  When the freshest last_update exists only
        # on incomplete copies, the PG must wait — the reference's
        # 'incomplete' state
        candidates = dict(infos)
        candidates[self.osd.whoami] = self.info
        max_lu = max(pi.last_update for pi in candidates.values())
        complete_max = max(
            (pi.last_update for pi in candidates.values()
             if pi.backfill_complete), default=None)
        if complete_max is None or complete_max < max_lu:
            holders = [o for o, pi in candidates.items()
                       if pi.last_update == max_lu]
            self.log_.warning(
                f"{self.pgid} incomplete: newest data (lu {max_lu}) "
                f"lives only on mid-backfill copies {holders}; waiting "
                f"for a complete copy")
            await asyncio.sleep(1.0)
            if epoch == self.interval_epoch:
                self._peering_task = \
                    asyncio.get_running_loop().create_task(self._peer())
            return

        def rank(pi: PGInfo):
            return (pi.backfill_complete, pi.last_update,
                    pi.last_epoch_started)
        cap = self._ec_rollback_cap(candidates)
        best_osd, best_info = None, None
        for p, pi in [(self.osd.whoami, self.info)] + list(infos.items()):
            if cap is not None and pi.last_update > cap:
                continue
            if best_info is None or rank(pi) > rank(best_info):
                best_osd, best_info = p, pi
        if best_osd != self.osd.whoami and (
                best_info.last_update != self.info.last_update
                or not self.info.backfill_complete):
            await self._catch_up_from(best_osd, best_info, epoch)

        if self.missing:
            # an earlier peering round was interrupted between advancing
            # last_update and draining its pulls: our log looks caught
            # up, so catch-up was skipped, but objects are still absent.
            # Activating like this serves ENOENT for committed writes
            # and poisons backfill listings (found by qa/rados_model on
            # an EC pool).  Heal from the best peer first
            heal_src = best_osd if best_osd != self.osd.whoami else next(
                iter(sorted(self.peer_info)), -1)
            if heal_src >= 0:
                await self._heal_missing(heal_src, epoch)
                txn = Transaction()
                self.save_meta(txn)
                self.osd.store.apply_transaction(txn)

        # WaitUpThru (PG.h WaitUpThru state): don't activate until the
        # COMMITTED map carries our up_thru for this interval.  The
        # discipline is what makes maybe_went_rw sound in BOTH
        # directions: writes can only have landed in intervals whose
        # primary's grant committed, so the mon may drop a grant whose
        # requester died holding it — and a restarted survivor stops
        # blocking on its dead partner's never-activated solo interval
        while self.osd.osdmap.get_up_thru(self.osd.whoami) \
                < self.info.same_interval_since:
            self.osd.request_up_thru(self.info.same_interval_since)
            # lint: allow[RETRY19] map poll at grant-commit granularity
            await asyncio.sleep(0.05)
            if epoch != self.interval_epoch:
                return

        # compute peer missing + activate peers
        await self._activate(epoch)

    def _ec_rollback_cap(self, candidates: Dict[int, PGInfo]):
        """The newest last_update an EC write can have reached and been
        acked at: the k-th newest among the complete copies, when that is
        proven.  An EC write acks once every shard of the acting set
        committed, so a version fewer than k copies hold was never acked
        if, in every interval that may have taken writes since the cap's
        epoch, k members answered for the shard they held there with a
        complete copy (``_rollback_proven``).  None when the
        pool is replicated, nothing is past the cap, or the proof is
        missing: peering then takes the longest log, as the JAX package
        always does.  Copies past the cap are not taken as the authority:
        the primary rewinds its own such entries and rebuilds the objects
        from k peers at their version (Ceph's EC rollback of divergent
        entries).  The JAX package keeps a write the primary applied
        alone, its sub-ops dropped by replicas already in the next
        interval, authoritative with one shard: its recovery and reads
        fail for good."""
        if not self.pool.is_erasure():
            return None
        k = self.backend.k
        lus = sorted((pi.last_update for pi in candidates.values()
                      if pi.backfill_complete), reverse=True)
        if len(lus) < k or lus[0] <= lus[k - 1]:
            return None
        cap = lus[k - 1]
        return cap if self._rollback_proven(cap, candidates) else None

    def _rollback_proven(self, cap, candidates: Dict[int, PGInfo]) -> bool:
        """Whether no version newer than ``cap`` can have been acked: in
        every interval that may have taken writes since ``cap``'s epoch,
        k members answered, each for the shard it held there with a
        complete copy.  A write acked there sits on every shard of the
        interval, so one held by fewer than k copies was not.  Members
        that are down, or were asked for another shard, leave it
        unproven (Ceph's EC prior set marks such a PG down unless k
        shards of every may-have-written interval answer)."""
        k = self.backend.k
        asked = dict(self._probe_shards)
        asked[self.osd.whoami] = self.pgid.shard
        since = max(cap.epoch, self.info.last_epoch_started)
        for iv in self.past_intervals:
            if not iv.maybe_went_rw or iv.last < since:
                continue
            heard = 0
            for pos, o in enumerate(iv.acting):
                pi = candidates.get(o)
                if (pi is not None and asked.get(o) == pos
                        and pi.backfill_complete):
                    heard += 1
            if heard < k:
                return False
        return True

    async def _catch_up_from(self, peer: int, pinfo: PGInfo,
                             epoch: int) -> None:
        """Merge the authoritative log; rewind divergence; pull objects."""
        fut = asyncio.get_running_loop().create_future()
        self._log_waiters[peer] = fut
        since = self.info.last_update
        peer_shard = self._probe_shards.get(peer, self.shard_of(peer))
        self.osd.send_osd(peer, MPGLogRequest(
            self.pgid.with_shard(peer_shard), epoch, since,
            self.osd.whoami))
        try:
            auth_info, auth_log = await asyncio.wait_for(fut, 15.0)
        finally:
            self._log_waiters.pop(peer, None)
        # divergent local branch? (we have entries the auth log lacks)
        if auth_info.last_update < self.info.last_update:
            divergent = self.log.rewind_to(auth_info.last_update)
            for e in divergent:
                self.missing.add(e.oid, EVersion.zero())
            self._drop_divergent_creates(divergent, auth_log)
        if not self.info.backfill_complete or \
                not auth_log.can_catch_up_from(self.info.last_update):
            # the auth log's window has closed over our position (or our
            # own last resync never finished): log merge would silently
            # lose every object older than the window — full self-resync
            await self._full_resync_from(peer, auth_info, auth_log, epoch)
            return
        added = self.log.merge_from(auth_log, self.info.last_update)
        for e in added:
            self.missing.add(e.oid, e.version)
        self.reqids = self.log.reqids()
        self.info.last_update = self.log.head
        await self._heal_missing(peer, epoch)
        self.info.last_complete = self.info.last_update
        txn = Transaction()
        self.save_meta(txn)
        self.osd.store.apply_transaction(txn)

    def _drop_divergent_creates(self, divergent, auth_log: PGLog) -> None:
        """Roll back to absent the objects that only the rewound entries
        name, when the authoritative log holds the PG's whole history
        (its tail is 0'0): no peer can hold them, so a pull would wait
        for good.  An EC write that fewer than k shards took, rolled back
        by peering, is one; it was never acked.  The JAX package keeps
        them missing and retries the pull (Ceph removes a divergent
        object whose prior version is none)."""
        if not auth_log.can_catch_up_from(EVersion()):
            return
        txn = Transaction()
        for oid in sorted({e.oid for e in divergent}):
            if auth_log.latest_entry_for(oid) is None:
                txn.remove(self.cid, self.object_id(oid))
                self.missing.items.pop(oid, None)
        self.osd.store.apply_transaction(txn)

    async def _heal_missing(self, peer: int, epoch: int) -> None:
        """Drain the primary's own missing set: deletions apply
        directly, the rest are pulled (replicated: whole-object push
        from the auth peer; EC: reconstruct OUR shard from k peers — a
        foreign shard's bytes must never be installed as ours)."""
        for oid in list(self.missing.items):
            latest = self.log.latest_entry_for(oid)
            if latest is not None and latest.is_delete():
                t = Transaction().remove(self.cid, self.object_id(oid))
                self.osd.store.apply_transaction(t)
            else:
                await self.backend.pull_object(peer, oid, epoch)
                if not self.osd.store.exists(self.cid,
                                             self.object_id(oid)):
                    # the donor couldn't provide it (it may be missing
                    # the object too — its tombstone push is rejected):
                    # keep the gap on the books and let the retry loop
                    # find a better source
                    raise RuntimeError(
                        f"{self.pgid}: heal of {oid} from osd.{peer} "
                        f"did not materialize the object")
            self.missing.items.pop(oid, None)

    async def _full_resync_from(self, peer: int, auth_info: PGInfo,
                                auth_log: PGLog, epoch: int) -> None:
        """Primary self-backfill: scan the auth peer's object list, drop
        local objects it doesn't have, pull the rest in sorted-name
        order advancing the last_backfill cursor, only then declare
        ourselves complete (reference backfill, PG.h:1911 — both-sides
        scan with a per-object cursor surviving interruption).

        Resume: objects <= our persisted cursor were pulled by an
        earlier attempt; they only need re-pulling if the auth log
        shows them CHANGED since the scan position we had then.  The
        honest scan position is min(last_update, last_complete):
        last_complete stays CLAMPED at the pre-resync position until
        this resync finishes, so a crash after adopting the new
        last_update but before re-pulling the changed-under-cursor
        objects still re-exposes that delta window to the next attempt
        (instead of silently keeping stale bytes).  When the log window
        has closed over that position the cursor is useless and the
        resync restarts from scratch."""
        prev_lu = min(self.info.last_update, self.info.last_complete)
        resume_from = self.info.last_backfill
        if resume_from == LB_MAX:
            resume_from = ""
        if resume_from and not auth_log.can_catch_up_from(prev_lu):
            resume_from = ""
        self.log_.info(
            f"{self.pgid}: full self-resync from osd.{peer}"
            + (f" (resume >{resume_from!r})" if resume_from else ""))
        # mark the cursor position FIRST: a crash mid-resync must
        # resume/retry, never trust a half-pulled copy
        self.info.last_backfill = resume_from
        txn = Transaction()
        self.save_meta(txn)
        self.osd.store.apply_transaction(txn)
        # adopt the authoritative log/info wholesale
        changed = {oid for oid, e in
                   auth_log.objects_since(prev_lu).items()
                   if not e.is_delete()} if resume_from else set()
        self.log = auth_log
        self.reqids = self.log.reqids()
        self.info.last_update = auth_info.last_update
        # last_complete stays at the honest pre-resync position until
        # the resync COMPLETES (see docstring: crash-window safety)
        self.info.last_complete = min(prev_lu, auth_info.last_update)
        txn = Transaction()
        self.save_meta(txn)
        self.osd.store.apply_transaction(txn)
        # both-sides scan in BOUNDED windows (osd_backfill_scan_max;
        # the reference never ships a whole PG listing in one message)
        local = sorted(s.name for s in
                       self.osd.store.collection_list(self.cid)
                       if s.name != self.meta_oid.name)
        window = max(8, int(self.osd.cfg["osd_backfill_scan_max"]))
        after = ""
        pulled = total = misplaced = 0
        my_pg = self.pgid.without_shard()
        while True:
            names, truncated = await self._fetch_list_window(
                peer, epoch, after, window)
            total += len(names)
            # backfill planning: map the whole listing window in ONE
            # batched placement pass (OSDMap.map_objects_batch →
            # prime_pgs → batch_do_rule) instead of a scalar descent
            # per object.  Misplaced names (objects whose CURRENT map
            # places them in another pg — locator-key writes hash
            # independently of the name) are only counted: they still
            # get pulled below, never dropped.
            if names:
                for _name, (pg, _act, _prim) in zip(
                        names, self.osd.place_objects(
                            self.pgid.pool, names)):
                    if pg != my_pg:
                        misplaced += 1
            # drop local objects inside this window's span the auth
            # peer doesn't have (peer-only objects must not survive);
            # `local` is sorted — bisect the span instead of rescanning
            # the whole list per window
            import bisect
            span_end = names[-1] if truncated and names else LB_MAX
            have = set(names)
            lo = bisect.bisect_right(local, after)
            hi = bisect.bisect_right(local, span_end)
            txn = Transaction()
            for n in local[lo:hi]:
                if n not in have:
                    txn.remove(self.cid, self.object_id(n))
            self.osd.store.apply_transaction(txn)
            for oid in names:
                if epoch != self.interval_epoch:
                    return  # superseded; the cursor survives for resume
                if oid <= resume_from and oid not in changed:
                    continue  # fresh from the previous attempt
                await self.backend.pull_object(peer, oid, epoch)
                pulled += 1
                if oid > self.info.last_backfill:
                    self.info.last_backfill = oid
                    if pulled % 16 == 0:  # bound meta-write amplification
                        t = Transaction()
                        self.save_meta(t)
                        self.osd.store.apply_transaction(t)
            if not truncated or not names:
                break
            after = names[-1]
        self.missing = MissingSet()
        self.info.last_backfill = LB_MAX
        self.info.last_complete = self.info.last_update
        txn = Transaction()
        self.save_meta(txn)
        self.osd.store.apply_transaction(txn)
        self.log_.info(f"{self.pgid}: self-resync complete "
                       f"({pulled}/{total} objects pulled"
                       + (f", {misplaced} misplaced under current map"
                          if misplaced else "") + ")")

    async def _fetch_list_window(self, peer: int, epoch: int,
                                 after: str, limit: int):
        """One bounded listing window from the auth peer."""
        fut = asyncio.get_running_loop().create_future()
        self._list_waiters[peer] = (fut, after)
        peer_shard = self._probe_shards.get(peer, self.shard_of(peer))
        req = MPGLogRequest(
            self.pgid.with_shard(peer_shard), epoch,
            EVersion.zero(), self.osd.whoami, want_list=True)
        req.list_after = after
        req.list_max = limit
        self.osd.send_osd(peer, req)
        try:
            return await asyncio.wait_for(fut, 15.0)
        finally:
            self._list_waiters.pop(peer, None)

    async def pull_object_via_push(self, peer: int, oid: str,
                                   epoch: int) -> None:
        """Whole-object pull: ask peer to push its copy (replicated)."""
        fut = asyncio.get_running_loop().create_future()
        self._pull_waiters[oid] = fut
        peer_shard = self._probe_shards.get(peer, self.shard_of(peer))
        self.osd.send_osd(peer, MPGLogRequest(
            self.pgid.with_shard(peer_shard), epoch,
            EVersion.zero(), self.osd.whoami, want_object=oid))
        try:
            await asyncio.wait_for(fut, 15.0)
        finally:
            self._pull_waiters.pop(oid, None)

    def _peer_in_sync(self, pi: PGInfo) -> bool:
        """Can this copy be trusted to serve after a log catch-up?"""
        peer_from = min(pi.last_update, pi.last_complete)
        return ((pi.is_empty() and self.info.is_empty())
                or (not pi.is_empty() and pi.backfill_complete
                    and self.log.can_catch_up_from(peer_from)))

    def _want_pg_temp(self) -> Optional[List[int]]:
        """pg_temp gate (PG::choose_acting -> queue_want_pg_temp): when
        an ACTING member needs a full backfill but a COMPLETE copy of
        its position exists on a probed stray, the complete holder
        should keep serving (as acting via pg_temp) while the new
        member backfills as an up-only target.  Returns the desired
        acting list, or None when no substitution helps."""
        m = self.osd.osdmap
        want = list(self.acting)
        changed = False
        for pos, p in enumerate(self.acting):
            if p == self.osd.whoami or p < 0 or p == CRUSH_ITEM_NONE:
                continue
            pi = self.peer_info.get(p)
            if pi is None or self._peer_in_sync(pi):
                continue
            for s, shard in self._probe_shards.items():
                if s in want or not m.is_up(s):
                    continue
                if self.pool.is_erasure() and shard != pos:
                    continue
                spi = self.peer_info.get(s)
                if spi is not None and self._peer_in_sync(spi):
                    want[pos] = s
                    changed = True
                    break
        return want if changed else None

    async def _activate(self, epoch: int) -> None:
        """Ship logs to peers, compute their missing sets, go active."""
        me = self.osd.whoami
        self._backfilling.clear()
        want = self._want_pg_temp()
        if want is not None \
                and self.osd.osdmap.pg_temp.get(
                    self.pgid.without_shard()) != want:
            # keep complete copies serving while the newcomers backfill:
            # ask the mon for pg_temp and re-peer under the new mapping
            self.log_.info(
                f"{self.pgid} requesting pg_temp {want} (backfill gate)")
            self.send_pg_temp(want)
            # do NOT activate the degraded set; the map change restarts
            # peering.  If the mon proposal is lost, retry via timeout
            await asyncio.sleep(2.0)
            if epoch == self.interval_epoch:
                self._peering_task = \
                    asyncio.get_running_loop().create_task(self._peer())
            return
        for p, pi in self.peer_info.items():
            if p not in self.acting and p not in self.up:
                continue
            pm = MissingSet()
            # a peer is in sync if it is empty along with us (initial
            # activation), or backfill-complete and within the log
            # window measured from its last_COMPLETE cursor (a copy that
            # adopted a log without the recovery pushes reports
            # last_complete < last_update; those objects get re-pushed)
            peer_from = min(pi.last_update, pi.last_complete)
            full_resync = not self._peer_in_sync(pi)
            backfill_from = ""
            if not full_resync:
                for oid, e in self.log.objects_since(peer_from).items():
                    if not e.is_delete():
                        pm.add(oid, e.version)
            else:
                # too far behind: backfill (reference Backfill role).
                # A peer with a partial last_backfill cursor whose log
                # position is still inside our window RESUMES: objects
                # <= its cursor need only the log-window deltas, names
                # beyond the cursor get the full scan-order push
                # (PG.h:1911 last_backfill semantics).  Otherwise the
                # peer drops everything and every object re-pushes, so
                # deletions beyond the log window can't resurrect
                # (reference backfill scans both sides).
                if (pi.last_backfill and pi.last_backfill != LB_MAX
                        and self.log.can_catch_up_from(peer_from)):
                    backfill_from = pi.last_backfill
                    rec = self.peer_backfill_cursors.get(p)
                    if rec is not None and rec < backfill_from:
                        # OUR durable record of what we saw acked caps
                        # how much of the target's claimed cursor the
                        # resume trusts (a half-copy must never be
                        # taken on faith); resuming lower only
                        # re-pushes names the target already holds
                        backfill_from = rec
                        pi.last_backfill = rec
                    for oid, e in self.log.objects_since(
                            peer_from).items():
                        if not e.is_delete() \
                                and oid <= backfill_from:
                            pm.add(oid, e.version)
                for soid in self.osd.store.collection_list(self.cid):
                    if soid.name != self.meta_oid.name \
                            and soid.name > backfill_from:
                        pm.add(soid.name, self.info.last_update)
                self._backfilling.add(p)
                # OUR view of the target's cursor is the cursor we just
                # assigned it.  Without this a FRESH target's queried
                # info (default last_backfill == LB_MAX) leaks into the
                # push floor: the first push would stamp
                # backfill_progress = LB_MAX and one ack marks the
                # target fully backfilled — reopening the exact
                # ENOENT-for-a-backfill-hole window the cursor closes
                pi.last_backfill = backfill_from
            self.peer_missing[p] = pm
            msg = MPGLog(
                self.pgid.with_shard(self.shard_of(p)), epoch,
                self.info, self.log, me,
                activate=True, full_resync=full_resync)
            msg.backfill_from = backfill_from
            self.osd.send_osd(p, msg)
        if epoch != self.interval_epoch:
            return   # superseded meanwhile
        if not self.info.backfill_complete:
            # our own copy is mid-resync and no complete peer was
            # reachable: serving would return ENOENT for objects we
            # simply don't have yet — stay peering and retry
            self.log_.warning(f"{self.pgid}: incomplete local copy, no "
                              f"complete peer; retrying peering")
            await asyncio.sleep(1.0)
            if epoch == self.interval_epoch:
                self._peering_task = asyncio.get_running_loop().create_task(
                    self._peer())
            return
        self.info.last_epoch_started = epoch
        self.state = STATE_ACTIVE
        self._active_event.set()
        txn = Transaction()
        self.save_meta(txn)
        self.osd.store.apply_transaction(txn)
        self.osd.note_pg_active(self)
        self.log_.info(f"{self.describe()} (activated "
                       f"{len(self.peer_info)} peers)")
        # background recovery of peer missing objects; must also run when
        # a backfilling peer has nothing to pull so its backfill_done
        # confirmation still goes out
        if any(self.peer_missing.values()) or self._backfilling:
            asyncio.get_running_loop().create_task(self._recover(epoch))
        else:
            self._on_clean(epoch)

    async def _recover(self, epoch: int) -> None:
        """Push missing objects to peers (ReplicatedPG recovery WQ /
        ECBackend::continue_recovery_op role).  Failures RETRY with
        backoff while the interval holds — a recovery task that gives up
        leaves backfilling peers incomplete forever, and nothing else
        would ever restart it (qa/rados_model seed 101 wedge).

        Objects go out in sorted-name WINDOWS pushed concurrently
        (bounded by the OSD-wide recovery budget,
        osd_recovery_max_active), so an EC rebuild decodes a whole
        window as a few batched device launches instead of one host
        decode per object.  Every push in a window stamps the cursor
        FLOOR — the last name known fully landed before the window —
        so an out-of-order ack can never advance the target's durable
        last_backfill over a sibling push still in flight; the floor
        advances only when the whole window acked.  An interval change
        abandons this task (a fresh activation starts a fresh one), so
        the backoff is implicitly reset per interval; within one
        interval it also resets whenever a retry round makes progress."""
        from ceph_tpu_torch.common.backoff import Backoff
        bo = Backoff("pg_recovery", base=0.5, cap=5.0,
                     perf=getattr(self.osd, "perf_recovery", None))
        window_max = max(1,
                         int(self.osd.cfg["osd_recovery_max_active"]))
        recovery_sleep = float(self.osd.cfg["osd_recovery_sleep"])
        while epoch == self.interval_epoch:
            progressed = False
            self.osd.note_cursor_lag(self.pgid, sum(
                len(pm.items) for pr, pm in self.peer_missing.items()
                if pr in self._backfilling))
            try:
                for p, pm in list(self.peer_missing.items()):
                    backfilling = p in self._backfilling
                    pending = sorted(pm.items)
                    while pending:
                        if epoch != self.interval_epoch:
                            return
                        window = pending[:window_max]
                        pending = pending[window_max:]
                        # prime batched CRUSH placement for the whole
                        # window in one kernel launch: the
                        # rebuild plane consumes backfill windows, not
                        # single names
                        try:
                            self.osd.place_objects(self.pool_id, window)
                        except Exception as e:
                            if self.osd.device.type == "cuda":
                                # a failed launch on the card is seen,
                                # not absorbed by the scalar path
                                self.osd.logger.error(
                                    f"pg {self.pgid}: batched placement "
                                    f"failed: {e!r}")
                        if recovery_sleep > 0:
                            # osd_recovery_sleep: explicit inter-window
                            # pause yielding the loop (and the store /
                            # messenger seams) to client ops — the
                            # graceful-degradation knob bench.py's
                            # recovery axis measures on vs off
                            await asyncio.sleep(recovery_sleep)
                        pi = self.peer_info.get(p)
                        floor = pi.last_backfill \
                            if backfilling and pi is not None else ""
                        done, err = await self.backend.recover_objects(
                            p, window,
                            progress=floor if backfilling else "")
                        for oid in done:
                            pm.items.pop(oid, None)
                        if done:
                            progressed = True
                        if err is not None:
                            raise err
                        if epoch != self.interval_epoch:
                            return
                        if backfilling and window:
                            # whole window acked: everything <= its
                            # last name landed — advance the floor and
                            # our durable per-target record
                            new_floor = window[-1]
                            if pi is not None \
                                    and new_floor > pi.last_backfill:
                                pi.last_backfill = new_floor
                            if new_floor > self.peer_backfill_cursors \
                                    .get(p, ""):
                                self.peer_backfill_cursors[p] = \
                                    new_floor
                                txn = Transaction()
                                self.save_meta(txn)
                                self.osd.store.apply_transaction(txn)
                    if p in self._backfilling and not pm.items \
                            and epoch == self.interval_epoch:
                        # every object pushed: the peer may now trust
                        # its copy
                        self._backfilling.discard(p)
                        self.peer_backfill_cursors.pop(p, None)
                        if p in self.peer_info:
                            self.peer_info[p].backfill_complete = True
                        self.osd.send_osd(p, MPGLog(
                            self.pgid.with_shard(self.shard_of(p)),
                            epoch, self.info, self.log,
                            self.osd.whoami,
                            activate=True, backfill_done=True))
                self.log_.debug(f"{self.pgid} recovery complete")
                self.osd.note_cursor_lag(self.pgid, 0)
                if epoch == self.interval_epoch:
                    self._on_clean(epoch)
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # storms must be visible in `perf dump --cluster`, not
                # only in warn logs (osd.recovery_retries +
                # osd.recovery backoff census)
                perf = getattr(self.osd, "perf_osd", None)
                if perf is not None:
                    perf.inc("recovery_retries")
                if progressed:
                    bo.reset()         # the round moved work
                self.log_.warning(
                    f"{self.pgid} recovery error ({e}); retrying in "
                    f"{bo.next_delay():.1f}s")
                await bo.sleep()

    def _on_clean(self, epoch: int) -> None:
        """Every copy caught up: past-interval history is no longer
        needed (PG::mark_clean trims past_intervals) and strays that
        served the PriorSet may delete their copies (the reference's
        MOSDPGRemove after clean)."""
        from ceph_tpu_torch.osd.messages import MPGRemove
        self.past_intervals = []
        txn = Transaction()
        self.save_meta(txn)
        self.osd.store.apply_transaction(txn)
        if self.osd.osdmap.pg_temp.get(self.pgid.without_shard()):
            # every copy caught up: hand serving back to the CRUSH
            # acting set (clear_want_pg_temp)
            self.log_.info(f"{self.pgid} clearing pg_temp (clean)")
            self.send_pg_temp([])
        for p in self._strays:
            # send regardless of up state: send_osd drops unreachable
            # targets, and a stray that misses this gets mopped up when
            # its next notify reaches an active clean primary
            shard = self._probe_shards.get(p, NO_SHARD)
            self.osd.send_osd(p, MPGRemove(
                self.pgid.with_shard(shard), epoch, self.osd.whoami))
        self._strays = set()
        # role-change leftover on OUR OWN osd: after an EC shard move
        # (e.g. s2 -> s0) the old-shard instance is a stray as well,
        # but _strays tracks osd IDS and we are in acting, so it never
        # lists ourselves.  Mop it up by registry key, inline — both
        # instances live on this PG's home shard
        for spgid in [k for k in list(self.osd.pgs)
                      if k.without_shard() == self.pgid.without_shard()
                      and k.shard != self.pgid.shard]:
            self.osd._pg_remove(MPGRemove(
                spgid, epoch, self.osd.whoami))

    async def _recover_object_everywhere(self, oid: str) -> None:
        # snapshot: re-peering may mutate peer_missing across the awaits
        for p, pm in list(self.peer_missing.items()):
            if oid in pm:
                await self.backend.recover_object(p, oid)
                pm.items.pop(oid, None)

    # --------------------------------------------- peering message handlers
    def on_query(self, m: MPGQuery) -> None:
        self.osd.send_osd(m.from_osd, MPGNotify(
            m.pgid, m.epoch, self.info, self.osd.whoami))

    def on_notify(self, m: MPGNotify) -> None:
        fut = self._notify_waiters.get(m.from_osd)
        if fut is not None and not fut.done():
            if m.epoch != self.interval_epoch:
                # the answer to a query of an earlier peering round
                # (the reference drops peering messages older than the
                # last peering reset): after an EC shard move it
                # describes the peer's copy of its OLD shard, and taken
                # for the new one it leaves that copy unfilled
                return
            fut.set_result(m.info())
            return
        if (self.state == STATE_ACTIVE and self.is_primary()
                and m.from_osd not in self.acting
                and m.from_osd not in self.up
                and not self._backfilling
                and not any(pm.items
                            for pm in self.peer_missing.values())):
            # unsolicited notify from a non-member while clean: a stray
            # that missed its MPGRemove (down at clean time) — mop it up
            from ceph_tpu_torch.osd.messages import MPGRemove
            self.osd.send_osd(m.from_osd, MPGRemove(
                m.pgid, self.interval_epoch, self.osd.whoami))

    def on_log_request(self, m: MPGLogRequest) -> None:
        if m.want_list:
            names = sorted(
                soid.name
                for soid in self.osd.store.collection_list(self.cid)
                if soid.name != self.meta_oid.name
                and soid.name > m.list_after)
            limit = m.list_max or len(names)
            truncated = len(names) > limit
            self.osd.send_osd(m.from_osd, MPGObjectList(
                m.pgid, names[:limit], self.osd.whoami,
                truncated=truncated, after=m.list_after))
            return
        if m.want_object:
            self.backend.push_object(m.from_osd, m.want_object,
                                     self.info.last_update)
            return
        self.osd.send_osd(m.from_osd, MPGLog(
            m.pgid, m.epoch, self.info, self.log,
            self.osd.whoami, activate=False))

    def on_pg_log(self, m: MPGLog) -> None:
        if m.activate and m.epoch < self.info.same_interval_since:
            # stale activation (found by the schedule explorer / rule
            # EPOCH10): a primary of a CLOSED interval activating us
            # after we already advanced to a newer interval would
            # clobber info/log state the new interval's peering owns.
            # Drop it; the live primary re-activates under its epoch.
            return
        if m.activate:
            # primary activated us: adopt info/log (replica path).
            # m.log()/m.info() are OUR mutable copies (copy discipline:
            # we adopt-and-append; the sender's snapshot stays frozen)
            since = self.info.last_update
            new_log = m.log()
            txn = Transaction()
            if m.full_resync:
                # drop what the primary will re-push: everything beyond
                # the resume cursor.  Names <= the cursor were pushed by
                # an earlier attempt and only need the log-window
                # deltas (deletes/overwrites) the primary recovers via
                # peer_missing — apply the deletes here so peer-only
                # objects can't survive under the cursor either
                cursor = m.backfill_from
                for soid in self.osd.store.collection_list(self.cid):
                    if soid.name != self.meta_oid.name \
                            and soid.name > cursor:
                        txn.remove(self.cid, soid)
                if cursor:
                    scan_from = min(since, self.info.last_complete)
                    if not new_log.can_catch_up_from(scan_from):
                        scan_from = since
                    for oid, e in new_log.objects_since(
                            scan_from).items():
                        if e.is_delete() and oid <= cursor:
                            txn.remove(self.cid, self.object_id(oid))
            else:
                # apply log-window deletions: adopting the log alone
                # would leave the object bytes in our store; for the
                # rest, record what we DON'T have — adopting the
                # primary's last_update while objects are still absent
                # must not masquerade as completeness, or a primary
                # failover before its recovery pushes land makes the
                # gap permanent (found by qa/rados_model, EC pool).
                # Scan from the honest cursor (covers gaps recorded by
                # PREVIOUS activations, merged not reset) and compare
                # stored VERSIONS, not mere existence — a stale copy of
                # an overwritten object is just as missing
                from ceph_tpu_torch.osd.backend import VERSION_XATTR
                scan_from = min(since, self.info.last_complete)
                if not new_log.can_catch_up_from(scan_from):
                    scan_from = since
                for oid, e in new_log.objects_since(scan_from).items():
                    if e.is_delete():
                        txn.remove(self.cid, self.object_id(oid))
                        self.missing.items.pop(oid, None)
                        continue
                    soid_o = self.object_id(oid)
                    try:
                        have_v = EVersion.from_bytes(
                            self.osd.store.getattr(self.cid, soid_o,
                                                   VERSION_XATTR))
                    except Exception:
                        have_v = None
                    if have_v is not None and not (have_v < e.version):
                        self.missing.items.pop(oid, None)
                    else:
                        self.missing.add(oid, e.version)
            prev_lb = self.info.last_backfill
            prev_lc = min(since, self.info.last_complete)
            self.info = m.info()
            self.info.pgid = self.pgid
            if self.missing and not m.full_resync:
                self.info.last_complete = since   # honest cursor
            # the adopted info carries the PRIMARY's backfill state; ours
            # is: mid-resync until the primary confirms every push
            # landed — resuming from the agreed cursor (never reuse the
            # primary's, and never regress a partial cursor to "")
            if m.full_resync:
                self.info.last_backfill = m.backfill_from
                if m.backfill_from:
                    # cursor-resumed: the under-cursor delta pushes are
                    # still owed — keep last_complete clamped at the
                    # pre-adoption position so a crash before they land
                    # re-exposes the (prev_lc, lu] window to the next
                    # primary instead of reading as fully caught up
                    self.info.last_complete = prev_lc
            elif m.backfill_done:
                self.info.backfill_complete = True
                self.info.last_complete = self.info.last_update
            else:
                self.info.last_backfill = prev_lb
            self.log = new_log
            self.reqids = self.log.reqids()
            self.state = STATE_ACTIVE
            self._active_event.set()
            self.save_meta(txn)
            self.osd.store.apply_transaction(txn)
            self.log_.debug(f"{self.pgid} activated by osd.{m.from_osd}"
                            + (" (full resync)" if m.full_resync else ""))
            # what overtook the activation applies now, on top of it
            held, self._held_sub_writes = self._held_sub_writes, []
            for sub in held:
                self.osd._dispatch_pg_msg(sub)
        else:
            fut = self._log_waiters.get(m.from_osd)
            if fut is not None and not fut.done():
                fut.set_result((m.info(), m.log()))

    # pushes carry no interval epoch: staleness is arbitrated
    # per-object by log VERSION in apply_push (never install below what
    # we already applied), and the ack rides the commit callback
    # lint: allow[EPOCH10] per-object version arbitration (apply_push)
    def on_push(self, m: MPGPush) -> None:
        def _ack():
            # the ack (and any local pull waiter) fires from the store
            # commit callback: a push is only acknowledged once the
            # installed object — and the backfill cursor riding the
            # same txn — is durable
            self.osd.send_osd(m.from_osd, MPGPushReply(
                m.pgid, m.oid, self.osd.whoami))
            fut = self._pull_waiters.get(m.oid)
            if fut is not None and not fut.done():
                fut.set_result(True)

        if not self.backend.apply_push(m, on_commit=_ack):
            _ack()   # rejected push: nothing queued, ack immediately

    def on_object_list(self, m: MPGObjectList) -> None:
        ent = self._list_waiters.get(m.from_osd)
        if ent is None:
            return
        fut, want_after = ent
        if m.after != want_after:
            return   # stale window from a superseded attempt: drop
        if not fut.done():
            fut.set_result((list(m.names), m.truncated))

    def on_push_reply(self, m: MPGPushReply) -> None:
        fut = self._push_acks.get((m.from_osd, m.oid))
        if fut is not None and not fut.done():
            fut.set_result(True)

    # ------------------------------------------------------------- op path
    # ------------------------------------------------------ cache tiering
    @property
    def hitset(self):
        if self._hitset is None:
            from ceph_tpu_torch.osd.hitset import HitSetTracker
            p = self.pool
            self._hitset = HitSetTracker(p.hit_set_count,
                                         fpp=p.hit_set_fpp)
            import time as _time
            self._hitset_rotated = _time.monotonic()
        return self._hitset

    @property
    def perf_tier(self):
        if self._perf_tier is None:
            self._perf_tier = self.osd.ctx.perf.create(
                f"tier_{self.pgid}")
            for k in ("promotes", "promote_bytes", "flushes",
                      "flush_bytes", "evicts"):
                self._perf_tier.add_u64(k)
        return self._perf_tier

    async def _hitset_tick(self) -> None:
        """Rotate on period; the sealed set PERSISTS as a replicated
        internal object (_hitset_<n>) so a failover primary inherits
        the recency window (ReplicatedPG::hit_set_persist)."""
        import time as _time
        now = _time.monotonic()
        if now - self._hitset_rotated < self.pool.hit_set_period:
            return
        if self._hitset_persisting:
            return   # a concurrent windowed op is already rotating
        self._hitset_persisting = True
        sealed = self.hitset.current
        self.hitset.rotate()
        self._hitset_rotated = now
        from ceph_tpu_torch.osd import tiering
        from ceph_tpu_torch.osd.messages import OP_DELETE, OP_WRITEFULL, OSDOp
        self._hitset_seq += 1
        try:
            await tiering.internal_write(
                self, f"_hitset_{self._hitset_seq:016x}",
                [OSDOp(OP_WRITEFULL, data=sealed.to_bytes())])
            old = self._hitset_seq - (self.pool.hit_set_count - 1)
            if old > 0:
                await tiering.internal_write(
                    self, f"_hitset_{old:016x}", [OSDOp(OP_DELETE)])
        except Exception:
            self.log_.exception(f"{self.pgid} hitset persist failed")
        finally:
            self._hitset_persisting = False

    async def _load_hitsets(self) -> None:
        """New primary: adopt the persisted hit-set window
        (ReplicatedPG::hit_set_setup)."""
        self._hitsets_loaded = True
        from ceph_tpu_torch.osd.hitset import BloomHitSet
        try:
            names = sorted(
                (o.name for o in self.osd.store.collection_list(self.cid)
                 if o.is_head() and o.name.startswith("_hitset_")),
                reverse=True)
        except Exception:
            return
        hs = self.hitset
        for name in names[:hs.count - 1]:
            try:
                blob = self.osd.store.read(self.cid,
                                           self.object_id(name))
                hs.archive.append(BloomHitSet.from_bytes(blob))
                self._hitset_seq = max(self._hitset_seq,
                                       int(name.rsplit("_", 1)[1], 16))
            except Exception:
                pass

    async def _maybe_handle_cache(self, m: MOSDOp) -> None:
        """ReplicatedPG::maybe_handle_cache distilled: record the hit,
        rotate hit sets on period, promote on miss (writeback)."""
        from ceph_tpu_torch.osd import tiering
        if not m.oid or m.oid.startswith("_hitset_"):
            return              # pool-level op / internal object
        if not self._hitsets_loaded:
            await self._load_hitsets()
        await self._hitset_tick()
        self.hitset.insert(m.oid)
        if self.pool.cache_mode == "writeback":
            await tiering.maybe_promote(self, m)

    def queue_op(self, m) -> None:
        from ceph_tpu_torch.osd.messages import (MPGPush, MPGScrub,
                                           MPGScrubScan)
        if callable(m):
            klass = "agent"
        elif isinstance(m, (MPGScrub, MPGScrubScan)):
            klass = "scrub"
        elif isinstance(m, MPGPush):
            # recovery admission rides the queue only under the QoS
            # scheduler (daemon routes pushes here when QOS), where
            # scrub/agent/recovery all fold into the 'background'
            # dmClock class — one policy knob for the rebuild-rate vs
            # client-p99 tradeoff.  osd_recovery_max_active stays the
            # hard cap on the PRIMARY's push window (recovery_budget)
            klass = "recovery"
        elif self._op_queue.QOS and isinstance(m, MOSDOp) \
                and m.qos_class:
            # dmClock: the client class rides the MOSDOp envelope
            # (wpq must never see these tags: an unknown class would
            # auto-register at weight 1 and change wpq scheduling)
            klass = m.qos_class
        else:
            # MOSDOp AND replica sub-ops: replica work carries the
            # client's priority (a deprioritized sub-op would stall the
            # primary awaiting its ack)
            klass = "client"
        self._op_queue.put_nowait(m, klass)

    def _is_barrier_op(self, m: MOSDOp) -> bool:
        """Whole-PG dependency class: ops that read or mutate PG-scope
        state and must not interleave with per-object ops — pool-scope
        ops carry no object id (PGLS listings and friends); everything
        object-addressed is covered by the per-object chains (cls write
        methods stage onto their own object only in this codebase)."""
        return not m.oid

    async def _worker(self) -> None:
        """The single ADMITTER (ShardedOpWQ role): dequeues in FIFO
        order and feeds the dependency-tracked window (osd/sequencer.py)
        — client ops on disjoint objects run concurrently as their own
        tasks, same-object ops chain in queue order, barrier-class work
        (scrub, agent passes, pool-scope ops) drains the window and
        runs alone.  Replica sub-ops stay inline on the worker: their
        apply path has no awaits before queue_transactions, so they
        pipeline through the commit thread already and their arrival
        order (== the primary's pglog submission order) is preserved."""
        from ceph_tpu_torch.osd.messages import MPGScrub, MPGScrubScan
        from ceph_tpu_torch.osd import scrub as scrub_mod
        seq = self.op_window
        while True:
            m = await self._op_queue.get()
            self._worker_busy = True
            try:
                if callable(m):
                    # internal work item (tier agent pass): iterates
                    # PG objects — whole-PG barrier class
                    await seq.drain()
                    await m()
                elif isinstance(m, MOSDOp):
                    if self._is_barrier_op(m) \
                            or self.state != STATE_ACTIVE:
                        # barrier class — and any op arriving while
                        # not active runs INLINE (window empty): its
                        # wait-for-active must park the admission
                        # queue, never occupy a window slot peering's
                        # drain would then deadlock against
                        if m._span is not None:
                            m._span.cut("queue_wait_pump",
                                        self.osd.ctx.tracer.hist)
                        await seq.drain()
                        await self._do_client_op(m)
                    else:
                        await seq.wait_slot(m._span)
                        # dependency registration is SYNCHRONOUS at
                        # admission (per-object order == queue order);
                        # machine-checked by devtools rule AF01
                        # awaitfree:begin window-admission
                        m._windowed = True
                        # writeback-tier reads are admitted EXCLUSIVE:
                        # a cache miss promotes (an internal WRITE of
                        # the object) — two shared readers of the same
                        # cold object would otherwise race duplicate
                        # promotes outside the per-object chain
                        write = any(o.is_write() for o in m.ops) or (
                            self.pool.is_tier()
                            and self.pool.cache_mode == "writeback")
                        slot = seq.admit(m.oid, write)
                        task = asyncio.get_running_loop().create_task(
                            self._run_windowed(m, slot))
                        self._window_tasks[task] = m
                        task.add_done_callback(
                            lambda t: self._window_tasks.pop(t, None))
                        # awaitfree:end window-admission
                elif isinstance(m, MPGScrub):
                    # scrub drains the window: no client op can
                    # interleave with the scan (reference write
                    # blocking).  Stamps advance only when the scrub
                    # really ran — a drop (re-peering) leaves the PG
                    # due for retry.
                    await seq.drain()
                    try:
                        if self.is_primary() and \
                                self.state == STATE_ACTIVE:
                            self.last_scrub_result = \
                                await scrub_mod.scrub_pg(
                                    self, m.deep, m.repair)
                    finally:
                        self._scrub_queued = False
                elif isinstance(m, MPGScrubScan):
                    scrub_mod.handle_scrub_scan(self, m)
                elif isinstance(m, MPGPush):
                    # QoS-admitted recovery push (background class):
                    # apply + ack exactly as the direct path — the
                    # queue only decided WHEN it runs relative to
                    # client work
                    self.on_push(m)
                else:
                    await self.backend.handle_sub_message(m)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.log_.exception(f"{self.pgid} op failed: {m}")
            finally:
                self._worker_busy = False

    def awaits_activation(self) -> bool:
        """A replica its primary has not activated in this interval."""
        return not self.is_primary() and self.state != STATE_ACTIVE

    def hold_until_active(self, m) -> None:
        """Keep a write sub-op that was handed over in process (mesh
        mode) until the primary's activation arrives: on the messenger
        it would have come after the activation the primary sent first,
        and applied before it, its log entry is replaced by the
        activation's log (the bytes stay, the entry is lost, and a
        later primary never recovers the object)."""
        self._held_sub_writes.append(m)

    def _drop_held_sub_writes(self) -> None:
        from ceph_tpu_torch.osd import extents
        held, self._held_sub_writes = self._held_sub_writes, []
        for m in held:
            extents.release_message(m)

    def try_fast_sub_write(self, m) -> bool:
        """Sharded-plane inline path for replica WRITE sub-ops: apply
        straight from the classify seam, skipping the op-queue put +
        worker wakeup.  Legal only while nothing could be ordered
        ahead of this message — the op queue is empty and the worker
        is idle (not mid-item, e.g. a scrub scan that must serialize
        against sub-op application); the backend apply itself is
        synchronous by contract (backend.sub_write_fast)."""
        if self._worker_busy or not self._op_queue.empty():
            return False
        return self.backend.sub_write_fast(m)

    async def _run_windowed(self, m: MOSDOp, slot) -> None:
        """One admitted client op: wait out its object-dependency
        chain, execute, release the slot (always — a failed op must
        never wedge its successors)."""
        try:
            await slot.wait()
            if m._span is not None:
                m._span.cut("dep_wait", self.osd.ctx.tracer.hist)
            await self._do_client_op(m)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.log_.exception(f"{self.pgid} op failed: {m}")
        finally:
            self.op_window.release(slot)

    def _finish_client_op(self, m: MOSDOp) -> None:
        """Release one client op's OSD-wide accounting — OpTracker
        entry + messenger dispatch-throttle budget.  IDEMPOTENT
        (_tracked nulled, throttle_cost zeroed inside the messenger):
        both the op's own finally and PG.stop()'s cancellation sweep
        may call it for the same op."""
        tracked = getattr(m, "_tracked", None)
        if tracked is not None:
            m._tracked = None
            self.osd.op_tracker.finish(tracked)
        self.osd.messenger.put_dispatch_throttle(m)

    async def _do_client_op(self, m: MOSDOp) -> None:
        """ReplicatedPG::do_op/execute_ctx distilled."""
        tracked = getattr(m, "_tracked", None)
        if tracked is not None:
            tracked.mark("reached_pg")
        try:
            await self._do_client_op_inner(m)
        finally:
            # op done: release tracker + intake budget (backpressure)
            self._finish_client_op(m)

    async def _do_client_op_inner(self, m: MOSDOp) -> None:
        if not self.is_primary():
            # stale client mapping: tell it to refresh + resend
            self.osd.reply_to(m, MOSDOpReply(
                m.tid, -errno.EAGAIN, map_epoch=self.osd.osdmap.epoch))
            return
        if self.state != STATE_ACTIVE:
            if getattr(m, "_windowed", False):
                # admitted while active, interval changed before we
                # ran: abort NOW.  Parking here would hold a window
                # slot peering's drain is waiting on (circular wait);
                # the client resends against the new mapping anyway
                self.osd.reply_to(m, MOSDOpReply(
                    m.tid, -errno.EAGAIN, map_epoch=self.osd.osdmap.epoch))
                return
            try:
                await asyncio.wait_for(self._active_event.wait(), 30.0)
            except asyncio.TimeoutError:
                self.osd.reply_to(m, MOSDOpReply(
                    m.tid, -errno.EAGAIN, map_epoch=self.osd.osdmap.epoch))
                return
        from ceph_tpu_torch.osd.pglog import valid_object_name
        if m.oid and not valid_object_name(m.oid):
            # defense in depth vs a client that skipped the IoCtx check
            # (LB_MAX backfill-cursor sentinel)
            self.osd.reply_to(m, MOSDOpReply(
                m.tid, -errno.EINVAL, map_epoch=self.osd.osdmap.epoch))
            return
        has_write = any(o.is_write() for o in m.ops)
        from ceph_tpu_torch.osd.messages import OP_DELETE
        from ceph_tpu_torch.osd.types import FLAG_FULL_QUOTA
        if has_write and (self.pool.flags & FLAG_FULL_QUOTA) \
                and not any(o.op == OP_DELETE for o in m.ops):
            # pool over quota (mon-flagged): writes fail EDQUOT;
            # deletes still pass so the operator can dig out
            # (ReplicatedPG::do_op pool-full EDQUOT path)
            self.osd.reply_to(m, MOSDOpReply(
                m.tid, -errno.EDQUOT, map_epoch=self.osd.osdmap.epoch))
            return
        if has_write and len(
                [o for o in self.acting if o != CRUSH_ITEM_NONE]) \
                < self.pool.min_size:
            self.osd.reply_to(m, MOSDOpReply(
                m.tid, -errno.EAGAIN, map_epoch=self.osd.osdmap.epoch))
            return
        if has_write and m.reqid and m.reqid in self.reqids:
            # duplicate of an already-applied write (client resend after a
            # map change / lost reply): ack success without re-executing
            self.osd.reply_to(m, MOSDOpReply(
                m.tid, 0, m.ops, self.osd.osdmap.epoch))
            return
        from ceph_tpu_torch.osd.backend import PGIntervalChanged
        try:
            if m.oid in self.missing.items:
                # our OWN copy of this object is still owed a recovery
                # pull (log adopted before data): serving now would
                # return ENOENT for committed data — heal it first
                # (the reference's wait_for_missing_object).  MUST run
                # before any cache promote: a missing dirty cache
                # object looks absent to store.exists and a promote
                # would clobber it with stale base-pool bytes
                src = next((p for p in self.actual_peers()), -1)
                if src >= 0:
                    await self._heal_missing(src, self.interval_epoch)
            elif m.oid and self.info.last_backfill != LB_MAX \
                    and m.oid > self.info.last_backfill:
                # our OWN copy is mid-backfill and this name is past
                # the durable cursor: any local bytes are an untrusted
                # half-copy — pull the authoritative copy first (the
                # block/pull side of the last_backfill read gate; the
                # route-away side is _stale_shards/_gather_once and
                # the replica-side refusal in _handle_ec_sub_read)
                src = next((p for p in self.actual_peers()), -1)
                if src >= 0:
                    try:
                        await self.backend.pull_object(
                            src, m.oid, self.interval_epoch)
                    except Exception as e:
                        # transient (peers down/backfilling): the op
                        # path below already degrades/waits per class
                        self.log_.debug(f"{self.pgid} cursor-gate pull "
                                        f"of {m.oid} failed: {e}")
            if self.pool.is_tier() \
                    and not getattr(m, "_tier_internal", False):
                await self._maybe_handle_cache(m)
            if has_write:
                # recover-before-write: peers must have the current object
                # before a mutation lands on top of it
                await self._recover_object_everywhere(m.oid)
                result = await self.backend.submit_client_write(m)
            else:
                result = await self.backend.do_reads(m)
                if m._span is not None:
                    # reads have no submit/commit cuts: attribute the
                    # whole execution here so the chain stays tiled
                    m._span.cut("op_exec", self.osd.ctx.tracer.hist)
        except PGIntervalChanged:
            result = -errno.EAGAIN
        reply = MOSDOpReply(m.tid, result, m.ops, self.osd.osdmap.epoch)
        if m._span is not None:
            reply.trace_id = m._span.trace_id
            reply.span_id = m._span.span_id
        self.osd.reply_to(m, reply)

    # -------------------------------------------------------- watch/notify
    def handle_watch(self, m, op) -> None:
        """OP_WATCH (op.offset: 1=watch, 0=unwatch) — osd/Watch.h:46.
        Watcher identity is the client entity; deliveries go to its
        messenger address."""
        key = str(m.src_name)
        watchers = self.watches.setdefault(m.oid, {})
        if op.offset:
            watchers[key] = m.src_addr
        else:
            watchers.pop(key, None)
            if not watchers:
                self.watches.pop(m.oid, None)
        op.rval = 0

    async def handle_notify(self, m, op) -> int:
        """OP_NOTIFY: fan op.data out to every watcher, gather acks with
        a timeout (reference Watch.cc notify machinery).  outdata = json
        of acked/missed watcher names."""
        import json
        from ceph_tpu_torch.osd.messages import MWatchNotify
        watchers = dict(self.watches.get(m.oid, {}))
        notify_id = self.osd.next_tid()
        if not watchers:
            op.outdata = json.dumps({"acked": [], "missed": []}).encode()
            return 0
        fut = asyncio.get_running_loop().create_future()
        pending = set(watchers)
        replies: List = []
        self._notify_acks[notify_id] = (pending, fut, replies)
        msg = MWatchNotify(self.pgid, m.oid, notify_id, op.data,
                           self.osd.whoami)
        for key, addr in watchers.items():
            self.osd.messenger.send_message(msg, addr,
                                            peer_type="client")
        timeout = (op.length / 1000.0) if op.length else 5.0
        try:
            await asyncio.wait_for(fut, timeout)
        # lint: allow[RETRY19] notify linger timeout IS the protocol; late watchers reaped below
        except asyncio.TimeoutError:
            pass
        finally:
            pending, _, replies = self._notify_acks.pop(
                notify_id, (set(), None, []))
        # dead-watcher reaping (the watch-timeout role): a watcher that
        # missed this notify is dropped, so it cannot stall the next one
        if pending:
            cur = self.watches.get(m.oid, {})
            for key in pending:
                cur.pop(key, None)
            if not cur:
                self.watches.pop(m.oid, None)
        op.outdata = json.dumps({
            "acked": sorted(set(watchers) - pending),
            "missed": sorted(pending),
            "replies": {k: v.hex() for k, v in replies}}).encode()
        return 0

    def on_notify_ack(self, m) -> None:
        ent = self._notify_acks.get(m.notify_id)
        if ent is None:
            return
        pending, fut, replies = ent
        pending.discard(str(m.src_name))
        if m.reply:
            replies.append((str(m.src_name), m.reply))
        if not pending and not fut.done():
            fut.set_result(True)

    # ---------------------------------------------------------- snap trim
    def maybe_trim_snaps(self) -> None:
        """Deterministic local trim when the map carries removed snaps
        we have not processed (SnapMapper/SnapTrimmer role)."""
        removed = [s for s in self.pool.removed_snaps
                   if s not in self._trimmed_snaps]
        if not removed:
            return
        from ceph_tpu_torch.osd import snaps as snaps_mod
        n = snaps_mod.trim_pg(self, removed)
        self._trimmed_snaps.update(removed)
        if n:
            self.log_.info(f"{self.pgid} snap trim: {n} clones removed "
                           f"for snaps {removed}")

    # ---------------------------------------------------- version plumbing
    def next_version(self) -> EVersion:
        return EVersion(self.osd.osdmap.epoch,
                        self.info.last_update.version + 1)

    def append_log(self, txn: Transaction, entry: LogEntry) -> None:
        """Advance the APPLIED state: log head + last_update move now
        (read-your-writes, next_version monotonicity); last_complete —
        the committed cursor — advances via complete_to from the store
        commit callback, never ahead of durability."""
        self.log.append(entry)
        self.note_reqid(entry)
        self.info.last_update = entry.version
        self.save_meta_log(txn, entry)

    def complete_to(self, version: EVersion) -> None:
        """Store commit callback: the txn carrying this log entry is
        durable — advance last_complete.  Guarded against an interval
        change that rewound the log mid-flight (never past last_update)
        and against a copy still owed recovery pulls (its honest cursor
        must keep exposing the gap)."""
        if not self.missing and self.info.last_complete < version \
                and version <= self.info.last_update:
            self.info.last_complete = version

    def note_reqid(self, entry: LogEntry) -> None:
        if entry.reqid:
            self.reqids[entry.reqid] = entry.version
            if len(self.reqids) > 2 * PGLog.MAX_ENTRIES:
                self.reqids = self.log.reqids()   # rebound to the log

    def object_id(self, oid: str) -> ObjectId:
        return ObjectId(oid, pool=self.pool_id)
