"""Objecter: the RADOS client op engine.

Reference parity: osdc/Objecter.cc — op_submit (:2167) → _calc_target
(:2661, object_locator_to_pg + pg→acting via the SAME placement pipeline
the OSDs run) → _send_op; resend on map change (:1974 handle_osd_map
scan) and on EAGAIN from an OSD that saw a stale mapping.  Linger
(watch) ops are out of scope this round.

The port's copy of ``ceph_tpu.client.objecter``.  The Objecter takes a
``device`` (default ``cuda``; raises without a card): the cork flush
places its batch with the CRUSH descent kernel on a card and with the
host engine on the CPU.
"""

from __future__ import annotations

import asyncio
import errno
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          placement_engine, resolve_device)
from ceph_tpu_torch.common.qos import QOS_CLASS, QosFeedback
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.osd.messages import MOSDOp, MOSDOpBatch, MOSDOpReply, OSDOp
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import ObjectLocator, PGId


class ObjectOperationError(Exception):
    def __init__(self, retcode: int, what: str = ""):
        super().__init__(f"rc={retcode} {what}")
        self.retcode = retcode


class _InFlight:
    __slots__ = ("tid", "oid", "loc", "ops", "fut", "attempts", "snapid",
                 "snapc", "span", "span_sent", "sent", "corked",
                 "qos_class")

    def __init__(self, tid, oid, loc, ops, fut, snapid=0, snapc=None):
        self.tid = tid
        self.oid = oid
        self.loc = loc
        self.ops = ops
        self.fut = fut
        self.attempts = 0
        self.snapid = snapid
        self.snapc = snapc      # (seq, [snapids]) selfmanaged override
        self.span = None        # tracer span (op_tracing only)
        self.span_sent = False  # first-send cut taken (resends skip)
        self.sent = False       # first send left — resends skip the cork
        self.corked = False     # parked in a pending cork (no re-entry)
        self.qos_class = "client"   # dmClock class riding the envelope


class Objecter(Dispatcher):
    def __init__(self, ctx, messenger: Messenger, monc: MonClient,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.ctx = ctx
        #: the device and CRUSH engine of the cork flush's placement
        self.device = resolve_device(device)
        self.crush_engine = placement_engine(self.device)
        #: batched placement calls made by cork flushes; on a card each
        #: is one launch of the CRUSH descent kernel
        self.crush_batches = 0
        self.log = ctx.logger("objecter")
        self.messenger = messenger
        messenger.add_dispatcher(self)
        self.monc = monc
        monc.on_osdmap(self._on_osdmap)
        self._tid = 0
        self._inflight: Dict[int, _InFlight] = {}
        # corked op batching (sharded-data-plane client half): ops
        # submitted within one loop pass park UNTARGETED; the flush
        # batch-computes every corked op's placement in ONE kernel call
        # (OSDMap.prime_pgs), then groups per target OSD into
        # MOSDOpBatch frames — one wire frame, one local-delivery
        # handoff — instead of N per-message hops with N scalar
        # placement descents
        self._batching = bool(ctx.config["objecter_op_batching"])
        self._cork: List[_InFlight] = []
        self.batches_sent = 0       # introspection (bench/tests)
        self.ops_batched = 0
        # dmClock client half (common/qos.py): ops carry a class tag
        # plus (delta, rho) completion feedback so the per-PG queues —
        # many servers from the scheduler's viewpoint — keep aggregate
        # rates equal to the configured spec
        self._default_qos_class = str(
            ctx.config["objecter_qos_class"] or "")
        self._qos = QosFeedback()

    @property
    def osdmap(self) -> Optional[OSDMap]:
        return self.monc.osdmap

    # ------------------------------------------------------------ dispatch
    def ms_dispatch(self, m: Message) -> bool:
        if isinstance(m, MOSDOpReply):
            op = self._inflight.get(m.tid)
            if op is None:
                return True
            if m.result == -errno.EAGAIN:
                # osd saw a stale/foreign mapping: refresh map + resend
                self.monc.sub_want("osdmap",
                                   max(m.map_epoch,
                                       self.osdmap.epoch if self.osdmap
                                       else 0))
                asyncio.get_running_loop().create_task(
                    self._resend_later(op))
                return True
            del self._inflight[m.tid]
            self._qos.note_done(op.qos_class, m.qos_phase)
            if op.span is not None and not op.span.finished:
                # close the trace: the reply transit back is the last
                # chain segment, then op_total (t0 -> now) lands as the
                # aux e2e the coverage guard measures the chain against.
                # A reply that crossed a process-lane ring carries the
                # lane's send stamp (converted to this clock by the
                # parent): rebase the cursor onto it so ack_delivery
                # covers only the reply leg — the skipped window is the
                # lane worker's service time, recorded by the lane's
                # own continuation span (merging would double count)
                tr = self.ctx.tracer
                anchor = getattr(m, "_lane_sent_mono", 0.0)
                if anchor:
                    op.span.rebase(anchor)
                op.span.cut("ack_delivery", tr.hist)
                tr.finish(op.span)
            if not op.fut.done():
                op.fut.set_result(m)
            return True
        return False

    async def _resend_later(self, op: _InFlight) -> None:
        op.attempts += 1
        await asyncio.sleep(min(0.05 * (2 ** min(op.attempts, 6)), 2.0))
        if op.tid in self._inflight and not op.fut.done():
            self._send(op)

    def _on_osdmap(self, osdmap: OSDMap) -> None:
        # reference handle_osd_map: rescan + resend everything in flight
        # whose target may have changed; we simply resend all (idempotent
        # at-most-once completion via tid matching)
        for op in list(self._inflight.values()):
            self._send(op)

    # ------------------------------------------------------------- submit
    def _calc_target(self, oid: str, loc: ObjectLocator
                     ) -> Tuple[PGId, int]:
        m = self.osdmap
        pg, acting, primary = m.object_to_acting(oid, loc)
        return pg, primary

    def _effective_loc(self, loc: ObjectLocator,
                       ops: List[OSDOp]) -> ObjectLocator:
        """Cache-tier overlay redirection (Objecter::_calc_target
        respecting pg_pool_t read_tier/write_tier): ops against a base
        pool with an overlay route to the cache pool transparently."""
        pool = self.osdmap.pools.get(loc.pool)
        if pool is None:
            return loc
        tier = (pool.write_tier if any(o.is_write() for o in ops)
                else pool.read_tier)
        if tier >= 0 and tier in self.osdmap.pools:
            return ObjectLocator(tier, loc.key, loc.namespace,
                                 loc.hash_pos)
        return loc

    def _build_msg(self, op: _InFlight):
        """Target + wire message for one in-flight op against the
        current map; None while the op has no reachable primary."""
        loc = self._effective_loc(op.loc, op.ops)
        pg, primary = self._calc_target(op.oid, loc)
        if primary < 0:
            return None   # no primary yet: next map triggers a resend
        addr = self.osdmap.get_addr(primary)
        if addr is None:
            return None
        reqid = f"{self.messenger.nonce:x}.{op.tid}"
        # snap context rides every write from the CURRENT map's pool
        # snap state (Objecter::_op_submit snapc handling); reads carry
        # the caller's snapid
        pool = self.osdmap.pools.get(loc.pool)
        snap_seq, snaps = 0, []
        if any(o.is_write() for o in op.ops):
            if op.snapc is not None:
                # self-managed snap context (librados
                # selfmanaged_snap_set_write_ctx): the client — librbd
                # analog — owns the per-image snap set
                snap_seq, snaps = op.snapc
            elif pool is not None:
                snap_seq = pool.snap_seq
                snaps = sorted(pool.snaps, reverse=True)
        m = MOSDOp(pg, op.oid, loc, op.ops, op.tid,
                   self.osdmap.epoch, reqid, snap_seq=snap_seq,
                   snaps=snaps, snapid=op.snapid)
        m.qos_class = op.qos_class
        m.qos_delta, m.qos_rho = self._qos.note_sent(op.qos_class,
                                                     primary)
        span = op.span
        if span is not None and not op.span_sent:
            # trace context rides the op: payload fields for the wire,
            # the live span for zero-encode local delivery.  Resends
            # after a map change keep the op's span but take no further
            # client_submit cut (the chain cursor is mid-path by then).
            m.trace_id, m.span_id = span.trace_id, span.span_id
            m._span = span
        return m, addr

    def _send(self, op: _InFlight) -> None:
        if op.corked and not op.sent:
            # a resend (map change racing the cork flush) must not
            # double-enter the pending cork: the already-corked frame
            # will ship; a stale target self-corrects via EAGAIN
            return
        if self._batching and not op.sent:
            # cork: ops submitted within one loop pass park UNTARGETED
            # (no per-op placement descent here) and ship as per-OSD
            # MOSDOpBatch frames from the flush.  The first op arms the
            # flush; flushing happens before any awaited reply can
            # exist, so latency cost is one call_soon hop.  RESENDS
            # (map change / EAGAIN) bypass the cork — they are
            # latency-critical singletons and must not wait out a
            # flush or double-enter a pending cork
            self._cork.append(op)
            op.corked = True
            if len(self._cork) == 1:
                asyncio.get_running_loop().call_soon(self._flush_cork)
            return
        built = self._build_msg(op)
        if built is None:
            return
        m, addr = built
        self.messenger.send_message(m, addr, peer_type="osd")
        self._note_sent(op)

    def _flush_cork(self) -> None:
        pend, self._cork = self._cork, []
        if not pend:
            return
        m = self.osdmap
        if m is not None and len(pend) > 1:
            # device-candidate:crush-placement@landed batch-compute
            # every corked op's placement in ONE ops/crush_kernel.py
            # call (OSDMap.prime_pgs → batch_do_rule, CHUNK_SIZES-
            # bucketed) instead of per-op _calc_target scalar descents
            # — the corked pass is already the N-ops shape the batched
            # kernel wants; _build_msg below then runs on pure
            # _acting_cache hits
            pgs = []
            for op in pend:
                loc = self._effective_loc(op.loc, op.ops)
                if loc.pool in m.pools:
                    pgs.append(m.object_locator_to_pg(op.oid, loc))
            self.crush_batches += m.prime_pgs(pgs, self.crush_engine,
                                              self.device)
        by_addr: Dict[Tuple[str, int], list] = {}
        for op in pend:
            built = self._build_msg(op)
            if built is None:
                # no reachable primary: leave the op for the next map's
                # resend scan (uncork so it can re-enter)
                op.corked = False
                continue
            msg, addr = built
            by_addr.setdefault(addr.without_nonce(),
                               (addr, []))[1].append((msg, op))
        for addr, group in by_addr.values():
            if len(group) == 1:
                msg, op = group[0]
                self.messenger.send_message(msg, addr, peer_type="osd")
                self._note_sent(op)
                continue
            self.messenger.send_message(
                MOSDOpBatch([msg for msg, _o in group]), addr,
                peer_type="osd")
            self.batches_sent += 1
            self.ops_batched += len(group)
            for _msg, op in group:
                self._note_sent(op)

    def _note_sent(self, op: _InFlight) -> None:
        op.sent = True
        op.corked = False
        if op.span is not None and not op.span_sent:
            op.span_sent = True
            op.span.cut("client_submit", self.ctx.tracer.hist)

    async def op_submit(self, oid: str, loc: ObjectLocator,
                        ops: List[OSDOp], timeout: float = 120.0,
                        snapid: int = 0, snapc=None) -> MOSDOpReply:
        # The reference Objecter never deadlines an op — it waits and
        # resends across map changes (Objecter::handle_osd_map). The
        # generous default here only bounds true wedges; first-touch
        # device compiles in a freshly booted OSD can take tens of
        # seconds on a loaded host.
        if self.osdmap is None:
            await self.monc.wait_for_osdmap()
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        op = _InFlight(tid, oid, loc, ops, fut, snapid, snapc)
        # class resolution order: per-task contextvar (multi-tenant
        # gateway) > per-client config default > "client"
        op.qos_class = QOS_CLASS.get() or self._default_qos_class \
            or "client"
        tr = self.ctx.tracer
        if tr.enabled:
            op.span = tr.start("osd_op")
        self._inflight[tid] = op
        self._send(op)
        try:
            reply = await asyncio.wait_for(fut, timeout)
        finally:
            self._inflight.pop(tid, None)
        return reply
