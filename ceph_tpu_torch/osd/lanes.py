"""Process shard lanes: each shard pump in its own interpreter.

On a host bound by the interpreter lock, thread lanes measure below
inline lanes because every lane contends for one interpreter.  This
module is the escape: ``osd_shard_lanes=process`` runs each shard's pump
in a ``multiprocessing`` worker, fed by shared-memory ring frames
(osd/laneipc.py), with every seam-crossing value in a form that
crosses a process edge:

  * work items cross as their byte-identical WIRE encoding (the lazy
    payload discipline's cheap cross-process form) plus a tiny
    transport envelope — no closure, live ref, or loop-bound object
    ever rides a ring;
  * reply futures resolve BY ID: a lane's control calls (mon map
    backfill) carry a u64 id, and the parent's answer frame resolves
    the lane-local future registered under it;
  * courier counters go PER LANE (frames/bytes/wakeups/stalls per
    ring, aggregated by ``ShardedDataPlane.counters``);
  * commit completions are idx-keyed records end to end (the lane
    hosts its own store + kv path; store/commit.py's completion
    records are already process-shaped).

Topology: the parent keeps the daemon scope — the real messenger (one
listening address per OSD), mon session, boot/heartbeats, map store —
and hosts NO PGs.  Each lane worker is a headless sub-OSD (same class)
restricted to the PGs whose ``shard_index`` equals its lane: it owns
their store collections (its own MemStore — volatile, like every
FAST_CFG daemon), runs their peering/op/scrub paths unchanged, and
reaches the world through a ``RingMessenger`` whose every send is a
frame the parent re-sends from its real address.  Inbound, the
parent's intake classifies PG-bound messages straight onto the owning
lane's ring — the same ``_ShardIntake`` seam, with the deque swapped
for shared memory.

Worker lifecycle / crash semantics: workers are SPAWNED (a fork would
inherit dead XLA threadpools and the parent's live event loop); the
parent watches each worker's sentinel and a death outside shutdown
marks the lane dead — subsequent posts and pending id-keyed calls
raise ``LaneDead`` loudly.  A dead lane never phantom-acks: its
in-flight client ops simply never answer, and clients resend after
the mon marks the OSD down (or time out) — exactly a crashed OSD's
contract, scoped to one lane.

Known v1 limits (documented, asserted where cheap): the cache-tier
agent and cephx-authenticated client caps do not run inside lanes;
file-backed stores and ``osd_mesh_mode=on`` are incompatible with
process lanes (the lane store is lane-local by construction).
Scheduled scrub and PG stats reporting DO run lane-side — the lanes
host the PGs, so each worker runs its own scheduler over its slice.

The port's copy of ``ceph_tpu.osd.lanes``; the message and out-frame
envelopes are the JAX package's bytes.  The device crosses the spawn:
the spec carries the parent OSD's ``device`` and the worker builds its
OSD there (a spec without one raises: a worker never picks a device of
its own), so on a card every worker launches the EC batch kernel and the
CRUSH descent itself, from its own CUDA context.  On a card the parent
builds both kernel libraries before it spawns a worker, and a worker
whose build, load or launch fails dies loudly.  A worker also answers
``lane_state``: its pid and device, its OSD's batched CRUSH placements
by call site, each EC batch queue's launches and the two kernel
wrappers' launch counts (these stay in the worker otherwise), its map
epoch, each primary PG's state and whether it is clean (PG state lives
only there), and the messages of the records it logged at ERROR.  A
worker keeps each map it is sent for ``get_map``, primed by its epoch
advance, as the daemon does with the sharded plane: decoded anew from
the store, every epoch an interval walk passes primes every pool again.
"""

from __future__ import annotations

import asyncio
import json
import logging
import multiprocessing
import os
import time
from typing import Dict, List, Optional

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.osd import extents as extents_mod
from ceph_tpu_torch.osd.laneipc import (
    FRAME_BURST, FRAME_BYE, FRAME_EXTFREE, FRAME_MAP, FRAME_MSG,
    FRAME_OUT, FRAME_PING, FRAME_PONG, FRAME_RESP, FRAME_RPC,
    FRAME_STATS, FRAME_STOP, LaneDead, ShmRing, pack_bursts,
    pack_extfree, pack_frame, unpack_burst, unpack_extfree,
    unpack_frame)
from ceph_tpu_torch.osd.shards import shard_index

_log = logging.getLogger("ceph-tpu-torch.osd.lanes")

#: retry cadence when a ring is full (the producer's backpressure
#: spin; the consumer advertises progress through the head cursor)
_RETRY_S = 0.001

#: message types eligible for the lane->lane same-host fastpath: the
#: parent routes the STILL-ENCODED frame to the target lane by the out
#: frame's (addr, pgid) header alone — no parent-side decode/re-encode.
#: Only PG-bound replication traffic qualifies: each type's handler
#: runs on the pgid's home shard, which IS the lane we forward to.
_FASTPATH_TYPES = frozenset((202, 203, 204, 205))

#: same-host OSD registry for the fastpath: messenger addr (sans nonce)
#: -> that OSD's ShardedDataPlane, registered only when the OSD runs
#: process lanes AND ms_local_delivery allows same-process shortcuts
_LOCAL_PLANES: Dict = {}


def register_local_plane(addr, plane) -> None:
    _LOCAL_PLANES[addr.without_nonce()] = plane


def unregister_local_plane(addr) -> None:
    _LOCAL_PLANES.pop(addr.without_nonce(), None)


def _local_lane_for(addr, pgid):
    """Resolve (target addr, pgid) to a live local process lane, or
    None -> the caller takes the real-socket slow path."""
    plane = _LOCAL_PLANES.get(addr.without_nonce())
    if plane is None or plane.process_lanes is None:
        return None
    lane = plane.process_lanes[shard_index(pgid, plane.num_shards)]
    return None if lane.dead else lane


def _parent_free_router(handle) -> None:
    """Parent-side free routing for pools the parent does not own: a
    lane-owned out pool's free relays down the owning lane's ring
    (where extents.release resolves it as owner)."""
    lane = _EXT_POOL_LANES.get(handle[0])
    if lane is not None and not lane.dead:
        try:
            lane._push(pack_frame(FRAME_EXTFREE, pack_extfree([handle])))
            return
        except LaneDead:
            pass
    # owner gone: the pool was (or will be) swept with the lane —
    # count it so a systematic leak cannot hide
    extents_mod._C.unroutable += 1


#: out-pool name -> owning ProcessLane (parent process only)
_EXT_POOL_LANES: Dict[str, "ProcessLane"] = {}


# ------------------------------------------------------------- envelopes

def encode_msg_envelope(m, sink=None) -> bytes:
    """Transport envelope + wire body for one message crossing a ring.
    The envelope carries what the messenger stamps out-of-band (source
    identity/address, receive stamp, transport id) so the lane-side
    dispatch sees exactly what a socket delivery would have stamped —
    plus the SPAN CONTEXT (trace/span id, the chain cursor in the
    parent's monotonic clock, and a push stamp) so the lane hop gets
    its own chain stages (``lane_codec``/``ring_wait``) instead of an
    unattributed hole in the op's timeline."""
    from ceph_tpu_torch.msg.types import EntityAddr, EntityName
    enc = Encoder()
    enc.u16(m.get_type())
    enc.opt_struct(m.src_name if isinstance(m.src_name, EntityName)
                   else None)
    enc.opt_struct(m.src_addr if isinstance(m.src_addr, EntityAddr)
                   else None)
    enc.f64(m.recv_stamp or 0.0)
    enc.u64(m.transport_id or 0)
    enc.u64(getattr(m, "throttle_cost", 0) or 0)
    sp = getattr(m, "_span", None)
    if sp is not None and not sp.finished:
        enc.u64(sp.trace_id)
        enc.u64(sp.span_id)
        enc.f64(sp._cursor)
    else:
        enc.u64(0)
        enc.u64(0)
        enc.f64(0.0)
    body = _wire_for_ring(m, sink)
    # the push stamp is the LAST field written: everything after it on
    # the parent side is the try_push itself, so lane-side
    # (t_push - cursor) is an honest wire-encode cost sample
    enc.f64(time.monotonic() if sp is not None and not sp.finished
            else 0.0)
    enc.bytes_(body)
    return enc.getvalue()


def _wire_for_ring(m, sink) -> bytes:
    """Ring-bound wire body.  With an extent sink installed the encode
    bypasses the wire_bytes cache on purpose: over-threshold data
    payloads divert into shared memory (Encoder.data_bytes_) so the
    handle-bearing form must never be cached as the message's socket
    form — a later real-socket send re-encodes inline from the same
    sealed payloads.  Without a sink this IS wire_bytes (cached,
    counted)."""
    if sink is None:
        return m.wire_bytes()
    from ceph_tpu_torch.msg import payload as payload_mod
    enc = Encoder()
    enc.extent_sink = sink
    m.encode(enc)
    body = enc.getvalue()
    payload_mod.note_encode(len(body))
    return body


def decode_msg_envelope(body: bytes, t_pop: Optional[float] = None,
                        runtime: Optional["LaneRuntime"] = None):
    from ceph_tpu_torch.msg.message import message_class
    from ceph_tpu_torch.msg.types import EntityAddr, EntityName
    dec = Decoder(body)
    mtype = dec.u16()
    src_name = dec.opt_struct(EntityName)
    src_addr = dec.opt_struct(EntityAddr)
    recv_stamp = dec.f64()
    transport_id = dec.u64()
    throttle_cost = dec.u64()
    trace_id = dec.u64()
    span_id = dec.u64()
    span_cursor = dec.f64()
    t_push = dec.f64()
    cls = message_class(mtype)
    if cls is None:
        raise ValueError(f"unregistered message type {mtype} on ring")
    # collect every ExtentRef the body decode mints so the consuming
    # op's commit callback can release them (extents.release_message)
    extents_mod.begin_collect()
    try:
        m = cls.from_bytes(dec.bytes_())
    finally:
        refs = extents_mod.end_collect()
    if refs:
        m._extent_refs = refs
    from ceph_tpu_torch.msg import payload as payload_mod
    payload_mod.note_decode()
    m.src_name = src_name
    m.src_addr = src_addr
    m.recv_stamp = recv_stamp
    m.transport_id = transport_id or None
    m.throttle_cost = throttle_cost
    if trace_id and runtime is not None:
        m._span = runtime.adopt_lane_span(trace_id, span_id,
                                          span_cursor, t_push, t_pop)
    return m


def encode_out_frame(m, addr, peer_type: Optional[str],
                     sink=None, pgid=None) -> bytes:
    """Lane -> parent outbound send: (target addr, peer type, send
    stamp, routing pgid, wire).  The send stamp (lane monotonic clock)
    is the reply leg's anchor: the parent converts it through the
    PING/PONG clock offset and the client rebases its span cursor onto
    it, so ``ack_delivery`` covers only the reply transit — the lane's
    service time was already recorded by the lane's own span.  The
    optional pgid is the fastpath routing key: present only for
    replication types the parent may forward still-encoded to a
    same-host lane (header-only routing, no re-decode)."""
    enc = Encoder()
    enc.string(peer_type or "")
    enc.struct(addr)
    enc.u16(m.get_type())
    enc.opt_struct(m.src_name)
    enc.f64(time.monotonic())
    enc.opt_struct(pgid)
    enc.bytes_(_wire_for_ring(m, sink))
    return enc.getvalue()


def decode_out_frame(body: bytes):
    from ceph_tpu_torch.msg.message import message_class
    from ceph_tpu_torch.msg.types import EntityAddr, EntityName
    from ceph_tpu_torch.osd.types import PGId
    dec = Decoder(body)
    peer_type = dec.string() or None
    addr = dec.struct(EntityAddr)
    mtype = dec.u16()
    src_name = dec.opt_struct(EntityName)
    t_send = dec.f64()
    dec.opt_struct(PGId)        # fastpath routing key (header-only)
    cls = message_class(mtype)
    if cls is None:
        raise ValueError(f"unregistered message type {mtype} on ring")
    extents_mod.begin_collect()
    try:
        m = cls.from_bytes(dec.bytes_())
    finally:
        refs = extents_mod.end_collect()
    if refs:
        m._extent_refs = refs
    from ceph_tpu_torch.msg import payload as payload_mod
    payload_mod.note_decode()
    if src_name is not None:
        m.src_name = src_name
    return m, addr, peer_type, t_send


def _encode_fwd_envelope(mtype: int, src_name, wire: bytes) -> bytes:
    """FRAME_MSG envelope the parent builds around a STILL-ENCODED
    fastpath frame: transport stamps only — no span context (trace id
    0 means the target lane skips adoption; the message's own payload
    trace fields survive untouched inside ``wire``)."""
    enc = Encoder()
    enc.u16(mtype)
    enc.opt_struct(src_name)
    enc.opt_struct(None)                 # src_addr: peers reply by id
    # recv stamp (forward instant): same wall-clock field the socket
    # intake stamps
    enc.f64(time.time())  # lint: allow[MONO05] wire recv_stamp is wall time
    enc.u64(0)                           # transport id: no socket rode
    enc.u64(0)                           # throttle: no intake budget taken
    enc.u64(0).u64(0).f64(0.0)           # no span adoption
    enc.f64(0.0)                         # no push stamp
    enc.bytes_(wire)
    return enc.getvalue()


# ------------------------------------------------------------ parent side

class ProcessLane:
    """Parent-side handle for one lane worker: the rings, the wake
    channels, the worker process, and the id-keyed control futures.
    Duck-types the slice of ``Shard`` the routing seam touches
    (``post``/``on_shard``/``ring``) so ``ShardedDataPlane.route``
    stays one code path."""

    ring = ()            # route()'s fast-path probe: never "queued work
    _busy = False        # visible in-parent" — lanes drain via ping()
    # class-level defaults: teardown/death paths must be safe on a
    # partially-constructed lane (a start() that threw mid-way)
    ext_tx = ext_out = _tx_sink = None
    _cork_on = False
    _cork_armed = False
    corked_frames = cork_pushes = fastpath_fwd = 0
    lane_cork: dict = {}
    _up: Optional[asyncio.Event] = None

    def __init__(self, plane, idx: int):
        self.plane = plane
        self.idx = idx
        self.osd = plane.osd
        cap = int(self.osd.cfg["osd_lane_ring_bytes"])
        self.to_lane = ShmRing(capacity=cap, create=True)
        self.from_lane = ShmRing(capacity=cap, create=True)
        # extent pools: the parent CREATES both segments (a dead worker
        # can never strand a named segment) and owns the tx allocator;
        # the lane worker owns the out allocator (attaches by name)
        ext_min = int(self.osd.cfg["osd_lane_extent_min_bytes"])
        self.ext_tx = self.ext_out = self._tx_sink = None
        if ext_min > 0:
            from ceph_tpu_torch.osd.extents import ExtentPool, ExtentSink
            pool_cap = int(self.osd.cfg["osd_lane_extent_pool_bytes"])
            self.ext_tx = ExtentPool(capacity=pool_cap,
                                     threshold=ext_min,
                                     create=True).register()
            self.ext_out = ExtentPool(capacity=pool_cap,
                                      threshold=ext_min, create=True)
            self._tx_sink = ExtentSink(self.ext_tx)
            _EXT_POOL_LANES[self.ext_out.name] = self
            extents_mod.set_free_router(_parent_free_router)
            tr = self.osd.ctx.tracer
            extents_mod.set_stage_recorder(
                lambda stage, dt: tr.hist.hinc(stage, dt)
                if tr.enabled else None)
        # ring-frame corking: frames queued in one loop pass coalesce
        # into one FRAME_BURST (one push, one wakeup, one drain)
        self._cork_on = bool(self.osd.cfg["osd_lane_cork"])
        self._cork: List[bytes] = []
        self._cork_armed = False
        self.corked_frames = 0      # frames that rode a cork flush
        self.cork_pushes = 0        # ring pushes those flushes cost
        self.fastpath_fwd = 0       # lane->lane frames never re-decoded
        self.lane_cork: dict = {}   # lane-reported cork counters
        # wake channels (mp.Pipe connections pickle across spawn)
        self._to_wake_r, self._to_wake_w = multiprocessing.Pipe(False)
        self._from_wake_r, self._from_wake_w = multiprocessing.Pipe(False)
        self.proc: Optional[multiprocessing.Process] = None
        self.dead = False
        self._stopping = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pending: Dict[int, asyncio.Future] = {}   # id-keyed
        self._next_id = 1
        from collections import deque
        self._overflow = deque()            # frames awaiting ring space
        self._retry_handle = None
        self.stat_rows: List[dict] = []     # last lane-reported pg rows
        self._byed = False
        self._cal_task: Optional[asyncio.Task] = None
        #: last metrics-plane snapshot the lane shipped (FRAME_STATS
        #: period or an on-demand call()); None until the first one
        self.metrics: Optional[dict] = None
        #: lane-reported slow-op total (forwarded complaints — the
        #: lane sweeps its OWN OpTracker; the parent heartbeat cannot
        #: see lane-hosted ops)
        self.slow_ops = 0
        #: monotonic-clock offset estimate: lane_clock ≈ parent_clock
        #: + clock_offset.  Same-host CLOCK_MONOTONIC is shared on
        #: Linux so 0.0 is already correct; the PING/PONG handshake
        #: measures it anyway (and keeps the lane hop attributable on
        #: platforms where the clocks differ)
        self.clock_offset = 0.0
        self._offset_known = False
        self._best_rtt = float("inf")
        self._ping_t: Dict[int, float] = {}   # rid -> ping send stamp

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        osd = self.osd
        spec = {
            "whoami": osd.whoami,
            "lane": self.idx,
            "num_lanes": self.plane.num_shards,
            "cfg": osd.cfg.dump(),
            "monmap": osd.monc.monmap.to_bytes(),
            "addr": osd.messenger.addr.to_bytes(),
            "to_lane": self.to_lane.name,
            "from_lane": self.from_lane.name,
            "ring_bytes": self.to_lane.capacity,
            "ext_tx": self.ext_tx.name if self.ext_tx else "",
            "ext_out": self.ext_out.name if self.ext_out else "",
            "ext_min": (self.ext_tx.threshold if self.ext_tx else 0),
            "device": str(osd.device),
        }
        if osd.device.type == "cuda":
            _build_kernels()
        ctx = multiprocessing.get_context("spawn")
        self.proc = ctx.Process(
            target=lane_main,
            args=(spec, self._to_wake_r, self._from_wake_w),
            daemon=True,
            name=f"osd{osd.whoami}-lane{self.idx}")
        self.proc.start()
        self._loop = asyncio.get_running_loop()
        #: set by the worker's first frame: its runtime is up
        self._up = asyncio.Event()
        self._loop.add_reader(self._from_wake_r.fileno(), self._on_wake)
        self._loop.add_reader(self.proc.sentinel, self._on_exit)
        # consumer half of the no-lost-wakeup handshake (laneipc):
        # advertise parked; _on_wake clears while draining
        self.from_lane.advertise_waiting(True)
        # clock calibration: a short PING/PONG burst measures the
        # parent->lane monotonic offset (min-RTT estimate) and the
        # follow-up pings DELIVER it — the lane needs it to attribute
        # ring dwell (`ring_wait`) across the process edge
        self._cal_task = self._loop.create_task(self._calibrate_clock())

    async def wait_ready(self) -> None:
        """Return once the worker's runtime is up (its first frame came
        back); raise ``LaneDead`` if it died first."""
        await self._up.wait()
        if self.dead:
            raise LaneDead(f"lane {self.idx} worker died")

    async def _calibrate_clock(self) -> None:
        # the worker answers nothing while it imports and builds its OSD
        # (seconds, and longer with 32 workers starting on a few cores):
        # the timed exchanges start once it is up, so that they time the
        # ring and not the worker's start
        try:
            await self.wait_ready()
        except LaneDead:
            return
        for _ in range(4):
            if self.dead or self._stopping:
                return
            try:
                await self.ping(timeout=10.0)
            except Exception:
                return            # dying/stopping lane: nothing to do
            await asyncio.sleep(0.02)

    async def stop(self, timeout: float = 20.0) -> None:
        self._stopping = True
        if getattr(self, "_cal_task", None) is not None \
                and not self._cal_task.done():
            self._cal_task.cancel()
        if self.proc is not None and self.proc.is_alive():
            self._push(pack_frame(FRAME_STOP))
            deadline = time.monotonic() + timeout
            while (self.proc.is_alive()
                   and time.monotonic() < deadline):
                self._on_wake()
                # lint: allow[RETRY19] bounded shutdown join, not an op-path retry
                await asyncio.sleep(0.01)
            if self.proc.is_alive():
                _log.error("lane %d did not stop in %.0fs; killing",
                           self.idx, timeout)
                self.proc.terminate()
            self.proc.join(timeout=5.0)
        self._teardown_io()

    def _teardown_io(self) -> None:
        if self._loop is not None:
            try:
                self._loop.remove_reader(self._from_wake_r.fileno())
            except Exception:
                pass
            if self.proc is not None:
                try:
                    self._loop.remove_reader(self.proc.sentinel)
                except Exception:
                    pass
        for conn in (self._to_wake_r, self._to_wake_w,
                     self._from_wake_r, self._from_wake_w):
            try:
                conn.close()
            except Exception:
                pass
        self.to_lane.close()
        self.to_lane.unlink()
        self.from_lane.close()
        self.from_lane.unlink()
        self._reclaim_extents("lane stop")
        if self.ext_tx is not None:
            self.ext_tx.close()
            self.ext_tx.unlink()
            self.ext_tx = None
        if self.ext_out is not None:
            self.ext_out.close()
            self.ext_out.unlink()
            self.ext_out = None
        self._tx_sink = None

    def _reclaim_extents(self, reason: str) -> None:
        """Force-free every live tx slot (the parent's side of the
        leak-proof contract): loud per-slot accounting via sweep_all,
        routing unregistered so late frees count unroutable instead of
        resolving against a reused arena."""
        if self.ext_tx is not None:
            _EXT_POOL_LANES.pop(self.ext_out.name, None)
            self.ext_tx.sweep_all(reason)

    def _on_exit(self) -> None:
        """Worker sentinel fired: clean only during stop().  Anything
        else is a crash — fail LOUDLY, never phantom-ack."""
        if self._loop is not None and self.proc is not None:
            try:
                self._loop.remove_reader(self.proc.sentinel)
            except Exception:
                pass
        if self._up is not None:
            self._up.set()      # wake wait_ready(): it raises LaneDead
        if self._stopping:
            return
        self.dead = True
        _log.error(
            "osd.%d shard lane %d worker died (exit=%s); its PGs are "
            "offline until daemon restart — in-flight ops will error, "
            "not phantom-ack", self.osd.whoami, self.idx,
            self.proc.exitcode if self.proc else "?")
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(LaneDead(
                    f"lane {self.idx} worker died"))
        self._pending.clear()
        # a dead lane's in-flight extents never see their commit
        # callback: reclaim NOW (loudly), not at daemon stop
        self._reclaim_extents(f"lane {self.idx} worker died")

    # -------------------------------------------------------------- sending
    def _push(self, frame: bytes) -> None:
        if self.dead:
            raise LaneDead(f"lane {self.idx} worker is dead")
        if self._cork_on and self._loop is not None:
            # cork: everything queued in one loop pass rides ONE ring
            # frame (FRAME_BURST) — one push, one wakeup, one drain.
            # FIFO holds: control frames cork too, in arrival order.
            self._cork.append(frame)
            if not self._cork_armed:
                self._cork_armed = True
                self._loop.call_soon(self._flush_cork)
            return
        self._push_now(frame)

    def _push_now(self, frame: bytes) -> None:
        if self._overflow or not self.to_lane.try_push(frame):
            # ring full: keep FIFO order through the overflow queue
            self._overflow.append(frame)
            self._arm_retry()
            return
        self._wake_lane()

    def _flush_cork(self) -> None:
        self._cork_armed = False
        frames = self._cork
        if not frames:
            return
        self._cork = []
        if self.dead:
            return          # drop, like the post() LaneDead contract
        self.corked_frames += len(frames)
        packed = pack_bursts(frames, self.to_lane.capacity)
        self.cork_pushes += len(packed)
        wake = False
        for f in packed:
            if self._overflow or not self.to_lane.try_push(f):
                self._overflow.append(f)
                self._arm_retry()
            else:
                wake = True
        if wake:
            self._wake_lane()

    def _wake_lane(self) -> None:
        if self.to_lane.peer_waiting():
            try:
                self._to_wake_w.send_bytes(b"w")
            except (BrokenPipeError, OSError):
                pass

    def _arm_retry(self) -> None:
        if self._retry_handle is None and self._loop is not None:
            self._retry_handle = self._loop.call_later(
                _RETRY_S, self._drain_overflow)

    def _drain_overflow(self) -> None:
        self._retry_handle = None
        if self.dead:
            self._overflow.clear()
            return
        pushed = False
        while self._overflow:
            if not self.to_lane.try_push(self._overflow[0]):
                self._arm_retry()
                break
            self._overflow.popleft()
            pushed = True
        if pushed:
            self._wake_lane()

    # Shard-compatible routing surface -----------------------------------
    def on_shard(self) -> bool:
        return False

    def post(self, fn, *args) -> None:
        """The routing seam's entry: only the classify seam's
        home-bound dispatch callable has a cross-process form; every
        other (control-plane) callable runs inline on the parent,
        where its PG lookups are no-ops — lanes own the PGs."""
        osd = self.osd
        if fn == osd._dispatch_pg_msg:
            m = args[0]
            try:
                self._push(pack_frame(FRAME_MSG, encode_msg_envelope(
                    m, sink=self._tx_sink)))
            except LaneDead:
                # drop, like a crashed OSD would: the death was
                # already logged loudly and the client resends/times
                # out.  Raising here would unwind the messenger
                # reader (killing the connection for HEALTHY lanes
                # too) and leak the intake budget below.
                pass
            # the ring bound is the backpressure now: release the
            # intake budget the parent took at classify time
            osd.messenger.put_dispatch_throttle(m)
            return
        fn(*args)

    def post_map(self, osdmap) -> None:
        self._push(pack_frame(FRAME_MAP, osdmap.to_bytes()))

    async def ping(self, timeout: float = 10.0):
        """Id-keyed quiesce probe: resolves after the lane has drained
        every frame posted before it (ring FIFO).  Doubles as the
        clock-offset handshake: the PING carries the parent's send
        stamp + its current best offset estimate (delivered to the
        lane), the PONG returns the lane's receive stamp and the
        parent refines ``clock_offset`` from the exchange with the
        smallest RTT."""
        rid = self._next_id
        self._next_id += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            # the push sits INSIDE the try: a LaneDead raised here must
            # still run the finally, or the table entry outlives the
            # lane (the _on_exit sweep already ran and cannot re-clean)
            t_send = time.monotonic()
            self._ping_t[rid] = t_send
            enc = Encoder().u64(rid)
            enc.f64(t_send)
            enc.f64(self.clock_offset)
            enc.u8(1 if self._offset_known else 0)
            self._push(pack_frame(FRAME_PING, enc.getvalue()))
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
            self._ping_t.pop(rid, None)

    async def admin_rpc(self, cmd: dict, timeout: float = 10.0) -> dict:
        """Id-keyed control call INTO the lane (the parent->lane half
        of the FRAME_RPC plane): dump/metrics requests for the
        lane-complete admin commands.  Raises ``LaneDead`` loudly on a
        dead lane — a missing lane must never look like an empty
        one."""
        rid = self._next_id
        self._next_id += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            # push inside the try: see ping() — a dead-lane raise must
            # not strand the id-keyed entry
            enc = Encoder().u64(rid)
            enc.bytes_(json.dumps(cmd).encode())
            self._push(pack_frame(FRAME_RPC, enc.getvalue()))
            status, outbl = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
        if status != 0:
            raise RuntimeError(outbl.decode(errors="replace"))
        return json.loads(outbl.decode() or "{}")

    # ------------------------------------------------------------ receiving
    def _on_wake(self) -> None:
        ring = self.from_lane
        ring.advertise_waiting(False)
        try:
            while self._from_wake_r.poll():
                self._from_wake_r.recv_bytes()
        except (EOFError, OSError):
            pass
        while True:
            for frame in ring.drain():
                try:
                    self._handle_frame(frame)
                except Exception:
                    _log.exception("lane %d frame failed", self.idx)
            # re-advertise BEFORE the emptiness re-check: a producer
            # racing the drain either sees waiting=1 (sends a byte)
            # or we see its data here and loop again
            ring.advertise_waiting(True)
            if ring.backlog_bytes == 0:
                return
            ring.advertise_waiting(False)

    def _handle_frame(self, frame: bytes) -> None:
        if self._up is not None:
            self._up.set()
        kind, body = unpack_frame(frame)
        osd = self.osd
        if kind == FRAME_BURST:
            for inner in unpack_burst(body):
                self._handle_frame(inner)
        elif kind == FRAME_EXTFREE:
            # lane-sent refcount drops: owned tx pool decrefs here;
            # another lane's out pool relays via _parent_free_router
            for h in unpack_extfree(body):
                extents_mod.release(h)
        elif kind == FRAME_OUT:
            self._handle_out(body)
        elif kind == FRAME_RPC:
            dec = Decoder(body)
            rid = dec.u64()
            cmd = json.loads(dec.bytes_().decode())
            asyncio.get_running_loop().create_task(
                self._serve_rpc(rid, cmd))
        elif kind == FRAME_RESP:
            dec = Decoder(body)
            rid = dec.u64()
            status = dec.s32()
            outbl = dec.bytes_()
            fut = self._pending.get(rid)
            if fut is not None and not fut.done():
                fut.set_result((status, outbl))
        elif kind == FRAME_PONG:
            dec = Decoder(body)
            rid = dec.u64()
            t_lane = dec.f64() if dec.remaining() >= 8 else 0.0
            t_send = self._ping_t.pop(rid, None)
            if t_send is not None and t_lane:
                now = time.monotonic()
                rtt = now - t_send
                if rtt < self._best_rtt:
                    # midpoint estimate from the tightest exchange:
                    # lane_clock - parent_clock at the same instant
                    self._best_rtt = rtt
                    self.clock_offset = t_lane - (t_send + now) / 2
                    self._offset_known = True
            fut = self._pending.get(rid)
            if fut is not None and not fut.done():
                fut.set_result(True)
        elif kind == FRAME_STATS:
            self._on_stats(json.loads(body.decode()))
        elif kind == FRAME_BYE:
            self._byed = True

    def _handle_out(self, body: bytes) -> None:
        """One lane-originated outbound send.  Header first: when the
        target address resolves to a same-host OSD running process
        lanes and the type is PG-bound replication traffic, the parent
        forwards the STILL-ENCODED wire to the target pgid's home lane
        (header-only routing — the payload, including any extent
        handles, is never touched in the parent).  Everything else
        decodes and goes out the real messenger."""
        from ceph_tpu_torch.msg.message import message_class
        from ceph_tpu_torch.msg.types import EntityAddr, EntityName
        from ceph_tpu_torch.osd.types import PGId
        osd = self.osd
        dec = Decoder(body)
        peer_type = dec.string() or None
        addr = dec.struct(EntityAddr)
        mtype = dec.u16()
        src_name = dec.opt_struct(EntityName)
        t_send = dec.f64()
        pgid = dec.opt_struct(PGId)
        if pgid is not None and mtype in _FASTPATH_TYPES \
                and bool(osd.cfg["ms_local_delivery"]):
            target = _local_lane_for(addr, pgid)
            if target is not None:
                try:
                    target._push(pack_frame(FRAME_MSG,
                                            _encode_fwd_envelope(
                                                mtype, src_name,
                                                dec.bytes_())))
                    self.fastpath_fwd += 1
                    return
                except LaneDead:
                    return   # dead target lane == crashed OSD: drop
        cls = message_class(mtype)
        if cls is None:
            raise ValueError(
                f"unregistered message type {mtype} on ring")
        extents_mod.begin_collect()
        try:
            m = cls.from_bytes(dec.bytes_())
        finally:
            refs = extents_mod.end_collect()
        from ceph_tpu_torch.msg import payload as payload_mod
        payload_mod.note_decode()
        if src_name is not None:
            m.src_name = src_name
        # a slow-path frame that carried extents pays its one copy NOW
        # (the socket encoder needs real bytes) and frees the slot
        # promptly; the cached copy keeps later re-encodes safe
        for r in refs:
            r.materialize()
            r.release()
        if t_send:
            # reply-leg anchor in the PARENT/client clock: the
            # objecter rebases its span cursor onto this so
            # ack_delivery covers only the reply transit (the
            # lane's span already recorded the service time)
            m._lane_sent_mono = t_send - self.clock_offset
        osd.messenger.send_message(m, addr, peer_type=peer_type)

    def _on_stats(self, data) -> None:
        if isinstance(data, list):          # legacy shape: rows only
            self.stat_rows = data
            return
        self.stat_rows = data.get("pg_rows") or []
        snap = data.get("metrics")
        if snap:
            self.metrics = snap
        cork = data.get("cork")
        if cork:
            self.lane_cork = cork
        slow = int(data.get("slow_ops", 0))
        if slow > self.slow_ops:
            # forwarded complaints: the lane swept its own OpTracker
            # (the parent heartbeat cannot see lane-hosted ops) —
            # surface the delta at the parent, where operators look
            _log.warning(
                "osd.%d lane %d reports %d new slow op(s) "
                "(lane total %d)", self.osd.whoami, self.idx,
                slow - self.slow_ops, slow)
            self.slow_ops = slow

    async def _serve_rpc(self, rid: int, cmd: dict) -> None:
        """Mon control calls on the lane's behalf (the lane has no mon
        session of its own); the reply resolves the lane-local future
        registered under ``rid``."""
        status, outbl = 0, b""
        try:
            ack = await self.osd.monc.command(cmd, timeout=15.0)
            outbl = ack.outbl or b""
        except Exception as e:
            status = -1
            outbl = str(e).encode()
        enc = Encoder().u64(rid).s32(status)
        enc.bytes_(outbl)
        try:
            self._push(pack_frame(FRAME_RESP, enc.getvalue()))
        except LaneDead:
            pass

    # ---------------------------------------------------------- inspection
    def counters(self) -> dict:
        return {
            "to_lane_frames": self.to_lane.pushed,
            "to_lane_bytes": self.to_lane.push_bytes,
            "to_lane_stalls": self.to_lane.full_stalls,
            "from_lane_frames": self.from_lane.popped,
            "from_lane_bytes": self.from_lane.pop_bytes,
            "from_lane_backlog": self.from_lane.backlog_bytes,
            "overflow_pending": len(self._overflow),
            "corked_frames": self.corked_frames,
            "cork_pushes": self.cork_pushes,
            "fastpath_fwd": self.fastpath_fwd,
            "lane_cork": self.lane_cork,
            "ext_tx_live": (self.ext_tx.live if self.ext_tx else 0),
            "ext_tx_live_bytes": (self.ext_tx.live_bytes
                                  if self.ext_tx else 0),
            "slow_ops": self.slow_ops,
            "clock_offset_s": round(self.clock_offset, 6),
            "has_metrics": self.metrics is not None,
            "dead": self.dead,
        }


# ------------------------------------------------------------ worker side

class RingMessenger:
    """The lane's messenger-shaped endpoint: every outbound send
    becomes a FRAME_OUT the parent re-sends from the OSD's real
    address; inbound messages arrive pre-classified from the parent's
    intake, so no listening socket, reader task, or throttle exists
    here.  Implements exactly the surface the OSD/PG/monc code
    touches."""

    def __init__(self, runtime: "LaneRuntime", addr):
        self.runtime = runtime
        self.addr = addr            # the PARENT's bound address
        self.dispatchers: List = []
        self.dispatch_throttle = None
        self.shard_router = None
        self.verify_authorizer_cb = None
        self.require_authorizer = False
        # ShardedDataPlane.counters reads these on any backend
        self._xthread_msgs = 0
        self._xthread_flushes = 0

    def add_dispatcher(self, d) -> None:
        self.dispatchers.append(d)

    def set_policy(self, *a, **kw) -> None:
        pass

    def send_message(self, msg, addr, peer_type: Optional[str] = None
                     ) -> None:
        if addr is None:
            return
        if msg.src_name is None:
            msg.src_name = self.runtime.entity_name
        rt = self.runtime
        # fastpath routing key: only replication types carry a pgid
        # header — the parent may forward those to a same-host lane
        # without decoding the body
        pgid = (getattr(msg, "pgid", None)
                if msg.get_type() in _FASTPATH_TYPES else None)
        rt.push(pack_frame(FRAME_OUT, encode_out_frame(
            msg, addr, peer_type, sink=rt.ext_sink, pgid=pgid)))

    def put_dispatch_throttle(self, msg) -> None:
        # intake budget lives (and was already released) parent-side
        if getattr(msg, "throttle_cost", 0):
            msg.throttle_cost = 0

    def get_connection(self, addr):
        return None

    def mark_down(self, addr) -> None:
        pass

    async def shutdown(self) -> None:
        pass

    def dispatch_inbound(self, m) -> None:
        for d in self.dispatchers:
            try:
                if d.ms_dispatch(m):
                    return
            except Exception:
                _log.exception("lane dispatch failed: %r", m)
        _log.warning("lane: no dispatcher took %r", m)


class LaneOSD:
    """Constructed in the worker via :func:`_make_lane_osd` — a real
    ``OSD`` instance with lane overrides bound post-construction (the
    OSD class is not imported at module scope to keep spawn cost off
    the parent's import path)."""


def _build_kernels() -> None:
    """Build (or load) the EC batch kernel's and the CRUSH descent's
    libraries in this process, so that the workers spawned next load
    them and never run ``nvcc`` all at once."""
    from ceph_tpu_torch.common.cuda_build import build
    for name in ("gf_apply", "crush_map"):
        build(name)


def _make_lane_osd(ctx, runtime: "LaneRuntime", store, monmap, device):
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.osd.shards import shard_index

    class _LaneOSD(OSD):
        def _lane_filter(self, pgid) -> bool:
            return shard_index(pgid, runtime.num_lanes) == runtime.lane

        async def ensure_map_history(self, from_e: int,
                                     to_e: int) -> None:
            """Map-history holes are filled by an id-keyed control
            call to the parent (the lane has no mon session): the
            reply frame resolves the future registered under the
            call id — the seam inventory's prescribed form for the
            reply-future seam."""
            from ceph_tpu_torch.store.types import CollectionId, ObjectId
            from ceph_tpu_torch.osd.osdmap import OSDMap
            from ceph_tpu_torch.store.objectstore import Transaction
            cid = CollectionId.meta()
            for e in range(max(1, from_e), to_e):
                if self.store.exists(cid, ObjectId(f"osdmap.{e}")):
                    continue
                try:
                    outbl = await runtime.rpc(
                        {"prefix": "osd getmap", "epoch": e})
                except Exception as ex:
                    self.logger.warning(
                        f"lane could not backfill osdmap e{e}: {ex}")
                    continue
                if outbl:
                    txn = Transaction()
                    if not self.store.collection_exists(cid):
                        txn.create_collection(cid)
                    txn.write(cid, ObjectId(f"osdmap.{e}"), 0, outbl)
                    self.store.apply_transaction(txn)
                    OSDMap.from_bytes(outbl)   # validate before trust

    osd = _LaneOSD(ctx, runtime.whoami, store, runtime.messenger,
                   monmap, device=device)
    return osd


class LaneRuntime:
    """Worker-process runtime: rings, wake handshake, the headless
    sub-OSD, and the pump that turns inbound frames into dispatches."""

    def __init__(self, spec: dict, to_wake_r, from_wake_w):
        import threading
        self.whoami = spec["whoami"]
        #: guards the id-keyed future table + overflow queue.  The
        #: whole runtime lives on one loop in its own process, but the
        #: seam tiling cannot see process boundaries — a real lock
        #: documents (and future-proofs) the affinity at ~zero cost
        self._mu = threading.Lock()
        self.lane = spec["lane"]
        self.num_lanes = spec["num_lanes"]
        self.spec = spec
        cap = int(spec.get("ring_bytes", 0))
        self.to_lane = ShmRing(name=spec["to_lane"],
                               capacity=cap)              # we consume
        self.from_lane = ShmRing(name=spec["from_lane"],
                                 capacity=cap)            # we produce
        self._wake_r = to_wake_r
        self._wake_w = from_wake_w
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.osd = None
        self.messenger: Optional[RingMessenger] = None
        self.entity_name = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 1
        self._stopping = False
        from collections import deque
        self._overflow = deque()
        self._retry_handle = None
        # cork + extents state (armed in run(): cfg and loop live there)
        self._cork_on = False
        self._cork: List[bytes] = []
        self._cork_armed = False
        self.corked_frames = 0
        self.cork_pushes = 0
        self.out_pool = None        # this lane's OWNED out-pool allocator
        self.ext_sink = None
        #: messages of the records logged at ERROR in this worker
        self.errors: List[str] = []
        self._error_handler = logging.Handler(logging.ERROR)
        self._error_handler.emit = (
            lambda record: self.errors.append(record.getMessage()))
        #: parent->lane monotonic offset (lane ≈ parent + offset),
        #: delivered by the parent's PING after its PONG-measured
        #: handshake; 0.0 (correct on same-host Linux) until then
        self.clock_offset = 0.0

    # ----------------------------------------------------------- tracing
    def adopt_lane_span(self, trace_id: int, span_id: int,
                        span_cursor: float, t_push: float,
                        t_pop: Optional[float]):
        """Continue a parent-side span across the ring hop: adopt a
        lane-local handle whose cursor starts where the parent's chain
        left off (converted through the clock offset), and attribute
        the hop itself — ``ring_wait`` (push -> pop dwell) and
        ``lane_codec`` (envelope encode + decode cost) — so
        process-lane runs tile to the same >=90% attribution inline
        runs do."""
        tr = self.osd.ctx.tracer if self.osd is not None else None
        if tr is None or not tr.enabled:
            return None
        off = self.clock_offset
        t_dec_end = time.monotonic()
        if t_pop is None:
            t_pop = t_dec_end
        span = tr.adopt(trace_id, span_id, t0=span_cursor + off)
        enc_dur = max(0.0, t_push - span_cursor)      # parent clock
        dwell = max(0.0, t_pop - (t_push + off))      # cross-clock
        dec_dur = max(0.0, t_dec_end - t_pop)         # lane clock
        span.attribute("ring_wait", dwell, hist=tr.hist)
        span.attribute("lane_codec", enc_dur + dec_dur,
                       now=t_dec_end, hist=tr.hist)
        return span

    # ------------------------------------------------------------- outbound
    def push(self, frame: bytes) -> None:
        with self._mu:
            if self._cork_on and self.loop is not None \
                    and not self._stopping:
                # producer-side cork: one FRAME_BURST per loop pass
                # (the teardown path bypasses — its loop stops running
                # callbacks before a call_soon flush would fire)
                self._cork.append(frame)
                if not self._cork_armed:
                    self._cork_armed = True
                    self.loop.call_soon(self._flush_cork)
                return
            if self._overflow or not self.from_lane.try_push(frame):
                self._overflow.append(frame)
                self._arm_retry()
                return
        self._wake_parent()

    def _arm_retry(self) -> None:
        if self._retry_handle is None and self.loop is not None:
            self._retry_handle = self.loop.call_later(
                _RETRY_S, self._drain_overflow)

    def _flush_cork(self) -> None:
        wake = False
        with self._mu:
            self._cork_armed = False
            frames = self._cork
            if not frames:
                return
            self._cork = []
            self.corked_frames += len(frames)
            packed = pack_bursts(frames, self.from_lane.capacity)
            self.cork_pushes += len(packed)
            for f in packed:
                if self._overflow or not self.from_lane.try_push(f):
                    self._overflow.append(f)
                    self._arm_retry()
                else:
                    wake = True
        if wake:
            self._wake_parent()

    def _drain_overflow(self) -> None:
        self._flush_cork()      # corked frames keep FIFO ahead of retry
        pushed = False
        with self._mu:
            self._retry_handle = None
            while self._overflow:
                if not self.from_lane.try_push(self._overflow[0]):
                    self._retry_handle = self.loop.call_later(
                        _RETRY_S, self._drain_overflow)
                    break
                self._overflow.popleft()
                pushed = True
        if pushed:
            self._wake_parent()

    def _wake_parent(self) -> None:
        if self.from_lane.peer_waiting():
            try:
                self._wake_w.send_bytes(b"w")
            except (BrokenPipeError, OSError):
                pass

    def _route_free(self, handle) -> None:
        """extents.set_free_router hook: a drop against a pool this
        lane does not own rides the ring to the parent (corked like
        any other frame); the parent resolves or relays it."""
        try:
            self.push(pack_frame(FRAME_EXTFREE, pack_extfree([handle])))
        except Exception:
            pass        # teardown race: the sweep accounts the slot

    async def rpc(self, cmd: dict, timeout: float = 15.0) -> bytes:
        fut = asyncio.get_running_loop().create_future()
        with self._mu:
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = fut
        enc = Encoder().u64(rid)
        enc.bytes_(json.dumps(cmd).encode())
        self.push(pack_frame(FRAME_RPC, enc.getvalue()))
        try:
            status, outbl = await asyncio.wait_for(fut, timeout)
        finally:
            with self._mu:
                self._pending.pop(rid, None)
        if status != 0:
            raise RuntimeError(outbl.decode(errors="replace"))
        return outbl

    # -------------------------------------------------------------- inbound
    def _on_wake(self) -> None:
        try:
            while self._wake_r.poll():
                self._wake_r.recv_bytes()
        except (EOFError, OSError):
            pass
        self._pump()

    def _pump(self) -> None:
        ring = self.to_lane
        ring.advertise_waiting(False)
        while True:
            for frame in ring.drain():
                try:
                    self._handle_frame(frame)
                except Exception:
                    _log.exception("lane %d: inbound frame failed",
                                   self.lane)
            # same handshake as the parent side: re-advertise before
            # the emptiness re-check so no producer push is lost
            ring.advertise_waiting(True)
            if ring.backlog_bytes == 0:
                return
            ring.advertise_waiting(False)

    def _handle_frame(self, frame: bytes) -> None:
        kind, body = unpack_frame(frame)
        if kind == FRAME_BURST:
            # one ring pop, one wakeup, then the whole corked batch
            for inner in unpack_burst(body):
                self._handle_frame(inner)
        elif kind == FRAME_EXTFREE:
            # parent-relayed drops against this lane's OWN out pool
            for h in unpack_extfree(body):
                extents_mod.release(h)
        elif kind == FRAME_MSG:
            t_pop = time.monotonic()
            self.messenger.dispatch_inbound(
                decode_msg_envelope(body, t_pop=t_pop, runtime=self))
        elif kind == FRAME_MAP:
            from ceph_tpu_torch.osd.osdmap import OSDMap
            osdmap = OSDMap.from_bytes(body)
            # a map of its own, kept for get_map once the advance has
            # primed it: the interval walks of PGs made later read it
            # there instead of decoding and priming the epoch anew
            self.osd._memo_map(osdmap)
            self.osd._apply_map(osdmap)
        elif kind == FRAME_RESP:
            dec = Decoder(body)
            rid = dec.u64()
            status = dec.s32()
            outbl = dec.bytes_()
            fut = self._pending.get(rid)
            if fut is not None and not fut.done():
                fut.set_result((status, outbl))
        elif kind == FRAME_RPC:
            # parent->lane dump/metrics request (the lane-complete
            # admin plane): id-keyed, answered with FRAME_RESP
            dec = Decoder(body)
            rid = dec.u64()
            cmd = json.loads(dec.bytes_().decode())
            self._serve_parent_rpc(rid, cmd)
        elif kind == FRAME_PING:
            t_recv = time.monotonic()
            dec = Decoder(body)
            rid = dec.u64()
            if dec.remaining() >= 17:
                dec.f64()                  # parent send stamp (unused)
                off = dec.f64()
                if dec.u8():
                    self.clock_offset = off
            enc = Encoder().u64(rid)
            enc.f64(t_recv)
            self.push(pack_frame(FRAME_PONG, enc.getvalue()))
        elif kind == FRAME_STOP:
            self._stopping = True

    def _serve_parent_rpc(self, rid: int, cmd: dict) -> None:
        """Serve one parent dump request (everything here is a plain
        in-memory read — no awaits, no store access, no encodes)."""
        status, out = 0, {}
        try:
            prefix = cmd.get("prefix", "")
            osd = self.osd
            if prefix == "metrics":
                from ceph_tpu_torch.common import metrics
                out = metrics.snapshot(
                    osd.ctx,
                    source=f"osd.{self.whoami}/lane{self.lane}")
            elif prefix == "stage_dumps":
                from ceph_tpu_torch.common import tracer as tracer_mod
                grp = osd.ctx.perf._groups.get(tracer_mod.STAGE_GROUP)
                out = grp.dump_histograms() if grp is not None else {}
            elif prefix == "dump_historic_slow_ops":
                out = osd.op_tracker.dump_historic_slow_ops()
            elif prefix == "dump_ops_in_flight":
                out = osd.op_tracker.dump_in_flight()
            elif prefix == "dump_flight_recorder":
                out = osd.op_tracker.dump_flight_recorder()
            elif prefix == "check_slow":
                out = {"raised": osd.op_tracker.check_slow()}
            elif prefix == "lane_transport":
                # zero-copy transport evidence, read at bench end:
                # producer-side cork ratio, replica-ack coalescing,
                # and this worker's extent (out-pool) accounting
                out = {
                    "cork": {"corked_frames": self.corked_frames,
                             "cork_pushes": self.cork_pushes},
                    "acks": osd.perf_repack.dump(),
                    "extents": extents_mod.counters(),
                }
            elif prefix == "lane_state":
                out = self._lane_state()
            else:
                status = -1
                out = {"error": f"unknown lane rpc {prefix!r}"}
        except Exception as e:
            status = -1
            out = {"error": f"{type(e).__name__}: {e}"}
        enc = Encoder().u64(rid).s32(status)
        enc.bytes_(json.dumps(out, default=str).encode())
        self.push(pack_frame(FRAME_RESP, enc.getvalue()))

    def _lane_state(self) -> dict:
        """What this worker launched on its device (its OSD's batched
        CRUSH placements by call site, each EC batch queue's launches,
        the kernel wrappers' launch counts in this process), its map
        epoch, its primary PGs' states and its ERROR records."""
        from ceph_tpu_torch.ec import kernel
        from ceph_tpu_torch.ops import crush_kernel
        osd = self.osd
        return {"pid": os.getpid(), "device": str(osd.device),
                "crush_batches": dict(osd.crush_batches),
                "queue_launches": {name: q.launches for name, q
                                   in osd.ec_queues().items()},
                "gf_apply_launches": kernel.gf_apply_launches,
                "crush_map_launches": crush_kernel.crush_map_launches,
                "osdmap_epoch": osd.osdmap.epoch,
                "primaries": {str(pg.pgid.without_shard()):
                              [pg.state, pg.is_fully_clean()]
                              for pg in list(osd.pgs.values())
                              if pg.is_primary()},
                "errors": list(self.errors)}

    # ------------------------------------------------------------ lifecycle
    async def run(self) -> None:
        from ceph_tpu_torch.common.context import Context
        from ceph_tpu_torch.mon.monmap import MonMap
        from ceph_tpu_torch.msg.types import EntityAddr, EntityName
        from ceph_tpu_torch.store.memstore import MemStore
        self.loop = asyncio.get_running_loop()
        spec = self.spec
        device = spec.get("device")
        if not device:
            raise ValueError(
                f"osd.{self.whoami} lane {self.lane}: the spawn spec names "
                f"no device")
        ctx = Context(f"osd.{self.whoami}")
        ctx.config.set_many(spec["cfg"])
        ctx.log.root.addHandler(self._error_handler)
        # the lane is single-loop inside: its own plane stays disabled
        ctx.config.set("osd_op_num_shards", 1)
        ctx.config.set("osd_shard_lanes", "inline")
        self.entity_name = EntityName("osd", str(self.whoami))
        addr = EntityAddr.from_bytes(spec["addr"])
        monmap = MonMap.from_bytes(spec["monmap"])
        self.messenger = RingMessenger(self, addr)
        store = MemStore()
        store.mkfs()
        store.ack_on_apply = True
        self.osd = _make_lane_osd(ctx, self, store, monmap, device)
        osd = self.osd
        store.mount()
        osd.shards.start()        # disabled plane: inline route()
        osd.running = True
        # zero-copy transport wiring: this lane OWNS the out-pool
        # allocator (segment created — and on death unlinked — by the
        # parent), publishes its over-threshold sends there, and
        # routes frees for foreign pools (the parent's tx arena,
        # sibling lanes' out arenas) back over the ring
        self._cork_on = bool(osd.cfg["osd_lane_cork"])
        if spec.get("ext_out"):
            from ceph_tpu_torch.osd.extents import ExtentPool, ExtentSink
            self.out_pool = ExtentPool(
                name=spec["ext_out"],
                threshold=int(spec.get("ext_min") or 1),
                create=False).register()
            self.ext_sink = ExtentSink(self.out_pool)
            extents_mod.set_free_router(self._route_free)
        tr = ctx.tracer
        extents_mod.set_stage_recorder(
            lambda stage, dt: tr.hist.hinc(stage, dt)
            if tr.enabled else None)
        # stats reporting: compute rows like the daemon would and ship
        # them BOTH to the mon (via the ring messenger, rows merge
        # per-pgid in the PGMap) and to the parent (FRAME_STATS, for
        # local introspection)
        stats_task = self.loop.create_task(self._stats_loop())
        # scheduled scrub runs WHERE the PGs live: the parent's
        # scheduler iterates an empty registry under process lanes
        osd._scrub_task = self.loop.create_task(
            osd._scrub_scheduler())
        self.loop.add_reader(self._wake_r.fileno(), self._on_wake)
        self.to_lane.advertise_waiting(True)
        self._pump()              # anything posted before we armed
        ppid = os.getppid()
        # slow-op sweep cadence: the lane hosts the PGs, so the
        # parent's heartbeat-tick sweep cannot see these ops — each
        # worker sweeps its OWN OpTracker and forwards complaint
        # counts via FRAME_STATS (osd.slow_ops stays lane-complete)
        sweep_every = max(0.5, float(osd.cfg["osd_heartbeat_interval"]))
        next_sweep = time.monotonic() + sweep_every
        try:
            while not self._stopping:
                # lint: allow[RETRY19] fixed pump cadence (belt), wakeup pipe is the fast path
                await asyncio.sleep(0.2)
                self._pump()      # belt: poll alongside wakeups
                now = time.monotonic()
                if now >= next_sweep:
                    next_sweep = now + sweep_every
                    try:
                        osd.op_tracker.check_slow()
                    except Exception:
                        _log.exception("lane %d slow-op sweep failed",
                                       self.lane)
                if os.getppid() != ppid:
                    _log.error("lane %d: parent died; exiting",
                               self.lane)
                    return
        finally:
            stats_task.cancel()
            if osd._scrub_task is not None:
                osd._scrub_task.cancel()
            self.to_lane.advertise_waiting(False)
            try:
                self.loop.remove_reader(self._wake_r.fileno())
            except Exception:
                pass
            # graceful: stop PGs, flush the lane store, say BYE
            osd.running = False
            for pg in list(osd.pgs.values()):
                pg.stop()
            try:
                store.sync()
            except Exception:
                pass
            try:
                self.push(pack_frame(FRAME_BYE))
            except Exception:
                pass
            self._drain_overflow()
            if self.out_pool is not None:
                self.out_pool.close()     # parent owns the unlink
            extents_mod.detach_all()

    async def _stats_loop(self) -> None:
        interval = float(self.osd.cfg["osd_mon_report_interval"])
        from ceph_tpu_torch.common import metrics
        while not self._stopping:
            await asyncio.sleep(interval)
            try:
                rows = self.osd._pg_stat_rows()
                # the periodic half of the metrics plane: PG rows +
                # the lane's FULL mergeable perf snapshot + forwarded
                # slow-op count ride one frame (on-demand fetches use
                # the id-keyed FRAME_RPC path instead)
                body = {
                    "pg_rows": rows,
                    "slow_ops": self.osd.op_tracker.slow_op_count,
                    "cork": {"corked_frames": self.corked_frames,
                             "cork_pushes": self.cork_pushes},
                    "metrics": metrics.snapshot(
                        self.osd.ctx,
                        source=f"osd.{self.whoami}/lane{self.lane}"),
                }
                self.push(pack_frame(
                    FRAME_STATS,
                    json.dumps(body, default=str).encode()))
                self.osd._send_pg_stats(rows)
            except Exception:
                _log.exception("lane %d stats tick failed", self.lane)


def lane_main(spec: dict, to_wake_r, from_wake_w) -> None:
    """Worker entry point (spawned).  Builds a fresh event loop and
    runs the lane runtime until STOP or parent death."""
    logging.basicConfig(level=logging.WARNING)
    runtime = LaneRuntime(spec, to_wake_r, from_wake_w)
    logging.getLogger().addHandler(runtime._error_handler)
    try:
        asyncio.run(runtime.run())
    finally:
        runtime.to_lane.close()
        runtime.from_lane.close()
