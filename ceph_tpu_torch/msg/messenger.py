"""Asyncio messenger: the control-plane transport between daemons.

Reference parity: msg/Messenger.h (factory :164, send_message :466,
dispatcher chain, lossy-client vs lossless-peer policies) and the
AsyncMessenger event-loop transport (msg/async/AsyncMessenger.cc,
AsyncConnection.cc state machine).  Redesigned for asyncio instead of
epoll threads, with one deliberate simplification of the hardest part of
the reference (Pipe.cc's simultaneous-connect races): each DIRECTION of a
peer pair is its own TCP connection owned by its sender.  Lossless
delivery then needs no connection-takeover protocol — the sender replays
un-acked messages on its own reconnect, and the receiver dedupes by
(peer nonce, seq) learned from the banner.  Semantics preserved:
per-peer FIFO, at-most-once delivery to dispatchers, reset callbacks,
message-count fault injection (ms_inject_socket_failures).

Wire format: banner = [u32 len][EntityName][EntityAddr] once per
connection, then frames [u8 tag][u32 len][payload]:
  MSG  payload = [u64 seq][u16 type][u32 crc(body)][body]
  ACK  payload = [u64 seq]      (cumulative)

The port's copy of ``ceph_tpu.msg.messenger``: frames, banners, acks
and cephx signatures are byte-identical, so a messenger of either package
talks to one of the other over TCP.  ``_post_home`` (reached only when a
thread other than the home loop's sends) marshals the send through the
port's ``osd.shards.Courier``.
"""

from __future__ import annotations

import asyncio
import random
import struct
import threading
import time
import zlib
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.common.throttle import AsyncThrottle
from ceph_tpu_torch.msg import payload as payload_mod
from ceph_tpu_torch.msg.message import Message, message_class
from ceph_tpu_torch.msg.types import EntityAddr, EntityName

TAG_MSG = 1
TAG_ACK = 2
TAG_KEEPALIVE = 3
TAG_AUTH_REPLY = 4

_FRAME_HDR = struct.Struct("<BI")       # tag, len
_MSG_HDR = struct.Struct("<QHI")        # seq, type, crc


class Policy:
    """Per-peer-type delivery policy (Messenger::Policy, msg/Messenger.h).

    lossy: on failure drop the queue and report a reset — the higher layer
    (Objecter, MonClient) owns resend.  lossless: reconnect forever and
    replay un-acked messages in order (daemon↔daemon)."""

    def __init__(self, lossy: bool):
        self.lossy = lossy

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True)

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False)


class Dispatcher:
    """Receiver interface (msg/Dispatcher.h).  ms_dispatch returns True if
    the message was handled; the messenger tries each dispatcher in
    registration order (Messenger::ms_deliver_dispatch)."""

    def ms_dispatch(self, msg: Message) -> bool:
        return False

    def ms_handle_reset(self, addr: EntityAddr) -> None:
        """A lossy session to addr dropped its queue."""

    def ms_handle_remote_reset(self, addr: EntityAddr) -> None:
        """Peer at addr restarted (new nonce observed)."""


class Connection:
    """Outgoing logical channel to one peer address (sender-owned)."""

    def __init__(self, msgr: "Messenger", addr: EntityAddr, policy: Policy,
                 peer_type: Optional[str] = None):
        self.msgr = msgr
        self.addr = addr
        self.policy = policy
        self.peer_type = peer_type
        # cephx: authorizer presented in the banner; session key signs
        # every frame once the peer's AUTH_REPLY proof checks out
        self.session_key: Optional[bytes] = None
        self._auth_nonce: Optional[bytes] = None
        self._auth_verified = asyncio.Event()
        self._auth_error: Optional[str] = None
        # identifies THIS logical connection across its tcp reconnects;
        # a fresh Connection (e.g. after mark_down) gets a fresh seq space
        self.conn_id = random.getrandbits(63)
        self.out_q: Deque[Message] = deque()
        self.unacked: Deque[Tuple[int, bytes]] = deque()  # (seq, frame)
        self.out_seq = 0
        self.acked_seq = 0
        self._kick = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._broken = False   # peer hung up (ack stream EOF)
        self.closed = False

    def send(self, msg: Message) -> None:
        self.out_q.append(msg)
        self._kick.set()

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    # --- writer loop ---
    async def _run(self) -> None:
        backoff = self.msgr.cfg["ms_initial_backoff"]
        while not self.closed:
            try:
                reader, writer = await asyncio.open_connection(
                    self.addr.host, self.addr.port)
            except OSError:
                if self.policy.lossy:
                    self._fail_lossy()
                    return
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.msgr.cfg["ms_max_backoff"])
                continue
            backoff = self.msgr.cfg["ms_initial_backoff"]
            self._writer = writer
            self._broken = False
            ack_task = asyncio.get_running_loop().create_task(
                self._read_acks(reader))
            try:
                await self._send_banner(writer)
                self.msgr.log.debug(
                    f"link to {self.addr} up (replay "
                    f"{len(self.unacked)})")
                # replay everything not yet acked, oldest first (framed
                # at write time so replays re-sign with the CURRENT
                # session key, not the pre-reconnect one)
                for _, payload in list(self.unacked):
                    writer.write(self._wrap(payload))
                await writer.drain()
                await self._pump(writer)
            except (OSError, asyncio.IncompleteReadError,
                    ConnectionError) as e:
                self.msgr.log.debug(
                    f"link to {self.addr} dropped: {e!r}")
            finally:
                ack_task.cancel()
                self._writer = None
                writer.close()
            if self.closed:
                return
            if self.policy.lossy:
                self._fail_lossy()
                return

    def _fail_lossy(self) -> None:
        self.out_q.clear()
        self.unacked.clear()
        self.closed = True
        self.msgr._drop_connection(self)
        for d in self.msgr.dispatchers:
            d.ms_handle_reset(self.addr)

    async def _send_banner(self, writer: asyncio.StreamWriter) -> None:
        authorizer = b""
        self.session_key = None
        self._auth_verified = asyncio.Event()
        self._auth_error = None
        if self.msgr.get_authorizer_cb is not None:
            got = self.msgr.get_authorizer_cb(self.peer_type)
            if got is not None:
                authorizer, self.session_key, self._auth_nonce = got
        enc = Encoder()
        enc.struct(self.msgr.name).struct(self.msgr.addr)
        enc.u64(self.conn_id)
        enc.bytes_(authorizer)
        b = enc.getvalue()
        writer.write(struct.pack("<I", len(b)) + b)
        await writer.drain()
        if self.session_key is not None:
            # wait for the acceptor's mutual proof before trusting the
            # link with any frames (cephx authorizer reply); _read_acks
            # also sets the event on FAILURE (with _auth_error) so a
            # rejected handshake surfaces immediately with its real
            # reason instead of burning the full timeout
            try:
                await asyncio.wait_for(self._auth_verified.wait(), 10.0)
            except asyncio.TimeoutError:
                raise ConnectionError("authorizer reply timed out")
            if self._auth_error is not None:
                raise ConnectionError(self._auth_error)

    async def _pump(self, writer: asyncio.StreamWriter) -> None:
        while not self.closed:
            if self._broken:
                # peer hung up: writes to the dead socket would buffer
                # silently (half-open TCP), so force the reconnect path —
                # un-acked frames replay there
                raise ConnectionError("peer closed ack stream")
            if self.out_q:
                # cork: frame EVERY queued message into one buffer and
                # hand the transport a single write before the single
                # drain — per-message write() calls each cost a send
                # syscall (asyncio flushes an empty transport buffer
                # eagerly), which dominates small-message bursts like
                # repop ack storms.  Ordering is untouched: frames are
                # corked in queue order and unacked tracks each seq.
                buf = bytearray()
                inject = False
                n = 0
                while self.out_q:
                    msg = self.out_q.popleft()
                    self.out_seq += 1
                    msg.seq = self.out_seq
                    # lazy payload: the body materializes HERE, at the
                    # real socket boundary, exactly once per message
                    # (fan-out reuses the cache; replay reuses frames)
                    body = msg.wire_bytes()
                    payload = _MSG_HDR.pack(msg.seq, msg.TYPE,
                                            zlib.crc32(body)) + body
                    self.unacked.append((self.out_seq, payload))
                    if self.msgr._inject_failure():
                        inject = True   # this frame replays on reconnect
                        break
                    buf += self._wrap(payload)
                    n += 1
                if buf:
                    writer.write(bytes(buf))
                    self.msgr._sock_writes += 1
                    self.msgr._sock_write_msgs += n
                if inject:
                    writer.transport.abort()   # hard drop, like a RST
                    raise ConnectionError("injected socket failure")
            await writer.drain()
            self._kick.clear()
            if not self.out_q and not self._broken:
                await self._kick.wait()

    def _wrap(self, payload: bytes) -> bytes:
        if self.session_key is not None:
            from ceph_tpu_torch.auth.cephx import sign_payload
            payload = payload + sign_payload(self.session_key, payload)
        return _FRAME_HDR.pack(TAG_MSG, len(payload)) + payload

    async def _read_acks(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                hdr = await reader.readexactly(_FRAME_HDR.size)
                tag, ln = _FRAME_HDR.unpack(hdr)
                payload = await reader.readexactly(ln)
                if tag == TAG_ACK:
                    (seq,) = struct.unpack("<Q", payload)
                    self.acked_seq = max(self.acked_seq, seq)
                    while self.unacked and self.unacked[0][0] <= seq:
                        self.unacked.popleft()
                elif tag == TAG_AUTH_REPLY:
                    from ceph_tpu_torch.auth.cephx import (
                        authorizer_reply_proof, hmac_eq)
                    if payload == b"":
                        # acceptor claims no verifier armed.  With cephx
                        # mandated, downgrading would let an active MITM
                        # strip mutual auth + signing by forging this
                        # empty frame — fail closed.  The one legitimate
                        # window is a MON pushing to an OSD still inside
                        # its own boot handshake (its verifier arms only
                        # after MAuth completes, and the MAuthReply rides
                        # THIS link): allow that downgrade; the OSD kills
                        # unauthenticated inbound links once it arms
                        # require_authorizer (osd/daemon.py), so the mon
                        # re-handshakes signed right after boot.  The OSD
                        # is the ONLY daemon type the mon dials (mds/mgr
                        # talk through their own client stacks), so the
                        # window stays osd-scoped — for everyone else an
                        # empty reply can only be an attack or a bug.
                        boot_window = (self.msgr.name.type == "mon"
                                       and self.peer_type == "osd")
                        if (self.msgr.cfg["auth_supported"] == "cephx"
                                and not boot_window):
                            self._auth_error = ("empty authorizer reply "
                                                "(cephx required)")
                            self._auth_verified.set()
                            raise ConnectionError(self._auth_error)
                        self.msgr.log.info(
                            f"downgrading link to {self.addr} to "
                            f"unsigned (acceptor has no verifier yet)")
                        self.session_key = None
                        self._auth_verified.set()
                    elif (self.session_key is not None
                            and self._auth_nonce is not None
                            and hmac_eq(payload, authorizer_reply_proof(
                                self.session_key, self._auth_nonce))):
                        self._auth_verified.set()
                    else:
                        self.msgr.log.warning(
                            f"bad authorizer reply from {self.addr}")
                        self._auth_error = "bad authorizer reply"
                        self._auth_verified.set()
                        raise ConnectionError(self._auth_error)
        except asyncio.CancelledError:
            return
        except (OSError, asyncio.IncompleteReadError, ConnectionError):
            self._broken = True
            self._kick.set()   # wake _pump so it reconnects

    async def close(self) -> None:
        self.closed = True
        self._kick.set()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass


#: process-local endpoint registry: (host, port) -> bound Messenger.
#: Registration is unconditional (bind/shutdown); whether a sender USES
#: it is gated per-send by the ms_local_delivery config on both ends.
_LOCAL_ENDPOINTS: Dict[Tuple[str, int], "Messenger"] = {}


class LocalConnection:
    """Same-process fast path (AsyncMessenger local_connection /
    ms_fast_dispatch role, widened from self-delivery to any co-located
    messenger — the deployment the QA cluster and bench actually run).

    ZERO-ENCODE delivery (msg/payload.py): the receiver is handed the
    message's ``local_view()`` — the live object graph, frozen/copied
    per that type's discipline — in FIFO order; no body is serialized
    or parsed on this path, which is the counter-guarded invariant.
    Everything that exists to survive an unreliable byte stream —
    framing, crc, acks, replay, reconnect — is skipped: in-process
    delivery cannot drop or reorder.  Fault-injection and cephx configs
    fall back to TCP at routing time (_local_peer), so thrash/
    model-checker semantics and auth gating are untouched.

    Backpressure: the receiver's per-sender intake queue is bounded by
    a bytes budget (ms_dispatch_throttle_bytes — the role TCP's socket
    buffers play).  While the budget has room, send() hands the message
    over synchronously; once it fills, messages queue HERE and an async
    pump awaits the receiver's gate — so a co-located flood parks the
    sender's stream instead of growing intake RAM, without ever
    head-of-line blocking other senders' queues."""

    is_local = True

    def __init__(self, msgr: "Messenger", addr: EntityAddr,
                 peer: "Messenger"):
        self.msgr = msgr
        self.addr = addr
        self.peer = peer
        self.conn_id = random.getrandbits(63)
        self.out_q: Deque[Message] = deque()
        self.out_seq = 0
        self.closed = False
        self._kick = asyncio.Event()   # mark_down compatibility
        self._task: Optional[asyncio.Task] = None

    def _peer_alive(self) -> Optional["Messenger"]:
        peer = _LOCAL_ENDPOINTS.get(self.addr.without_nonce())
        return peer if peer is self.peer else None

    def _reset(self) -> None:
        # peer endpoint went away (daemon shutdown/restart): behave
        # like a torn-down TCP session — drop and let the caller's
        # resend machinery (objecter, peering) recover via whatever
        # endpoint rebinds
        self.closed = True
        self.out_q.clear()
        self.msgr._drop_connection(self)
        for d in self.msgr.dispatchers:
            d.ms_handle_reset(self.addr)

    def send(self, msg: Message) -> None:
        if self.closed:
            return
        if self._task is None and not self.out_q:
            peer = self._peer_alive()
            if peer is None:
                self._reset()
                return
            if self._try_shard_fast(peer, msg):
                return      # handed straight to the owning shard
            cost = msg.local_cost()
            if peer._local_intake_gate(self.conn_id).get_or_fail(cost):
                self._deliver(peer, msg, cost)   # uncongested fast path
                return
        # intake over budget (or a pump already draining a backlog):
        # preserve FIFO by parking behind the async producer gate
        self.out_q.append(msg)
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._pump_local())

    def _try_shard_fast(self, peer: "Messenger", msg: Message) -> bool:
        """Sharded-intake classify (osd/shards.py): when the peer runs
        a sharded data plane and this message class belongs to a PG,
        hand the local view STRAIGHT to the owning shard's ring — no
        per-sender intake queue, no worker task, no per-message
        wakeup.  Engages only while no legacy delivery from this
        connection is still in flight (``_local_pending``), so per-PG
        FIFO order can never be overtaken; op-class messages still
        pass the dispatch throttle (non-blocking probe — on a full
        budget the message takes the legacy path, which parks and
        preserves the backpressure contract)."""
        router = peer.shard_router
        if router is None or not router.wants(msg):
            return False
        if peer._local_pending.get(self.conn_id):
            return False
        throttled = 0
        if msg.THROTTLE_DISPATCH and not msg.THROTTLE_SPLIT \
                and peer.dispatch_throttle is not None:
            throttled = msg.local_cost()
            if not peer.dispatch_throttle.get_or_fail(throttled):
                return False
        self.out_seq += 1
        view = msg.local_view()
        view.seq = self.out_seq
        view.src_name = self.msgr.name
        view.src_addr = self.msgr.addr
        view.transport_id = -self.conn_id
        view.recv_stamp = time.monotonic()
        view.throttle_cost = throttled
        # stage cuts mirror the legacy intake worker exactly: only
        # throttled (client-op) classes consume chain stages here — a
        # sub-op shares the client's LIVE span and must not cut it
        if msg.THROTTLE_DISPATCH and peer.ctx.tracer.enabled \
                and view._span is not None:
            view._span.cut("deliver", peer.ctx.tracer.hist)
            view._span.cut("throttle_wait", peer.ctx.tracer.hist)
        self.msgr._local_msgs += 1
        payload_mod.note_local()
        peer._msgs_received += 1
        router.deliver(view)
        return True

    def _deliver(self, peer: "Messenger", msg: Message,
                 cost: int) -> None:
        self.out_seq += 1
        view = msg.local_view()
        view.seq = self.out_seq
        self.msgr._local_msgs += 1
        payload_mod.note_local()
        peer._local_enqueue(self.msgr.name, self.msgr.addr,
                            self.conn_id, view, cost)

    async def _pump_local(self) -> None:
        """Drains the backlog through the receiver's bytes-budget gate;
        exits once empty (send() resumes the synchronous fast path)."""
        try:
            while self.out_q and not self.closed:
                peer = self._peer_alive()
                if peer is None:
                    self._reset()
                    return
                msg = self.out_q[0]
                cost = msg.local_cost()
                gate = peer._local_intake_gate(self.conn_id)
                await gate.get(cost)
                if self.closed:
                    gate.put(cost)
                    return
                if self._peer_alive() is None:   # died across the await
                    self._reset()
                    return
                self.out_q.popleft()
                self._deliver(peer, msg, cost)
        except asyncio.CancelledError:
            pass
        finally:
            self._task = None

    async def close(self) -> None:
        self.closed = True
        self._kick.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass


class _AckBatcher:
    """Coalesces the receive side's cumulative acks: one ACK frame per
    drained burst of inbound frames (scheduled via call_soon, which runs
    only once the reader empties its buffer and yields), instead of one
    eager write syscall + sender wakeup per message.  Acks are
    cumulative, so acking only the newest seq is lossless."""

    __slots__ = ("writer", "_seq", "_scheduled")

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self._seq = 0
        self._scheduled = False

    def note(self, seq: int) -> None:
        if seq > self._seq:
            self._seq = seq
        if not self._scheduled:
            self._scheduled = True
            asyncio.get_running_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._scheduled = False
        if self.writer.is_closing():
            return
        ack = struct.pack("<Q", self._seq)
        self.writer.write(_FRAME_HDR.pack(TAG_ACK, len(ack)) + ack)


class Messenger:
    """One per process endpoint (daemons bind; clients stay unbound)."""

    def __init__(self, ctx, name: EntityName,
                 default_policy: Optional[Policy] = None):
        self.ctx = ctx
        self.cfg = ctx.config
        self.log = ctx.logger("ms")
        self.name = name
        self.nonce = random.getrandbits(48)
        self.addr = EntityAddr("", 0, self.nonce)
        self.dispatchers: List[Dispatcher] = []
        if default_policy is None:
            # clients default lossy (their stacks own resend); daemons
            # default lossless peer links (Messenger policy defaults)
            default_policy = (Policy.lossy_client() if name.is_client()
                              else Policy.lossless_peer())
        self.default_policy = default_policy
        self.policies: Dict[str, Policy] = {}   # peer entity type -> policy
        self.conns: Dict[Tuple[str, int], Connection] = {}
        # receive-side dedupe: (peer nonce, conn id) -> last delivered seq
        self._in_seq: Dict[Tuple[int, int], int] = {}
        self._peer_nonce: Dict[Tuple[str, int], int] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._in_tasks: set = set()
        self._next_transport_id = 1    # per-incoming-socket id counter
        self._msgs_sent = 0
        self._msgs_received = 0
        # corked-write accounting: messages coalesced per socket write
        # (msgs/write > 1 == the cork is earning its keep)
        self._sock_writes = 0
        self._sock_write_msgs = 0
        # same-process fast-path accounting + intake: one
        # queue+worker+bytes-gate PER SENDER CONNECTION, mirroring the
        # TCP path's per-peer reader tasks + socket buffers — a
        # throttled client op must only back-pressure its own sender,
        # never head-of-line block peer acks
        self._local_msgs = 0
        self._local_in: Dict[
            int, Tuple[asyncio.Queue, asyncio.Task, AsyncThrottle]] = {}
        # per-sender count of legacy local deliveries not yet fully
        # dispatched: the shard fast path stays OFF while any are in
        # flight so it can never overtake the queued stream (FIFO)
        self._local_pending: Dict[int, int] = {}
        # cephx hooks (msg/Messenger.h ms_get_authorizer /
        # ms_verify_authorizer dispatcher hooks, collapsed onto the
        # messenger since auth state lives with the owning stack):
        #   get_authorizer_cb(peer_type) -> (authorizer, session_key,
        #       nonce) | None — presented in the banner of OUTGOING
        #       connections
        #   verify_authorizer_cb(authorizer) -> (ticket, reply_proof) —
        #       validates INCOMING banners; raises AuthError to reject
        #   require_authorizer — drop incoming connections with no/bad
        #       authorizer (daemons with auth_supported=cephx)
        self.get_authorizer_cb = None
        self.verify_authorizer_cb = None
        self.require_authorizer = False
        # optional intake backpressure (Throttle.h role): frames whose
        # message class sets THROTTLE_DISPATCH block the reader while
        # over budget; the handling daemon releases at op completion
        self.dispatch_throttle = None
        # sharded data plane seam (osd/shards.py): when the owning OSD
        # runs >1 shard it installs a classifier here; intake then
        # hands op-class messages straight to the owning shard's ring
        # instead of dispatching on this loop (ms_fast_dispatch ->
        # ShardedOpWQ role).  None = classic dispatch, unchanged.
        self.shard_router = None
        # home event loop: the loop this messenger's asyncio state
        # (connections, throttles, intake queues) belongs to.  Sends
        # from a FOREIGN thread (a PG's shard loop) are marshalled
        # back here through a batched courier — one wakeup per burst
        # — so shard threads never touch loop-affine state directly.
        self._home_loop: Optional[asyncio.AbstractEventLoop] = None
        self._home_thread: Optional[int] = None
        self._out_courier = None
        self._xthread_msgs = 0
        self._xthread_flushes = 0
        try:
            self._capture_home_loop()
        except RuntimeError:
            pass        # bound later (bind/add_dispatcher re-capture)

    # --- setup ---
    def _capture_home_loop(self) -> None:
        self._home_loop = asyncio.get_running_loop()
        self._home_thread = threading.get_ident()

    def _on_home_thread(self) -> bool:
        """True when the caller may touch this messenger's asyncio
        state directly.  A messenger never bound to a loop yet behaves
        classically (single-threaded by construction)."""
        return self._home_thread is None \
            or self._home_thread == threading.get_ident()

    def add_dispatcher(self, d: Dispatcher) -> None:
        if self._home_loop is None:
            try:
                self._capture_home_loop()
            except RuntimeError:
                pass
        self.dispatchers.append(d)

    def set_policy(self, entity_type: str, policy: Policy) -> None:
        """Delivery policy for connections TO peers of entity_type
        (Messenger::set_policy); overwrites any earlier setting."""
        self.policies[entity_type] = policy

    def _policy_for(self, peer_type: Optional[str]) -> Policy:
        if peer_type is not None and peer_type in self.policies:
            return self.policies[peer_type]
        return self.default_policy

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> EntityAddr:
        self._capture_home_loop()
        self._server = await asyncio.start_server(
            self._handle_incoming, host, port)
        sock = self._server.sockets[0]
        bound_host, bound_port = sock.getsockname()[:2]
        self.addr = EntityAddr(bound_host, bound_port, self.nonce)
        _LOCAL_ENDPOINTS[self.addr.without_nonce()] = self
        self.log.debug(f"{self.name} bound at {self.addr}")
        return self.addr

    # --- send path ---
    def send_message(self, msg: Message, addr: EntityAddr,
                     peer_type: Optional[str] = None) -> None:
        """Queue msg for addr; never blocks (Messenger.h:466 contract).
        peer_type selects the delivery policy for a NEW connection (e.g.
        "client" when replying to a lossy client); existing connections
        keep the policy they were created with.

        Thread-safe: a call from a foreign thread (a PG's shard loop,
        osd/shards.py) is marshalled to the home loop through a
        batched courier — the send itself, and therefore every
        connection/queue touch, always runs on the home loop."""
        if not self._on_home_thread():
            self._post_home(self.send_message, msg, addr, peer_type)
            return
        key = addr.without_nonce()
        conn = self.conns.get(key)
        if conn is None or conn.closed:
            peer = self._local_peer(addr)
            if peer is not None:
                conn = LocalConnection(self, addr, peer)
            else:
                conn = Connection(self, addr,
                                  self._policy_for(peer_type), peer_type)
                conn.start()
            self.conns[key] = conn
        self._msgs_sent += 1
        conn.send(msg)

    def _post_home(self, fn, *args) -> None:
        """Batched cross-thread marshalling onto the home loop (one
        call_soon_threadsafe wakeup per burst, not per message)."""
        from ceph_tpu_torch.osd.shards import Courier
        # gil-atomic:begin _out_courier,_xthread_msgs runs on the
        # POSTING shard thread by construction: the lazy courier init
        # races benignly (two shards can each build one; the second
        # store wins and the loser's courier drains its own posts —
        # both target the same home loop), and the counter is a
        # stats-only RMW whose drift under contention is accepted
        courier = self._out_courier
        if courier is None:
            # constructed lazily FROM a shard thread: the home thread
            # must be passed explicitly or the courier would treat the
            # constructing shard as "same thread" and skip the
            # cross-thread wakeup
            courier = self._out_courier = Courier(
                self._home_loop, f"{self.name}-out",
                thread_ident=self._home_thread)
            courier.on_flush = self._note_xthread_flush
        self._xthread_msgs += 1
        # gil-atomic:end
        courier.post(fn, *args)

    def _note_xthread_flush(self, n: int) -> None:
        self._xthread_flushes += 1

    def _local_peer(self, addr: EntityAddr) -> Optional["Messenger"]:
        """The co-located messenger at addr, when BOTH ends opted into
        ms_local_delivery and nothing requires real wire semantics
        (fault injection, cephx authorizers)."""
        if not self.cfg["ms_local_delivery"]:
            return None
        if self.cfg["ms_inject_socket_failures"] > 0:
            return None
        if self.get_authorizer_cb is not None:
            return None
        peer = _LOCAL_ENDPOINTS.get(addr.without_nonce())
        if peer is None or not peer.cfg["ms_local_delivery"] \
                or peer.cfg["ms_inject_socket_failures"] > 0 \
                or peer.require_authorizer or peer._server is None:
            return None
        return peer

    def get_connection(self, addr: EntityAddr) -> Optional[Connection]:
        return self.conns.get(addr.without_nonce())

    def mark_down(self, addr: EntityAddr) -> None:
        """Tear down the session to addr (Messenger::mark_down)."""
        conn = self.conns.pop(addr.without_nonce(), None)
        if conn is not None:
            conn.closed = True
            conn._kick.set()

    def _drop_connection(self, conn: Connection) -> None:
        cur = self.conns.get(conn.addr.without_nonce())
        if cur is conn:
            del self.conns[conn.addr.without_nonce()]

    def _inject_failure(self) -> bool:
        n = self.cfg["ms_inject_socket_failures"]
        return n > 0 and random.randrange(n) == 0

    # --- receive path (same-process fast path) ---
    def _local_entry(self, conn_id: int):
        ent = self._local_in.get(conn_id)
        if ent is None:
            q: asyncio.Queue = asyncio.Queue()
            # bytes-budget gate bounding THIS sender's intake queue
            # (the role TCP's socket buffer plays); 0/neg = unbounded
            gate = AsyncThrottle("ms_local_intake",
                                 self.cfg["ms_dispatch_throttle_bytes"])
            task = asyncio.get_running_loop().create_task(
                self._local_worker(q, gate, conn_id))
            ent = self._local_in[conn_id] = (q, task, gate)
        return ent

    def _local_intake_gate(self, conn_id: int) -> AsyncThrottle:
        """The producer gate senders must pass (sync get_or_fail on the
        uncongested path, async get from their pump once over budget)."""
        return self._local_entry(conn_id)[2]

    def _local_enqueue(self, peer_name: EntityName, peer_addr: EntityAddr,
                       conn_id: int, msg: Message, cost: int) -> None:
        """Zero-encode intake: `msg` is already the receiver-safe
        local_view; the caller holds `cost` of this queue's gate."""
        self._local_pending[conn_id] = \
            self._local_pending.get(conn_id, 0) + 1
        self._local_entry(conn_id)[0].put_nowait(
            (peer_name, peer_addr, msg, cost))

    async def _local_worker(self, q: asyncio.Queue, gate: AsyncThrottle,
                            conn_id: int) -> None:
        """Drains ONE co-located sender's messages in FIFO order — the
        local twin of a _serve_peer reader, minus everything that only
        exists to survive a real socket (no decode at all now: the view
        object IS the delivery).  Dispatch throttle still applies and,
        as on TCP, stalls only THIS sender's stream while the op budget
        is full — the intake-gate budget is held across that wait, so
        the backpressure reaches the sender.  An idle worker retires
        itself so sender reset/reconnect cycles (fresh conn_ids) can't
        accumulate parked tasks; retirement only happens with the gate
        fully released — a producer acquires the gate and enqueues in
        the same synchronous step, so gate.cur == 0 with an empty queue
        proves no message can slip into the popped entry."""
        while True:
            if not q.empty():
                # burst fast path: drain buffered messages without the
                # per-message wait_for Task/timer overhead (the same
                # no-yield drain a TCP reader gets from buffered frames;
                # throttle awaits below still yield under pressure)
                peer_name, peer_addr, msg, cost = q.get_nowait()
            else:
                try:
                    peer_name, peer_addr, msg, cost = \
                        await asyncio.wait_for(q.get(), 60.0)
                except asyncio.TimeoutError:
                    # retire only when provably drained: q.empty() must
                    # be re-checked here (an UNBOUNDED gate never bumps
                    # cur, so a sender may have enqueued between the
                    # timeout firing and this coroutine resuming); both
                    # checks and the pop are one synchronous step, so
                    # nothing can slip in after them
                    if gate.cur == 0 and q.empty():
                        self._local_in.pop(conn_id, None)
                        return
                    continue   # admitted-not-yet-enqueued producer races
            msg.src_name = peer_name
            msg.src_addr = peer_addr
            msg.transport_id = -conn_id   # local ids: distinct namespace
            msg.recv_stamp = time.monotonic()
            if (self.dispatch_throttle is not None
                    and msg.THROTTLE_DISPATCH
                    and not msg.THROTTLE_SPLIT):
                # op tracing: the live span rode local_view — attribute
                # transit-so-far as `deliver` and the budget wait as
                # `throttle_wait` into THIS daemon's stage histograms
                span = msg._span if self.ctx.tracer.enabled else None
                if span is not None:
                    span.cut("deliver", self.ctx.tracer.hist)
                await self.dispatch_throttle.get(cost)
                msg.throttle_cost = cost
                if span is not None:
                    span.cut("throttle_wait", self.ctx.tracer.hist)
            gate.put(cost)   # message left the intake queue
            try:
                self._dispatch(msg)
            finally:
                left = self._local_pending.get(conn_id, 1) - 1
                self._local_pending[conn_id] = max(0, left)

    # --- receive path ---
    async def _handle_incoming(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        self._in_tasks.add(asyncio.current_task())
        try:
            await self._serve_peer(reader, writer)
        finally:
            self._in_tasks.discard(asyncio.current_task())

    async def _serve_peer(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        # receiver-assigned, unforgeable per-socket id: auth sessions bind
        # to this, never to the banner-claimed src address (which daemons
        # publish in the osdmap and anyone can claim)
        transport_id = self._next_transport_id
        self._next_transport_id += 1
        try:
            (blen,) = struct.unpack("<I",
                                    await reader.readexactly(4))
            dec = Decoder(await reader.readexactly(blen))
            peer_name = dec.struct(EntityName)
            peer_addr = dec.struct(EntityAddr)
            conn_id = dec.u64()
            authorizer = dec.bytes_() if dec.remaining() else b""
        except (OSError, asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        # cephx: validate the authorizer before ANY frame is accepted
        auth_ticket = None
        session_key = None
        if authorizer and self.verify_authorizer_cb is not None:
            try:
                auth_ticket, reply_proof = self.verify_authorizer_cb(
                    authorizer)
                session_key = auth_ticket.session_key
                writer.write(_FRAME_HDR.pack(TAG_AUTH_REPLY,
                                             len(reply_proof)) + reply_proof)
            except Exception as e:
                self.log.warning(
                    f"authorizer from {peer_name} {peer_addr} rejected: "
                    f"{e}")
                writer.close()
                return
        elif authorizer:
            # no verifier armed: tell the connector explicitly so it can
            # downgrade instead of waiting out its proof timeout
            writer.write(_FRAME_HDR.pack(TAG_AUTH_REPLY, 0))
        if self.require_authorizer and auth_ticket is None:
            self.log.warning(
                f"unauthenticated connection from {peer_name} "
                f"{peer_addr} refused (auth required)")
            writer.close()
            return
        # restart detection only applies to BOUND peers: distinct unbound
        # clients all advertise ("", 0) and must not alias each other
        if not peer_addr.is_blank():
            pkey = peer_addr.without_nonce()
            old_nonce = self._peer_nonce.get(pkey)
            if old_nonce is not None and old_nonce != peer_addr.nonce:
                # peer restarted: its seq spaces reset (remote reset event)
                for k in [k for k in self._in_seq if k[0] == old_nonce]:
                    del self._in_seq[k]
                for d in self.dispatchers:
                    d.ms_handle_remote_reset(peer_addr)
            if peer_addr.nonce:
                self._peer_nonce[pkey] = peer_addr.nonce
        # coalesced cumulative acks: frames already buffered in the
        # reader parse back-to-back without yielding, so the flush
        # scheduled via call_soon runs once per drained burst and acks
        # only the LATEST seq — one tiny write (and one peer wakeup)
        # per burst instead of one per message
        acker = _AckBatcher(writer)
        try:
            while True:
                hdr = await reader.readexactly(_FRAME_HDR.size)
                tag, ln = _FRAME_HDR.unpack(hdr)
                payload = await reader.readexactly(ln)
                if self.require_authorizer and auth_ticket is None:
                    # the bar was raised after this connection was
                    # accepted (daemon finished its auth boot): drop the
                    # unauthenticated link so the peer re-handshakes
                    # with a verifiable authorizer (unacked messages
                    # replay signed on its reconnect)
                    self.log.info(
                        f"dropping unauthenticated link from {peer_name} "
                        f"{peer_addr} (authorizer now required)")
                    raise ConnectionError(
                        "authorizer now required; re-handshake")
                if tag == TAG_MSG:
                    if session_key is not None:
                        from ceph_tpu_torch.auth.cephx import (hmac_eq,
                                                         sign_payload)
                        payload, sig = payload[:-16], payload[-16:]
                        if not hmac_eq(sig, sign_payload(session_key,
                                                         payload)):
                            self.log.warning(
                                f"message signature mismatch from "
                                f"{peer_name}")
                            raise ConnectionError("bad message signature")
                    msg = self._parse_frame(payload, peer_name,
                                            peer_addr, conn_id, acker,
                                            auth_ticket, transport_id)
                    if msg is not None:
                        # dispatch throttle (Message.cc throttle hooks /
                        # Policy throttler): stop READING this peer's
                        # socket while the budget is full — TCP pushes
                        # the backpressure to the sender.  Only message
                        # types that opt in (client data ops) count.
                        if (self.dispatch_throttle is not None
                                and msg.THROTTLE_DISPATCH
                                and not msg.THROTTLE_SPLIT):
                            cost = len(payload)
                            span = msg._span
                            if span is not None:
                                span.cut("deliver", self.ctx.tracer.hist)
                            await self.dispatch_throttle.get(cost)
                            msg.throttle_cost = cost
                            if span is not None:
                                span.cut("throttle_wait",
                                         self.ctx.tracer.hist)
                        # sharded data plane: PG-bound wire messages
                        # enqueue onto the owning shard instead of
                        # dispatching on the reader (already
                        # throttled above)
                        if self.shard_router is not None \
                                and self.shard_router.wants(msg):
                            self.shard_router.deliver(msg)
                        else:
                            self._dispatch(msg)
                elif tag == TAG_KEEPALIVE:
                    pass
        except (OSError, asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def _parse_frame(self, payload: bytes, peer_name: EntityName,
                     peer_addr: EntityAddr, conn_id: int,
                     acker: "_AckBatcher",
                     auth_ticket=None,
                     transport_id: Optional[int] = None
                     ) -> Optional[Message]:
        seq, mtype, crc = _MSG_HDR.unpack_from(payload, 0)
        body = payload[_MSG_HDR.size:]
        if zlib.crc32(body) != crc:
            self.log.warning(f"crc mismatch on {mtype} from {peer_name}")
            raise ConnectionError("bad crc")
        # ack first (cumulative, coalesced per burst), then dedupe replays
        acker.note(seq)
        skey = (peer_addr.nonce, conn_id)
        if seq <= self._in_seq.get(skey, 0):
            return None  # replayed duplicate after sender reconnect
        cls = message_class(mtype)
        if cls is None:
            # undecodable deterministically: consume the seq (replaying the
            # same bytes can never succeed) but keep the transport alive
            self.log.warning(f"unknown message type {mtype}")
            self._in_seq[skey] = seq
            return None
        try:
            msg = cls.from_bytes(body)
        except Exception as e:
            self.log.warning(f"decode of {cls.__name__} failed: {e!r}")
            self._in_seq[skey] = seq
            return None
        self._in_seq[skey] = seq   # delivered at-most-once from here on
        msg.seq = seq
        msg.src_name = peer_name
        msg.src_addr = peer_addr
        msg.transport_id = transport_id
        if auth_ticket is not None:
            # transport-authenticated identity (verified authorizer) —
            # dispatchers gate on this, never on the claimed src_name
            msg.auth_entity = auth_ticket.entity
            msg.auth_caps = auth_ticket.caps
        msg.recv_stamp = time.monotonic()
        # op tracing across a REAL wire: adopt the propagated span
        # context so downstream stage cuts attribute into THIS daemon's
        # histograms under the sender's trace (the transit itself stays
        # unattributed — different clocks cannot be differenced safely).
        # Only throttled client-op classes consume an adopted span —
        # replies resolve against the client's own op.span and replica
        # sub-ops record aux stages off the raw ids — so everything
        # else skips the per-message allocation
        if (msg.THROTTLE_DISPATCH and self.ctx.tracer.enabled
                and getattr(msg, "trace_id", 0)):
            msg._span = self.ctx.tracer.adopt(
                msg.trace_id, msg.span_id, t0=msg.recv_stamp)
        return msg

    def _dispatch(self, msg: Message) -> None:
        self._msgs_received += 1
        for d in self.dispatchers:
            try:
                if d.ms_dispatch(msg):
                    return
            except Exception:
                # a buggy dispatcher must not kill the peer transport —
                # but it must not leak the op's intake budget either, or
                # enough failures wedge the whole daemon's intake
                self.log.exception(f"dispatcher {d} failed on {msg}")
                self.put_dispatch_throttle(msg)
                return
        self.log.warning(f"unhandled message {msg}")
        self.put_dispatch_throttle(msg)

    def put_dispatch_throttle(self, msg: Message) -> None:
        """Release a throttled message's budget; owners (the OSD op
        path) call this when the op COMPLETES, unhandled messages
        release immediately.  Thread-safe: a release from a shard
        thread is marshalled to the home loop (the throttle's waiter
        futures belong there), batched one wakeup per burst."""
        cost = getattr(msg, "throttle_cost", 0)
        if cost and self.dispatch_throttle is not None:
            msg.throttle_cost = 0       # idempotent
            if self._on_home_thread():
                self.dispatch_throttle.put(cost)
            else:
                self._post_home(self.dispatch_throttle.put, cost)

    # --- teardown ---
    async def shutdown(self) -> None:
        key = self.addr.without_nonce()
        if _LOCAL_ENDPOINTS.get(key) is self:
            del _LOCAL_ENDPOINTS[key]
        for _, task, gate in list(self._local_in.values()):
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            # admit any sender pump parked on our intake gate so it can
            # observe the deregistered endpoint and reset, instead of
            # hanging on a budget nobody will ever release
            gate.open_wide()
        self._local_in.clear()
        if self._server is not None:
            self._server.close()
        # cancel live peer handlers instead of wait_closed(): waiting would
        # deadlock two messengers shutting down in sequence (each handler
        # only exits when the OTHER side closes its sending socket)
        for t in list(self._in_tasks):
            t.cancel()
        for t in list(self._in_tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        for conn in list(self.conns.values()):
            await conn.close()
        self.conns.clear()
