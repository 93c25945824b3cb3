"""OSD data-plane and peering messages.

Reference parity: messages/MOSDOp.h, MOSDOpReply.h, MOSDRepOp{,Reply}.h,
MOSDECSubOpWrite/Read{,Reply}.h, MOSDPing.h, MOSDPGQuery/Notify/Log/
Info/Trim.h, MOSDPGPush/Pull.h.  Op payloads are op-code vectors like
the reference's vector<OSDOp> (osd/osd_types.h OSDOp).

The port's copy of ``ceph_tpu.osd.messages``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.msg.message import Message, PRIO_HIGH, register_message
from ceph_tpu_torch.msg.payload import LazyPayload
from ceph_tpu_torch.osd.types import ObjectLocator, PGId

# client/op codes (include/rados.h CEPH_OSD_OP_*; subset the framework
# implements — the interpreter is ReplicatedPG::do_osd_ops :4317)
OP_READ = 1
OP_STAT = 2
OP_ASSERT_EXISTS = 3  # fail the op with ENOENT unless the object exists
OP_WRITE = 10
OP_WRITEFULL = 11
OP_APPEND = 12
OP_TRUNCATE = 13
OP_ZERO = 14
OP_DELETE = 15
OP_CREATE = 16
OP_ROLLBACK = 17      # restore head from the snap in op.offset
OP_GETXATTR = 20
OP_SETXATTR = 21
OP_RMXATTR = 22
OP_GETXATTRS = 23
OP_CMPXATTR = 24      # guard: stored xattr == op.data else ECANCELED
OP_OMAP_GET_VALS = 30
OP_OMAP_SET = 31
OP_OMAP_RM_KEYS = 32
OP_OMAP_GET_HEADER = 33
OP_OMAP_SET_HEADER = 34
OP_PGLS = 40          # list objects in pg (rados ls)
OP_LIST_SNAPS = 41    # per-object SnapSet dump (librados list_snaps)
OP_WATCH = 50         # op.offset: 1 = watch, 0 = unwatch
OP_NOTIFY = 51        # fan payload out to watchers, gather acks
OP_CALL = 60          # object-class method: op.name = "class.method",
#                       op.data = input (objclass.h CEPH_OSD_OP_CALL)

WRITE_OPS = {OP_WRITE, OP_WRITEFULL, OP_APPEND, OP_TRUNCATE, OP_ZERO,
             OP_DELETE, OP_CREATE, OP_ROLLBACK, OP_SETXATTR, OP_RMXATTR,
             OP_OMAP_SET, OP_OMAP_RM_KEYS, OP_OMAP_SET_HEADER, OP_WATCH}


class OSDOp(Encodable):
    """One sub-op of a client request (osd_types.h OSDOp)."""

    __slots__ = ("op", "offset", "length", "name", "data", "kv", "keys",
                 "rval", "outdata")

    def __init__(self, op: int, offset: int = 0, length: int = 0,
                 name: str = "", data: bytes = b"",
                 kv: Optional[Dict[bytes, bytes]] = None,
                 keys: Optional[List[bytes]] = None):
        self.op = op
        self.offset = offset
        self.length = length
        self.name = name            # xattr name
        self.data = data
        self.kv = kv or {}
        self.keys = keys or []
        # result fields (filled by execution, encoded in replies)
        self.rval = 0
        self.outdata = b""

    def encode_payload(self, enc: Encoder) -> None:
        enc.u16(self.op).u64(self.offset).u64(self.length)
        # data rides the extent pool on the lane transport (handle on
        # the wire, payload in shared memory); outdata stays inline —
        # it flows toward the CLIENT, which must get plain bytes
        enc.string(self.name).data_bytes_(self.data)
        enc.map_(self.kv, lambda e, k: e.bytes_(k), lambda e, v: e.bytes_(v))
        enc.list_(self.keys, lambda e, k: e.bytes_(k))
        enc.s32(self.rval).bytes_(self.outdata)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "OSDOp":
        o = cls(dec.u16(), dec.u64(), dec.u64(), dec.string(),
                dec.data_bytes_(),
                dec.map_(lambda d: d.bytes_(), lambda d: d.bytes_()),
                dec.list_(lambda d: d.bytes_()))
        o.rval = dec.s32()
        o.outdata = dec.bytes_()
        return o

    def is_write(self) -> bool:
        if self.op == OP_CALL:
            # write-ness comes from the method registry (the reference
            # flags CLS_METHOD_WR at registration)
            from ceph_tpu_torch.cls import method_is_write
            return method_is_write(self.name)
        return self.op in WRITE_OPS

    def result_copy(self) -> "OSDOp":
        """Receiver-side copy for zero-encode local delivery: shares the
        immutable request fields (including the data bytes) but owns its
        result fields, so an executing OSD never scribbles rval/outdata
        onto the client's op vector (or a retried twin's)."""
        return OSDOp(self.op, self.offset, self.length, self.name,
                     self.data, self.kv, self.keys)

    def cost(self) -> int:
        n = 64 + len(self.data) + len(self.outdata) + len(self.name)
        for k, v in self.kv.items():
            n += len(k) + len(v)
        for k in self.keys:
            n += len(k)
        return n


class EVersion(Encodable):
    """eversion_t: (epoch, version) — total order on pg log entries."""

    __slots__ = ("epoch", "version")

    def __init__(self, epoch: int = 0, version: int = 0):
        self.epoch = epoch
        self.version = version

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.epoch).u64(self.version)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "EVersion":
        return cls(dec.u32(), dec.u64())

    def key(self):
        return (self.epoch, self.version)

    def __lt__(self, other):
        return self.key() < other.key()

    def __le__(self, other):
        return self.key() <= other.key()

    def __eq__(self, other):
        return isinstance(other, EVersion) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"{self.epoch}'{self.version}"

    @classmethod
    def zero(cls):
        return cls(0, 0)


@register_message
class MOSDOp(Message):
    """Client -> primary OSD op (messages/MOSDOp.h).  v2 adds the snap
    context for writes (snap_seq + existing snap ids) and the read
    snapid (0 = head), mirroring MOSDOp's snapc/snapid fields.  v3 adds
    the optional trace header (trace_id/span_id, 0 = untraced —
    common/tracer.py; blkin trace info role): old decoders skip it via
    struct framing, old bytes decode as untraced.  v4 adds the dmClock
    QoS envelope (common/qos.py): the client CLASS plus the delta/rho
    distributed-feedback counters; old bytes decode as class '' (=
    client, quantum 1).  Riding the payload means the tag survives
    MOSDOpBatch packing and the process-lane IPC hop unchanged — both
    re-encode/decode this frame verbatim."""
    TYPE = 200
    STRUCT_V = 4
    THROTTLE_DISPATCH = True     # client data ops bound OSD intake

    def __init__(self, pgid: Optional[PGId] = None, oid: str = "",
                 loc: Optional[ObjectLocator] = None,
                 ops: Optional[List[OSDOp]] = None, tid: int = 0,
                 map_epoch: int = 0, reqid: str = "",
                 snap_seq: int = 0, snaps: Optional[List[int]] = None,
                 snapid: int = 0):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.oid = oid
        self.loc = loc or ObjectLocator(0)
        self.ops = ops or []
        self.tid = tid
        self.map_epoch = map_epoch
        self.reqid = reqid      # osd_reqid_t: client-unique, resend-stable
        self.snap_seq = snap_seq      # write snapc: newest pool snap seq
        self.snaps = snaps or []      # write snapc: existing snap ids
        self.snapid = snapid          # read target snap (0 = head)
        self.trace_id = 0             # tracer span context (0 = none)
        self.span_id = 0
        self.qos_class = ""           # dmClock class ('' = client)
        self.qos_delta = 1            # ops done anywhere since last
        self.qos_rho = 1              # ...and reservation-phase subset

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).string(self.oid).struct(self.loc)
        enc.list_(self.ops, lambda e, o: e.struct(o))
        enc.u64(self.tid).u32(self.map_epoch).string(self.reqid)
        enc.u64(self.snap_seq)
        enc.list_(self.snaps, lambda e, v: e.u64(v))
        enc.u64(self.snapid)
        enc.u64(self.trace_id).u64(self.span_id)
        enc.string(self.qos_class)
        enc.u32(self.qos_delta).u32(self.qos_rho)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDOp":
        m = cls(dec.struct(PGId), dec.string(), dec.struct(ObjectLocator),
                dec.list_(lambda d: d.struct(OSDOp)), dec.u64(),
                dec.u32(), dec.string())
        if struct_v >= 2:
            m.snap_seq = dec.u64()
            m.snaps = dec.list_(lambda d: d.u64())
            m.snapid = dec.u64()
        if struct_v >= 3:
            m.trace_id = dec.u64()
            m.span_id = dec.u64()
        if struct_v >= 4:
            m.qos_class = dec.string()
            m.qos_delta = dec.u32()
            m.qos_rho = dec.u32()
        return m

    def local_view(self) -> "MOSDOp":
        # copy-on-send: the executing OSD fills rval/outdata in place
        # and the reply carries the SAME op objects back — without this
        # copy a resent op could race two OSDs over one result vector
        view = MOSDOp(self.pgid, self.oid, self.loc,
                      [o.result_copy() for o in self.ops], self.tid,
                      self.map_epoch, self.reqid, self.snap_seq,
                      self.snaps, self.snapid)
        view.trace_id, view.span_id = self.trace_id, self.span_id
        view.qos_class = self.qos_class
        view.qos_delta, view.qos_rho = self.qos_delta, self.qos_rho
        # zero-encode local delivery carries the LIVE span: co-located
        # daemons cut stages on the client's span object directly
        view._span = self._span
        return view

    def local_cost(self) -> int:
        return 128 + sum(o.cost() for o in self.ops)


@register_message
class MOSDOpReply(Message):
    """v2 adds the trace header mirrored back from the request, so a
    wire client can correlate replies to its spans.  v3 adds the
    dmClock phase echo (common/qos.py PHASE_*): which scheduler phase
    served the op, feeding the client's delta/rho counters — old bytes
    decode as phase 0 (untagged)."""
    TYPE = 201
    STRUCT_V = 3

    def __init__(self, tid: int = 0, result: int = 0,
                 ops: Optional[List[OSDOp]] = None, map_epoch: int = 0):
        super().__init__()
        self.tid = tid
        self.result = result
        self.ops = ops or []        # carry back per-op rval/outdata
        self.map_epoch = map_epoch
        self.trace_id = 0
        self.span_id = 0
        self.qos_phase = 0          # PHASE_NONE: no QoS queue on path

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid).s32(self.result)
        enc.list_(self.ops, lambda e, o: e.struct(o))
        enc.u32(self.map_epoch)
        enc.u64(self.trace_id).u64(self.span_id)
        enc.u8(self.qos_phase)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDOpReply":
        m = cls(dec.u64(), dec.s32(),
                dec.list_(lambda d: d.struct(OSDOp)), dec.u32())
        if struct_v >= 2:
            m.trace_id = dec.u64()
            m.span_id = dec.u64()
        if struct_v >= 3:
            m.qos_phase = dec.u8()
        return m

    def local_cost(self) -> int:
        return 128 + sum(o.cost() for o in self.ops)


@register_message
class MOSDRepOp(Message):
    """Primary -> replica transaction (messages/MOSDRepOp.h): the
    ObjectStore transaction + pg log entry to append, carried as LAZY
    payloads (msg/payload.py): live Transaction/LogEntry objects that
    serialize only when a frame actually hits a TCP socket.  The wire
    format is unchanged ([txn bytes][log bytes]); on local delivery the
    receiver gets the sealed object graph and MUST take ``txn()`` (a
    mutable copy) before appending its own save_meta ops.  v2 adds the
    trace header (the primary's span context) so replica-side stage
    records land under the client's trace."""
    TYPE = 202
    STRUCT_V = 2
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 txn=b"", log=b"",
                 version: Optional[EVersion] = None, map_epoch: int = 0):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.txn_payload = LazyPayload.coerce(txn)
        self.log_payload = LazyPayload.coerce(log)
        self.version = version or EVersion()
        self.map_epoch = map_epoch
        self.trace_id = 0
        self.span_id = 0

    def txn(self):
        """Receiver-owned Transaction (mutable copy — copy discipline)."""
        from ceph_tpu_torch.store.objectstore import Transaction
        return self.txn_payload.mutable(Transaction)

    def log_entry(self):
        """The LogEntry to append (immutable: shared zero-copy when
        delivered locally, so its framed-bytes cache is shared too)."""
        from ceph_tpu_torch.osd.pglog import LogEntry
        return self.log_payload.peek(LogEntry)

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid)
        # the txn body (which embeds the object data) rides the extent
        # pool on the lane transport; the log entry is small and stays
        # inline either way (data_bytes_ == bytes_ under threshold)
        enc.data_bytes_(self.txn_payload.bytes())
        enc.data_bytes_(self.log_payload.bytes())
        enc.struct(self.version).u32(self.map_epoch)
        enc.u64(self.trace_id).u64(self.span_id)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDRepOp":
        m = cls(dec.struct(PGId), dec.u64(), dec.data_bytes_(),
                dec.data_bytes_(), dec.struct(EVersion), dec.u32())
        if struct_v >= 2:
            m.trace_id = dec.u64()
            m.span_id = dec.u64()
        return m

    def local_cost(self) -> int:
        return 128 + self.txn_payload.cost() + self.log_payload.cost()


@register_message
class MOSDRepOpReply(Message):
    TYPE = 203
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 result: int = 0, committed: bool = True,
                 from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.result = result
        self.committed = committed
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid).s32(self.result)
        enc.boolean(self.committed).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDRepOpReply":
        return cls(dec.struct(PGId), dec.u64(), dec.s32(), dec.boolean(),
                   dec.s32())


@register_message
class MOSDECSubOpWrite(Message):
    """Primary -> EC shard write (messages/MOSDECSubOpWrite.h): the
    per-shard transaction produced after the EC encode, payload-carried
    like MOSDRepOp (the log-entry payload is SHARED across the whole
    shard fan-out, so it encodes at most once per write).  v2 adds the
    trace header like MOSDRepOp."""
    TYPE = 204
    STRUCT_V = 2
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 txn=b"", log=b"",
                 version: Optional[EVersion] = None, map_epoch: int = 0):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)   # includes target shard
        self.tid = tid
        self.txn_payload = LazyPayload.coerce(txn)
        self.log_payload = LazyPayload.coerce(log)
        self.version = version or EVersion()
        self.map_epoch = map_epoch
        self.trace_id = 0
        self.span_id = 0

    txn = MOSDRepOp.txn
    log_entry = MOSDRepOp.log_entry
    encode_payload = MOSDRepOp.encode_payload
    local_cost = MOSDRepOp.local_cost

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        m = cls(dec.struct(PGId), dec.u64(), dec.data_bytes_(),
                dec.data_bytes_(), dec.struct(EVersion), dec.u32())
        if struct_v >= 2:
            m.trace_id = dec.u64()
            m.span_id = dec.u64()
        return m


@register_message
class MOSDECSubOpWriteReply(Message):
    TYPE = 205
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 result: int = 0, from_shard: int = -1, from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.result = result
        self.from_shard = from_shard
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid).s32(self.result)
        enc.s32(self.from_shard).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        return cls(dec.struct(PGId), dec.u64(), dec.s32(), dec.s32(),
                   dec.s32())


@register_message
class MOSDECSubOpRead(Message):
    """Primary -> shard chunk read: (oid, off, len) list.  v2 adds the
    snap each read targets (clone chunk reads for snapshot decode);
    v3 adds want_ss — the reply carries the shard's SnapSet row so a
    primary whose own meta missed the row (adopted the pg mid-churn)
    can resolve reads-at-snap authoritatively."""
    TYPE = 206
    STRUCT_V = 3
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 reads: Optional[List[Tuple[str, int, int]]] = None,
                 snap: int = 0):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.reads = reads or []
        self.snap = snap              # 0 = head
        self.want_ss = False

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid)
        enc.list_(self.reads, lambda e, r: (e.string(r[0]), e.u64(r[1]),
                                            e.s64(r[2])))
        enc.u64(self.snap)
        enc.boolean(self.want_ss)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        m = cls(dec.struct(PGId), dec.u64(),
                dec.list_(lambda d: (d.string(), d.u64(), d.s64())))
        if struct_v >= 2:
            m.snap = dec.u64()
        if struct_v >= 3:
            m.want_ss = dec.boolean()
        return m


@register_message
class MOSDECSubOpReadReply(Message):
    TYPE = 207
    STRUCT_V = 2
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 from_shard: int = -1, result: int = 0,
                 data: Optional[List[bytes]] = None,
                 attrs: Optional[Dict[str, bytes]] = None):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.from_shard = from_shard
        self.result = result
        self.data = data or []
        self.attrs = attrs or {}
        self.ss = b""        # v2: shard's SnapSet row (want_ss reads)

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid).s32(self.from_shard)
        enc.s32(self.result)
        enc.list_(self.data, lambda e, b: e.bytes_(b))
        enc.map_(self.attrs, lambda e, k: e.string(k),
                 lambda e, v: e.bytes_(v))
        enc.bytes_(self.ss)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        m = cls(dec.struct(PGId), dec.u64(), dec.s32(), dec.s32(),
                dec.list_(lambda d: d.bytes_()),
                dec.map_(lambda d: d.string(), lambda d: d.bytes_()))
        if struct_v >= 2:
            m.ss = dec.bytes_()
        return m

    def local_cost(self) -> int:
        return (128 + sum(len(d) for d in self.data) + len(self.ss)
                + sum(len(k) + len(v) for k, v in self.attrs.items()))


# ------------------------------------------------------------- heartbeats

@register_message
class MOSDPing(Message):
    """osd <-> osd liveness (messages/MOSDPing.h)."""
    TYPE = 208
    PRIORITY = PRIO_HIGH

    PING, PING_REPLY = 1, 2

    def __init__(self, op: int = PING, from_osd: int = -1,
                 map_epoch: int = 0, stamp: float = 0.0):
        super().__init__()
        self.op = op
        self.from_osd = from_osd
        self.map_epoch = map_epoch
        self.stamp = stamp

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.op).s32(self.from_osd).u32(self.map_epoch)
        enc.f64(self.stamp)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDPing":
        return cls(dec.u8(), dec.s32(), dec.u32(), dec.f64())


# ---------------------------------------------------------------- peering

@register_message
class MPGQuery(Message):
    """Primary asks a peer for its pg_info (MOSDPGQuery)."""
    TYPE = 210
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, epoch: int = 0,
                 from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.epoch = epoch
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u32(self.epoch).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGQuery":
        return cls(dec.struct(PGId), dec.u32(), dec.s32())


def _pg_state_payload(v) -> LazyPayload:
    """Coerce a PGInfo/PGLog message field into a LazyPayload.  Bytes
    and payloads pass through (wire/decode path, fan-out sharing); a
    LIVE object is SNAPSHOTTED via its cheap ``mutable_copy`` — the
    sender's pg keeps mutating its info/log after the send, and both
    the lazily-materialized wire bytes and the local-delivery object
    graph must reflect the state at construction time."""
    if isinstance(v, (LazyPayload, bytes, bytearray, memoryview)) \
            or v is None:
        return LazyPayload.coerce(v)
    return LazyPayload.seal(v.mutable_copy())


@register_message
class MPGNotify(Message):
    """Peer replies with (or proactively sends) its pg_info — carried
    as a LAZY payload (msg/payload.py): encodes only at a real TCP
    socket, wire format unchanged (ROADMAP named the MPGLog/MPGNotify
    pre-encode as the cold-path leftover)."""
    TYPE = 211
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, epoch: int = 0,
                 info=b"", from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.epoch = epoch
        self.info_payload = _pg_state_payload(info)
        self.from_osd = from_osd

    def info(self):
        """Receiver-owned PGInfo (mutable copy — copy discipline)."""
        from ceph_tpu_torch.osd.pglog import PGInfo
        return self.info_payload.mutable(PGInfo)

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u32(self.epoch)
        enc.bytes_(self.info_payload.bytes())
        enc.s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGNotify":
        return cls(dec.struct(PGId), dec.u32(), dec.bytes_(), dec.s32())

    def local_cost(self) -> int:
        return 128 + self.info_payload.cost()


@register_message
class MPGLogRequest(Message):
    """Primary asks peer for log entries since a version (MOSDPGLog ask);
    with want_object set it is instead a whole-object pull request
    (MOSDPGPull role)."""
    TYPE = 212
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, epoch: int = 0,
                 since: Optional[EVersion] = None, from_osd: int = -1,
                 want_object: str = "", want_list: bool = False):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.epoch = epoch
        self.since = since or EVersion()
        self.from_osd = from_osd
        self.want_object = want_object
        # ask for a WINDOW of the peer's object listing (backfill scan
        # role, bounded like the reference's BackfillInterval: names
        # AFTER list_after, at most list_max — never the whole PG in
        # one message)
        self.want_list = want_list
        self.list_after = ""
        self.list_max = 0

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u32(self.epoch).struct(self.since)
        enc.s32(self.from_osd).string(self.want_object)
        enc.boolean(self.want_list)
        enc.string(self.list_after).u32(self.list_max)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGLogRequest":
        m = cls(dec.struct(PGId), dec.u32(), dec.struct(EVersion),
                dec.s32(), dec.string(), dec.boolean())
        m.list_after = dec.string()
        m.list_max = dec.u32()
        return m


@register_message
class MPGLog(Message):
    """Log (+info) shipped to a peer (MOSDPGLog): activation / catch-up.

    Both bodies are LAZY payloads: the sender passes its live PGInfo/
    PGLog (snapshotted cheaply at construction — entry objects shared,
    list copied), bytes materialize only at a real TCP socket, and
    co-located receivers take ``info()``/``log()`` mutable copies with
    zero encode/decode.  Wire format is byte-identical to the old
    eager encoding (tests/test_payload.py asserts it)."""
    TYPE = 213
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, epoch: int = 0,
                 info=b"", log=b"",
                 from_osd: int = -1, activate: bool = False,
                 full_resync: bool = False, backfill_done: bool = False):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.epoch = epoch
        self.info_payload = _pg_state_payload(info)
        self.log_payload = _pg_state_payload(log)
        self.from_osd = from_osd
        self.activate = activate
        # backfill-style resync: receiver must drop objects the primary
        # doesn't know about (they will all be re-pushed)
        self.full_resync = full_resync
        # primary confirms every object was pushed — receiver may now
        # persist backfill_complete
        self.backfill_done = backfill_done
        # cursor-resumed backfill: with full_resync, objects with name
        # <= backfill_from are kept (log deltas cover them) and only
        # names beyond the cursor are dropped for re-push
        # (last_backfill resume, PG.h:1911)
        self.backfill_from = ""

    def info(self):
        """Receiver-owned PGInfo (mutable copy — copy discipline)."""
        from ceph_tpu_torch.osd.pglog import PGInfo
        return self.info_payload.mutable(PGInfo)

    def log(self):
        """Receiver-owned PGLog (mutable copy: receivers adopt it as
        their own log and keep appending)."""
        from ceph_tpu_torch.osd.pglog import PGLog
        return self.log_payload.mutable(PGLog)

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u32(self.epoch)
        enc.bytes_(self.info_payload.bytes())
        enc.bytes_(self.log_payload.bytes()).s32(self.from_osd)
        enc.boolean(self.activate).boolean(self.full_resync)
        enc.boolean(self.backfill_done)
        enc.string(self.backfill_from)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGLog":
        m = cls(dec.struct(PGId), dec.u32(), dec.bytes_(), dec.bytes_(),
                dec.s32(), dec.boolean(), dec.boolean(), dec.boolean())
        m.backfill_from = dec.string()
        return m

    def local_cost(self) -> int:
        return (128 + self.info_payload.cost()
                + self.log_payload.cost())


# --------------------------------------------------------------- recovery

@register_message
class MPGPush(Message):
    """Recovery push: full object state to a peer (MOSDPGPush distilled:
    whole-object pushes, no partial chunks).  v2 adds the object's
    SnapSet + clone objects, so a recovered replica can serve
    reads-at-snap (the reference pushes clones as ordinary hobjects;
    here they ride the head's push)."""
    TYPE = 214
    STRUCT_V = 2

    def __init__(self, pgid: Optional[PGId] = None, oid: str = "",
                 version: Optional[EVersion] = None, data: bytes = b"",
                 attrs: Optional[Dict[str, bytes]] = None,
                 omap: Optional[Dict[bytes, bytes]] = None,
                 omap_header: bytes = b"", from_osd: int = -1,
                 deleted: bool = False):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.oid = oid
        self.version = version or EVersion()
        self.data = data
        self.attrs = attrs or {}
        self.omap = omap or {}
        self.omap_header = omap_header
        self.from_osd = from_osd
        self.deleted = deleted
        # BACKFILL pushes advance the receiver's persisted last_backfill
        # cursor to this name (pushes arrive in sorted-name order), so a
        # killed target resumes from the cursor instead of from scratch
        self.backfill_progress = ""
        # v2: snapshot state.  has_snap_state=True means the pusher's
        # snapset/clones below are AUTHORITATIVE (replicated pushes) —
        # the receiver replaces its local state, even with "none".
        # False (EC shard pushes) means "not carried": local snapshot
        # state must be left untouched, not destroyed.
        self.has_snap_state: bool = False
        self.snapset: bytes = b""       # encoded SnapSet (b"" = none)
        self.clones: List[tuple] = []   # [(clone_id, data, attrs)]

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).string(self.oid).struct(self.version)
        enc.bytes_(self.data)
        enc.map_(self.attrs, lambda e, k: e.string(k),
                 lambda e, v: e.bytes_(v))
        enc.map_(self.omap, lambda e, k: e.bytes_(k),
                 lambda e, v: e.bytes_(v))
        enc.bytes_(self.omap_header).s32(self.from_osd)
        enc.boolean(self.deleted)
        enc.string(self.backfill_progress)
        enc.boolean(self.has_snap_state)
        enc.bytes_(self.snapset)
        enc.u32(len(self.clones))
        for cid_, cdata, cattrs in self.clones:
            enc.u64(cid_).bytes_(cdata)
            enc.map_(cattrs, lambda e, k: e.string(k),
                     lambda e, v: e.bytes_(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGPush":
        m = cls(dec.struct(PGId), dec.string(), dec.struct(EVersion),
                dec.bytes_(),
                dec.map_(lambda d: d.string(), lambda d: d.bytes_()),
                dec.map_(lambda d: d.bytes_(), lambda d: d.bytes_()),
                dec.bytes_(), dec.s32(), dec.boolean())
        m.backfill_progress = dec.string()
        if struct_v >= 2:
            m.has_snap_state = dec.boolean()
            m.snapset = dec.bytes_()
            for _ in range(dec.u32()):
                m.clones.append((dec.u64(), dec.bytes_(), dec.map_(
                    lambda d: d.string(), lambda d: d.bytes_())))
        return m

    def local_cost(self) -> int:
        n = 256 + len(self.data) + len(self.omap_header) \
            + len(self.snapset)
        for k, v in self.omap.items():
            n += len(k) + len(v)
        for k, v in self.attrs.items():
            n += len(k) + len(v)
        for _, cdata, cattrs in self.clones:
            n += len(cdata) + sum(len(k) + len(v)
                                  for k, v in cattrs.items())
        return n


@register_message
class MPGPushReply(Message):
    TYPE = 215

    def __init__(self, pgid: Optional[PGId] = None, oid: str = "",
                 from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.oid = oid
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).string(self.oid).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGPushReply":
        return cls(dec.struct(PGId), dec.string(), dec.s32())


@register_message
class MPGObjectList(Message):
    """One WINDOW of a peer's sorted object listing — the backfill
    both-sides scan (reference BackfillInterval, osd/PG.h:1911).
    `truncated` means more names follow after names[-1]."""
    TYPE = 216
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None,
                 names: Optional[list] = None, from_osd: int = -1,
                 truncated: bool = False, after: str = ""):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.names = names or []
        self.from_osd = from_osd
        self.truncated = truncated
        # echoes the request's list_after: the requester correlates
        # windows so a LATE reply from a timed-out earlier attempt
        # can't masquerade as the current window (that aliasing lost
        # objects: a stale partial listing drove the peer-only sweep)
        self.after = after

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid)
        enc.list_(self.names, lambda e, v: e.string(v))
        enc.s32(self.from_osd)
        enc.boolean(self.truncated)
        enc.string(self.after)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGObjectList":
        return cls(dec.struct(PGId), dec.list_(lambda d: d.string()),
                   dec.s32(), dec.boolean(), dec.string())


# ------------------------------------------------------------------ scrub

class ScrubEntry(Encodable):
    """Per-object scrub map row (reference ScrubMap::object,
    osd/osd_types.h): stored size, the digest xattr the write path
    recorded, and — deep scrub only — the crc32c recomputed from the
    bytes on disk."""

    __slots__ = ("size", "stored_crc", "computed_crc")

    def __init__(self, size: int = 0, stored_crc: int = -1,
                 computed_crc: int = -1):
        self.size = size
        self.stored_crc = stored_crc        # -1 = no/invalid digest xattr
        self.computed_crc = computed_crc    # -1 = light scrub (not read)

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.size).s64(self.stored_crc).s64(self.computed_crc)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "ScrubEntry":
        return cls(dec.u64(), dec.s64(), dec.s64())


@register_message
class MPGScrub(Message):
    """Instruct a primary to scrub one PG (mon `ceph pg [deep-]scrub`
    command path; reference PG::sched_scrub / MOSDScrub)."""
    TYPE = 220

    def __init__(self, pgid: Optional[PGId] = None, deep: bool = False,
                 repair: bool = True):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.deep = deep
        self.repair = repair

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).boolean(self.deep).boolean(self.repair)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGScrub":
        return cls(dec.struct(PGId), dec.boolean(), dec.boolean())


@register_message
class MPGScrubScan(Message):
    """Primary -> replica/shard: build and return your scrub map.
    Flows through the PG op queue so it serializes with writes
    (reference chunky-scrub write blocking)."""
    TYPE = 221

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 deep: bool = False, from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.deep = deep
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid).boolean(self.deep)
        enc.s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGScrubScan":
        return cls(dec.struct(PGId), dec.u64(), dec.boolean(), dec.s32())


@register_message
class MPGScrubMap(Message):
    """Replica's scrub map back to the primary (reference MOSDRepScrubMap)."""
    TYPE = 222
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, tid: int = 0,
                 entries: Optional[Dict[str, "ScrubEntry"]] = None,
                 from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.tid = tid
        self.entries = entries or {}
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u64(self.tid)
        enc.map_(self.entries, lambda e, k: e.string(k),
                 lambda e, v: e.struct(v))
        enc.s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGScrubMap":
        return cls(dec.struct(PGId), dec.u64(),
                   dec.map_(lambda d: d.string(),
                            lambda d: d.struct(ScrubEntry)), dec.s32())


# ----------------------------------------------------------- watch/notify

@register_message
class MWatchNotify(Message):
    """OSD -> watching client: a notify fired on an object you watch
    (messages/MWatchNotify.h)."""
    TYPE = 230
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, oid: str = "",
                 notify_id: int = 0, payload: bytes = b"",
                 from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.oid = oid
        self.notify_id = notify_id
        self.payload = payload
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).string(self.oid).u64(self.notify_id)
        enc.bytes_(self.payload).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MWatchNotify":
        return cls(dec.struct(PGId), dec.string(), dec.u64(),
                   dec.bytes_(), dec.s32())

    def local_cost(self) -> int:
        return 128 + len(self.payload)


@register_message
class MWatchNotifyAck(Message):
    """Watching client -> OSD: notify delivered (+ optional reply)."""
    TYPE = 231
    PRIORITY = PRIO_HIGH

    def __init__(self, pgid: Optional[PGId] = None, oid: str = "",
                 notify_id: int = 0, reply: bytes = b""):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.oid = oid
        self.notify_id = notify_id
        self.reply = reply

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).string(self.oid).u64(self.notify_id)
        enc.bytes_(self.reply)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int
                       ) -> "MWatchNotifyAck":
        return cls(dec.struct(PGId), dec.string(), dec.u64(),
                   dec.bytes_())


@register_message
class MPGRemove(Message):
    """Primary -> stray after the PG went clean: delete your copy
    (messages/MOSDPGRemove.h)."""
    TYPE = 232

    def __init__(self, pgid: Optional[PGId] = None, epoch: int = 0,
                 from_osd: int = -1):
        super().__init__()
        self.pgid = pgid or PGId(0, 0)
        self.epoch = epoch
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).u32(self.epoch).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGRemove":
        return cls(dec.struct(PGId), dec.u32(), dec.s32())


@register_message
class MOSDOpBatch(Message):
    """Client -> OSD corked op batch (Objecter op batching, the
    client half of the sharded data plane): ONE wire frame / ONE
    local-delivery handoff carrying N MOSDOps bound for the same OSD,
    amortizing the per-message deliver/ack hops the op tracer blames
    for ~40% of local e2e.  Purely a transport envelope — every inner
    op keeps its own tid/reqid/snap/trace fields and earns its own
    MOSDOpReply; the OSD unpacks at intake and classifies each op to
    its PG's home shard.  Wire format: a list of the inner ops' own
    encoded frames, so the inner format (and its versioning) is
    exactly MOSDOp's."""
    TYPE = 233
    # v2: inner MOSDOp frames are v4 (QoS envelope).  The batch framing
    # itself is unchanged — the bump tracks the inner format so the
    # encoding corpus can tell a v1-era blob from a fresh one.
    STRUCT_V = 2
    THROTTLE_DISPATCH = True     # client data ops bound OSD intake
    THROTTLE_SPLIT = True        # ...accounted PER INNER OP at unpack

    def __init__(self, msgs: Optional[List["MOSDOp"]] = None):
        super().__init__()
        self.msgs: List[MOSDOp] = msgs or []

    def ops_list(self) -> List["MOSDOp"]:
        return list(self.msgs)

    def encode_payload(self, enc: Encoder) -> None:
        enc.list_(self.msgs, lambda e, m: e.bytes_(m.to_bytes()))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDOpBatch":
        return cls(dec.list_(lambda d: MOSDOp.from_bytes(d.bytes_())))

    def local_view(self) -> "MOSDOpBatch":
        # zero-encode local delivery: each inner op takes ITS OWN
        # copy-on-send view (result-vector copies + live span), same
        # discipline as an unbatched send
        return MOSDOpBatch([m.local_view() for m in self.msgs])

    def local_cost(self) -> int:
        return 64 + sum(m.local_cost() for m in self.msgs)


@register_message
class MOSDRepAckBatch(Message):
    """Replica -> primary coalesced commit acks (the server half of
    the corked data plane): ONE frame carrying every MOSDRepOpReply /
    MOSDECSubOpWriteReply a replica produced for one primary in one
    drained commit burst.  The store's completion batching
    (store/commit.py runs a drained group's callbacks in one loop
    callback) means a deep client window commits N rep-txns back to
    back — without coalescing each ack is its own ring frame + wakeup
    + dispatch, and replica_rtt eats the per-hop overhead N times.
    Purely a transport envelope like MOSDOpBatch: inner replies keep
    their own tid/pgid and unpack through the normal dispatch path at
    intake.  Inner frames are [type u16][reply frame] since the two
    reply types mix in one burst."""
    TYPE = 234

    def __init__(self, msgs: Optional[List[Message]] = None):
        super().__init__()
        self.msgs: List[Message] = msgs or []

    def encode_payload(self, enc: Encoder) -> None:
        enc.list_(self.msgs,
                  lambda e, m: e.u16(m.TYPE).bytes_(m.to_bytes()))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDRepAckBatch":
        from ceph_tpu_torch.msg.message import message_class

        def one(d):
            mcls = message_class(d.u16())
            return mcls.from_bytes(d.bytes_())
        return cls(dec.list_(one))

    def local_view(self) -> "MOSDRepAckBatch":
        return MOSDRepAckBatch([m.local_view() for m in self.msgs])

    def local_cost(self) -> int:
        return 64 + sum(m.local_cost() for m in self.msgs)
