"""Monitor-plane typed messages.

Reference parity: messages/MMonElection.h, MMonPaxos.h, MMonCommand.h,
MMonSubscribe{,Ack}.h, MOSDMap.h, MMonGetMap/MMonMap.h, plus the
osd->mon reports MOSDBoot/MOSDFailure/MOSDAlive (messages/MOSD*.h).
Type codes are framework-local (the wire format is new); semantic fields
mirror the reference.

The port's copy of ``ceph_tpu.mon.messages``: the same 17 type codes and
bytes, registered in the port's own message registry.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, PRIO_HIGH, register_message
from ceph_tpu_torch.msg.types import EntityAddr


# ---------------------------------------------------------------- election

@register_message
class MMonElection(Message):
    TYPE = 100
    PRIORITY = PRIO_HIGH

    OP_PROPOSE, OP_ACK, OP_VICTORY = 1, 2, 3

    def __init__(self, op: int = 0, epoch: int = 0, rank: int = -1,
                 quorum: Optional[List[int]] = None):
        super().__init__()
        self.op = op
        self.epoch = epoch
        self.rank = rank
        self.quorum = quorum or []

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.op).u32(self.epoch).s32(self.rank)
        enc.list_(self.quorum, lambda e, v: e.s32(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MMonElection":
        return cls(dec.u8(), dec.u32(), dec.s32(),
                   dec.list_(lambda d: d.s32()))


# ------------------------------------------------------------------- paxos

@register_message
class MMonPaxos(Message):
    TYPE = 101
    PRIORITY = PRIO_HIGH

    OP_COLLECT, OP_LAST, OP_BEGIN, OP_ACCEPT, OP_COMMIT, OP_LEASE, \
        OP_LEASE_ACK = range(1, 8)

    def __init__(self, op: int = 0, pn: int = 0, first_committed: int = 0,
                 last_committed: int = 0,
                 values: Optional[Dict[int, bytes]] = None,
                 uncommitted_pn: int = 0, lease_until: float = 0.0,
                 epoch: int = 0):
        super().__init__()
        self.op = op
        self.pn = pn                       # proposal number
        self.first_committed = first_committed
        self.last_committed = last_committed
        self.values = values or {}         # version -> encoded txn
        self.uncommitted_pn = uncommitted_pn
        self.lease_until = lease_until     # sender-relative seconds
        self.epoch = epoch                 # election epoch (stale guard)

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.op).u64(self.pn)
        enc.u64(self.first_committed).u64(self.last_committed)
        enc.map_(self.values, lambda e, k: e.u64(k),
                 lambda e, v: e.bytes_(v))
        enc.u64(self.uncommitted_pn).f64(self.lease_until)
        enc.u32(self.epoch)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MMonPaxos":
        return cls(dec.u8(), dec.u64(), dec.u64(), dec.u64(),
                   dec.map_(lambda d: d.u64(), lambda d: d.bytes_()),
                   dec.u64(), dec.f64(), dec.u32())

    def local_cost(self) -> int:
        # byte-budget estimate for the local intake gate (msg/payload.py)
        return 128 + sum(len(v) for v in self.values.values())


# ---------------------------------------------------------------- commands

@register_message
class MMonCommand(Message):
    """CLI/mgmt command: json dict like the reference's cmd vector, plus
    an optional binary input (e.g. an encoded CrushMap for set-map)."""
    TYPE = 102

    def __init__(self, cmd: Optional[dict] = None, tid: int = 0,
                 inbl: bytes = b""):
        super().__init__()
        self.cmd = cmd or {}
        self.tid = tid
        self.inbl = inbl

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid).string(json.dumps(self.cmd, sort_keys=True))
        enc.bytes_(self.inbl)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MMonCommand":
        tid = dec.u64()
        return cls(json.loads(dec.string()), tid, dec.bytes_())


@register_message
class MMonCommandAck(Message):
    TYPE = 103

    def __init__(self, tid: int = 0, retcode: int = 0, outs: str = "",
                 outbl: bytes = b"", leader_hint: int = -1):
        super().__init__()
        self.tid = tid
        self.retcode = retcode
        self.outs = outs            # human-readable status
        self.outbl = outbl          # binary payload (e.g. an encoded map)
        self.leader_hint = leader_hint   # -EAGAIN redirect target rank

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid).s32(self.retcode).string(self.outs)
        enc.bytes_(self.outbl).s32(self.leader_hint)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MMonCommandAck":
        return cls(dec.u64(), dec.s32(), dec.string(), dec.bytes_(),
                   dec.s32())

    def local_cost(self) -> int:
        return 128 + len(self.outbl) + len(self.outs)


# ----------------------------------------------------------- subscriptions

@register_message
class MMonSubscribe(Message):
    """what -> start epoch (deliver everything >= start; 0 = just latest);
    subscriptions are sticky until the session drops (onetime unsupported,
    matching how daemons actually use it)."""
    TYPE = 104

    def __init__(self, what: Optional[Dict[str, int]] = None):
        super().__init__()
        self.what = what or {}

    def encode_payload(self, enc: Encoder) -> None:
        enc.map_(self.what, lambda e, k: e.string(k), lambda e, v: e.u32(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MMonSubscribe":
        return cls(dec.map_(lambda d: d.string(), lambda d: d.u32()))


@register_message
class MMonSubscribeAck(Message):
    TYPE = 105


# --------------------------------------------------------- map distribution

@register_message
class MMonGetMap(Message):
    TYPE = 106


@register_message
class MMonMap(Message):
    TYPE = 107

    def __init__(self, monmap_bytes: bytes = b""):
        super().__init__()
        self.monmap_bytes = monmap_bytes

    def encode_payload(self, enc: Encoder) -> None:
        enc.bytes_(self.monmap_bytes)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MMonMap":
        return cls(dec.bytes_())


@register_message
class MOSDMap(Message):
    """Map epochs: incrementals and/or fulls (messages/MOSDMap.h)."""
    TYPE = 108

    def __init__(self, incrementals: Optional[Dict[int, bytes]] = None,
                 fulls: Optional[Dict[int, bytes]] = None):
        super().__init__()
        self.incrementals = incrementals or {}
        self.fulls = fulls or {}

    def encode_payload(self, enc: Encoder) -> None:
        enc.map_(self.incrementals, lambda e, k: e.u32(k),
                 lambda e, v: e.bytes_(v))
        enc.map_(self.fulls, lambda e, k: e.u32(k), lambda e, v: e.bytes_(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDMap":
        return cls(dec.map_(lambda d: d.u32(), lambda d: d.bytes_()),
                   dec.map_(lambda d: d.u32(), lambda d: d.bytes_()))

    def local_cost(self) -> int:
        return (128 + sum(len(v) for v in self.incrementals.values())
                + sum(len(v) for v in self.fulls.values()))


# ----------------------------------------------------------- osd -> mon

@register_message
class MOSDBoot(Message):
    TYPE = 110

    def __init__(self, osd_id: int = -1, addr: Optional[EntityAddr] = None,
                 boot_epoch: int = 0):
        super().__init__()
        self.osd_id = osd_id
        self.addr = addr or EntityAddr()
        self.boot_epoch = boot_epoch

    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.osd_id).struct(self.addr).u32(self.boot_epoch)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDBoot":
        return cls(dec.s32(), dec.struct(EntityAddr), dec.u32())


@register_message
class MOSDFailure(Message):
    """Peer failure report (messages/MOSDFailure.h); is_failed=False is the
    recovery cancellation (\"still alive\")."""
    TYPE = 111

    def __init__(self, target_osd: int = -1, is_failed: bool = True,
                 epoch: int = 0, failed_for: float = 0.0):
        super().__init__()
        self.target_osd = target_osd
        self.is_failed = is_failed
        self.epoch = epoch
        self.failed_for = failed_for

    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.target_osd).boolean(self.is_failed)
        enc.u32(self.epoch).f64(self.failed_for)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDFailure":
        return cls(dec.s32(), dec.boolean(), dec.u32(), dec.f64())


@register_message
class MOSDAlive(Message):
    """up_thru assertion after peering (messages/MOSDAlive.h)."""
    TYPE = 112

    def __init__(self, osd_id: int = -1, want_epoch: int = 0):
        super().__init__()
        self.osd_id = osd_id
        self.want_epoch = want_epoch

    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.osd_id).u32(self.want_epoch)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MOSDAlive":
        return cls(dec.s32(), dec.u32())


@register_message
class MPGTemp(Message):
    """Primary requests a pg_temp during backfill (MOSDPGTemp.h)."""
    TYPE = 113

    def __init__(self, osd_id: int = -1,
                 pg_temp: Optional[Dict] = None):
        super().__init__()
        self.osd_id = osd_id
        self.pg_temp = pg_temp or {}   # PGId -> [osd]

    def encode_payload(self, enc: Encoder) -> None:
        from ceph_tpu_torch.osd.types import PGId  # local: avoid cycle at import
        enc.s32(self.osd_id)
        enc.u32(len(self.pg_temp))
        for pg in sorted(self.pg_temp):
            enc.struct(pg).list_(self.pg_temp[pg], lambda e, v: e.s32(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGTemp":
        from ceph_tpu_torch.osd.types import PGId
        m = cls(dec.s32())
        for _ in range(dec.u32()):
            pg = dec.struct(PGId)
            m.pg_temp[pg] = dec.list_(lambda d: d.s32())
        return m


@register_message
class MPGStats(Message):
    """OSD -> mon: periodic per-PG + per-OSD statistics
    (messages/MPGStats.h; feeds PGMap aggregation)."""
    TYPE = 114

    def __init__(self, from_osd: int = -1, epoch: int = 0,
                 pg_stats: Optional[List[dict]] = None,
                 osd_stat: Optional[dict] = None):
        super().__init__()
        self.from_osd = from_osd
        self.epoch = epoch
        # per-pg rows: pgid(str), state, num_objects, num_bytes,
        # scrub_errors, log_version
        self.pg_stats = pg_stats or []
        self.osd_stat = osd_stat or {}

    def encode_payload(self, enc: Encoder) -> None:
        import json
        enc.s32(self.from_osd).u32(self.epoch)
        enc.string(json.dumps(self.pg_stats))
        enc.string(json.dumps(self.osd_stat))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MPGStats":
        import json
        return cls(dec.s32(), dec.u32(), json.loads(dec.string()),
                   json.loads(dec.string()))


@register_message
class MLog(Message):
    """Daemon -> mon cluster-log entries (messages/MLog.h; LogClient ->
    LogMonitor path)."""
    TYPE = 115

    def __init__(self, entries: Optional[List[dict]] = None):
        super().__init__()
        # rows: stamp(float), who, level, message
        self.entries = entries or []

    def encode_payload(self, enc: Encoder) -> None:
        import json
        enc.string(json.dumps(self.entries))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MLog":
        import json
        return cls(json.loads(dec.string()))


@register_message
class MAuth(Message):
    """Client -> mon cephx exchange (messages/MAuth.h).  phase 1 requests a
    server challenge; phase 2 carries the key-possession proof and the
    service-ticket wants (CEPHX_GET_AUTH_SESSION_KEY flow)."""
    TYPE = 116

    def __init__(self, entity: str = "", phase: int = 1,
                 client_challenge: bytes = b"", proof: bytes = b"",
                 want: Optional[List[str]] = None, tid: int = 0):
        super().__init__()
        self.entity = entity
        self.phase = phase
        self.client_challenge = client_challenge
        self.proof = proof
        self.want = want if want is not None else []
        self.tid = tid     # round correlator: replies echo it so a slow
        #                    mon's late answer can't cross-wire hunting

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.entity).u8(self.phase)
        enc.bytes_(self.client_challenge).bytes_(self.proof)
        enc.list_(self.want, lambda e, s: e.string(s))
        enc.u64(self.tid)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MAuth":
        return cls(dec.string(), dec.u8(), dec.bytes_(), dec.bytes_(),
                   dec.list_(lambda d: d.string()), dec.u64())


@register_message
class MAuthReply(Message):
    """Mon -> client (messages/MAuthReply.h).  phase 1: server_challenge.
    phase 2: result + payload sealed with the entity key (tickets,
    service secrets)."""
    TYPE = 117

    def __init__(self, phase: int = 1, result: int = 0,
                 server_challenge: bytes = b"", payload: bytes = b"",
                 tid: int = 0):
        super().__init__()
        self.phase = phase
        self.result = result
        self.server_challenge = server_challenge
        self.payload = payload
        self.tid = tid

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.phase).s32(self.result)
        enc.bytes_(self.server_challenge).bytes_(self.payload)
        enc.u64(self.tid)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MAuthReply":
        return cls(dec.u8(), dec.s32(), dec.bytes_(), dec.bytes_(),
                   dec.u64())
