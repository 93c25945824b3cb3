"""Entity addressing for the messenger.

Reference parity: entity_name_t / entity_addr_t (msg/msg_types.h) — every
process is a typed entity ("mon.a", "osd.3", "client.4821") reachable at an
address carrying a nonce that distinguishes process incarnations (so a
restarted daemon at the same ip:port is a new peer).
"""

from __future__ import annotations

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder

ENTITY_TYPE_MON = "mon"
ENTITY_TYPE_OSD = "osd"
ENTITY_TYPE_MDS = "mds"
ENTITY_TYPE_MGR = "mgr"
ENTITY_TYPE_CLIENT = "client"


class EntityName(Encodable):
    __slots__ = ("type", "id")

    def __init__(self, type_: str, id_: str):
        self.type = type_
        self.id = str(id_)

    @classmethod
    def parse(cls, s: str) -> "EntityName":
        t, _, i = s.partition(".")
        return cls(t, i)

    def is_osd(self) -> bool:
        return self.type == ENTITY_TYPE_OSD

    def is_mon(self) -> bool:
        return self.type == ENTITY_TYPE_MON

    def is_client(self) -> bool:
        return self.type == ENTITY_TYPE_CLIENT

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.type).string(self.id)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "EntityName":
        return cls(dec.string(), dec.string())

    def __str__(self):
        return f"{self.type}.{self.id}"

    def __repr__(self):
        return f"EntityName({self})"

    def __hash__(self):
        return hash((self.type, self.id))

    def __eq__(self, other):
        return (isinstance(other, EntityName)
                and self.type == other.type and self.id == other.id)


class EntityAddr(Encodable):
    __slots__ = ("host", "port", "nonce")

    def __init__(self, host: str = "", port: int = 0, nonce: int = 0):
        self.host = host
        self.port = port
        self.nonce = nonce   # process incarnation (pid/random at bind time)

    def is_blank(self) -> bool:
        return not self.host or not self.port

    def without_nonce(self):
        return (self.host, self.port)

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.host).u16(self.port).u64(self.nonce)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "EntityAddr":
        return cls(dec.string(), dec.u16(), dec.u64())

    def __str__(self):
        return f"{self.host}:{self.port}/{self.nonce}"

    def __repr__(self):
        return f"EntityAddr({self})"

    def __hash__(self):
        return hash((self.host, self.port, self.nonce))

    def __eq__(self, other):
        return (isinstance(other, EntityAddr) and self.host == other.host
                and self.port == other.port and self.nonce == other.nonce)
