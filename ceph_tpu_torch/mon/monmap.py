"""MonMap: the monitor cluster membership map.

Reference parity: mon/MonMap.{h,cc} — named monitors with addresses;
rank = index in name-sorted order; epoch bumps on membership change.

The port's copy of ``ceph_tpu.mon.monmap``: the same bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.msg.types import EntityAddr


class MonMap(Encodable):
    STRUCT_V = 1

    def __init__(self):
        self.epoch = 0
        self.fsid = ""
        self.mons: Dict[str, EntityAddr] = {}   # name -> addr

    def add(self, name: str, addr: EntityAddr) -> None:
        self.mons[name] = addr
        self.epoch += 1

    def remove(self, name: str) -> None:
        self.mons.pop(name, None)
        self.epoch += 1

    def size(self) -> int:
        return len(self.mons)

    def names(self) -> List[str]:
        return sorted(self.mons)

    def rank_of(self, name: str) -> int:
        try:
            return self.names().index(name)
        except ValueError:
            return -1

    def name_of_rank(self, rank: int) -> str:
        return self.names()[rank]

    def addr_of(self, name: str) -> Optional[EntityAddr]:
        return self.mons.get(name)

    def addr_of_rank(self, rank: int) -> EntityAddr:
        return self.mons[self.name_of_rank(rank)]

    def quorum_size(self) -> int:
        return len(self.mons) // 2 + 1

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.epoch).string(self.fsid)
        enc.map_(self.mons, lambda e, k: e.string(k),
                 lambda e, v: e.struct(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "MonMap":
        m = cls()
        m.epoch = dec.u32()
        m.fsid = dec.string()
        m.mons = dec.map_(lambda d: d.string(),
                          lambda d: d.struct(EntityAddr))
        return m

    def __repr__(self):
        return f"MonMap(e{self.epoch}, {self.names()})"
