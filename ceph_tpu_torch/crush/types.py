"""CRUSH data model: buckets, rules, map, tunables.

Reference parity: crush/crush.h:129-232 (crush_map/crush_bucket structs) —
redesigned as plain dataclasses with derived per-alg fields computed by
builder.py.  Weights are 16.16 fixed-point u32 everywhere, device ids are
>= 0 and bucket ids are < 0 with index = -1-id, exactly like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.crush.constants import (BUCKET_ALG_NAMES, BUCKET_STRAW2,
                                      HASH_RJENKINS1, TUNABLE_PROFILES)


def weight_to_fixed(w: float) -> int:
    return int(w * 0x10000)


def fixed_to_weight(w: int) -> float:
    return w / 0x10000


@dataclass
class Bucket(Encodable):
    """One interior node of the hierarchy (crush.h:129-187)."""
    STRUCT_V = 1

    id: int                       # < 0
    alg: int = BUCKET_STRAW2
    hash: int = HASH_RJENKINS1
    type: int = 1                 # bucket type id (host/rack/root...)
    weight: int = 0               # 16.16 total
    items: List[int] = field(default_factory=list)
    # per-alg derived state:
    item_weights: List[int] = field(default_factory=list)  # list/straw/straw2
    sum_weights: List[int] = field(default_factory=list)   # list (cumulative)
    node_weights: List[int] = field(default_factory=list)  # tree (2^depth)
    straws: List[int] = field(default_factory=list)        # straw

    @property
    def size(self) -> int:
        return len(self.items)

    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.id).u8(self.alg).u8(self.hash).u16(self.type)
        enc.u32(self.weight)
        enc.list_(self.items, lambda e, v: e.s32(v))
        enc.list_(self.item_weights, lambda e, v: e.u32(v))
        enc.list_(self.sum_weights, lambda e, v: e.u32(v))
        enc.list_(self.node_weights, lambda e, v: e.u32(v))
        enc.list_(self.straws, lambda e, v: e.u32(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "Bucket":
        b = cls(id=dec.s32(), alg=dec.u8(), hash=dec.u8(), type=dec.u16(),
                weight=dec.u32())
        b.items = dec.list_(lambda d: d.s32())
        b.item_weights = dec.list_(lambda d: d.u32())
        b.sum_weights = dec.list_(lambda d: d.u32())
        b.node_weights = dec.list_(lambda d: d.u32())
        b.straws = dec.list_(lambda d: d.u32())
        return b


@dataclass
class RuleStep(Encodable):
    op: int
    arg1: int = 0
    arg2: int = 0

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.op).s32(self.arg1).s32(self.arg2)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "RuleStep":
        return cls(dec.u32(), dec.s32(), dec.s32())


@dataclass
class Rule(Encodable):
    """crush_rule + crush_rule_mask (crush.h:76-95)."""
    ruleset: int
    type: int                      # replicated / erasure
    min_size: int
    max_size: int
    steps: List[RuleStep] = field(default_factory=list)

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.ruleset).u8(self.type).u8(self.min_size).u8(self.max_size)
        enc.list_(self.steps, lambda e, s: e.struct(s))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "Rule":
        r = cls(dec.u8(), dec.u8(), dec.u8(), dec.u8())
        r.steps = dec.list_(lambda d: RuleStep.decode(d))
        return r


@dataclass
class Tunables:
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1

    @classmethod
    def profile(cls, name: str) -> "Tunables":
        return cls(**TUNABLE_PROFILES[name])


class CrushMap(Encodable):
    """The full map (crush.h:191-232 + CrushWrapper name/type maps)."""
    STRUCT_V = 1

    def __init__(self):
        self.buckets: List[Optional[Bucket]] = []   # index = -1-id
        self.rules: List[Optional[Rule]] = []
        self.max_devices: int = 0
        self.tunables = Tunables()
        # CrushWrapper facade state (CrushWrapper.h): names and types
        self.type_map: Dict[int, str] = {0: "osd", 1: "host", 2: "rack",
                                         3: "row", 4: "room", 5: "datacenter",
                                         10: "root"}
        self.name_map: Dict[int, str] = {}          # item id -> name
        self.rule_name_map: Dict[int, str] = {}     # rule id -> name

    # -- topology accessors -------------------------------------------------
    @property
    def max_buckets(self) -> int:
        return len(self.buckets)

    def bucket(self, item_id: int) -> Optional[Bucket]:
        idx = -1 - item_id
        if 0 <= idx < len(self.buckets):
            return self.buckets[idx]
        return None

    def _invalidate_kernel_cache(self) -> None:
        """Drop the attached batched-kernel compile cache (see
        ops/crush_kernel.compile_rule) — in-place topology mutation
        invalidates compiled level tables."""
        self.__dict__.pop("_kernel_compile_cache", None)
        self.__dict__.pop("_kernel_compile_token", None)

    def add_bucket(self, b: Bucket) -> int:
        self._invalidate_kernel_cache()
        if b.id == 0:  # auto-assign
            b.id = -1 - len(self.buckets)
            self.buckets.append(b)
        else:
            idx = -1 - b.id
            while len(self.buckets) <= idx:
                self.buckets.append(None)
            assert self.buckets[idx] is None, f"bucket id {b.id} in use"
            self.buckets[idx] = b
        return b.id

    def add_rule(self, r: Rule, rule_id: int = -1) -> int:
        self._invalidate_kernel_cache()
        if rule_id < 0:
            rule_id = len(self.rules)
        while len(self.rules) <= rule_id:
            self.rules.append(None)
        self.rules[rule_id] = r
        return rule_id

    def find_rule(self, ruleset: int, type_: int, size: int) -> int:
        """reference: crush_find_rule (mapper.c top) / CrushWrapper."""
        for i, r in enumerate(self.rules):
            if (r is not None and r.ruleset == ruleset and r.type == type_
                    and r.min_size <= size <= r.max_size):
                return i
        return -1

    def name_of(self, item_id: int) -> str:
        return self.name_map.get(
            item_id, f"osd.{item_id}" if item_id >= 0 else f"bucket{item_id}")

    def set_tunables_profile(self, name: str) -> None:
        self._invalidate_kernel_cache()
        self.tunables = Tunables.profile(name)

    # -- encoding ------------------------------------------------------------
    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.max_devices)
        t = self.tunables
        enc.u32(t.choose_local_tries).u32(t.choose_local_fallback_tries)
        enc.u32(t.choose_total_tries).u8(t.chooseleaf_descend_once)
        enc.u8(t.chooseleaf_vary_r).u8(t.chooseleaf_stable)
        enc.u8(t.straw_calc_version)
        enc.list_(self.buckets, lambda e, b: e.opt_struct(b))
        enc.list_(self.rules, lambda e, r: e.opt_struct(r))
        enc.map_(self.type_map, lambda e, k: e.s32(k), lambda e, v: e.string(v))
        enc.map_(self.name_map, lambda e, k: e.s32(k), lambda e, v: e.string(v))
        enc.map_(self.rule_name_map, lambda e, k: e.s32(k),
                 lambda e, v: e.string(v))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "CrushMap":
        m = cls()
        m.max_devices = dec.s32()
        m.tunables = Tunables(
            choose_local_tries=dec.u32(),
            choose_local_fallback_tries=dec.u32(),
            choose_total_tries=dec.u32(),
            chooseleaf_descend_once=dec.u8(),
            chooseleaf_vary_r=dec.u8(),
            chooseleaf_stable=dec.u8(),
            straw_calc_version=dec.u8(),
        )
        m.buckets = dec.list_(lambda d: d.opt_struct(Bucket))
        m.rules = dec.list_(lambda d: d.opt_struct(Rule))
        m.type_map = dec.map_(lambda d: d.s32(), lambda d: d.string())
        m.name_map = dec.map_(lambda d: d.s32(), lambda d: d.string())
        m.rule_name_map = dec.map_(lambda d: d.s32(), lambda d: d.string())
        return m

    def __eq__(self, other):
        return isinstance(other, CrushMap) and self.to_bytes() == other.to_bytes()

    def summary(self) -> str:
        nb = sum(1 for b in self.buckets if b)
        nr = sum(1 for r in self.rules if r)
        return (f"CrushMap(devices<{self.max_devices}, buckets={nb}, "
                f"rules={nr}, algs={sorted({BUCKET_ALG_NAMES[b.alg] for b in self.buckets if b})})")
