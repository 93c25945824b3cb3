"""PG log + info: per-PG op history for divergence detection and catch-up.

Reference parity: osd/PGLog.h (log entries bounding log-based recovery vs
backfill), osd/osd_types.h pg_info_t / pg_log_entry_t.  Redesign note:
recovery here pushes whole objects (MPGPush), so the missing set is
{oid -> need version}; the reference's byte-granular pulls and have
versions collapse into that.

The port's copy of ``ceph_tpu.osd.pglog``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.osd.messages import EVersion
from ceph_tpu_torch.osd.types import PGId

LOG_MODIFY = 1
LOG_DELETE = 2


class LogEntry(Encodable):
    """Includes the client reqid (osd_reqid_t role) so a re-sent write is
    recognized as already-applied instead of executed twice.

    Entries are immutable once constructed, so their framed encoding is
    cached (_enc): the pg log is re-persisted on EVERY write and
    re-encoding the whole window per op dominated the OSD profile."""

    __slots__ = ("op", "oid", "version", "prior_version", "reqid",
                 "_enc")

    def __init__(self, op: int = LOG_MODIFY, oid: str = "",
                 version: Optional[EVersion] = None,
                 prior_version: Optional[EVersion] = None,
                 reqid: str = ""):
        self.op = op
        self.oid = oid
        self.version = version or EVersion()
        self.prior_version = prior_version or EVersion()
        self.reqid = reqid
        self._enc: Optional[bytes] = None

    def framed_bytes(self) -> bytes:
        """Full ENCODE_START-framed bytes, cached (safe: immutable)."""
        if self._enc is None:
            self._enc = self.to_bytes()
        return self._enc

    def is_delete(self) -> bool:
        return self.op == LOG_DELETE

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.op).string(self.oid)
        enc.struct(self.version).struct(self.prior_version)
        enc.string(self.reqid)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "LogEntry":
        return cls(dec.u8(), dec.string(), dec.struct(EVersion),
                   dec.struct(EVersion), dec.string())

    def __repr__(self):
        return (f"{'del' if self.is_delete() else 'mod'} "
                f"{self.oid}@{self.version}")


# the "backfill finished" cursor sentinel: compares greater than any
# real object name (hobject_t::get_max / last_backfill == MAX role);
# U+10FFFF is the maximum code point so no name can exceed it
#: backfill-cursor sentinel: compares above every VALID object name.
#: Names containing U+10FFFF are rejected at client intake
#: (IoCtx._op) and at the OSD (submit_client_write) — otherwise a name
#: sorting above the sentinel would knock a completed PG's
#: last_backfill off LB_MAX and sit forever beyond the cursor.
LB_MAX = "\U0010ffff"


def valid_object_name(oid: str) -> bool:
    return LB_MAX not in oid


class PGInfo(Encodable):
    """pg_info_t distilled: identity + log bounds + interval history."""

    STRUCT_V = 4

    __slots__ = ("pgid", "last_update", "last_complete", "log_tail",
                 "last_epoch_started", "same_interval_since",
                 "last_backfill", "last_scrub_stamp",
                 "last_deep_scrub_stamp")

    def __init__(self, pgid: Optional[PGId] = None):
        self.pgid = pgid or PGId(0, 0)
        self.last_update = EVersion()      # newest log entry
        self.last_complete = EVersion()    # everything <= this is local
        self.log_tail = EVersion()         # oldest log entry we hold
        self.last_epoch_started = 0        # last epoch the pg went active
        self.same_interval_since = 0       # epoch the acting set last changed
        # per-object backfill cursor (pg_info_t last_backfill,
        # PG.h:1911): every object with name <= last_backfill is
        # up to date locally; names beyond it may be missing or stale.
        # LB_MAX = fully backfilled; "" = a full resync just started.
        # Backfill pushes objects in sorted-name order and advances
        # this, so an interrupted backfill resumes from the cursor
        # instead of starting over, and readers can route per object.
        self.last_backfill = LB_MAX
        # scrub history (pg_info_t history.last_scrub_stamp role), ms
        self.last_scrub_stamp = 0
        self.last_deep_scrub_stamp = 0

    def mutable_copy(self) -> "PGInfo":
        """Cheap field copy (msg/payload.py copy discipline): senders
        snapshot their live info into MPGLog/MPGNotify payloads and
        receivers take their own copy — zero encode on local hops."""
        c = PGInfo(self.pgid)
        c.last_update = self.last_update
        c.last_complete = self.last_complete
        c.log_tail = self.log_tail
        c.last_epoch_started = self.last_epoch_started
        c.same_interval_since = self.same_interval_since
        c.last_backfill = self.last_backfill
        c.last_scrub_stamp = self.last_scrub_stamp
        c.last_deep_scrub_stamp = self.last_deep_scrub_stamp
        return c

    def approx_size(self) -> int:
        """Byte estimate for intake gates (must not force an encode)."""
        return 96 + len(self.last_backfill)

    @property
    def backfill_complete(self) -> bool:
        """Derived view of the cursor (the old PG-level boolean)."""
        return self.last_backfill == LB_MAX

    @backfill_complete.setter
    def backfill_complete(self, value: bool) -> None:
        self.last_backfill = LB_MAX if value else ""

    def is_empty(self) -> bool:
        return self.last_update == EVersion.zero()

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.pgid).struct(self.last_update)
        enc.struct(self.last_complete).struct(self.log_tail)
        enc.u32(self.last_epoch_started).u32(self.same_interval_since)
        enc.boolean(self.backfill_complete)
        enc.u64(self.last_scrub_stamp).u64(self.last_deep_scrub_stamp)
        enc.string(self.last_backfill)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "PGInfo":
        i = cls(dec.struct(PGId))
        i.last_update = dec.struct(EVersion)
        i.last_complete = dec.struct(EVersion)
        i.log_tail = dec.struct(EVersion)
        i.last_epoch_started = dec.u32()
        i.same_interval_since = dec.u32()
        if struct_v >= 2:
            i.backfill_complete = dec.boolean()
        if struct_v >= 3:
            i.last_scrub_stamp = dec.u64()
            i.last_deep_scrub_stamp = dec.u64()
        if struct_v >= 4:
            i.last_backfill = dec.string()
        return i

    def __repr__(self):
        return (f"PGInfo({self.pgid} lu={self.last_update} "
                f"les={self.last_epoch_started} "
                f"sis={self.same_interval_since})")


class PastInterval(Encodable):
    """pg_interval_t (osd_types.h): one closed mapping interval, kept
    from last_epoch_started forward so peering can walk every acting set
    that might have accepted writes (PG::PriorSet)."""

    __slots__ = ("first", "last", "up", "acting", "primary",
                 "maybe_went_rw")

    def __init__(self, first: int = 0, last: int = 0,
                 up: Optional[List[int]] = None,
                 acting: Optional[List[int]] = None,
                 primary: int = -1, maybe_went_rw: bool = False):
        self.first = first
        self.last = last
        self.up = up or []
        self.acting = acting or []
        self.primary = primary
        self.maybe_went_rw = maybe_went_rw

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.first).u32(self.last)
        enc.list_(self.up, lambda e, v: e.s32(v))
        enc.list_(self.acting, lambda e, v: e.s32(v))
        enc.s32(self.primary).boolean(self.maybe_went_rw)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "PastInterval":
        return cls(dec.u32(), dec.u32(), dec.list_(lambda d: d.s32()),
                   dec.list_(lambda d: d.s32()), dec.s32(), dec.boolean())

    def __repr__(self):
        return (f"interval({self.first}-{self.last} acting {self.acting}"
                f"{' rw' if self.maybe_went_rw else ''})")


class PGLog(Encodable):
    """Bounded in-order entry list (osd/PGLog.h)."""

    MAX_ENTRIES = 3000    # osd_max_pg_log_entries flavor

    def __init__(self):
        self.entries: List[LogEntry] = []
        self.tail = EVersion()    # version before the first entry

    @property
    def head(self) -> EVersion:
        return self.entries[-1].version if self.entries else self.tail

    def append(self, e: LogEntry) -> None:
        assert self.head < e.version, (self.head, e.version)
        self.entries.append(e)
        if len(self.entries) > self.MAX_ENTRIES:
            drop = len(self.entries) - self.MAX_ENTRIES
            self.tail = self.entries[drop - 1].version
            del self.entries[:drop]

    def entries_since(self, v: EVersion) -> List[LogEntry]:
        """Entries with version > v; requires v >= tail (else caller must
        backfill)."""
        return [e for e in self.entries if v < e.version]

    def can_catch_up_from(self, v: EVersion) -> bool:
        return self.tail <= v

    def objects_since(self, v: EVersion) -> Dict[str, LogEntry]:
        """Newest entry per object touched after v."""
        out: Dict[str, LogEntry] = {}
        for e in self.entries_since(v):
            out[e.oid] = e
        return out

    def latest_entry_for(self, oid: str) -> Optional[LogEntry]:
        for e in reversed(self.entries):
            if e.oid == oid:
                return e
        return None

    def reqids(self) -> Dict[str, EVersion]:
        """reqid -> version for duplicate-op detection (PGLog dup index)."""
        return {e.reqid: e.version for e in self.entries if e.reqid}

    def mutable_copy(self) -> "PGLog":
        """Cheap snapshot (msg/payload.py copy discipline): the entry
        LIST is copied, the immutable LogEntry objects — and their
        framed-bytes caches — are shared.  Senders snapshot into MPGLog
        payloads (the live log keeps appending after send); receivers
        adopt their own copy."""
        c = PGLog()
        c.entries = list(self.entries)
        c.tail = self.tail
        return c

    def approx_size(self) -> int:
        """Byte estimate for intake gates (must not force an encode)."""
        return 32 + 64 * len(self.entries)

    def merge_from(self, other: "PGLog", since: EVersion) -> List[LogEntry]:
        """Append other's entries newer than ``since`` (== our head when
        catching up); returns the appended entries."""
        added = []
        for e in other.entries:
            if self.head < e.version and since < e.version:
                self.append(e)
                added.append(e)
        return added

    def rewind_to(self, v: EVersion) -> List[LogEntry]:
        """Drop entries newer than v (divergent branch after an
        authoritative log chose a shorter history); returns the dropped
        entries, newest first — their objects need recovery."""
        dropped = []
        while self.entries and v < self.entries[-1].version:
            dropped.append(self.entries.pop())
        return dropped

    def encode_payload(self, enc: Encoder) -> None:
        enc.struct(self.tail)
        enc.u32(len(self.entries))
        buf = enc.buf
        for x in self.entries:
            buf += x.framed_bytes()

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "PGLog":
        log = cls()
        log.tail = dec.struct(EVersion)
        log.entries = dec.list_(lambda d: d.struct(LogEntry))
        return log


class MissingSet:
    """oid -> version needed (pg_missing_t distilled to whole-object
    granularity; see module docstring)."""

    def __init__(self):
        self.items: Dict[str, EVersion] = {}

    def add(self, oid: str, need: EVersion) -> None:
        self.items[oid] = need

    def rm(self, oid: str, at: EVersion) -> None:
        cur = self.items.get(oid)
        if cur is not None and cur <= at:
            del self.items[oid]

    def __contains__(self, oid: str) -> bool:
        return oid in self.items

    def __len__(self):
        return len(self.items)

    def __bool__(self):
        return bool(self.items)

    def __repr__(self):
        return f"Missing({self.items})"
