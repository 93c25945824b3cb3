"""Journaler: append-only replicated journal over rados objects.

Reference parity: src/journal/Journaler.{h,cc} + ObjectRecorder/
JournalMetadata — a journal is a header object carrying registered
clients and their commit positions, plus numbered data objects holding
framed entries; appenders rotate to a new data object at a size
threshold, tailers replay from a commit position, and trimming removes
data objects every registered client has committed past
(JournalTrimmer).  librbd's journaling feature and rbd-mirror sit on
this exactly as in the reference.

Redesign notes: entry framing is the repo's Encodable (seq + payload,
crc via the messenger-less store path is unnecessary — rados already
checksums); the reference's splay-width multi-object striping of one
active set collapses to a single active object (splay exists to spread
append load across PGs; here the append fan-out win is negligible
against the simpler recovery story).

The port's copy of ``ceph_tpu.journal.journaler``.
"""

from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Dict, List, Optional, Tuple

from ceph_tpu_torch.client.objecter import ObjectOperationError
from ceph_tpu_torch.common.encoding import Decoder, Encoder

OBJECT_SIZE_DEFAULT = 4 << 20


class JournalEntry:
    __slots__ = ("seq", "payload")

    def __init__(self, seq: int, payload: bytes):
        self.seq = seq
        self.payload = payload


def _hdr_oid(journal_id: str) -> str:
    return f"journal.{journal_id}"


def _data_oid(journal_id: str, n: int) -> str:
    return f"journal_data.{journal_id}.{n:016x}"


class Journaler:
    def __init__(self, ioctx, journal_id: str,
                 object_size: int = OBJECT_SIZE_DEFAULT):
        self.io = ioctx
        self.jid = journal_id
        self.object_size = object_size
        # appender state
        self._seq = 0
        self._obj = 0
        self._obj_bytes = 0
        from ceph_tpu_torch.common.lockdep import make_async_lock
        self._lock = make_async_lock(f"journaler:{journal_id}")

    # ------------------------------------------------------------- metadata
    # Every field is its OWN omap key on the header object, so concurrent
    # updaters (appender rotating, mirrors committing, clients
    # registering) each touch one key atomically and cannot clobber each
    # other — the role the reference's cls_journal object class plays.
    async def _get_meta(self) -> dict:
        try:
            omap = await self.io.omap_get(_hdr_oid(self.jid))
        except ObjectOperationError:
            raise KeyError(f"journal {self.jid} does not exist")
        if b"first_obj" not in omap:
            raise KeyError(f"journal {self.jid} does not exist")
        clients = {}
        for k, v in omap.items():
            if k.startswith(b"client."):
                clients[k[7:].decode()] = {
                    "committed_seq": int(v.decode())}
        return {"first_obj": int(omap[b"first_obj"].decode()),
                "active_obj": int(omap[b"active_obj"].decode()),
                "clients": clients}

    async def _put_key(self, key: str, value: str) -> None:
        await self.io.omap_set(_hdr_oid(self.jid),
                               {key.encode(): value.encode()})

    async def create(self) -> None:
        await self.io.write_full(_hdr_oid(self.jid), b"")
        await self._put_key("first_obj", "0")
        await self._put_key("active_obj", "0")

    async def exists(self) -> bool:
        try:
            await self._get_meta()
            return True
        except KeyError:
            return False

    async def remove(self) -> None:
        meta = await self._get_meta()
        for n in range(meta["first_obj"], meta["active_obj"] + 1):
            try:
                await self.io.remove(_data_oid(self.jid, n))
            except ObjectOperationError:
                pass
        await self.io.remove(_hdr_oid(self.jid))

    # -------------------------------------------------------------- clients
    async def register_client(self, client_id: str) -> None:
        """A tailer that participates in trim decisions — atomic
        register-if-absent on the OSD (cls_journal client_register)."""
        import json as _json
        await self.io.exec(_hdr_oid(self.jid), "journal",
                           "client_register",
                           _json.dumps({"id": client_id}).encode())

    async def unregister_client(self, client_id: str) -> None:
        await self.io.omap_rm_keys(_hdr_oid(self.jid),
                                   [f"client.{client_id}".encode()])

    async def _get_client_raw(self, client_id: str):
        try:
            omap = await self.io.omap_get(_hdr_oid(self.jid))
        except ObjectOperationError:
            return None
        raw = omap.get(f"client.{client_id}".encode())
        return int(raw.decode()) if raw is not None else None

    async def commit(self, client_id: str, seq: int) -> None:
        """Record replay progress — the monotonic guard runs ON the OSD
        (cls_journal client_commit), so concurrent replayers can never
        rewind each other's positions."""
        import json as _json
        await self.io.exec(_hdr_oid(self.jid), "journal",
                           "client_commit",
                           _json.dumps({"id": client_id,
                                        "seq": seq}).encode())

    async def get_commit(self, client_id: str) -> int:
        return await self._get_client_raw(client_id) or 0

    async def tail_seq(self) -> int:
        """Highest appended seq (bootstrap position marker)."""
        meta = await self._get_meta()
        top = 0
        async for e in self._iter_object(meta["active_obj"]):
            top = max(top, e.seq)
        if top == 0 and meta["active_obj"] > meta["first_obj"]:
            async for e in self._iter_object(meta["active_obj"] - 1):
                top = max(top, e.seq)
        return top

    # --------------------------------------------------------------- append
    async def _recover_appender(self) -> None:
        """Find the live tail (highest seq + active object fill) after
        open (ObjectRecorder recovery)."""
        meta = await self._get_meta()
        self._obj = meta["active_obj"]
        self._obj_bytes = 0
        self._seq = 0
        async for e in self._iter_object(self._obj):
            self._seq = max(self._seq, e.seq)
        try:
            self._obj_bytes = await self.io.stat(_data_oid(self.jid,
                                                           self._obj))
        except ObjectOperationError:
            self._obj_bytes = 0
        # earlier objects may hold higher... no: seqs are monotone per
        # journal, the active object always has the newest entries
        if self._seq == 0 and self._obj > meta["first_obj"]:
            async for e in self._iter_object(self._obj - 1):
                self._seq = max(self._seq, e.seq)

    async def append(self, payload: bytes) -> int:
        async with self._lock:
            if self._seq == 0 and self._obj_bytes == 0:
                await self._recover_appender()
            self._seq += 1
            enc = Encoder()
            enc.u64(self._seq).bytes_(payload)
            frame = enc.getvalue()
            rec = Encoder().bytes_(frame).getvalue()
            await self.io.write(_data_oid(self.jid, self._obj), rec,
                                offset=self._obj_bytes)
            self._obj_bytes += len(rec)
            if self._obj_bytes >= self.object_size:
                # CAS rotation (cls_journal advance_active): a stale
                # second appender gets ESTALE and refreshes instead of
                # double-advancing the pointer
                import errno as _errno
                import json as _json
                try:
                    await self.io.exec(
                        _hdr_oid(self.jid), "journal", "advance_active",
                        _json.dumps({"expect": self._obj,
                                     "to": self._obj + 1}).encode())
                    self._obj += 1
                    self._obj_bytes = 0
                except ObjectOperationError as e:
                    if e.retcode != -_errno.ESTALE:
                        raise
                    # another appender won the rotation: recover the
                    # REAL tail (object, byte offset, top seq) — blindly
                    # assuming offset 0 would overwrite its records
                    await self._recover_appender()
            return self._seq

    # --------------------------------------------------------------- replay
    async def _iter_object(self, n: int):
        import errno as _errno
        try:
            raw = await self.io.read(_data_oid(self.jid, n))
        except ObjectOperationError as e:
            if e.retcode == -_errno.ENOENT:
                return
            raise   # a transient error must not silently skip (and
            #         later TRIM) a whole object of events
        dec = Decoder(raw)
        while dec.remaining() > 0:
            try:
                frame = dec.bytes_()
                fd = Decoder(frame)
                yield JournalEntry(fd.u64(), fd.bytes_())
            except Exception:
                return   # torn tail of an in-flight append

    async def replay(self, from_seq: int = 0
                     ) -> AsyncIterator[JournalEntry]:
        """Entries with seq > from_seq, in order (JournalPlayer)."""
        meta = await self._get_meta()
        for n in range(meta["first_obj"], meta["active_obj"] + 1):
            async for e in self._iter_object(n):
                if e.seq > from_seq:
                    yield e

    # ----------------------------------------------------------------- trim
    async def trim(self) -> int:
        """Remove whole data objects every client has committed past
        (JournalTrimmer::committed).  Returns objects removed."""
        meta = await self._get_meta()
        if not meta["clients"]:
            return 0
        min_seq = min(c["committed_seq"]
                      for c in meta["clients"].values())
        removed = 0
        n = meta["first_obj"]
        while n < meta["active_obj"]:
            top = 0
            async for e in self._iter_object(n):
                top = max(top, e.seq)
            if top == 0 or top <= min_seq:
                try:
                    await self.io.remove(_data_oid(self.jid, n))
                except ObjectOperationError:
                    pass
                removed += 1
                n += 1
            else:
                break
        if removed:
            import json as _json
            await self.io.exec(_hdr_oid(self.jid), "journal", "trim_to",
                               _json.dumps({"to": n}).encode())
        return removed
