"""KStore: everything-in-KV object store (the port's copy of
``ceph_tpu.store.kstore``).

Reference parity: os/kstore/KStore.cc (the experimental store that puts
object data, attrs, and omap all in the key-value database — no
filesystem data path; durability and atomicity come entirely from the
KV WAL) and its stripe layout (kstore_default_stripe_size).

Redesign notes:
  * Rides KeyValueDB (store/kv.py): MemDB for tests, FileDB for a
    durable WAL + snapshot — one KVTransaction per ObjectStore
    Transaction keeps the reference's all-or-nothing commit rule
    without a separate journal.
  * Object data is striped into fixed-size chunk records so a small
    overwrite WALs only the touched chunks, not the whole object
    (KStore.cc _do_write stripe loop).
  * Keys are the Encodable byte forms of CollectionId/ObjectId (self-
    delimiting: the encoding starts with its own length, so no oid key
    can be a proper prefix of another); chunk numbers append big-endian
    so a data scan walks a stripe in order.
  * An in-memory (cid -> {oid bytes -> ObjectId}) registry, rebuilt at
    mount from the meta rows, serves collection_list in ghobject sort
    order — the KV itself has no need to sort by hobject like the
    reference's rocksdb comparator does.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.store.kv import FileDB, KeyValueDB, KVTransaction, MemDB
from ceph_tpu_torch.store.objectstore import (NoSuchCollection, NoSuchObject,
                                        ObjectStore, StoreError,
                                        Transaction, TxOp,
                                        OP_NOP, OP_TOUCH, OP_WRITE,
                                        OP_ZERO, OP_TRUNCATE, OP_REMOVE,
                                        OP_SETATTR, OP_SETATTRS,
                                        OP_RMATTR, OP_CLONE,
                                        OP_CLONERANGE2, OP_MKCOLL,
                                        OP_RMCOLL, OP_OMAP_CLEAR,
                                        OP_OMAP_SETKEYS, OP_OMAP_RMKEYS,
                                        OP_OMAP_SETHEADER,
                                        OP_OMAP_RMKEYRANGE,
                                        OP_COLL_MOVE_RENAME,
                                        OP_TRY_RENAME)
from ceph_tpu_torch.store.types import CollectionId, ObjectId

#: column prefixes (KStore.cc PREFIX_DATA/PREFIX_OMAP/...)
P_COLL = "C"       # cid -> b""
P_META = "M"       # cid+oid -> onode (size, xattrs, omap header)
P_DATA = "D"       # cid+oid+chunk#BE -> chunk bytes
P_OMAP = "O"       # cid+oid+okey -> value

STRIPE = 64 * 1024


class _Onode:
    """Per-object metadata row (KStore.cc kstore_onode_t)."""

    __slots__ = ("size", "xattrs", "omap_header")

    def __init__(self, size: int = 0,
                 xattrs: Optional[Dict[str, bytes]] = None,
                 omap_header: bytes = b""):
        self.size = size
        self.xattrs = xattrs if xattrs is not None else {}
        self.omap_header = omap_header

    def to_bytes(self) -> bytes:
        enc = Encoder()
        enc.u64(self.size).bytes_(self.omap_header)
        enc.map_(self.xattrs, lambda e, k: e.string(k),
                 lambda e, v: e.bytes_(v))
        return bytes(enc.buf)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "_Onode":
        dec = Decoder(raw)
        size, header = dec.u64(), dec.bytes_()
        xattrs = dec.map_(lambda d: d.string(), lambda d: d.bytes_())
        return cls(size, xattrs, header)


class _Txn:
    """A KVTransaction plus a dict overlay giving O(1) read-your-writes
    inside one ObjectStore transaction (clone-after-write must see the
    write; same pattern as blockstore's overlay)."""

    __slots__ = ("db", "kvt", "overlay")

    def __init__(self, db: KeyValueDB):
        self.db = db
        self.kvt = db.create_transaction()
        # (prefix, key) -> value | None (None = pending remove)
        self.overlay: Dict[Tuple[str, bytes], Optional[bytes]] = {}

    def set(self, prefix: str, key: bytes, value: bytes) -> None:
        self.kvt.set(prefix, key, value)
        self.overlay[(prefix, key)] = bytes(value)

    def rm(self, prefix: str, key: bytes) -> None:
        self.kvt.rmkey(prefix, key)
        self.overlay[(prefix, key)] = None

    def get(self, prefix: str, key: bytes) -> Optional[bytes]:
        if (prefix, key) in self.overlay:
            return self.overlay[(prefix, key)]
        return self.db.get(prefix, key)

    def scan(self, prefix: str, keyprefix: bytes) -> List[bytes]:
        """Keys under (prefix, keyprefix*) as visible inside the txn:
        an ordered range scan plus pending sets minus removes."""
        keys = set()
        for k, _ in self.db.iterate(prefix, start=keyprefix):
            if not k.startswith(keyprefix):
                break                   # ordered: past the prefix range
            keys.add(k)
        for (p, k), v in self.overlay.items():
            if p != prefix or not k.startswith(keyprefix):
                continue
            if v is None:
                keys.discard(k)
            else:
                keys.add(k)
        return sorted(keys)


class KStore(ObjectStore):
    def __init__(self, path: str = ""):
        super().__init__(path)
        self.db: Optional[KeyValueDB] = None
        # cid -> {oid key bytes -> ObjectId}
        self._objs: Dict[bytes, Dict[bytes, ObjectId]] = {}
        self._committer = None

    # ------------------------------------------------------------ keys
    @staticmethod
    def _ckey(cid: CollectionId) -> bytes:
        return cid.to_bytes()

    @staticmethod
    def _okey(cid: CollectionId, oid: ObjectId) -> bytes:
        return cid.to_bytes() + oid.to_bytes()

    @staticmethod
    def _dkey(okey: bytes, chunk: int) -> bytes:
        return okey + struct.pack(">Q", chunk)

    # ------------------------------------------------------- lifecycle
    def mkfs(self) -> None:
        if self.path:
            FileDB(self.path).close()

    def mount(self) -> None:
        self.db = FileDB(self.path) if self.path else MemDB()
        self._objs = {ck: {} for ck in self.db.keys(P_COLL)}
        for mk in self.db.keys(P_META):
            # cid.to_bytes() is self-delimiting: v u8, compat u8, then
            # a u32 payload length — so 6 + len delimits the cid record
            clen = 6 + struct.unpack("<I", mk[2:6])[0]
            ck, ok = mk[:clen], mk[clen:]
            oid = ObjectId.from_bytes(ok)
            self._objs.setdefault(ck, {})[ok] = oid
        # group commit: transactions apply to memory inline; the commit
        # thread makes the whole backlog durable with ONE WAL fsync
        # (a MemDB substrate has no deferral — log_deferred is a no-op
        # and the thread only groups/orders the commit callbacks)
        from ceph_tpu_torch.store.commit import KVSyncThread
        # static gather base for the barrier-cost auto-tuner (see
        # BlockStore.mount): effective window = ewma(WAL fsync cost)
        # clamped to [0, 4x this]
        self._committer = KVSyncThread("kstore_commit",
                                       kv_sync=self.db.log_deferred,
                                       gather_window=0.001)
        self._committer.start()

    def umount(self) -> None:
        if self._committer is not None:
            self._committer.stop()
            self._committer = None
        if self.db is not None:
            self.db.close()
            self.db = None

    # ---------------------------------------------------------- writes
    def queue_transactions(self, txns: List[Transaction],
                           on_applied=None, on_commit=None) -> None:
        if self._committer is not None and self._committer.dead:
            # dead commit thread = WAL never syncs, acks never fire
            raise StoreError("kstore commit thread is dead")
        tx = _Txn(self.db)
        for txn in txns:
            for op in txn.ops:
                self._apply_op(tx, op)
        # memory-apply now (read-your-writes); WAL durability rides the
        # commit thread so concurrent batches share one fsync
        seq = self.db.submit_deferred(tx.kvt)
        self.applied_seq += 1
        if on_applied:
            on_applied()
        if self._committer is not None:
            self._committer.submit(seq=seq, on_commit=on_commit)
        elif on_commit:
            on_commit()

    def sync(self) -> None:
        if self._committer is not None:
            self._committer.flush()

    def commit_counters(self) -> Dict[str, float]:
        return self._committer.counters() if self._committer else {}

    def _onode(self, tx: _Txn, okey: bytes,
               create: bool) -> Optional[_Onode]:
        raw = tx.get(P_META, okey)
        if raw is not None:
            return _Onode.from_bytes(raw)
        return _Onode() if create else None

    def _put_onode(self, tx: _Txn, cid: CollectionId,
                   oid: ObjectId, on: _Onode) -> None:
        okey = self._okey(cid, oid)
        tx.set(P_META, okey, on.to_bytes())
        self._objs.setdefault(self._ckey(cid), {})[oid.to_bytes()] = oid

    def _read_chunks(self, tx: _Txn, okey: bytes, size: int,
                     off: int, length: int) -> bytes:
        if length < 0 or off + length > size:
            length = max(0, size - off)
        out = bytearray(length)
        pos = off
        while pos < off + length:
            cno, coff = divmod(pos, STRIPE)
            chunk = tx.get(P_DATA, self._dkey(okey, cno)) or b""
            take = min(STRIPE - coff, off + length - pos)
            piece = chunk[coff:coff + take]
            out[pos - off:pos - off + len(piece)] = piece
            pos += take
        return bytes(out)

    def _write_chunks(self, tx: _Txn, okey: bytes, off: int,
                      data: bytes) -> None:
        pos = 0
        while pos < len(data):
            cno, coff = divmod(off + pos, STRIPE)
            take = min(STRIPE - coff, len(data) - pos)
            if coff == 0 and take == STRIPE:
                chunk = data[pos:pos + STRIPE]
            else:
                chunk = bytearray(
                    tx.get(P_DATA, self._dkey(okey, cno))
                    or b"")
                if len(chunk) < coff + take:
                    chunk.extend(b"\x00" * (coff + take - len(chunk)))
                chunk[coff:coff + take] = data[pos:pos + take]
                chunk = bytes(chunk)
            tx.set(P_DATA, self._dkey(okey, cno), chunk)
            pos += take

    def _drop_object(self, tx: _Txn, cid: CollectionId,
                     oid: ObjectId, on: Optional[_Onode]) -> None:
        okey = self._okey(cid, oid)
        if on is not None:
            for cno in range((on.size + STRIPE - 1) // STRIPE):
                tx.rm(P_DATA, self._dkey(okey, cno))
        for k in tx.scan(P_OMAP, okey):
            tx.rm(P_OMAP, k)
        tx.rm(P_META, okey)
        c = self._objs.get(self._ckey(cid))
        if c is not None:
            c.pop(oid.to_bytes(), None)

    def _apply_op(self, tx: _Txn, op: TxOp) -> None:
        code = op.op
        if code == OP_NOP:
            return
        if code == OP_MKCOLL:
            tx.set(P_COLL, self._ckey(op.cid), b"")
            self._objs.setdefault(self._ckey(op.cid), {})
            return
        if code == OP_RMCOLL:
            ck = self._ckey(op.cid)
            for oid in list(self._objs.get(ck, {}).values()):
                self._drop_object(tx, op.cid, oid,
                                  self._onode(
                                      tx, self._okey(op.cid, oid),
                                      create=False))
            tx.rm(P_COLL, ck)
            self._objs.pop(ck, None)
            return
        okey = self._okey(op.cid, op.oid)
        if code == OP_TOUCH:
            self._put_onode(tx, op.cid, op.oid,
                            self._onode(tx, okey, create=True))
            return
        if code in (OP_WRITE, OP_ZERO):
            data = op.data if code == OP_WRITE else b"\x00" * op.length
            on = self._onode(tx, okey, create=True)
            self._write_chunks(tx, okey, op.off, data)
            on.size = max(on.size, op.off + len(data))
            self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_TRUNCATE:
            on = self._onode(tx, okey, create=True)
            size = op.off
            if size < on.size:
                lo = (size + STRIPE - 1) // STRIPE
                for cno in range(lo, (on.size + STRIPE - 1) // STRIPE):
                    tx.rm(P_DATA, self._dkey(okey, cno))
                if size % STRIPE:
                    cno = size // STRIPE
                    chunk = (tx.get(P_DATA,
                                    self._dkey(okey, cno)) or b"")
                    tx.set(P_DATA, self._dkey(okey, cno),
                           chunk[:size % STRIPE])
            on.size = size
            self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_REMOVE:
            self._drop_object(tx, op.cid, op.oid,
                              self._onode(tx, okey, create=False))
            return
        if code == OP_SETATTR:
            on = self._onode(tx, okey, create=True)
            on.xattrs[op.name] = op.data
            self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_SETATTRS:
            on = self._onode(tx, okey, create=True)
            for k, v in op.kv.items():
                on.xattrs[k.decode("utf-8")] = v
            self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_RMATTR:
            on = self._onode(tx, okey, create=False)
            if on is not None:
                on.xattrs.pop(op.name, None)
                self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_CLONE:
            on = self._onode(tx, okey, create=False)
            if on is None:
                return
            dst = self._okey(op.cid, op.oid2)
            self._drop_object(tx, op.cid, op.oid2,
                              self._onode(tx, dst, create=False))
            data = self._read_chunks(tx, okey, on.size, 0, -1)
            self._write_chunks(tx, dst, 0, data)
            for k in tx.scan(P_OMAP, okey):
                tx.set(P_OMAP, dst + k[len(okey):], tx.get(P_OMAP, k))
            self._put_onode(tx, op.cid, op.oid2,
                            _Onode(on.size, dict(on.xattrs),
                                   on.omap_header))
            return
        if code == OP_CLONERANGE2:
            on = self._onode(tx, okey, create=False)
            if on is None:
                return
            data = self._read_chunks(tx, okey, on.size, op.off,
                                     op.length)
            dst_oid = op.oid2
            dkey = self._okey(op.cid, dst_oid)
            don = self._onode(tx, dkey, create=True)
            self._write_chunks(tx, dkey, op.dest_off, data)
            don.size = max(don.size, op.dest_off + len(data))
            self._put_onode(tx, op.cid, dst_oid, don)
            return
        if code in (OP_COLL_MOVE_RENAME, OP_TRY_RENAME):
            on = self._onode(tx, okey, create=False)
            if on is None:
                return
            dst_cid = op.cid2 if code == OP_COLL_MOVE_RENAME else op.cid
            dkey0 = self._okey(dst_cid, op.oid2)
            self._drop_object(tx, dst_cid, op.oid2,
                              self._onode(tx, dkey0, create=False))
            data = self._read_chunks(tx, okey, on.size, 0, -1)
            omap = {k[len(okey):]: tx.get(P_OMAP, k)
                    for k in tx.scan(P_OMAP, okey)}
            self._drop_object(tx, op.cid, op.oid, on)
            dkey = self._okey(dst_cid, op.oid2)
            self._write_chunks(tx, dkey, 0, data)
            for k, v in omap.items():
                tx.set(P_OMAP, dkey + k, v)
            self._put_onode(tx, dst_cid, op.oid2, on)
            return
        if code == OP_OMAP_CLEAR:
            on = self._onode(tx, okey, create=False)
            if on is not None:
                for k in tx.scan(P_OMAP, okey):
                    tx.rm(P_OMAP, k)
                on.omap_header = b""
                self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_OMAP_SETKEYS:
            on = self._onode(tx, okey, create=True)
            for k, v in op.kv.items():
                tx.set(P_OMAP, okey + k, v)
            self._put_onode(tx, op.cid, op.oid, on)
            return
        if code == OP_OMAP_RMKEYS:
            for k in op.keys:
                tx.rm(P_OMAP, okey + k)
            return
        if code == OP_OMAP_RMKEYRANGE:
            first, last = op.keys
            for k in tx.scan(P_OMAP, okey):
                if first <= k[len(okey):] < last:
                    tx.rm(P_OMAP, k)
            return
        if code == OP_OMAP_SETHEADER:
            on = self._onode(tx, okey, create=True)
            on.omap_header = op.data
            self._put_onode(tx, op.cid, op.oid, on)
            return
        # unknown op code: skip (forward compat) — never poison replay

    # ----------------------------------------------------------- reads
    def _require(self, cid: CollectionId, oid: ObjectId) -> _Onode:
        ck = self._ckey(cid)
        if ck not in self._objs:
            raise NoSuchCollection(str(cid))
        raw = self.db.get(P_META, self._okey(cid, oid))
        if raw is None:
            raise NoSuchObject(str(oid))
        return _Onode.from_bytes(raw)

    def read(self, cid, oid, off: int = 0, length: int = -1) -> bytes:
        on = self._require(cid, oid)
        return self._read_chunks(_Txn(self.db), self._okey(cid, oid),
                                 on.size, off, length)

    def stat(self, cid, oid) -> Dict[str, int]:
        return {"size": self._require(cid, oid).size}

    def getattr(self, cid, oid, name: str) -> bytes:
        on = self._require(cid, oid)
        if name not in on.xattrs:
            raise NoSuchObject(f"{oid} xattr {name}")
        return on.xattrs[name]

    def getattrs(self, cid, oid) -> Dict[str, bytes]:
        return dict(self._require(cid, oid).xattrs)

    def omap_get(self, cid, oid) -> Tuple[bytes, Dict[bytes, bytes]]:
        on = self._require(cid, oid)
        okey = self._okey(cid, oid)
        omap = {}
        for k, v in self.db.iterate(P_OMAP, start=okey):
            if not k.startswith(okey):
                break
            omap[k[len(okey):]] = v
        return on.omap_header, omap

    def omap_get_values(self, cid, oid, keys) -> Dict[bytes, bytes]:
        okey = self._okey(cid, oid)
        self._require(cid, oid)
        out = {}
        for k in keys:
            v = self.db.get(P_OMAP, okey + k)
            if v is not None:
                out[k] = v
        return out

    def omap_get_header(self, cid, oid) -> bytes:
        return self._require(cid, oid).omap_header

    def list_collections(self) -> List[CollectionId]:
        return [CollectionId.from_bytes(ck) for ck in self._objs]

    def collection_exists(self, cid) -> bool:
        return self._ckey(cid) in self._objs

    def collection_list(self, cid, start: Optional[ObjectId] = None,
                        max_count: int = 2**31) -> List[ObjectId]:
        ck = self._ckey(cid)
        if ck not in self._objs:
            raise NoSuchCollection(str(cid))
        oids = sorted(self._objs[ck].values(),
                      key=lambda o: o.sort_key())
        if start is not None:
            oids = [o for o in oids if o.sort_key() > start.sort_key()]
        return oids[:max_count]
