"""MemStore: in-memory ObjectStore backend (the port's copy of
``ceph_tpu.store.memstore``).

Reference parity: os/memstore/MemStore.cc (RAM-backed fake store used to run
OSD logic without disks).  Holds the canonical Transaction apply semantics
that FileStore reuses.

Apply is TOTAL: mutation ops never raise — destructive ops on missing
targets are no-ops, constructive ops create their collection/object, and
unknown op codes are skipped (forward compat, mirroring encoding's
skip-unknown rule).  This guarantees (a) transactions are atomic in the
only failure mode left (process crash, handled by the WAL), and (b) journal
replay can never poison a mount.  Validity checking (ENOENT for clients
etc.) is the PG/OSD layer's job, as in the reference where FileStore replay
tolerates what the op layer already vetted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.store.objectstore import (
    OP_CLONE, OP_CLONERANGE2, OP_COLL_MOVE_RENAME, OP_MKCOLL, OP_NOP,
    OP_OMAP_CLEAR, OP_OMAP_RMKEYRANGE, OP_OMAP_RMKEYS, OP_OMAP_SETHEADER,
    OP_OMAP_SETKEYS, OP_REMOVE, OP_RMATTR, OP_RMCOLL, OP_SETATTR,
    OP_SETATTRS, OP_TOUCH, OP_TRUNCATE, OP_TRY_RENAME, OP_WRITE, OP_ZERO,
    NoSuchCollection, NoSuchObject, ObjectStore, StoreError, Transaction,
    TxOp,
)
from ceph_tpu_torch.store.types import CollectionId, ObjectId


class Obj:
    __slots__ = ("data", "xattrs", "omap", "omap_header")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: Dict[str, bytes] = {}
        self.omap: Dict[bytes, bytes] = {}
        self.omap_header = b""

    def clone(self) -> "Obj":
        o = Obj()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        o.omap_header = self.omap_header
        return o


class MemStore(ObjectStore):
    #: gather window for the commit thread: RAM has no fsync cost to
    #: batch behind, so a tiny linger is what lets concurrent writers
    #: share one commit batch (and keeps callback ordering pipelined)
    GATHER_WINDOW = 0.0003

    def __init__(self, path: str = ""):
        super().__init__(path)
        self.colls: Dict[CollectionId, Dict[ObjectId, Obj]] = {}
        self.mounted = False
        self._committer = None

    # --- lifecycle ---
    def mkfs(self) -> None:
        self.colls = {}

    def mount(self) -> None:
        from ceph_tpu_torch.store.commit import KVSyncThread
        self._committer = KVSyncThread(
            "memstore_commit", gather_window=self.GATHER_WINDOW,
            # set by the mounting OSD when its sharded data plane is
            # enabled: RAM stores then ack-on-apply (inline commit
            # groups — no barrier exists to wait for); default off =
            # today's threaded handoff, bit-for-bit
            ack_on_apply=getattr(self, "ack_on_apply", False))
        self._committer.start()
        self.mounted = True

    def umount(self) -> None:
        if self._committer is not None:
            self._committer.stop()
            self._committer = None
        self.mounted = False

    # --- write path ---
    def queue_transactions(self, txns, on_applied=None, on_commit=None):
        if self._committer is not None and self._committer.dead:
            # dead commit thread = acks would never fire: fail loudly
            raise StoreError("memstore commit thread is dead")
        for t in txns:
            self._apply(t)
        self.applied_seq += len(txns)
        if on_applied:
            on_applied()
        if on_commit is None:
            return            # memory state IS the committed state
        if self._committer is not None:
            # ride the group-commit thread: callbacks fire in
            # submission order and concurrent batches share one pass,
            # so the OSD's ack pipeline behaves like the durable stores
            self._committer.submit(on_commit=on_commit)
        else:
            on_commit()

    def sync(self) -> None:
        if self._committer is not None:
            self._committer.flush()

    def commit_counters(self) -> Dict[str, float]:
        return self._committer.counters() if self._committer else {}

    # read-path lookups (raise) -----------------------------------------
    def _coll(self, cid) -> Dict[ObjectId, Obj]:
        c = self.colls.get(cid)
        if c is None:
            raise NoSuchCollection(str(cid))
        return c

    def _obj(self, cid, oid) -> Obj:
        o = self._coll(cid).get(oid)
        if o is None:
            raise NoSuchObject(f"{cid}/{oid}")
        return o

    # write-path lookups (total) ----------------------------------------
    def _obj_w(self, cid, oid) -> Obj:
        c = self.colls.setdefault(cid, {})
        o = c.get(oid)
        if o is None:
            o = c[oid] = Obj()
        return o

    def _obj_opt(self, cid, oid) -> Optional[Obj]:
        c = self.colls.get(cid)
        return None if c is None else c.get(oid)

    def _apply(self, txn: Transaction) -> None:
        for op in txn.ops:
            self._apply_op(op)

    @staticmethod
    def _splice(o: Obj, off: int, data: bytes) -> None:
        end = off + len(data)
        if len(o.data) < end:
            o.data.extend(b"\x00" * (end - len(o.data)))
        o.data[off:end] = data

    def _apply_op(self, op: TxOp) -> None:
        code = op.op
        if code == OP_NOP:
            return
        if code == OP_MKCOLL:
            self.colls.setdefault(op.cid, {})
            return
        if code == OP_RMCOLL:
            self.colls.pop(op.cid, None)
            return
        if code == OP_TOUCH:
            self._obj_w(op.cid, op.oid)
            return
        if code == OP_WRITE:
            self._splice(self._obj_w(op.cid, op.oid), op.off, op.data)
            return
        if code == OP_ZERO:
            self._splice(self._obj_w(op.cid, op.oid), op.off,
                         b"\x00" * op.length)
            return
        if code == OP_TRUNCATE:
            o = self._obj_w(op.cid, op.oid)
            size = op.off
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\x00" * (size - len(o.data)))
            return
        if code == OP_REMOVE:
            c = self.colls.get(op.cid)
            if c is not None:
                c.pop(op.oid, None)
            return
        if code == OP_SETATTR:
            self._obj_w(op.cid, op.oid).xattrs[op.name] = op.data
            return
        if code == OP_SETATTRS:
            o = self._obj_w(op.cid, op.oid)
            for k, v in op.kv.items():
                o.xattrs[k.decode("utf-8")] = v
            return
        if code == OP_RMATTR:
            o = self._obj_opt(op.cid, op.oid)
            if o is not None:
                o.xattrs.pop(op.name, None)
            return
        if code == OP_CLONE:
            src = self._obj_opt(op.cid, op.oid)
            if src is not None:
                self.colls[op.cid][op.oid2] = src.clone()
            return
        if code == OP_CLONERANGE2:
            src = self._obj_opt(op.cid, op.oid)
            if src is not None:
                chunk = bytes(src.data[op.off:op.off + op.length])
                self._splice(self._obj_w(op.cid, op.oid2), op.dest_off,
                             chunk)
            return
        if code == OP_COLL_MOVE_RENAME:
            c = self.colls.get(op.cid)
            src = c.pop(op.oid, None) if c is not None else None
            if src is not None:
                self.colls.setdefault(op.cid2, {})[op.oid2] = src
            return
        if code == OP_TRY_RENAME:
            c = self.colls.get(op.cid)
            src = c.pop(op.oid, None) if c is not None else None
            if src is not None:
                c[op.oid2] = src
            return
        if code == OP_OMAP_CLEAR:
            o = self._obj_opt(op.cid, op.oid)
            if o is not None:
                o.omap.clear()
                o.omap_header = b""
            return
        if code == OP_OMAP_SETKEYS:
            self._obj_w(op.cid, op.oid).omap.update(op.kv)
            return
        if code == OP_OMAP_RMKEYS:
            o = self._obj_opt(op.cid, op.oid)
            if o is not None:
                for k in op.keys:
                    o.omap.pop(k, None)
            return
        if code == OP_OMAP_RMKEYRANGE:
            o = self._obj_opt(op.cid, op.oid)
            if o is not None:
                first, last = op.keys
                for k in [k for k in o.omap if first <= k < last]:
                    del o.omap[k]
            return
        if code == OP_OMAP_SETHEADER:
            self._obj_w(op.cid, op.oid).omap_header = op.data
            return
        # unknown op code: skip (forward compat, like encoding's
        # skip-unknown-trailing rule) — never poison WAL replay.

    # --- read path (raises NoSuchCollection/NoSuchObject) ---
    def read(self, cid, oid, off: int = 0, length: int = -1) -> bytes:
        o = self._obj(cid, oid)
        if length < 0:
            return bytes(o.data[off:])
        return bytes(o.data[off:off + length])

    def stat(self, cid, oid) -> Dict[str, int]:
        o = self._obj(cid, oid)
        return {"size": len(o.data), "omap_keys": len(o.omap)}

    def getattr(self, cid, oid, name: str) -> bytes:
        o = self._obj(cid, oid)
        if name not in o.xattrs:
            raise NoSuchObject(f"xattr {name} on {oid}")
        return o.xattrs[name]

    def getattrs(self, cid, oid) -> Dict[str, bytes]:
        return dict(self._obj(cid, oid).xattrs)

    _STATFS_TTL = 5.0

    def statfs(self) -> Dict[str, int]:
        """df-style usage (ObjectStore::statfs): RAM-backed stores
        have no fixed device — total/free report 0 = unknown.  The
        object walk is TTL-cached: the stats reporter calls this every
        tick and deliberately avoids per-tick store walks."""
        import time
        cached = getattr(self, "_statfs_cache", None)
        now = time.monotonic()
        if cached is not None and now - cached[0] < self._STATFS_TTL:
            return cached[1]
        used = sum(len(o.data)
                   for objs in self.colls.values()
                   for o in objs.values())
        out = {"total": 0, "free": 0, "used": used}
        self._statfs_cache = (now, out)
        return out

    def omap_get(self, cid, oid) -> Tuple[bytes, Dict[bytes, bytes]]:
        o = self._obj(cid, oid)
        return o.omap_header, dict(o.omap)

    def omap_get_values(self, cid, oid, keys) -> Dict[bytes, bytes]:
        o = self._obj(cid, oid)
        return {k: o.omap[k] for k in keys if k in o.omap}

    def omap_get_header(self, cid, oid) -> bytes:
        return self._obj(cid, oid).omap_header

    def list_collections(self) -> List[CollectionId]:
        return sorted(self.colls)

    def collection_exists(self, cid) -> bool:
        return cid in self.colls

    def collection_list(self, cid, start: Optional[ObjectId] = None,
                        max_count: int = 2**31) -> List[ObjectId]:
        objs = sorted(self._coll(cid), key=lambda o: o.sort_key())
        if start is not None:
            sk = start.sort_key()
            objs = [o for o in objs if o.sort_key() > sk]
        return objs[:max_count]
