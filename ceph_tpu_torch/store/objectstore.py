"""ObjectStore: transactional local object persistence API (the port's
copy of ``ceph_tpu.store.objectstore``).

Reference parity: os/ObjectStore.h:68 (collections of objects carrying
byte data + xattrs + omap, mutated only through atomic ``Transaction``
batches with on_applied/on_commit callbacks; factory os/ObjectStore.cc:63).
Redesigned: Transactions are Encodable op-lists (so stores can WAL them
verbatim), apply is synchronous single-writer per store, and completion
callbacks fire in submission order.  Backends: MemStore (tests/OSD logic
without disks) and FileStore (WAL journal + checkpoint, filestore.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.store.types import CollectionId, ObjectId

# op codes (subset of os/ObjectStore.h:345-388 that the data plane uses)
OP_NOP = 0
OP_TOUCH = 9
OP_WRITE = 10
OP_ZERO = 11
OP_TRUNCATE = 12
OP_REMOVE = 13
OP_SETATTR = 14
OP_SETATTRS = 15
OP_RMATTR = 16
OP_CLONE = 17
OP_CLONERANGE2 = 30
OP_MKCOLL = 20
OP_RMCOLL = 21
OP_OMAP_CLEAR = 31
OP_OMAP_SETKEYS = 32
OP_OMAP_RMKEYS = 33
OP_OMAP_SETHEADER = 34
OP_OMAP_RMKEYRANGE = 37
OP_COLL_MOVE_RENAME = 38
OP_TRY_RENAME = 41


class TxOp(Encodable):
    __slots__ = ("op", "cid", "oid", "oid2", "cid2", "off", "length",
                 "dest_off", "name", "data", "kv", "keys")

    def __init__(self, op: int, cid: CollectionId,
                 oid: Optional[ObjectId] = None,
                 oid2: Optional[ObjectId] = None,
                 cid2: Optional[CollectionId] = None,
                 off: int = 0, length: int = 0, dest_off: int = 0,
                 name: str = "", data: bytes = b"",
                 kv: Optional[Dict[bytes, bytes]] = None,
                 keys: Optional[List[bytes]] = None):
        self.op = op
        self.cid = cid
        self.oid = oid
        self.oid2 = oid2
        self.cid2 = cid2
        self.off = off
        self.length = length
        self.dest_off = dest_off
        self.name = name
        self.data = data
        self.kv = kv or {}
        self.keys = keys or []

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.op).struct(self.cid)
        enc.opt_struct(self.oid).opt_struct(self.oid2).opt_struct(self.cid2)
        enc.u64(self.off).u64(self.length).u64(self.dest_off)
        enc.string(self.name).bytes_(self.data)
        enc.map_(self.kv, lambda e, k: e.bytes_(k), lambda e, v: e.bytes_(v))
        enc.list_(self.keys, lambda e, k: e.bytes_(k))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "TxOp":
        op = dec.u8()
        cid = dec.struct(CollectionId)
        oid = dec.opt_struct(ObjectId)
        oid2 = dec.opt_struct(ObjectId)
        cid2 = dec.opt_struct(CollectionId)
        off, length, dest_off = dec.u64(), dec.u64(), dec.u64()
        name, data = dec.string(), dec.bytes_()
        kv = dec.map_(lambda d: d.bytes_(), lambda d: d.bytes_())
        keys = dec.list_(lambda d: d.bytes_())
        return cls(op, cid, oid, oid2, cid2, off, length, dest_off,
                   name, data, kv, keys)


class Transaction(Encodable):
    """Atomic mutation batch (os/ObjectStore.h:209-239 builder methods).

    Lazy-payload copy discipline (msg/payload.py): a txn sealed into a
    message is shared between the sender's store apply, the wire
    encoder, and — under ms_local_delivery — the receivers themselves.
    ``freeze()`` seals it (builders then fail loudly); a receiver that
    must mutate (save_meta appends) takes ``mutable_copy()``, which is
    a shallow op-list copy: TxOps are immutable once built, so sharing
    them is safe and copies stay O(ops), never O(bytes)."""

    __slots__ = ("ops",)

    def __init__(self):
        self.ops: List[TxOp] = []

    def empty(self) -> bool:
        return not self.ops

    def freeze(self) -> "Transaction":
        """Seal against mutation: ops becomes a tuple, so any builder
        append raises AttributeError (freeze-and-assert)."""
        if isinstance(self.ops, list):
            self.ops = tuple(self.ops)
        return self

    @property
    def frozen(self) -> bool:
        return isinstance(self.ops, tuple)

    def mutable_copy(self) -> "Transaction":
        t = Transaction()
        t.ops = list(self.ops)
        return t

    def approx_size(self) -> int:
        """Byte-budget estimate without encoding (intake gates)."""
        n = 32
        for op in self.ops:
            n += 64 + len(op.data) + len(op.name)
            for k, v in op.kv.items():
                n += len(k) + len(v)
            for k in op.keys:
                n += len(k)
        return n

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    # --- builders ---
    def nop(self):
        self.ops.append(TxOp(OP_NOP, CollectionId.meta())); return self

    def touch(self, cid, oid):
        self.ops.append(TxOp(OP_TOUCH, cid, oid)); return self

    def write(self, cid, oid, off: int, data: bytes):
        self.ops.append(TxOp(OP_WRITE, cid, oid, off=off,
                             length=len(data), data=bytes(data)))
        return self

    def zero(self, cid, oid, off: int, length: int):
        self.ops.append(TxOp(OP_ZERO, cid, oid, off=off, length=length))
        return self

    def truncate(self, cid, oid, size: int):
        self.ops.append(TxOp(OP_TRUNCATE, cid, oid, off=size)); return self

    def remove(self, cid, oid):
        self.ops.append(TxOp(OP_REMOVE, cid, oid)); return self

    def setattr(self, cid, oid, name: str, value: bytes):
        self.ops.append(TxOp(OP_SETATTR, cid, oid, name=name,
                             data=bytes(value)))
        return self

    def setattrs(self, cid, oid, attrs: Dict[str, bytes]):
        kv = {k.encode("utf-8"): bytes(v) for k, v in attrs.items()}
        self.ops.append(TxOp(OP_SETATTRS, cid, oid, kv=kv)); return self

    def rmattr(self, cid, oid, name: str):
        self.ops.append(TxOp(OP_RMATTR, cid, oid, name=name)); return self

    def clone(self, cid, oid, newoid):
        self.ops.append(TxOp(OP_CLONE, cid, oid, oid2=newoid)); return self

    def clone_range(self, cid, oid, newoid, srcoff, length, dstoff):
        self.ops.append(TxOp(OP_CLONERANGE2, cid, oid, oid2=newoid,
                             off=srcoff, length=length, dest_off=dstoff))
        return self

    def create_collection(self, cid):
        self.ops.append(TxOp(OP_MKCOLL, cid)); return self

    def remove_collection(self, cid):
        self.ops.append(TxOp(OP_RMCOLL, cid)); return self

    def collection_move_rename(self, oldcid, oldoid, newcid, newoid):
        self.ops.append(TxOp(OP_COLL_MOVE_RENAME, oldcid, oldoid,
                             oid2=newoid, cid2=newcid))
        return self

    def try_rename(self, cid, oldoid, newoid):
        self.ops.append(TxOp(OP_TRY_RENAME, cid, oldoid, oid2=newoid))
        return self

    def omap_clear(self, cid, oid):
        self.ops.append(TxOp(OP_OMAP_CLEAR, cid, oid)); return self

    def omap_setkeys(self, cid, oid, kv: Dict[bytes, bytes]):
        self.ops.append(TxOp(OP_OMAP_SETKEYS, cid, oid,
                             kv={bytes(k): bytes(v) for k, v in kv.items()}))
        return self

    def omap_rmkeys(self, cid, oid, keys):
        self.ops.append(TxOp(OP_OMAP_RMKEYS, cid, oid,
                             keys=[bytes(k) for k in keys]))
        return self

    def omap_rmkeyrange(self, cid, oid, first: bytes, last: bytes):
        self.ops.append(TxOp(OP_OMAP_RMKEYRANGE, cid, oid,
                             keys=[bytes(first), bytes(last)]))
        return self

    def omap_setheader(self, cid, oid, header: bytes):
        self.ops.append(TxOp(OP_OMAP_SETHEADER, cid, oid,
                             data=bytes(header)))
        return self

    def encode_payload(self, enc: Encoder) -> None:
        enc.list_(self.ops, lambda e, op: e.struct(op))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "Transaction":
        t = cls()
        t.ops = dec.list_(lambda d: d.struct(TxOp))
        return t


class StoreError(Exception):
    pass


class NoSuchCollection(StoreError):
    pass


class NoSuchObject(StoreError):
    pass


class ObjectStore:
    """Abstract store (factory: create())."""

    def __init__(self, path: str = ""):
        self.path = path
        self.applied_seq = 0

    @staticmethod
    def create(kind: str, path: str = "") -> "ObjectStore":
        # reference factory os/ObjectStore.cc:63-87
        from ceph_tpu_torch.store.memstore import MemStore
        from ceph_tpu_torch.store.filestore import FileStore
        if kind == "memstore":
            return MemStore(path)
        if kind == "filestore":
            return FileStore(path)
        if kind == "blockstore":
            from ceph_tpu_torch.store.blockstore import BlockStore
            return BlockStore(path)
        if kind == "kstore":
            from ceph_tpu_torch.store.kstore import KStore
            return KStore(path)
        raise ValueError(f"unknown objectstore kind {kind!r}")

    # lifecycle
    def mkfs(self) -> None: ...
    def mount(self) -> None: ...
    def umount(self) -> None: ...

    # writes
    def queue_transactions(
            self, txns: List[Transaction],
            on_applied: Optional[Callable[[], None]] = None,
            on_commit: Optional[Callable[[], None]] = None) -> None:
        raise NotImplementedError

    def apply_transaction(self, txn: Transaction) -> None:
        """Apply txn and return once it is DURABLE: queue + drain the
        commit pipeline.  Callers that can tolerate deferred durability
        (the OSD's hot write path) use queue_transactions with an
        on_commit callback instead and keep working while the group
        commits."""
        self.queue_transactions([txn])
        self.sync()

    def sync(self) -> None:
        """Block until every queued transaction is durable (the
        reference ObjectStore::sync / flush_commit role).  Stores with
        synchronous commit have nothing to wait for."""

    def commit_counters(self) -> Dict[str, float]:
        """Group-commit pipeline counters (commit_batches, txns,
        fsyncs, txns_per_batch, ...); empty for synchronous stores."""
        return {}

    # reads
    def read(self, cid, oid, off: int = 0, length: int = -1) -> bytes:
        raise NotImplementedError

    def stat(self, cid, oid) -> Dict[str, int]:
        raise NotImplementedError

    def exists(self, cid, oid) -> bool:
        try:
            self.stat(cid, oid)
            return True
        except StoreError:
            return False

    def getattr(self, cid, oid, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid, oid) -> Dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid, oid) -> Tuple[bytes, Dict[bytes, bytes]]:
        raise NotImplementedError

    def omap_get_values(self, cid, oid, keys) -> Dict[bytes, bytes]:
        omap = self.omap_get(cid, oid)[1]
        return {k: omap[k] for k in keys if k in omap}

    def omap_get_header(self, cid, oid) -> bytes:
        """Header-only read; backends override so hot per-object cls
        methods don't materialize the whole omap for it."""
        return self.omap_get(cid, oid)[0]

    def list_collections(self) -> List[CollectionId]:
        raise NotImplementedError

    def collection_exists(self, cid) -> bool:
        return cid in self.list_collections()

    def collection_list(self, cid, start: Optional[ObjectId] = None,
                        max_count: int = 2**31) -> List[ObjectId]:
        raise NotImplementedError
