"""BlockStore: raw-block-file object store with extent allocation,
per-extent checksums and copy-on-write crash consistency (the port's copy
of ``ceph_tpu.store.blockstore``; its block file and kv image are
byte-identical to the JAX package's, so either package mounts a store the
other wrote).

Reference parity: os/bluestore/BlueStore.{h,cc} — objects live as extent
maps over a raw block device with metadata in a kv store, not as files
in a filesystem (src/os/bluestore/BlueStore.cc, Allocator.h,
bluestore_types.h onode/extent/blob).  The role split is kept:
``block`` is the data device, FileDB (WAL + snapshot) plays rocksdb,
onodes carry the logical->disk extent map, and the allocator
hands out min_alloc-sized extents.

Redesign notes (vs the C++ original):
  * Crash consistency is pure COW ordering instead of BlueStore's
    deferred-write journal: new data always lands in FRESHLY allocated
    blocks, the block file is fsync'd, and only then does the metadata
    batch (onode updates) commit through the kv WAL.  A crash between
    the two leaks unreferenced blocks — which the mount-time allocator
    rebuild reclaims for free, playing FreelistManager without any
    persistent freelist to keep transactional.
  * Deferred small-write optimization is dropped: it exists to dodge
    HDD seek latency; the RMW a sub-block overwrite pays here is one
    pread + one pwrite into a fresh block.
  * Every extent stores a crc32c over its live bytes (bluestore csum);
    reads verify and raise on mismatch, which the scrub deep pass
    surfaces as a shard error instead of silently returning rot.
  * clone copies extents (no shared-blob refcounting); clone_range and
    zero/truncate trim or copy at extent granularity.
  * Commit is a group-committed pipeline (BlueStore kv_sync_thread):
    queue_transactions applies data (pwrite) and metadata (kv memory)
    inline — immediately readable — and a dedicated commit thread
    issues ONE data fsync + ONE atomic kv WAL submit for every batch in
    flight, preserving data-before-metadata and submission order, then
    fires on_commit callbacks back on the event loop.  Freed COW blocks
    return to the allocator only after their dereferencing metadata is
    durable.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.crc import crc32c
from ceph_tpu_torch.common.xxhash import xxh32, xxh64
from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder
from ceph_tpu_torch.store.commit import KVSyncThread
from ceph_tpu_torch.store.kv import FileDB, KVTransaction
from ceph_tpu_torch.store.objectstore import (
    NoSuchCollection, NoSuchObject, ObjectStore, StoreError, Transaction,
    OP_NOP, OP_TOUCH, OP_WRITE, OP_ZERO, OP_TRUNCATE, OP_REMOVE,
    OP_SETATTR, OP_SETATTRS, OP_RMATTR, OP_CLONE, OP_CLONERANGE2,
    OP_MKCOLL, OP_RMCOLL, OP_OMAP_CLEAR, OP_OMAP_SETKEYS, OP_OMAP_RMKEYS,
    OP_OMAP_SETHEADER, OP_OMAP_RMKEYRANGE, OP_COLL_MOVE_RENAME,
    OP_TRY_RENAME,
)
from ceph_tpu_torch.store.types import CollectionId, ObjectId

MIN_ALLOC = 4096          # bluestore min_alloc_size
_PREFIX_COLL = "C"        # cid -> b""
_PREFIX_ONODE = "O"       # cid + 0x00 + oidkey -> Onode
_PREFIX_OMAP = "M"        # cid + 0x00 + oidkey + 0x00 + key -> value


class Extent(Encodable):
    """One contiguous logical->disk mapping (bluestore_pextent_t +
    csum).  v2 adds blob compression (bluestore_blob_t compressed
    flag): `length` is always the LOGICAL byte count, `disk_len` the
    stored bytes, `alg` the compressor that produced them ("" = raw);
    crc covers the stored bytes."""

    STRUCT_V = 2

    __slots__ = ("logical", "disk", "length", "crc", "disk_len", "alg")

    def __init__(self, logical: int = 0, disk: int = 0, length: int = 0,
                 crc: int = 0, disk_len: int = -1, alg: str = ""):
        self.logical = logical
        self.disk = disk
        self.length = length
        self.crc = crc
        self.disk_len = disk_len if disk_len >= 0 else length
        self.alg = alg

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.logical).u64(self.disk).u32(self.length)
        enc.u32(self.crc)
        enc.u32(self.disk_len).string(self.alg)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "Extent":
        e = cls(dec.u64(), dec.u64(), dec.u32(), dec.u32())
        if struct_v >= 2:
            e.disk_len = dec.u32()
            e.alg = dec.string()
        return e

    def __repr__(self):
        z = f"~{self.alg}" if self.alg else ""
        return f"ext({self.logical}+{self.length}@{self.disk:#x}{z})"


class Onode(Encodable):
    """Object metadata record (bluestore_onode_t role)."""

    __slots__ = ("size", "extents", "attrs", "omap_header", "has_omap")

    def __init__(self):
        self.size = 0
        self.extents: List[Extent] = []
        self.attrs: Dict[str, bytes] = {}
        self.omap_header = b""
        self.has_omap = False

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.size)
        enc.list_(self.extents, lambda e, x: e.struct(x))
        enc.map_(self.attrs, lambda e, k: e.string(k),
                 lambda e, v: e.bytes_(v))
        enc.bytes_(self.omap_header).boolean(self.has_omap)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "Onode":
        o = cls()
        o.size = dec.u64()
        o.extents = dec.list_(lambda d: d.struct(Extent))
        o.attrs = dec.map_(lambda d: d.string(), lambda d: d.bytes_())
        o.omap_header = dec.bytes_()
        o.has_omap = dec.boolean()
        return o


class Allocator:
    """Free-extent manager over the block file (Allocator.h bitmap/stupid
    role, as a sorted free-range list).  Thread-safe: freed COW blocks
    are released from the commit thread once the metadata that stopped
    referencing them is durable, while the event loop allocates."""

    def __init__(self):
        from ceph_tpu_torch.common.lockdep import make_thread_lock
        self._mu = make_thread_lock("blockstore:alloc:_mu")
        self.free: List[List[int]] = []   # sorted [off, len]
        self.device_size = 0

    def init_add_free(self, off: int, length: int) -> None:
        with self._mu:
            self.free.append([off, length])
            self.free.sort()
            self._coalesce()

    def init_rm_free(self, off: int, length: int) -> None:
        """Carve an allocated range out during mount rebuild."""
        with self._mu:
            out = []
            for f_off, f_len in self.free:
                f_end, end = f_off + f_len, off + length
                if f_end <= off or f_off >= end:
                    out.append([f_off, f_len])
                    continue
                if f_off < off:
                    out.append([f_off, off - f_off])
                if f_end > end:
                    out.append([end, f_end - end])
            self.free = sorted(out)

    def allocate(self, length: int) -> List[Tuple[int, int]]:
        """-> [(disk_off, len)] covering length (may fragment); extends
        the device when free space runs out (file-backed device grows)."""
        need = length
        got: List[Tuple[int, int]] = []
        with self._mu:
            while need > 0 and self.free:
                off, ln = self.free[0]
                take = min(ln, need)
                got.append((off, take))
                if take == ln:
                    self.free.pop(0)
                else:
                    self.free[0] = [off + take, ln - take]
                need -= take
            if need > 0:
                off = self.device_size
                grow = (need + MIN_ALLOC - 1) // MIN_ALLOC * MIN_ALLOC
                self.device_size += grow
                got.append((off, need))
                if grow > need:
                    self.free.append([off + need, grow - need])
                    self.free.sort()
                    self._coalesce()
        return got

    def release(self, off: int, length: int) -> None:
        self.init_add_free(off, length)

    def _coalesce(self) -> None:
        # caller holds _mu
        out: List[List[int]] = []
        for off, ln in self.free:
            if out and out[-1][0] + out[-1][1] == off:
                out[-1][1] += ln
            else:
                out.append([off, ln])
        self.free = out

    def free_bytes(self) -> int:
        with self._mu:
            return sum(ln for _, ln in self.free)


def _oid_key(oid: ObjectId) -> bytes:
    enc = Encoder()
    enc.struct(oid)
    return enc.getvalue()


def _onode_key(cid: CollectionId, oid: ObjectId) -> bytes:
    return cid.name.encode() + b"\x00" + _oid_key(oid)


def _omap_key(cid: CollectionId, oid: ObjectId, key: bytes) -> bytes:
    return _onode_key(cid, oid) + b"\x00" + key


class _Batch:
    """Call-local staging for ONE queue_transactions invocation.

    Previously the overlay / wrote-data flag were instance attributes
    mutated per call, so two interleaved callers corrupted each other's
    staged kv — and the async commit path makes interleaving the norm.
    """

    __slots__ = ("ov", "freed", "dirty", "wrote_data")

    def __init__(self):
        # staged kv mutations: (prefix, key) -> value | None(delete).
        # Reads during apply consult this overlay so ops see earlier
        # ops of the SAME batch, while the db commits in ONE atomic
        # KVTransaction at the end (anything less would tear the txn
        # on crash)
        self.ov: Dict[Tuple[str, bytes], Optional[bytes]] = {}
        self.freed: List[Tuple[int, int]] = []
        self.dirty: Dict[bytes, Optional[Onode]] = {}
        self.wrote_data = False


class BlockStore(ObjectStore):
    #: selectable per-extent checksum (bluestore csum_type: crc32c is
    #: the default; xxhash32/xxhash64 as in bluestore_types.h
    #: Checksummer).  Stored crcs are alg-agnostic 32-bit values, so
    #: the extent format doesn't change (xxh64 keeps its low 32 bits).
    CSUM_FNS = {
        "crc32c": crc32c,
        "xxhash32": xxh32,
        "xxhash64": lambda d: xxh64(d) & 0xFFFFFFFF,
    }

    def __init__(self, path: str, compression: str = "",
                 compression_min_blob: int = 4096,
                 csum_type: str = "crc32c"):
        super().__init__(path)
        self.db: Optional[FileDB] = None
        self._fd = -1
        self.alloc = Allocator()
        self._onodes: Dict[bytes, Onode] = {}    # write-through cache
        self.mounted = False
        self._committer: Optional[KVSyncThread] = None
        self._comp = None
        if csum_type not in self.CSUM_FNS:
            raise StoreError(
                f"unknown csum_type {csum_type!r} "
                f"(supported: {sorted(self.CSUM_FNS)})")
        self._csum_name = csum_type
        self._csum = self.CSUM_FNS[csum_type]
        self.set_compression(compression, compression_min_blob)

    def set_compression(self, algorithm: str,
                        min_blob: int = 4096) -> None:
        """Enable blob compression for future writes (per-extent alg tag
        means mixed/compressed data coexists and stays readable)."""
        from ceph_tpu_torch.compressor import create
        self._comp = create(algorithm) if algorithm else None
        self.compression_min_blob = min_blob

    # ------------------------------------------------------------ lifecycle
    def _block_path(self) -> str:
        return os.path.join(self.path, "block")

    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(self._block_path(), "wb"):
            pass
        db = FileDB(os.path.join(self.path, "db"))
        db.close()

    def mount(self) -> None:
        if self.mounted:
            return
        if not os.path.exists(self._block_path()):
            self.mkfs()
        self.db = FileDB(os.path.join(self.path, "db"))
        # the csum alg is a STORE property (extents carry only the
        # 32-bit value): the pinned type wins over the constructor
        # argument, so reopening with a different default can't
        # misverify old extents.  A store WITH onodes but WITHOUT a
        # pin predates selectable csums — its extents are crc32c.
        pinned = self.db.get("meta", b"csum_type")
        if pinned is None and self.db.keys(_PREFIX_ONODE):
            pinned = b"crc32c"            # legacy store
        if pinned is not None:
            name = pinned.decode()
            if name not in self.CSUM_FNS:
                raise StoreError(
                    f"store pins unknown csum_type {name!r} "
                    f"(supported: {sorted(self.CSUM_FNS)})")
            self._csum_name = name
            self._csum = self.CSUM_FNS[name]
        txn = self.db.create_transaction()
        txn.set("meta", b"csum_type", self._csum_name.encode())
        self.db.submit(txn)
        self._fd = os.open(self._block_path(), os.O_RDWR)
        # allocator rebuild: everything is free except extents referenced
        # by some onode (FreelistManager role, derived not persisted)
        self.alloc = Allocator()
        # the file ends at the last written byte, which can be mid-block:
        # round up so rebuild carving stays block-aligned
        self.alloc.device_size = _align_up(os.fstat(self._fd).st_size)
        if self.alloc.device_size:
            self.alloc.init_add_free(0, self.alloc.device_size)
        for k in self.db.keys(_PREFIX_ONODE):
            on = Onode.from_bytes(self.db.get(_PREFIX_ONODE, k))
            for ext in on.extents:
                self.alloc.init_rm_free(ext.disk,
                                        _align_up(ext.disk_len))
        self._onodes = {}
        # group-commit pipeline (BlueStore kv_sync_thread role): the
        # event loop applies in memory; this thread batches the data
        # fsync + kv WAL sync for every transaction in flight
        self.db.pre_compact_hook = self._data_barrier
        # small static gather base: the auto-tuner tracks the MEASURED
        # barrier cost (EWMA) clamped to 4x this — on tmpfs the window
        # stays at the ~0.1ms a cheap fsync costs, on a real disk it
        # grows to the clamp so co-arriving txns share the 4ms+ fsync
        self._committer = KVSyncThread(
            "blockstore_commit",
            data_sync=self._data_barrier,
            kv_sync=self.db.log_deferred,
            gather_window=0.001)
        self._committer.start()
        self.mounted = True

    def _data_barrier(self) -> None:
        if self._fd >= 0:
            os.fsync(self._fd)

    def sync(self) -> None:
        """Block until every queued transaction is durable (flush)."""
        if self._committer is not None:
            self._committer.flush()

    def commit_counters(self) -> Dict[str, float]:
        return self._committer.counters() if self._committer else {}

    def umount(self) -> None:
        if not self.mounted:
            return
        self._committer.stop()
        self._committer = None
        # close the db BEFORE the block fd: close() may still flush
        # deferred kv records (dead commit thread) and its data barrier
        # (pre_compact_hook -> _data_barrier) needs the fd open
        self.db.close()
        self.db = None
        os.close(self._fd)
        self._fd = -1
        self._onodes = {}
        self.mounted = False

    # ------------------------------------------------------------- helpers
    def _coll_exists(self, cid: CollectionId,
                     b: Optional[_Batch] = None) -> bool:
        return self._kv_get(_PREFIX_COLL, cid.name.encode(),
                            b) is not None

    def _get_onode(self, cid: CollectionId, oid: ObjectId,
                   create: bool = False,
                   b: Optional[_Batch] = None) -> Onode:
        key = _onode_key(cid, oid)
        if b is not None and key in b.dirty and b.dirty[key] is None:
            # removed earlier in THIS batch: the committed row must not
            # resurrect (remove+write in one txn is apply_push's shape)
            if not create:
                raise NoSuchObject(f"{cid}/{oid}")
            if not self._coll_exists(cid, b):
                raise NoSuchCollection(str(cid))
            on = Onode()
            self._onodes[key] = on
            return on
        on = self._onodes.get(key)
        if on is None:
            raw = self._kv_get(_PREFIX_ONODE, key, b)
            if raw is not None:
                on = Onode.from_bytes(raw)
            elif create:
                if not self._coll_exists(cid, b):
                    raise NoSuchCollection(str(cid))
                on = Onode()
            else:
                raise NoSuchObject(f"{cid}/{oid}")
            self._onodes[key] = on
        return on

    # -------------------------------------------------------------- writes
    def queue_transactions(self, txns, on_applied=None,
                           on_commit=None) -> None:
        """Apply data + metadata in memory, then hand the staged kv
        batch to the commit thread: ONE data fsync + ONE atomic kv
        submit cover every batch in flight (group commit).  on_applied
        fires inline (state is readable); on_commit fires from the
        commit thread once the batch is durable, in submission order."""
        assert self.mounted, "blockstore not mounted"
        if self._committer is not None and self._committer.dead:
            # the commit thread died (fsync error / injected crash):
            # accepting more writes would apply them in memory with no
            # path to durability and no acks — fail loudly so the OSD
            # surfaces the wedge instead of serving phantom writes
            raise StoreError("blockstore commit thread is dead")
        b = _Batch()                     # call-local: reentrancy-safe
        try:
            for txn in txns:
                for op in txn.ops:
                    self._apply_op(op, b)
        except Exception:
            # roll back every trace of the failed batch: staged kv is
            # dropped, the onode cache may hold in-place mutations so it
            # is flushed wholesale (it is only a cache), and blocks
            # allocated for the doomed writes leak until the next mount
            # rebuild reclaims them
            self._onodes = {}
            raise
        for key, on in b.dirty.items():
            if on is None:
                self._stage(b, _PREFIX_ONODE, key, None)
                self._onodes.pop(key, None)
            else:
                self._stage(b, _PREFIX_ONODE, key, on.to_bytes())
                self._onodes[key] = on
        batch = KVTransaction()
        for (prefix, key), val in b.ov.items():
            if val is None:
                batch.rmkey(prefix, key)
            else:
                batch.set(prefix, key, val)
        # memory-apply now (read-your-writes for every later caller);
        # the WAL record becomes durable on the commit thread
        seq = self.db.submit_deferred(batch)
        self.applied_seq += 1
        if on_applied:
            on_applied()
        post = None
        if b.freed:
            freed = b.freed

            def post():
                # old blocks become reusable only after the metadata
                # that dereferenced them is DURABLE (COW ordering): a
                # reuse before that could overwrite blocks a replayed
                # old onode still references
                for off, ln in freed:
                    self.alloc.release(off, ln)
        self._committer.submit(seq=seq, wrote_data=b.wrote_data,
                               on_commit=on_commit, post=post)

    # --- staged kv views (overlay over the committed db) ---
    @staticmethod
    def _stage(b: _Batch, prefix: str, key: bytes,
               val: Optional[bytes]) -> None:
        b.ov[(prefix, key)] = val

    def _kv_get(self, prefix: str, key: bytes,
                b: Optional[_Batch] = None) -> Optional[bytes]:
        if b is not None and (prefix, key) in b.ov:
            return b.ov[(prefix, key)]
        return self.db.get(prefix, key)

    def _kv_keys(self, prefix: str, pre: bytes = b"",
                 b: Optional[_Batch] = None) -> List[bytes]:
        """Keys under `prefix` starting with `pre`, overlay-aware; the
        committed side is a bounded range scan, not a full-prefix walk."""
        end = _prefix_end(pre) if pre else None
        keys = {k for k, _ in self.db.iterate(prefix, start=pre,
                                              end=end)}
        if b is not None:
            for (p, k), v in b.ov.items():
                if p != prefix or not k.startswith(pre):
                    continue
                if v is None:
                    keys.discard(k)
                else:
                    keys.add(k)
        return sorted(keys)

    def _apply_op(self, op, b: _Batch) -> None:
        """Apply one op; any block-file write sets b.wrote_data."""
        c, o = op.cid, op.oid
        freed, dirty = b.freed, b.dirty
        if op.op == OP_NOP:
            return
        if op.op == OP_MKCOLL:
            self._stage(b, _PREFIX_COLL, c.name.encode(), b"")
            return
        if op.op == OP_RMCOLL:
            if not self._coll_exists(c, b):
                return       # removal of missing collection: no-op
            for oid in self.collection_list(c):
                self._remove_object(c, oid, b)
            self._stage(b, _PREFIX_COLL, c.name.encode(), None)
            return
        if op.op == OP_TOUCH:
            key = _onode_key(c, o)
            dirty[key] = self._get_onode(c, o, create=True, b=b)
            return
        if op.op == OP_WRITE:
            on = self._get_onode(c, o, create=True, b=b)
            self._write_range(on, op.off, op.data, b)
            dirty[_onode_key(c, o)] = on
            return
        if op.op == OP_ZERO:
            on = self._get_onode(c, o, create=True, b=b)
            self._punch(on, op.off, op.length, b)
            on.size = max(on.size, op.off + op.length)
            dirty[_onode_key(c, o)] = on
            return
        if op.op == OP_TRUNCATE:
            on = self._get_onode(c, o, create=True, b=b)
            size = op.off
            self._punch(on, size, max(on.size - size, 0), b)
            on.size = size
            dirty[_onode_key(c, o)] = on
            return
        if op.op == OP_REMOVE:
            self._remove_object(c, o, b)
            return
        if op.op == OP_SETATTR:
            on = self._get_onode(c, o, create=True, b=b)
            on.attrs[op.name] = op.data
            dirty[_onode_key(c, o)] = on
            return
        if op.op == OP_SETATTRS:
            on = self._get_onode(c, o, create=True, b=b)
            for k, v in op.kv.items():
                on.attrs[k.decode("utf-8")] = v
            dirty[_onode_key(c, o)] = on
            return
        if op.op == OP_RMATTR:
            try:
                on = self._get_onode(c, o, b=b)
            except StoreError:
                return       # destructive op on missing: no-op
            on.attrs.pop(op.name, None)
            dirty[_onode_key(c, o)] = on
            return
        if op.op == OP_CLONE:
            try:
                src = self._get_onode(c, o, b=b)
            except StoreError:
                return       # clone of missing: no-op
            # clone REPLACES the destination (memstore semantics): old
            # extents freed, old omap dropped
            try:
                old = self._get_onode(c, op.oid2, b=b)
                for ext in old.extents:
                    freed.append((ext.disk, _align_up(ext.disk_len)))
                pre_old = _omap_key(c, op.oid2, b"")
                for k in self._kv_keys(_PREFIX_OMAP, pre_old, b):
                    self._stage(b, _PREFIX_OMAP, k, None)
                self._onodes.pop(_onode_key(c, op.oid2), None)
            except StoreError:
                pass
            data = self._read_onode(src, 0, src.size)
            dst = Onode()
            dst.attrs = dict(src.attrs)
            dst.omap_header = src.omap_header
            self._write_range(dst, 0, data, b)
            dst.size = src.size
            # omap copies too (clone carries omap in the reference)
            if src.has_omap:
                dst.has_omap = True
                pre = _omap_key(c, o, b"")
                for k in self._kv_keys(_PREFIX_OMAP, pre, b):
                    self._stage(b, _PREFIX_OMAP,
                                _omap_key(c, op.oid2, k[len(pre):]),
                                self._kv_get(_PREFIX_OMAP, k, b))
            dirty[_onode_key(c, op.oid2)] = dst
            return
        if op.op == OP_CLONERANGE2:
            try:
                src = self._get_onode(c, o, b=b)
            except StoreError:
                return

            data = self._read_onode(src, op.off, op.length)
            try:
                dst = self._get_onode(c, op.oid2, create=True, b=b)
            except NoSuchObject:
                dst = Onode()
            self._write_range(dst, op.dest_off, data, b)
            dirty[_onode_key(c, op.oid2)] = dst
            return
        if op.op == OP_COLL_MOVE_RENAME or op.op == OP_TRY_RENAME:
            newcid = op.cid2 or c
            try:
                src = self._get_onode(c, o, b=b)
            except NoSuchObject:
                if op.op == OP_TRY_RENAME:
                    return
                raise
            # rename replaces any existing destination
            try:
                old = self._get_onode(newcid, op.oid2, b=b)
                if old is not src:
                    for ext in old.extents:
                        freed.append((ext.disk, _align_up(ext.disk_len)))
                    for k in self._kv_keys(_PREFIX_OMAP,
                                           _omap_key(newcid, op.oid2,
                                                     b""), b):
                        self._stage(b, _PREFIX_OMAP, k, None)
                    self._onodes.pop(_onode_key(newcid, op.oid2), None)
            except StoreError:
                pass
            dirty[_onode_key(c, o)] = None
            self._onodes.pop(_onode_key(c, o), None)
            dirty[_onode_key(newcid, op.oid2)] = src
            pre = _omap_key(c, o, b"")
            for k in self._kv_keys(_PREFIX_OMAP, pre, b):
                self._stage(b, _PREFIX_OMAP,
                            _omap_key(newcid, op.oid2, k[len(pre):]),
                            self._kv_get(_PREFIX_OMAP, k, b))
                self._stage(b, _PREFIX_OMAP, k, None)
            return
        if op.op == OP_OMAP_CLEAR:
            try:
                self._get_onode(c, o, b=b)
            except StoreError:
                return

            pre = _omap_key(c, o, b"")
            for k in self._kv_keys(_PREFIX_OMAP, pre, b):
                self._stage(b, _PREFIX_OMAP, k, None)
            return
        if op.op == OP_OMAP_SETKEYS:
            on = self._get_onode(c, o, create=True, b=b)
            on.has_omap = True
            dirty[_onode_key(c, o)] = on
            for k, v in op.kv.items():
                self._stage(b, _PREFIX_OMAP, _omap_key(c, o, k), v)
            return
        if op.op == OP_OMAP_RMKEYS:
            for k in op.keys:
                self._stage(b, _PREFIX_OMAP, _omap_key(c, o, k), None)
            return
        if op.op == OP_OMAP_RMKEYRANGE:
            first, last = op.keys
            pre = _omap_key(c, o, b"")
            for k in self._kv_keys(_PREFIX_OMAP, pre, b):
                if first <= k[len(pre):] < last:
                    self._stage(b, _PREFIX_OMAP, k, None)
            return
        if op.op == OP_OMAP_SETHEADER:
            on = self._get_onode(c, o, create=True, b=b)
            on.omap_header = op.data
            dirty[_onode_key(c, o)] = on
            return
        raise StoreError(f"blockstore: unsupported op {op.op}")

    def _remove_object(self, cid, oid, b: _Batch) -> None:
        try:
            on = self._get_onode(cid, oid, b=b)
        except NoSuchObject:
            return
        for ext in on.extents:
            b.freed.append((ext.disk, _align_up(ext.disk_len)))
        pre = _omap_key(cid, oid, b"")
        for k in self._kv_keys(_PREFIX_OMAP, pre, b):
            self._stage(b, _PREFIX_OMAP, k, None)
        b.dirty[_onode_key(cid, oid)] = None
        self._onodes.pop(_onode_key(cid, oid), None)

    # COW write: merge-affected old extents are read, the merged span is
    # written to fresh blocks, old blocks freed post-commit
    def _write_range(self, on: Onode, off: int, data: bytes,
                     b: _Batch) -> None:
        if not data:
            on.size = max(on.size, off)
            return
        end = off + len(data)
        # widen to existing extents overlapping the span so the rewrite
        # keeps their surviving bytes
        lo, hi = off, end
        keep: List[Extent] = []
        drop: List[Extent] = []
        for ext in on.extents:
            if ext.logical + ext.length <= off or ext.logical >= end:
                keep.append(ext)
            else:
                drop.append(ext)
                lo = min(lo, ext.logical)
                hi = max(hi, ext.logical + ext.length)
        span = bytearray(hi - lo)
        for ext in drop:
            span[ext.logical - lo:ext.logical - lo + ext.length] = \
                self._pread_checked(ext)
            b.freed.append((ext.disk, _align_up(ext.disk_len)))
        span[off - lo:end - lo] = data
        on.extents = sorted(keep + self._rewrite(lo, bytes(span), b),
                            key=lambda e: e.logical)
        on.size = max(on.size, end)

    def _punch(self, on: Onode, off: int, length: int,
               b: _Batch) -> None:
        if length <= 0:
            return
        end = off + length
        out: List[Extent] = []
        for ext in on.extents:
            e_end = ext.logical + ext.length
            if e_end <= off or ext.logical >= end:
                out.append(ext)
                continue
            data = self._pread_checked(ext)
            b.freed.append((ext.disk, _align_up(ext.disk_len)))
            if ext.logical < off:
                head = data[:off - ext.logical]
                out.extend(self._rewrite(ext.logical, head, b))
            if e_end > end:
                tail = data[end - ext.logical:]
                out.extend(self._rewrite(end, tail, b))
        on.extents = sorted(out, key=lambda e: e.logical)

    def _rewrite(self, logical: int, data: bytes,
                 b: _Batch) -> List[Extent]:
        exts = []
        pos = 0
        for d_off, d_len in self.alloc.allocate(_align_up(len(data))):
            take = min(d_len, len(data) - pos)
            if take <= 0:
                self.alloc.release(d_off, d_len)
                continue
            chunk = data[pos:pos + take]
            exts.append(self._store_piece(logical + pos, chunk, d_off,
                                          d_len, b))
            pos += take
        return exts

    def _store_piece(self, logical: int, chunk: bytes, d_off: int,
                     d_len: int, b: _Batch) -> Extent:
        """Write one contiguous piece, compressing when it pays
        (bluestore_compression_required_ratio role: stored bytes must
        save at least one alloc unit)."""
        stored, alg = chunk, ""
        if (self._comp is not None
                and len(chunk) >= self.compression_min_blob):
            cand = self._comp.compress(chunk)
            if _align_up(len(cand)) < _align_up(len(chunk)):
                stored, alg = cand, self._comp.name
        os.pwrite(self._fd, stored, d_off)
        b.wrote_data = True
        used = _align_up(len(stored))
        if used < d_len:
            self.alloc.release(d_off + used, d_len - used)
        return Extent(logical, d_off, len(chunk), self._csum(stored),
                      len(stored), alg)

    # --------------------------------------------------------------- reads
    def _pread_checked(self, ext: Extent) -> bytes:
        data = os.pread(self._fd, ext.disk_len, ext.disk)
        if len(data) != ext.disk_len or self._csum(data) != ext.crc:
            raise StoreError(
                f"blockstore: csum mismatch at {ext!r} "
                f"(stored {ext.crc:#x}, got {self._csum(data):#x})")
        if ext.alg:
            from ceph_tpu_torch.compressor import CompressorError, cached
            try:
                data = cached(ext.alg).decompress(data)
            except CompressorError as e:
                # integrity failures must surface uniformly (scrub deep
                # pass catches StoreError as a shard error)
                raise StoreError(f"blockstore: {ext!r}: {e}")
            if len(data) != ext.length:
                raise StoreError(
                    f"blockstore: decompressed length mismatch at "
                    f"{ext!r}")
        return data

    def _read_onode(self, on: Onode, off: int, length: int) -> bytes:
        if length < 0:
            length = on.size - off
        length = max(0, min(length, on.size - off))
        out = bytearray(length)
        for ext in on.extents:
            e_end = ext.logical + ext.length
            if e_end <= off or ext.logical >= off + length:
                continue
            data = self._pread_checked(ext)
            s = max(off, ext.logical)
            e = min(off + length, e_end)
            out[s - off:e - off] = data[s - ext.logical:e - ext.logical]
        return bytes(out)

    def read(self, cid, oid, off: int = 0, length: int = -1) -> bytes:
        return self._read_onode(self._get_onode(cid, oid), off, length)

    def stat(self, cid, oid) -> Dict[str, int]:
        on = self._get_onode(cid, oid)
        return {"size": on.size}

    def getattr(self, cid, oid, name: str) -> bytes:
        on = self._get_onode(cid, oid)
        if name not in on.attrs:
            raise StoreError(f"no attr {name!r} on {oid}")
        return on.attrs[name]

    def getattrs(self, cid, oid) -> Dict[str, bytes]:
        return dict(self._get_onode(cid, oid).attrs)

    def omap_get(self, cid, oid) -> Tuple[bytes, Dict[bytes, bytes]]:
        on = self._get_onode(cid, oid)
        pre = _omap_key(cid, oid, b"")
        out = {}
        for k in self._kv_keys(_PREFIX_OMAP, pre):
            out[k[len(pre):]] = self._kv_get(_PREFIX_OMAP, k)
        return on.omap_header, out

    def omap_get_values(self, cid, oid, keys) -> Dict[bytes, bytes]:
        self._get_onode(cid, oid)          # existence check
        out = {}
        for k in keys:
            v = self._kv_get(_PREFIX_OMAP, _omap_key(cid, oid, k))
            if v is not None:
                out[k] = v
        return out

    def omap_get_header(self, cid, oid) -> bytes:
        return self._get_onode(cid, oid).omap_header

    def list_collections(self) -> List[CollectionId]:
        return [CollectionId(k.decode())
                for k in self._kv_keys(_PREFIX_COLL)]

    def collection_exists(self, cid) -> bool:
        return self._coll_exists(cid)

    def collection_list(self, cid, start: Optional[ObjectId] = None,
                        max_count: int = 2**31) -> List[ObjectId]:
        if not self._coll_exists(cid):
            raise NoSuchCollection(str(cid))
        pre = cid.name.encode() + b"\x00"
        oids = []
        for k in self._kv_keys(_PREFIX_ONODE, pre):
            oids.append(ObjectId.from_bytes(k[len(pre):]))
        oids.sort(key=lambda o: o.sort_key())
        if start is not None:
            oids = [o for o in oids if o.sort_key() > start.sort_key()]
        return oids[:max_count]

    # ---------------------------------------------------------- inspection
    def statfs(self) -> Dict[str, int]:
        """df-style usage (ObjectStore::statfs)."""
        total = self.alloc.device_size
        return {"total": total, "free": self.alloc.free_bytes(),
                "used": total - self.alloc.free_bytes()}


def _align_up(n: int) -> int:
    return (n + MIN_ALLOC - 1) // MIN_ALLOC * MIN_ALLOC


def _prefix_end(pre: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string starting with pre."""
    b = bytearray(pre)
    while b and b[-1] == 0xFF:
        b.pop()
    if not b:
        return None
    b[-1] += 1
    return bytes(b)
