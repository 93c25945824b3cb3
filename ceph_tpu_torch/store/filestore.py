"""FileStore: durable ObjectStore with write-ahead journal + checkpoints
(the port's copy of ``ceph_tpu.store.filestore``).

Reference parity: os/filestore/FileStore.cc + FileJournal (journal-ahead
writes, replay on mount) and BlueStore's WAL idea distilled.  Redesigned:
state lives in memory (MemStore apply semantics), durability comes from a
checksummed WAL of encoded Transactions plus an atomically-replaced
checkpoint of the full store — the same snapshot+log recipe as kv.FileDB.
``queue_transactions`` returns after the WAL record is fsync'd, so
on_commit == journal-durable exactly like the reference's journaled mode
(JournalingObjectStore).  A torn WAL tail is discarded on replay.
"""

from __future__ import annotations

import os
from typing import Dict, List

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.store.memstore import MemStore, Obj
from ceph_tpu_torch.store.objectstore import StoreError, Transaction
from ceph_tpu_torch.store.types import CollectionId, ObjectId
from ceph_tpu_torch.store.wal import WriteAheadLog, atomic_snapshot

_MAGIC = b"CTFS\x01"


class KilledAt(StoreError):
    """Injected crash (filestore_kill_at role, config_opts.h:1171):
    the store dies mid-write-path; the test re-mounts and checks the
    recovered state is an exact transaction-boundary prefix."""


class FileStore(MemStore):
    COMPACT_BYTES = 64 << 20

    def __init__(self, path: str):
        if not path:
            raise StoreError("filestore requires a path")
        super().__init__(path)
        self.committed_seq = 0
        self._wal = None
        #: crash injection countdown (0 = off).  N > 0: die AFTER the
        #: Nth batch's WAL records are durable but BEFORE the in-memory
        #: apply (journal replay must recover it).  N < 0: die BEFORE
        #: the |N|th batch touches the WAL (the txn must vanish).
        self.kill_at = 0

    # --- paths ---
    def _ckpt_path(self):
        return os.path.join(self.path, "checkpoint")

    def _wal_path(self):
        return os.path.join(self.path, "wal")

    # --- lifecycle ---
    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "fsid"), "wb") as f:
            f.write(_MAGIC)

    def mount(self) -> None:
        if not os.path.exists(os.path.join(self.path, "fsid")):
            raise StoreError(f"{self.path}: not a filestore (run mkfs)")
        self._load_checkpoint()
        self._wal = WriteAheadLog(self._wal_path())
        for seq, payload in self._wal.replay():
            if seq > self.committed_seq:
                self._apply(Transaction.from_bytes(payload))
                self.committed_seq = seq
        self.applied_seq = self.committed_seq
        self.mounted = True

    def umount(self) -> None:
        if self._wal is not None and not self._wal.closed:
            if self._wal.size() > 0:   # snapshot already current otherwise
                self.checkpoint()
            self._wal.close()
        self.mounted = False

    # --- write path ---
    def queue_transactions(self, txns: List[Transaction],
                           on_applied=None, on_commit=None):
        if not self.mounted:
            raise StoreError("not mounted")
        if self.kill_at < 0:
            self.kill_at += 1
            if self.kill_at == 0:
                self._die("before journal")
        # journal-ahead: encode + fsync all records, then apply in memory
        recs = [(self.committed_seq + 1 + i, t.to_bytes())
                for i, t in enumerate(txns)]
        self._wal.append_many(recs)
        if self.kill_at > 0:
            self.kill_at -= 1
            if self.kill_at == 0:
                self._die("after journal, before apply")
        self.committed_seq += len(txns)   # only after records are durable
        for t in txns:
            self._apply(t)
        self.applied_seq = self.committed_seq
        if on_applied:
            on_applied()
        if on_commit:
            on_commit()
        if self._wal.size() > self.COMPACT_BYTES:
            self.checkpoint()

    def _die(self, where: str) -> None:
        """Injected crash: the store must look DEAD — in particular the
        WAL handle closes WITHOUT checkpoint/rotate, or a well-meaning
        try/finally umount() would snapshot the stale pre-apply state
        and truncate the very record the injection proved durable."""
        self.mounted = False
        if self._wal is not None and not self._wal.closed:
            self._wal.close()
        raise KilledAt(where)

    # --- checkpoint / replay ---
    def checkpoint(self) -> None:
        enc = Encoder()
        enc.u64(self.committed_seq)
        enc.u32(len(self.colls))
        for cid in sorted(self.colls):
            enc.struct(cid)
            objs = self.colls[cid]
            enc.u32(len(objs))
            for oid, o in objs.items():
                enc.struct(oid)
                enc.bytes_(bytes(o.data))
                enc.map_({k.encode("utf-8"): v for k, v in o.xattrs.items()},
                         lambda e, k: e.bytes_(k), lambda e, v: e.bytes_(v))
                enc.map_(o.omap, lambda e, k: e.bytes_(k),
                         lambda e, v: e.bytes_(v))
                enc.bytes_(o.omap_header)
        atomic_snapshot(self._ckpt_path(), enc.getvalue())
        if self._wal is None:
            self._wal = WriteAheadLog(self._wal_path())
            self._wal.open()
        self._wal.rotate()

    def _load_checkpoint(self) -> None:
        self.colls = {}
        try:
            with open(self._ckpt_path(), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        dec = Decoder(data)
        self.committed_seq = dec.u64()
        ncoll = dec.u32()
        for _ in range(ncoll):
            cid = dec.struct(CollectionId)
            nobj = dec.u32()
            objs: Dict[ObjectId, Obj] = {}
            for _ in range(nobj):
                oid = dec.struct(ObjectId)
                o = Obj()
                o.data = bytearray(dec.bytes_())
                o.xattrs = {k.decode("utf-8"): v for k, v in dec.map_(
                    lambda d: d.bytes_(), lambda d: d.bytes_()).items()}
                o.omap = dec.map_(lambda d: d.bytes_(), lambda d: d.bytes_())
                o.omap_header = dec.bytes_()
                objs[oid] = o
            self.colls[cid] = objs
        self.applied_seq = self.committed_seq

