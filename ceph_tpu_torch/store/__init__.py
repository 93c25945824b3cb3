"""Local persistence layer: ObjectStore backends + KeyValueDB (the port's
copy of ``ceph_tpu.store``).

Reference parity: src/os/ (ObjectStore/Transaction, MemStore, FileStore
journal) and src/kv/ (KeyValueDB over leveldb/rocksdb).
"""

from ceph_tpu_torch.store.kv import FileDB, KeyValueDB, KVTransaction, MemDB
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.filestore import FileStore
from ceph_tpu_torch.store.objectstore import (
    NoSuchCollection, NoSuchObject, ObjectStore, StoreError, Transaction,
)
from ceph_tpu_torch.store.types import SNAP_DIR, SNAP_HEAD, CollectionId, ObjectId

__all__ = [
    "CollectionId", "FileDB", "FileStore", "KVTransaction", "KeyValueDB",
    "MemDB", "MemStore", "NoSuchCollection", "NoSuchObject", "ObjectId",
    "ObjectStore", "SNAP_DIR", "SNAP_HEAD", "StoreError", "Transaction",
]
