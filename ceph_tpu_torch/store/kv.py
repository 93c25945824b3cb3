"""KeyValueDB: transactional ordered key-value store abstraction (the
port's copy of ``ceph_tpu.store.kv``).

Reference parity: kv/KeyValueDB.h (abstract kv with batched transactions and
prefix iterators; backends LevelDBStore/RocksDBStore/MemDB).  Redesigned with
two backends, no external deps:

- MemDB      — sorted in-memory map (tests, MemStore omap).
- FileDB     — log-structured file backend: append-only WAL of committed
               batches + periodic compacted snapshot, replayed on open.
               This is the durability substrate for the monitor store and
               FileStore metadata, playing the role rocksdb plays in the
               reference (kv/RocksDBStore.cc) with a deliberately simple
               single-writer design.

Keys are namespaced by a string prefix like the reference
(``prefix`` + 0x00 + key ordering), values are bytes.
"""

from __future__ import annotations

import os
import struct
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ceph_tpu_torch.common.lockdep import make_thread_lock
from ceph_tpu_torch.store.wal import WriteAheadLog, atomic_snapshot

_SEP = b"\x00"


def _full_key(prefix: str, key: bytes) -> bytes:
    return prefix.encode("utf-8") + _SEP + key


class KVTransaction:
    """Batched mutations applied atomically by ``KeyValueDB.submit``."""

    __slots__ = ("ops",)

    SET, RM, RM_PREFIX = 0, 1, 2

    def __init__(self):
        self.ops: List[Tuple[int, bytes, bytes]] = []

    def set(self, prefix: str, key, value: bytes) -> "KVTransaction":
        if isinstance(key, str):
            key = key.encode("utf-8")
        self.ops.append((self.SET, _full_key(prefix, key), bytes(value)))
        return self

    def rmkey(self, prefix: str, key) -> "KVTransaction":
        if isinstance(key, str):
            key = key.encode("utf-8")
        self.ops.append((self.RM, _full_key(prefix, key), b""))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append((self.RM_PREFIX, prefix.encode("utf-8") + _SEP, b""))
        return self

    def encode(self) -> bytes:
        out = bytearray(struct.pack("<I", len(self.ops)))
        for op, k, v in self.ops:
            out += struct.pack("<BI", op, len(k)) + k
            out += struct.pack("<I", len(v)) + v
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "KVTransaction":
        t = cls()
        off = 4
        (n,) = struct.unpack_from("<I", data, 0)
        for _ in range(n):
            op, klen = struct.unpack_from("<BI", data, off)
            off += 5
            k = data[off:off + klen]; off += klen
            (vlen,) = struct.unpack_from("<I", data, off)
            off += 4
            v = data[off:off + vlen]; off += vlen
            t.ops.append((op, k, v))
        return t


class KeyValueDB:
    """Abstract ordered kv store."""

    #: True when submit_deferred really defers durability (FileDB);
    #: backends without a durability cost just apply immediately
    supports_deferred = False

    def create_transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        raise NotImplementedError

    def submit_deferred(self, txn: KVTransaction) -> int:
        """Apply txn to the visible (in-memory) state NOW; its
        durability is deferred until ``log_deferred`` covers the
        returned seq.  Default: no durability substrate — plain
        submit."""
        self.submit(txn, sync=True)
        return 0

    def log_deferred(self, upto_seq: int) -> int:
        """Make every deferred record with seq <= upto_seq durable in
        one group (single WAL fsync).  Returns the record count."""
        return 0

    def get(self, prefix: str, key) -> Optional[bytes]:
        raise NotImplementedError

    def iterate(self, prefix: str, start=b"", end=None
                ) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (key, value) within prefix, key >= start (< end if given),
        in key order."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    # conveniences
    def exists(self, prefix: str, key) -> bool:
        return self.get(prefix, key) is not None

    def keys(self, prefix: str) -> List[bytes]:
        return [k for k, _ in self.iterate(prefix)]

    def iterate_all(self) -> Iterator[Tuple[str, bytes, bytes]]:
        """Yield (prefix, key, value) over the whole keyspace — offline
        tooling surface (kvstore tool list/stats)."""
        raise NotImplementedError


class MemDB(KeyValueDB):
    """Sorted in-memory backend (reference kv/MemDB analog)."""

    def __init__(self):
        self._keys: List[bytes] = []          # sorted full keys
        self._map: Dict[bytes, bytes] = {}

    def _insert(self, k: bytes, v: bytes):
        if k not in self._map:
            self._keys.insert(bisect_left(self._keys, k), k)
        self._map[k] = v

    def _remove(self, k: bytes):
        if k in self._map:
            del self._map[k]
            i = bisect_left(self._keys, k)
            del self._keys[i]

    def _remove_prefix(self, p: bytes):
        lo = bisect_left(self._keys, p)
        hi = lo
        while hi < len(self._keys) and self._keys[hi].startswith(p):
            del self._map[self._keys[hi]]
            hi += 1
        del self._keys[lo:hi]

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        for op, k, v in txn.ops:
            if op == KVTransaction.SET:
                self._insert(k, v)
            elif op == KVTransaction.RM:
                self._remove(k)
            else:
                self._remove_prefix(k)

    def get(self, prefix: str, key) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("utf-8")
        return self._map.get(_full_key(prefix, key))

    def iterate(self, prefix: str, start=b"", end=None):
        if isinstance(start, str):
            start = start.encode("utf-8")
        if isinstance(end, str):
            end = end.encode("utf-8")
        p = prefix.encode("utf-8") + _SEP
        lo = bisect_left(self._keys, p + start)
        for i in range(lo, len(self._keys)):   # no tail copy
            k = self._keys[i]
            if not k.startswith(p):
                break
            short = k[len(p):]
            if end is not None and short >= end:
                break
            yield short, self._map[k]

    def iterate_all(self):
        for k in self._keys:
            p, _, short = k.partition(_SEP)
            yield p.decode("utf-8", errors="replace"), short, self._map[k]


class FileDB(MemDB):
    """Durable log-structured backend.

    Layout in ``path/``:
      - ``snapshot`` — compacted full state at some committed seq
                       (atomic-rename replaced).
      - ``wal``      — checksummed append log of KVTransactions since the
                       snapshot; replayed on open; truncated by compact().

    Crash semantics: submit(sync=True) returns only after the WAL record is
    fsync'd — the reference's journal-ahead rule (os/filestore/FileJournal).
    A torn tail record (bad crc / short read) is discarded and truncated on
    replay (wal.WriteAheadLog), exactly like the reference journal replay.

    Group commit: ``submit_deferred`` applies to memory immediately
    (read-your-writes for the event loop) and stages the encoded record;
    a commit thread later calls ``log_deferred(upto_seq)`` to append the
    whole backlog with ONE fsync (the BlueStore kv_sync_thread recipe).

    Two locks split memory from I/O so event-loop reads never stall for
    a barrier (otherwise ``db.get``/``iterate`` would block for the
    whole WAL group fsync / snapshot compaction):
      * ``_mu`` (RLock) — guards ONLY in-memory state (map/keys, seq,
        the deferred backlog); held for microseconds.
      * ``_io`` (Lock)  — serializes WAL appends, fsyncs and snapshot
        compaction so records hit the log in seq order; the group fsync
        and the data-device barrier run under ``_io`` alone, with the
        backlog STAGED under ``_mu`` and flushed outside it.
    Lock order is strictly ``_io`` -> ``_mu``; readers take ``_mu``
    only; ``iterate`` materializes its rows under the lock.
    """

    COMPACT_BYTES = 8 << 20

    supports_deferred = True

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.seq = 0
        # built through the lockdep factory: with the sanitizer enabled
        # (qa clusters) the documented _io -> _mu order is a CHECKED
        # edge in the runtime lock-order graph; disabled, these are
        # plain stdlib locks (zero overhead).  The static half of the
        # same invariant is the reference's devtools rule LOCK06.
        self._mu = make_thread_lock(f"filedb:{path}:_mu", rlock=True)
        self._io = make_thread_lock(f"filedb:{path}:_io")
        self._deferred: List[Tuple[int, bytes]] = []
        #: called under _io (NOT _mu — it must never block readers)
        #: right before a snapshot compaction / backlog flush persists;
        #: BlockStore points it at its data-device fsync so a snapshot
        #: can never persist metadata whose data blocks aren't durable
        self.pre_compact_hook: Optional[Callable[[], None]] = None
        #: set when a WAL append failed AFTER memory was applied: the
        #: in-memory state is ahead of the durable log and can never be
        #: reconciled, so the instance refuses further writes (the
        #: deferred path gets the same wedge from a dead KVSyncThread)
        self._broken: Optional[str] = None
        self._load_snapshot()
        self._wal = WriteAheadLog(self._wal_path())
        for seq, payload in self._wal.replay():
            if seq > self.seq:
                super().submit(KVTransaction.decode(payload))
                self.seq = seq

    def _check_broken(self) -> None:
        if self._broken is not None:
            raise RuntimeError(f"FileDB {self.path} is broken "
                               f"(memory ahead of WAL): {self._broken}")

    # --- persistence ---
    def _snap_path(self):
        return os.path.join(self.path, "snapshot")

    def _wal_path(self):
        return os.path.join(self.path, "wal")

    def _load_snapshot(self):
        try:
            with open(self._snap_path(), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        (self.seq, n) = struct.unpack_from("<QI", data, 0)
        off = 12
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", data, off); off += 4
            k = data[off:off + klen]; off += klen
            (vlen,) = struct.unpack_from("<I", data, off); off += 4
            v = data[off:off + vlen]; off += vlen
            self._insert(k, v)

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        with self._io:
            self._check_broken()
            payload = txn.encode()
            with self._mu:
                # reserve OUR seq first, applying memory in the same
                # critical section (memory order == seq/replay order
                # even against a racing submit_deferred on the same
                # key).  Any deferred record staged BEFORE this point
                # has a lower seq and is flushed below, strictly ahead
                # of our append; one staged AFTER has a higher seq and
                # stays deferred — so the WAL file order always equals
                # seq order and replay can never skip a durable record.
                self.seq += 1
                seq = self.seq
                super().submit(txn)
                backlog = bool(self._deferred)
            if backlog:
                # flush the lower-seq backlog before appending our
                # record — after the data barrier, since those records'
                # data blocks may be pwritten but not yet fsync'd
                # (data-before-metadata; their pwrites happened before
                # their submit_deferred returned, i.e. before the hook)
                if self.pre_compact_hook is not None:
                    self.pre_compact_hook()
                self._log_deferred_io(seq - 1)
            # memory was applied above: a failed append would leave it
            # ahead of the durable log forever — poison the instance so
            # LATER writes wedge loudly instead of persisting state a
            # crash would replay without this record
            try:
                self._wal.append(seq, payload, sync=sync)  # no _mu held
            except Exception as e:
                self._broken = f"append of seq {seq} failed: {e!r}"
                raise
            if self._wal.size() > self.COMPACT_BYTES:
                self._compact_io()

    def submit_deferred(self, txn: KVTransaction) -> int:
        """Memory-apply now, WAL later (group commit).  A crash before
        log_deferred loses the record — which is exactly the window the
        store's on_commit callback has not yet acknowledged."""
        with self._mu:
            self._check_broken()
            self.seq += 1
            self._deferred.append((self.seq, txn.encode()))
            super().submit(txn)
            return self.seq

    def log_deferred(self, upto_seq: int) -> int:
        """Append every deferred record with seq <= upto_seq in ONE
        group (single fsync).  Records staged after upto_seq stay
        deferred: their data-device barrier may not have happened yet
        (data-before-metadata)."""
        with self._io:
            return self._log_deferred_io(upto_seq)

    def _log_deferred_io(self, upto_seq: int) -> int:
        """Caller holds ``_io``.  The backlog is collected under ``_mu``
        but the group append/fsync runs outside it, so event-loop reads
        proceed for the whole barrier duration."""
        with self._mu:
            take = [r for r in self._deferred if r[0] <= upto_seq]
            if not take:
                return 0
            self._deferred = [r for r in self._deferred
                              if r[0] > upto_seq]
        try:
            self._wal.append_many(take, sync=True)  # fsync: no _mu held
        except Exception as e:
            # the taken records left the backlog but never reached the
            # log — memory is ahead of durable state for good
            self._broken = f"group append upto {upto_seq} failed: {e!r}"
            raise
        with self._mu:
            fully_logged = not self._deferred
        if self._wal.size() > self.COMPACT_BYTES and fully_logged:
            # compact only at a fully-logged boundary: the snapshot
            # covers live memory, which includes any still-deferred
            # records — never persist those before their barrier
            self._compact_io()
        return len(take)

    def compact(self) -> None:
        with self._io:
            self._compact_io()

    def _compact_io(self) -> None:
        """Caller holds ``_io``.  The snapshot image is built under
        ``_mu`` (consistent seq + state); the data-device barrier and
        the snapshot write/rename/rotate run outside it.  Ordering: any
        record in the image had its data pwritten before its
        submit_deferred returned (i.e. before the image was built), so
        the barrier AFTER building still covers every block the
        snapshot references (COW data-before-metadata)."""
        with self._mu:
            out = bytearray(struct.pack("<QI", self.seq, len(self._keys)))
            for k in self._keys:
                v = self._map[k]
                out += struct.pack("<I", len(k)) + k
                out += struct.pack("<I", len(v)) + v
        if self.pre_compact_hook is not None:
            self.pre_compact_hook()
        atomic_snapshot(self._snap_path(), bytes(out))
        self._wal.rotate()

    # --- thread-safe read/apply views (commit thread vs event loop) ---
    def get(self, prefix: str, key) -> Optional[bytes]:
        with self._mu:
            return super().get(prefix, key)

    def iterate(self, prefix: str, start=b"", end=None):
        with self._mu:
            rows = list(super().iterate(prefix, start=start, end=end))
        return iter(rows)

    def iterate_all(self):
        with self._mu:
            rows = list(super().iterate_all())
        return iter(rows)

    def close(self) -> None:
        with self._io:
            if self._wal.closed:
                return
            with self._mu:
                upto = self.seq
                backlog = bool(self._deferred)
            if backlog:
                # records can still be pending here when the commit
                # thread died: their data blocks may be pwritten but
                # never fsync'd — run the data barrier FIRST so the
                # WAL flush can't persist metadata ahead of its data
                # (data-before-metadata, same rule as compact)
                if self.pre_compact_hook is not None:
                    self.pre_compact_hook()
                self._log_deferred_io(upto)
            if self._wal.size() > 0:   # nothing new since snapshot?
                self._compact_io()
            self._wal.close()
