"""Shared write-ahead log: checksummed append records + torn-tail recovery
(the port's copy of ``ceph_tpu.store.wal``).

Reference parity: os/filestore/FileJournal (journal-ahead rule: a record is
durable once fsync'd; replay discards a torn tail).  One helper serves both
the kv backend (kv.FileDB) and the object store (filestore.FileStore) so the
record framing, replay, truncation and rotation logic exist exactly once.

Recovery contract: ``replay()`` returns the valid (seq, payload) records AND
truncates the file to the last valid byte, so records appended after a
recovered crash are reachable by the next replay (appending after garbage
would orphan them).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

_REC_HDR = struct.Struct("<IIQ")   # crc32, payload_len, seq


def fsync_dir(path: str) -> None:
    """Durably persist a directory entry (after os.replace/creat)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WriteAheadLog:
    def __init__(self, path: str):
        self.path = path
        self._f = None

    def replay(self) -> List[Tuple[int, bytes]]:
        """Read valid records, truncate any torn tail, open for append."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            data = b""
        records: List[Tuple[int, bytes]] = []
        off = valid_end = 0
        while off + _REC_HDR.size <= len(data):
            crc, ln, seq = _REC_HDR.unpack_from(data, off)
            payload = data[off + _REC_HDR.size: off + _REC_HDR.size + ln]
            if len(payload) != ln or zlib.crc32(payload) != crc:
                break  # torn tail: discard the rest
            records.append((seq, payload))
            off += _REC_HDR.size + ln
            valid_end = off
        if valid_end < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
        self._f = open(self.path, "ab")
        return records

    def open(self) -> None:
        if self._f is None or self._f.closed:
            self._f = open(self.path, "ab")

    def append(self, seq: int, payload: bytes, sync: bool = True) -> None:
        self.append_many([(seq, payload)], sync=sync)

    def append_many(self, recs: List[Tuple[int, bytes]],
                    sync: bool = True) -> None:
        buf = bytearray()
        for seq, payload in recs:
            buf += _REC_HDR.pack(zlib.crc32(payload), len(payload), seq)
            buf += payload
        good = self._f.tell()
        try:
            self._f.write(buf)
            self._f.flush()
            if sync:
                os.fsync(self._f.fileno())
        except OSError:
            # a partial record mid-log would orphan every later fsync'd
            # record at the next replay (CRC scan stops at the tear) —
            # roll the file back to the last good byte before re-raising
            try:
                self._f.truncate(good)
                self._f.seek(good)
            except OSError:
                pass
            raise

    def size(self) -> int:
        return self._f.tell() if self._f else 0

    def rotate(self) -> None:
        """Empty the log (after the caller persisted a snapshot)."""
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.flush()
        os.fsync(self._f.fileno())

    @property
    def closed(self) -> bool:
        return self._f is None or self._f.closed

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


def atomic_snapshot(path: str, data: bytes) -> None:
    """Atomically replace ``path`` with data, durably: write sidecar tmp,
    fsync it, rename over, fsync the directory (rename must hit disk
    before the caller empties its WAL — the snapshot+log crash rule)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")
