"""ObjectCacher: client-side write-back object cache.

Reference parity: osdc/ObjectCacher.{h,cc} — per-object buffer lists in
clean/dirty/tx states, LRU eviction of clean buffers, background
flusher pushing aged dirty data, flush barriers, and dirty/size limits
(ObjectCacher::flusher_entry, trim, writex/readx).  librbd (cache=true)
and the fs client sit on top of it.

Redesigned for asyncio: buffers are interval lists per object, the
flusher is a task instead of a thread, and the backend is a pair of
awaitable callables (reader/writer) so any stack (rbd data objects,
file data objects) can plug in without knowing about IoCtx.

The port's copy of ``ceph_tpu.client.object_cacher``.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

CLEAN, DIRTY, TX = "clean", "dirty", "tx"
DEAD = "dead"    # overwritten while its flush was in flight


class _Buffer:
    __slots__ = ("off", "data", "state", "stamp")

    def __init__(self, off: int, data: bytes, state: str):
        self.off = off
        self.data = data
        self.state = state
        self.stamp = time.monotonic()

    @property
    def end(self) -> int:
        return self.off + len(self.data)


class ObjectCacher:
    def __init__(self, reader: Callable, writer: Callable,
                 max_dirty: int = 8 << 20, max_bytes: int = 32 << 20,
                 max_dirty_age: float = 1.0):
        """reader(oid, off, length) -> bytes (short read = hole/EOF);
        writer(oid, off, data) -> None, durable on return."""
        self._read_backend = reader
        self._write_backend = writer
        self.max_dirty = max_dirty
        self.max_bytes = max_bytes
        self.max_dirty_age = max_dirty_age
        # oid -> interval list sorted by offset (non-overlapping)
        self._objects: "OrderedDict[str, List[_Buffer]]" = OrderedDict()
        self._dirty_bytes = 0
        self._total_bytes = 0
        self._inflight = 0                 # TX flushes on the wire
        self._tx_done = asyncio.Event()    # pulses per TX completion
        self._flush_wake = asyncio.Event()
        self._flusher_task: Optional[asyncio.Task] = None
        from ceph_tpu_torch.common.lockdep import make_async_lock
        self._lock = make_async_lock("object_cacher:_lock")
        self.stats = {"hit_bytes": 0, "miss_bytes": 0, "flushes": 0,
                      "evictions": 0}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._flusher_task is None:
            self._flusher_task = asyncio.get_running_loop().create_task(
                self._flusher())

    async def stop(self) -> None:
        await self.flush_all()
        if self._flusher_task is not None:
            self._flusher_task.cancel()
            try:
                await self._flusher_task
            except (asyncio.CancelledError, Exception):
                pass
            self._flusher_task = None

    # ------------------------------------------------------------ interval
    def _insert(self, oid: str, off: int, data: bytes,
                state: str) -> None:
        """Install [off, off+len) replacing overlapped ranges."""
        bufs = self._objects.setdefault(oid, [])
        self._objects.move_to_end(oid)
        end = off + len(data)
        out: List[_Buffer] = []
        for b in bufs:
            if b.end <= off or b.off >= end:
                out.append(b)
                continue
            self._account(b, remove=True)
            # fragments of an in-flight (TX) buffer are no longer what
            # the flush will acknowledge: they must be re-flushed, so
            # they re-enter DIRTY; the original is marked DEAD so its
            # completion can't touch accounting twice
            frag_state = DIRTY if b.state in (DIRTY, TX) else CLEAN
            if b.off < off:
                nb = _Buffer(b.off, b.data[:off - b.off], frag_state)
                self._account(nb)
                out.append(nb)
            if b.end > end:
                nb = _Buffer(end, b.data[end - b.off:], frag_state)
                self._account(nb)
                out.append(nb)
            if b.state == TX:
                b.state = DEAD
        nb = _Buffer(off, data, state)
        self._account(nb)
        out.append(nb)
        out.sort(key=lambda b: b.off)
        self._objects[oid] = out

    def _account(self, b: _Buffer, remove: bool = False) -> None:
        d = -1 if remove else 1
        self._total_bytes += d * len(b.data)
        if b.state in (DIRTY, TX):
            self._dirty_bytes += d * len(b.data)

    # ------------------------------------------------------------ data path
    async def write(self, oid: str, off: int, data: bytes) -> None:
        """Write-back: buffer dirty and return; flusher persists.  When
        over max_dirty, block until the flusher drains below the limit
        (ObjectCacher wait_for_dirty throttle)."""
        async with self._lock:
            self._insert(oid, off, bytes(data), DIRTY)
        self._flush_wake.set()
        while self._dirty_bytes > self.max_dirty:
            if await self._flush_some() == 0:
                if self._inflight == 0:
                    break          # nothing flushable remains
                self._tx_done.clear()
                await self._tx_done.wait()   # let in-flight TX land
        self._trim()

    async def read(self, oid: str, off: int, length: int) -> bytes:
        """Serve from buffers; fetch missing ranges through the backend
        and cache them clean."""
        out = bytearray(length)
        missing: List[Tuple[int, int]] = []
        async with self._lock:
            bufs = list(self._objects.get(oid, ()))
            self._objects.move_to_end(oid) if oid in self._objects \
                else None
            pos = off
            end = off + length
            for b in sorted(bufs, key=lambda b: b.off):
                if b.end <= pos or b.off >= end:
                    continue
                if b.off > pos:
                    missing.append((pos, b.off - pos))
                s, e = max(pos, b.off), min(end, b.end)
                out[s - off:e - off] = b.data[s - b.off:e - b.off]
                self.stats["hit_bytes"] += e - s
                pos = e
            if pos < end:
                missing.append((pos, end - pos))
        for m_off, m_len in missing:
            data = await self._read_backend(oid, m_off, m_len)
            self.stats["miss_bytes"] += m_len
            data = data.ljust(m_len, b"\x00")   # holes read as zeros
            out[m_off - off:m_off - off + m_len] = data
            async with self._lock:
                # cache the fetch unless a concurrent write dirtied it
                cur = self._objects.get(oid, ())
                if not any(b.off < m_off + m_len and b.end > m_off
                           and b.state != CLEAN for b in cur):
                    self._insert(oid, m_off, bytes(data), CLEAN)
        self._trim()
        return bytes(out)

    def discard(self, oid: str) -> None:
        """Drop every buffer (object deleted underneath us)."""
        for b in self._objects.pop(oid, ()):
            self._account(b, remove=True)
            if b.state == TX:
                b.state = DEAD

    async def invalidate_all(self) -> None:
        """Flush dirty data then drop every buffer (cache-coherency
        barrier for out-of-band mutations like discard/resize)."""
        await self.flush_all()
        for oid in list(self._objects):
            self.discard(oid)

    # ------------------------------------------------------------ flushing
    async def _flush_some(self, only_oid: Optional[str] = None,
                          min_age: float = 0.0) -> int:
        """Write out dirty buffers (oldest first); returns bytes
        flushed."""
        now = time.monotonic()
        # group per object and coalesce ADJACENT dirty buffers into one
        # backend write — on EC pools each write is a whole-object RMW,
        # so 64 small buffers must not cost 64 RMWs
        work: List[Tuple[str, List[_Buffer]]] = []
        async with self._lock:
            for oid, bufs in self._objects.items():
                if only_oid is not None and oid != only_oid:
                    continue
                run: List[_Buffer] = []
                for b in sorted(bufs, key=lambda b: b.off):
                    if b.state == DIRTY and now - b.stamp >= min_age:
                        b.state = TX
                        self._inflight += 1
                        if run and run[-1].end == b.off:
                            run.append(b)
                        else:
                            if run:
                                work.append((oid, run))
                            run = [b]
                    elif run:
                        work.append((oid, run))
                        run = []
                if run:
                    work.append((oid, run))
        flushed = 0
        pending = list(work)
        while pending:
            oid, run = pending.pop(0)
            data = b"".join(b.data for b in run)
            try:
                await self._write_backend(oid, run[0].off, data)
            except BaseException:
                # includes CancelledError: these bytes may not have
                # landed — and buffers queued BEHIND the failure must
                # not strand in TX either
                async with self._lock:
                    for _, r in [(oid, run)] + pending:
                        for b in r:
                            if b.state == TX:
                                b.state = DIRTY   # retry on next pass
                            self._inflight -= 1
                    self._tx_done.set()
                raise
            flushed += len(data)
            async with self._lock:
                for b in run:
                    if b.state == TX:   # not overwritten meanwhile
                        b.state = CLEAN
                        self._dirty_bytes -= len(b.data)
                    self._inflight -= 1
                self._tx_done.set()
            self.stats["flushes"] += 1
        return flushed

    async def flush(self, oid: str) -> None:
        await self._flush_some(only_oid=oid)

    async def flush_all(self) -> None:
        """Returns only when every dirty byte is durably on the backend
        (in-flight TX included — close() relies on this)."""
        while self._dirty_bytes > 0 or self._inflight > 0:
            if await self._flush_some() == 0:
                if self._inflight == 0:
                    break
                self._tx_done.clear()
                await self._tx_done.wait()

    async def _flusher(self) -> None:
        from ceph_tpu_torch.common.backoff import Backoff
        bo = Backoff("cache_writeback", base=0.25, cap=10.0)
        while True:
            try:
                await asyncio.wait_for(self._flush_wake.wait(),
                                       self.max_dirty_age)
            # lint: allow[RETRY19] timeout IS the flush trigger (dirty-age cadence)
            except asyncio.TimeoutError:
                pass
            self._flush_wake.clear()
            try:
                await self._flush_some(min_age=self.max_dirty_age)
                bo.reset()
            except Exception:
                # backend down: jittered exponential retry (shared
                # policy — was a hardcoded 0.5s that hammered a
                # recovering cluster in lockstep with every client)
                await bo.sleep()

    # ------------------------------------------------------------ trimming
    def _trim(self) -> None:
        """Evict CLEAN buffers LRU (oldest objects first) until under
        max_bytes — single pass, evicting as many as needed."""
        if self._total_bytes <= self.max_bytes:
            return
        for oid in list(self._objects):
            bufs = self._objects[oid]
            keep = []
            for b in bufs:
                if b.state == CLEAN and self._total_bytes > self.max_bytes:
                    self._account(b, remove=True)
                    self.stats["evictions"] += 1
                else:
                    keep.append(b)
            if keep:
                self._objects[oid] = keep
            else:
                del self._objects[oid]
            if self._total_bytes <= self.max_bytes:
                return
