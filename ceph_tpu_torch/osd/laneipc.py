"""Shared-memory ring frames: the process-lane handoff transport.

The sharded data plane's thread lanes hand work across with a plain
deque because the GIL makes append/popleft atomic; a PROCESS lane has
no shared heap, so the ring becomes explicit bytes: a single-producer /
single-consumer ring buffer in a ``multiprocessing.shared_memory``
segment carrying length-prefixed frames, plus a wake channel.

Design (one ``ShmRing`` per direction, two per lane):

  * Layout: ``[head u64][tail u64][waiting u32][pad][data ...]``.
    ``head``/``tail`` are monotonically increasing byte cursors
    (position = cursor % capacity); the producer only ever writes
    ``tail``, the consumer only ``head`` — the classic SPSC split, so
    no cross-process lock exists anywhere on the data path.
  * Frames are ``[u32 length][payload]``, wrapped byte-wise at the
    capacity boundary (a frame may straddle the wrap).
  * Backpressure is the ring bound: ``try_push`` returns False when
    the frame does not fit, and the producer retries — the exact role
    the bounded kv-sync queue and the dispatch throttle play on their
    seams.  Nothing is ever dropped or overwritten.
  * Wakeups follow the Courier discipline across the process edge:
    the consumer advertises ``waiting=1`` in the segment, RE-CHECKS
    the ring, then parks on its wake connection; the producer pushes
    first and writes one wake byte only if the consumer advertises
    waiting (a burst against a busy consumer costs zero syscalls).
    Either the producer reads ``waiting=1`` and sends the byte, or
    the consumer's post-advertise re-check sees the data — no lost
    wakeup, no polling on the hot path.
  * Crash detection is the caller's job (the lane plane watches the
    worker's sentinel fd); a dead peer turns pending work into LOUD
    failures (``LaneDead``), never phantom acks.

Frames carry a one-byte kind tag (``FRAME_*``) followed by the body;
every body is plain bytes — messages cross in their byte-identical
wire encoding (the lazy-payload discipline's cheap cross-process
form), everything else as small scalar records.

The port's copy of ``ceph_tpu.osd.laneipc``: the ring layout and the
frame bytes are the JAX package's, so a ring written by either package
reads in the other.
"""

from __future__ import annotations

import struct
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

__all__ = ["ShmRing", "FRAME_MSG", "FRAME_OUT", "FRAME_MAP",
           "FRAME_RPC", "FRAME_RESP", "FRAME_STOP", "FRAME_BYE",
           "FRAME_PING", "FRAME_PONG", "FRAME_STATS", "FRAME_BURST",
           "FRAME_EXTFREE", "LaneDead", "pack_frame", "unpack_frame",
           "pack_bursts", "unpack_burst", "pack_extfree",
           "unpack_extfree"]

# frame kinds (first byte of every frame payload)
FRAME_MSG = 1     # parent -> lane: one PG-bound message (envelope+wire)
FRAME_OUT = 2     # lane -> parent: one outbound message (addr+wire)
FRAME_MAP = 3     # parent -> lane: one full osdmap (wire bytes)
FRAME_RPC = 4     # id-keyed control call; DIRECTION disambiguates:
#                   lane->parent = mon command on the lane's behalf,
#                   parent->lane = dump/metrics request (the lane-
#                   complete admin plane).  Ids are allocated by the
#                   sender and scoped to its direction's ring.
FRAME_RESP = 5    # id-keyed reply, opposite direction of its request
FRAME_STOP = 6    # parent -> lane: drain + shut down
FRAME_BYE = 7     # lane -> parent: clean shutdown acknowledged
FRAME_PING = 8    # parent -> lane: id-keyed quiesce probe; carries the
#                   parent's monotonic send stamp + its current best
#                   parent->lane clock-offset estimate (span continuity)
FRAME_PONG = 9    # lane -> parent: probe reply (ring drained to here)
#                   + the lane's monotonic receive stamp
FRAME_STATS = 10  # lane -> parent: periodic PG stat rows + metrics
#                   snapshot + slow-op count (json)
FRAME_BURST = 11  # either direction: every frame the producer corked
#                   in one loop pass, concatenated [u32 len][frame]...
#                   — ONE ring push + ONE wakeup per burst, the Courier
#                   batched-handoff discipline applied to the ring edge
FRAME_EXTFREE = 12  # consumer -> extent-pool owner: refcount drops for
#                   shared-memory payload extents (osd/extents.py),
#                   batched [count u32] then per-entry
#                   [name str][gen u32][off u32][len u32]; rides the
#                   cork like any other frame

_HDR = 24                      # head u64 | tail u64 | waiting u32 | pad
_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_WAIT = 16


class LaneDead(RuntimeError):
    """The peer process is gone; queued/pending work cannot complete.
    Raised LOUDLY — a dead lane must never look like a slow one."""


class ShmRing:
    """SPSC byte ring in shared memory (see module docstring).  One
    side constructs with ``create=True`` and passes ``name`` to the
    other, which attaches.  Each side then uses exactly one of the
    push/pop halves — the SPSC contract is the caller's to keep (the
    lane plane owns one ring per direction).  The wake CHANNEL (a
    ``multiprocessing.Pipe`` connection pair) is owned by the lane
    plane — connections pickle across a spawn boundary, raw pipe fds
    do not — and this class only carries the ``waiting`` flag half of
    the no-lost-wakeup handshake."""

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 1 << 20, create: bool = False):
        if create:
            self._shm = shared_memory.SharedMemory(
                create=True, size=_HDR + capacity)
            self.capacity = capacity
            struct.pack_into("<QQQ", self._shm.buf, 0, 0, 0, 0)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            # attach side takes the CREATOR's capacity when given:
            # some platforms round the segment up to a page multiple,
            # and a consumer wrapping at a different modulus than the
            # producer would corrupt every frame after the first wrap
            self.capacity = capacity if capacity and \
                capacity <= self._shm.size - _HDR \
                else self._shm.size - _HDR
            # NOTE on the resource tracker: spawn workers inherit the
            # parent's tracker daemon, and register() dedupes by name
            # — the attach-side registration collapses into the
            # creator's, and the creator's unlink() retires it.  Do
            # NOT unregister here: that would steal the creator's
            # registration out of the shared tracker.
        self.name = self._shm.name
        # producer-side accounting (per-lane courier counters)
        self.pushed = 0
        self.push_bytes = 0
        self.full_stalls = 0
        # consumer-side accounting (same per-lane discipline; ONE
        # consumer per ring by the SPSC contract)
        self.popped = 0
        self.pop_bytes = 0

    # ------------------------------------------------------------ cursors
    def _load(self, off: int) -> int:
        return struct.unpack_from("<Q", self._shm.buf, off)[0]

    def _store(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self._shm.buf, off, v)

    def _copy_in(self, pos: int, data: bytes) -> None:
        cap = self.capacity
        buf = self._shm.buf
        pos %= cap
        n = len(data)
        first = min(n, cap - pos)
        buf[_HDR + pos:_HDR + pos + first] = data[:first]
        if first < n:
            buf[_HDR:_HDR + n - first] = data[first:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        cap = self.capacity
        buf = self._shm.buf
        pos %= cap
        first = min(n, cap - pos)
        out = bytes(buf[_HDR + pos:_HDR + pos + first])
        if first < n:
            out += bytes(buf[_HDR:_HDR + n - first])
        return out

    # ----------------------------------------------------------- producer
    def try_push(self, payload: bytes) -> bool:
        """Append one frame; False when it does not fit (backpressure
        — retry after the consumer drains).  Frames larger than the
        whole ring are a hard error: they could NEVER fit."""
        need = 4 + len(payload)
        if need > self.capacity:
            raise ValueError(
                f"frame of {len(payload)}B exceeds ring capacity "
                f"{self.capacity}B — raise osd_lane_ring_bytes")
        head = self._load(_OFF_HEAD)
        tail = self._load(_OFF_TAIL)
        if need > self.capacity - (tail - head):
            # gil-atomic:begin full_stalls,pushed,push_bytes
            # producer-side stats: ONE producer per ring by the SPSC
            # contract; the adds are single GIL steps either way
            self.full_stalls += 1
            # gil-atomic:end
            return False
        self._copy_in(tail, struct.pack("<I", len(payload)))
        self._copy_in(tail + 4, payload)
        # the tail store is the publish point: the consumer reads the
        # length/payload only for cursors < tail
        self._store(_OFF_TAIL, tail + need)
        # gil-atomic:begin pushed,push_bytes same producer-side stats
        # discipline as the stall counter above
        self.pushed += 1
        self.push_bytes += need
        # gil-atomic:end
        return True

    def peer_waiting(self) -> bool:
        """Producer half of the handshake: consult AFTER the push."""
        return bool(struct.unpack_from("<I", self._shm.buf,
                                       _OFF_WAIT)[0])

    # ----------------------------------------------------------- consumer
    def try_pop(self) -> Optional[bytes]:
        head = self._load(_OFF_HEAD)
        tail = self._load(_OFF_TAIL)
        if tail == head:
            return None
        ln = struct.unpack("<I", self._copy_out(head, 4))[0]
        payload = self._copy_out(head + 4, ln)
        self._store(_OFF_HEAD, head + 4 + ln)
        # gil-atomic:begin popped,pop_bytes consumer-side stats: ONE
        # consumer per ring by the SPSC contract; single GIL steps
        self.popped += 1
        self.pop_bytes += 4 + ln
        # gil-atomic:end
        return payload

    def drain(self, limit: int = 0) -> List[bytes]:
        out: List[bytes] = []
        while True:
            got = self.try_pop()
            if got is None:
                return out
            out.append(got)
            if limit and len(out) >= limit:
                return out

    def advertise_waiting(self, flag: bool) -> None:
        """Consumer half of the handshake: set BEFORE parking, then
        re-check the ring — the producer pushes first and checks the
        flag after, so one of the two sides always sees the data."""
        struct.pack_into("<I", self._shm.buf, _OFF_WAIT,
                         1 if flag else 0)

    @property
    def backlog_bytes(self) -> int:
        return self._load(_OFF_TAIL) - self._load(_OFF_HEAD)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        try:
            self._shm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except Exception:
            pass


# ------------------------------------------------------------ frame codecs

def pack_frame(kind: int, body: bytes = b"") -> bytes:
    return bytes([kind]) + body


def unpack_frame(frame: bytes) -> Tuple[int, bytes]:
    return frame[0], frame[1:]


def pack_bursts(frames: List[bytes], cap: int) -> List[bytes]:
    """Cork ``frames`` into as few FRAME_BURST frames as fit the ring:
    one burst per ~cap/2 bytes so a single cork can never exceed ring
    capacity (which try_push hard-errors on).  A frame that is alone in
    its burst goes out AS ITSELF — the burst envelope only pays for
    itself when it actually coalesces."""
    budget = max(1, cap // 2)
    out: List[bytes] = []
    batch: List[bytes] = []
    size = 0
    def flush():
        if not batch:
            return
        if len(batch) == 1:
            out.append(batch[0])
        else:
            out.append(bytes([FRAME_BURST]) + b"".join(
                struct.pack("<I", len(f)) + f for f in batch))
        del batch[:]
    for f in frames:
        if batch and size + 4 + len(f) > budget:
            flush()
            size = 0
        batch.append(f)
        size += 4 + len(f)
    flush()
    return out


def unpack_burst(body: bytes) -> List[bytes]:
    out: List[bytes] = []
    off = 0
    n = len(body)
    while off < n:
        ln = struct.unpack_from("<I", body, off)[0]
        off += 4
        out.append(body[off:off + ln])
        off += ln
    return out


def pack_extfree(handles: List[Tuple[str, int, int, int]]) -> bytes:
    """FRAME_EXTFREE body: batched extent refcount drops."""
    parts = [struct.pack("<I", len(handles))]
    for name, gen, off, ln in handles:
        nb = name.encode("utf-8")
        parts.append(struct.pack("<I", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<III", gen, off, ln))
    return b"".join(parts)


def unpack_extfree(body: bytes) -> List[Tuple[str, int, int, int]]:
    count = struct.unpack_from("<I", body, 0)[0]
    off = 4
    out: List[Tuple[str, int, int, int]] = []
    for _ in range(count):
        nl = struct.unpack_from("<I", body, off)[0]
        off += 4
        name = body[off:off + nl].decode("utf-8")
        off += nl
        gen, soff, ln = struct.unpack_from("<III", body, off)
        off += 12
        out.append((name, gen, soff, ln))
    return out
