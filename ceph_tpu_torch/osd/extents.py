"""Shared-memory payload extents: zero-copy object data across lanes.

The process-lane transport (osd/laneipc.py) carries every message as
its full wire encoding through a bounded SPSC ring.  Profiling
showed ``lane_codec`` scales LINEARLY with object size — a 256 KB
write pays its data payload four times between the client loop and the
lane PG (wire encode, ring copy in, ring copy out, wire decode), and
big frames crowd the ring enough to stall small control traffic behind
them.  This module takes the data bytes off that path:

  * a payload at or above ``osd_lane_extent_min_bytes`` is written
    ONCE into a ref-counted slot of a shared-memory **extent pool**;
    the wire stream carries a tiny ``(pool, gen, offset, len)`` handle
    instead (common/encoding.py ``data_bytes_`` — the marker-tagged
    sibling of ``bytes_``);
  * the receiver materializes LAZILY through the LazyPayload
    discipline (msg/payload.py): the one copy out of shared memory
    happens at first use — store apply, TCP re-encode — never at ring
    decode, so ``lane_codec`` stays flat with object size (the copy is
    attributed to the ``extent_read`` aux stage, the publish to
    ``extent_write``);
  * slots are freed on the COMMIT callback of the consuming side (the
    same callback that releases acks), so a slot's lifetime is exactly
    the op's durability window.

Ownership discipline (the allocator is never shared): each pool has
ONE allocating process — the parent allocates the lane-bound ("tx")
pool, the lane worker allocates the outbound ("out") pool — and the
allocator's book-keeping (free list, refcounts, generations) lives in
that process's plain heap.  Only payload BYTES live in shared memory,
so there is no cross-process atomic anywhere, exactly the SPSC split
the rings use.  Consumers send frees BACK over the existing rings
(FRAME_EXTFREE); a free that reaches a non-owner routes onward via
``set_free_router`` (the parent relays lane-to-lane frees to the
owning lane).

Leak discipline: a dead lane can never strand slots silently —
  * the parent owns the segment lifecycle of BOTH pools and force-
    reclaims every live tx slot on lane death (``sweep_all``), loudly
    counted (``ext_swept``);
  * consumer-side ``ExtentRef``s that are garbage-collected without an
    explicit release are counted (``ext_ref_gc``) and released
    best-effort;
  * ``OBSERVER`` (the schedule explorer's hook, same shape as
    store/commit.py's) sees every alloc/incref/decref/free/sweep, so
    "no extent outlives its last reference" is checkable per schedule.

Generations make frees ABA-safe: a slot's handle embeds the gen it was
allocated under, and a late free (or late fetch) against a reused
offset is refused and counted rather than corrupting the new tenant.

The port's copy of ``ceph_tpu.osd.extents``.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Tuple

_log = logging.getLogger("ceph-tpu-torch.osd.extents")

#: handle tuple shape crossing the wire: (pool name, gen, offset, len)
Handle = Tuple[str, int, int, int]

#: Observer hook for the schedule explorer's extent-lifetime invariant:
#: called as OBSERVER(pool_name, event, offset, refs_after) with event
#: in {"alloc", "incref", "decref", "free", "sweep"}.  None (default)
#: costs one attribute load per transition.
OBSERVER: Optional[Callable[[str, str, int, int], None]] = None

# ---------------------------------------------------------------- counters


class _Counters:
    """Process-wide extent accounting (one process == one parent or one
    lane worker; lanes ship theirs up the metrics plane)."""

    __slots__ = ("allocs", "alloc_bytes", "frees", "alloc_full",
                 "swept", "ref_gc", "stale_free", "unroutable",
                 "reads", "read_bytes")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # gil-atomic:begin allocs,alloc_bytes,frees,alloc_full,swept,ref_gc,stale_free,unroutable,reads,read_bytes
        # test-scoped reset; plain stores are single GIL steps
        self.allocs = 0
        self.alloc_bytes = 0
        self.frees = 0
        self.alloc_full = 0
        self.swept = 0
        self.ref_gc = 0
        self.stale_free = 0
        self.unroutable = 0
        self.reads = 0
        self.read_bytes = 0
        # gil-atomic:end


_C = _Counters()


def counters() -> dict:
    live = sum(p.live for p in _OWNED.values())
    live_bytes = sum(p.live_bytes for p in _OWNED.values())
    return {"ext_allocs": _C.allocs, "ext_alloc_bytes": _C.alloc_bytes,
            "ext_frees": _C.frees, "ext_alloc_full": _C.alloc_full,
            "ext_swept": _C.swept, "ext_ref_gc": _C.ref_gc,
            "ext_stale_free": _C.stale_free,
            "ext_free_unroutable": _C.unroutable,
            "ext_reads": _C.reads, "ext_read_bytes": _C.read_bytes,
            "ext_live": live, "ext_live_bytes": live_bytes}


def reset_counters() -> None:
    _C.reset()


# ------------------------------------------------- aux-stage attribution

#: recorder(stage, seconds) for the tracer's ``extent_write`` /
#: ``extent_read`` aux stages (STAGE18-declared in common/tracer.py).
#: The lane plane installs one per process; None = off-path.
_STAGE_RECORDER: Optional[Callable[[str, float], None]] = None


def set_stage_recorder(fn: Optional[Callable[[str, float], None]]) -> None:
    global _STAGE_RECORDER
    _STAGE_RECORDER = fn


def _record(stage: str, dt: float) -> None:
    rec = _STAGE_RECORDER
    if rec is not None:
        try:
            rec(stage, dt)
        except Exception:
            pass


# -------------------------------------------------------- process registry

#: pools this process ALLOCATES from (owner side): name -> ExtentPool
_OWNED: Dict[str, "ExtentPool"] = {}
#: read-only attachments to foreign pools (consumer side), cached
_VIEWS: Dict[str, "ExtentView"] = {}
#: routes a free for a pool this process neither owns nor can reach
#: directly (the lane pushes FRAME_EXTFREE to the parent; the parent
#: relays to the owning lane).  None = frees for foreign pools are
#: counted unroutable — loud in counters, never silent.
_FREE_ROUTER: Optional[Callable[[Handle], None]] = None


def set_free_router(fn: Optional[Callable[[Handle], None]]) -> None:
    global _FREE_ROUTER
    _FREE_ROUTER = fn


def release(handle: Handle) -> None:
    """Drop one reference on a handle, wherever its owner lives: a
    locally-owned pool decrefs directly; anything else routes through
    the free router (one ring frame, corked like any other)."""
    pool = _OWNED.get(handle[0])
    if pool is not None:
        pool.decref(handle[2], handle[1])
        return
    router = _FREE_ROUTER
    if router is not None:
        router(handle)
        return
    # gil-atomic:begin unroutable stats counter, single GIL step
    _C.unroutable += 1
    # gil-atomic:end
    _log.warning("extent free for %s has no route (pool gone?)",
                 handle[0])


def fetch(handle: Handle) -> bytes:
    """The one copy out of shared memory (extent_read): owner pools
    read their own segment, consumers attach (and cache) a read-only
    view by name."""
    t0 = time.monotonic()
    name, gen, off, ln = handle
    pool = _OWNED.get(name)
    if pool is not None:
        data = pool.read(off, ln, gen)
    else:
        view = _VIEWS.get(name)
        if view is None:
            view = _VIEWS[name] = ExtentView(name)
        data = view.read(off, ln)
    # gil-atomic:begin reads,read_bytes stats counters, single GIL steps
    _C.reads += 1
    _C.read_bytes += ln
    # gil-atomic:end
    _record("extent_read", time.monotonic() - t0)
    return data


def detach_all() -> None:
    """Drop cached consumer views (test teardown aid; segments are
    owned and unlinked by the lane plane)."""
    for view in _VIEWS.values():
        view.close()
    _VIEWS.clear()


# ----------------------------------------------------- decode integration

#: decode-side collector: every ExtentRef minted by Decoder.data_bytes_
#: between begin_collect()/end_collect() on this thread is gathered, so
#: the lane envelope decode can pin a MESSAGE's refs to the message and
#: release them on its commit callback.  Thread-local: parent intake
#: and shard loops decode concurrently.
_collect = threading.local()


def begin_collect() -> None:
    _collect.refs = []


def end_collect() -> List["ExtentRef"]:
    refs = getattr(_collect, "refs", None)
    _collect.refs = None
    return refs or []


def _note_ref(ref: "ExtentRef") -> None:
    refs = getattr(_collect, "refs", None)
    if refs is not None:
        refs.append(ref)


class ExtentRef:
    """Consumer-side handle to one shared-memory payload: bytes-shaped
    enough for the lazy seams (``len``, ``bytes``), materialized (ONE
    copy) at first real use, released explicitly on the consuming op's
    commit callback.  A ref the GC collects un-released is counted
    loudly and released best-effort — never a silent leak."""

    _is_extent_ref = True

    __slots__ = ("name", "gen", "off", "ln", "_data", "_released",
                 "__weakref__")

    def __init__(self, name: str, gen: int, off: int, ln: int):
        self.name = name
        self.gen = gen
        self.off = off
        self.ln = ln
        self._data: Optional[bytes] = None
        self._released = False

    @property
    def handle(self) -> Handle:
        return (self.name, self.gen, self.off, self.ln)

    def materialize(self) -> bytes:
        """Copy the payload out of shared memory, exactly once.  Does
        NOT release the slot — lifetime is the commit callback's call
        (a requeued EAGAIN op may materialize again from the cache)."""
        data = self._data
        if data is None:
            data = self._data = fetch(self.handle)
        return data

    def release(self) -> None:
        """Drop this ref's share of the slot (idempotent)."""
        if self._released:
            return
        self._released = True
        release(self.handle)

    def __len__(self) -> int:
        return self.ln

    def __bytes__(self) -> bytes:
        return self.materialize()

    def __repr__(self):
        state = "cached" if self._data is not None else "lazy"
        return (f"ExtentRef({self.name}+{self.off}:{self.ln}, "
                f"gen={self.gen}, {state})")

    def __del__(self):
        if not self._released:
            # gil-atomic:begin ref_gc stats counter, single GIL step
            _C.ref_gc += 1
            # gil-atomic:end
            try:
                self.release()
            except Exception:
                pass


def make_ref(name: str, gen: int, off: int, ln: int) -> ExtentRef:
    """Decoder factory (registered on common/encoding.py at import):
    mint a ref for a wire handle and note it with the active per-thread
    collector so the envelope decode can pin it to its message."""
    ref = ExtentRef(name, gen, off, ln)
    _note_ref(ref)
    return ref


def materialize(v):
    """Extent-transparent bytes access: plain buffers pass through,
    refs pay their one copy.  The call sites are the points where the
    data is ACTUALLY needed (txn build, socket encode)."""
    if getattr(v, "_is_extent_ref", False):
        return v.materialize()
    return v


def release_message(m) -> None:
    """Release every extent ref the lane decode pinned to ``m`` (the
    commit-callback hook; idempotent, and a no-op for messages that
    never crossed a ring or carried no extents)."""
    refs = getattr(m, "_extent_refs", None)
    if refs:
        for ref in refs:
            ref.release()


# --------------------------------------------------------------- the pool


class ExtentPool:
    """One direction's payload arena: a shared-memory segment plus the
    OWNER-side allocator state (first-fit free list, per-slot refcount
    and generation).  Exactly one process allocates/frees; any process
    may read.  The segment itself is always created (and unlinked) by
    the PARENT so a dying worker can never strand a named segment —
    a worker that owns the ALLOCATOR attaches with ``create=False``
    and starts with an empty book, which is correct: nothing has been
    allocated from its arena yet."""

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 4 << 20, threshold: int = 32768,
                 create: bool = False):
        if create:
            self._shm = shared_memory.SharedMemory(
                create=True, size=max(capacity, 4096))
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        self.name = self._shm.name
        self.capacity = self._shm.size
        #: payloads below this stay inline in the wire stream
        self.threshold = max(1, int(threshold))
        # allocator book (owner-process heap only — never shared):
        self._free: List[List[int]] = [[0, self.capacity]]  # [off, size]
        self._slots: Dict[int, List[int]] = {}   # off -> [len, gen, refs]
        self._gen = 0
        self.created = create

    # ------------------------------------------------------------- observer
    @staticmethod
    def _notify(name: str, event: str, off: int, refs: int) -> None:
        obs = OBSERVER
        if obs is not None:
            obs(name, event, off, refs)

    # ------------------------------------------------------------ allocator
    def put(self, data, refs: int = 1) -> Optional[Handle]:
        """Publish one payload: first-fit slot, one copy in, refcount
        preset to the consumer count.  None when the arena is full —
        the caller falls back to inline bytes (counted, never blocks:
        backpressure belongs to the ring, not the pool)."""
        n = len(data)
        t0 = time.monotonic()
        for i, (off, size) in enumerate(self._free):
            if size >= n:
                break
        else:
            # gil-atomic:begin alloc_full stats counter, single GIL step
            _C.alloc_full += 1
            # gil-atomic:end
            return None
        # the allocator book is OWNER-AFFINE, not GIL-protected: each
        # pool instance is allocated from by exactly one process/loop
        # (parent: tx pool, lane worker: out pool) — consumers only
        # read the segment and send frees back over the rings
        if size == n:
            del self._free[i]
        else:
            # lint: allow[ESC12] owner-affine allocator book (one process per pool)
            self._free[i] = [off + n, size - n]
        # lint: allow[ESC12] owner-affine allocator book (one process per pool)
        self._gen += 1
        gen = self._gen
        self._shm.buf[off:off + n] = bytes(data) if not \
            isinstance(data, (bytes, bytearray, memoryview)) else data
        # lint: allow[ESC12] owner-affine allocator book (one process per pool)
        self._slots[off] = [n, gen, refs]
        # gil-atomic:begin allocs,alloc_bytes stats counters, single GIL steps
        _C.allocs += 1
        _C.alloc_bytes += n
        # gil-atomic:end
        self._notify(self.name, "alloc", off, refs)
        _record("extent_write", time.monotonic() - t0)
        return (self.name, gen, off, n)

    def incref(self, off: int, gen: int) -> bool:
        slot = self._slots.get(off)
        if slot is None or slot[1] != gen:
            return False
        slot[2] += 1
        self._notify(self.name, "incref", off, slot[2])
        return True

    def decref(self, off: int, gen: int) -> None:
        slot = self._slots.get(off)
        if slot is None or slot[1] != gen:
            # late free against a reclaimed/reused slot (ABA guard):
            # refused loudly — the sweep already accounted the slot
            # gil-atomic:begin stale_free stats counter, single GIL step
            _C.stale_free += 1
            # gil-atomic:end
            return
        slot[2] -= 1
        self._notify(self.name, "decref", off, slot[2])
        if slot[2] <= 0:
            self._release_slot(off, slot[0])
            self._notify(self.name, "free", off, 0)

    def _release_slot(self, off: int, n: int) -> None:
        del self._slots[off]
        # gil-atomic:begin frees stats counter, single GIL step
        _C.frees += 1
        # gil-atomic:end
        # coalescing insert keeps the free list from fragmenting into
        # unusably small runs under churn
        free = self._free
        lo = 0
        for i, (foff, fsize) in enumerate(free):
            if foff > off:
                lo = i
                break
            lo = i + 1
        free.insert(lo, [off, n])
        # merge with successor, then predecessor
        if lo + 1 < len(free) and free[lo][0] + free[lo][1] == free[lo + 1][0]:
            free[lo][1] += free[lo + 1][1]
            del free[lo + 1]
        if lo > 0 and free[lo - 1][0] + free[lo - 1][1] == free[lo][0]:
            free[lo - 1][1] += free[lo][1]
            del free[lo]

    def read(self, off: int, ln: int, gen: Optional[int] = None) -> bytes:
        if gen is not None:
            slot = self._slots.get(off)
            if slot is None or slot[1] != gen:
                raise KeyError(
                    f"extent {self.name}+{off} gen {gen} is gone "
                    f"(freed or swept before its last reader)")
        return bytes(self._shm.buf[off:off + ln])

    def sweep_all(self, reason: str) -> int:
        """Force-free every live slot (lane death / teardown).  Loud:
        each swept slot was a leak in the making, and the count is the
        evidence the invariant tests key on."""
        n = len(self._slots)
        for off in list(self._slots):
            ln = self._slots[off][0]
            self._release_slot(off, ln)
            self._notify(self.name, "sweep", off, 0)
        if n:
            # gil-atomic:begin swept stats counter, single GIL step
            _C.swept += n
            # gil-atomic:end
            _log.warning("extent pool %s: swept %d live slot(s) (%s)",
                         self.name, n, reason)
        return n

    # ----------------------------------------------------------- inspection
    @property
    def live(self) -> int:
        return len(self._slots)

    @property
    def live_bytes(self) -> int:
        return sum(s[0] for s in self._slots.values())

    # ------------------------------------------------------------ lifecycle
    def register(self) -> "ExtentPool":
        _OWNED[self.name] = self
        return self

    def close(self) -> None:
        _OWNED.pop(self.name, None)
        try:
            self._shm.close()
        except Exception:
            pass    # lingering lazy views; the unlink still retires it

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except Exception:
            pass


class ExtentView:
    """Read-only consumer attachment to a foreign pool's segment."""

    def __init__(self, name: str):
        self._shm = shared_memory.SharedMemory(name=name)
        self.name = name

    def read(self, off: int, ln: int) -> bytes:
        return bytes(self._shm.buf[off:off + ln])

    def close(self) -> None:
        try:
            self._shm.close()
        except Exception:
            pass


# ------------------------------------------------------ encoder-side sink

class ExtentSink:
    """The Encoder's extent hook (``Encoder.extent_sink``): routes
    over-threshold ``data_bytes_`` payloads into one owning pool.  A
    paper-thin adapter so the codec never sees pool plumbing."""

    __slots__ = ("pool",)

    def __init__(self, pool: ExtentPool):
        self.pool = pool

    @property
    def threshold(self) -> int:
        return self.pool.threshold

    def put(self, data) -> Optional[Handle]:
        return self.pool.put(data)


# register the decoder-side factory (dependency inversion: common/
# never imports osd/, the osd layer plugs its ref type in at import)
def _install_decoder_factory() -> None:
    from ceph_tpu_torch.common.encoding import Decoder
    Decoder.extent_factory = staticmethod(make_ref)


_install_decoder_factory()
