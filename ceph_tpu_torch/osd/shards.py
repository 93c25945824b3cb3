"""Sharded OSD data plane: per-shard event loops + lock-free handoff.

Reference parity: osd/OSD.h ShardedOpWQ (:1748) + the msgr-worker
discipline — PGs hash to shards, each shard owns its queue and worker
thread, and ms_fast_dispatch hands ops straight to the owning shard
instead of executing on the messenger thread.  Queueing and delivery on
the single shared event loop (dep_wait + queue_wait + deliver +
ack_delivery) are a large share of the local write path; this module is
the cut aimed at that share.

Model:

  * An OSD owns ``osd_op_num_shards`` shards (0 = auto: one per core,
    1 = today's single-loop behavior, bit-for-bit).  Each PG has one
    stable home shard (crc32 of the shard-less pgid), and EVERY piece
    of work that touches that PG — client ops, replica sub-ops, acks,
    peering events, scrub/tier passes, map advances, commit callbacks
    — runs on the home shard.  PG state therefore stays single-loop
    and the sequencer and group-commit ordering invariants
    hold per shard with no new locks.

  * The handoff seam is a lock-free single-producer-batched ring
    (``Courier``): producers append to a plain deque (GIL-atomic) and
    arm at most ONE wakeup per burst (``call_soon`` on the same
    thread, ``call_soon_threadsafe`` across threads), so a storm of N
    messages costs N appends + ~1 task wakeup instead of N queue
    round-trips.  The ``osd_shard_handoff`` perf group counts both
    edges — wakeups << ops is the batching evidence.

  * ``osd_shard_threads=true`` gives each shard its own thread running
    its own event loop (the msgr-worker split).  Under the
    deterministic sim loop (the reference's devtools/schedule.py) threads are forced
    off and each shard's pump is an ordinary task on the seeded loop,
    so the schedule explorer permutes shard interleavings exactly like
    any other task wakeups — every explored schedule is one the
    threaded plane could legally produce.

  * Work posted to a shard runs in post order (one FIFO ring per
    shard).  Since every producer for one PG posts through the same
    ring, per-PG arrival order is preserved end to end.

The reference's lint rule SHARD11 (devtools/rules.py) checks the seam: intake/heartbeat
-path functions must not mutate PG state directly — they route through
``ShardedDataPlane.route`` / ``post`` and the PG's home shard runs it.

The port's copy of ``ceph_tpu.osd.shards``.  ``shard_index``,
``resolve_future`` and ``Courier`` serve the mon client and the
messenger's cross-thread sends now; ``Shard`` and ``ShardedDataPlane`` run
under an OSD, and their lane and extent branches import ``osd.lanes`` and
``osd.extents`` only when a configuration asks for them.
"""

from __future__ import annotations

import asyncio
import threading
import zlib
from collections import deque
from typing import Callable, List, Optional

__all__ = ["Courier", "Shard", "ShardedDataPlane", "resolve_future",
           "shard_index"]


def shard_index(pgid, n: int) -> int:
    """Stable pgid -> shard hash (shard-less identity: EC shard
    members of one PG share a home shard with the NO_SHARD instance).
    crc32 is stable across processes/PYTHONHASHSEED, so replayed sim
    schedules and restarted daemons agree on the mapping."""
    if n <= 1:
        return 0
    base = pgid.without_shard()
    return zlib.crc32(b"%d.%d" % (base.pool, base.seed)) % n


def _set_future(fut: asyncio.Future, value, exc) -> None:
    """The target-loop half of resolve_future: runs ON the loop that
    owns ``fut`` (the done re-check closes the cancel race).  A plain
    module-level function — what crosses the loop seam is (function,
    future, value, exc), the id-keyed record shape process lanes use
    (osd/lanes.py resolves its control futures the same way)."""
    if fut.done():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(value)


def resolve_future(fut: asyncio.Future, value=None,
                   exc: Optional[BaseException] = None) -> None:
    """Resolve a future that may belong to ANOTHER shard's loop.
    Daemon-level reply handlers (mon client, tier client) run on the
    intake loop while the awaiting coroutine lives on a PG's home
    shard; setting a foreign loop's future directly is not
    thread-safe, so the set is posted to the owning loop."""
    loop = fut.get_loop()
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        _set_future(fut, value, exc)
    else:
        loop.call_soon_threadsafe(_set_future, fut, value, exc)


class Courier:
    """Batched lock-free handoff of callables onto one target loop.

    ``post`` appends to a deque (append/popleft are GIL-atomic — no
    lock on the hot path) and arms at most one drain callback per
    burst.  The drain clears the armed flag FIRST, so a producer
    racing the drain can at worst schedule one spurious extra wakeup,
    never lose an item.  Used for the shard→messenger outbound seam
    (sends + throttle releases marshalled back to the intake loop,
    corked into one wakeup per burst)."""

    __slots__ = ("loop", "name", "_ring", "_armed", "_thread",
                 "on_flush")

    def __init__(self, loop: asyncio.AbstractEventLoop, name: str,
                 thread_ident: Optional[int] = None):
        self.loop = loop
        self.name = name
        self._ring: deque = deque()
        self._armed = False
        #: the loop's OWNING thread — posts from any other thread take
        #: call_soon_threadsafe.  Callers constructing the courier from
        #: a foreign thread (the messenger's lazy _post_home) MUST pass
        #: the owner explicitly, or same-thread detection would pin to
        #: the wrong thread and skip the cross-thread wakeup
        self._thread = (thread_ident if thread_ident is not None
                        else threading.get_ident())
        #: optional (n_items) observer per drain (perf accounting)
        self.on_flush: Optional[Callable[[int], None]] = None

    def post(self, fn: Callable, *args) -> None:
        # gil-atomic:begin _ring,_armed lock-free producer: deque
        # append is one bytecode-visible C op, and the armed
        # test-and-set races only benignly (at most one spurious
        # extra wakeup, never a lost item — _drain clears first)
        self._ring.append((fn, args))
        if not self._armed:
            self._armed = True
            if threading.get_ident() == self._thread:
                self.loop.call_soon(self._drain)
            else:
                self.loop.call_soon_threadsafe(self._drain)
        # gil-atomic:end

    def _drain(self) -> None:
        # gil-atomic:begin _ring,_armed consumer half: clear-armed
        # strictly before draining (no lost wakeups); popleft is
        # GIL-atomic against concurrent producer appends
        self._armed = False
        ring = self._ring
        n = 0
        while ring:
            fn, args = ring.popleft()
            n += 1
            try:
                fn(*args)
            except Exception:
                # one failing item (a send against a torn-down
                # connection, say) must not strand the rest of the
                # burst — an unflushed throttle release would wedge
                # intake forever
                import logging
                logging.getLogger("ceph-tpu-torch.shards").exception(
                    f"courier {self.name}: posted call failed: {fn}")
        # gil-atomic:end
        if self.on_flush is not None and n:
            self.on_flush(n)


def _call_and_resolve(fut, fn: Callable, *args) -> None:
    """Target-lane half of ShardedDataPlane.call: run the forwarded
    callable and resolve the concurrent.futures handle (exceptions
    cross the thread edge through it)."""
    try:
        fut.set_result(fn(*args))
    except BaseException as e:
        fut.set_exception(e)


class Shard:
    """One shard: a FIFO work ring + the pump that drains it, on the
    shard's own event loop (its own thread when the plane is
    threaded, the host loop otherwise)."""

    def __init__(self, plane: "ShardedDataPlane", idx: int):
        self.plane = plane
        self.idx = idx
        self.ring: deque = deque()
        self._wake_armed = False
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._thread_ident: Optional[int] = None
        self._evt: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._stopping = False
        self._busy = False       # pump mid-item (drain barrier)

    # ------------------------------------------------------------ lifecycle
    def start(self, host_loop: asyncio.AbstractEventLoop,
              threaded: bool) -> None:
        if threaded:
            ready = threading.Event()

            def run() -> None:
                loop = asyncio.new_event_loop()
                asyncio.set_event_loop(loop)
                self.loop = loop
                self._thread_ident = threading.get_ident()
                self._evt = asyncio.Event()
                self._pump_task = loop.create_task(self._pump())
                ready.set()
                try:
                    loop.run_forever()
                finally:
                    # let cancellation finallys run before closing
                    try:
                        pending = asyncio.all_tasks(loop)
                        for t in pending:
                            t.cancel()
                        if pending:
                            loop.run_until_complete(asyncio.gather(
                                *pending, return_exceptions=True))
                    except Exception:
                        pass
                    asyncio.set_event_loop(None)
                    loop.close()

            self._thread = threading.Thread(
                target=run, daemon=True,
                name=f"osd{self.plane.osd.whoami}-shard{self.idx}")
            self._thread.start()
            ready.wait()
        else:
            self.loop = host_loop
            self._thread_ident = threading.get_ident()
            self._evt = asyncio.Event()
            self._pump_task = host_loop.create_task(self._pump())

    def _finish_stop(self) -> None:
        """Teardown control, run ON the shard's own loop (the bound
        method IS the portable form: routing key + method name — the
        process-lane analogue is the STOP control frame)."""
        if self._pump_task is not None:
            self._pump_task.cancel()
        self.loop.call_soon(self.loop.stop)

    async def stop(self) -> None:
        """Stop the pump (and the shard thread).  Posted work already
        in the ring drains first; the caller has stopped the PGs."""
        self._stopping = True
        if self._thread is not None:
            try:
                self.loop.call_soon_threadsafe(self._finish_stop)
            except RuntimeError:
                pass
            self._thread.join(timeout=30.0)
            self._thread = None
        else:
            if self._pump_task is not None:
                self._pump_task.cancel()
                try:
                    await self._pump_task
                except (asyncio.CancelledError, Exception):
                    pass
                self._pump_task = None

    # -------------------------------------------------------------- handoff
    def post(self, fn: Callable, *args) -> None:
        """Enqueue one unit of work for this shard, from any thread.
        Lock-free (deque append) + batched wakeup: only the first post
        of a burst schedules the pump."""
        # gil-atomic:begin ring,_wake_armed lock-free handoff: the
        # append is GIL-atomic and the wake flag's test-and-set races
        # only benignly (at most one spurious wakeup; the pump's
        # clear-before-drain means none is ever lost).  The handoff
        # perf counters ride the same region (benign count drift is
        # accepted; exactness would cost a lock on the hot path)
        self.ring.append((fn, args))
        perf = self.plane.perf
        if perf is not None:
            perf.inc("handoff_ops")
        if not self._wake_armed:
            self._wake_armed = True
            if perf is not None:
                perf.inc("handoff_wakeups")
            if threading.get_ident() == self._thread_ident:
                self.loop.call_soon(self._wake)
            else:
                self.loop.call_soon_threadsafe(self._wake)
        # gil-atomic:end

    def _wake(self) -> None:
        # gil-atomic:begin ring,_wake_armed pump-side flag clear:
        # strictly before the event set, so a producer racing this
        # callback re-arms rather than losing its wakeup
        self._wake_armed = False
        if self._evt is not None:
            self._evt.set()
        # gil-atomic:end

    async def _pump(self) -> None:
        """The shard's worker: drains the ring in FIFO order.  Work
        items are synchronous (queue_op, advance_map, reply handlers);
        anything long-running spawns its own task on THIS loop, so the
        pump stays responsive — exactly the ShardedOpWQ worker
        discipline."""
        from ceph_tpu_torch.msg.message import Message
        ring = self.ring
        evt = self._evt
        osd = self.plane.osd
        log = osd.logger
        while not self._stopping:
            if ring:
                # gil-atomic:begin ring,_wake_armed single consumer:
                # the ring cannot empty between the check and the pop
                # (producers only ever append), so popleft against
                # concurrent GIL-atomic appends is safe.
                # _busy BEFORE the pop: drain() polls (ring or _busy)
                # from the intake thread, and a pop-then-set window
                # would let teardown proceed mid-item.
                self._busy = True
                fn, args = ring.popleft()
                # gil-atomic:end
                try:
                    fn(*args)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception(
                        f"shard {self.idx} work item failed: {fn}")
                    # a failed handler must not leak its message's
                    # intake budget (the legacy _dispatch path's
                    # guarantee): enough leaks wedge client intake
                    for a in args:
                        if isinstance(a, Message):
                            osd.messenger.put_dispatch_throttle(a)
                finally:
                    self._busy = False
                continue
            evt.clear()
            if ring:
                continue      # posted between drain and clear
            await evt.wait()

    # ----------------------------------------------------------- utilities
    def on_shard(self) -> bool:
        return threading.get_ident() == self._thread_ident


class ShardedDataPlane:
    """The OSD's shard set + routing seam.

    ``enabled`` is False at ``osd_op_num_shards=1``: every route() is
    a plain inline call and nothing else changes — the documented
    backward-compat mode.  At N>1 the plane owns N shard
    pumps (threads when ``osd_shard_threads`` and the host loop is a
    real one) and the messenger's intake classifies op-class messages
    straight onto the owning shard's ring."""

    def __init__(self, osd):
        self.osd = osd
        cfg = osd.cfg
        n = int(cfg["osd_op_num_shards"])
        if n <= 0:
            import os
            n = min(8, os.cpu_count() or 1)
        self.num_shards = max(1, n)
        self.enabled = self.num_shards > 1
        self.threaded = False
        # lane backend (osd_shard_lanes = inline | thread | process):
        # "auto" preserves the pre-lane knob (osd_shard_threads)
        lanes = str(cfg["osd_shard_lanes"] or "auto")
        if lanes == "auto":
            lanes = "thread" if cfg["osd_shard_threads"] else "inline"
        self.lane_backend = lanes
        #: the backend actually running (sim forces inline; see start)
        self.active_backend = "inline"
        self.process_lanes: Optional[List] = None
        self.shards: List[Shard] = [Shard(self, i)
                                    for i in range(self.num_shards)]
        self.perf = None
        if self.enabled:
            self.perf = osd.ctx.perf.create("osd_shard_handoff")
            for key in ("handoff_ops", "handoff_wakeups",
                        "direct_local_ops", "subop_inline"):
                self.perf.add_u64(key)
        self._host_loop: Optional[asyncio.AbstractEventLoop] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._host_loop = loop
        if not self.enabled:
            return
        backend = self.lane_backend
        # thread AND process lanes are forced OFF under the
        # deterministic sim loop: the schedule explorer owns every
        # interleaving, and a real thread or worker process would be
        # the one wakeup source it cannot permute or replay — under
        # SIM every lane backend degrades to inline pumps the seeded
        # scheduler interleaves like any other task
        if getattr(loop, "deterministic", False):
            backend = "inline"
        self.active_backend = backend
        if backend == "process":
            from ceph_tpu_torch.osd import lanes as lanes_mod
            self.process_lanes = [lanes_mod.ProcessLane(self, i)
                                  for i in range(self.num_shards)]
            for lane in self.process_lanes:
                lane.start()
            self.threaded = False
            # lane->lane fastpath registry: same-host replication
            # frames route still-encoded to the target OSD's lane;
            # gated by the same knob as every local-delivery shortcut
            if bool(self.osd.cfg["ms_local_delivery"]):
                lanes_mod.register_local_plane(
                    self.osd.messenger.addr, self)
            return
        self.threaded = backend == "thread"
        for s in self.shards:
            s.start(loop, self.threaded)

    async def stop(self) -> None:
        if not self.enabled:
            return
        if self.process_lanes is not None:
            from ceph_tpu_torch.osd import lanes as lanes_mod
            lanes_mod.unregister_local_plane(self.osd.messenger.addr)
            for lane in self.process_lanes:
                await lane.stop()
            self.process_lanes = None
            return
        for s in self.shards:
            await s.stop()

    # -------------------------------------------------------------- routing
    def shard_for(self, pgid):
        idx = shard_index(pgid, self.num_shards)
        if self.process_lanes is not None:
            return self.process_lanes[idx]
        return self.shards[idx]

    def broadcast_map(self, osdmap) -> None:
        """Process lanes: ship each new full map to every lane worker
        (the per-lane _advance_pgs runs THERE, against the lane's own
        PG registry and store)."""
        if self.process_lanes is not None:
            for lane in self.process_lanes:
                lane.post_map(osdmap)

    def route(self, pgid, fn: Callable, *args) -> None:
        """Run fn(*args) on pgid's home shard.  Inline when the plane
        is disabled (shards=1: today's behavior, same call stack) or
        when the caller is already on the home shard."""
        if not self.enabled:
            fn(*args)
            return
        shard = self.shard_for(pgid)
        if shard.on_shard() and not shard.ring:
            # already home and nothing queued ahead: run now (keeps
            # same-shard send->handle paths synchronous, e.g. a
            # backend completing a pull inline)
            fn(*args)
            return
        shard.post(fn, *args)

    def post(self, pgid, fn: Callable, *args) -> None:
        """Like route() but ALWAYS via the ring (never inline), for
        callers that must not re-enter (e.g. teardown sweeps)."""
        if not self.enabled:
            fn(*args)
            return
        self.shard_for(pgid).post(fn, *args)

    async def call(self, shard: Shard, fn: Callable, *args):
        """Run fn on a shard and await its result from a foreign
        loop (used by teardown and admin introspection)."""
        if not self.enabled or (getattr(shard, "loop", None)
                                is self._host_loop
                                and shard.on_shard()):
            return fn(*args)
        import concurrent.futures
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        # id-keyed admin RPC shape: what crosses the seam is (module
        # function, future handle, forwarded callable+args) — the
        # target lane runs fn and resolves the handle (process lanes
        # use the FRAME_RPC/FRAME_RESP pair for the same contract)
        shard.post(_call_and_resolve, fut, fn, *args)
        return await asyncio.wrap_future(fut)

    async def drain(self) -> None:
        """Wait until every shard's ring is empty (quiesce aid for
        tests and the schedule explorer).  Process lanes quiesce via
        the id-keyed ping: the pong proves every frame posted before
        it was consumed (ring FIFO)."""
        if not self.enabled:
            return
        if self.process_lanes is not None:
            for lane in self.process_lanes:
                if not lane.dead:
                    try:
                        await lane.ping()
                    except Exception:
                        pass     # dead/stopping lane: nothing to drain
            return
        while any(s.ring or s._busy for s in self.shards):
            # inline lanes: yield so the pumps (same loop) can run;
            # threaded: back off instead of spinning against the GIL
            await asyncio.sleep(0.001 if self.threaded else 0)

    # ---------------------------------------------------------- inspection
    def lane_metric_snapshots(self) -> dict:
        """Latest metrics-plane snapshot per process lane (periodic
        FRAME_STATS push or the last on-demand fetch); entries are
        None until a lane has reported.  Empty at inline/thread lanes
        — those share the parent's PerfCountersCollection already."""
        if self.process_lanes is None:
            return {}
        return {lane.idx: lane.metrics for lane in self.process_lanes}

    async def fetch_lane_metrics(self) -> list:
        """On-demand cluster-scrape half of the metrics plane: ask
        every live lane for a fresh full dump over the id-keyed
        FRAME_RPC path.  Returns the indices of DEAD/unreachable lanes
        — the caller must surface them loudly, never as an empty
        snapshot."""
        if self.process_lanes is None:
            return []
        live = [ln for ln in self.process_lanes if not ln.dead]
        dead = [ln.idx for ln in self.process_lanes if ln.dead]
        # concurrent scrape: one wedged lane costs one timeout total
        results = await asyncio.gather(
            *[ln.admin_rpc({"prefix": "metrics"}) for ln in live],
            return_exceptions=True)
        for ln, r in zip(live, results):
            if isinstance(r, BaseException):
                dead.append(ln.idx)
            else:
                ln.metrics = r
        return sorted(dead)

    def counters(self) -> dict:
        if self.perf is None:
            d = {"handoff_ops": 0, "handoff_wakeups": 0,
                 "direct_local_ops": 0}
        else:
            d = self.perf.dump()
        d["num_shards"] = self.num_shards
        d["threaded"] = self.threaded
        d["lane_backend"] = self.active_backend
        # shard->messenger marshalling (sends + throttle releases
        # posted back to the intake loop, corked per burst)
        msgr = self.osd.messenger
        d["outbound_msgs"] = msgr._xthread_msgs
        d["outbound_flushes"] = msgr._xthread_flushes
        if self.process_lanes is not None:
            # courier counters go PER LANE (frames/bytes/stalls each)
            d["lanes"] = {lane.idx: lane.counters()
                          for lane in self.process_lanes}
            from ceph_tpu_torch.osd import extents as ext_mod
            d["extents"] = ext_mod.counters()
        return d
