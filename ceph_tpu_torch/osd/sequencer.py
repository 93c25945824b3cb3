"""Per-PG op pipelining: a dependency-tracked in-flight window.

Reference parity: the combination of ShardedOpWQ (osd/OSD.h:1748 — many
ops in flight per PG) with ObjectContext rw-state tracking
(osd/osd_types.h ObjectContext::RWState — writes to one object
serialize, reads share) and the in-order repop completion discipline
(ReplicatedPG::eval_repop applies commits in pglog order).  A window of
ONE client op per PG (the worker awaited the full replica
round trip before the next dequeue); this module is the op-dependency
tracking that widening it needs.

Model:
  * the PG worker stays the single ADMITTER: it dequeues in FIFO order,
    waits for a free window slot (osd_pg_max_inflight_ops), registers
    the op's object dependency synchronously — so per-object order is
    exactly queue order — and spawns the op as its own task.
  * dependencies are keyed by object id: writes are exclusive per
    object (queue behind every earlier op on it), reads share (queue
    only behind the last write).  Ops on disjoint objects run fully
    concurrently.
  * BARRIER ops (scrub boundaries, tier-agent passes, pool-scope ops
    with no object id, peering/epoch changes) drain the window first
    and run alone — the whole-PG dependency class.
  * versions/commit order: admission fixes per-object order only; log
    versions are assigned inside the backend's await-free submit
    section (version -> append_log -> queue_transactions -> fan-out
    with no await between them), so pglog versions stay dense and the
    group-commit callbacks — last_complete, repop acks, EC sub-op
    acks — still fire in exact pglog submission order.

The port's copy of ``ceph_tpu.osd.sequencer``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional


class _ObjGate:
    """Per-object dependency tail: the last admitted writer's done
    future plus every reader admitted since it."""

    __slots__ = ("write_tail", "readers")

    def __init__(self):
        self.write_tail: Optional[asyncio.Future] = None
        self.readers: List[asyncio.Future] = []


class OpSlot:
    """One admitted op's place in the window: what it must wait for
    and the future later ops key their own waits on."""

    __slots__ = ("oid", "write", "done", "waits")

    def __init__(self, oid: str, write: bool, done: asyncio.Future,
                 waits: List[asyncio.Future]):
        self.oid = oid
        self.write = write
        self.done = done
        self.waits = waits

    async def wait(self) -> None:
        """Block until every predecessor on this object finished.
        Predecessors resolve their futures unconditionally (success,
        error or abort), so a failed op can never wedge its chain."""
        for f in self.waits:
            if not f.done():
                await f


class OpSequencer:
    """The per-PG in-flight window (see module docstring).

    All registration/release steps are synchronous; only slot waiting
    and draining await — asyncio's run-to-completion makes the
    bookkeeping race-free without locks."""

    def __init__(self, max_inflight: int, perf=None, tracer=None):
        self.max_inflight = max(1, int(max_inflight))
        self.active = 0            # admitted, not yet released
        self.max_depth = 0         # high-water mark (counter)
        self._gates: Dict[str, _ObjGate] = {}
        self._slot_free = asyncio.Event()
        self._slot_free.set()
        self._idle = asyncio.Event()
        self._idle.set()
        self.perf = perf           # shared "osd_op_window" group or None
        self.tracer = tracer       # op tracer (stage histograms) or None

    # -------------------------------------------------------------- admit
    async def wait_slot(self, span=None) -> None:
        """Admission backpressure: block the admitter while the window
        is full (the op queue keeps buffering behind it, and the
        messenger dispatch throttle pushes back on clients).  A traced
        op cuts `queue_wait_pump` (dispatch -> here: PG op-queue dwell
        behind a busy worker — one of the named queue-wait causes) on
        entry and `admit_wait` (a full window's slot wait) on exit."""
        if span is not None and self.tracer is not None:
            span.cut("queue_wait_pump", self.tracer.hist)
        while self.active >= self.max_inflight:
            self._slot_free.clear()
            await self._slot_free.wait()
        if span is not None and self.tracer is not None:
            span.cut("admit_wait", self.tracer.hist)

    # awaitfree:begin sequencer-admit-release (admission registration
    # and slot release are synchronous BY CONTRACT — the window's
    # bookkeeping is race-free only because no suspension point can
    # interleave two admissions; devtools rule AF01 enforces it)
    def admit(self, oid: str, write: bool) -> OpSlot:
        """Synchronously register one op: takes a window slot and links
        it into its object's dependency chain.  MUST be called from the
        single admitter with a free slot (wait_slot)."""
        loop = asyncio.get_running_loop()
        done = loop.create_future()
        gate = self._gates.get(oid)
        if gate is None:
            gate = self._gates[oid] = _ObjGate()
        waits: List[asyncio.Future] = []
        if write:
            # exclusive: behind the last writer AND every reader since
            if gate.write_tail is not None:
                waits.append(gate.write_tail)
            waits.extend(gate.readers)
            gate.write_tail = done
            gate.readers = []
        else:
            # shared: behind the last writer only
            if gate.write_tail is not None:
                waits.append(gate.write_tail)
            gate.readers.append(done)
        self.active += 1
        self._idle.clear()
        if self.active > self.max_depth:
            self.max_depth = self.active
            if self.perf is not None:
                # set_max, not set: the group is OSD-wide and shared by
                # every PG — a shallower PG's new personal best must
                # not clobber a deeper PG's high-water mark
                self.perf.set_max("max_inflight_depth", self.max_depth)
        if self.perf is not None:
            self.perf.inc("ops_admitted")
            # depth sampled at BOTH edges (admission here, release
            # below): a single-edge sample systematically undercounts
            # the time-averaged depth during ramp-up bursts; the
            # two-edge mean is the pipelining evidence bench ec_e2e
            # and test_perf_smoke assert on (> 1, serial pins it at 1)
            self.perf.tinc("inflight_depth", self.active)
        return OpSlot(oid, write, done, waits)

    # ------------------------------------------------------------ release
    def release(self, slot: OpSlot) -> None:
        """Op finished (any outcome): resolve its future so successors
        run, unlink it, free the slot."""
        if not slot.done.done():
            slot.done.set_result(None)
        gate = self._gates.get(slot.oid)
        if gate is not None:
            if gate.write_tail is slot.done:
                gate.write_tail = None
            else:
                try:
                    gate.readers.remove(slot.done)
                except ValueError:
                    pass
            if gate.write_tail is None and not gate.readers:
                del self._gates[slot.oid]
        if self.perf is not None:
            # release-edge depth sample (see admit)
            self.perf.tinc("inflight_depth", self.active)
        self.active -= 1
        self._slot_free.set()
        if self.active == 0:
            self._idle.set()
    # awaitfree:end sequencer-admit-release

    def balanced(self) -> bool:
        """True when every admitted slot has been released and no
        object gate is left dangling — the quiesced-window invariant
        the schedule explorer asserts after every explored schedule
        (a leaked slot wedges the PG's dependency chains forever)."""
        return self.active == 0 and not self._gates

    # -------------------------------------------------------------- drain
    async def drain(self) -> None:
        """Wait for the window to empty — the whole-PG barrier.  Used
        before scrub scans, tier-agent passes, pool-scope ops and on
        peering/epoch changes (window-drain-on-epoch-change is a
        ROADMAP invariant: a new interval must never interleave with
        ops admitted under the old one)."""
        if self.perf is not None and self.active:
            self.perf.inc("window_drains")
        while self.active:
            self._idle.clear()
            await self._idle.wait()
