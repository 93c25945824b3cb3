"""Group-commit thread: many in-flight transactions share one fsync (the
port's copy of ``ceph_tpu.store.commit``).

Reference parity: os/bluestore/BlueStore.cc ``_kv_sync_thread`` — the
event loop (or op threads) stage transactions cheaply in memory and a
dedicated thread drains the backlog, issuing ONE data-device barrier and
ONE atomic kv submit for the whole group, then completes the commit
callbacks in submission order.  The store's ``queue_transactions``
becomes "apply + enqueue"; durability (and therefore repop acks, client
acks, pglog last_complete) rides the callback.

Invariants the thread preserves:
  * data before metadata — the group's data fsync happens strictly
    before its kv records are made durable (COW crash rule);
  * submission order — kv records are logged in seq order and commit
    callbacks fire in the exact order transactions were submitted;
  * bounded backlog — the queue is bounded; a producer outrunning the
    disk blocks on enqueue (Throttle role) instead of ballooning RAM.

Fault injection for crash-ordering tests: ``crash_at`` kills the thread
at a named point ("before_data_sync" | "before_kv") leaving the store
exactly as a power cut at that instant would; ``trace`` observes the
stage sequence without perturbing it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional

from ceph_tpu_torch.common.lockdep import make_thread_lock
from ceph_tpu_torch.common.perf_counters import PerfCounters

_log = logging.getLogger("ceph-tpu-torch.store.commit")

_STOP = object()

#: Deterministic-simulation switch, one per package (the reference's
#: schedule explorer, devtools/schedule.py, sets the JAX package's): when True,
#: threads STARTED from then on run INLINE — no kv-sync thread is
#: spawned; corked groups commit synchronously at the loop-side flush
#: point.  The commit code path (_commit, fault injection, counters,
#: callback posting) is byte-identical; only the thread handoff — the
#: one nondeterministic interleaving the schedule explorer cannot
#: control — is removed.  Never set outside a sim run.
SIM_INLINE = False

#: Observer hook for the schedule explorer's commit-order invariant
#: ("no ack before durability"): called as OBSERVER(store_name, event,
#: item_indices) with event in {"committed", "callbacks", "crashed"}.
#: None (the default) costs one attribute load per group.  The hook is
#: this package's own: the reference's OBSERVER sees none of these stores.
OBSERVER: Optional[Callable[[str, str, List[int]], None]] = None


class _Item:
    """One staged transaction's PORTABLE commit record: plain scalars
    only.  The loop-bound on_commit/post closures never ride the
    kv-sync queue — they stay in the submitter-side ``_cbs`` table
    keyed by ``idx``, and completion crosses back as an idx-keyed
    record the owning lane resolves (the process-lane form the seam
    inventory prescribed)."""

    __slots__ = ("seq", "wrote_data", "t0", "idx")

    def __init__(self, seq, wrote_data, idx=0):
        self.seq = seq
        self.wrote_data = wrote_data
        self.t0 = time.perf_counter()
        #: process-unique submission index (the seq field is
        #: store-assigned and 0 for RAM stores): the explorer's
        #: phantom-ack check keys on this, and the callback table
        #: (_cbs) is keyed by it
        self.idx = idx


class InjectedCrash(Exception):
    """Raised on the commit thread by the crash_at fault hook."""


class KVSyncThread:
    """One per mounted store.

    data_sync() -- durability barrier for the data device (optional).
    kv_sync(upto_seq) -- make every staged kv record with seq <=
    upto_seq durable in ONE atomic submit (optional).
    """

    QUEUE_MAX = 1024        # backlog bound (bluestore throttle role)
    _instances = 0          # name-uniquifier (see __init__)

    def __init__(self, name: str,
                 data_sync: Optional[Callable[[], None]] = None,
                 kv_sync: Optional[Callable[[int], None]] = None,
                 queue_max: int = QUEUE_MAX,
                 gather_window: float = 0.0,
                 auto_tune: bool = True,
                 ack_on_apply: bool = False):
        # unique per instance: co-located stores of the same backend
        # (a 4-OSD in-process cluster = four "memstore_commit"s) must
        # be distinguishable in the schedule explorer's commit-order
        # observations; mount order is deterministic under sim
        KVSyncThread._instances += 1
        self.name = f"{name}#{KVSyncThread._instances}"
        self.data_sync = data_sync
        self.kv_sync = kv_sync
        #: seconds to linger after the first item of a group so bursts
        #: coalesce.  Stores whose commit has real cost (fsync) batch
        #: naturally and leave this 0; RAM-backed stores set a tiny
        #: window so group commit still engages under concurrency.
        #: This is the STATIC base; with auto_tune the effective window
        #: tracks the observed barrier cost instead (see
        #: _effective_window) — lingering longer than a barrier costs
        #: buys nothing, and a static guess on a device whose fsync is
        #: 4x slower under-batches by the same factor.
        self.gather_window = gather_window
        #: sharded-data-plane opt-in (the OSD sets it for stores it
        #: mounts while the plane is enabled): a store with NO
        #: durability hooks may then commit groups inline at the
        #: cork-flush point instead of paying the thread handoff —
        #: see start().  Off = today's threaded behavior, bit-for-bit
        #: (osd_op_num_shards=1 and standalone stores keep it off).
        self.ack_on_apply = ack_on_apply
        #: adapt the window to the measured barrier latency (EWMA),
        #: clamped to [0, 4x the static value].  Only engages on stores
        #: with a REAL barrier hook — a RAM store has no fsync signal
        #: to tune from and keeps its static window.
        self.auto_tune = auto_tune
        self._barrier_ewma: Optional[float] = None
        self.perf = PerfCounters(name)
        for key in ("commit_batches", "txns", "data_fsyncs", "kv_syncs",
                    "fsyncs_saved"):
            self.perf.add_u64(key)
        self.perf.add_avg("txns_per_batch")
        self.perf.add_avg("commit_inflight")
        self.perf.add_time("commit_lat")
        # full latency distribution (perf_histogram role): the mean
        # above hides the p99 the op tracer's commit-group-wait stage
        # needs to be checked against
        self.perf.add_hist("commit_lat_hist")
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_max)
        #: idx -> (on_commit, post, loop): the submitter-side half of
        #: the idx-keyed completion records.  Closures never cross the
        #: kv-sync seam — _complete ships idx lists back to each loop
        #: and _run_completion_records resolves them HERE, under the
        #: same lock every side already takes for _submitted
        self._cbs: dict = {}
        self._thread: Optional[threading.Thread] = None
        # lockdep-wrapped when the sanitizer is on: the commit thread
        # holds this while the event loop submits, so an ordering slip
        # against the store's own locks is a real deadlock class
        self._lock = make_thread_lock(f"kvsync:{name}:_lock")
        self._cv = threading.Condition(self._lock)
        self._submitted = 0
        self._completed = 0
        # event-loop-side cork: submissions staged within one loop pass
        # ship to the thread as ONE queue put (one lock round + one GIL
        # handoff per pass instead of per transaction — the handoffs,
        # not the queue, are what tax a busy event loop).  Staging is
        # keyed PER LOOP: under the sharded data plane (osd/shards.py)
        # several shard loops submit to one store concurrently, and a
        # shared list would lose wakeups across threads.  Per-loop FIFO
        # is the order that matters (a PG lives on exactly one shard).
        self._staged: dict = {}          # id(loop) -> List[_Item]
        self._flush_scheduled: dict = {}  # id(loop) -> bool
        self.dead = False           # crashed (fault injection) or error
        # --- test hooks ---
        self.trace: Optional[Callable[[str, int], None]] = None
        self.crash_at: Optional[str] = None
        #: occurrence-indexed crash injection: skip this many hits of
        #: crash_at's point before raising — the schedule explorer
        #: enumerates (point, occurrence) pairs, not just first-hit
        self.crash_skip = 0
        self.gate: Optional[threading.Event] = None   # holds the thread
        #     before it takes its next group (deterministic batching)
        #: captured at start(): inline (sim) vs threaded commit
        self._inline = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if SIM_INLINE:
            self._inline = True
            return
        if self.ack_on_apply and self.data_sync is None \
                and self.kv_sync is None:
            # ack-on-apply (ROADMAP: "tighter gather window or
            # ack-on-apply semantics where safe"): a RAM-backed store
            # has NO durability point beyond the apply — no data
            # barrier, no kv submit — so the commit thread would add
            # only a GIL handoff (5-15ms p50 on a busy event loop,
            # the tracer's repl_commit cost) between apply and ack.
            # Commit groups run inline at the cork-flush point
            # instead: the exact SIM_INLINE code path, so ordering,
            # observer hooks and crash injection are unchanged.
            self._inline = True
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="kv_sync_thread")
        self._thread.start()

    def submit(self, seq: int = 0, wrote_data: bool = False,
               on_commit: Optional[Callable[[], None]] = None,
               post: Optional[Callable[[], None]] = None) -> None:
        """Enqueue one staged transaction batch.  Blocks (backpressure)
        when the commit backlog is full.  Captures the running event
        loop, if any, so callbacks are posted back to it; without a
        loop they run on the commit thread itself, still in order.

        With a loop, items cork on the loop side and ship to the thread
        once per loop pass (call_soon flush) — submission order within
        and across passes is preserved."""
        loop = None
        try:
            import asyncio
            loop = asyncio.get_running_loop()
        except RuntimeError:
            pass
        with self._lock:
            self._submitted += 1
            idx = self._submitted
            if on_commit is not None or post is not None:
                self._cbs[idx] = (on_commit, post, loop)
        rec = _Item(seq, wrote_data, idx=idx)
        if loop is None:
            if self._inline:
                self._run_group([rec])
            else:
                # the record is plain scalars (seq/wrote_data/idx/t0):
                # the loop-bound callbacks stayed in _cbs on this side
                self._q.put([rec])
            return
        key = id(loop)
        # gil-atomic:begin _staged,_flush_scheduled per-loop staging
        # keyed by id(loop): each loop only ever touches ITS OWN key
        # from its own thread; the dict inserts themselves are single
        # GIL steps, so foreign-key traffic (teardown's _flush_staged
        # sweep) can race only per-key pops, never corrupt the dict
        self._staged.setdefault(key, []).append(rec)
        if not self._flush_scheduled.get(key):
            self._flush_scheduled[key] = True
            loop.call_soon(self._flush_one, key)
        # gil-atomic:end

    def _flush_one(self, key: int) -> None:
        """Ship one loop's corked items (runs ON that loop)."""
        # gil-atomic:begin _staged,_flush_scheduled the per-key pop is
        # one GIL step: racing the owning loop's own flush is safe —
        # exactly one side ships each staged list
        self._flush_scheduled[key] = False
        recs = self._staged.pop(key, None)
        # gil-atomic:end
        if not recs:
            return
        if self._inline:
            # sim mode: the loop-pass cork IS the commit group; no
            # thread handoff, no gather linger — deterministic
            self._run_group(recs)
        else:
            self._q.put(recs)

    def _flush_staged(self) -> None:
        """Ship the CALLING loop's corked items now (flush()/stop()
        path).  With no running loop — tools, teardown — OR in inline
        (ack-on-apply / sim) mode, ship EVERY loop's residue: inline
        groups commit synchronously wherever they run, and a
        teardown-time flush from the intake thread must not leave a
        shard loop's staged group behind (its scheduled cork flush
        may never run once the daemon stops).  The per-key pop is
        GIL-atomic, so racing the owning loop's own flush is safe —
        exactly one side ships each list."""
        try:
            import asyncio
            key = id(asyncio.get_running_loop())
        except RuntimeError:
            key = None
        if key is not None and not self._inline:
            self._flush_one(key)
            return
        for k in list(self._staged):
            self._flush_one(k)

    def _run_group(self, group: List[_Item]) -> None:
        """One group through the commit path, on the calling thread
        (inline sim mode).  Identical failure semantics to _run: an
        injected crash or commit error kills the store 'thread'."""
        if self.dead:
            self._finish(group)
            return
        try:
            self._commit(group)
        except InjectedCrash:
            self.dead = True
            self._finish(group)
        except Exception:
            _log.exception("inline commit failed; store is dead")
            self.dead = True
            self._finish(group)

    def flush(self, timeout: float = 60.0) -> None:
        """Wait until every submitted batch is durable (callbacks may
        still be pending on their event loop).  Ships any corked items
        first.  Call from the submitting (event-loop) thread or from
        loop-less code — a foreign thread racing the loop's scheduled
        cork flush could put groups out of submission order.  Raises
        when the thread is dead: returning quietly would let
        sync()/apply_transaction report durability that never
        happened."""
        self._flush_staged()
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._completed < self._submitted and not self.dead \
                    and not self._inline:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("commit flush timed out")
                self._cv.wait(left)
        if self.dead:
            from ceph_tpu_torch.store.objectstore import StoreError
            raise StoreError("commit thread is dead; queued "
                             "transactions were never made durable")

    def stop(self) -> None:
        if self._inline:
            if not self.dead:
                try:
                    self.flush()
                except Exception:
                    pass
            return
        if self._thread is None:
            return
        if not self.dead:
            try:
                self.flush()
            except Exception:
                pass   # teardown is best-effort; dead is handled below
        self._q.put(_STOP)
        self._thread.join(timeout=30.0)
        self._thread = None

    # ------------------------------------------------------------- internal
    def _run(self) -> None:
        while True:
            got = self._q.get()
            if got is _STOP:
                return
            if self.gate is not None:
                self.gate.wait()
            win = self._effective_window()
            if win > 0.0:
                # linger ONLY when more submissions are actually in
                # flight beyond what this group already holds: a lone
                # closed-loop writer (iodepth 1) is blocked on THIS
                # commit, so sleeping would add pure latency with zero
                # batching gain — the exact p50 floor the bench
                # measures.  Concurrent writers have submitted (or
                # corked) before blocking, so the backlog check sees
                # them.
                with self._lock:
                    backlog = self._submitted - self._completed
                if backlog > len(got):
                    time.sleep(win)
            group: List[_Item] = list(got)
            stop_after = False
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                group.extend(nxt)
            if self.dead:
                self._finish(group)     # crashed: account, do nothing
            else:
                try:
                    self._commit(group)
                except InjectedCrash:
                    self.dead = True
                    self._finish(group)
                except Exception:
                    _log.exception("commit thread failed; store is dead")
                    self.dead = True
                    self._finish(group)
            if stop_after:
                return

    def _inject(self, point: str, group: List[_Item]) -> None:
        if self.trace is not None:
            self.trace(point, len(group))
        if self.crash_at == point:
            if self.crash_skip > 0:
                # fault-injection hook: the schedule explorer arms it
                # on exactly one commit context at a time
                # lint: allow[ESC12] test hook, single armed commit context by construction
                self.crash_skip -= 1
            else:
                raise InjectedCrash(point)

    def _notify(self, event: str, group: List[_Item]) -> None:
        obs = OBSERVER
        if obs is not None:
            obs(self.name, event, [it.idx for it in group])

    def _effective_window(self) -> float:
        """The gather window actually slept: the EWMA of observed
        barrier cost, clamped to [0, 4x] of the static value — linger
        about as long as one barrier costs (that is exactly the span
        co-arriving transactions can share), never more than 4x the
        configured base.  Falls back to the static window while there
        is no auto-tune signal (disabled, no real barrier hooks, or no
        sample yet)."""
        base = self.gather_window
        if not self.auto_tune or self._barrier_ewma is None \
                or base <= 0.0:
            return base
        return min(max(self._barrier_ewma, 0.0), 4.0 * base)

    def _commit(self, group: List[_Item]) -> None:
        with self._lock:
            # backlog depth at group start (submitted-not-yet-durable):
            # the write-path pipelining evidence `perf dump` reports
            self.perf.tinc("commit_inflight",
                           self._submitted - self._completed)
        self._inject("before_data_sync", group)
        n_data = sum(1 for it in group if it.wrote_data)
        t_barrier0 = time.perf_counter()
        ran_barrier = False
        if n_data and self.data_sync is not None:
            self.data_sync()            # ONE barrier for the whole group
            self.perf.inc("data_fsyncs")
            ran_barrier = True
        self._inject("before_kv", group)
        if self.kv_sync is not None:
            # ONE atomic kv submit covering every record of the group,
            # strictly after the data barrier (data-before-metadata)
            self.kv_sync(max(it.seq for it in group))
            self.perf.inc("kv_syncs")
            ran_barrier = True
        if ran_barrier:
            dt = time.perf_counter() - t_barrier0
            self._barrier_ewma = dt if self._barrier_ewma is None \
                else 0.8 * self._barrier_ewma + 0.2 * dt
        self._inject("committed", group)
        self._notify("committed", group)
        now = time.perf_counter()
        self.perf.inc("commit_batches")
        self.perf.inc("txns", len(group))
        self.perf.tinc("txns_per_batch", len(group))
        # the synchronous path would have paid one data fsync per
        # data-writing txn plus one kv sync per txn; the group paid at
        # most one of each.  Only barriers this store ACTUALLY has
        # count — a RAM-backed store (no hooks) saves nothing.
        would_have = (n_data if self.data_sync is not None else 0) \
            + (len(group) if self.kv_sync is not None else 0)
        actual = (1 if n_data and self.data_sync is not None else 0) \
            + (1 if self.kv_sync is not None else 0)
        self.perf.inc("fsyncs_saved", max(0, would_have - actual))
        for it in group:
            self.perf.tinc("commit_lat", now - it.t0)
            self.perf.hinc("commit_lat_hist", now - it.t0)
        self._complete(group)
        with self._cv:
            self._completed += len(group)
            self._cv.notify_all()

    def _finish(self, group: List[_Item]) -> None:
        """Crashed path: account the items so flush() can't hang, but
        run NO callbacks — these transactions never committed.  Their
        completion records are PURGED (not delivered): a dead commit
        thread must never phantom-ack."""
        self._notify("crashed", group)
        with self._cv:
            for it in group:
                self._cbs.pop(it.idx, None)
            self._completed += len(group)
            self._cv.notify_all()

    def _complete(self, group: List[_Item]) -> None:
        self._notify("callbacks", group)
        # completions post PER SHARD LOOP, batched: one
        # call_soon_threadsafe wakeup per (loop, group) carrying the
        # idx-keyed completion RECORDS for that loop in submission
        # order — plain ints; the owning lane resolves them against
        # its _cbs half (the process-portable form of the old
        # closure-list handoff).  One wakeup per (loop, group), never
        # one per transaction.
        by_loop: dict = {}
        direct: List[int] = []
        with self._lock:
            metas = [(it.idx, self._cbs.get(it.idx)) for it in group]
        for idx, meta in metas:
            if meta is None:
                continue
            loop = meta[2]
            if loop is not None and not loop.is_closed():
                by_loop.setdefault(id(loop), (loop, []))[1].append(idx)
            else:
                direct.append(idx)
        if direct:
            # no submitting loop (tools, teardown): resolve on the
            # commit thread itself, still in order
            self._run_completion_records(direct)
        for loop, records in by_loop.values():
            try:
                loop.call_soon_threadsafe(
                    self._run_completion_records, records)
            except RuntimeError:
                self._run_completion_records(records)  # loop closed

    def _run_completion_records(self, records: List[int]) -> None:
        """Resolve idx-keyed completion records on the owning lane:
        pop each idx's callbacks from the submitter-side table and run
        them in record (== submission) order."""
        for idx in records:
            with self._lock:
                meta = self._cbs.pop(idx, None)
            if meta is None:
                continue
            for f in meta[:2]:
                if f is not None:
                    self._guard(f)

    @staticmethod
    def _guard(fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception:
            _log.exception("commit callback failed")

    # ---------------------------------------------------------- inspection
    def counters(self) -> dict:
        d = self.perf.dump()
        tpb = d.get("txns_per_batch", {})
        lat = d.get("commit_lat", {})
        inf = d.get("commit_inflight", {})
        hist = d.get("commit_lat_hist", {})
        n_b = tpb.get("avgcount", 0) or 0
        n_l = lat.get("avgcount", 0) or 0
        n_i = inf.get("avgcount", 0) or 0
        return {
            "commit_batches": d.get("commit_batches", 0),
            "txns": d.get("txns", 0),
            "data_fsyncs": d.get("data_fsyncs", 0),
            "kv_syncs": d.get("kv_syncs", 0),
            "fsyncs": d.get("data_fsyncs", 0) + d.get("kv_syncs", 0),
            "fsyncs_saved": d.get("fsyncs_saved", 0),
            "txns_per_batch": (tpb.get("sum", 0.0) / n_b) if n_b else 0.0,
            "commit_lat_ms": (lat.get("sum", 0.0) / n_l * 1e3)
            if n_l else 0.0,
            "commit_lat_p50_ms": hist.get("p50_ms", 0.0),
            "commit_lat_p99_ms": hist.get("p99_ms", 0.0),
            # auto-tune evidence: the window actually slept (EWMA of
            # barrier cost clamped to 4x static) + mean backlog depth
            "gather_window_ms": round(self._effective_window() * 1e3, 4),
            "gather_window_static_ms": round(self.gather_window * 1e3, 4),
            "commit_inflight": (inf.get("sum", 0.0) / n_i)
            if n_i else 0.0,
        }
