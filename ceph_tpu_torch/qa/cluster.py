"""In-process test cluster: mon + OSDs + rados clients in one loop.

Reference parity: qa/workunits/ceph-helpers.sh (setup/run_mon/run_osd/
kill_daemon/wait_for_clean) — the multi-daemon-without-real-nodes
harness, here as asyncio objects so tests and the model checker can
reach into daemon state (PGs, stores) directly.

The port's copy of ``ceph_tpu.qa.cluster``.  A ``Cluster`` takes a
``device`` (default ``cuda``; raises without a card) and hands it to
every OSD and client it starts; ``Cluster(device="cpu")`` runs on the
host.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          resolve_device)
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.mon.monmap import MonMap
from ceph_tpu_torch.msg.messenger import Messenger
from ceph_tpu_torch.msg.types import EntityName
from ceph_tpu_torch.osd import OSD
from ceph_tpu_torch.store.kv import MemDB
from ceph_tpu_torch.store.memstore import MemStore

FAST_CFG = {
    "mon_election_timeout": 0.3,
    "mon_lease": 1.0,
    "mon_tick_interval": 0.5,
    "ms_initial_backoff": 0.02,
    "osd_heartbeat_interval": 0.3,
    "osd_heartbeat_grace": 1.5,
    "mon_osd_down_out_interval": 3.0,
    # quiet stderr (warnings only): daemon INFO chatter from dozens of
    # in-process clusters corrupts pytest's progress lines when a
    # background thread logs between tests; the in-memory ring still
    # records every level for `log dump` assertions/introspection
    "log_level": 0,
    # invariant sanitizer (common/lockdep.py): every e2e test doubles
    # as a race/ordering regression test — lock acquisitions through
    # the lockdep factories build the order graph and Cluster.stop()
    # FAILS on any recorded inversion / cross-loop misuse.  The
    # loop-stall budget stays 0 here: on this shared container,
    # CPU-contention stalls are indistinguishable from code stalls
    # (3x run-to-run throughput variance); stall-focused tests opt in
    # via lockdep_stall_budget.
    "lockdep": True,
    # backward-compat pin: the bulk of the tests runs the single-loop
    # data plane (osd/shards.py disabled — today's dispatch path,
    # bit-for-bit).  Sharded coverage is explicit: test_shards.py,
    # the perf-smoke shard guards, and the 2-shard schedule-explorer
    # run override this per test.
    "osd_op_num_shards": 1,
}


#: deterministic-simulation overrides (devtools/schedule.py): clusters
#: under the DeterministicLoop run fully in-process — every daemon pair
#: on the zero-encode local path (TCP would reintroduce kernel-timing
#: nondeterminism) — and with wall-clock failure detectors disarmed:
#: the sim's virtual clock freezes while callbacks run, but heartbeat
#: staleness is judged against time.monotonic, so a CPU-slow schedule
#: would otherwise fabricate failure reports and osdmap churn that
#: differ run to run.
SIM_CFG = {
    **FAST_CFG,
    "ms_local_delivery": True,
    "osd_heartbeat_grace": 3600.0,
    "mon_osd_down_out_interval": 3600.0,
}


def make_ctx(name):
    ctx = Context(name)
    for k, v in FAST_CFG.items():
        ctx.config.set(k, v)
    return ctx


def make_sim_ctx(name):
    ctx = Context(name)
    for k, v in SIM_CFG.items():
        ctx.config.set(k, v)
    return ctx


class Cluster:
    def __init__(self, ctx_factory=None, store_factory=None,
                 device: DeviceLike = DEFAULT_DEVICE):
        #: the device of every OSD and client this cluster starts
        self.device = resolve_device(device)
        self.monmap = MonMap()
        self.mons = []
        self.osds = {}
        self.clients = []
        self.make_ctx = ctx_factory or make_ctx
        # store_factory(osd_id) -> ObjectStore lets tests run OSDs on a
        # durable backend (e.g. BlockStore on a tmp dir) instead of the
        # MemStore default
        self.store_factory = store_factory
        self._stall_monitor = None

    async def start(self, n_osds: int, osds_per_host: int = 1):
        self.monmap.fsid = "e2e-fsid"
        ctx = self.make_ctx("mon.a")
        # runtime invariant sanitizer: the module-level gate covers the
        # lock holders that have no Context in reach (FileDB, commit
        # thread); findings are surfaced — loudly — by stop()
        from ceph_tpu_torch.common import lockdep
        if ctx.config["lockdep"]:
            lockdep.enable()
        budget = ctx.config["lockdep_stall_budget"]
        if budget > 0:
            loop = asyncio.get_running_loop()
            mon = lockdep.LoopStallMonitor(loop, budget)
            if getattr(loop, "deterministic", False):
                # sim mode: the deterministic loop times every callback
                # itself — exhaustive, replayable stall attribution
                # instead of a probe thread racing container CPU noise
                self._stall_monitor = mon.attach_virtual(loop)
            else:
                self._stall_monitor = mon.start()
        msgr = Messenger(ctx, EntityName("mon", "a"))
        self.monmap.add("a", await msgr.bind())
        mon = Monitor(ctx, "a", self.monmap, MemDB(), msgr)
        await mon.start()
        self.mons.append(mon)
        admin = await self.client()
        await admin.mon_command({"prefix": "osd crush build-simple",
                                 "num_osds": n_osds,
                                 "osds_per_host": osds_per_host})
        for i in range(n_osds):
            await self.start_osd(i)
        for osd in self.osds.values():
            await osd.wait_for_boot()
        return admin

    async def start_osd(self, i: int, store=None):
        ctx = self.make_ctx(f"osd.{i}")
        msgr = Messenger(ctx, EntityName("osd", str(i)))
        # a handed-in store is a RESTART with surviving data: never mkfs
        # it (mkfs wipes), or restart-with-data scenarios silently test
        # recovery-from-peers instead
        fresh = store is None
        if store is None:
            store = (self.store_factory(i) if self.store_factory
                     else MemStore())
        if fresh:
            store.mkfs()
        osd = OSD(ctx, i, store, msgr, self.monmap, device=self.device)
        await osd.start()
        self.osds[i] = osd
        return osd

    async def kill_osd(self, i: int):
        osd = self.osds.pop(i)
        await osd.shutdown()
        return osd.store

    async def client(self, name="client.admin") -> Rados:
        r = Rados(self.make_ctx(name), self.monmap, device=self.device)
        await r.connect()
        self.clients.append(r)
        return r

    async def mark_down_and_wait(self, admin: Rados, osd_id: int):
        await admin.mon_command({"prefix": "osd down", "id": osd_id})
        while admin.monc.osdmap.is_up(osd_id):
            await asyncio.sleep(0.05)

    async def wait_epoch(self, admin: Rados, epoch: int, timeout=15.0):
        deadline = asyncio.get_event_loop().time() + timeout
        while admin.monc.osdmap.epoch < epoch:
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.05)

    async def write_burst(self, io, blobs: dict, iodepth: int = 16):
        """Issue the writes with a bounded client iodepth (obj_bencher
        concurrentios role).  iodepth > 1 is what lets the OSD-side
        per-PG op window (osd_pg_max_inflight_ops) actually fill —
        serial awaits can never have more than one op in flight."""
        sem = asyncio.Semaphore(max(1, iodepth))

        async def one(name, data):
            async with sem:
                await io.write_full(name, data)

        await asyncio.gather(*[one(n, d) for n, d in blobs.items()])

    def window_counters(self) -> dict:
        """Aggregated per-PG op-window evidence across all OSDs:
        mean/max in-flight depth + admissions (osd_op_window group)."""
        s = n = admitted = drains = 0
        mx = 0
        for osd in self.osds.values():
            d = osd.perf_window.dump()
            depth = d.get("inflight_depth", {})
            s += depth.get("sum", 0.0)
            n += depth.get("avgcount", 0)
            admitted += int(d.get("ops_admitted", 0))
            drains += int(d.get("window_drains", 0))
            mx = max(mx, int(d.get("max_inflight_depth", 0)))
        return {"mean_inflight_depth": (s / n) if n else 0.0,
                "max_inflight_depth": mx,
                "ops_admitted": admitted,
                "window_drains": drains}

    async def refresh_lane_metrics(self) -> list:
        """On-demand metrics scrape of every OSD's process-lane
        workers (FRAME_RPC); the fetched snapshots feed
        stage_histograms()/cluster_perf_dump().  No-op (empty list) at
        inline/thread lanes.  Returns loud per-OSD dead-lane names."""
        dead = []
        for i, osd in self.osds.items():
            for idx in await osd.shards.fetch_lane_metrics():
                dead.append(f"osd.{i}/lane{idx}")
        return dead

    def _lane_stage_dumps(self) -> list:
        """Per-lane {stage: dump_full} mappings from the latest lane
        metrics snapshots (periodic FRAME_STATS push or an explicit
        refresh_lane_metrics())."""
        from ceph_tpu_torch.common import tracer as tracer_mod
        dumps = []
        for osd in self.osds.values():
            for snap in osd.shards.lane_metric_snapshots().values():
                if snap:
                    dumps.append((snap.get("groups") or {}).get(
                        tracer_mod.STAGE_GROUP) or {})
        return dumps

    def stage_histograms(self) -> dict:
        """Merged op-tracer stage histograms across every daemon and
        client of this in-process cluster — and every process-lane
        worker that has shipped a metrics snapshot (call
        refresh_lane_metrics() first for fresh lane data):
        {stage: PerfHistogram}.  Empty unless the contexts ran with
        op_tracing=true."""
        from ceph_tpu_torch.common import tracer as tracer_mod
        ctxs = [o.ctx for o in self.osds.values()]
        ctxs += [m.ctx for m in self.mons]
        ctxs += [c.ctx for c in self.clients]
        return tracer_mod.merge_stage_histograms(
            ctxs, extra_dumps=self._lane_stage_dumps())

    def cluster_perf_dump(self) -> dict:
        """One merged metrics-plane view of the whole in-process
        cluster (the `ceph perf dump --cluster` shape without admin
        sockets): every daemon + client context snapshot plus every
        lane worker's latest shipped snapshot."""
        from ceph_tpu_torch.common import metrics
        snaps = []
        dead = []
        for i, osd in self.osds.items():
            snaps.append(metrics.snapshot(osd.ctx, source=f"osd.{i}"))
            for idx, snap in sorted(
                    osd.shards.lane_metric_snapshots().items()):
                lanes = osd.shards.process_lanes or []
                if snap:
                    snaps.append(snap)
                if any(ln.idx == idx and ln.dead for ln in lanes):
                    dead.append(f"osd.{i}/lane{idx}")
        for m in self.mons:
            snaps.append(metrics.snapshot(m.ctx))
        for c in self.clients:
            snaps.append(metrics.snapshot(c.ctx))
        return metrics.merge(snaps, lane_dead=dead)

    def stage_breakdown(self, measured_e2e_s=None) -> dict:
        """Per-stage quantiles + attributed/unattributed split (see
        tracer.breakdown): the profile bench ec_e2e reports and
        test_perf_smoke guards."""
        from ceph_tpu_torch.common import tracer as tracer_mod
        return tracer_mod.breakdown(self.stage_histograms(),
                                    measured_e2e_s)

    async def stop(self):
        try:
            for c in self.clients:
                await c.shutdown()
            for o in list(self.osds.values()):
                await o.shutdown()
            for m in self.mons:
                await m.shutdown()
        except BaseException as e:
            # shutdown wedged — which is exactly when the sanitizer
            # report (a recorded deadlock cycle, say) EXPLAINS the
            # failure: attach it to the propagating error instead of
            # resetting it into the void
            findings = self._drain_sanitizer()
            if findings:
                from ceph_tpu_torch.common.lockdep import render_report
                raise AssertionError(
                    f"cluster shutdown failed WITH {len(findings)} "
                    f"sanitizer finding(s):\n"
                    f"{render_report(findings)}") from e
            raise
        findings = self._drain_sanitizer()
        if findings:
            from ceph_tpu_torch.common.lockdep import render_report
            raise AssertionError(
                f"invariant sanitizer: {len(findings)} finding(s) at "
                f"cluster teardown:\n{render_report(findings)}")

    def _drain_sanitizer(self) -> list:
        """Collect sanitizer findings and reset the process-wide state
        (enable flag, order graph) so one test's edges can never bleed
        a false cycle into the next.  Always runs, even when daemon
        shutdown itself failed — a leaked enable would silently tax
        every later test."""
        from ceph_tpu_torch.common import lockdep
        had_monitor = self._stall_monitor is not None
        if had_monitor:
            self._stall_monitor.stop()
            self._stall_monitor = None
        if not lockdep.is_enabled() and not had_monitor:
            return []
        findings = lockdep.report()
        lockdep.disable()
        lockdep.reset()
        return findings
