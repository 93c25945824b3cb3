"""PGMonitor (PGMap aggregation + health) and LogMonitor (cluster log).

Reference parity: mon/PGMap.cc + mon/PGMonitor.cc (cluster-wide pg/usage
stats, the data behind `ceph -s` / `ceph health`), mon/LogMonitor.cc
(cluster log sink for LogClient entries, `ceph log last`).

Redesign: aggregation state is leader-memory + a rolling kv checkpoint
rather than a full PaxosService — stats are ephemeral observations that
regenerate within one report interval after an election (the reference
itself moved this aggregation out of paxos and into the mgr in later
releases for the same reason).

The port's copy of ``ceph_tpu.mon.pg_monitor``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class PGMonitor:
    """Aggregates MPGStats into a PGMap; computes health."""

    STALE_AFTER = 30.0          # stats older than this mark pgs stale

    def __init__(self, mon):
        self.mon = mon
        self.log = mon.ctx.logger("mon")
        # pgid(str) -> {state, num_objects, num_bytes, scrub_errors,
        #               reported_by, stamp}
        self.pg_stats: Dict[str, dict] = {}
        self.osd_stats: Dict[int, dict] = {}

    def handle_stats(self, m) -> None:
        now = time.time()
        self.osd_stats[m.from_osd] = dict(m.osd_stat, stamp=now)
        for row in m.pg_stats:
            pgid = row.get("pgid")
            if not pgid:
                continue
            cur = self.pg_stats.get(pgid)
            # an in-flight report from a JUST-deposed primary must not
            # overwrite the new primary's fresher row (epoch-guarded)
            if cur is not None and cur.get("epoch", 0) > m.epoch:
                continue
            self.pg_stats[pgid] = dict(row, reported_by=m.from_osd,
                                       stamp=now, epoch=m.epoch)
        self._prune()
        self._check_pool_quotas()

    def _pool_usage(self) -> Dict[int, list]:
        """pool_id -> [objects, bytes] aggregated from pg stats (one
        copy, shared by df() and the quota check)."""
        usage: Dict[int, list] = {}
        for pgid, st in self.pg_stats.items():
            try:
                pool_id = int(pgid.partition(".")[0])
            except ValueError:
                continue
            agg = usage.setdefault(pool_id, [0, 0])
            agg[0] += st.get("num_objects", 0)
            agg[1] += st.get("num_bytes", 0)
        return usage

    def _check_pool_quotas(self) -> None:
        """Flip FLAG_FULL_QUOTA when PGMap usage crosses a pool's
        quota (OSDMonitor/PGMap check_full role): writes to a full
        pool fail EDQUOT on the OSDs until usage drops or the quota
        is raised."""
        if not self.mon.is_leader():
            return
        usage = self._pool_usage()
        from ceph_tpu_torch.osd.types import FLAG_FULL_QUOTA
        for pid, pool in self.mon.osdmon.osdmap.pools.items():
            if not (pool.quota_max_bytes or pool.quota_max_objects):
                if pool.flags & FLAG_FULL_QUOTA:
                    self.mon.osdmon.set_pool_full_quota(pid, False)
                continue
            objs, nbytes = usage.get(pid, [0, 0])
            full = (pool.quota_max_objects
                    and objs >= pool.quota_max_objects) or \
                   (pool.quota_max_bytes
                    and nbytes >= pool.quota_max_bytes)
            self.mon.osdmon.set_pool_full_quota(pid, bool(full))

    def _prune(self) -> None:
        """Drop rows for pgs that no longer exist (pool deleted/shrunk),
        so health doesn't flag dead pgs as stale forever."""
        pools = self.mon.osdmon.osdmap.pools
        dead = []
        for pgid in self.pg_stats:
            try:
                pool_s, _, seed_s = pgid.partition(".")
                pool = pools.get(int(pool_s))
                if pool is None or int(seed_s, 16) >= pool.pg_num:
                    dead.append(pgid)
            except ValueError:
                dead.append(pgid)
        for pgid in dead:
            del self.pg_stats[pgid]

    # ------------------------------------------------------------- views
    def pg_summary(self) -> Dict:
        self._prune()
        states: Dict[str, int] = {}
        objects = 0
        nbytes = 0
        scrub_errors = 0
        now = time.time()
        for st in self.pg_stats.values():
            state = st.get("state", "unknown")
            if now - st.get("stamp", 0) > self.STALE_AFTER:
                state = "stale+" + state
            states[state] = states.get(state, 0) + 1
            objects += st.get("num_objects", 0)
            nbytes += st.get("num_bytes", 0)
            scrub_errors += st.get("scrub_errors", 0)
        return {"num_pgs": len(self.pg_stats), "by_state": states,
                "num_objects": objects, "num_bytes": nbytes,
                "scrub_errors": scrub_errors}

    def expected_pg_count(self) -> int:
        return sum(p.pg_num for p in self.mon.osdmon.osdmap.pools.values())

    def osd_df(self) -> Dict:
        """`ceph osd df` role (OSDMonitor/PGMap osd_df): per-osd
        capacity + pg count from the reported osd_stat statfs."""
        osdmap = self.mon.osdmon.osdmap
        rows = []
        for osd in range(osdmap.max_osd):
            if not osdmap.exists(osd):
                continue
            st = self.osd_stats.get(osd, {})
            fs = st.get("statfs", {})
            total, used = fs.get("total", 0), fs.get("used", 0)
            rows.append({
                "id": osd,
                "up": osdmap.is_up(osd),
                "in": osdmap.is_in(osd),
                "weight": osdmap.osd_weight[osd] / 0x10000
                if osd < len(osdmap.osd_weight) else 0.0,
                "num_pgs": st.get("num_pgs", 0),
                "total": total, "used": used,
                "free": fs.get("free", 0),
                "utilization": round(used / total, 4) if total else None,
            })
        return {"nodes": rows,
                "summary": {"total": sum(r["total"] for r in rows),
                            "used": sum(r["used"] for r in rows)}}

    def df(self) -> Dict:
        """`ceph df` role (PGMonitor::dump_pool_stats /
        dump_fs_stats): per-pool logical usage aggregated from pg
        stats, plus the raw multiplier implied by the pool's
        redundancy (size for replicated, (k+m)/k for EC)."""
        self._prune()
        osdmap = self.mon.osdmon.osdmap
        per_pool = {pid: {"objects": u[0], "bytes": u[1]}
                    for pid, u in self._pool_usage().items()}
        pools = []
        total = 0
        total_raw = 0.0
        for pool_id, pool in sorted(osdmap.pools.items()):
            agg = per_pool.get(pool_id, {"objects": 0, "bytes": 0})
            if pool.is_erasure():
                prof = osdmap.ec_profiles.get(pool.ec_profile, {})
                k = max(1, int(prof.get("k", pool.min_size)))
                raw_mult = pool.size / k
            else:
                raw_mult = float(pool.size)
            raw = agg["bytes"] * raw_mult
            pools.append({"name": osdmap.pool_names.get(pool_id,
                                                        str(pool_id)),
                          "id": pool_id,
                          "objects": agg["objects"],
                          "bytes_used": agg["bytes"],
                          "raw_bytes_used": int(raw)})
            total += agg["bytes"]
            total_raw += raw
        return {"pools": pools,
                "stats": {"total_objects":
                          sum(p["objects"] for p in pools),
                          "total_bytes_used": total,
                          "total_raw_used": int(total_raw),
                          "num_osds": osdmap.count_up()}}

    def health(self) -> Dict:
        """HEALTH_OK/WARN/ERR roll-up (PGMap::get_health role)."""
        checks: List[str] = []
        osdmap = self.mon.osdmon.osdmap
        down = [o for o in range(osdmap.max_osd)
                if osdmap.exists(o) and osdmap.is_in(o)
                and not osdmap.is_up(o)]
        if down:
            checks.append(f"{len(down)} osds down: {down}")
        summ = self.pg_summary()
        expected = self.expected_pg_count()
        not_active = {s: n for s, n in summ["by_state"].items()
                      if "active" not in s or s.startswith("stale+")}
        if not_active:
            checks.append(f"pgs not active/fresh: {not_active}")
        if summ["num_pgs"] < expected:
            checks.append(f"{expected - summ['num_pgs']} pgs not yet "
                          f"reported")
        status = "HEALTH_OK" if not checks else "HEALTH_WARN"
        if summ["scrub_errors"]:
            checks.append(f"{summ['scrub_errors']} scrub errors")
            status = "HEALTH_ERR"
        return {"status": status, "checks": checks}

    def dump(self) -> Dict:
        return {"pg_stats": self.pg_stats,
                "osd_stats": self.osd_stats,
                "summary": self.pg_summary()}


class LogMonitor:
    """Cluster log aggregation (mon/LogMonitor.cc): daemons' LogClient
    entries land here; kept in a bounded ring + appended to
    <mon_data>/cluster.log when file logging is on."""

    MAX_RECENT = 1000

    def __init__(self, mon, log_path: Optional[str] = None):
        self.mon = mon
        self.recent: List[dict] = []
        self.log_path = log_path

    def handle_log(self, m) -> None:
        for e in m.entries:
            self.recent.append(e)
        del self.recent[:-self.MAX_RECENT]
        if self.log_path:
            try:
                with open(self.log_path, "a") as f:
                    for e in m.entries:
                        f.write(f"{e.get('stamp', 0):.6f} "
                                f"{e.get('who', '?')} "
                                f"{e.get('level', 'INF')} "
                                f"{e.get('message', '')}\n")
            except OSError:
                pass

    def last(self, n: int = 20) -> List[dict]:
        return self.recent[-n:]
