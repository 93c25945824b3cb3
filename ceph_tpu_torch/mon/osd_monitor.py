"""OSDMonitor: the OSDMap service on paxos.

Reference parity: mon/OSDMonitor.{h,cc} — osd boot/failure handling
(prepare_failure :1427, can_mark_down :1666 safeguards), pool and crush
commands, pg_temp requests, up_thru (alive) assertions, down→out aging.
Committed state: full + incremental OSDMap per epoch in the "osdmap"
store prefix; mutations accumulate in pending_inc and commit through
Paxos as one transaction per epoch.

The port's copy of ``ceph_tpu.mon.osd_monitor``.  Its two placement
sweeps (reweight-by-utilization and the pg_num growth check) map on the
CRUSH host engine: the mon answers on its event loop, where a kernel
launch and the fetch of its result would stall every other message.
An up_thru request (``MOSDAlive``) that a committed or pending grant
covers already is dropped, where the JAX package's mon proposes a new
epoch for each one.
"""

from __future__ import annotations

import errno
import json
import time
from typing import Dict, Optional

from ceph_tpu_torch.crush.builder import (build_hierarchy, make_erasure_rule,
                                    make_replicated_rule)
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.mon.messages import (
    MMonCommand, MMonCommandAck, MOSDAlive, MOSDBoot, MOSDFailure, MOSDMap,
    MPGTemp,
)
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.mon.monitor import PaxosService
from ceph_tpu_torch.osd.types import (
    OSD_IN_WEIGHT, OSD_UP, PGPool, POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED,
)
from ceph_tpu_torch.store.kv import KVTransaction


class OSDMonitor(PaxosService):
    def __init__(self, mon):
        super().__init__(mon, "osdmap")
        self.log = mon.log
        self.osdmap = OSDMap()
        self.pending_inc = Incremental(1)
        # failure tracking: target osd -> {reporter osd: monotonic stamp}
        self.failure_reports: Dict[int, Dict[int, float]] = {}
        self.down_stamp: Dict[int, float] = {}
        # up_thru grants held for a propose window after a down-mark
        # (prepare_alive); folded into the next proposal, dropped if
        # the requester dies while held
        self._held_alive: Dict[int, float] = {}
        self._alive_flush = None
        self._last_down_mark = 0.0
        # absolute flag word most recently PROPOSED but possibly not
        # yet committed — the read-modify-write base for a second `osd
        # set` arriving in that window (pending_inc resets on propose,
        # so neither it nor osdmap.flags carries the in-flight value)
        self._flags_target: Optional[int] = None
        # ONE MOSDMap message per (start, end) epoch range, shared
        # across every subscriber session: committed epochs are
        # immutable, so the same Message object — and therefore its
        # lazily-materialized wire-byte cache — serves all of them.
        # Previously each subscriber push built and encoded its own
        # copy (N encodes per epoch on an N-daemon cluster).
        self._osdmap_msg_cache: Dict[tuple, MOSDMap] = {}
        self.osdmap_msgs_built = 0     # cache misses (one per range)
        self.osdmap_msgs_shared = 0    # cache hits (re-used messages)

    # ----------------------------------------------------------- state io
    def refresh(self) -> None:
        v = self.mon.store_get("osdmap", "last_committed")
        last = int.from_bytes(v, "little") if v else 0
        if last > self.osdmap.epoch:
            full = self.mon.store_get("osdmap", f"full_{last}")
            self.osdmap = OSDMap.from_bytes(full)
            self.log.info(f"osdmap {self.osdmap.summary()}")
            if self._flags_target is not None \
                    and self.osdmap.flags == self._flags_target:
                self._flags_target = None     # landed
        if self.pending_inc.epoch <= self.osdmap.epoch:
            self.pending_inc = Incremental(self.osdmap.epoch + 1)
        elif self.pending_inc.epoch > self.osdmap.epoch + 1:
            # mutations that arrived while a proposal was in flight were
            # pre-assigned a later epoch; realign so they stay proposable
            self.pending_inc.epoch = self.osdmap.epoch + 1
        # changes accumulated while the previous proposal was in flight
        # must be proposed now or they'd sit until the next trigger
        if (self.mon.is_leader() and self._pending_dirty()
                and self.mon.paxos.is_writeable()):
            self.propose_pending()

    def _pending_dirty(self) -> bool:
        inc = self.pending_inc
        return bool(inc.new_pools or inc.new_pool_names or inc.old_pools
                    or inc.new_up or inc.new_state or inc.new_weight
                    or inc.new_primary_affinity or inc.new_up_thru
                    or inc.new_pg_temp or inc.new_primary_temp
                    or inc.new_crush is not None or inc.new_max_osd >= 0
                    or inc.fsid or inc.new_lost or inc.new_flags >= 0)

    def on_active(self) -> None:
        # a flag target proposed by the previous leadership is void:
        # its command was never acked (acks follow commit)
        self._flags_target = None
        if self.osdmap.epoch == 0:
            self.create_initial()

    def create_initial(self) -> None:
        """First map: empty, fsid only (OSDMonitor::create_initial)."""
        self.pending_inc = Incremental(1)
        self.pending_inc.fsid = self.mon.monmap.fsid
        self.pending_inc.new_max_osd = 0
        self.propose_pending()

    def encode_pending(self, txn: KVTransaction) -> bool:
        inc = self.pending_inc
        if inc.epoch != self.osdmap.epoch + 1:
            return False
        nm = OSDMap.from_bytes(self.osdmap.to_bytes()) \
            if self.osdmap.epoch else OSDMap()
        nm.apply_incremental(inc)
        nm.modified = time.time()
        e = inc.epoch
        txn.set("osdmap", f"inc_{e}", inc.to_bytes())
        txn.set("osdmap", f"full_{e}", nm.to_bytes())
        txn.set("osdmap", "last_committed", e.to_bytes(8, "little"))
        return True

    def propose_pending(self, done=None) -> None:
        self._fold_held_alive()
        txn = KVTransaction()
        try:
            ok = self.encode_pending(txn)
        except Exception:
            # a poisoned pending_inc (e.g. a mutation for an osd id the
            # map rejects) must never wedge the service: drop it — and
            # any flag target riding it never committed, so it must
            # not seed a later read-modify-write
            self.log.exception("encode_pending failed; "
                               "discarding pending incremental")
            self.pending_inc = Incremental(self.osdmap.epoch + 1)
            self._flags_target = None
            ok = False
        if not ok:
            if done:
                done(False)
            return
        self.pending_inc = Incremental(self.pending_inc.epoch + 1)
        self.mon.paxos.propose_new_value(txn.encode(), done)

    def build_osdmap_msg(self, start: int, end: int) -> MOSDMap:
        """Incrementals [start..end]; falls back to a full map when the
        range predates start or is trimmed.

        The built message is CACHED per range and shared across
        subscribers: the messenger encodes a message's body at most
        once (Message.wire_bytes), so a 5-OSD cluster pays ONE encode
        per epoch instead of five — and local-delivery receivers share
        the object graph with zero encodes.  Safe because epoch blobs
        are immutable and nothing mutates a message after send."""
        key = (start, end)
        cached = self._osdmap_msg_cache.get(key)
        if cached is not None:
            self.osdmap_msgs_shared += 1
            return cached
        msg = self._build_osdmap_msg(start, end)
        if end >= 1:
            self.osdmap_msgs_built += 1
            if len(self._osdmap_msg_cache) >= 64:
                self._osdmap_msg_cache.clear()
            self._osdmap_msg_cache[key] = msg
        return msg

    def _build_osdmap_msg(self, start: int, end: int) -> MOSDMap:
        msg = MOSDMap()
        if end < 1:
            return msg   # nothing committed yet
        if start == 0 or start <= self.osdmap.epoch - 100:
            full = self.mon.store_get("osdmap", f"full_{end}")
            if full is not None:
                msg.fulls[end] = full
            return msg
        for e in range(start, end + 1):
            inc = self.mon.store_get("osdmap", f"inc_{e}")
            if inc is None:
                full = self.mon.store_get("osdmap", f"full_{end}")
                if full is not None:
                    msg.fulls[end] = full
                return msg
            msg.incrementals[e] = inc
        return msg

    # ------------------------------------------------------------ reports
    def dispatch(self, m) -> None:
        if not self.mon.is_leader():
            return   # reports go to the leader; clients retry via hints
        if isinstance(m, MOSDBoot):
            self.prepare_boot(m)
        elif isinstance(m, MOSDFailure):
            self.prepare_failure(m)
        elif isinstance(m, MOSDAlive):
            self.prepare_alive(m)
        elif isinstance(m, MPGTemp):
            self.prepare_pgtemp(m)

    def prepare_boot(self, m: MOSDBoot) -> None:
        osd = m.osd_id
        if osd >= (self.pending_inc.new_max_osd
                   if self.pending_inc.new_max_osd >= 0
                   else self.osdmap.max_osd):
            self.pending_inc.new_max_osd = osd + 1
        self.pending_inc.new_up[osd] = m.addr
        if not self.osdmap.exists(osd) or self.osdmap.osd_weight[osd] == 0:
            # new or previously-out osd boots in (mon_osd_auto_mark_in)
            self.pending_inc.new_weight[osd] = OSD_IN_WEIGHT
        self.failure_reports.pop(osd, None)
        self.down_stamp.pop(osd, None)
        self.log.info(f"osd.{osd} boot from {m.addr}")
        self.propose_pending()

    def prepare_failure(self, m: MOSDFailure) -> None:
        target = m.target_osd
        reporter = int(m.src_name.id) if m.src_name else -1
        if not m.is_failed:
            reps = self.failure_reports.get(target)
            if reps:
                reps.pop(reporter, None)
            return
        if not self.osdmap.exists(target) or self.osdmap.is_down(target):
            return
        if target < len(self.osdmap.osd_info) \
                and m.epoch < self.osdmap.osd_info[target].up_from:
            # the reporter hadn't seen the target's LATEST boot: its
            # grace window straddles the re-boot and its report is
            # about the previous incarnation.  Counting it re-downs a
            # freshly booted osd and sustains a flap loop (mon marks
            # down -> osd re-boots -> stale reports mark it down
            # again; OSDMonitor::prepare_failure failed_since guard).
            return
        if self.pending_inc.new_state.get(target, 0) & OSD_UP:
            return   # down-mark already queued: a second XOR would undo it
        reps = self.failure_reports.setdefault(target, {})
        reps[reporter] = time.monotonic()
        if len(reps) >= self.mon.cfg["mon_osd_min_down_reporters"]:
            # can_mark_down safeguard: never take down the last up osd
            # via reports (OSDMonitor.cc:1666 up-ratio check distilled)
            if self.osdmap.count_up() <= 1:
                self.log.warning(f"refusing to mark osd.{target} down: "
                                 "last one standing")
                return
            self.log.info(f"marking osd.{target} down "
                          f"({len(reps)} reporters)")
            self.pending_inc.new_state[target] = \
                self.pending_inc.new_state.get(target, 0) | OSD_UP
            self.failure_reports.pop(target, None)
            self.down_stamp[target] = time.monotonic()
            self._last_down_mark = time.monotonic()
            self.propose_pending()

    def prepare_alive(self, m: MOSDAlive) -> None:
        if not self.osdmap.exists(m.osd_id):
            return   # stray daemon: a bad id would poison the incremental
        if max(self.osdmap.get_up_thru(m.osd_id),
               self.pending_inc.new_up_thru.get(m.osd_id, 0)) \
                >= m.want_epoch:
            # a duplicate: its grant is committed or pending already
            # (OSDMonitor::preprocess_alive).  Granting it again is an
            # epoch for nothing, which every OSD must advance through
            return
        # An up_thru grant asserts "this osd could serve its interval",
        # which is exactly what a later PriorSet walk reads back as
        # maybe_went_rw.  In steady state grant immediately; but inside
        # the propose window after a down-mark, HOLD the grant (real
        # mons batch proposals across paxos_propose_interval): the
        # requester is typically the failure's new solo primary, and if
        # it dies before the window closes the grant is dropped — its
        # never-activated interval must not be branded rw, or a
        # restarted partner would block on the corpse forever
        if time.monotonic() - self._last_down_mark \
                < self.mon.cfg["paxos_propose_interval"]:
            self._held_alive[m.osd_id] = time.monotonic()
            self._arm_alive_flush(self.mon.cfg["paxos_propose_interval"])
            return
        # grant up_thru = the pending epoch (>= the osd's want_epoch)
        self.pending_inc.new_up_thru[m.osd_id] = self.pending_inc.epoch
        self.propose_pending()

    def _arm_alive_flush(self, delay: float) -> None:
        if self._alive_flush is None:
            import asyncio
            self._alive_flush = asyncio.get_running_loop().call_later(
                delay, self._flush_alive)

    def _flush_alive(self) -> None:
        self._alive_flush = None
        if not self._held_alive:
            return
        if not (self.mon.running and self.mon.is_leader()
                and self.mon.paxos.is_writeable()):
            self._arm_alive_flush(0.25)   # grants ride out an election
            return
        self.propose_pending()

    def _fold_held_alive(self) -> None:
        """Move held up_thru grants into the pending incremental: every
        proposal carries them (one paxos transaction per epoch).  A
        grant whose requester went down while held is DROPPED — up_thru
        is a liveness assertion, and committing it posthumously would
        poison maybe_went_rw for intervals that never activated."""
        if not self._held_alive:
            return
        inc = self.pending_inc
        for osd in list(self._held_alive):
            down_in_inc = bool(inc.new_state.get(osd, 0) & OSD_UP)
            if self.osdmap.is_up(osd) and not down_in_inc:
                inc.new_up_thru[osd] = inc.epoch
            else:
                self.log.warning(
                    f"dropping held up_thru grant for osd.{osd}: "
                    f"requester went down before the grant committed")
            del self._held_alive[osd]

    def prepare_pgtemp(self, m: MPGTemp) -> None:
        changed = False
        for pg, osds in m.pg_temp.items():
            if self.osdmap.pg_temp.get(pg, []) != osds:
                self.pending_inc.new_pg_temp[pg] = osds
                changed = True
        if changed:
            self.propose_pending()

    def tick(self) -> None:
        """Leader periodic work: age down osds to out."""
        from ceph_tpu_torch.osd.osdmap import FLAG_NOOUT
        if self.osdmap.flags & FLAG_NOOUT:
            return        # maintenance: `osd set noout` holds them in
        now = time.monotonic()
        grace = self.mon.cfg["mon_osd_down_out_interval"]
        dirty = False
        for osd in range(self.osdmap.max_osd):
            if (self.osdmap.exists(osd) and self.osdmap.is_down(osd)
                    and self.osdmap.is_in(osd)):
                stamp = self.down_stamp.setdefault(osd, now)
                if grace and now - stamp > grace:
                    self.log.info(f"osd.{osd} down > {grace}s: marking out")
                    self.pending_inc.new_weight[osd] = 0
                    dirty = True
        if dirty:
            self.propose_pending()

    # ------------------------------------------------------------ commands
    def handle_command(self, m: MMonCommand) -> None:
        cmd = m.cmd
        prefix = cmd.get("prefix", "")
        ack = lambda rc, outs="", outbl=b"": self.mon.reply(
            m, MMonCommandAck(m.tid, rc, outs, outbl))

        if prefix == "osd dump":
            ack(0, self.osdmap.summary(), self.osdmap.to_bytes())
        elif prefix == "osd getmap":
            e = int(cmd.get("epoch", self.osdmap.epoch))
            full = self.mon.store_get("osdmap", f"full_{e}")
            if full is None:
                ack(-errno.ENOENT, f"no osdmap epoch {e}")
            else:
                ack(0, f"osdmap e{e}", full)
        elif prefix == "osd stat":
            ack(0, self.osdmap.summary())
        elif prefix == "osd tree":
            ack(0, json.dumps(self._tree()))
        elif prefix == "osd setmaxosd":
            self.pending_inc.new_max_osd = int(cmd["num"])
            self._propose_and_ack(m)
        elif prefix == "osd pool create":
            self._cmd_pool_create(m)
        elif prefix == "osd pool delete":
            pid = self.osdmap.lookup_pool(cmd["pool"])
            if pid < 0:
                ack(-errno.ENOENT, f"no pool {cmd['pool']!r}")
                return
            self.pending_inc.old_pools.append(pid)
            self._propose_and_ack(m)
        elif prefix == "osd pool ls":
            ack(0, json.dumps(sorted(self.osdmap.pool_names.values())))
        elif prefix == "osd out":
            self._cmd_weight(m, int(cmd["id"]), 0)
        elif prefix == "osd in":
            self._cmd_weight(m, int(cmd["id"]), OSD_IN_WEIGHT)
        elif prefix == "osd down":
            osd = int(cmd["id"])
            if self.osdmap.is_up(osd) and not \
                    (self.pending_inc.new_state.get(osd, 0) & OSD_UP):
                self.pending_inc.new_state[osd] = \
                    self.pending_inc.new_state.get(osd, 0) | OSD_UP
                self.down_stamp[osd] = time.monotonic()
                self._last_down_mark = time.monotonic()
            self._propose_and_ack(m)
        elif prefix in ("osd set", "osd unset"):
            # cluster flags: `osd set noout|noscrub|nodeep-scrub`
            from ceph_tpu_torch.osd.osdmap import CLUSTER_FLAGS, flag_names
            bit = CLUSTER_FLAGS.get(cmd.get("key", ""))
            if bit is None:
                ack(-errno.EINVAL,
                    f"unknown flag {cmd.get('key')!r} "
                    f"(know: {sorted(CLUSTER_FLAGS)})")
                return
            cur = self.pending_inc.new_flags
            if cur < 0:
                cur = self._flags_target \
                    if self._flags_target is not None \
                    else self.osdmap.flags
            new = (cur | bit) if prefix == "osd set" else (cur & ~bit)
            if new == cur == self.osdmap.flags:
                ack(0, f"flags {','.join(flag_names(new)) or '(none)'}")
                return
            self.pending_inc.new_flags = new
            self._flags_target = new
            self._propose_and_ack(
                m, outs=f"flags {','.join(flag_names(new)) or '(none)'}")
        elif prefix == "osd reweight":
            osd = int(cmd["id"])
            if not self.osdmap.exists(osd):
                ack(-errno.ENOENT, f"osd.{osd} dne")
                return
            w = float(cmd["weight"])
            if not (0.0 <= w <= 1.0):
                ack(-errno.EINVAL, "weight must be in [0, 1]")
                return
            self.pending_inc.new_weight[osd] = int(w * OSD_IN_WEIGHT)
            self._propose_and_ack(m)
        elif prefix == "osd reweight-by-utilization":
            # OSDMonitor::reweight_by_utilization: nudge overloaded osds
            # down proportionally to their PG-count excess over the mean
            # (usage proxy — the reference uses kb_used the same way).
            # The all-PG census sweeps every pool through the batched
            # placement kernel (OSDMap.map_pgs_batch: one launch per
            # pool) instead of waiting on reported pg_stats — the mon
            # answers from the map it is about to mutate
            oload = int(cmd.get("oload", 120))
            if oload <= 100:
                ack(-errno.EINVAL, "oload must be > 100")
                return
            per_osd: Dict[int, int] = {}
            for pool_id in self.osdmap.pools:
                for _pg, _up, _upp, acting, _actp in \
                        self.osdmap.map_pgs_batch(pool_id,
                                                  engine="host"):
                    for o in acting:
                        if o >= 0:
                            per_osd[o] = per_osd.get(o, 0) + 1
            if not per_osd:
                ack(0, json.dumps({"avg_pgs": 0, "reweighted": {}}))
                return
            avg = sum(per_osd.values()) / len(per_osd)
            changed = {}
            for o, n in per_osd.items():
                # pg_stats rows can reference osds that no longer exist
                # or were operator-outed: never resurrect or crash on
                # them
                if not self.osdmap.exists(o) or self.osdmap.is_out(o):
                    continue
                if n * 100 > avg * oload:
                    cur = self.osdmap.osd_weight[o]
                    neww = max(1, int(cur * avg / n))
                    self.pending_inc.new_weight[o] = neww
                    changed[o] = {"pgs": n,
                                  "weight": neww / OSD_IN_WEIGHT}
            if changed:
                self._propose_and_ack(
                    m, outs=json.dumps({"avg_pgs": avg,
                                        "reweighted": changed}))
            else:
                ack(0, json.dumps({"avg_pgs": avg, "reweighted": {}}))
        elif prefix == "osd lost":
            # operator declares an osd's data unrecoverable so peering
            # stops waiting for it (OSDMonitor 'osd lost' command; needs
            # the same explicit confirmation the reference demands)
            osd = int(cmd["id"])
            if not self.osdmap.exists(osd):
                ack(-errno.ENOENT, f"osd.{osd} dne")
                return
            if not cmd.get("yes_i_really_mean_it"):
                ack(-errno.EPERM,
                    "are you SURE? this might mean real, permanent data "
                    "loss. pass --yes-i-really-mean-it if you really do")
                return
            if self.osdmap.is_up(osd):
                ack(-errno.EBUSY, f"osd.{osd} is up; mark it down first")
                return
            self.pending_inc.new_lost[osd] = self.osdmap.epoch
            self._propose_and_ack(m)
        elif prefix == "osd primary-affinity":
            osd = int(cmd["id"])
            if not self.osdmap.exists(osd):
                ack(-errno.ENOENT, f"osd.{osd} dne")
                return
            w = float(cmd["weight"])
            self.pending_inc.new_primary_affinity[osd] = \
                int(w * 0x10000) & 0x1FFFF
            self._propose_and_ack(m)
        elif prefix == "osd erasure-code-profile set":
            # OSDMonitor.cc erasure-code-profile set: name + k=v pairs.
            # k/m are always materialized so every consumer reads the
            # same geometry
            name = cmd["name"]
            prof = {kk: str(vv) for kk, vv in cmd.get("profile", {}).items()}
            prof.setdefault("k", "4")
            prof.setdefault("m", "2")
            existing = self.osdmap.ec_profiles.get(name)
            if existing == prof:
                ack(0, f"profile {name!r} unchanged")
                return
            if existing is not None:
                used = [pn for pid, pn in self.osdmap.pool_names.items()
                        if self.osdmap.pools[pid].ec_profile == name]
                if used:
                    # changing geometry under live pools makes every
                    # existing object undecodable — never allowed
                    ack(-errno.EBUSY,
                        f"profile {name!r} in use by {used}")
                    return
                if not cmd.get("force"):
                    ack(-errno.EPERM,
                        f"profile {name!r} exists with different params; "
                        f"use force to overwrite")
                    return
            self.pending_inc.new_ec_profiles[name] = prof
            self._propose_and_ack(m, outs=f"profile {name!r} set")
        elif prefix == "osd erasure-code-profile get":
            prof = self.osdmap.ec_profiles.get(cmd["name"])
            if prof is None:
                ack(-errno.ENOENT, f"no profile {cmd['name']!r}")
            else:
                ack(0, json.dumps(prof))
        elif prefix == "osd erasure-code-profile ls":
            ack(0, json.dumps(sorted(self.osdmap.ec_profiles)))
        elif prefix == "osd erasure-code-profile rm":
            name = cmd["name"]
            used = [pn for pid, pn in self.osdmap.pool_names.items()
                    if self.osdmap.pools[pid].ec_profile == name]
            if used:
                ack(-errno.EBUSY, f"profile {name!r} in use by {used}")
                return
            if name not in self.osdmap.ec_profiles:
                ack(0, f"no profile {name!r}")
                return
            self.pending_inc.old_ec_profiles.append(name)
            self._propose_and_ack(m, outs=f"profile {name!r} removed")
        elif prefix in ("osd pool mksnap", "osd pool rmsnap",
                        "osd pool lssnap", "osd pool selfmanaged-mksnap",
                        "osd pool selfmanaged-rmsnap"):
            self._cmd_pool_snap(m, prefix.rsplit(" ", 1)[1])
        elif prefix in ("osd tier add", "osd tier remove",
                        "osd tier cache-mode", "osd tier set-overlay",
                        "osd tier remove-overlay"):
            self._cmd_tier(m, prefix.rsplit(" ", 1)[1])
        elif prefix == "osd pool set":
            self._cmd_pool_set(m)
        elif prefix in ("pg scrub", "pg deep-scrub"):
            # route to the PG's acting primary (reference
            # OSDMonitor/MOSDScrub path)
            from ceph_tpu_torch.osd.messages import MPGScrub
            from ceph_tpu_torch.osd.types import PGId
            try:
                # canonical "<pool>.<seed-hex>" grammar (PGId.__str__)
                pgid = PGId.parse(str(cmd["pgid"])).without_shard()
            except (KeyError, ValueError):
                ack(-errno.EINVAL, f"bad pgid {cmd.get('pgid')!r}")
                return
            if pgid.pool not in self.osdmap.pools:
                ack(-errno.ENOENT, f"no pool {pgid.pool}")
                return
            _, _, _, primary = self.osdmap.pg_to_up_acting_osds(pgid)
            addr = self.osdmap.get_addr(primary) if primary >= 0 else None
            if addr is None:
                ack(-errno.EAGAIN, f"pg {cmd['pgid']} has no primary")
                return
            self.mon.messenger.send_message(
                MPGScrub(pgid, deep=(prefix == "pg deep-scrub")),
                addr, peer_type="osd")
            ack(0, f"instructing pg {cmd['pgid']} on osd.{primary} to "
                   f"{'deep-' if prefix == 'pg deep-scrub' else ''}scrub")
        elif prefix == "osd crush set-map":
            self.pending_inc.new_crush = CrushMap.from_bytes(m.inbl)
            self._propose_and_ack(m)
        elif prefix == "osd crush build-simple":
            # convenience: hierarchy for n osds (vstart / tests)
            crush = CrushMap()
            n = int(cmd["num_osds"])
            per_host = int(cmd.get("osds_per_host", 1))
            crush.max_devices = max(n, self.osdmap.max_osd)
            build_hierarchy(crush, n, per_host)
            make_replicated_rule(crush, "replicated_rule")
            self.pending_inc.new_crush = crush
            if n > self.osdmap.max_osd:
                self.pending_inc.new_max_osd = n
            self._propose_and_ack(m)
        else:
            ack(-errno.EINVAL, f"unknown osd command {prefix!r}")

    def _cmd_pool_snap(self, m: MMonCommand, verb: str) -> None:
        """Pool snapshots (OSDMonitor mksnap/rmsnap; pg_pool_t snap
        state rides the map so every OSD/client sees the same snapc)."""
        import copy
        import json as _json
        cmd = m.cmd
        name = cmd.get("pool", "")
        pid = self.osdmap.lookup_pool(name)
        if pid < 0:
            self.mon.reply(m, MMonCommandAck(
                m.tid, -errno.ENOENT, f"no pool {name!r}"))
            return
        pool = copy.deepcopy(self.pending_inc.new_pools.get(
            pid, self.osdmap.pools[pid]))
        snap = cmd.get("snap", "")
        if verb == "lssnap":
            self.mon.reply(m, MMonCommandAck(m.tid, 0, _json.dumps(
                [{"id": sid, "name": n}
                 for sid, n in sorted(pool.snaps.items())])))
            return
        if verb == "selfmanaged-mksnap":
            # allocate a snap id WITHOUT registering a pool snap: the
            # client (librbd analog) owns the snap context and attaches
            # it to its writes (OSDMonitor prepare_pool_op
            # POOL_OP_CREATE_UNMANAGED_SNAP)
            pool.snap_seq += 1
            self.pending_inc.new_pools[pid] = pool
            self._propose_and_ack(m, outs=str(pool.snap_seq))
            return
        if verb == "selfmanaged-rmsnap":
            sid = int(cmd.get("snapid", 0))
            if sid <= 0 or sid in pool.snaps:
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EINVAL,
                    f"snapid {sid} is not a self-managed snap"))
                return
            if sid not in pool.removed_snaps:
                pool.removed_snaps.append(sid)
                self.pending_inc.new_pools[pid] = pool
            self._propose_and_ack(m, outs=f"removed snap {sid}")
            return
        if verb == "mksnap":
            if snap in pool.snaps.values():
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EEXIST, f"snap {snap!r} exists"))
                return
            pool.snap_seq += 1
            pool.snaps[pool.snap_seq] = snap
            self.pending_inc.new_pools[pid] = pool
            self._propose_and_ack(
                m, outs=f"created pool {name} snap {snap} "
                        f"(id {pool.snap_seq})")
        else:   # rmsnap
            sid = next((i for i, n in pool.snaps.items() if n == snap),
                       None)
            if sid is None:
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.ENOENT, f"no snap {snap!r}"))
                return
            del pool.snaps[sid]
            pool.removed_snaps.append(sid)
            self.pending_inc.new_pools[pid] = pool
            self._propose_and_ack(m, outs=f"removed pool {name} snap "
                                          f"{snap}")

    def _cmd_tier(self, m: MMonCommand, verb: str) -> None:
        """Cache-tier pool linkage (OSDMonitor 'osd tier *' commands:
        add/remove set tier_of + tiers; set-overlay/remove-overlay set
        the base pool's read_tier/write_tier the Objecter redirects on;
        cache-mode gates the OSD's promote/agent machinery)."""
        import copy
        cmd = m.cmd

        def ack(rc, msg):
            self.mon.reply(m, MMonCommandAck(m.tid, rc, msg))

        def pool_of(key):
            name = cmd.get(key, "")
            pid = self.osdmap.lookup_pool(name)
            if pid < 0:
                ack(-errno.ENOENT, f"no pool {name!r}")
                return None, None
            p = copy.deepcopy(self.pending_inc.new_pools.get(
                pid, self.osdmap.pools[pid]))
            return pid, p

        if verb == "add":
            base_id, base = pool_of("pool")
            if base is None:
                return
            tier_id, tier = pool_of("tierpool")
            if tier is None:
                return
            if tier_id == base_id:
                ack(-errno.EINVAL, "a pool cannot tier itself")
                return
            if not tier.is_replicated():
                ack(-errno.EINVAL, "cache pools must be replicated")
                return
            if tier.is_tier() or tier_id in base.tiers:
                ack(-errno.EEXIST, "already a tier")
                return
            tier.tier_of = base_id
            base.tiers = sorted(set(base.tiers) | {tier_id})
            self.pending_inc.new_pools[base_id] = base
            self.pending_inc.new_pools[tier_id] = tier
            self._propose_and_ack(m, outs="tier added")
        elif verb == "remove":
            base_id, base = pool_of("pool")
            if base is None:
                return
            tier_id, tier = pool_of("tierpool")
            if tier is None:
                return
            if tier.tier_of != base_id or tier_id not in base.tiers:
                ack(-errno.EINVAL,
                    f"{cmd.get('tierpool')!r} is not a tier of "
                    f"{cmd.get('pool')!r}")
                return
            if base.read_tier == tier_id or base.write_tier == tier_id:
                ack(-errno.EBUSY, "remove the overlay first")
                return
            tier.tier_of = -1
            tier.cache_mode = "none"
            base.tiers = [t for t in base.tiers if t != tier_id]
            self.pending_inc.new_pools[base_id] = base
            self.pending_inc.new_pools[tier_id] = tier
            self._propose_and_ack(m, outs="tier removed")
        elif verb == "cache-mode":
            tier_id, tier = pool_of("pool")
            if tier is None:
                return
            mode = cmd.get("mode", "")
            if mode not in ("none", "writeback"):
                ack(-errno.EINVAL, f"unsupported cache mode {mode!r} "
                    f"(writeback|none)")
                return
            if not tier.is_tier():
                ack(-errno.EINVAL, "pool is not a tier")
                return
            tier.cache_mode = mode
            self.pending_inc.new_pools[tier_id] = tier
            self._propose_and_ack(m, outs=f"cache-mode {mode}")
        elif verb == "set-overlay":
            base_id, base = pool_of("pool")
            if base is None:
                return
            tier_id, tier = pool_of("overlaypool")
            if tier is None:
                return
            if tier_id not in base.tiers:
                ack(-errno.EINVAL, "overlay pool is not a tier of pool")
                return
            base.read_tier = tier_id
            base.write_tier = tier_id
            self.pending_inc.new_pools[base_id] = base
            self._propose_and_ack(m, outs="overlay set")
        else:   # remove-overlay
            base_id, base = pool_of("pool")
            if base is None:
                return
            base.read_tier = -1
            base.write_tier = -1
            self.pending_inc.new_pools[base_id] = base
            self._propose_and_ack(m, outs="overlay removed")

    _POOL_SET_FIELDS = {
        "hit_set_count": int, "hit_set_period": float,
        "hit_set_fpp": float, "target_max_objects": int,
        "cache_target_dirty_ratio": float,
        "cache_target_full_ratio": float, "size": int,
        "min_size": int,
        # pool quotas (`osd pool set-quota` role): the mon's quota
        # check flips FLAG_FULL_QUOTA off PGMap usage
        "quota_max_bytes": int, "quota_max_objects": int,
        # pg_num growth (split): validated by a batched all-PG sweep
        "pg_num": int,
    }

    def set_pool_full_quota(self, pid: int, full: bool) -> None:
        """Flip FLAG_FULL_QUOTA on a pool and propose (called by the
        PGMonitor's quota check — OSDMonitor handle_full role)."""
        import copy
        from ceph_tpu_torch.osd.types import FLAG_FULL_QUOTA
        pool = copy.deepcopy(self.pending_inc.new_pools.get(
            pid, self.osdmap.pools[pid]))
        if bool(pool.flags & FLAG_FULL_QUOTA) == full:
            return
        pool.flags = (pool.flags | FLAG_FULL_QUOTA) if full \
            else (pool.flags & ~FLAG_FULL_QUOTA)
        self.pending_inc.new_pools[pid] = pool
        name = self.osdmap.pool_names.get(pid, pid)
        self.mon.log.warning(
            f"pool {name!r} {'is FULL (quota exceeded)' if full else 'quota cleared'}")
        self.propose_pending()

    def _cmd_pool_set(self, m: MMonCommand) -> None:
        """osd pool set <pool> <var> <val> — the tiering/agent knobs +
        size (OSDMonitor prepare_command pool set)."""
        import copy
        cmd = m.cmd
        name = cmd.get("pool", "")
        pid = self.osdmap.lookup_pool(name)
        if pid < 0:
            self.mon.reply(m, MMonCommandAck(
                m.tid, -errno.ENOENT, f"no pool {name!r}"))
            return
        var = cmd.get("var", "")
        conv = self._POOL_SET_FIELDS.get(var)
        if conv is None:
            self.mon.reply(m, MMonCommandAck(
                m.tid, -errno.EINVAL, f"unknown pool option {var!r}"))
            return
        try:
            val = conv(cmd.get("val", ""))
        except (TypeError, ValueError):
            self.mon.reply(m, MMonCommandAck(
                m.tid, -errno.EINVAL, f"bad value for {var!r}"))
            return
        pool = copy.deepcopy(self.pending_inc.new_pools.get(
            pid, self.osdmap.pools[pid]))
        if var == "pg_num":
            if val <= pool.pg_num:
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EINVAL,
                    f"pg_num may only grow (now {pool.pg_num})"))
                return
            # sweep the WHOLE grown pg set through the batched
            # placement kernel in one launch before the map commits:
            # unplaceable growth (dead rule / empty topology) is
            # rejected here instead of surfacing as stuck pgs later
            from ceph_tpu_torch.ops.crush_kernel import batch_do_rule
            from ceph_tpu_torch.osd.types import PGId
            grown = copy.deepcopy(pool)
            grown.pg_num = val
            grown.pgp_num = val
            ruleno = self.osdmap.crush.find_rule(
                pool.crush_ruleset, pool.type, pool.size)
            if ruleno < 0:
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EINVAL,
                    f"pool {name!r} has no usable crush rule"))
                return
            pps = [grown.raw_pg_to_pps(PGId(pid, ps))
                   for ps in range(val)]
            mapped = batch_do_rule(self.osdmap.crush, ruleno, pps,
                                   pool.size, self.osdmap.osd_weight,
                                   engine="host")
            if not any(any(o >= 0 for o in row) for row in mapped):
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EINVAL,
                    "pg_num growth would leave every pg unmapped"))
                return
            pool.pgp_num = val
        setattr(pool, var, val)
        self.pending_inc.new_pools[pid] = pool
        self._propose_and_ack(m, outs=f"set pool {name} {var} = {val}")

    def _cmd_pool_create(self, m: MMonCommand) -> None:
        cmd = m.cmd
        name = cmd["pool"]
        if self.osdmap.lookup_pool(name) >= 0 or \
                name in self.pending_inc.new_pool_names.values():
            self.mon.reply(m, MMonCommandAck(m.tid, 0,
                                             f"pool {name!r} exists"))
            return
        pg_num = int(cmd.get("pg_num",
                             self.mon.cfg["osd_pool_default_pg_num"]))
        pool_type = cmd.get("pool_type", "replicated")
        pid = max([0] + list(self.osdmap.pools)
                  + list(self.pending_inc.new_pools)) + 1
        crush = self.pending_inc.new_crush or self.osdmap.crush
        if pool_type == "erasure":
            profile = cmd.get("erasure_code_profile", "default")
            stored = self.osdmap.ec_profiles.get(
                profile, self.pending_inc.new_ec_profiles.get(profile))
            if stored is not None:
                # profile wins; explicit k/m must not contradict it
                k = int(stored.get("k", 4))
                mm = int(stored.get("m", 2))
                for key, have, want in (("k", k, cmd.get("k")),
                                        ("m", mm, cmd.get("m"))):
                    if want is not None and int(want) != have:
                        self.mon.reply(m, MMonCommandAck(
                            m.tid, -errno.EINVAL,
                            f"{key}={want} contradicts profile "
                            f"{profile!r} ({key}={have})"))
                        return
            else:
                # persist the effective profile in the map so every
                # ECBackend reads the same k/m (OSDMap
                # erasure_code_profiles; never derive it from the
                # pool size)
                k = int(cmd.get("k", 4))
                mm = int(cmd.get("m", 2))
                prof = {"k": str(k), "m": str(mm)}
                if cmd.get("plugin"):
                    prof["plugin"] = str(cmd["plugin"])
                self.pending_inc.new_ec_profiles[profile] = prof
            size = k + mm
            # each EC pool gets its own indep rule (create_ruleset role)
            newc = CrushMap.from_bytes(crush.to_bytes())
            rule_name = f"ec_{name}"
            existing = [rid for rid, rn in newc.rule_name_map.items()
                        if rn == rule_name]
            if existing:
                rule = existing[0]
            else:
                rule = make_erasure_rule(newc, rule_name, size)
                self.pending_inc.new_crush = newc
            pool = PGPool(POOL_TYPE_ERASURE, size=size,
                          min_size=k + 1, crush_ruleset=rule,
                          pg_num=pg_num, ec_profile=profile)
            pool.stripe_width = k * 4096
        else:
            size = int(cmd.get("size",
                               self.mon.cfg["osd_pool_default_size"]))
            rule = 0
            pool = PGPool(POOL_TYPE_REPLICATED, size=size,
                          crush_ruleset=rule, pg_num=pg_num)
        self.pending_inc.new_pools[pid] = pool
        self.pending_inc.new_pool_names[pid] = name
        self._propose_and_ack(m, outs=f"pool {name!r} created (id {pid})")

    def _cmd_weight(self, m: MMonCommand, osd: int, w: int) -> None:
        if not self.osdmap.exists(osd):
            self.mon.reply(m, MMonCommandAck(m.tid, -errno.ENOENT,
                                             f"osd.{osd} dne"))
            return
        self.pending_inc.new_weight[osd] = w
        self._propose_and_ack(m)

    def _propose_and_ack(self, m: MMonCommand, outs: str = "") -> None:
        def done(ok):
            self.mon.reply(m, MMonCommandAck(
                m.tid, 0 if ok else -errno.EAGAIN,
                outs or f"osdmap e{self.osdmap.epoch}"))
        self.propose_pending(done)

    def _tree(self) -> list:
        out = []
        for o in range(self.osdmap.max_osd):
            if self.osdmap.exists(o):
                out.append({"id": o,
                            "up": self.osdmap.is_up(o),
                            "in": self.osdmap.is_in(o),
                            "weight": self.osdmap.osd_weight[o] / 0x10000})
        return out
