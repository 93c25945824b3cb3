"""RadosModel: randomized op workload + in-memory model + thrashing.

Reference parity: src/test/osd/RadosModel.h:104 (the expected-object
model behind ceph_test_rados) combined with the thrashosds role from
qa/tasks — random writes/deletes/reads race osd kills, restarts, out/in
flaps and map churn, and every read is checked against the model.

Ambiguity handling mirrors the reference's in-flight accounting: an op
that neither acked nor errored definitively (timeout, interval-change
EAGAIN) leaves the object in a set of acceptable values; any later read
must observe one of them.  Objects with pending ambiguity are not
written again (the abandoned op could land later and clobber a newer
write — the reference serializes per-object ops the same way).

Run standalone over many seeds:

    python -m ceph_tpu_torch.qa.rados_model --seeds 20 --rounds 80

The port's copy of ``ceph_tpu.qa.rados_model``.  Its clusters are the
port's ``qa.cluster.Cluster`` at that class's default device (``cuda``;
it raises without a card).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time
from typing import Dict, List, Optional, Set

from ceph_tpu_torch.client import ObjectOperationError
from ceph_tpu_torch.qa.cluster import Cluster


class ObjectModel:
    """Expected state of one pool; None = object absent."""

    def __init__(self):
        self.acceptable: Dict[str, Set[Optional[bytes]]] = {}
        self.dirty: Set[str] = set()    # oids with an abandoned op

    def value(self, oid: str) -> Set[Optional[bytes]]:
        return self.acceptable.get(oid, {None})

    def committed(self, oid: str, val: Optional[bytes]) -> None:
        self.acceptable[oid] = {val}
        self.dirty.discard(oid)

    def ambiguous(self, oid: str, val: Optional[bytes]) -> None:
        self.acceptable[oid] = self.value(oid) | {val}
        self.dirty.add(oid)

    def check(self, oid: str, got: Optional[bytes]) -> bool:
        return got in self.value(oid)


class Thrasher:
    """Random failure injector (thrashosds role): at most one osd is
    gone at a time so a size-3/min_size-2 pool keeps making progress."""

    def __init__(self, cl: Cluster, admin, rng: random.Random,
                 log: List[str]):
        self.cl = cl
        self.admin = admin
        self.rng = rng
        self.log = log
        self.stopped = False
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self.stopped = True
        if self._task is not None:
            await self._task

    async def _heal(self) -> None:
        """Bring every osd back up and in."""
        for i, store in list(getattr(self, "_down", {}).items()):
            await self.cl.start_osd(i, store=store)
            self.log.append(f"heal: restarted osd.{i}")
        self._down = {}
        m = self.admin.monc.osdmap
        for i in range(m.max_osd):
            if m.exists(i) and m.is_out(i):
                await self.admin.mon_command({"prefix": "osd in",
                                              "id": i})
                self.log.append(f"heal: osd.{i} back in")

    async def _run(self) -> None:
        self._down: Dict[int, object] = {}
        try:
            while not self.stopped:
                await asyncio.sleep(self.rng.uniform(0.15, 0.5))
                if self.stopped:
                    break
                action = self.rng.choice(
                    ["kill", "restart", "out_in", "down"])
                try:
                    if action == "kill" and not self._down:
                        victim = self.rng.choice(list(self.cl.osds))
                        store = await self.cl.kill_osd(victim)
                        self._down[victim] = store
                        await self.cl.mark_down_and_wait(
                            self.admin, victim)
                        self.log.append(f"killed osd.{victim}")
                    elif action == "restart" and self._down:
                        victim, store = self._down.popitem()
                        await self.cl.start_osd(victim, store=store)
                        self.log.append(f"restarted osd.{victim}")
                    elif action == "out_in":
                        m = self.admin.monc.osdmap
                        live = [i for i in self.cl.osds
                                if m.is_in(i) and m.is_up(i)]
                        if len(live) > 3:
                            victim = self.rng.choice(live)
                            await self.admin.mon_command(
                                {"prefix": "osd out", "id": victim})
                            self.log.append(f"out osd.{victim}")
                            await asyncio.sleep(
                                self.rng.uniform(0.5, 1.5))
                            await self.admin.mon_command(
                                {"prefix": "osd in", "id": victim})
                            self.log.append(f"in osd.{victim}")
                    elif action == "down":
                        # false alarm: daemon alive, map says down; it
                        # must re-assert itself
                        live = [i for i in self.cl.osds]
                        victim = self.rng.choice(live)
                        await self.admin.mon_command(
                            {"prefix": "osd down", "id": victim})
                        self.log.append(f"false-down osd.{victim}")
                except Exception as e:            # pragma: no cover
                    self.log.append(f"thrash {action} failed: {e!r}")
        finally:
            await self._heal()


async def run_model(seed: int, rounds: int = 80, n_osds: int = 5,
                    pool_kw: Optional[dict] = None,
                    n_oids: int = 24,
                    verbose: bool = False) -> dict:
    """One seeded run: returns a result dict (ok, ops, ambiguities...)."""
    rng = random.Random(seed)
    events: List[str] = []

    def _ctx(name):
        from ceph_tpu_torch.qa.cluster import make_ctx
        c = make_ctx(name)
        # the checker's signal is CONSISTENCY under thrasher-driven
        # kills, not heartbeat tuning: on a loaded box the fast-test
        # grace (1.5s) false-positives into a mon-flap storm that
        # wedges runs (seeds 406/422) — relax it; real kills still
        # stop heartbeats entirely and get detected
        c.config.set("osd_heartbeat_grace", 5.0)
        return c

    cl = Cluster(ctx_factory=_ctx)
    admin = await cl.start(n_osds)
    await admin.pool_create("model", pg_num=8,
                            **(pool_kw or {"size": 3}))
    io = admin.open_ioctx("model")
    model = ObjectModel()
    history: Dict[str, List[str]] = {}
    oids = [f"m{i}" for i in range(n_oids)]
    thrasher = Thrasher(cl, admin, rng, events)
    thrasher.start()
    stats = {"writes": 0, "deletes": 0, "reads": 0, "ambiguous": 0,
             "read_checks": 0, "snaps": 0, "snap_reads": 0}
    failures: List[str] = []
    # ---- snapshot model (ceph_test_rados SnapCreateOp/SnapRemoveOp
    # role): snapid -> frozen acceptable-value SETS per oid.  Taken
    # between ops, so the frozen sets are exactly the model's current
    # sets; an ambiguous pre-snap write that lands late carries the
    # OLD snapc (no clone) but its value is IN the frozen set — sound.
    snaps: Dict[int, Dict[str, set]] = {}
    snap_order: List[int] = []

    def _apply_snapc():
        if snap_order:
            io.set_write_snapc(max(snap_order),
                               sorted(snap_order, reverse=True))
        else:
            io.set_write_snapc(0, [])
    try:
        for r in range(rounds):
            await asyncio.sleep(rng.uniform(0.0, 0.06))
            oid = rng.choice(oids)
            op = rng.choice(["write", "write", "write", "read", "read",
                             "delete", "snap_read"]
                            + (["snap_create"] if len(snaps) < 3
                               and r % 3 == 0 else [])
                            + (["snap_remove"] if len(snaps) > 1
                               else []))
            if op == "snap_create":
                try:
                    sid = await io.selfmanaged_snap_create()
                except Exception as e:
                    # created-or-not unknown: nobody will read it, and
                    # not adding it to our snapc only skips COW for a
                    # snapid no check ever targets
                    events.append(f"round {r}: snap_create "
                                  f"ambiguous ({e!r})")
                    continue
                snaps[sid] = {o: set(model.value(o)) for o in oids}
                snap_order.append(sid)
                _apply_snapc()
                stats["snaps"] += 1
                continue
            if op == "snap_remove":
                sid = rng.choice(snap_order)
                # drop from the model FIRST: even an ambiguous remove
                # must end reads-at-snap (the clones may be trimming)
                snap_order.remove(sid)
                snaps.pop(sid, None)
                _apply_snapc()
                try:
                    await io.selfmanaged_snap_remove(sid)
                except Exception as e:
                    events.append(f"round {r}: snap_remove {sid} "
                                  f"ambiguous ({e!r})")
                continue
            if op == "snap_read":
                if not snap_order:
                    op = "read"
                else:
                    sid = rng.choice(snap_order)
                    sio = io.dup()
                    sio.set_snap_read(sid)
                    try:
                        sgot = await sio.read(oid, timeout=10.0)
                    except ObjectOperationError:
                        sgot = None
                    except asyncio.TimeoutError:
                        continue       # unavailable: no verdict
                    stats["snap_reads"] += 1
                    stats["read_checks"] += 1
                    if sgot not in snaps[sid][oid]:
                        failures.append(
                            f"round {r}: snap {sid} read {oid} = "
                            f"{sgot if sgot is None else sgot[:16]!r} "
                            f"not in frozen set")
                        events.extend(_forensics(cl, admin, "model",
                                                 oid))
                    continue
            if op in ("write", "delete") and oid in model.dirty:
                op = "read"   # never overwrite an ambiguous object
            try:
                if op == "write":
                    val = bytes([rng.randrange(256)]) * \
                        rng.randrange(1, 4096)
                    await io.write_full(oid, val)
                    model.committed(oid, val)
                    history.setdefault(oid, []).append(
                        f"r{r}: wrote {val[:1]!r}x{len(val)}")
                    stats["writes"] += 1
                elif op == "delete":
                    history.setdefault(oid, []).append(f"r{r}: delete")
                    try:
                        await io.remove(oid)
                        model.committed(oid, None)
                    except ObjectOperationError:
                        # ENOENT — fine iff absence is acceptable
                        if not model.check(oid, None):
                            failures.append(
                                f"round {r}: remove {oid} says ENOENT "
                                f"but model has it")
                        else:
                            model.committed(oid, None)
                    stats["deletes"] += 1
                else:
                    try:
                        got = await io.read(oid, timeout=10.0)
                    except ObjectOperationError:
                        got = None
                    stats["reads"] += 1
                    stats["read_checks"] += 1
                    if not model.check(oid, got):
                        failures.append(
                            f"round {r}: read {oid} = "
                            f"{got if got is None else got[:16]!r}"
                            f"... not in model "
                            f"({[v if v is None else v[:16] for v in model.value(oid)]})")
                        events.extend(_forensics(cl, admin, "model",
                                                 oid))
            except (asyncio.TimeoutError, ObjectOperationError) as e:
                # outcome unknown: both old and new values acceptable
                if op == "write":
                    model.ambiguous(oid, val)
                elif op == "delete":
                    model.ambiguous(oid, None)
                stats["ambiguous"] += 1
                events.append(f"round {r}: {op} {oid} ambiguous ({e!r})")
    finally:
        await thrasher.stop()

    # settle: all osds healed; wait for every pg clean, then final verify
    await _wait_clean(cl, admin, events)
    for oid in oids:
        deadline = time.monotonic() + 45.0
        while True:
            try:
                got = await io.read(oid, timeout=10.0)
                break
            except ObjectOperationError:
                got = None
                break
            except asyncio.TimeoutError:
                if time.monotonic() >= deadline:
                    # prolonged unavailability after full heal is a
                    # LIVENESS failure (wedged pg), distinct from loss
                    failures.append(
                        f"final read {oid} unavailable after 45s")
                    got = "__unavailable__"
                    break
        if got == "__unavailable__":
            events.extend(_forensics(cl, admin, "model", oid))
            continue
        stats["read_checks"] += 1
        if not model.check(oid, got):
            failures.append(
                f"final: {oid} = {got if got is None else got[:16]!r} "
                f"not acceptable")
            events.extend(_forensics(cl, admin, "model", oid))
    await cl.stop()
    result = {"seed": seed, "ok": not failures, "failures": failures,
              **stats, "events": len(events)}
    if verbose or failures:
        for e in events:
            print("  ", e, file=sys.stderr)
        for f in failures:
            bad_oid = f.split()[1]
            for h in history.get(bad_oid, []):
                print(f"   {bad_oid}: {h}", file=sys.stderr)
    return result


def _forensics(cl: Cluster, admin, pool: str, oid: str) -> List[str]:
    """Cluster-side state dump for a lost object: which pg, and every
    osd's log/store view of it — printed with the failure so a one-shot
    stochastic repro still tells the whole story."""
    out = [f"FORENSICS {oid}:"]
    try:
        from ceph_tpu_torch.osd.types import ObjectLocator
        m = admin.monc.osdmap
        pid = m.lookup_pool(pool)
        raw = m.object_locator_to_pg(oid, ObjectLocator(pid))
        pgid = m.pools[pid].raw_pg_to_pg(raw)
        up, _, acting, primary = m.pg_to_up_acting_osds(pgid)
        out.append(f"  pg {pgid} up {up} acting {acting} "
                   f"primary {primary}")
        for osd_id, osd in sorted(cl.osds.items()):
            for pg in osd.pgs.values():
                if pg.pgid.without_shard() != pgid.without_shard():
                    continue
                e = pg.log.latest_entry_for(oid)
                in_store = any(
                    s.name == oid
                    for s in osd.store.collection_list(pg.cid))
                out.append(
                    f"  osd.{osd_id} shard {pg.pgid.shard}: "
                    f"state={pg.state} role={pg.role} "
                    f"lu={pg.info.last_update} "
                    f"bc={pg.info.backfill_complete} "
                    f"log[{oid}]={e.version if e else None}"
                    f"{'(del)' if e and e.is_delete() else ''} "
                    f"stored={in_store} "
                    f"missing={oid in pg.missing.items}")
    except Exception as e:   # forensics must never mask the failure
        out.append(f"  (forensics failed: {e!r})")
    return out


async def _wait_clean(cl: Cluster, admin, events: List[str],
                      timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        dirty = 0
        for osd in cl.osds.values():
            for pg in osd.pgs.values():
                if not pg.is_primary():
                    continue
                if pg.state != "active" or pg._backfilling or \
                        any(pm.items for pm in pg.peer_missing.values()):
                    dirty += 1
        if dirty == 0:
            return
        await asyncio.sleep(0.3)
    events.append(f"wait_clean timed out with {dirty} dirty pgs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados_model")
    ap.add_argument("--seeds", type=int, default=5,
                    help="number of seeds (seed, seed+1, ...)")
    ap.add_argument("--seed", type=int, default=1, help="first seed")
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--osds", type=int, default=5)
    ap.add_argument("--ec", action="store_true",
                    help="run against an EC (k=2,m=2) pool")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    pool_kw = ({"pool_type": "erasure", "k": 2, "m": 2}
               if args.ec else {"size": 3})
    bad = 0
    for s in range(args.seed, args.seed + args.seeds):
        res = asyncio.run(run_model(s, rounds=args.rounds,
                                    n_osds=args.osds, pool_kw=pool_kw,
                                    verbose=args.verbose))
        print(json.dumps(res))
        if not res["ok"]:
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
