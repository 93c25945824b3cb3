"""PG scrub: integrity verification + repair.

Reference parity: osd/PG.cc:3300 (sched_scrub / chunky scrub),
osd/ScrubStore.cc (error records), osd/ECBackend.cc:1695 (get_hash_info
— the per-chunk digest role our `_crc` xattr plays), osd/osd_types.h
ScrubMap.

Redesign: scrub runs as a PG-op-queue item on every member, so it
serializes with writes without extra locking (the reference blocks
writes on scrub ranges instead).  One pass covers the whole PG — the
reference's chunked cursor is a scale concern deferred to real-disk
stores.

Light scrub compares object sets + sizes + digest xattrs across the
acting set.  Deep scrub additionally recomputes crc32c of every stored
byte and checks it against the digest the write path recorded
(`_crc` xattr — written per-shard by ECBackend, per-object by
ReplicatedBackend full writes; partial overwrites invalidate it like
the reference's data_digest).

Repair (replicated): a copy is GOOD if its recomputed crc matches its
stored digest; the authoritative copy is the primary's when good, else
any good replica.  Bad/missing/stale copies are re-pushed from the
authoritative one (or pulled when the primary itself is bad).
Repair (EC): a shard is bad when its own recomputed crc disagrees with
its stored digest; it is rebuilt from the surviving shards via the
existing reconstruction path with the bad shards excluded from the
gather.

The port's copy of ``ceph_tpu.osd.scrub``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional

from ceph_tpu_torch.common.crc import crc32c
from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
from ceph_tpu_torch.osd.messages import MPGScrubMap, MPGScrubScan, ScrubEntry
from ceph_tpu_torch.store.objectstore import (NoSuchCollection, NoSuchObject,
                                        Transaction)

CRC_XATTR = "_crc"      # digest the write path records (hinfo role)


def build_scrub_map(pg, deep: bool) -> Dict[str, ScrubEntry]:
    """Scan our local copy of the PG (runs inside the PG worker)."""
    store = pg.osd.store
    out: Dict[str, ScrubEntry] = {}
    try:
        soids = store.collection_list(pg.cid)
    except NoSuchCollection:
        return out
    for soid in soids:
        if soid.name == pg.meta_oid.name:
            continue
        if not soid.is_head():
            # clones scrub like heads, keyed by name\x00snapid; their
            # CRC_XATTR (per-object for replicated, per-shard for EC)
            # was copied at clone time, so deep scrub self-verifies
            # the frozen bytes
            key = f"{soid.name}\x00{soid.snap}"
        else:
            key = soid.name
        try:
            stored = -1
            try:
                raw = store.getattr(pg.cid, soid, CRC_XATTR)
                if raw:
                    stored = int(raw)
            except Exception:
                pass
            if deep:
                data = store.read(pg.cid, soid)
                out[key] = ScrubEntry(
                    size=len(data), stored_crc=stored,
                    computed_crc=crc32c(data))
            else:
                # light scrub never reads object bytes (stat only)
                out[key] = ScrubEntry(
                    size=store.stat(pg.cid, soid)["size"],
                    stored_crc=stored, computed_crc=-1)
        except (NoSuchObject, NoSuchCollection):
            continue
    return out


def entry_is_good(e: Optional[ScrubEntry], deep: bool) -> bool:
    """A copy proves itself by matching its own recorded digest; light
    scrub (or no digest) can only say it exists."""
    if e is None:
        return False
    if deep and e.stored_crc >= 0 and e.computed_crc >= 0:
        return e.computed_crc == e.stored_crc
    return True


async def scrub_pg(pg, deep: bool, repair: bool = True) -> Dict:
    """Primary-side scrub: gather maps, compare, repair.  Runs as a PG
    op-queue item, so no client write interleaves."""
    osd = pg.osd
    t0 = time.monotonic()   # elapsed-time measurement (MONO05)
    maps: Dict[int, Dict[str, ScrubEntry]] = {
        osd.whoami: build_scrub_map(pg, deep)}
    # gather peer maps (their scans also ride their op queues)
    waiters = {}
    for i, peer in enumerate(pg.acting):
        if peer == osd.whoami or peer == CRUSH_ITEM_NONE \
                or not osd.osdmap.is_up(peer):
            continue
        tid = osd.next_tid()
        fut = asyncio.get_running_loop().create_future()
        pg._scrub_map_waiters[tid] = fut
        waiters[peer] = (tid, fut)
        osd.send_osd(peer, MPGScrubScan(
            pg.pgid.with_shard(pg.shard_of(peer)), tid, deep, osd.whoami))
    for peer, (tid, fut) in waiters.items():
        try:
            maps[peer] = (await asyncio.wait_for(fut, 20.0)).entries
        except asyncio.TimeoutError:
            pg.log_.warning(f"{pg.pgid} scrub: no map from osd.{peer}")
        finally:
            pg._scrub_map_waiters.pop(tid, None)

    all_oids = set()
    for m in maps.values():
        all_oids.update(m)
    errors = 0
    repaired = 0
    inconsistent = []
    if pg.pool.is_erasure():
        errors, repaired, inconsistent = await _scrub_ec(
            pg, maps, all_oids, deep, repair)
    else:
        errors, repaired, inconsistent = await _scrub_replicated(
            pg, maps, all_oids, deep, repair)

    # persisted PGInfo stamp, compared across daemon restarts by the
    # scrub scheduler — monotonic resets per process, so this one stays
    # wall-clock by design
    now_ms = int(time.time() * 1000)   # lint: allow[MONO05] persisted stamp
    pg.info.last_scrub_stamp = now_ms
    if deep:
        pg.info.last_deep_scrub_stamp = now_ms
    txn = Transaction()
    # ScrubStore role: persist the last result with the pg meta
    txn.touch(pg.cid, pg.meta_oid)
    txn.omap_setkeys(pg.cid, pg.meta_oid, {
        b"scrub_errors": str(errors).encode(),
        # \x01-joined: clone keys embed \x00 (name\x00snapid)
        b"scrub_inconsistent": "\x01".join(inconsistent).encode(),
    })
    pg.save_meta(txn)
    osd.store.apply_transaction(txn)
    osd.perf_scrub.inc("scrubs_deep" if deep else "scrubs_light")
    if errors:
        osd.perf_scrub.inc("scrub_errors", errors)
        osd.perf_scrub.inc("scrub_repaired", repaired)
        pg.log_.warning(
            f"{pg.pgid} {'deep-' if deep else ''}scrub: {errors} errors, "
            f"{repaired} repaired ({time.monotonic() - t0:.2f}s)")
        # operator-visible cluster log event (LogClient -> LogMonitor)
        osd.ctx.cluster_log.warn(
            f"pg {pg.pgid} {'deep-' if deep else ''}scrub: {errors} "
            f"errors, {repaired} repaired")
    else:
        pg.log_.info(f"{pg.pgid} {'deep-' if deep else ''}scrub ok "
                     f"({len(all_oids)} objects, "
                     f"{time.monotonic() - t0:.2f}s)")
    return {"errors": errors, "repaired": repaired,
            "objects": len(all_oids), "inconsistent": inconsistent}


async def _scrub_replicated(pg, maps, all_oids, deep, repair):
    osd = pg.osd
    errors = repaired = 0
    inconsistent = []
    me = osd.whoami
    # detection pass: per-key comparison; repairs ACCUMULATE per base
    # object, because a push moves head + SnapSet + clones wholesale
    # (MPGPush v2) — the repair auth must hold good copies of EVERY
    # key of the base, and the push must reach the UNION of bad osds
    repairs: Dict[str, dict] = {}
    for oid in sorted(all_oids):
        base, _, snap_s = oid.partition("\x00")
        is_clone = bool(snap_s)
        if not is_clone:
            latest = pg.log.latest_entry_for(oid)
            if latest is not None and latest.is_delete():
                # a deleted HEAD is expected-absent; its CLONES
                # legitimately outlive it (snapdir role), so only
                # head keys skip here
                continue
        entries = {o: maps[o].get(oid) for o in maps}
        # copies that PROVE themselves (recomputed crc == stored digest)
        proven = {o for o, e in entries.items() if e is not None
                  and deep and e.stored_crc >= 0 and e.computed_crc >= 0
                  and e.computed_crc == e.stored_crc}
        if proven:
            auth = me if me in proven else sorted(proven)[0]
            cands = set(proven)
        else:
            # digest-less objects (partial-write history): nothing
            # self-verifies, so majority vote on (size, crc).  Trusting
            # the primary unconditionally would push primary bit-rot
            # over good replicas.
            groups: Dict[tuple, set] = {}
            for o, e in entries.items():
                if e is not None:
                    groups.setdefault((e.size, e.computed_crc),
                                      set()).add(o)
            if not groups:
                errors += 1
                inconsistent.append(oid)
                repairs.setdefault(base, {"bad": set(), "cands": [],
                                          "ok": True})["ok"] = False
                continue
            best = max(groups.values(), key=len)
            n_copies = sum(len(g) for g in groups.values())
            if len(groups) > 1 and len(best) * 2 <= n_copies:
                # no strict majority: report, never guess a repair
                errors += len(groups) - 1
                inconsistent.append(oid)
                repairs.setdefault(base, {"bad": set(), "cands": [],
                                          "ok": True})["ok"] = False
                continue
            auth = me if me in best else sorted(best)[0]
            cands = set(best)
        ref = entries[auth]
        bad = set()
        for o, e in entries.items():
            if o == auth:
                continue
            if e is None or not entry_is_good(e, deep) \
                    or e.size != ref.size or (
                        deep and e.computed_crc >= 0
                        and ref.computed_crc >= 0
                        and e.computed_crc != ref.computed_crc):
                bad.add(o)
        if not bad:
            continue
        errors += len(bad)
        inconsistent.append(oid)
        rec = repairs.setdefault(base, {"bad": set(), "cands": [],
                                        "ok": True})
        rec["bad"] |= bad
        rec["cands"].append(cands - bad)

    # repair pass: one push per base covering the union of bad osds,
    # sourced from an osd whose copies of EVERY key verified
    if repair:
        for base in sorted(repairs):
            rec = repairs[base]
            if not rec["bad"] or not rec["ok"]:
                continue
            cands = set(maps)
            for c in rec["cands"]:
                cands &= c
            cands -= rec["bad"]
            if not cands:
                # no single osd holds a good copy of every key:
                # reported inconsistent above, never guess a source
                continue
            auth = me if me in cands else sorted(cands)[0]
            bad = set(rec["bad"])
            if auth != me:
                # heal ourselves first, then fan out from our copy
                try:
                    await pg.pull_object_via_push(auth, base,
                                                  pg.interval_epoch)
                    repaired += 1 if me in bad else 0
                    bad.discard(me)
                except Exception:
                    # one failed pull must not abort the whole scrub
                    pg.log_.exception(
                        f"{pg.pgid} scrub self-repair {base}")
                    continue
            for o in sorted(bad):
                try:
                    await pg.backend.recover_object(o, base)
                    repaired += 1
                except Exception:
                    pg.log_.exception(
                        f"{pg.pgid} scrub repair {base}->{o}")
    return errors, repaired, inconsistent


async def _scrub_ec(pg, maps, all_oids, deep, repair):
    """EC: each shard proves itself against its own digest; bad shards
    rebuild from the good ones (excluded from the gather)."""
    osd = pg.osd
    errors = repaired = 0
    inconsistent = []
    me = osd.whoami
    shard_of = {o: pg.shard_of(o) for o in pg.acting
                if o != CRUSH_ITEM_NONE}
    # detection pass: repairs rebuild the BASE per osd (recover/pull
    # reconstruct the head chunk AND every clone chunk), so the
    # exclude set must be the UNION of bad shards across all keys of
    # the base — a shard bad on only one clone key must never feed
    # ANY rebuild of that base (its garbage would be re-encoded with
    # a fresh self-consistent digest and scrub clean forever after)
    base_bad: Dict[str, set] = {}
    for oid in sorted(all_oids):
        base, _, snap_s = oid.partition("\x00")
        if not snap_s:
            latest = pg.log.latest_entry_for(oid)
            if latest is not None and latest.is_delete():
                # deleted HEAD is expected-absent; clone keys
                # legitimately outlive it (snapdir role)
                continue
        bad_osds = set()
        for o, m in maps.items():
            e = m.get(oid)
            if e is None or not entry_is_good(e, deep):
                bad_osds.add(o)
        if not bad_osds:
            continue
        errors += len(bad_osds)
        inconsistent.append(oid)
        base_bad.setdefault(base, set()).update(bad_osds)
    if repair:
        for base in sorted(base_bad):
            bad_osds = base_bad[base]
            bad_shards = {shard_of[o] for o in bad_osds
                          if o in shard_of}
            good_osds = sorted(set(maps) - bad_osds)
            for o in sorted(bad_osds):
                if o not in shard_of:
                    continue
                try:
                    if o == me:
                        if not good_osds:
                            continue   # nothing trustworthy left
                        await pg.backend.pull_object(
                            good_osds[0], base, pg.interval_epoch,
                            exclude=bad_shards - {shard_of[o]})
                    else:
                        await pg.backend.recover_object(
                            o, base, exclude=bad_shards - {shard_of[o]})
                    repaired += 1
                except Exception:
                    pg.log_.exception(f"{pg.pgid} scrub repair {base} "
                                      f"shard {shard_of[o]}")
    return errors, repaired, inconsistent


def handle_scrub_scan(pg, m: MPGScrubScan) -> None:
    """Replica side: build our map and reply (runs in the PG worker)."""
    entries = build_scrub_map(pg, m.deep)
    pg.osd.send_osd(m.from_osd, MPGScrubMap(
        pg.pgid, m.tid, entries, pg.osd.whoami))
