"""The port's stochastic model checker (``ceph_tpu_torch.qa.rados_model``)
under thrashing, on the CPU.

Every case of ``tests/test_thrash.py`` runs on the port: the reference
test module's source with ``ceph_tpu`` read as ``ceph_tpu_torch``
(``test_torch_osd.case_module``), every port cluster, OSD and client on
``device="cpu"`` (``cpu_defaults``), with the reference's seeds and its
slow marks (replicated seed 5, EC seed 105) and no others.  The runs
are stochastic (thrasher timing), so what is held against the reference
is the checker's model: ``ObjectModel`` takes the same seeded op
sequence in both packages and must answer alike.
"""

from __future__ import annotations

import random
import sys

import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import PORT, REF, case_module, cpu_defaults  # noqa: E402

_REF = case_module("test_thrash", REF)


def _port_case(name, *args):
    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        getattr(case_module("test_thrash", PORT), name)(*args)


@pytest.mark.parametrize("seed", _REF.SEEDS)
def test_model_checker_replicated(seed):
    _port_case("test_model_checker_replicated", seed)


@pytest.mark.parametrize("seed", _REF.EC_SEEDS)
def test_model_checker_ec_pool(seed):
    _port_case("test_model_checker_ec_pool", seed)


def test_crash_mid_backfill_forces_retry():
    _port_case("test_crash_mid_backfill_forces_retry")


def test_backfill_windowed_listing_and_cursor_resume():
    _port_case("test_backfill_windowed_listing_and_cursor_resume")


def test_op_intake_throttle_bounds_memory():
    _port_case("test_op_intake_throttle_bounds_memory")


def test_every_reference_case_has_a_port_case():
    ref = {n for n in vars(_REF) if n.startswith("test_")}
    assert len(ref) == 5 and ref <= set(globals())


def test_the_seeds_and_slow_marks_are_the_references():
    def marked(params):
        return sorted((p.values[0] if hasattr(p, "values") else p,
                       any(m.name == "slow" for m in getattr(p, "marks", ())))
                      for p in params)
    assert marked(_REF.SEEDS) == [(s, s == 5) for s in range(1, 7)]
    assert marked(_REF.EC_SEEDS) == [(101, False), (105, True)]


@pytest.mark.parametrize("seed", range(4))
def test_object_model_matches_the_reference(seed):
    """A seeded sequence of commits, ambiguous ops and checks through both
    packages' ``ObjectModel``: the same acceptable sets, dirty sets and
    verdicts."""
    from ceph_tpu.qa.rados_model import ObjectModel as RefModel
    from ceph_tpu_torch.qa.rados_model import ObjectModel

    def run(cls):
        rng = random.Random(seed)
        model, out = cls(), []
        oids = [f"m{i}" for i in range(6)]
        for _ in range(300):
            oid = rng.choice(oids)
            val = rng.choice([None, b"", bytes([rng.randrange(4)]) * 3])
            op = rng.choice(["committed", "ambiguous", "check"])
            if op == "check":
                out.append(model.check(oid, val))
            else:
                getattr(model, op)(oid, val)
            out.append((sorted(model.value(oid), key=repr),
                        sorted(model.dirty)))
        return out

    assert run(ObjectModel) == run(RefModel)


def _write_only_the_primary_applied(root, create=False, timeout=20.0):
    """An RS k=2 m=2 pool of one PG on 5 OSDs: "a" written whole, then
    rewritten while every replica drops the rewrite's sub-op (as a
    replica already in the next interval drops a stale one), the client
    giving up; then a replica is marked down (a new interval, re-peered
    without the drops).  Returns what reading "a" gives: its first or its
    second contents, or the error.  With ``create`` the dropped write is
    the one that makes "a" ("b" is written first instead)."""
    import asyncio
    import importlib
    cluster = importlib.import_module(root + ".qa.cluster")
    backend = importlib.import_module(root + ".osd.backend")
    real = backend.ECBackend._apply_ec_sub_write
    dropping = {"on": False}

    def apply(self, m):
        if dropping["on"] and m.log_entry().oid == "a":
            return                    # dropped, as a stale sub-op is
        return real(self, m)

    async def run():
        kw = {"device": "cpu"} if root == PORT else {}
        cl = cluster.Cluster(**kw)
        admin = await cl.start(5)
        await admin.pool_create("ec", pg_num=1, pool_type="erasure",
                                k=2, m=2)
        io = admin.open_ioctx("ec")
        first, second = b"1" * 3000, b"2" * 3000
        await io.write_full("b" if create else "a", first)
        dropping["on"] = True
        t = asyncio.get_running_loop().create_task(io.write_full("a",
                                                                 second))
        await asyncio.sleep(1.0)      # the primary applied it alone
        t.cancel()                    # the client gives up
        dropping["on"] = False
        m = admin.monc.osdmap
        pid = m.lookup_pool("ec")
        from_root = importlib.import_module(root + ".osd.types")
        pg = m.pools[pid].raw_pg_to_pg(
            m.object_locator_to_pg("a", from_root.ObjectLocator(pid)))
        acting = m.pg_to_up_acting_osds(pg)[2]
        await cl.mark_down_and_wait(admin, acting[1])
        try:
            got = await io.read("a", timeout=timeout)
        except Exception as e:        # noqa: BLE001 - the outcome
            got = (type(e).__name__, getattr(e, "retcode", None))
        if create:
            got = (got, await io.read("b", timeout=timeout) == first)
        await cl.stop()
        return {first: "first", second: "second"}.get(got, got)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(backend.ECBackend, "_apply_ec_sub_write", apply)
        return asyncio.run(run())


def test_an_ec_write_no_replica_took_rolls_back():
    """The port takes as authority only a version k copies reached (an
    EC write acks once every shard committed): the primary's lone entry
    rolls back and "a" reads as its first contents."""
    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        assert _write_only_the_primary_applied(PORT) == "first"


def test_the_jax_package_keeps_an_ec_write_only_the_primary_took():
    """The JAX package peers from the longest log, the primary's: the
    rewrite stays authoritative with one shard of two needed, and "a"
    cannot be read."""
    import test_torch_osd
    with pytest.MonkeyPatch.context() as mp:
        test_torch_osd.install_ref_backoff(mp)
        got = _write_only_the_primary_applied(REF)
    assert got not in ("first", "second"), got


def test_an_ec_create_no_replica_took_rolls_back_to_absent():
    """The same with a write that creates "a": the rollback removes the
    primary's lone copy, the PG peers, and "a" reads as absent.  Fails on
    a rollback that keeps "a" missing: no peer holds it, the primary's
    pull fails on every peering retry and the read times out."""
    import errno
    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        got = _write_only_the_primary_applied(PORT, create=True,
                                              timeout=10.0)
    assert got == (("ObjectOperationError", -errno.ENOENT), True)


def test_the_jax_package_cannot_read_an_ec_create_only_the_primary_took():
    import test_torch_osd
    with pytest.MonkeyPatch.context() as mp:
        test_torch_osd.install_ref_backoff(mp)
        got = _write_only_the_primary_applied(REF, create=True, timeout=5.0)
    assert got[0][0] != "ObjectOperationError" or got[0][1] != -2, got


def test_an_acked_ec_write_survives_its_shards_going_down():
    """An RS k=2 m=2 pool of one PG on 5 OSDs: "a" written and acked on
    all four shards, then the three shards besides the primary's are
    stopped, marked down and out (not lost), so that the fifth OSD joins
    the acting set with a complete copy that is older.  Fewer than k
    shards of the interval that took the write answer, so a rollback is
    unproven and peering takes the longest log: the primary keeps the
    write's entry, and once the three return "a" reads as written."""
    import asyncio

    from ceph_tpu_torch.osd.types import ObjectLocator
    from ceph_tpu_torch.qa.cluster import Cluster

    async def run():
        cl = Cluster(device="cpu")
        admin = await cl.start(5)
        await admin.pool_create("ec", pg_num=1, pool_type="erasure",
                                k=2, m=2)
        io = admin.open_ioctx("ec")
        data = bytes(range(256)) * 12
        await io.write_full("a", data)
        m = admin.monc.osdmap
        pid = m.lookup_pool("ec")
        pg = m.pools[pid].raw_pg_to_pg(
            m.object_locator_to_pg("a", ObjectLocator(pid)))
        acting = m.pg_to_up_acting_osds(pg)[2]
        primary, others = cl.osds[acting[0]], acting[1:]

        def primary_lu():
            return [p.info.last_update for p in primary.pgs.values()
                    if p.pool_id == pid]

        acked = primary_lu()
        stores = {}
        for o in others:
            stores[o] = await cl.kill_osd(o)
            await cl.mark_down_and_wait(admin, o)
            await admin.mon_command({"prefix": "osd out", "id": o})
        await asyncio.sleep(4.0)      # the new interval peers
        kept = primary_lu()
        for o in others:
            await cl.start_osd(o, store=stores[o])
            await admin.mon_command({"prefix": "osd in", "id": o})
        try:
            got = await io.read("a", timeout=30.0)
        except Exception as e:        # noqa: BLE001 - the outcome
            got = type(e).__name__
        await cl.stop()
        return acked, kept, got == data or got

    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        acked, kept, read = asyncio.run(run())
    assert kept == acked and read is True


def test_a_repeated_interval_walk_reads_no_map_again():
    """A PG's interval walk from last_epoch_started, repeated on every
    peering retry under thrashing, reads each epoch's map once: the
    second walk gets no map and primes nothing, and finds the same
    intervals."""
    import asyncio

    from ceph_tpu_torch.qa.cluster import Cluster

    async def run():
        cl = Cluster(device="cpu")
        admin = await cl.start(4)
        await admin.pool_create("p", pg_num=4, size=3)
        for o in (1, 2):          # a few intervals to walk
            await cl.mark_down_and_wait(admin, o)
            await admin.mon_command({"prefix": "osd out", "id": o})
            await admin.mon_command({"prefix": "osd in", "id": o})
        await asyncio.sleep(1.0)
        osd = cl.osds[0]
        pg = next(iter(osd.pgs.values()))
        pg.generate_past_intervals(replace=True)
        first = [(iv.first, iv.last, iv.acting) for iv in pg.past_intervals]
        reads = []
        real = osd.get_map
        osd.get_map = lambda e: reads.append(e) or real(e)
        pg.generate_past_intervals(replace=True)
        osd.get_map = real
        again = [(iv.first, iv.last, iv.acting) for iv in pg.past_intervals]
        await cl.stop()
        return first, again, reads

    first, again, reads = asyncio.run(run())
    assert again == first and reads == []


def test_an_interval_walk_folds_a_pg_made_by_a_split():
    """A PG made by a pg_num increase walks back past the split through
    its parent's placement: ``OSD.interval_row`` answers every epoch as
    that epoch's map does (``pg_to_up_acting_osds`` folds the PG by the
    map's pg_num), for the PGs the split made as for the others."""
    import asyncio

    from ceph_tpu_torch.qa.cluster import Cluster

    async def run():
        cl = Cluster(device="cpu")
        admin = await cl.start(4)
        await admin.pool_create("p", pg_num=2, size=3)
        await cl.mark_down_and_wait(admin, 1)
        await admin.mon_command({"prefix": "osd pool set", "pool": "p",
                                 "var": "pg_num", "val": "4"})
        await admin.mon_command({"prefix": "osd out", "id": 2})
        await admin.mon_command({"prefix": "osd in", "id": 2})
        await asyncio.sleep(1.0)
        osd = cl.osds[0]
        cur = osd.osdmap
        pid = cur.lookup_pool("p")
        got, want = [], []
        for e in range(1, cur.epoch + 1):
            m = cur if e == cur.epoch else osd.get_map(e)
            for pg in cur.pg_ids(pid):
                got.append(osd.interval_row(pid, e, pg, cur))
                if m is None or pid not in m.pools:
                    want.append(None)
                    continue
                up, _, acting, primary = m.pg_to_up_acting_osds(pg)
                want.append((up, acting, primary, m.pools[pid].min_size,
                             [i.up_thru for i in m.osd_info]))
        split = [e for e in range(1, cur.epoch + 1)
                 if osd.get_map(e) is not None
                 and pid in osd.get_map(e).pools
                 and osd.get_map(e).pools[pid].pg_num == 2]
        await cl.stop()
        return got, want, split, len(cur.pg_ids(pid))

    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        got, want, split, n = asyncio.run(run())
    assert n == 4 and split, (n, split)
    assert got == want


def _shards_moved_off_their_holders(root, snap=False, timeout=12.0):
    """An RS k=2 m=2 pool of one PG on 8 OSDs: "a" written on its acting
    set, then three of its four OSDs (the primary among them) marked out
    while they stay up.  CRUSH's indep rule moves only those positions,
    so one shard of "a" is left in place and the three others are held
    by strays; the new primary has nothing.  Returns what a read of "a"
    gave (the data, or the error's name), with the acting set before and
    the up set after.  With ``snap`` "a" is first written, snapshotted
    and overwritten (each shard clones its chunk), and the read is of
    the snapshot: the first contents, or the error's name."""
    import asyncio
    import importlib

    cluster = importlib.import_module(root + ".qa.cluster")
    types_ = importlib.import_module(root + ".osd.types")

    def ctx(name):
        # no false down marks under a loaded host: an OSD marked down
        # boots again and is marked in, undoing the outs
        c = cluster.make_ctx(name)
        c.config.set("osd_heartbeat_grace", 30.0)
        return c

    async def run():
        cl = cluster.Cluster(ctx_factory=ctx)
        admin = await cl.start(8)
        await admin.pool_create("ec", pg_num=1, pool_type="erasure",
                                k=2, m=2)
        io = admin.open_ioctx("ec")
        data = bytes(range(256)) * 12
        await io.write_full("a", data)
        if snap:
            sid = await io.selfmanaged_snap_create()
            io.set_write_snapc(sid, [sid])
            await io.write_full("a", b"2" * 5000)
            io.set_snap_read(sid)
        m = admin.monc.osdmap
        pid = m.lookup_pool("ec")
        pg = m.pools[pid].raw_pg_to_pg(
            m.object_locator_to_pg("a", types_.ObjectLocator(pid)))
        acting = m.pg_to_up_acting_osds(pg)[2]
        moved = [acting[0], acting[2], acting[3]]
        await asyncio.gather(*[admin.mon_command(
            {"prefix": "osd out", "id": o}) for o in moved])
        for _ in range(600):          # the client's map has all three out
            if not set(admin.monc.osdmap.pg_to_up_acting_osds(pg)[0]) \
                    & set(moved):
                break
            await asyncio.sleep(0.05)
        if snap:
            # the snapshot is read once backfill is done: no pg_temp
            # keeps the strays in the acting set any more
            for _ in range(200):
                up, _, acting_now, _ = \
                    admin.monc.osdmap.pg_to_up_acting_osds(pg)
                if acting_now == up and not set(up) & set(moved):
                    break
                await asyncio.sleep(0.1)
            await asyncio.sleep(1.0)
        try:
            got = await io.read("a", timeout=timeout)
        except Exception as e:        # noqa: BLE001 - the outcome
            got = type(e).__name__
        after = admin.monc.osdmap.pg_to_up_acting_osds(pg)[0]
        await cl.stop()
        return acting, after, got == data or got

    return asyncio.run(run())


def test_a_shard_held_only_by_a_stray_feeds_the_rebuild():
    """The new primary rebuilds its shard of "a" from the one shard left
    in place and a stray's (the sources that peering probed), and the
    read returns the data.  Fails on a gather that asks the acting set
    alone: one shard of the two needed, peering retries for good and
    the read times out."""
    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        before, after, read = _shards_moved_off_their_holders(PORT)
    assert after[1] == before[1] and not set(after) & {
        before[0], before[2], before[3]}
    assert read is True


def test_a_snapshot_held_only_by_strays_reads_back():
    """The same after a snapshot and an overwrite, read once backfill is
    done: the new primary, rebuilding the head from the strays, takes the
    object's SnapSet row from the acting set before it rebuilds the
    clones, and a read at the snapshot returns the first contents.  Fails
    when the primary rebuilds clones from its own row alone: it has none,
    so it rebuilds none, and the snapshot read fails."""
    with pytest.MonkeyPatch.context() as mp:
        cpu_defaults(mp)
        before, after, read = _shards_moved_off_their_holders(PORT,
                                                               snap=True)
    assert after[1] == before[1]
    assert read is True


def test_the_jax_package_asks_the_acting_set_alone():
    import test_torch_osd
    with pytest.MonkeyPatch.context() as mp:
        test_torch_osd.install_ref_backoff(mp)
        before, after, read = _shards_moved_off_their_holders(REF,
                                                               timeout=5.0)
    assert after[1] == before[1]
    assert read is not True
