"""The port's OSD wire types and its device seam.

- bytes: the corpus bins of the 27 ``osd.messages`` types and of
  ``pglog``, ``snaps`` and ``hitset`` decode in the port and re-encode to
  the same bytes, both ways; every message type has the reference's code
  in the port's own registry;
- the ``ref_backoff`` fixture is scoped to one test: after it, the
  reference's ``backoff`` import fails again as it does on Python 3.12;
- the device seam: the CRUSH engine follows the OSD's and the client's
  device (the device descent on a card, the host engine on the CPU); the
  default device raises without a card; mesh mode is refused at
  ``start()``; a class call (a read-class and a write-class method, an
  unknown one) gets the reply a reference OSD gives; the EC batch queues'
  launch counts add up under two shard threads;
- the port's repairs of the reference under thread lanes: BlockStore
  entries serialized, one map fetch per missing epoch shared by every
  PG, each epoch's map a copy of its own (kept, primed, for the
  interval walks), up_thru asked for once per
  interval and granted once (no up_thru storm after a down-mark),
  scheduled scrubs on clean PGs only, and a peering query sent from an
  epoch the OSD has not applied waiting for that map (C2: else another
  EC shard's copy of the PG answers it), and peering waiting on an up
  peer that answers late (the JAX package fails the round);
- the lazy imports that waited for this slice now land in the port.

Tolerance 0: bytes and counts are compared exactly.
"""

import asyncio
import errno
import importlib
import inspect
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_osd import install_ref_backoff

CORPUS = pathlib.Path(__file__).parent / "corpus"
BINS = sorted(p.name[len("ceph_tpu."):-len(".bin")]
              for p in CORPUS.glob("ceph_tpu.osd.*.bin")
              if p.name.split(".")[2] in ("messages", "pglog", "snaps",
                                          "hitset"))


def test_the_corpus_holds_the_osd_bins():
    assert len([b for b in BINS if b.startswith("osd.messages.")]) == 27
    assert {b.rsplit(".", 1)[0] for b in BINS} == {
        "osd.messages", "osd.pglog", "osd.snaps", "osd.hitset"}


@pytest.mark.parametrize("dotted", BINS)
def test_corpus_bins_reencode_byte_identically(dotted):
    blob = (CORPUS / f"ceph_tpu.{dotted}.bin").read_bytes()
    mod, _, name = dotted.rpartition(".")
    port_cls = getattr(importlib.import_module(f"ceph_tpu_torch.{mod}"),
                       name)
    ref_cls = getattr(importlib.import_module(f"ceph_tpu.{mod}"), name)
    assert getattr(port_cls, "TYPE", None) == getattr(ref_cls, "TYPE", None)
    assert port_cls.from_bytes(blob).to_bytes() == blob
    assert port_cls.from_bytes(ref_cls.from_bytes(blob).to_bytes()) \
        .to_bytes() == blob
    assert ref_cls.from_bytes(port_cls.from_bytes(blob).to_bytes()) \
        .to_bytes() == blob


def test_message_codes_are_registered_per_package():
    from ceph_tpu.osd import messages as ref
    from ceph_tpu_torch.msg.message import Message, message_class
    from ceph_tpu_torch.osd import messages as port
    types = {n: c for n, c in vars(port).items()
             if isinstance(c, type) and issubclass(c, Message)
             and c is not Message and c.__module__ == port.__name__}
    assert len(types) >= 24
    for name, cls in types.items():
        assert cls.TYPE == getattr(ref, name).TYPE, name
        assert message_class(cls.TYPE) is cls, name


# ----------------------------------------------------------------- backoff

def test_ref_backoff_is_installed_for_one_test_only():
    import ceph_tpu.common
    with pytest.MonkeyPatch.context() as mp:
        mod = install_ref_backoff(mp)
        from ceph_tpu.common.backoff import Backoff, BackoffGiveUp
        assert Backoff is mod.Backoff
        assert issubclass(BackoffGiveUp, TimeoutError)
        assert ceph_tpu.common.backoff is mod
    assert "ceph_tpu.common.backoff" not in sys.modules
    assert not hasattr(ceph_tpu.common, "backoff")
    with pytest.raises(TypeError, match="duplicate base class"):
        importlib.import_module("ceph_tpu.common.backoff")
    assert "ceph_tpu.common.backoff" not in sys.modules


# ------------------------------------------------------------- device seam

def _osd(device="cpu", cfg=None):
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.mon.monmap import MonMap
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.msg.types import EntityName
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.store.memstore import MemStore
    ctx = Context("osd.0")
    for k, v in (cfg or {}).items():
        ctx.config.set(k, v)
    store = MemStore()
    store.mkfs()
    return OSD(ctx, 0, store, Messenger(ctx, EntityName("osd", "0")),
               MonMap(), device=device)


def _no_card_check(monkeypatch):
    """Let ``device="cuda"`` construct without a card (nothing here
    launches): the modules' ``resolve_device`` becomes ``torch.device``."""
    for mod in ("ceph_tpu_torch.osd.daemon", "ceph_tpu_torch.osd.ec_queue",
                "ceph_tpu_torch.client.objecter"):
        monkeypatch.setattr(importlib.import_module(mod), "resolve_device",
                            torch.device)


def _port_map():
    from test_torch_osdmap import ref_map, to_port
    return to_port(ref_map())


@pytest.mark.parametrize("device,engine", [("cpu", "host"),
                                           ("cuda", "device")])
def test_crush_engine_follows_the_device(monkeypatch, device, engine):
    from ceph_tpu_torch.client.objecter import Objecter
    from ceph_tpu_torch.common.device import placement_engine
    from ceph_tpu_torch.osd.osdmap import OSDMap
    _no_card_check(monkeypatch)
    assert placement_engine(torch.device(device)) == engine
    osd = _osd(device)
    assert (osd.crush_engine, osd.device.type) == (engine, device)
    assert all(q.device.type == device for q in osd.ec_queues().values())
    obj = Objecter(osd.ctx, osd.messenger, osd.monc, device=device)
    assert (obj.crush_engine, obj.device.type) == (engine, device)
    seen, real = [], OSDMap.prime_pgs

    def spy(self, pgs, engine="device", device="cuda"):
        seen.append((engine, str(device)))
        return real(self, pgs, "host", "cpu")

    monkeypatch.setattr(OSDMap, "prime_pgs", spy)
    osd.osdmap = _port_map()
    pool = sorted(osd.osdmap.pools)[0]
    placed = osd.place_objects(pool, [f"obj{i}" for i in range(40)])
    assert len(placed) == 40
    # one priming per window, on the OSD's engine and device
    assert seen == [(engine, device)]
    assert osd.crush_batches["backfill"] == 1


def test_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device builds")
    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.qa.cluster import Cluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _osd(device="cuda")
    from ceph_tpu_torch.osd.daemon import OSD
    assert inspect.signature(OSD).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Rados()


@pytest.mark.parametrize("cfg,names", [
    ({"osd_mesh_mode": "on"}, "A8"),
])
def test_unported_modes_are_refused_at_start(cfg, names, monkeypatch):
    """No mode is refused at start() any more: mesh mode (ROADMAP A8,
    once refused here) is ported, and start() enables the process-wide
    mesh executor and registers the OSD on it, as the JAX package's
    does, before it authenticates (stopped there: no mon)."""
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.parallel import mesh_exec

    async def no_mon(self):
        raise RuntimeError(f"authenticate ({names} ported)")

    monkeypatch.setattr(OSD, "_authenticate", no_mon)
    mesh_exec.disable()
    ex = mesh_exec.enable(devices=["cpu"] * 4)
    try:
        osd = _osd(cfg=cfg)
        with pytest.raises(RuntimeError, match="authenticate"):
            asyncio.run(osd.start())
        assert osd.mesh_exec is ex and ex.covers(osd.whoami)
        assert osd.shards.process_lanes is None
    finally:
        mesh_exec.disable()


def _cluster_ctx(shards, lanes="thread", mode="force"):
    from ceph_tpu_torch.qa.cluster import make_ctx

    def make(name):
        ctx = make_ctx(name)
        ctx.config.set("osd_op_num_shards", shards)
        ctx.config.set("osd_shard_lanes", lanes)
        ctx.config.set("osd_ec_batch_device", mode)
        return ctx
    return make


def test_a_class_call_gets_an_error_reply(monkeypatch):
    """OP_CALL reaches a port OSD and comes back as from a reference OSD:
    a read-class call, a write-class call and an unknown method (the one
    that gets an error reply, -EOPNOTSUPP) answer with the same result,
    rvals and outdata in both packages, and the object reads back the
    same."""
    def run(root):
        m = importlib.import_module
        msgs = m(root + ".osd.messages")
        ObjectLocator = m(root + ".osd.types").ObjectLocator
        lock = b'{"name": "l", "type": "exclusive", "entity": "a"}'
        vectors = ([msgs.OSDOp(msgs.OP_CALL, name="lock.get_info",
                               data=b'{"name": "l"}')],
                   [msgs.OSDOp(msgs.OP_CALL, name="lock.lock", data=lock)],
                   [msgs.OSDOp(msgs.OP_CALL, name="lock.lock", data=lock)],
                   [msgs.OSDOp(msgs.OP_CALL, name="nope.method")])

        async def go():
            kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
            cl = m(root + ".qa.cluster").Cluster(**kw)
            admin = await cl.start(3)
            await admin.pool_create("p", pg_num=4)
            io = admin.open_ioctx("p")
            await io.write_full("o", b"data")
            seen = []
            for ops in vectors:
                reply = await admin.objecter.op_submit(
                    "o", ObjectLocator(io.pool_id), ops)
                seen.append((reply.result, [(o.rval, o.outdata)
                                            for o in reply.ops]))
            seen.append(await io.read("o"))
            await cl.stop()
            return seen

        return asyncio.run(go())

    with pytest.MonkeyPatch.context() as mp:
        install_ref_backoff(mp)
        want = run("ceph_tpu")
    got = run("ceph_tpu_torch")
    assert got == want
    assert [r[0] for r in got[:4]] == [0, 0, -errno.EEXIST, -errno.EOPNOTSUPP]
    assert got[4] == b"data"


def test_launch_counts_add_up_under_two_shard_threads(monkeypatch):
    """Two thread lanes per OSD, each with its own EC batch queue and
    executor thread, on the CPU (queue "force": the plain apply stands in
    for the kernel): every device_call is counted once, by its queue,
    and the queues of an OSD add up to its perf counter."""
    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.qa.cluster import Cluster
    calls, real = [], kernel.MatrixApply.device_call

    def spy(self, chunks, out=None):
        calls.append(threading.get_ident())
        return real(self, chunks, out)

    monkeypatch.setattr(kernel.MatrixApply, "device_call", spy)
    before = kernel.gf_apply_launches

    async def run():
        cl = Cluster(ctx_factory=_cluster_ctx(2), device="cpu")
        admin = await cl.start(4)
        await admin.pool_create("ec", pg_num=8, pool_type="erasure",
                                k=2, m=2)
        io = admin.open_ioctx("ec")
        rng = np.random.default_rng(7)
        blobs = {f"o{i}": rng.integers(0, 256, 96 << 10,
                                       dtype=np.uint8).tobytes()
                 for i in range(24)}
        await cl.write_burst(io, blobs, iodepth=24)
        got = [await io.read(n) == b for n, b in blobs.items()]
        per_osd = {i: ({n: q.launches for n, q in o.ec_queues().items()},
                       o.ctx.perf.dump()["ec_batch_queue"]
                       ["device_launches"])
                   for i, o in cl.osds.items()}
        threads = {i: o.shards.threaded for i, o in cl.osds.items()}
        await cl.stop()
        return got, per_osd, threads

    got, per_osd, threads = asyncio.run(run())
    assert all(got) and all(threads.values())
    for queues, perf in per_osd.values():
        assert sum(queues.values()) == perf
        assert queues["daemon"] == 0       # thread lanes: per-shard queues
    total = sum(perf for _, perf in per_osd.values())
    assert total == len(calls) > 0
    used = [n for queues, _ in per_osd.values()
            for n, c in queues.items() if c]
    assert len(used) >= 2 and len(set(calls)) >= 2
    # the CPU runs the plain version: the kernel's count does not move
    assert kernel.gf_apply_launches == before


# --------------------------------------- repairs of the reference's faults

def test_blockstore_reads_never_see_a_write_half_applied(tmp_path):
    """One thread rewrites an object while another reads it, as an OSD's
    shard thread writes a PG's meta while its intake loop reads it: every
    read returns one whole version.  (The JAX package's BlockStore mutates
    its cached onode in place while a batch applies, so such a reader
    can see new extents before their data, or a torn size.)"""
    from ceph_tpu_torch.store import CollectionId, ObjectId, Transaction
    from ceph_tpu_torch.store.blockstore import BlockStore
    s = BlockStore(str(tmp_path / "bs"), csum_type="crc32c")
    s.mkfs()
    s.mount()
    c, o = CollectionId.pg(1, 0), ObjectId("x", pool=1)
    versions = [bytes([i]) * (4096 * (1 + i % 4) + 100 * i)
                for i in range(8)]

    def put(v):
        return Transaction().write(c, o, 0, v).truncate(c, o, len(v))

    s.apply_transaction(Transaction().create_collection(c))
    s.apply_transaction(put(versions[0]))
    done, seen = threading.Event(), []

    def reader():
        while not done.is_set():
            try:
                got = s.read(c, o)
                seen.append(None if got in versions else "torn")
            except Exception as e:          # noqa: BLE001
                seen.append(repr(e))

    t = threading.Thread(target=reader)
    t.start()
    for n in range(400):
        s.queue_transactions([put(versions[n % 8])])
    done.set()
    t.join(60)
    s.umount()
    assert seen and [x for x in seen if x is not None] == []


def test_one_map_fetch_per_missing_epoch(tmp_path):
    """Twenty PGs that miss the same five epochs share five fetches from
    the mon; every map lands in the store."""
    from ceph_tpu_torch.store.types import CollectionId, ObjectId
    osd = _osd()
    osd.store.mount()
    asked = []

    class Ack:
        def __init__(self, e):
            self.outbl = f"map{e}".encode()

    async def command(cmd, timeout=30.0):
        asked.append(cmd["epoch"])
        await asyncio.sleep(0.01)
        return Ack(cmd["epoch"])

    osd.monc.command = command

    async def run():
        await asyncio.gather(*[osd.ensure_map_history(1, 6)
                               for _ in range(20)])

    asyncio.run(run())
    assert sorted(asked) == [1, 2, 3, 4, 5]
    cid = CollectionId.meta()
    assert [osd.store.read(cid, ObjectId(f"osdmap.{e}"))
            for e in range(1, 6)] == [f"map{e}".encode()
                                       for e in range(1, 6)]
    assert osd._map_fetches == {}


def test_each_epoch_advances_on_a_map_of_its_own(monkeypatch):
    """With the sharded data plane, every PG's advance_map gets a map
    that stays at the epoch it was handed at (the MonClient goes on
    applying incrementals to its own map in place)."""
    from ceph_tpu_torch.osd.pg import PG
    from ceph_tpu_torch.qa.cluster import Cluster
    seen, real = [], PG.advance_map

    def spy(self, osdmap):
        seen.append((osdmap, osdmap.epoch))
        return real(self, osdmap)

    monkeypatch.setattr(PG, "advance_map", spy)

    async def run():
        cl = Cluster(ctx_factory=_cluster_ctx(2), device="cpu")
        admin = await cl.start(4)
        await admin.pool_create("r", pg_num=8)
        io = admin.open_ioctx("r")
        await io.write_full("x", b"1")
        await cl.kill_osd(3)
        await cl.mark_down_and_wait(admin, 3)
        await io.write_full("y", b"2")
        monc_maps = {id(o.monc.osdmap) for o in cl.osds.values()}
        await cl.stop()
        return monc_maps

    monc_maps = asyncio.run(run())
    assert len({e for _, e in seen}) > 3
    assert all(m.epoch == e for m, e in seen)
    assert not monc_maps & {id(m) for m, _ in seen}


def test_interval_walks_read_the_maps_the_advance_primed(monkeypatch):
    """With the sharded data plane, every epoch's map that an OSD advanced
    its PGs on is the one ``get_map`` gives the interval walks of PGs made
    later (after an OSD goes out), and no scalar lookup primes any of
    them again on the host engine."""
    import sys as _sys

    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.qa.cluster import Cluster
    applied, reprimed = {}, set()
    real_apply, real_prime = OSD._apply_map, OSDMap._prime_batch

    def apply_spy(self, osdmap):
        applied.setdefault(self.whoami, {})[osdmap.epoch] = osdmap
        return real_apply(self, osdmap)

    def prime_spy(self, *args, **kw):
        if _sys._getframe(1).f_code.co_name == "pg_to_up_acting_osds":
            reprimed.add(id(self))
        return real_prime(self, *args, **kw)

    monkeypatch.setattr(OSD, "_apply_map", apply_spy)
    monkeypatch.setattr(OSDMap, "_prime_batch", prime_spy)

    async def run():
        cl = Cluster(ctx_factory=_cluster_ctx(2, lanes="inline"),
                     device="cpu")
        admin = await cl.start(4)
        await admin.pool_create("r", pg_num=16)
        io = admin.open_ioctx("r")
        await asyncio.gather(*[io.write_full(f"o{i}", b"%d" % i)
                               for i in range(16)])
        await cl.kill_osd(3)
        await cl.mark_down_and_wait(admin, 3)
        await admin.mon_command({"prefix": "osd out", "id": 3})
        await cl.wait_epoch(admin, admin.monc.osdmap.epoch + 1)
        for _ in range(100):
            if all(o.osdmap.epoch == admin.monc.osdmap.epoch
                   for o in cl.osds.values()):
                break
            await asyncio.sleep(0.05)
        kept = {i: {e: o.get_map(e) for e in applied[i]}
                for i, o in cl.osds.items()}
        await cl.stop()
        return kept

    kept = asyncio.run(run())
    walked = [m for i, maps in kept.items() for m in maps.values()]
    assert len(walked) > 3 * 5
    assert all(kept[i][e] is applied[i][e]
               for i in kept for e in kept[i])
    assert not reprimed & {id(m) for m in walked}


def test_an_up_thru_request_asks_for_the_interval_start():
    """The OSD asks the mon for an up_thru of at least the waiting PG's
    interval start: once per want (the map's epoch moving on sends
    nothing new), again only for a higher want or after the 2 s re-send
    timer, and never for a want its map's up_thru covers."""
    from ceph_tpu_torch.mon.messages import MOSDAlive
    from ceph_tpu_torch.mon.monmap import MonMap
    from ceph_tpu_torch.msg.types import EntityAddr
    osd = _osd()
    osd.osdmap = _port_map()
    osd.monc.monmap = MonMap()
    osd.monc.monmap.add("a", EntityAddr("127.0.0.1", 6789, 1))
    sent = []
    osd.messenger.send_message = lambda m, addr, peer_type=None: \
        sent.append(m.want_epoch) if isinstance(m, MOSDAlive) else None
    covered = osd.osdmap.get_up_thru(0)
    osd.request_up_thru(covered)
    assert sent == []
    want = covered + 1
    for _ in range(5):
        osd.request_up_thru(want)
        osd.osdmap.epoch += 1       # other OSDs' grants move the map on
    assert sent == [want]
    osd.request_up_thru(want + 3)
    assert sent == [want, want + 3]
    osd._alive_sent_at -= 2.5       # the re-send timer
    osd.request_up_thru(want)
    assert sent == [want, want + 3, want + 3]


def test_the_mon_drops_an_up_thru_request_already_granted():
    """A port mon grants an up_thru want once: a second MOSDAlive that
    the committed (or pending) up_thru covers proposes no epoch."""
    from ceph_tpu_torch.mon.messages import MOSDAlive
    from ceph_tpu_torch.qa.cluster import Cluster

    async def run():
        cl = Cluster(device="cpu")
        admin = await cl.start(2)
        osdmon = cl.mons[0].osdmon
        await asyncio.sleep(0.5)
        epochs = [admin.monc.osdmap.epoch]
        want = epochs[0]
        osdmon.prepare_alive(MOSDAlive(0, want))
        await cl.wait_epoch(admin, want + 1)
        granted = admin.monc.osdmap.get_up_thru(0)
        for w in (want, want - 1, granted):
            osdmon.prepare_alive(MOSDAlive(0, w))
        await asyncio.sleep(0.5)
        epochs.append(admin.monc.osdmap.epoch)
        await cl.stop()
        return want, granted, epochs

    want, granted, epochs = asyncio.run(run())
    assert granted >= want
    assert epochs[1] == epochs[0] + 1


def test_a_down_mark_costs_the_osds_one_up_thru_grant_each(monkeypatch):
    """Thread lanes, two shards each, 16 OSDs and an RS k=8 m=4 pool: two
    OSDs stop and are marked down; every PG peers again with at most one
    up_thru grant per OSD, and the objects that lost a shard read back.
    (The JAX package's OSDs ask for up_thru at every epoch they see while
    their map lags the grant, and its mon grants every ask: each grant is
    an epoch and each epoch more asks; the degraded reads starve.)"""
    from ceph_tpu_torch.mon import osd_monitor
    from ceph_tpu_torch.qa.cluster import Cluster
    grants = []
    real = osd_monitor.OSDMonitor.propose_pending

    def spy(self, done=None):
        if self.pending_inc.new_up_thru:
            grants.append((self.pending_inc.epoch,
                           dict(self.pending_inc.new_up_thru)))
        return real(self, done)

    monkeypatch.setattr(osd_monitor.OSDMonitor, "propose_pending", spy)
    make = _cluster_ctx(2)

    def ctx(name):
        c = make(name)
        c.config.set("osd_heartbeat_grace", 20.0)
        c.config.set("mon_osd_down_out_interval", 3600.0)
        c.config.set("lockdep", False)
        return c

    rng = np.random.default_rng(23)
    objs = {f"o{i}": rng.integers(0, 256, 1 << 14, dtype=np.uint8).tobytes()
            for i in range(32)}

    async def run():
        cl = Cluster(ctx_factory=ctx, device="cpu")
        admin = await cl.start(16)
        await admin.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "rs",
            "profile": {"plugin": "rs", "k": "8", "m": "4"}})
        await admin.pool_create("ec", pg_num=16, pool_type="erasure",
                                erasure_code_profile="rs")
        io = admin.open_ioctx("ec")
        await asyncio.gather(*[io.write_full(n, d) for n, d in objs.items()])
        for o in (3, 7):
            await cl.kill_osd(o)
        await asyncio.gather(*[admin.mon_command(
            {"prefix": "osd down", "id": o}) for o in (3, 7)])
        while any(admin.monc.osdmap.is_up(o) for o in (3, 7)):
            await asyncio.sleep(0.05)
        down_epoch = admin.monc.osdmap.epoch
        got = await asyncio.gather(*[io.read(n) for n in objs])
        await cl.stop()
        return down_epoch, got

    down_epoch, got = asyncio.run(run())
    assert got == list(objs.values())
    after = [osds for e, osds in grants if e > down_epoch]
    assert len(after) <= 14, after
    assert all(len(g) == 1 for g in after)
    per_osd = [o for g in after for o in g]
    assert len(per_osd) == len(set(per_osd)), after


def test_scheduled_scrubs_take_clean_pgs_only():
    """The scrub scheduler queues a due scrub on a clean primary PG and
    none on one that still owes recovery (the JAX package's scheduler
    takes every active PG: its scrubs report the shards in flight as
    errors and push "repairs" racing the recovery)."""
    from ceph_tpu_torch.osd.types import PGId
    osd = _osd()

    class Info:
        last_scrub_stamp = last_deep_scrub_stamp = 1

    class FakePG:
        def __init__(self, clean):
            self.clean, self.info, self.queued = clean, Info(), []
            self._scrub_queued = False
            self.pgid = PGId(1, 0)

        def is_primary(self):
            return True

        def is_fully_clean(self):
            return self.clean

        def queue_op(self, m):
            self.queued.append(m.deep)

    for clean in (False, True):
        pg = osd.pgs[PGId(1, 0)] = FakePG(clean)
        osd._sched_scrub_pg(PGId(1, 0), 10_000, False, False, 100, 1e9)
        assert pg.queued == ([False] if clean else [])


def _notify_from_an_earlier_round(root):
    """A primary peering at e37 waits for osd.11's info on shard 3; the
    answer to its e36 query of osd.11's old shard 10 (complete, 27'1)
    comes first, then the e37 answer (shard 3, empty).  Returns the info
    the round took (last_update)."""
    from test_torch_osdmap import ref_map

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    ctx = mod("common.context").Context("osd.8")
    ctx.config.set("osd_op_num_shards", 1)
    store = mod("store.memstore").MemStore()
    store.mkfs()
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    osd = mod("osd.daemon").OSD(
        ctx, 8, store, mod("msg.messenger").Messenger(
            ctx, mod("msg.types").EntityName("osd", "8")),
        mod("mon.monmap").MonMap(), **kw)
    m1 = mod("osd.osdmap").OSDMap.from_bytes(
        ref_map(degraded=False).to_bytes())
    PGId = mod("osd.types").PGId
    PGInfo = mod("osd.pglog").PGInfo
    MPGNotify = mod("osd.messages").MPGNotify

    async def run():
        osd.osdmap = m1
        pg = mod("osd.pg").PG(osd, PGId(2, 24).with_shard(0), 2,
                              m1.pools[2])
        pg.interval_epoch = 37
        fut = asyncio.get_running_loop().create_future()
        pg._notify_waiters[11] = fut
        old = PGInfo(PGId(2, 24).with_shard(10))
        old.last_update = mod("osd.pglog").EVersion(27, 1)
        pg.on_notify(MPGNotify(PGId(2, 24).with_shard(10), 36, old, 11))
        pg.on_notify(MPGNotify(PGId(2, 24).with_shard(3), 37,
                               PGInfo(PGId(2, 24).with_shard(3)), 11))
        return str((await fut).last_update)

    return asyncio.run(run())


def test_a_notify_answers_only_the_round_that_asked():
    """C2, the cause seen in the recipe (two OSDs of 16 out, every PG
    deep-scrubbed as soon as it reports clean): after the out, CRUSH's
    indep retries moved osd.11 from shard 10 of a PG to shard 3.  The
    primary's e36 round asked osd.11 for shard 10; the map moved on, and
    the e37 round asked for shard 3, but took the e36 answer (complete)
    as osd.11's info: shard 3 was never filled, and a scrub of the PG
    just reported clean found the object missing there.  The port drops
    the earlier round's answer."""
    assert _notify_from_an_earlier_round("ceph_tpu_torch") == "0'0"


def test_the_jax_package_takes_a_notify_from_an_earlier_round(
        monkeypatch):
    """The fault as the JAX package has it."""
    install_ref_backoff(monkeypatch)
    assert _notify_from_an_earlier_round("ceph_tpu") == "27'1"


def _query_ahead_of_the_map(root):
    """An OSD on map e1 holds a complete copy of shard ``other`` of an EC
    PG; a primary on e2 queries it for shard ``j``, its position in the
    acting set, which the e2 advance makes.  Returns the infos the OSD
    sends back (last_update, backfill_complete) before e2 and after."""
    from test_torch_osdmap import ref_map

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    ctx = mod("common.context").Context("osd.0")
    ctx.config.set("osd_op_num_shards", 1)
    store = mod("store.memstore").MemStore()
    store.mkfs()
    store.mount()
    msgr = mod("msg.messenger").Messenger(
        ctx, mod("msg.types").EntityName("osd", "0"))
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    osd = mod("osd.daemon").OSD(ctx, 0, store, msgr,
                                mod("mon.monmap").MonMap(), **kw)
    OSDMap = mod("osd.osdmap").OSDMap
    PGId = mod("osd.types").PGId
    m1 = OSDMap.from_bytes(ref_map(degraded=False).to_bytes())
    pool = 2                                   # EC k=4 m=2
    ps = next(ps for ps in range(m1.pools[pool].pg_num)
              if 0 in m1.pg_to_acting_osds(PGId(pool, ps))[0])
    acting = list(m1.pg_to_acting_osds(PGId(pool, ps))[0])
    j = acting.index(0)
    other = (j + 1) % len(acting)
    sent = []
    osd.send_osd = lambda peer, msg: sent.append((peer, msg))

    def infos():
        return [(p, str(msg.pgid), str(msg.info().last_update),
                 msg.info().backfill_complete) for p, msg in sent
                if type(msg).__name__ == "MPGNotify"]

    async def run():
        osd.osdmap = m1
        old = mod("osd.pg").PG(osd, PGId(pool, ps).with_shard(other), pool,
                               m1.pools[pool])
        old.info.last_update = mod("osd.pglog").EVersion(1, 5)
        osd.pgs[old.pgid] = old
        osd.ms_dispatch(mod("osd.messages").MPGQuery(
            PGId(pool, ps).with_shard(j), m1.epoch + 1, 3))
        before = infos()
        m2 = OSDMap.from_bytes(m1.to_bytes())
        m2.apply_incremental(mod("osd.osdmap").Incremental(m1.epoch + 1))
        osd._apply_map(m2)
        await asyncio.sleep(0.05)
        for pg in list(osd.pgs.values()):
            pg.stop()
        return before, infos(), f"{pool}.{ps:x}s{j}"

    return asyncio.run(run())


def test_a_query_ahead_of_the_map_waits_for_its_shard():
    """C2: after an out, CRUSH's indep retries move a live OSD's EC shard
    to another position.  The new primary's peering query reached it
    before the map that makes the new shard's instance; the OSD's copy of
    the old shard answered, complete, and the primary pushed the new
    shard nothing: a scrub of the PG just reported clean found one object
    missing there.  The query now waits for its map, and the new, empty
    instance answers."""
    before, after, pgid = _query_ahead_of_the_map("ceph_tpu_torch")
    assert before == []
    assert after == [(3, pgid, "0'0", True)]


def test_the_jax_package_answers_a_query_from_another_shards_copy(
        monkeypatch):
    """The fault as the JAX package has it."""
    install_ref_backoff(monkeypatch)
    before, after, pgid = _query_ahead_of_the_map("ceph_tpu")
    assert before == [(3, pgid, "1'5", True)]



def _an_info_answered_late(root):
    """A size-3 pool of one PG on 3 OSDs, each replica answering the
    primary's first peering query 11.5 s late (past the JAX package's
    10 s).  Returns the ERROR records logged meanwhile, whether the PG
    went active, and what an object written then reads back as."""
    import logging

    cluster = importlib.import_module(root + ".qa.cluster")
    pgmod = importlib.import_module(root + ".osd.pg")
    real = pgmod.PG.on_query
    late = set()

    def on_query(self, m):
        if self.osd.whoami in late:
            return real(self, m)
        late.add(self.osd.whoami)
        asyncio.get_running_loop().call_later(11.5, real, self, m)

    errors = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda rec: errors.append(rec.getMessage())

    async def run():
        kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
        cl = cluster.Cluster(**kw)
        admin = await cl.start(3)
        for o in cl.osds.values():
            o.ctx.log.root.addHandler(handler)
        await admin.pool_create("p", pg_num=1, size=3)
        io = admin.open_ioctx("p")
        await asyncio.wait_for(io.write_full("a", b"late" * 100), 40.0)
        got = await io.read("a", timeout=10.0)
        active = [pg.state for o in cl.osds.values()
                  for pg in o.pgs.values() if pg.is_primary()]
        await cl.stop()
        return active, got

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgmod.PG, "on_query", on_query)
        active, got = asyncio.run(run())
    return errors, active, got


def test_peering_waits_for_an_up_peer_that_answers_late():
    """Under the card run's load a replica's answer to a peering query
    came more than 10 s late, and the primary failed the round with an
    ERROR record (``no info from UP osd``) and started another.  The
    port waits on, asking again every ``PEER_INFO_WAIT_S``, as Ceph's
    GetInfo waits: the late answers complete the round, nothing is
    logged at ERROR, and the PG serves the write."""
    errors, active, got = _an_info_answered_late("ceph_tpu_torch")
    assert errors == [] and active == ["active"] and got == b"late" * 100


def test_the_jax_package_fails_the_round_on_a_late_peer(monkeypatch):
    """The JAX package fails the round after 10 s (an ERROR record) and
    peers again; the second round's answers come at once."""
    install_ref_backoff(monkeypatch)
    errors, active, got = _an_info_answered_late("ceph_tpu")
    assert any("peering failed" in e for e in errors), errors
    assert active == ["active"] and got == b"late" * 100

# ------------------------------------------------------------ lazy imports

def test_the_lazy_imports_land_in_the_port(tmp_path):
    """osd/shards' extents and lane branches and the mon's MPGScrub
    resolve in the port."""
    from ceph_tpu_torch.osd import extents
    from ceph_tpu_torch.osd.messages import MPGScrub
    from ceph_tpu_torch.common.encoding import Decoder
    osd = _osd(cfg={"osd_op_num_shards": 2})
    osd.shards.process_lanes = []          # the process-lane branch
    counters = osd.shards.counters()
    assert counters["extents"] == extents.counters()
    assert Decoder.extent_factory is not None
    assert Decoder.extent_factory.__module__ == extents.__name__
    assert MPGScrub.__module__ == "ceph_tpu_torch.osd.messages"
    from ceph_tpu_torch.osd import shards
    src = inspect.getsource(shards.ShardedDataPlane)
    assert src.count("from ceph_tpu_torch.osd import lanes as lanes_mod") \
        == 2
    lanes = importlib.import_module("ceph_tpu_torch.osd.lanes")
    assert lanes.ShmRing.__module__ == "ceph_tpu_torch.osd.laneipc"
