"""The port's client and OSDs end to end, held against the JAX package.

- Done (A7): an RS k=2 m=2 pool on a port cluster (``device="cpu"``, the
  EC batch queue forced onto its device path, so the plain version of the
  matrix-apply kernel runs): every shard on the stores equals the
  reference codec's chunk of the same object; a degraded read returns the
  object and the recovery rebuilds the reference codec's chunks;
- across the packages over loopback TCP (``ms_local_delivery`` off, each
  package with its own message registry): the reference ``Rados`` against
  a port cluster, the port ``Rados`` against a reference cluster, and one
  cluster whose OSDs are half port, half reference, with EC sub-ops and
  recovery pushes crossing the packages while a port OSD and then a
  reference OSD are lost;
- chip_smoke's ``osd`` phase at a small size on the CPU.

The reference's cluster boots with the ``ref_backoff`` fixture (see
``test_torch_osd``).  Tolerance 0: bytes are compared exactly.
"""

import asyncio
import errno
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from test_torch_osd import ref_backoff  # noqa: F401  (fixture)


def _pkg(root):
    m = importlib.import_module
    return SimpleNamespace(
        root=root, Cluster=m(root + ".qa.cluster").Cluster,
        make_ctx=m(root + ".qa.cluster").make_ctx,
        Rados=m(root + ".client").Rados,
        ObjectOperationError=m(root + ".client").ObjectOperationError,
        OSD=m(root + ".osd").OSD, Monitor=m(root + ".mon").Monitor,
        MonMap=m(root + ".mon.monmap").MonMap,
        Messenger=m(root + ".msg.messenger").Messenger,
        EntityName=m(root + ".msg.types").EntityName,
        MemDB=m(root + ".store.kv").MemDB,
        MemStore=m(root + ".store.memstore").MemStore,
        CollectionId=m(root + ".store.types").CollectionId,
        ObjectId=m(root + ".store.types").ObjectId,
        ObjectLocator=m(root + ".osd.types").ObjectLocator,
        OSDOp=m(root + ".osd.messages").OSDOp,
        OP_CALL=m(root + ".osd.messages").OP_CALL)


REF, PORT = _pkg("ceph_tpu"), _pkg("ceph_tpu_torch")
K, M = 2, 2


def _run(coro, timeout=120.0):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


def _ctx(p, name, cfg=None):
    ctx = p.make_ctx(name)
    for k, v in (cfg or {}).items():
        ctx.config.set(k, v)
    return ctx


def _objects(seed, n=4, size=48 << 10):
    rng = np.random.default_rng(seed)
    return {f"obj{i}": rng.integers(0, 256, size + 512 * i,
                                    dtype=np.uint8).tobytes()
            for i in range(n)}


def _ref_chunks(data):
    """The reference codec's k + m chunks of ``data`` (RS, its host
    path)."""
    from ceph_tpu.ec.registry import factory
    codec = factory("rs", {"k": str(K), "m": str(M), "backend": "host"})
    ch = codec.encode(set(range(K + M)), data)
    return [bytes(np.asarray(ch[i], np.uint8)) for i in range(K + M)]


def _acting(admin, pool_id, name):
    m = admin.monc.osdmap
    pg = m.pools[pool_id].raw_pg_to_pg(
        m.object_locator_to_pg(name, _loc(admin, pool_id)))
    return pg, list(m.pg_to_acting_osds(pg)[0])


def _loc(admin, pool_id):
    mod = importlib.import_module(
        type(admin).__module__.split(".")[0] + ".osd.types")
    return mod.ObjectLocator(pool_id)


def _shard(osd, pool_id, pg, i, name):
    """Shard ``i`` of ``name`` as ``osd``'s store holds it, with the
    store's own id types (either package)."""
    root = type(osd).__module__.split(".")[0]
    t = importlib.import_module(root + ".store.types")
    return bytes(osd.store.read(t.CollectionId.pg(pool_id, pg.seed, i),
                                t.ObjectId(name, pool=pool_id)))


def _stored_shards(osds, admin, pool_id, blobs):
    """{name: [shard bytes by position]} read from the acting OSDs."""
    out = {}
    for name in blobs:
        pg, acting = _acting(admin, pool_id, name)
        out[name] = [_shard(osds[o], pool_id, pg, i, name)
                     for i, o in enumerate(acting)]
    return out


async def _clean(osds, admin, timeout=60.0):
    """Every PG of every pool active+clean on its live primary."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        m = admin.monc.osdmap
        want = sum(p.pg_num for p in m.pools.values())
        prim = ok = 0
        for o in osds.values():
            for pg in list(o.pgs.values()):
                if pg.is_primary():
                    prim += 1
                    ok += pg.is_fully_clean()
        if prim == ok == want:
            return
        assert loop.time() < deadline, f"{ok}/{want} PGs clean"
        await asyncio.sleep(0.1)


async def _lose(cl_osds, admin, o):
    """Stop an OSD, mark it down and out, wait for the map."""
    osd = cl_osds.pop(o)
    await osd.shutdown()
    await admin.mon_command({"prefix": "osd down", "id": o})
    await admin.mon_command({"prefix": "osd out", "id": o})
    while admin.monc.osdmap.is_up(o) or admin.monc.osdmap.is_in(o):
        await asyncio.sleep(0.05)


# ------------------------------------------------------------- Done (A7)

def test_done_a7_ec_pool_shards_equal_the_reference_codec():
    from ceph_tpu_torch.ec import kernel
    # past the queue's host threshold (64 KiB per request)
    blobs = _objects(91, size=160 << 10)
    want = {n: _ref_chunks(b) for n, b in blobs.items()}

    async def run():
        cl = PORT.Cluster(
            ctx_factory=lambda n: _ctx(PORT, n,
                                       {"osd_ec_batch_device": "force"}),
            device="cpu")
        admin = await cl.start(6)
        await admin.pool_create("ec", pg_num=4, pool_type="erasure",
                                k=K, m=M)
        io = admin.open_ioctx("ec")
        for n, b in blobs.items():
            await io.write_full(n, b)
        stored = _stored_shards(cl.osds, admin, io.pool_id, blobs)
        # lose the OSD holding the first data shard of obj0
        pg, acting = _acting(admin, io.pool_id, "obj0")
        lost = acting[0]
        await _lose(cl.osds, admin, lost)
        degraded = {n: await io.read(n) for n in blobs}
        await _clean(cl.osds, admin)
        rebuilt = _stored_shards(cl.osds, admin, io.pool_id, blobs)
        moved = sum(o != lost for o in _acting(admin, io.pool_id,
                                               "obj0")[1])
        launches = sum(q.launches for o in cl.osds.values()
                       for q in o.ec_queues().values())
        await cl.stop()
        return stored, degraded, rebuilt, moved, launches

    before = kernel.gf_apply_launches
    stored, degraded, rebuilt, moved, launches = _run(run())
    assert stored == want
    assert degraded == blobs
    assert rebuilt == want and moved == K + M
    # the queue's device path ran (the plain version, on the CPU)
    assert launches > 0 and kernel.gf_apply_launches == before


# ---------------------------------------------------- across the packages

async def _io_script(p, io, blobs):
    """Writes, reads, stat, listing and a removal; returns what the
    client saw."""
    for n, b in blobs.items():
        await io.write_full(n, b)
    got = [await io.read(n) == b for n, b in blobs.items()]
    got.append([await io.stat(n) for n in blobs])
    got.append(await io.read("obj1", length=100, offset=200))
    got.append(sorted(await io.list_objects()))
    await io.remove("obj0")
    try:
        await io.read("obj0")
        got.append("read after remove")
    except p.ObjectOperationError as e:
        got.append(e.retcode)
    return got


def _ec_and_rep(admin):
    return [admin.pool_create("ec", pg_num=4, pool_type="erasure",
                              k=K, m=M),
            admin.pool_create("rep", pg_num=4, size=3)]


@pytest.mark.parametrize("client,cluster", [("ref", "port"),
                                            ("port", "ref")])
def test_a_client_of_one_package_against_the_others_cluster(
        ref_backoff, client, cluster):
    cp = REF if client == "ref" else PORT
    sp = REF if cluster == "ref" else PORT
    blobs = _objects(92, n=3)

    async def run():
        kw = {"device": "cpu"} if sp is PORT else {}
        cl = sp.Cluster(**kw)
        admin = await cl.start(5)
        for c in _ec_and_rep(admin):
            await c
        ckw = {"device": "cpu"} if cp is PORT else {}
        r = cp.Rados(_ctx(cp, "client.other"),
                     cp.MonMap.from_bytes(cl.monmap.to_bytes()), **ckw)
        await r.connect()
        seen = {}
        for pool in ("ec", "rep"):
            seen[pool] = await _io_script(cp, r.open_ioctx(pool), blobs)
        # the cluster's own client reads what the other package wrote
        io = admin.open_ioctx("rep")
        seen["back"] = [await io.read(n) == b for n, b in blobs.items()
                        if n != "obj0"]
        # a class call from one package's client to the other's OSD
        ioc = r.open_ioctx("rep")
        reply = await r.objecter.op_submit(
            "obj1", cp.ObjectLocator(ioc.pool_id),
            [cp.OSDOp(cp.OP_CALL, name="lock.get_info",
                      data=b'{"name": "l1"}')])
        call = (reply.result, reply.ops[0].rval, reply.ops[0].outdata)
        await r.shutdown()
        await cl.stop()
        return seen, call

    seen, call = _run(run())
    for pool in ("ec", "rep"):
        s = seen[pool]
        assert s[:3] == [True] * 3
        assert s[3] == [len(b) for b in blobs.values()]
        assert s[4] == blobs["obj1"][200:300]
        assert s[5] == sorted(blobs)
        assert s[6] == -errno.ENOENT
    assert seen["back"] == [True, True]
    # the reply a reference OSD gives (cluster "ref"), a port OSD gives
    # too (cluster "port")
    assert call == (0, 0, b'{"type": "", "lockers": {}}')


def test_half_port_half_reference_osds_write_read_and_recover(ref_backoff):
    """A port mon and six OSDs, the even ones port and the odd ones
    reference, one RS k=2 m=2 pool: the primaries of either package encode
    and fan out sub-ops to both; every stored shard equals the reference
    codec's chunk.  A port OSD and then a reference OSD are lost; after
    each recovery every shard, wherever it was rebuilt, is again equal."""
    blobs = _objects(93, n=6)
    want = {n: _ref_chunks(b) for n, b in blobs.items()}

    async def run():
        monmap = PORT.MonMap()
        monmap.fsid = "mixed-osds"
        ctx = _ctx(PORT, "mon.a")
        msgr = PORT.Messenger(ctx, PORT.EntityName("mon", "a"))
        monmap.add("a", await msgr.bind())
        mon = PORT.Monitor(ctx, "a", monmap, PORT.MemDB(), msgr)
        await mon.start()
        blob = monmap.to_bytes()
        admin = PORT.Rados(_ctx(PORT, "client.admin"),
                           PORT.MonMap.from_bytes(blob), device="cpu")
        await admin.connect()
        await admin.mon_command({"prefix": "osd crush build-simple",
                                 "num_osds": 6, "osds_per_host": 1})
        osds = {}
        for i in range(6):
            p = PORT if i % 2 == 0 else REF
            c = _ctx(p, f"osd.{i}")
            store = p.MemStore()
            store.mkfs()
            kw = {"device": "cpu"} if p is PORT else {}
            osds[i] = p.OSD(c, i, store,
                            p.Messenger(c, p.EntityName("osd", str(i))),
                            p.MonMap.from_bytes(blob), **kw)
            await osds[i].start()
        for o in osds.values():
            await o.wait_for_boot()
        await admin.pool_create("ec", pg_num=8, pool_type="erasure",
                                k=K, m=M)
        await _clean(osds, admin)
        io = admin.open_ioctx("ec")
        for n, b in blobs.items():
            await io.write_full(n, b)
        primaries = {type(osds[_acting(admin, io.pool_id, n)[1][0]])
                     .__module__.split(".")[0] for n in blobs}
        rounds = [(_stored_shards(osds, admin, io.pool_id, blobs),
                   {n: await io.read(n) for n in blobs})]
        for lost in (0, 1):           # a port OSD, then a reference one
            await _lose(osds, admin, lost)
            await _clean(osds, admin)
            rounds.append((_stored_shards(osds, admin, io.pool_id, blobs),
                           {n: await io.read(n) for n in blobs}))
        await admin.shutdown()
        for o in osds.values():
            await o.shutdown()
        await mon.shutdown()
        return primaries, rounds

    primaries, rounds = _run(run(), timeout=180)
    assert primaries == {"ceph_tpu", "ceph_tpu_torch"}
    for stored, read in rounds:
        assert stored == want
        assert read == blobs


# ------------------------------------------- chip_smoke's osd phase, small

SMALL = {"osds": 6, "k": K, "m": M, "ec_pgs": 16, "rep_pgs": 32,
         "queue_mode": "force",
         "client_files": 3, "client_file_bytes": 3 << 19}


def test_chip_smoke_osd_phase_on_the_cpu(tmp_path, capsys):
    """The script's osd phase on the CPU (the queue forced onto the plain
    apply, the host CRUSH engine at every call site): the cluster boots
    by command and MOSDBoots, every stored and rebuilt shard equals the
    CPU codec's chunk, the replicas agree, the degraded reads return the
    objects, and the phase counts placements at the Objecter, the epoch
    advance and backfill, and the queues' launches by step.  Its class
    step rewrites every EC object under a version guard (K1 encodes each
    rewrite), replays the guard (-ECANCELED), takes a lock and refcounts
    on EC and builds a bucket index of every replicated object; the
    degraded reads and rebuilt shards are held against the new
    contents.  Its client step writes a striped file set on the
    replicated pool, reads, edits, truncates and removes files, and
    patches EC objects through a write-back cache (K1 encodes each
    flush's rewrite); later EC checks hold the patched contents."""
    import torch

    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.ops import crush_kernel as ck
    rng = np.random.default_rng(17)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    out = chip_smoke.osd_phase(np, kernel, torch.device("cpu"), "cpu",
                               objects, str(tmp_path), **SMALL)
    assert set(out["d1_launches"]) == set(chip_smoke.OSD_D1_RANGES)
    assert out["d1_launches"]["objecter"] >= 2
    assert out["d1_launches"]["epoch"] >= 2 * SMALL["osds"]
    assert out["d1_wrapper"] == 0 == ck.crush_map_launches
    assert set(out["k1_launches"]) == set(chip_smoke.OSD_K1_RANGES)
    assert all(n > 0 for n in out["k1_launches"].values())
    assert out["k1_wrapper"] == 0
    assert out["recovery"]["moved_shards"] > 0
    assert out["phase_s"] < 30
    cls = out["cls"]
    assert cls["rewrites"] == cls["index_entries"] == len(objects)
    assert cls["k1"] == out["k1_launches"]["cls write"] > 0
    assert out["d1_launches"]["cls objecter"] == cls["d1_objecter"]
    assert cls["ops"] == 3 * len(objects) + 8
    client = out["client"]
    assert client["files"] == 3 and client["cache_objects"] == len(objects)
    assert client["cache_writes"] == chip_smoke.OSD_CACHE_WRITES
    assert client["k1_cache"] == out["k1_launches"]["client cache"] > 0
    assert client["cache_stats"]["flushes"] > 0
    assert out["d1_launches"]["client objecter"] == client["d1_objecter"]
    text = capsys.readouterr().out
    for step in ("boot", "ec write", "ec read", "rep write", "rep read",
                 "cls write", "cls replay", "cls xattr", "cls index", "cls",
                 *chip_smoke.CLIENT_STEPS, "degraded read", "recovery"):
        assert f"phase osd {step}:" in text, step


def test_chip_smoke_osd_phase_fails_on_an_error_from_an_osd(tmp_path,
                                                            monkeypatch):
    """An OSD that logs at ERROR fails the phase, though every check of
    the phase passed: here each OSD logs one as it starts."""
    import torch

    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.osd.daemon import OSD
    real = OSD.start

    async def start(self):
        await real(self)
        self.logger.error(f"osd.{self.whoami}: injected failure")

    monkeypatch.setattr(OSD, "start", start)
    rng = np.random.default_rng(18)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    with pytest.raises(chip_smoke.SmokeFailure, match="injected failure"):
        chip_smoke.osd_phase(np, kernel, torch.device("cpu"), "cpu",
                             objects, str(tmp_path), **SMALL)
