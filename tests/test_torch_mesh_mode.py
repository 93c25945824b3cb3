"""The port's OSD device-mesh execution mode (``osd_mesh_mode=on``,
``ceph_tpu_torch.parallel.mesh_exec``) against the JAX package's.

``tests/test_mesh_mode.py``'s case runs in both packages (the reference
with the repaired ``backoff``, ``test_torch_osd.install_ref_backoff``;
the port on the CPU with the executor's positions eight CPU devices, as
conftest gives the reference eight virtual ones) and their observations
must be equal.  Then the port alone: degraded reads and a rebuild in mesh
mode against the CPU codec, on one and on two thread shards per OSD, and
a failed mesh program off the CPU reaching its caller.  Tolerance 0.
"""

from __future__ import annotations

import asyncio
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import both  # noqa: E402

from ceph_tpu_torch.parallel import mesh_exec  # noqa: E402

CPU8 = ("cpu",) * 8


@pytest.fixture
def cpu_mesh(monkeypatch):
    """The port's executor over eight CPU positions unless told
    otherwise (``enable``'s default is one position per card), and the
    codec factory's default device the CPU (the case builds its ground
    truth with ``factory("rs", profile)``)."""
    from ceph_tpu_torch.ec import registry
    monkeypatch.setattr(mesh_exec.enable, "__defaults__", (CPU8,))
    monkeypatch.setattr(registry.factory, "__defaults__", ("cpu",))
    mesh_exec.disable()
    yield
    mesh_exec.disable()


def test_mesh_mode_case_matches_reference(cpu_mesh):
    both("test_mesh_mode", "test_mesh_mode_ec_write_placement_and_parity")


def _mesh_ctx(shards):
    from ceph_tpu_torch.qa.cluster import make_ctx

    def ctx_f(name):
        c = make_ctx(name)
        c.config.set("osd_mesh_mode", "on")
        if shards > 1:
            c.config.set("osd_op_num_shards", shards)
            c.config.set("osd_shard_lanes", "thread")
        return c
    return ctx_f


def _shards(cl, admin, pool, names):
    """Each object's acting set and each shard's bytes in its OSD's store
    (None where absent)."""
    from ceph_tpu_torch.osd.types import ObjectLocator
    from ceph_tpu_torch.store.types import CollectionId, ObjectId
    m = admin.monc.osdmap
    pid = m.lookup_pool(pool)
    out = {}
    for name in names:
        pgid = m.pools[pid].raw_pg_to_pg(
            m.object_locator_to_pg(name, ObjectLocator(pid)))
        acting = m.pg_to_up_acting_osds(pgid)[2]
        got = []
        for i, o in enumerate(acting):
            try:
                raw = cl.osds[o].store.read(
                    CollectionId.pg(pid, pgid.seed, i), ObjectId(name,
                                                                 pool=pid))
                got.append(bytes(raw))
            except Exception:       # noqa: BLE001 - not there (yet)
                got.append(None)
        out[name] = (list(acting), got)
    return out


@pytest.mark.parametrize("shards", [1, 2])
def test_degraded_reads_and_a_rebuild_in_mesh_mode(cpu_mesh, shards):
    """Writes encode on the mesh (no batch queue takes a request), reads
    of objects that lost a shard decode on it, and after the OSD goes
    out every shard on its new OSD equals the CPU codec's chunk; on two
    thread shards per OSD the in-process delivery crosses shard
    threads."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue
    from ceph_tpu_torch.qa.cluster import Cluster

    async def run():
        calls = []
        real = ECBatchQueue.apply

        async def apply(q, *a, **kw):
            calls.append(1)
            return await real(q, *a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ECBatchQueue, "apply", apply)
            cl = Cluster(ctx_factory=_mesh_ctx(shards), device="cpu")
            admin = await cl.start(6)
            ex = mesh_exec.current()
            assert ex is not None and len(ex.osds) == 6
            assert ex.devices == (torch.device("cpu"),) * 8
            await admin.pool_create("ecm", pg_num=8, pool_type="erasure",
                                    k=2, m=2)
            io = admin.open_ioctx("ecm")
            rng = np.random.default_rng(30 + shards)
            payloads = {f"mobj{i}": rng.integers(
                0, 256, 8192 + 1000 * i, dtype=np.uint8).tobytes()
                for i in range(12)}
            await asyncio.gather(*[io.write_full(n, d)
                                   for n, d in payloads.items()])
            assert ex.encode_launches == len(payloads)
            assert ex.inproc_subops > 0
            codec = factory("rs", {"k": "2", "m": "2"}, device="cpu")
            want = {n: [c.tobytes() for c in (
                codec.encode(set(range(4)), d)[i] for i in range(4))]
                for n, d in payloads.items()}
            before = _shards(cl, admin, "ecm", payloads)
            assert all(got == want[n] for n, (_, got) in before.items())

            # the OSD holding the most data shards goes down
            held = {}
            for acting, _ in before.values():
                for o in acting[:2]:
                    held[o] = held.get(o, 0) + 1
            victim = max(sorted(held), key=lambda o: held[o])
            await cl.kill_osd(victim)
            await cl.mark_down_and_wait(admin, victim)
            hit = [n for n, (acting, _) in before.items()
                   if victim in acting[:2]]
            got = await asyncio.gather(*[io.read(n) for n in hit])
            assert got == [payloads[n] for n in hit]
            assert ex.recover_launches >= 1

            # out: the lost shards are rebuilt on the mesh elsewhere
            await admin.mon_command({"prefix": "osd out", "id": victim})
            deadline = asyncio.get_running_loop().time() + 60
            while True:
                now = _shards(cl, admin, "ecm", payloads)
                if all(victim not in acting and got == want[n]
                       for n, (acting, got) in now.items()):
                    break
                assert asyncio.get_running_loop().time() < deadline, \
                    "the lost shards were not rebuilt"
                await asyncio.sleep(0.2)
            for n, d in payloads.items():
                assert await io.read(n) == d
            assert not calls, "a batch queue took a request in mesh mode"
            assert ex.k1_encode == ex.k1_recover == 0     # the CPU: plain
            await cl.stop()
    asyncio.run(run())


class _Osd:
    """What ``ECBackend._encode_object`` and ``_decode_shards`` read of
    their OSD: the mesh executor, the batch queue, the tracer's switch."""

    def __init__(self, ex, queue):
        import types
        self.mesh_exec = ex
        self._q = queue
        self.ctx = types.SimpleNamespace(
            tracer=types.SimpleNamespace(enabled=False))

    def ec_batch_queue(self):
        return self._q


class _Queue:
    def __init__(self):
        self.calls = 0

    async def apply(self, mat, chunks):
        from ceph_tpu_torch.ec import gf256
        self.calls += 1
        return gf256.host_apply(mat, chunks)


def _backend(ex, queue):
    import logging

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd.backend import ECBackend
    be = object.__new__(ECBackend)
    be.osd = _Osd(ex, queue)
    be.codec = factory("rs", {"k": "2", "m": "2"}, device="cpu")
    be.k, be.n = 2, 4
    be.log_ = logging.getLogger("test_torch_mesh_mode")
    return be


@pytest.mark.parametrize("where", ["cpu", "card"])
def test_a_failed_mesh_program_reaches_the_caller_off_the_cpu(where,
                                                               monkeypatch):
    """On the CPU a failed mesh program falls back to the batch queue, as
    the JAX package's does; off it (a card stood in for by naming a meta
    device after construction) the error goes to the caller of the
    encode and of the decode, and the batch queue takes nothing."""
    ex = mesh_exec.MeshExecutor(devices=CPU8)
    if where == "card":
        ex.devices = (torch.device("meta"),) * 8

    async def boom(*a, **kw):
        raise RuntimeError("mesh launch failed")

    monkeypatch.setattr(ex, "encode_object", boom)
    monkeypatch.setattr(ex, "recover_chunks", boom)
    q = _Queue()
    be = _backend(ex, q)
    data = bytes(range(256)) * 40
    want = be.codec.encode(set(range(4)), data)
    streams = {i: want[i] for i in (1, 2, 3)}

    async def run():
        enc = await be._encode_object(data)
        dec = await be._decode_shards([0, 1], streams)
        return enc, dec

    if where == "card":
        with pytest.raises(RuntimeError, match="mesh launch failed"):
            asyncio.run(be._encode_object(data))
        with pytest.raises(RuntimeError, match="mesh launch failed"):
            asyncio.run(be._decode_shards([0, 1], streams))
        assert q.calls == 0
        return
    enc, dec = asyncio.run(run())
    assert all(np.array_equal(enc[i], want[i]) for i in range(4))
    assert np.array_equal(dec[0], want[0]) and q.calls == 2


def test_chip_smoke_mesh_phase_on_the_cpu(tmp_path, capsys):
    """chip_smoke's mesh-mode run at a small size on the CPU (6 OSDs on two
    thread shards each, RS k=2 m=2, the executor over 8 CPU positions, the
    EC pool alone): every write encodes on the mesh, the degraded reads
    and the rebuild decode on it, every stored and rebuilt shard equals
    the CPU codec's, sub-ops go in process and no batch queue launches."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    import chip_smoke
    from ceph_tpu_torch.ec import kernel
    rng = np.random.default_rng(21)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    out = chip_smoke.osd_phase(np, kernel, torch.device("cpu"), "cpu",
                               objects, str(tmp_path), osds=6, k=2, m=2,
                               ec_pgs=16, rep_pgs=0, queue_mode="force",
                               mesh_positions=8)
    counts = out["mesh_counts"]
    assert counts["encode launches"] == len(objects)
    assert counts["recover launches"] >= 1
    assert counts["in-process sub-ops"] > 0
    assert counts["encode k1"] == counts["recover k1"] == 0   # the CPU
    assert set(out["d1_launches"]) == set(chip_smoke.OSD_MESH_D1_RANGES)
    assert out["k1_launches"] == {"mesh encode": 0, "mesh recover": 0}
    assert sum(out["k1_by_queue"].values()) == 0
    assert out["recovery"]["moved_shards"] > 0
    assert mesh_exec.current() is None
    text = capsys.readouterr().out
    for step in ("boot", "ec write", "ec read", "degraded read",
                 "recovery"):
        assert f"phase osd-mesh {step}:" in text, step
    assert "phase osd-mesh rep" not in text


def _parked_during_a_launch(ex, codec):
    """Two rebuilds on one loop, the second parked while the first's
    launch runs (each launch held 0.3 s): whether the second is served
    within 5 s, and what it rebuilt."""
    import time
    real = ex._rec_launch

    def slow(key, survs):
        time.sleep(0.3)
        return real(key, survs)

    ex._rec_launch = slow
    data = bytes(range(256)) * 48
    chunks = codec.encode(set(range(4)), data)

    async def run():
        first = asyncio.get_running_loop().create_task(ex.recover_chunks(
            codec, [0], {i: chunks[i] for i in (1, 2, 3)}))
        await asyncio.sleep(0.1)      # its window closed, its launch runs
        try:
            got = await asyncio.wait_for(ex.recover_chunks(
                codec, [1], {i: chunks[i] for i in (0, 2, 3)}), 5.0)
        except asyncio.TimeoutError:
            got = None
        await first
        return got

    got = asyncio.run(run())
    return got is not None and np.array_equal(got[1], chunks[1])


def test_a_rebuild_parked_during_a_launch_is_served():
    """The port's collector serves window after window: a rebuild parked
    while an earlier window's launch runs is served by the next (a
    backfill's concurrent pulls depend on it)."""
    from ceph_tpu_torch.ec.registry import factory
    ex = mesh_exec.MeshExecutor(devices=CPU8)
    codec = factory("rs", {"k": "2", "m": "2"}, device="cpu")
    assert _parked_during_a_launch(ex, codec)
    assert ex.recover_launches == 2


def test_the_jax_package_strands_a_rebuild_parked_during_a_launch():
    """The JAX package's collector serves one window and ends: the second
    rebuild finds its task still running, starts none, and is never
    served (the fault behind mesh-mode backfills that never finish)."""
    from ceph_tpu.ec.registry import factory
    from ceph_tpu.parallel import mesh_exec as ref_mesh_exec
    ex = ref_mesh_exec.MeshExecutor()
    codec = factory("rs", {"k": "2", "m": "2"})
    assert not _parked_during_a_launch(ex, codec)
    assert ex.launches == 1


def _writes_ahead_of_the_activation(root, mp):
    """A mesh-mode cluster of ``root`` whose primaries' activations reach
    their replicas 0.5 s late (each one sent later on its own loop), an
    EC pool written at once after its creation: for each object, how
    many of its shards' PG logs hold its write (4 each when none is
    lost)."""
    import importlib
    cluster = importlib.import_module(root + ".qa.cluster")
    daemon = importlib.import_module(root + ".osd.daemon")
    messages = importlib.import_module(root + ".osd.messages")
    real = daemon.OSD.send_osd

    def send_osd(self, peer, msg):
        if isinstance(msg, messages.MPGLog) and msg.activate:
            asyncio.get_running_loop().call_later(0.5, real, self, peer, msg)
            return
        return real(self, peer, msg)

    mp.setattr(daemon.OSD, "send_osd", send_osd)

    def ctx_f(name):
        c = cluster.make_ctx(name)
        c.config.set("osd_mesh_mode", "on")
        return c

    async def run():
        kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
        cl = cluster.Cluster(ctx_factory=ctx_f, **kw)
        admin = await cl.start(5)
        await admin.pool_create("ecm", pg_num=4, pool_type="erasure",
                                k=2, m=2)
        io = admin.open_ioctx("ecm")
        names = [f"early{i}" for i in range(8)]
        await asyncio.gather(*[io.write_full(n, bytes([i + 1]) * 4096)
                               for i, n in enumerate(names)])
        await asyncio.sleep(1.0)          # every activation has landed
        logged = {n: sum(pg.log.latest_entry_for(n) is not None
                         for o in cl.osds.values()
                         for pg in list(o.pgs.values()))
                  for n in names}
        for n in names:
            assert await io.read(n) is not None
        await cl.stop()
        return logged

    return asyncio.run(run())


def test_a_sub_op_handed_over_ahead_of_the_activation_waits_for_it(
        cpu_mesh, monkeypatch):
    """In-process delivery keeps the messenger's order: a write sub-op
    that reaches a replica before its primary's activation is held until
    the activation and applied on top of it, so every shard's log keeps
    the write (the unrepaired port, as the JAX package, lost it)."""
    logged = _writes_ahead_of_the_activation("ceph_tpu_torch", monkeypatch)
    assert logged == {n: 4 for n in logged}
    assert mesh_exec.current().inproc_subops >= 3 * len(logged)


def test_the_jax_package_loses_writes_that_overtake_the_activation(
        monkeypatch):
    """The same in the JAX package: the replicas apply the in-process
    sub-op at once, then adopt the activation's log without its entry
    (only the primary's log keeps the writes)."""
    import test_torch_osd
    from ceph_tpu.parallel import mesh_exec as ref_mesh_exec
    test_torch_osd.install_ref_backoff(monkeypatch)
    ref_mesh_exec.disable()
    try:
        logged = _writes_ahead_of_the_activation("ceph_tpu", monkeypatch)
    finally:
        ref_mesh_exec.disable()
    assert any(c < 4 for c in logged.values()), logged
