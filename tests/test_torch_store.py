"""The port's store layer (``ceph_tpu_torch.store``) against the JAX
package's (``ceph_tpu.store``).

- bytes: the corpus bins of ``Extent``, ``Onode``, ``Transaction``,
  ``TxOp``, ``CollectionId`` and ``ObjectId`` decode in the port and
  re-encode to the same bytes; ``KVTransaction``, ``Transaction`` and WAL
  records built from the same seeded inputs are the same bytes; the
  ``ObjectId`` placement hash and sort order agree over a few hundred
  seeded names;
- every backend (memstore, filestore, blockstore, kstore): the cases of
  ``tests/test_store.py`` run in both packages and give the same
  results, and a seeded sequence of transactions leaves the same state;
- store images: the same seeded transactions, one ``apply_transaction``
  at a time, leave byte-identical files in both packages' store
  directories, and a store written by either package mounts in the
  other and reads back equal;
- crash ordering: the replay sweep of FileStore's ``kill_at`` and the
  commit thread's ``crash_at`` points leave the same surviving state in
  both packages; bit rot is detected in both;
- the lockdep names of FileDB, the allocator and the commit thread, and
  the per-package ``OBSERVER`` hook;
- chip_smoke's store phase at a tiny size on the CPU (the queue forced
  onto the plain apply, the host CRUSH engine).

Tolerance 0: bytes and states are compared exactly.  Group boundaries
depend on the clock, so batch counts are never compared across
packages.  Every wait is bounded.
"""

import importlib
import os
import pathlib
import shutil
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

CORPUS = pathlib.Path(__file__).parent / "corpus"


def _pkg(root):
    m = importlib.import_module
    store = m(root + ".store")
    return SimpleNamespace(
        root=root, store=store, kv=m(root + ".store.kv"),
        wal=m(root + ".store.wal"), commit=m(root + ".store.commit"),
        objectstore=m(root + ".store.objectstore"),
        types=m(root + ".store.types"),
        filestore=m(root + ".store.filestore"),
        kstore=m(root + ".store.kstore"),
        blockstore=m(root + ".store.blockstore"),
        lockdep=m(root + ".common.lockdep"),
        ObjectStore=store.ObjectStore, Transaction=store.Transaction,
        ObjectId=store.ObjectId, CollectionId=store.CollectionId,
        StoreError=store.StoreError, FileDB=store.FileDB,
        MemDB=store.MemDB)


REF, PORT = _pkg("ceph_tpu"), _pkg("ceph_tpu_torch")
BOTH = (REF, PORT)
KINDS = ("memstore", "filestore", "blockstore", "kstore")
DURABLE = ("filestore", "blockstore", "kstore")


def _both(fn, tmp_path, *args):
    """Run ``fn(pkg, dir, *args)`` for each package in a directory of its
    own; the two results must be equal."""
    got = []
    for p in BOTH:
        d = tmp_path / p.root
        d.mkdir()
        got.append(fn(p, d, *args))
    assert got[1] == got[0]
    return got[1]


def _raises(fn):
    """The name of the exception ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:          # the name is the observation
        return type(e).__name__
    return None


def _open(p, kind, d, name="store"):
    s = p.ObjectStore.create(kind, str(d / name))
    s.mkfs()
    s.mount()
    return s


def _fingerprint(s):
    """Every collection, its listing order, and each object's data,
    xattrs, omap header and omap."""
    out = []
    for cid in sorted(s.list_collections(), key=lambda c: c.name):
        for oid in s.collection_list(cid):
            hdr, omap = s.omap_get(cid, oid)
            out.append((cid.name, oid.name, oid.snap, oid.shard,
                        s.read(cid, oid), sorted(s.getattrs(cid, oid).items()),
                        hdr, sorted(omap.items())))
        if not s.collection_list(cid):
            out.append((cid.name,))
    return out


def _tree(d):
    """Relative path -> bytes of every file under d."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


# ------------------------------------------------------------------ bytes

@pytest.mark.parametrize("dotted", [
    "store.blockstore.Extent", "store.blockstore.Onode",
    "store.objectstore.Transaction", "store.objectstore.TxOp",
    "store.types.CollectionId", "store.types.ObjectId"])
def test_corpus_bins_reencode_byte_identically(dotted):
    blob = (CORPUS / f"ceph_tpu.{dotted}.bin").read_bytes()
    mod, _, name = dotted.rpartition(".")
    port_cls = getattr(importlib.import_module(f"ceph_tpu_torch.{mod}"),
                       name)
    ref_cls = getattr(importlib.import_module(f"ceph_tpu.{mod}"), name)
    assert port_cls.STRUCT_V == ref_cls.STRUCT_V == blob[0]
    obj = port_cls.from_bytes(blob)
    assert obj.to_bytes() == blob
    assert port_cls.from_bytes(ref_cls.from_bytes(blob).to_bytes()) \
        .to_bytes() == blob


def _kv_ops(p, seed):
    rng = np.random.default_rng(seed)
    t = p.kv.KVTransaction()
    for _ in range(int(rng.integers(1, 40))):
        prefix = ["p", "meta", "O", "é"][int(rng.integers(0, 4))]
        key = rng.integers(0, 256, int(rng.integers(0, 20)),
                           dtype=np.uint8).tobytes()
        op = int(rng.integers(0, 3))
        if op == 0:
            t.set(prefix, key, rng.integers(0, 256, int(rng.integers(
                0, 300)), dtype=np.uint8).tobytes())
        elif op == 1:
            t.rmkey(prefix, key if rng.integers(0, 2) else "text-key")
        else:
            t.rmkeys_by_prefix(prefix)
    return t


@pytest.mark.parametrize("seed", range(4))
def test_kvtransaction_bytes_match(seed):
    ref, port = _kv_ops(REF, seed), _kv_ops(PORT, seed)
    assert port.encode() == ref.encode()
    assert PORT.kv.KVTransaction.decode(ref.encode()).ops == ref.ops
    assert REF.kv.KVTransaction.decode(port.encode()).ops == port.ops


def _ids(p, seed, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        name = "".join(chr(int(c)) for c in rng.integers(
            32, 0x24F, int(rng.integers(0, 24))))
        key = "" if rng.integers(0, 3) else f"key{i % 7}"
        out.append(p.ObjectId(
            name, key=key, namespace=["", "ns", "z"][i % 3],
            pool=int(rng.integers(-1, 4)),
            snap=[p.types.SNAP_HEAD, 1, 5, 2**40][int(rng.integers(0, 4))],
            shard=int(rng.integers(-1, 12)),
            generation=int(rng.integers(0, 3))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_object_id_hash_sort_and_bytes_match(seed):
    ref, port = _ids(REF, seed), _ids(PORT, seed)
    for r, q in zip(ref, port):
        assert (q.hash32, q.reversed_hash, q.sort_key(), repr(q),
                q.is_head()) == (r.hash32, r.reversed_hash, r.sort_key(),
                                 repr(r), r.is_head())
        assert q.to_bytes() == r.to_bytes()
        assert PORT.ObjectId.from_bytes(r.to_bytes()) == q
    order = sorted(range(len(ref)), key=lambda i: ref[i])
    assert sorted(range(len(port)), key=lambda i: port[i]) == order
    # the placement hash is the reference's rjenkins of (key or name)
    assert [o.hash32 for o in port] == [
        PORT.types.ceph_str_hash_rjenkins((o.key or o.name).encode())
        for o in port]
    c = [p.CollectionId.pg(3, 0x1A, shard=2) for p in BOTH]
    assert c[1].to_bytes() == c[0].to_bytes() and c[1].name == c[0].name
    assert c[1].is_pg() and not PORT.CollectionId.meta().is_pg()


def _txn(p, seed):
    """One seeded transaction using every Transaction op."""
    rng = np.random.default_rng(seed)
    T, C = p.Transaction, p.CollectionId
    cid, cid2 = C.pg(1, int(rng.integers(0, 64))), C("meta")
    o = p.ObjectId(f"obj{seed}", pool=1, shard=int(rng.integers(-1, 6)))
    o2 = o.with_snap(int(rng.integers(1, 9)))

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    return (T().nop().create_collection(cid).touch(cid, o)
            .write(cid, o, int(rng.integers(0, 9000)), blob(3000))
            .zero(cid, o, 5, 77).truncate(cid, o, 1234)
            .setattr(cid, o, "_", blob(40))
            .setattrs(cid, o, {"snapset": blob(9), "é": b""})
            .rmattr(cid, o, "_").clone(cid, o, o2)
            .clone_range(cid, o, o2, 3, 100, 7)
            .omap_setkeys(cid, o, {blob(5): blob(50), b"k": b""})
            .omap_rmkeys(cid, o, [b"k", blob(3)])
            .omap_rmkeyrange(cid, o, b"a", b"q")
            .omap_setheader(cid, o, blob(12)).omap_clear(cid, o2)
            .try_rename(cid, o2, o2.with_snap(99))
            .collection_move_rename(cid, o, cid2, o)
            .remove(cid2, o).remove_collection(cid))


@pytest.mark.parametrize("seed", range(3))
def test_transaction_bytes_match(seed):
    ref, port = _txn(REF, seed), _txn(PORT, seed)
    blob = ref.to_bytes()
    assert port.to_bytes() == blob
    assert PORT.Transaction.from_bytes(blob).to_bytes() == blob
    assert port.approx_size() == ref.approx_size()
    frozen = port.mutable_copy().freeze()
    assert frozen.frozen and frozen.to_bytes() == blob
    with pytest.raises(AttributeError):
        frozen.touch(PORT.CollectionId.meta(), PORT.ObjectId("x"))


def _wal(p, d):
    w = p.wal.WriteAheadLog(str(d / "wal"))
    assert w.replay() == []
    w.append(1, b"one")
    w.append_many([(2, b""), (7, bytes(range(256)) * 9)])
    w.close()
    with open(d / "wal", "ab") as f:
        f.write(b"\x01\x02torn")                # a torn tail record
    img = (d / "wal").read_bytes()
    w2 = p.wal.WriteAheadLog(str(d / "wal"))
    recs = w2.replay()                      # truncates the torn tail
    w2.append(8, b"after")
    w2.close()
    p.wal.atomic_snapshot(str(d / "snap"), b"snapshot bytes")
    return img, recs, _tree(d)


def test_wal_records_and_torn_tail_replay_match(tmp_path):
    img, recs, tree = _both(_wal, tmp_path)
    assert [s for s, _ in recs] == [1, 2, 7]
    assert tree["wal"].endswith(b"after") and b"torn" not in tree["wal"]


# ---------------------------------------------------------------- kv layer

def _kv_basic(p, d, kind):
    db = p.MemDB() if kind == "mem" else p.FileDB(str(d / "kv"))
    try:
        t = db.create_transaction()
        t.set("p", "a", b"1").set("p", "b", b"2").set("q", "a", b"3")
        db.submit(t)
        obs = [db.get("p", "a"), db.get("q", "a"), db.get("p", "zzz"),
               list(db.iterate("p"))]
        db.submit(db.create_transaction().rmkey("p", "a"))
        obs.append(db.get("p", "a"))
        db.submit(db.create_transaction().rmkeys_by_prefix("p"))
        obs += [db.keys("p"), db.get("q", "a")]
        t = db.create_transaction()
        for i in range(10):
            t.set("x", f"k{i}", str(i).encode())
        db.submit(t)
        obs.append([k for k, _ in db.iterate("x", start=b"k3", end=b"k7")])
        obs.append(list(db.iterate_all()))
    finally:
        db.close()
    assert obs[:3] == [b"1", b"3", None] and obs[-2] == [
        b"k3", b"k4", b"k5", b"k6"]
    return obs


@pytest.mark.parametrize("kind", ["mem", "file"])
def test_kv_basic_and_iterate_range(tmp_path, kind):
    _both(_kv_basic, tmp_path, kind)


def _filedb_replay_torn_tail(p, d):
    path = str(d / "kv")
    db = p.FileDB(path)
    db.submit(db.create_transaction().set("p", "a", b"1"))
    db.submit(db.create_transaction().set("p", "b", b"2"))
    db._wal.close()                          # crash: no close/compact
    with open(os.path.join(path, "wal"), "ab") as f:
        f.write(b"\x01\x02garbage-torn-record")
    db2 = p.FileDB(path)
    obs = [db2.get("p", "a"), db2.get("p", "b"), db2.seq]
    db2.submit(db2.create_transaction().set("p", "c", b"3"))
    db2._wal.close()                         # crash again
    db3 = p.FileDB(path)
    obs += [db3.get("p", "c"), db3.seq, _tree(path)]
    db3.close()
    obs.append(_tree(path))                  # compacted on close
    db4 = p.FileDB(path)
    obs.append(list(db4.iterate_all()))
    db4.close()
    assert obs[:3] == [b"1", b"2", 2] and obs[3] == b"3"
    return obs


def test_filedb_replay_and_torn_tail(tmp_path):
    _both(_filedb_replay_torn_tail, tmp_path)


def _filedb_reads_during_group_fsync(p, d):
    db = p.FileDB(str(d / "kv"))
    db.submit(db.create_transaction().set("p", "seed", b"v"))
    for i in range(8):
        db.submit_deferred(
            db.create_transaction().set("p", f"d{i}", str(i).encode()))
    entered, release = threading.Event(), threading.Event()
    orig = db._wal.append_many

    def slow_append(recs, sync=True):
        entered.set()
        assert release.wait(10)
        orig(recs, sync=sync)

    db._wal.append_many = slow_append
    flusher = threading.Thread(target=db.log_deferred, args=(db.seq,))
    flusher.start()
    assert entered.wait(10)
    reads = []
    reader = threading.Thread(target=lambda: reads.append(
        (db.get("p", "seed"), db.get("p", "d0"),
         [k for k, _ in db.iterate("p", start=b"d")][:2])))
    reader.start()
    reader.join(5.0)
    stalled = reader.is_alive()
    release.set()
    flusher.join(10)
    reader.join(5)
    db._wal.append_many = orig
    db.close()
    db2 = p.FileDB(str(d / "kv"))
    obs = [stalled, reads, db2.get("p", "d7"), db2.seq]
    db2.close()
    assert obs[:3] == [False, [(b"v", b"0", [b"d0", b"d1"])], b"7"]
    return obs


def test_filedb_reads_do_not_wait_for_the_group_fsync(tmp_path):
    _both(_filedb_reads_during_group_fsync, tmp_path)


def _filedb_concurrent(p, d):
    db = p.FileDB(str(d / "kv"))
    stop = threading.Event()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as can be

    def committer():
        while not stop.is_set():
            db.log_deferred(db.seq)

    t = threading.Thread(target=committer)
    t.start()
    try:
        for i in range(200):
            if i % 3 == 0:
                db.submit(db.create_transaction()
                          .set("s", f"k{i:03d}", b"sync"))
            else:
                db.submit_deferred(db.create_transaction()
                                   .set("s", f"k{i:03d}", b"def"))
    finally:
        stop.set()
        t.join(10)
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    db.close()
    db2 = p.FileDB(str(d / "kv"))
    obs = list(db2.iterate("s"))
    db2.close()
    assert len(obs) == 200
    return obs


def test_filedb_submit_racing_log_deferred(tmp_path):
    _both(_filedb_concurrent, tmp_path)


def test_memdb_remove_prefix_with_high_bytes():
    def run(p):
        db = p.MemDB()
        hot = b"\xff" * 12
        db.submit(db.create_transaction().set("p", hot, b"v")
                  .set("p", b"normal", b"n").set("q", b"other", b"o"))
        db.submit(db.create_transaction().rmkeys_by_prefix("p"))
        return [db.get("p", hot), db.keys("p"), db.get("q", b"other"),
                list(db.iterate("q")), db._keys]
    assert run(PORT) == run(REF) == [None, [], b"o", [(b"other", b"o")],
                                     [b"q\x00other"]]


# ------------------------------------------------- every backend, both ways

def _c(p):
    return p.CollectionId.pg(1, 0)


def _o(p, name="obj"):
    return p.ObjectId(name, pool=1)


def _case_write_read(p, s):
    C, O, T = _c(p), _o(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    s.apply_transaction(T().write(C, O, 0, b"hello world"))
    obs = [s.read(C, O), s.read(C, O, 6, 5)]
    s.apply_transaction(T().write(C, O, 6, b"there"))
    obs.append(s.read(C, O))
    s.apply_transaction(T().write(C, O, 20, b"x"))
    obs += [s.read(C, O, 11, 9), s.stat(C, O)]
    assert obs[:4] == [b"hello world", b"world", b"hello there",
                       b"\x00" * 9] and obs[4]["size"] == 21
    return obs


def _case_zero_truncate_remove(p, s):
    C, O, T = _c(p), _o(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    s.apply_transaction(T().write(C, O, 0, b"abcdef"))
    s.apply_transaction(T().zero(C, O, 1, 3))
    obs = [s.read(C, O)]
    s.apply_transaction(T().truncate(C, O, 2))
    obs.append(s.read(C, O))
    s.apply_transaction(T().remove(C, O))
    obs += [s.exists(C, O), _raises(lambda: s.read(C, O))]
    assert obs == [b"a\x00\x00\x00ef", b"a\x00", False, "NoSuchObject"]
    return obs


def _case_xattr_omap(p, s):
    C, O, T = _c(p), _o(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    s.apply_transaction(
        T().touch(C, O).setattrs(C, O, {"_": b"meta", "snapset": b"ss"})
        .omap_setheader(C, O, b"hdr")
        .omap_setkeys(C, O, {b"a": b"1", b"b": b"2"}))
    obs = [s.getattr(C, O, "_"), s.getattrs(C, O), s.omap_get(C, O),
           s.omap_get_header(C, O), _raises(lambda: s.getattr(C, O, "no"))]
    s.apply_transaction(T().rmattr(C, O, "snapset")
                        .omap_rmkeys(C, O, [b"a"]))
    obs += [s.getattrs(C, O), s.omap_get(C, O)[1],
            s.omap_get_values(C, O, [b"b", b"zz"])]
    assert obs[2] == (b"hdr", {b"a": b"1", b"b": b"2"})
    assert obs[-1] == {b"b": b"2"}
    return obs


def _case_clone_and_rename(p, s):
    C, O, T = _c(p), _o(p), p.Transaction
    snap = O.with_snap(5)
    s.apply_transaction(T().create_collection(C))
    s.apply_transaction(T().write(C, O, 0, b"v1").clone(C, O, snap))
    s.apply_transaction(T().write(C, O, 0, b"v2"))
    obs = [s.read(C, snap), s.read(C, O)]
    c2 = p.CollectionId.pg(1, 1)
    s.apply_transaction(T().create_collection(c2)
                        .collection_move_rename(C, O, c2, O))
    obs += [s.read(c2, O), s.exists(C, O), _fingerprint(s)]
    assert obs[:4] == [b"v1", b"v2", b"v2", False]
    return obs


def _case_collections_and_listing(p, s):
    C, T = _c(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    oids = [_o(p, f"o{i}") for i in range(10)]
    t = T()
    for o in oids:
        t.touch(C, o)
    s.apply_transaction(t)
    listed = s.collection_list(C)
    first = s.collection_list(C, max_count=4)
    rest = s.collection_list(C, start=first[-1])
    obs = [[o.name for o in listed], first + rest == listed,
           [c.name for c in s.list_collections()],
           s.collection_exists(C),
           s.collection_exists(p.CollectionId.pg(9, 9)),
           _raises(lambda: s.collection_list(p.CollectionId.pg(9, 9)))]
    assert set(listed) == set(oids) and obs[1] and obs[-1] == \
        "NoSuchCollection"
    return obs


def _case_callbacks_order(p, s):
    C, O, T = _c(p), _o(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    events = []
    s.queue_transactions([T().write(C, O, 0, b"x")],
                         on_applied=lambda: events.append("applied"),
                         on_commit=lambda: events.append("commit"))
    first = events[0]
    s.sync()
    assert first == "applied" and events == ["applied", "commit"]
    return [first, events]


def _case_apply_is_total(p, s):
    C, O, T = _c(p), _o(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    missing = _o(p, "missing")
    s.apply_transaction(
        T().write(C, O, 0, b"x").rmattr(C, missing, "a")
        .omap_rmkeys(C, missing, [b"k"]).omap_clear(C, missing)
        .remove(C, missing).clone(C, missing, _o(p, "c"))
        .remove(p.CollectionId.pg(9, 9), missing))
    obs = [s.read(C, O), s.exists(C, missing), _fingerprint(s)]
    assert obs[:2] == [b"x", False]
    return obs


def _case_group_commit_order(p, s):
    C, T = _c(p), p.Transaction
    s.apply_transaction(T().create_collection(C))
    committer = getattr(s, "_committer", None)
    if committer is not None:
        committer.gate = threading.Event()   # every batch in one group
    order = []
    for i in range(24):
        s.queue_transactions(
            [T().write(C, _o(p, f"seq{i}"), 0, bytes([i]) * 128)],
            on_commit=lambda i=i: order.append(i))
    if committer is not None:
        committer.gate.set()
    s.sync()
    assert order == list(range(24))
    return [order, _fingerprint(s)]


CASES = {"write_read": _case_write_read,
         "zero_truncate_remove": _case_zero_truncate_remove,
         "xattr_omap": _case_xattr_omap,
         "clone_and_rename": _case_clone_and_rename,
         "collections_and_listing": _case_collections_and_listing,
         "callbacks_order": _case_callbacks_order,
         "apply_is_total": _case_apply_is_total,
         "group_commit_order": _case_group_commit_order}


def _run_case(p, d, kind, case):
    s = _open(p, kind, d)
    try:
        return CASES[case](p, s)
    finally:
        s.umount()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_backend_case_matches_reference(tmp_path, case, kind):
    _both(_run_case, tmp_path, kind, case)


def _seq(p, seed, n=40):
    """A seeded sequence of transactions over three collections that
    stays valid on every backend (renames and clones only of objects
    that exist at that point)."""
    rng = np.random.default_rng(seed)
    T, C = p.Transaction, p.CollectionId
    colls = [C.pg(1, 0), C.pg(1, 1, shard=2), C.meta()]
    live = {c.name: set() for c in colls}
    names = [f"o{i}" for i in range(6)]

    def oid(name):
        return p.ObjectId(name, pool=1)

    def blob(lo, hi):
        return rng.integers(0, 256, int(rng.integers(lo, hi)),
                            dtype=np.uint8).tobytes()

    first = T()
    for c in colls:
        first.create_collection(c)
    txns = [first]
    for _ in range(n):
        t = T()
        for _ in range(int(rng.integers(1, 4))):
            ci = int(rng.integers(0, len(colls)))
            c, here = colls[ci], live[colls[ci].name]
            name = names[int(rng.integers(0, len(names)))]
            other = names[(names.index(name) + int(rng.integers(
                1, len(names)))) % len(names)]
            op = int(rng.integers(0, 16))
            if op < 3:
                t.write(c, oid(name), int(rng.integers(0, 9000)),
                        blob(1, 20000))
            elif op == 3:
                t.zero(c, oid(name), int(rng.integers(0, 9000)),
                       int(rng.integers(1, 6000)))
            elif op == 4:
                t.truncate(c, oid(name), int(rng.integers(0, 12000)))
            elif op == 5:
                t.setattr(c, oid(name), f"a{int(rng.integers(0, 3))}",
                          blob(0, 40))
            elif op == 6:
                t.setattrs(c, oid(name), {"x": blob(0, 9), "y": b"y"})
            elif op == 7:
                t.rmattr(c, oid(name), f"a{int(rng.integers(0, 3))}")
                continue
            elif op == 8:
                t.omap_setkeys(c, oid(name), {
                    f"k{int(rng.integers(0, 5))}".encode(): blob(0, 64)
                    for _ in range(3)})
            elif op == 9:
                t.omap_rmkeys(c, oid(name), [b"k1", b"k4"])
                t.omap_rmkeyrange(c, oid(name), b"k2", b"k3")
                continue
            elif op == 10:
                t.omap_setheader(c, oid(name), blob(0, 30))
            elif op == 11:
                t.omap_clear(c, oid(name))
                continue
            elif op in (12, 13) and name in here:
                if op == 12:
                    t.clone(c, oid(name), oid(other))
                else:
                    t.clone_range(c, oid(name), oid(other),
                                  int(rng.integers(0, 4000)),
                                  int(rng.integers(0, 8000)),
                                  int(rng.integers(0, 4000)))
                name = other
            elif op == 14 and name in here:
                t.try_rename(c, oid(name), oid(other))
                here.discard(name)
                name = other
            elif op == 15 and name in here:
                to = colls[(ci + 1) % len(colls)]
                t.collection_move_rename(c, oid(name), to, oid(name))
                here.discard(name)
                here = live[to.name]
            else:
                t.remove(c, oid(name))
                here.discard(name)
                continue
            here.add(name)
        txns.append(t)
    return txns


def _apply_seq(p, d, kind, seed):
    s = _open(p, kind, d)
    try:
        for t in _seq(p, seed):
            s.apply_transaction(t)
        return _fingerprint(s)
    finally:
        s.umount()


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_sequence_leaves_the_same_state(tmp_path, kind):
    fp = _both(_apply_seq, tmp_path, kind, 7)
    assert len(fp) > 6


# ------------------------------------------------------------ store images

def _image(p, d, kind, seed):
    s = _open(p, kind, d)
    for t in _seq(p, seed):
        s.apply_transaction(t)
    fp = _fingerprint(s)
    crash = _tree(d / "store")          # every commit durable, no umount
    s.umount()
    return fp, crash, _tree(d / "store")


@pytest.mark.parametrize("kind", DURABLE)
def test_store_files_are_byte_identical(tmp_path, kind):
    fp, crash, clean = _both(_image, tmp_path, kind, 11)
    assert crash and clean and fp


def _write_then_copy(p, d, kind, seed, umount):
    s = _open(p, kind, d)
    for t in _seq(p, seed):
        s.apply_transaction(t)
    fp = _fingerprint(s)
    if umount:
        s.umount()
        shutil.copytree(d / "store", d / "copy")
    else:
        # a crash image: every commit is durable, nothing compacted
        shutil.copytree(d / "store", d / "copy")
        s.umount()
    return fp


@pytest.mark.parametrize("umount", [True, False], ids=["clean", "crash"])
@pytest.mark.parametrize("kind", DURABLE)
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_store_written_by_one_package_mounts_in_the_other(
        tmp_path, kind, writer, reader, umount):
    fp = _write_then_copy(writer, tmp_path, kind, 5, umount)
    s = reader.ObjectStore.create(kind, str(tmp_path / "copy"))
    s.mount()
    try:
        assert _fingerprint(s) == fp
        # and the mounted store takes more writes
        C, O = _c(reader), _o(reader, "late")
        s.apply_transaction(reader.Transaction().write(C, O, 0, b"late"))
        assert s.read(C, O) == b"late"
    finally:
        s.umount()


# ----------------------------------------------------------- backend cases

def _filestore_crash_replay(p, d):
    C, O, T = _c(p), _o(p), p.Transaction
    FS = p.filestore.FileStore
    path = str(d / "fs")
    s = FS(path)
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C))
    s.apply_transaction(T().write(C, O, 0, b"durable")
                        .omap_setkeys(C, O, {b"k": b"v"}))
    for i in range(5):
        s.apply_transaction(T().write(C, _o(p, f"o{i}"), 0,
                                      bytes([i]) * 100))
    s.checkpoint()
    s.apply_transaction(T().write(C, _o(p, "after"), 0, b"post-ckpt")
                        .rmattr(C, _o(p, "ghost"), "x"))
    s._wal.close()                           # crash
    with open(os.path.join(path, "wal"), "ab") as f:
        f.write(b"torn-half-record\x00\x01")
    s2 = FS(path)
    s2.mount()
    obs = [_fingerprint(s2)]
    s2.apply_transaction(T().write(C, O, 0, b"DURABLE"))
    s2._wal.close()                          # crash again
    s3 = FS(path)
    s3.mount()
    obs.append(_fingerprint(s3))
    s3.umount()                              # checkpoint + empty wal
    obs += [os.path.getsize(os.path.join(path, "wal")), _tree(path),
            _raises(lambda: FS(str(d / "nofs")).mount()),
            _raises(lambda: FS(""))]
    assert {e[1]: e[4] for e in obs[1]}["obj"] == b"DURABLE"
    assert obs[2] == 0
    return obs


def _blockstore_crash_no_umount(p, d):
    BS = p.blockstore.BlockStore
    C, T = _c(p), p.Transaction
    path = str(d / "bs")
    s = BS(path)
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C))
    for i in range(10):
        s.apply_transaction(T().write(C, _o(p, f"o{i}"), 0,
                                      bytes([i]) * 5000))
    for i in range(10):
        s.apply_transaction(T().write(C, _o(p, f"o{i}"), 100,
                                      bytes([0xF0 | i]) * 1000))
    s2 = BS(path)                            # no umount: a crash
    s2.mount()
    fs = s2.statfs()
    obs = [_fingerprint(s2), fs, s2.alloc.free]
    s2.umount()
    s.umount()
    assert fs["used"] + fs["free"] == fs["total"]
    return obs


def _blockstore_cow(p, d):
    BS = p.blockstore.BlockStore
    C, O, T = _c(p), _o(p), p.Transaction
    s = BS(str(d / "bs"))
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C).write(C, O, 0, b"1" * 8192))
    before = [(e.disk, e.length) for e in s._get_onode(C, O).extents]
    s.apply_transaction(T().write(C, O, 0, b"2" * 8192))
    after = [(e.disk, e.length) for e in s._get_onode(C, O).extents]
    for _ in range(20):
        s.apply_transaction(T().write(C, O, 0, b"x" * 8192))
    obs = [before, after, s.read(C, O), s.statfs(), s.alloc.free]
    s.umount()
    assert set(before).isdisjoint(after)
    assert obs[3]["total"] <= 8192 * 4 + 4 * 4096
    return obs


def _blockstore_compression(p, d):
    BS = p.blockstore.BlockStore
    C, O, T = _c(p), _o(p), p.Transaction
    path = str(d / "bsz")
    s = BS(path, compression="zlib")
    s.mkfs()
    s.mount()
    payload = b"squeeze me please " * 4096
    rnd = np.random.default_rng(3).integers(
        0, 256, 32768, dtype=np.uint8).tobytes()
    O2, O3 = _o(p, "rand"), _o(p, "almost")
    # zlib saves ~1.5 KiB here, less than one allocation unit: kept raw
    almost = rnd[:8192] + bytes(1536)
    s.apply_transaction(T().create_collection(C).write(C, O, 0, payload)
                        .write(C, O2, 0, rnd).write(C, O3, 0, almost))
    exts = [[(e.logical, e.disk, e.length, e.crc, e.disk_len, e.alg)
             for e in s._get_onode(C, o).extents] for o in (O, O2, O3)]
    s.umount()
    s2 = BS(path)                            # no compression configured
    s2.mount()
    s2.apply_transaction(T().write(C, O, 100, b"RAW"))
    obs = [exts, _fingerprint(s2)]
    s2.umount()
    obs.append(_tree(path))
    assert any(e[5] == "zlib" for e in exts[0])
    assert all(e[5] == "" for e in exts[1] + exts[2])
    return obs


def _kstore_cases(p, d):
    KS = p.kstore.KStore
    STRIPE = p.kstore.STRIPE
    C, O, T = _c(p), _o(p), p.Transaction
    path = str(d / "ks")
    s = KS(path)
    s.mkfs()
    s.mount()
    big = bytes(range(256)) * ((STRIPE * 2 + 777) // 256 + 1)
    s.apply_transaction(T().create_collection(C).write(C, O, 0, big)
                        .setattr(C, O, "_", b"oi-bytes")
                        .omap_setkeys(C, O, {b"a": b"1", b"b": b"2"})
                        .omap_setheader(C, O, b"HDR"))
    s.umount()
    s2 = KS(path)
    s2.mount()
    obs = [s2.read(C, O, STRIPE - 100, 200), _fingerprint(s2)]
    # a small overwrite WALs only the stripe it touches
    seen = []
    orig = s2.db.submit_deferred

    def spy(kvt):
        seen.extend(k for kind, k, _ in kvt.ops
                    if kind == 0 and k.startswith(b"D"))
        return orig(kvt)
    s2.db.submit_deferred = spy
    s2.apply_transaction(T().write(C, O, STRIPE + 5, b"y" * 100))
    s2.db.submit_deferred = orig
    obs.append(seen)
    # clone and rename carry omap; rename replaces the destination
    a, b, o2, o3 = (_o(p, n) for n in ("a", "b", "obj2", "obj3"))
    s2.apply_transaction(
        T().clone(C, O, o2).write(C, b, 0, b"Z" * (STRIPE * 2))
        .omap_setkeys(C, b, {b"old": b"1"}).write(C, a, 0, b"payload")
        .omap_setkeys(C, a, {b"k": b"v"}))
    s2.apply_transaction(T().try_rename(C, o2, o3).try_rename(C, a, b))
    s2.apply_transaction(T().write(C, b, STRIPE + 5, b"!"))
    obs += [s2.read(C, b, STRIPE, 5), _fingerprint(s2)]
    s2.umount()
    obs.append(_tree(path))
    assert len(seen) == 1 and obs[3] == b"\x00" * 5
    return obs


def _blockstore_group_commit_shares_fsyncs(p, d):
    BS = p.blockstore.BlockStore
    C, T = _c(p), p.Transaction
    path = str(d / "bs")
    s = BS(path)
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C))
    base = s.commit_counters()
    s._committer.gate = threading.Event()
    done = []
    for i in range(16):
        s.queue_transactions(
            [T().write(C, _o(p, f"grp{i}"), 0, bytes([i]) * 4096)],
            on_commit=lambda i=i: done.append(i))
    s._committer.gate.set()
    s.sync()
    c = s.commit_counters()
    s2 = BS(path)                            # no umount: a power cut
    s2.mount()
    fp = _fingerprint(s2)
    s2.umount()
    s.umount()
    # counts only as bounds: group boundaries follow the clock
    assert c["txns"] - base["txns"] == 16
    assert c["commit_batches"] - base["commit_batches"] < 16
    assert 1 <= c["fsyncs"] - base["fsyncs"] < 16
    assert c["fsyncs_saved"] > base["fsyncs_saved"]
    return [done, fp]


SPECIFIC = {"filestore_crash_replay": _filestore_crash_replay,
            "blockstore_crash_no_umount": _blockstore_crash_no_umount,
            "blockstore_cow_overwrite": _blockstore_cow,
            "blockstore_compression": _blockstore_compression,
            "kstore_stripes_clone_rename": _kstore_cases,
            "blockstore_group_commit": _blockstore_group_commit_shares_fsyncs}


@pytest.mark.parametrize("case", sorted(SPECIFIC))
def test_backend_specific_case_matches_reference(tmp_path, case):
    _both(SPECIFIC[case], tmp_path)


# ---------------------------------------------------------- crash ordering

def _random_txn(p, rng):
    """test_store.py's seeded transaction (data, xattr, omap, truncate)."""
    cid = p.CollectionId("seq")
    oid = p.ObjectId(f"o{rng.integers(0, 6)}")
    t = p.Transaction()
    kind = int(rng.integers(0, 4))
    if kind == 0:
        t.write(cid, oid, int(rng.integers(0, 512)),
                bytes(rng.integers(0, 256, int(rng.integers(1, 2048)),
                                   dtype=np.uint8)))
    elif kind == 1:
        t.setattr(cid, oid, f"a{int(rng.integers(0, 3))}",
                  bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
    elif kind == 2:
        t.omap_setkeys(cid, oid, {
            f"k{int(rng.integers(0, 4))}".encode():
            bytes(rng.integers(0, 256, 32, dtype=np.uint8))})
    else:
        t.truncate(cid, oid, int(rng.integers(0, 256)))
    return t


def _replay_sweep(p, d, n_txns=12, seed=1234):
    FS, KilledAt = p.filestore.FileStore, p.filestore.KilledAt

    def txns():
        rng = np.random.default_rng(seed)
        first = p.Transaction().create_collection(p.CollectionId("seq"))
        return [first] + [_random_txn(p, rng) for _ in range(n_txns)]

    clean = []
    for m in range(n_txns + 2):
        s = FS(str(d / f"clean{m}"))
        s.mkfs()
        s.mount()
        for t in txns()[:m]:
            s.queue_transactions([t])
        clean.append(_fingerprint(s))
        s.umount()
    out = {}
    for n in range(1, n_txns + 2):
        for mode, survivors in (("after", n), ("before", n - 1)):
            path = str(d / f"kill_{mode}_{n}")
            s = FS(path)
            s.mkfs()
            s.mount()
            s.kill_at = n if mode == "after" else -n
            died = _raises(lambda: [s.queue_transactions([t])
                                    for t in txns()])
            s2 = FS(path)                    # crash: remount replays
            s2.mount()
            fp = _fingerprint(s2)
            s2.umount()
            assert died == "KilledAt" and fp == clean[survivors], (mode, n)
            out[mode, n] = (died, fp)
    assert KilledAt.__module__ == p.filestore.__name__
    return out


def test_filestore_kill_at_replay_sweep(tmp_path):
    out = _both(_replay_sweep, tmp_path)
    assert len(out) == 26


def _commit_crash(p, d, kind, point, skip):
    C, T = _c(p), p.Transaction
    path = d / "s"
    s = _open(p, kind, d, "s")
    s.apply_transaction(T().create_collection(C))       # durable
    stages, done = [], []
    s._committer.trace = lambda pt, n: stages.append(pt)
    s._committer.crash_at = point
    s._committer.crash_skip = skip
    for i in range(skip):                    # these groups commit
        s.apply_transaction(T().write(C, _o(p, f"kept{i}"), 0, b"k"))
    s.queue_transactions([T().write(C, _o(p), 0, b"doomed")],
                         on_commit=lambda: done.append(1))
    obs = [_raises(s.sync), s._committer.dead, done,
           _raises(lambda: s.queue_transactions(
               [T().write(C, _o(p, "after"), 0, b"x")])),
           s.read(C, _o(p)), stages]
    # a power cut: abandon without umount, reopen
    s2 = p.ObjectStore.create(kind, str(path))
    s2.mount()
    obs += [_fingerprint(s2), _raises(lambda: s2.read(C, _o(p)))]
    s2.umount()
    assert obs[:4] == ["StoreError", True, [], "StoreError"]
    assert obs[4] == b"doomed" and obs[-1] == "NoSuchObject"
    assert [e[1] for e in obs[6] if len(e) > 1] == [
        f"kept{i}" for i in range(skip)]
    return obs


@pytest.mark.parametrize("kind,point,skip", [
    ("blockstore", "before_data_sync", 0), ("blockstore", "before_kv", 0),
    ("blockstore", "before_kv", 1), ("kstore", "before_data_sync", 0),
    ("kstore", "before_kv", 1)])
def test_commit_thread_crash_leaves_the_same_state(tmp_path, kind, point,
                                                   skip):
    obs = _both(_commit_crash, tmp_path, kind, point, skip)
    stages = obs[5]
    if point == "before_kv":
        assert stages[-2:] == ["before_data_sync", "before_kv"]


def _bit_rot(p, d, csum):
    BS = p.blockstore.BlockStore
    C, O, T = _c(p), _o(p), p.Transaction
    path = str(d / "bs")
    s = BS(path, csum_type=csum)
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C)
                        .write(C, O, 0, b"precious-bytes" * 100))
    ext = s._get_onode(C, O).extents[0]
    s.umount()
    with open(os.path.join(path, "block"), "r+b") as f:
        f.seek(ext.disk + 7)
        b = f.read(1)
        f.seek(ext.disk + 7)
        f.write(bytes([b[0] ^ 0x40]))
    out = []
    for reader in BOTH:                      # each package reads the rot
        s2 = reader.blockstore.BlockStore(path)
        s2.mount()
        try:
            s2.read(C, O)
            out.append(None)
        except reader.StoreError as e:
            out.append(str(e))
        finally:
            s2.umount()
    assert out[0] == out[1] and "csum mismatch" in out[0]
    return out


@pytest.mark.parametrize("csum", ["crc32c", "xxhash32", "xxhash64"])
def test_bit_rot_is_detected_in_both(tmp_path, csum):
    _both(_bit_rot, tmp_path, csum)


def _csum_pin(p, d):
    BS = p.blockstore.BlockStore
    C, O, T = _c(p), _o(p), p.Transaction
    path = str(d / "bs")
    s = BS(path, csum_type="xxhash64")
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C).write(C, O, 0, b"a" * 9000))
    s.umount()
    s = BS(path, csum_type="crc32c")         # the pinned type wins
    s.mount()
    obs = [s._csum_name, s.read(C, O)]
    s.umount()
    # a store with onodes and no pin predates selectable csums: crc32c
    legacy = str(d / "legacy")
    s = BS(legacy)
    s.mkfs()
    s.mount()
    s.apply_transaction(T().create_collection(C).write(C, O, 0, b"b" * 9000))
    s.umount()
    db = p.FileDB(os.path.join(legacy, "db"))
    db.submit(db.create_transaction().rmkey("meta", b"csum_type"))
    db.close()
    s = BS(legacy, csum_type="xxhash32")
    s.mount()
    obs += [s._csum_name, s.read(C, O),
            _raises(lambda: BS(path, csum_type="md5"))]
    s.umount()
    assert obs[0] == "xxhash64" and obs[2] == "crc32c"
    return obs


def test_csum_type_pin_and_legacy_store(tmp_path):
    _both(_csum_pin, tmp_path)


# ------------------------------------------- lockdep names and the observer

def _lock_edges(p, d):
    ld = p.lockdep
    ld.reset()
    ld.enable()
    try:
        s = p.blockstore.BlockStore(str(d / "bs"))
        s.mkfs()
        s.mount()
        C, T = _c(p), p.Transaction
        s.apply_transaction(T().create_collection(C))
        for i in range(4):
            s.apply_transaction(T().write(C, _o(p, f"o{i}"), 0, b"x" * 5000))
        s.apply_transaction(T().write(C, _o(p, "o0"), 0, b"y" * 5000))
        s.umount()
        edges = sorted((a.replace(str(d), "<dir>"), b.replace(str(d),
                                                               "<dir>"))
                       for a, bs in ld.GRAPH.edges.items() for b in bs)
        return edges, [e.get("kind") for e in ld.report()]
    finally:
        ld.disable()
        ld.reset()


def test_lockdep_names_and_order_match_reference(tmp_path):
    edges, report = _both(_lock_edges, tmp_path)
    assert ("filedb:<dir>/bs/db:_io", "filedb:<dir>/bs/db:_mu") in edges
    assert report == []


def test_commit_observer_is_per_package(tmp_path):
    seen = {p.root: [] for p in BOTH}
    for p in BOTH:
        p.commit.OBSERVER = lambda name, ev, idx, r=p.root: \
            seen[r].append((name.split("#")[0], ev, len(idx)))
    try:
        s = _open(PORT, "memstore", tmp_path)
        s.apply_transaction(PORT.Transaction().create_collection(_c(PORT)))
        s.queue_transactions([PORT.Transaction().touch(_c(PORT),
                                                       _o(PORT))],
                             on_commit=lambda: None)
        s.sync()
        s.umount()
    finally:
        for p in BOTH:
            p.commit.OBSERVER = None
    assert seen["ceph_tpu"] == []
    assert ("memstore_commit", "committed", 1) in seen["ceph_tpu_torch"]
    assert ("memstore_commit", "callbacks", 1) in seen["ceph_tpu_torch"]


# --------------------------------------- chip_smoke's store phase, tiny

def test_chip_smoke_store_phase_on_the_cpu(tmp_path, capsys):
    """The script's store phase at a tiny size on the CPU (the queue
    forced onto the plain apply, the host CRUSH engine): every chunk
    reads back after a remount equal to the CPU codec's, two lost OSDs
    are rebuilt, OSD 0's chunks round-trip through the other backends,
    and the zlib store keeps the random chunks raw."""
    import torch

    import chip_smoke
    from ceph_tpu_torch.ec import kernel
    rng = np.random.default_rng(7)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(8)]
    out = chip_smoke.store_phase(np, kernel, torch.device("cpu"), "cpu",
                                 objects, str(tmp_path), engine="host")
    assert out["d1_launches"] == 0 and out["encode_launches"] == 0
    assert out["objects_losing_two_data"] > 0
    assert len(out["mount_s"]) == chip_smoke.STORE_OSDS
    assert sum(c["txns"] for c in out["counters"]) == 8 * 12
    assert set(out["share"]) == {"kstore", "filestore", "memstore",
                                 "blockstore zlib"}
    assert out["share"]["blockstore zlib"]["compressed_extents"] == 0
    text = capsys.readouterr().out
    assert "phase store rebuild" in text and "each equal" in text


def test_chip_smoke_store_phase_fails_on_a_wrong_chunk(tmp_path,
                                                       monkeypatch):
    """A chunk that reads back different from the CPU codec's fails the
    phase."""
    import torch

    import chip_smoke
    from ceph_tpu_torch.ec import kernel
    from ceph_tpu_torch.store.blockstore import BlockStore
    real = BlockStore.read

    def rotten(self, cid, oid, off=0, length=-1):
        data = real(self, cid, oid, off, length)
        return bytes([data[0] ^ 1]) + data[1:] if oid.shard == 3 else data

    monkeypatch.setattr(BlockStore, "read", rotten)
    rng = np.random.default_rng(8)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(4)]
    with pytest.raises(chip_smoke.SmokeFailure, match="differ"):
        chip_smoke.store_phase(np, kernel, torch.device("cpu"), "cpu",
                               objects, str(tmp_path), engine="host")
