"""The port's object classes (``ceph_tpu_torch.cls``) against the JAX
package's, method by method and case by case.

- the registry: both packages register the same ``class.method`` names
  with the same write flags, each in its own ``_METHODS``, and a port
  class module registers into the port's registry only;
- every method called directly: one table of calls, valid and invalid
  inputs made from a seed with numpy, runs in each package against a
  MemStore-backed ``ClsContext``; each call's (rval, outdata), the
  exception it raised, and the wire bytes of the logical ops it staged
  must be equal, and so must the stores after the staged ops of each
  call are applied through the package's own ``build_write_txn``.  The
  table reaches every registered method, the ones no cluster case calls
  among them (``timeindex``, ``inotable``, ``rbd``'s snaps and children,
  ``rgw.usage_add``, ``rgw.dir_suggest_changes``,
  ``rgw.bucket_rebuild_index``);
- an ``OP_CALL`` op with its result crosses between the packages as the
  same bytes both ways, and a guarded-write vector and its reply cross
  the process lanes' envelopes (parent -> lane, lane -> parent)
  unchanged, in and between the packages;
- the reference's class cases of ``tests/test_cls_misc.py`` (all 7) and
  ``tests/test_cls_rgw.py`` (3: the gateway's case waits for the port of
  ``services/rgw``) run once per package on the harness of
  ``test_torch_osd`` with equal observations: every ``IoCtx`` outcome and
  the stores at each cluster stop.

``version.inc`` mints its tag with ``secrets.token_hex``: for each run
both packages' ``cls.version`` draw it from the same seeded sequence, so
the ``exec`` outputs and the ``ceph.objclass.version`` xattr in the store
images compare exactly.  ``cls.lock`` reads ``time.time()`` for a locker
with a ``duration``: the direct calls give both packages the same clock,
which the table moves forward to expire a locker.

Each test holds itself to a deadline of 60 s (``deadline``, one fixture
for the file).  Tolerance 0: every comparison is exact.
"""

from __future__ import annotations

import errno
import importlib
import json
import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_osd import BOTH, PORT, REF, run_case
from test_torch_osd_lanes import deadline

ROOT = pathlib.Path(__file__).parent.parent

@pytest.fixture(autouse=True)
def _deadline():
    """Every test of this file holds itself to 60 s."""
    with deadline(60):
        yield


#: the seed of the tags ``version.inc`` mints in a pinned run
TAG_SEED = 20261018


def pin_cls(mp: pytest.MonkeyPatch, root: str, clock=None) -> None:
    """Give ``root``'s ``cls.version`` a seeded tag sequence and, with
    ``clock``, ``cls.lock`` that clock, for as long as ``mp`` lasts."""
    version = importlib.import_module(root + ".cls.version")
    rng = np.random.default_rng(TAG_SEED)
    mp.setattr(version, "secrets",
               SimpleNamespace(token_hex=lambda n: rng.bytes(n).hex()))
    if clock is not None:
        lock = importlib.import_module(root + ".cls.lock")
        mp.setattr(lock, "time", SimpleNamespace(time=lambda: clock[0]))


def observe(name: str, case: str, root: str):
    """``run_case`` with ``root``'s class tags pinned."""
    with pytest.MonkeyPatch.context() as mp:
        pin_cls(mp, root)
        return run_case(name, case, root)


def both_pinned(name: str, case: str):
    want = observe(name, case, REF)
    got = observe(name, case, PORT)
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got


# ---------------------------------------------------------------- registry

def _registry(root):
    cls = importlib.import_module(root + ".cls")
    return {name: writes for name, (_, writes) in cls._METHODS.items()}


def test_both_packages_register_the_same_methods():
    want, got = _registry(REF), _registry(PORT)
    assert got == want
    assert len(got) == 65
    # each package's class modules register in their own package
    import ceph_tpu.cls as ref_cls
    import ceph_tpu_torch.cls as port_cls
    assert ref_cls._METHODS is not port_cls._METHODS
    for name, (fn, _) in port_cls._METHODS.items():
        assert fn.__module__.startswith("ceph_tpu_torch.cls."), name
        assert ref_cls._METHODS[name][0] is not fn
    # the OSDOp's route follows the port's registry
    from ceph_tpu_torch.osd.messages import OP_CALL, OSDOp
    for name, writes in got.items():
        assert OSDOp(OP_CALL, name=name).is_write() is writes
    assert OSDOp(OP_CALL, name="nope.method").is_write()


def test_the_class_modules_import_nothing_of_the_jax_package():
    for path in sorted((ROOT / "ceph_tpu_torch" / "cls").glob("*.py")):
        src = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(jax|ceph_tpu)\b(?!_torch)",
                             src, re.M), path.name


# ------------------------------------------------------- the direct calls

def _word(rng, prefix="k"):
    return f"{prefix}{int(rng.integers(1 << 30)):08x}"


def _ts(rng):
    return float(np.round(rng.uniform(1e9, 2e9), 6))


def _table(rng):
    """The calls, in order: ``(oid, method, input)`` rows, with
    ``("!create", oid, data)``, ``("!omap", oid, kv)`` and
    ``("!clock", seconds)`` rows that set up the store or move the lock
    clock in both packages alike, and ``(oid, method, input, "ro")`` rows
    that call without a write context."""
    j = lambda d: json.dumps(d).encode()          # noqa: E731
    rows = []
    add = rows.append

    # lock: exclusive, shared, renew, break, expiry
    name, a, b = _word(rng, "l"), _word(rng, "e"), _word(rng, "e")
    req = {"name": name, "type": "exclusive", "entity": a, "cookie": "c1"}
    for r in ({"name": name}, req, req, dict(req, entity=b),
              dict(req, renew=True, duration=30),
              dict(req, renew=True), {"name": name}):
        add(("lk", "lock.lock" if "entity" in r else "lock.get_info", j(r)))
    add(("lk", "lock.unlock", j({"name": name, "entity": b,
                                 "cookie": "c1"})))
    add(("lk", "lock.unlock", j({"name": name, "entity": a,
                                 "cookie": "c1"})))
    shared = {"name": name, "type": "shared", "cookie": "s"}
    add(("lk", "lock.lock", j(dict(shared, entity=a))))
    add(("lk", "lock.lock", j(dict(shared, entity=b))))
    add(("lk", "lock.lock", j(dict(req, entity="x"))))
    add(("lk", "lock.break_lock", j({"name": name, "entity": b,
                                     "cookie": "s"})))
    add(("lk", "lock.break_lock", j({"name": name, "entity": "x",
                                     "cookie": "s"})))
    add(("lk", "lock.get_info", j({"name": name})))
    ttl = int(rng.integers(5, 50))
    add(("lk", "lock.lock", j({"name": "t", "entity": a, "duration": ttl})))
    add(("lk", "lock.lock", j({"name": "t", "entity": b})))
    add(("!clock", ttl + 1))
    add(("lk", "lock.lock", j({"name": "t", "entity": b})))
    add(("lk", "lock.get_info", j({"name": "t"})))

    # version: mint, conditions, set, check
    ver = int(rng.integers(2, 1000))
    tag = _word(rng, "t")
    add(("ver", "version.read", b""))
    add(("ver", "version.inc", b""))
    add(("ver", "version.inc", j({"conds": [{"cond": "eq", "ver": 1}]})))
    add(("ver", "version.inc", j({"conds": [{"cond": "eq", "ver": 1}]})))
    add(("ver", "version.inc", j({"conds": [{"cond": "gt", "ver": 5}]})))
    add(("ver", "version.set", j({"ver": ver, "tag": tag})))
    for cond in ({"cond": "eq", "ver": ver}, {"cond": "gt", "ver": ver},
                 {"cond": "ge", "ver": ver}, {"cond": "tag_eq", "tag": tag},
                 {"cond": "tag_ne", "tag": tag}, {"cond": "none"},
                 {"cond": "ver_eq", "ver": ver + 1}):
        add(("ver", "version.check_conds", j({"conds": [cond]})))
    add(("ver", "version.inc", j({"conds": [{"cond": "ver_eq", "ver": 0}]})))
    add(("ver", "version.read", b""))
    add(("ver2", "version.inc", j({"conds": [{"cond": "eq", "ver": 0}]})))
    add(("ver2", "version.read", b""))

    # refcount: implicit ref, tags, set, last put deletes
    t1, t2 = _word(rng, "r"), _word(rng, "r")
    add(("rc", "refcount.get", j({"tag": t1})))
    add(("rc", "refcount.read", b""))
    add(("!create", "rc", rng.bytes(int(rng.integers(1, 4096)))))
    for method, r in (("get", t1), ("get", t2), ("get", t1), ("read", None),
                      ("put", t1), ("put", "zz"), ("read", None)):
        add(("rc", f"refcount.{method}", j({"tag": r}) if r else b""))
    add(("rc", "refcount.set", j({"tags": [t1, t2]})))
    add(("rc", "refcount.put", j({"tag": t1})))
    add(("rc", "refcount.put", j({"tag": t2})))
    add(("rc", "refcount.read", b""))
    add(("rc", "refcount.get", j({"tag": t1})))
    add(("rc", "refcount.set", j({"tags": [t1]})))
    add(("rc", "refcount.put", j({"tag": t1})))

    # rbd: header, size, snaps, protection, children, parent; directory
    size = int(rng.integers(1, 1 << 40))
    hdr = {"size": size, "order": 22, "stripe_unit": 1 << 22,
           "stripe_count": 1}
    s1, s2 = _word(rng, "s"), _word(rng, "s")
    for method, r in (
            ("get_header", None), ("set_size", {"size": 1}),
            ("snap_add", {"id": 1, "name": s1, "size": 1}),
            ("set_parent", {"pool": 1}), ("create_header", hdr),
            ("create_header", hdr), ("get_header", None),
            ("set_size", {"size": size // 2}),
            ("snap_add", {"id": 5, "name": s1, "size": size}),
            ("snap_add", {"id": 7, "name": s1, "size": size}),
            ("snap_add", {"id": 3, "name": s2, "size": size}),
            ("snap_add", {"id": 9, "name": s2, "size": size // 2}),
            ("snap_protect", {"name": s1}), ("snap_protect", {"name": "zz"}),
            ("snap_rm", {"name": s1}),
            ("child_add", {"snap_id": 5, "child": "c1"}),
            ("child_add", {"snap_id": 5, "child": "c1"}),
            ("child_add", {"snap_id": 9, "child": "c2"}),
            ("snap_unprotect", {"name": s1}),
            ("child_list", {"snap_id": 5}), ("child_list", None),
            ("child_rm", {"snap_id": 5, "child": "c1"}),
            ("child_rm", {"snap_id": 5, "child": "c1"}),
            ("snap_unprotect", {"name": s1}),
            ("snap_unprotect", {"name": "zz"}),
            ("snap_rm", {"name": s1}), ("snap_rm", {"name": s1}),
            ("get_snaps", None),
            ("set_parent", {"pool": 2, "pool_name": "p", "image": "i",
                            "snap_id": 9, "snap_name": s2,
                            "overlap": size // 4}),
            ("set_parent", {"pool": 2}), ("get_header", None),
            ("remove_parent", None), ("remove_parent", None),
            ("get_header", None)):
        add(("hdr", f"rbd.{method}", j(r) if r is not None else b""))
    img = [_word(rng, "img") for _ in range(3)]
    for method, r in (("dir_list", None), ("dir_add", img[0]),
                      ("dir_add", img[0]), ("dir_add", img[1]),
                      ("dir_add", img[2]), ("dir_remove", "zz"),
                      ("dir_remove", img[1]), ("dir_list", None)):
        add(("dir", f"rbd.{method}", j({"name": r}) if r else b""))

    # journal: registration, monotonic commits, CAS rotation, trims
    seq = int(rng.integers(10, 100))
    add(("jr", "journal.client_register", j({"id": "m1"})))
    add(("!create", "jr", b""))
    for method, r in (("get_meta", None), ("advance_active",
                                          {"expect": 0, "to": 1}),
                      ("trim_to", {"to": 1}),
                      ("client_register", {"id": "m1"}),
                      ("client_commit", {"id": "m1", "seq": seq}),
                      ("client_commit", {"id": "m1", "seq": seq // 2}),
                      ("client_register", {"id": "m1"}),
                      ("client_commit", {"id": "ghost", "seq": 1})):
        add(("jr", f"journal.{method}", j(r) if r else b""))
    add(("!omap", "jr", {b"first_obj": b"0", b"active_obj": b"0"}))
    for method, r in (("advance_active", {"expect": 5, "to": 6}),
                      ("advance_active", {"expect": 0, "to": 1}),
                      ("trim_to", {"to": 3}), ("trim_to", {"to": 1}),
                      ("get_meta", None)):
        add(("jr", f"journal.{method}", j(r) if r else b""))

    # numops: add, mul, bad operands, a bad stored value, overflow
    x = _word(rng, "n")
    for method, r in (("add", {"key": x, "value": float(rng.uniform(-9, 9))}),
                      ("add", {"key": x, "value": 1}),
                      ("mul", {"key": x, "value": int(rng.integers(2, 9))}),
                      ("mul", {"key": "y", "value": 3}),
                      ("add", {"key": x, "value": "abc"}),
                      ("add", {"key": x, "value": None}),
                      ("add", {"key": "bad", "value": 1}),
                      ("mul", {"key": "big", "value": 1e308}),
                      ("add", {"key": "big", "value": 1}),
                      ("mul", {"key": "big", "value": 1e308}),
                      ("mul", {"key": "big", "value": 1e308})):
        if r["key"] == "bad" and method == "add":
            add(("!omap", "num", {b"bad": b"notnum"}))
        add(("num", f"numops.{method}", j(r)))

    # rgw: the bucket index, its repairs, reshard installs, usage
    keys = sorted(_word(rng, "obj") for _ in range(6))
    sizes = [int(rng.integers(1, 1 << 20)) for _ in keys]
    entry = lambda i: {"size": sizes[i], "etag": f"e{i}",      # noqa: E731
                       "mtime": float(i)}
    for method, r in (
            ("bucket_read_header", None), ("bucket_list", None),
            ("bucket_init", None), ("bucket_init", None),
            ("bucket_prepare_op", {"tag": "t1", "op": "put", "key": keys[0],
                                   "ts": 1.5}),
            ("bucket_prepare_op", {"tag": "t2", "key": "\x01x"}),
            ("bucket_prepare_op", {"op": "put", "key": keys[1]}),
            ("bucket_complete_op", {"tag": "t1", "op": "put",
                                    "key": keys[0], "entry": entry(0)}),
            ("bucket_complete_op", {"op": "put", "key": keys[1],
                                    "entry": entry(1)}),
            ("bucket_complete_op", {"op": "put", "key": keys[2],
                                    "entry": entry(2)}),
            ("bucket_complete_op", {"op": "put", "key": keys[0],
                                    "entry": entry(3),
                                    "observed": {"etag": "old"}}),
            ("bucket_complete_op", {"op": "put", "key": keys[5],
                                    "entry": entry(5),
                                    "observed": {"etag": "e5"}}),
            ("bucket_complete_op", {"op": "put", "key": keys[0],
                                    "entry": entry(4),
                                    "observed": {"etag": "e0"}}),
            ("bucket_complete_op", {"op": "del", "key": keys[1],
                                    "observed": {"etag": "e1"}}),
            ("bucket_complete_op", {"op": "del", "key": keys[2],
                                    "observed": {"etag": "zz"}}),
            ("bucket_complete_op", {"op": "del", "key": "ghost"}),
            ("bucket_complete_op", {"op": "cancel", "key": "k"}),
            ("bucket_complete_op", {"op": "put", "key": "\x01x"}),
            ("bucket_prepare_op", {"tag": "t9", "op": "del", "key": keys[2],
                                   "ts": 9.0}),
            ("bucket_list", None), ("bucket_list", {"max_keys": 1}),
            ("bucket_list", {"marker": keys[0]}),
            ("bucket_list", {"prefix": keys[2][:6]}),
            ("bucket_read_header", None), ("bucket_check", None),
            ("dir_suggest_changes", {
                "changes": [{"op": "remove", "key": keys[0],
                             "observed": {"etag": "zz"}},
                            {"op": "remove", "key": keys[2],
                             "observed": {"etag": "e2"}},
                            {"op": "remove", "key": keys[2]},
                            {"op": "update", "key": keys[4],
                             "entry": entry(4)},
                            {"op": "remove", "key": "\x01p"}],
                "expire_tags": ["t9", "nope"]}),
            ("bucket_check", None), ("bucket_rebuild_index", None),
            ("bucket_install_entries", {"entries": {
                keys[3]: entry(3), keys[4]: entry(1), "\x01bad": {}}}),
            ("bucket_read_header", None), ("bucket_list", None)):
        add(("idx", f"rgw.{method}", j(r) if r is not None else b""))
    add(("legacy", "rgw.bucket_rebuild_index", b""))
    rows_in = [{"key": f"{keys[i % 2]}", "ops": int(rng.integers(1, 9)),
                "successful_ops": 1, "bytes_sent": int(rng.integers(1 << 20)),
                "bytes_received": int(rng.integers(1 << 20))}
               for i in range(3)]
    add(("usage", "rgw.usage_add", j({"rows": rows_in})))
    add(("usage", "rgw.usage_add", j({"rows": rows_in[:1]})))
    add(("usage", "rgw.usage_add", j({"rows": []})))

    # log: append, ranged and paged lists, trims
    ts = sorted(_ts(rng) for _ in range(6))
    add(("log", "log.info", b""))
    add(("log", "log.add", j({"entries": [
        {"ts": t, "section": "s", "name": _word(rng, "n"), "data": i}
        for i, t in enumerate(ts[:4])]})))
    add(("log", "log.add", j({"entries": [{"ts": t} for t in ts[4:]]})))
    add(("log", "log.add", j({"entries": []})))
    for method, r in (("list", None), ("list", {"max_entries": 2}),
                      ("list", {"from_ts": ts[1], "to_ts": ts[4]}),
                      ("info", None), ("trim", {"to_ts": ts[2]}),
                      ("trim", {"to_ts": ts[2]}),
                      ("trim", {"from_ts": ts[5], "to_ts": ts[5] + 1}),
                      ("list", None), ("trim", None), ("trim", None),
                      ("info", None)):
        add(("log", f"log.{method}", j(r) if r else b""))

    # timeindex: append, ranged and paged lists, marker trims
    add(("ti", "timeindex.add", j({"entries": [
        {"ts": t, "key_ext": _word(rng, "x"), "value": {"i": i}}
        for i, t in enumerate(ts)]})))
    add(("ti", "timeindex.add", j({"entries": []})))
    for method, r in (("list", None), ("list", {"max_entries": 4}),
                      ("list", {"from_ts": ts[2], "to_ts": ts[5]}),
                      ("trim", {"to_ts": ts[1]}), ("trim", {"to_ts": ts[1]}),
                      ("list", {"marker": "0"}), ("trim", None),
                      ("trim", None), ("list", None)):
        add(("ti", f"timeindex.{method}", j(r) if r else b""))

    # user: bucket stats, resync, listing, removal
    buckets = [{"bucket": _word(rng, "b"), "size": int(rng.integers(1 << 30)),
                "count": int(rng.integers(100)), "creation_ts": _ts(rng)}
               for _ in range(4)]
    for method, r in (("get_header", None),
                      ("set_buckets", {"entries": buckets[:3], "add": True,
                                       "ts": 5.0}),
                      ("set_buckets", {"entries": [dict(buckets[0],
                                                        creation_ts=1.0)],
                                       "add": True, "ts": 6.0}),
                      ("set_buckets", {"entries": [buckets[3]], "add": False,
                                       "ts": 7.0}),
                      ("list_buckets", None),
                      ("list_buckets", {"max_entries": 2}),
                      ("list_buckets", {"marker": buckets[1]["bucket"]}),
                      ("remove_bucket", {"bucket": buckets[2]["bucket"]}),
                      ("remove_bucket", {"bucket": "ghost"}),
                      ("get_header", None)):
        add(("usr", f"user.{method}", j(r) if r else b""))

    # statelog: three indexes, escapes, guards
    ents = [{"client_id": c, "op_id": o, "object": b, "state": s,
             "ts": float(i), "data": {"i": i}}
            for i, (c, o, b, s) in enumerate((
                ("c_1", "op%1", "a_1", "pending"), ("c_1", "op2", "a", "done"),
                ("c2", "op3", "a_1", "pending")))]
    add(("sl", "statelog.add", j({"entries": ents})))
    for method, r in (("list", None), ("list", {"client_id": "c_1"}),
                      ("list", {"op_id": "op%1"}), ("list", {"object": "a"}),
                      ("list", {"max_entries": 1}),
                      ("check_state", dict(ents[0], state="pending")),
                      ("check_state", dict(ents[0], state="done")),
                      ("check_state", dict(ents[0], object="zz")),
                      ("remove", ents[1]), ("remove", ents[1]),
                      ("list", None)):
        add(("sl", f"statelog.{method}", j(r) if r else b""))

    # replica_log: bounds by entity, the oldest wins
    for method, r in (("get_bounds", None),
                      ("set_bound", {"entity_id": "a", "position_marker": "m5",
                                     "position_time": 5.0,
                                     "items": [{"name": "x", "ts": 4.0}]}),
                      ("set_bound", {"entity_id": "a", "position_marker": "m3",
                                     "position_time": 3.0}),
                      ("set_bound", {"entity_id": "b", "position_marker": "m4",
                                     "position_time": 4.0}),
                      ("set_bound", {"entity_id": "b", "position_marker": "m2",
                                     "position_time": 2.0}),
                      ("get_bounds", None), ("delete_bound", {"entity_id": "a"}),
                      ("delete_bound", {"entity_id": "a"}),
                      ("get_bounds", None)):
        add(("rl", f"replica_log.{method}", j(r) if r else b""))

    # inotable: block allocation, the snap table
    for method, r in (("alloc_block", None),
                      ("alloc_block", {"count": int(rng.integers(2, 99))}),
                      ("alloc_block", {"count": 0}),
                      ("snap_update", {"add": 5}), ("snap_update", {"add": 3}),
                      ("snap_update", {"rm": 5}), ("snap_update", None),
                      ("alloc_block", None)):
        add(("ino", f"inotable.{method}", j(r) if r else b""))

    # every method: malformed inputs, and a write method without a write
    # context (a read-class route); an unknown method
    for method in sorted(_registry(PORT)):
        for inbl in (b"", b"{", b"[]", b"{}"):
            add(("bad", method, inbl))
        add(("bad2", method, b"{}", "ro"))
    add(("bad", "nope.method", b"{}"))
    return rows


def run_table(root: str, rows):
    """Every row in ``root``'s package: each call's outcome and staged ops
    (wire bytes), and the store afterwards."""
    cls = importlib.import_module(root + ".cls")
    backend = importlib.import_module(root + ".osd.backend")
    MemStore = importlib.import_module(root + ".store.memstore").MemStore
    objectstore = importlib.import_module(root + ".store.objectstore")
    types_ = importlib.import_module(root + ".store.types")
    store = MemStore()
    store.mkfs()
    store.mount()
    cid = types_.CollectionId.pg(1, 0)
    txn = objectstore.Transaction()
    txn.create_collection(cid)
    store.apply_transaction(txn)
    clock = [1.7e9]
    seen = []

    def soid(oid):
        return types_.ObjectId(oid, pool=1)

    with pytest.MonkeyPatch.context() as mp:
        pin_cls(mp, root, clock)
        for row in rows:
            if row[0] == "!clock":
                clock[0] += row[1]
                continue
            txn = objectstore.Transaction()
            if row[0] == "!create":
                txn.touch(cid, soid(row[1]))
                txn.write(cid, soid(row[1]), 0, row[2])
                store.apply_transaction(txn)
                continue
            if row[0] == "!omap":
                txn.touch(cid, soid(row[1]))
                txn.omap_setkeys(cid, soid(row[1]), row[2])
                store.apply_transaction(txn)
                continue
            oid, method, inbl = row[:3]
            staged = None if row[3:] == ("ro",) else []
            hctx = cls.ClsContext(store, cid, soid(oid), staged=staged)
            try:
                rv, out = cls.call(method, hctx, inbl)
                res = ("ok", rv, out)
            except Exception as e:              # noqa: BLE001
                rv, res = -1, ("raise", type(e).__name__, str(e))
            ops = [op.to_bytes() for op in staged or ()]
            seen.append((oid, method, inbl, res, ops))
            if rv >= 0 and staged:
                result, _ = backend.build_write_txn(
                    store, cid, soid(oid), staged, txn)
                assert result >= 0
                store.apply_transaction(txn)
    image = []
    for o in store.collection_list(cid):
        hdr, omap = store.omap_get(cid, o)
        image.append((o.name, store.read(cid, o),
                      sorted(store.getattrs(cid, o).items()), hdr,
                      sorted(omap.items())))
    return seen, image


def test_every_method_called_directly_answers_as_the_reference():
    rows = _table(np.random.default_rng(12))
    want = run_table(REF, rows)
    got = run_table(PORT, rows)
    called = {row[1] for row in rows if not row[0].startswith("!")}
    assert called >= set(_registry(PORT))
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert g == w, g[:3]
    assert got[1] == want[1]
    # the table reaches each method's answers beyond the malformed ones
    answered = {(m, res[1]) for _, m, _, res, _ in got[0] if res[0] == "ok"}
    for name in _registry(PORT):
        assert (name, 0) in answered, name
    rvals = {res[1] for _, _, _, res, _ in got[0] if res[0] == "ok"}
    assert rvals >= {0, -errno.ENOENT, -errno.EEXIST, -errno.EBUSY,
                     -errno.ECANCELED, -errno.ESTALE, -errno.EINVAL,
                     -errno.EBADMSG, -errno.EOVERFLOW, -errno.ENODATA,
                     -errno.EROFS, -errno.EOPNOTSUPP}


def test_an_unknown_condition_passes_in_both_packages():
    """``cls.version._check`` skips a condition kind it does not know
    (Ceph's ``cls_version`` fails one): ``ver_eq`` guards nothing in the
    JAX package, and the port keeps that."""
    rows = [("ver", "version.inc", b""),
            ("ver", "version.inc",
             json.dumps({"conds": [{"cond": "ver_eq", "ver": 0}]}).encode()),
            ("ver", "version.read", b"")]
    for root in BOTH:
        seen, _ = run_table(root, rows)
        assert seen[1][3] == ("ok", 0, b"")
        assert json.loads(seen[2][3][2])["ver"] == 2


def test_a_class_call_crosses_between_the_packages_as_the_same_bytes():
    from ceph_tpu.osd import messages as ref
    from ceph_tpu_torch.osd import messages as port
    rng = np.random.default_rng(13)
    for mod, other in ((ref, port), (port, ref)):
        op = mod.OSDOp(mod.OP_CALL, name="rgw.bucket_list",
                       data=rng.bytes(64))
        op.rval = -errno.ECANCELED
        op.outdata = rng.bytes(32)
        blob = op.to_bytes()
        back = other.OSDOp.from_bytes(blob)
        assert (back.op, back.name, bytes(back.data), back.rval,
                back.outdata) == (op.op, op.name, op.data, op.rval,
                                  op.outdata)
        assert back.to_bytes() == blob


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF),
                                           (PORT, PORT)])
def test_a_class_vector_crosses_the_lane_rings_unchanged(writer, reader,
                                                        monkeypatch):
    """A guarded-write vector in the parent -> lane envelope, and its
    reply with each op's rval and outdata in the lane -> parent frame:
    what one package writes the other reads, and writes again as the same
    bytes."""
    rng = np.random.default_rng(14)
    data, out = rng.bytes(4096), rng.bytes(48)
    frames = {}
    for root in {writer, reader}:
        lanes = importlib.import_module(root + ".osd.lanes")
        monkeypatch.setattr(lanes.time, "monotonic", lambda: 7.5)
        msgs = importlib.import_module(root + ".osd.messages")
        types_ = importlib.import_module(root + ".msg.types")
        ops = [msgs.OSDOp(msgs.OP_CALL, name="version.inc",
                          data=b'{"conds": [{"cond": "eq", "ver": 0}]}'),
               msgs.OSDOp(msgs.OP_WRITEFULL, length=len(data), data=data)]
        m = msgs.MOSDOp(pgid=importlib.import_module(
            root + ".osd.types").PGId(2, 5), oid="g0", tid=11, ops=ops)
        m.src_name = types_.EntityName("client", "9")
        m.src_addr = types_.EntityAddr("127.0.0.1", 6801, nonce=1)
        for o, rval in zip(ops, (-errno.ECANCELED, 0)):
            o.rval, o.outdata = rval, out
        reply = msgs.MOSDOpReply(11, -errno.ECANCELED, ops, 6)
        reply.src_name = types_.EntityName("osd", "1")
        addr = types_.EntityAddr("127.0.0.1", 6802, nonce=2)
        frames[root] = (lanes, lanes.encode_msg_envelope(m),
                        lanes.encode_out_frame(reply, addr, "client"))
    w, r = frames[writer], frames[reader]
    got = r[0].decode_msg_envelope(w[1])
    rmsgs = importlib.import_module(reader + ".osd.messages")
    assert [(o.op, o.name, bytes(o.data)) for o in got.ops] == [
        (rmsgs.OP_CALL, "version.inc",
         b'{"conds": [{"cond": "eq", "ver": 0}]}'),
        (rmsgs.OP_WRITEFULL, "", data)]
    assert r[0].encode_msg_envelope(got) == w[1] == r[1]
    rep, addr, peer, _ = r[0].decode_out_frame(w[2])
    assert rep.result == -errno.ECANCELED
    assert [(o.rval, o.outdata) for o in rep.ops] == [
        (-errno.ECANCELED, out), (0, out)]
    assert r[0].encode_out_frame(rep, addr, peer) == w[2] == r[2]


# ---------------------------------------------- the reference's class cases

CLS_RGW = ("test_prepare_complete_and_header_stats",
           "test_list_pagination_and_prefix",
           "test_crash_repair_suggest_and_rebuild")
CLS_MISC = ("test_cls_version_set_inc_conds", "test_cls_numops_add_mul_errors",
            "test_cls_timeindex_add_list_trim", "test_cls_log_header_high_water",
            "test_cls_user_stats_and_listing",
            "test_cls_statelog_indexes_and_guard",
            "test_cls_replica_log_bounds")


@pytest.mark.parametrize("case", CLS_MISC)
def test_cls_misc_case_matches_reference(case):
    both_pinned("test_cls_misc", case)


@pytest.mark.parametrize("case", CLS_RGW)
def test_cls_rgw_case_matches_reference(case):
    both_pinned("test_cls_rgw", case)


def test_cls_rgw_gateway_case_matches_reference():
    """``test_cls_rgw.py``'s gateway case, now that the port carries the
    S3 gateway: its services on the same pinned clock and tokens."""
    from test_torch_rbd import both_services
    both_services("test_cls_rgw", "test_gateway_rides_cls_index")


def test_the_cases_named_are_the_reference_files_cases():
    from test_torch_osd import cases
    assert set(cases("test_cls_misc")) == set(CLS_MISC)
    assert set(cases("test_cls_rgw")) == set(CLS_RGW) | {
        "test_gateway_rides_cls_index"}


# ------------------------------------------- a repair: absent xattrs on BlockStore

def _blockstore_call(root, path, method, inbl=b""):
    """``method`` on a fresh object of a BlockStore of ``root``'s package."""
    cls = importlib.import_module(root + ".cls")
    BlockStore = importlib.import_module(root + ".store.blockstore").BlockStore
    objectstore = importlib.import_module(root + ".store.objectstore")
    types_ = importlib.import_module(root + ".store.types")
    store = BlockStore(str(path), csum_type="crc32c")
    store.mkfs()
    store.mount()
    try:
        cid, soid = types_.CollectionId.pg(1, 0), types_.ObjectId("o", pool=1)
        txn = objectstore.Transaction()
        txn.create_collection(cid)
        txn.touch(cid, soid)
        txn.write(cid, soid, 0, b"data")
        store.apply_transaction(txn)
        staged = [] if cls.method_is_write(method) else None
        return cls.call(method, cls.ClsContext(store, cid, soid, staged),
                        inbl), staged
    finally:
        store.umount()


def test_a_class_reads_an_absent_xattr_on_a_blockstore(tmp_path):
    """An object's first ``version.inc``, ``lock.lock`` or
    ``refcount.get`` reads an xattr the object does not have yet: on the
    OSD's BlockStore the port answers as on a MemStore."""
    for i, (method, inbl) in enumerate((
            ("version.read", b""), ("version.inc", b""),
            ("lock.get_info", b'{"name": "l"}'),
            ("lock.lock", b'{"name": "l", "entity": "a"}'),
            ("refcount.get", b'{"tag": "a"}'))):
        (rv, out), staged = _blockstore_call(PORT, tmp_path / str(i),
                                             method, inbl)
        assert rv == 0, method
        assert staged is None or staged, method
    (rv, out), _ = _blockstore_call(PORT, tmp_path / "r", "version.read")
    assert json.loads(out) == {"ver": 0, "tag": ""}


def test_the_jax_package_fails_a_class_read_of_an_absent_xattr_on_a_blockstore(
        tmp_path):
    """The fault the port repairs: ``ClsContext.getxattr`` catches what
    MemStore and KStore raise for an absent xattr, not BlockStore's
    ``StoreError``, which escapes ``cls.call`` (on an OSD it fails the op
    and the client waits out its timeout)."""
    from ceph_tpu.store.objectstore import StoreError
    with pytest.raises(StoreError, match="no attr"):
        _blockstore_call(REF, tmp_path, "version.read")
