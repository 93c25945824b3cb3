"""The port's object classes on clusters of port OSDs, held against the JAX
package's.

- the six cluster cases of ``tests/test_cls.py`` run once per package
  with equal observations (every ``IoCtx`` outcome, the stores at each
  cluster stop): ``lock`` and ``rbd``'s directory on a replicated pool,
  ``lock`` on an EC pool, ``refcount``, ``journal`` (through each
  package's own ``Journaler``), and the two RBD cases (the exclusive
  lock under contending clients, the image header through ``cls rbd``),
  whose services run on the same pinned clock and tokens
  (``test_torch_rbd.pin_services``);
- a class-guarded EC write on an RS k=2 m=2 pool: ``[OP_CALL version.inc
  {ver eq 0}, OP_WRITEFULL]`` on objects written before, the same guard
  again carrying the first contents (each answers -ECANCELED), the
  objects read back and their versions read: the replies, the data, the
  versions and the store images are equal in both packages, and in the
  port the staged ``write_full`` is encoded by the EC batch queue;
- the same class calls and guarded write on a port cluster whose OSDs run
  two process lanes each, against the same on thread lanes: every answer
  equal (the tags, which each worker mints from its own ``secrets``, are
  compared by form only).

``version.inc``'s tags are pinned as in ``test_torch_cls``.  Each test
holds itself to a deadline of 60 s (``deadline``).  Tolerance 0.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import importlib
import json
import re
import sys
import types

import numpy as np
import pytest

from test_torch_cls import observe, pin_cls
from test_torch_osd import (PORT, REF, TESTS, case_module, cpu_defaults,
                            install_ref_backoff, port_source, store_image)
from test_torch_rbd import both_services
from test_torch_osd_lanes import deadline


@pytest.fixture(autouse=True)
def _deadline():
    """Every test of this file holds itself to 60 s."""
    with deadline(60):
        yield


# ------------------------------------------------------ tests/test_cls.py

#: the cases of tests/test_cls.py that use no RBD service
CLS_CASES = ("test_cls_lock_and_dir_replicated", "test_cls_lock_on_ec_pool",
             "test_cls_refcount_get_put_delete",
             "test_cls_journal_commit_monotonic_and_cas")
#: and the two that drive it
RBD_CASES = ("test_rbd_exclusive_lock_no_lost_updates",
             "test_rbd_header_via_cls")


def port_test_cls():
    """``tests/test_cls.py`` read as the port: its RBD service and its
    ``Journaler`` are the port's."""
    return case_module("test_cls", PORT)


@pytest.mark.parametrize("case", CLS_CASES)
def test_cls_case_matches_reference(case):
    port_test_cls()
    want = observe("test_cls", case, REF)
    got = observe("test_cls", case, PORT)
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.parametrize("case", RBD_CASES)
def test_cls_rbd_case_matches_reference(case):
    both_services("test_cls", case)


def test_the_port_reading_of_test_cls_leaves_out_only_the_rbd_cases():
    """The port reading of ``tests/test_cls.py`` is the whole file now
    that the port carries the RBD service and the journal: its cases are
    the four class cases and the two RBD cases above, and they run the
    port's ``RBD`` and ``Journaler``."""
    mod = port_test_cls()
    names = {n for n in vars(mod) if n.startswith("test_")}
    assert names == set(CLS_CASES) | set(RBD_CASES)
    assert mod.RBD.__module__ == PORT + ".services.rbd"
    src = port_source((TESTS / "test_cls.py").read_text())
    assert src.count("from ceph_tpu_torch.journal import Journaler") == 1


# ------------------------------------------------- the guarded EC write

K, M = 2, 2
GUARD = json.dumps({"conds": [{"cond": "eq", "ver": 0}]}).encode()


def _blobs(seed, n=4, size=(160 << 10) + 17):
    """Objects past the EC batch queue's host threshold (64 KiB per
    request)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


async def guarded_ec_script(p, io, first, new, launches=lambda: 0):
    """Write ``first``, rewrite under the guard with ``new`` (all in
    flight), send the guard again with ``first``; then read back and read
    each version.  Returns what the client saw, and ``launches()`` before
    and after the guarded writes and after the replays."""
    names = [f"g{i}" for i in range(len(first))]
    await asyncio.gather(*[io.write_full(n, b) for n, b in zip(names, first)])
    counts = [launches()]

    async def guarded(name, data):
        ops = [p.OSDOp(p.OP_CALL, name="version.inc", data=GUARD),
               p.OSDOp(p.OP_WRITEFULL, length=len(data), data=data)]
        try:
            reply = await io._op(name, ops)
        except p.ObjectOperationError as e:
            return e.retcode
        return (reply.result, [(o.rval, o.outdata) for o in reply.ops])

    seen = {"write": await asyncio.gather(
        *[guarded(n, b) for n, b in zip(names, new)])}
    counts.append(launches())
    seen["replay"] = await asyncio.gather(
        *[guarded(n, b) for n, b in zip(names, first)])
    counts.append(launches())
    seen["read"] = [hashlib.sha256(await io.read(n)).hexdigest()
                    for n in names]
    seen["version"] = [json.loads(await io.exec(n, "version", "read"))
                       for n in names]
    return seen, counts


def _pkg(root):
    m = importlib.import_module
    msgs = m(root + ".osd.messages")
    return types.SimpleNamespace(
        Cluster=m(root + ".qa.cluster").Cluster,
        make_ctx=m(root + ".qa.cluster").make_ctx,
        OSDOp=msgs.OSDOp, OP_CALL=msgs.OP_CALL, OP_WRITEFULL=msgs.OP_WRITEFULL,
        ObjectOperationError=m(root + ".client").ObjectOperationError)


def run_guarded(root, first, new):
    """The guarded EC write on a cluster of ``root``'s package: what the
    client saw, the store image before the stop and the EC batch queues'
    launches (the port's queues forced onto their device path, where the
    plain version of the matrix-apply kernel runs on the CPU)."""
    p = _pkg(root)

    def make(name):
        ctx = p.make_ctx(name)
        if root == PORT:
            ctx.config.set("osd_ec_batch_device", "force")
        return ctx

    async def run():
        kw = {"device": "cpu"} if root == PORT else {}
        cl = p.Cluster(ctx_factory=make, **kw)
        admin = await cl.start(K + M)
        await admin.pool_create("ec", pg_num=4, pool_type="erasure",
                                k=K, m=M)

        def launches():
            if root == REF:
                return 0
            return sum(q.launches for o in cl.osds.values()
                       for q in o.ec_queues().values())

        seen, counts = await guarded_ec_script(
            p, admin.open_ioctx("ec"), first, new, launches)
        image = store_image(cl.osds)
        await cl.stop()
        return seen, image, counts

    with pytest.MonkeyPatch.context() as mp:
        if root == REF:
            install_ref_backoff(mp)
        else:
            cpu_defaults(mp)
        pin_cls(mp, root)
        return asyncio.run(run())


def test_a_guarded_ec_write_answers_as_the_reference():
    first, new = _blobs(31), _blobs(32)
    want = run_guarded(REF, first, new)
    got = run_guarded(PORT, first, new)
    assert got[:2] == want[:2]
    seen = got[0]
    assert [r[0] for r in seen["write"]] == [0] * len(new)
    assert seen["replay"] == [-errno.ECANCELED] * len(new)
    assert seen["read"] == [hashlib.sha256(b).hexdigest() for b in new]
    assert all(v["ver"] == 1 and re.fullmatch(r"[0-9a-f]{16}", v["tag"])
               for v in seen["version"])
    # the version xattr went to every shard with the new chunks
    attrs = {name for objs in got[1].values() for o in objs
             for name, _ in o[4]}
    assert "ceph.objclass.version" in attrs
    # the rewrites went through the port's EC batch queues, the replays
    # never reached them
    before, after, replayed = got[2]
    assert after > before and replayed == after


# ------------------------------------------------------- process lanes

async def lane_calls(p, io):
    """One object's lock, refcount and an omap-staging call on the EC
    pool: the answers."""
    req = {"name": "l", "type": "exclusive", "entity": "a", "cookie": "c"}
    out = []
    for oid, method, r in (("g0", "lock.lock", req),
                           ("g0", "lock.lock", dict(req, entity="b")),
                           ("g0", "lock.get_info", {"name": "l"}),
                           ("g0", "refcount.get", {"tag": "a"}),
                           ("g0", "refcount.read", None),
                           ("dir", "rbd.dir_add", {"name": "x"}),
                           ("g0", "nope.method", None)):
        try:
            got = await io.exec(oid, *method.split("."),
                                json.dumps(r).encode() if r else b"")
            out.append((0, got))
        except p.ObjectOperationError as e:
            out.append((e.retcode, b""))
    return out


def run_lanes(lanes, first, new):
    p = _pkg(PORT)

    def make(name):
        ctx = p.make_ctx(name)
        ctx.config.set("osd_op_num_shards", 2)
        ctx.config.set("osd_shard_lanes", lanes)
        return ctx

    async def run():
        cl = p.Cluster(ctx_factory=make, device="cpu")
        admin = await cl.start(K + M)
        await admin.pool_create("ec", pg_num=4, pool_type="erasure",
                                k=K, m=M)
        io = admin.open_ioctx("ec")
        seen, _ = await guarded_ec_script(p, io, first, new)
        seen["calls"] = await lane_calls(p, io)
        await cl.stop()
        return seen

    return asyncio.run(run())


def test_process_lanes_answer_class_calls_as_thread_lanes():
    first, new = _blobs(33, n=3), _blobs(34, n=3)
    want = run_lanes("thread", first, new)
    got = run_lanes("process", first, new)
    for seen in (want, got):
        for v in seen.pop("version"):
            assert v["ver"] == 1 and re.fullmatch(r"[0-9a-f]{16}", v["tag"])
    assert got == want
    assert [rc for rc, _ in got["calls"]] == [
        0, -errno.EBUSY, 0, 0, 0, -errno.EOPNOTSUPP, -errno.EOPNOTSUPP]
    assert got["replay"] == [-errno.ECANCELED] * 3
