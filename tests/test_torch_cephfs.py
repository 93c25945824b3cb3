"""The port's MDS and CephFS client (``ceph_tpu_torch.services.mds``,
``ceph_tpu_torch.services.cephfs``) against the JAX package's.

- Every case of ``tests/test_cephfs.py`` runs once per package on the
  same pinned clock and tokens (``test_torch_rbd.both_services``), with
  equal observations: every ``IoCtx`` call's outcome (the MDS journal's
  appends, the directory omaps, the striped file data) and the stores at
  each cluster's stop.  The port's MDS messages carry the reference's
  type codes, in the port's own registry.
- A repair: a CephFS data pool (and any striped object) on an
  erasure-coded pool.  The reference's ``RadosStriper.write`` sends
  partial writes, which EC pools refuse (-EOPNOTSUPP); the port's
  rewrites each sub-object whole there, as the RBD service does for
  images on EC pools.

Tolerance 0.
"""

from __future__ import annotations

import asyncio
import errno
import importlib
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import (BOTH, PORT, REF, case_module, cases,  # noqa: E402
                            cpu_defaults, install_ref_backoff)
from test_torch_rbd import both_services  # noqa: E402

CEPHFS_CASES = cases("test_cephfs")
#: two mounts create files at once: the MDS numbers them in the order
#: they arrive (``both_services``' ``concurrent``)
CONCURRENT = {"test_cephfs_two_clients_share_namespace"}


def test_the_cases_are_the_reference_modules():
    assert len(CEPHFS_CASES) == 10 and CONCURRENT <= set(CEPHFS_CASES)


@pytest.mark.parametrize("case", CEPHFS_CASES)
def test_cephfs_case_matches_reference(case):
    both_services("test_cephfs", case, concurrent=case in CONCURRENT)


def test_the_mds_messages_keep_the_references_type_codes():
    for name in ("MClientLease", "MClientRequest", "MClientReply"):
        ref = getattr(importlib.import_module(REF + ".services.mds"), name)
        port = getattr(importlib.import_module(PORT + ".services.mds"), name)
        assert port is not ref and port.TYPE == ref.TYPE
        reg = importlib.import_module(PORT + ".msg.message")
        assert reg._REGISTRY[port.TYPE] is port


# ------------------------------------------- a repair: EC data pools

K, M = 2, 2


def _file(seed, size):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


async def _ec_cluster(mod, admin_pools=True):
    cl = mod.Cluster()
    admin = await cl.start(K + M)
    await admin.mon_command({
        "prefix": "osd erasure-code-profile set", "name": "rs",
        "profile": {"plugin": "rs", "k": str(K), "m": str(M)}})
    await admin.pool_create("ecdata", pg_num=8, pool_type="erasure",
                            erasure_code_profile="rs")
    return cl, admin


def ec_data_pool_run(root):
    """A CephFS file set on an RS k=2 m=2 data pool: two files written
    (one over several 4 MiB objects, each in two writes at an unaligned
    offset), read back, one overwritten in the middle, one truncated; a
    striped object on the same pool.  Returns what each read gave, or
    the error code of the first refused write."""
    with pytest.MonkeyPatch.context() as mp:
        if root == REF:
            install_ref_backoff(mp)
        else:
            cpu_defaults(mp)
        mod = case_module("test_cephfs", root)
        CephFS = importlib.import_module(root + ".services.cephfs").CephFS
        striper = importlib.import_module(root + ".client.rados_striper")
        objecter = importlib.import_module(root + ".client.objecter")

        async def run():
            cl, admin = await _ec_cluster(mod)
            mds, msgr, addr = await mod._start_mds(cl, admin)
            fs = CephFS(admin, addr, "ecdata")
            big, small = _file(1, (9 << 20) + 4321), _file(2, 70000)
            seen = []
            try:
                f = await fs.open("/big.bin", "w")
                await f.write(big[:(5 << 20) + 17])
                await f.write(big[(5 << 20) + 17:])
                await f.close()
                await fs.write_file("/small.bin", small)
                seen.append(await fs.read_file("/big.bin") == big)
                seen.append(await fs.read_file("/small.bin") == small)
                f = await fs.open("/big.bin", "r+")
                await f.write(b"x" * 5000, offset=(4 << 20) - 2500)
                await f.truncate(6 << 20)
                await f.close()
                want = (big[:(4 << 20) - 2500] + b"x" * 5000
                        + big[(4 << 20) + 2500:6 << 20])
                seen.append(await fs.read_file("/big.bin") == want)
                st = striper.RadosStriper(admin.open_ioctx("ecdata"))
                await st.write("striped", small, offset=100)
                await st.write("striped", small[:999], offset=50)
                seen.append(await st.read("striped")
                            == b"\0" * 50 + small[:999]
                            + small[949:])
                seen.append(sorted(await fs.listdir("/")))
            except objecter.ObjectOperationError as e:
                seen.append(e.retcode)
            await msgr.shutdown()
            await cl.stop()
            return seen
        return asyncio.run(run())


def test_a_cephfs_data_pool_on_an_ec_pool_round_trips():
    """Fails on the unrepaired striper: its first write to the EC data
    pool is refused with -EOPNOTSUPP."""
    assert ec_data_pool_run(PORT) == [True, True, True, True,
                                      ["big.bin", "small.bin"]]


def test_the_jax_package_refuses_a_cephfs_file_on_an_ec_data_pool():
    assert ec_data_pool_run(REF) == [-errno.EOPNOTSUPP]


def test_the_striper_on_a_replicated_pool_sends_what_the_reference_sends():
    """Off EC pools the repaired striper is the reference's: the same
    ``IoCtx`` calls for the same writes (a recording fake)."""
    def calls(root):
        striper = importlib.import_module(root + ".client.rados_striper")
        log, xattrs, objs = [], {}, {}

        class Pool:
            def is_erasure(self):
                return False

        class Io:
            pool_id = 1
            rados = type("R", (), {"monc": type("M", (), {
                "osdmap": type("O", (), {"pools": {1: Pool()}})()})()})()

            async def getxattr(self, oid, name):
                log.append(("getxattr", oid, name))
                if (oid, name) not in xattrs:
                    raise importlib.import_module(
                        root + ".client.objecter").ObjectOperationError(
                            -errno.ENOENT)
                return xattrs[oid, name]

            async def setxattr(self, oid, name, value):
                log.append(("setxattr", oid, name, value))
                xattrs[oid, name] = value

            async def write(self, oid, data, offset=0):
                log.append(("write", oid, offset, len(data)))
                cur = bytearray(objs.get(oid, b""))
                cur.extend(b"\0" * max(0, offset + len(data) - len(cur)))
                cur[offset:offset + len(data)] = data
                objs[oid] = bytes(cur)

        async def go():
            st = striper.RadosStriper(Io(), striper.Layout(4096, 3, 16384))
            await st.write("f", _file(3, 100000), offset=777)
            await st.write("f", _file(4, 5000), offset=40000)
        asyncio.run(go())
        return log, sorted(objs.items())
    assert calls(PORT) == calls(REF)


# ------------- a repair: an EC object made by a setxattr alone, on BlockStore

def xattr_only_ec_object(root, path):
    """On 4 OSDs with crc32c BlockStores, an RS k=2 m=2 pool: an object
    made by a setxattr alone (a striped file's head before its first
    write), then read and stat.  Returns each call's outcome."""
    with pytest.MonkeyPatch.context() as mp:
        if root == REF:
            install_ref_backoff(mp)
        else:
            cpu_defaults(mp)
        Cluster = importlib.import_module(root + ".qa.cluster").Cluster
        BlockStore = importlib.import_module(
            root + ".store.blockstore").BlockStore
        objecter = importlib.import_module(root + ".client.objecter")

        async def run():
            cl = Cluster(store_factory=lambda i: BlockStore(
                str(path / f"osd.{i}"), csum_type="crc32c"))
            admin = await cl.start(K + M)
            await admin.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "rs",
                "profile": {"plugin": "rs", "k": str(K), "m": str(M)}})
            await admin.pool_create("ec", pg_num=4, pool_type="erasure",
                                    erasure_code_profile="rs")
            io = admin.open_ioctx("ec")
            await io.setxattr("head", "striper.size", b"0")
            seen = [await io.getxattr("head", "striper.size")]
            for call in (io.read("head"), io.stat("head")):
                try:
                    seen.append(("ok", await asyncio.wait_for(call, 4.0)))
                except objecter.ObjectOperationError as e:
                    seen.append(("rc", e.retcode))
                except asyncio.TimeoutError:
                    seen.append("timeout")
            await cl.stop()
            return seen
        return asyncio.run(run())


def test_a_read_of_an_ec_object_with_no_data_answers_enoent(tmp_path):
    """Such an object has no size xattr: it reads as absent, as on
    MemStore (the striper's EC rewrite then starts from nothing).  Fails
    on the unrepaired backend: BlockStore's bare StoreError for the
    absent xattr fails the op, and the client waits out its timeout."""
    assert xattr_only_ec_object(PORT, tmp_path) == [
        b"0", ("rc", -errno.ENOENT), ("rc", -errno.ENOENT)]


def test_the_jax_package_fails_a_read_of_an_ec_object_with_no_data(
        tmp_path):
    assert xattr_only_ec_object(REF, tmp_path) == [b"0", "timeout",
                                                   "timeout"]
