"""The port's OSD core and client (``ceph_tpu_torch.osd``,
``ceph_tpu_torch.client``, ``ceph_tpu_torch.qa.cluster``) against the JAX
package's, case by case.

Every case of ``tests/test_osd.py`` runs once per package on the same
inputs: the reference's test source as it is, and the same source with
``ceph_tpu`` read as ``ceph_tpu_torch`` (each port cluster, OSD and client
on ``device="cpu"``).  Both runs must pass their own assertions, and their
observations must be equal: every ``IoCtx`` call's outcome (bytes read,
stat, xattrs, omap, listings, error codes) and, at each cluster's stop,
the objects on every OSD's store with their data and the xattrs that
carry no epoch or clock.

The reference's OSD cluster needs one repair to boot on Python 3.12:
``ceph_tpu/common/backoff.py:45`` declares ``BackoffGiveUp(TimeoutError,
asyncio.TimeoutError)``, a duplicate base there.  Every reference import
of ``backoff`` is lazy, so the ``ref_backoff`` fixture installs, for one
test, a copy of that module with only the base list replaced; the file
stays as it is, and the real import still raises after the test.

This module also holds the harness the other ``test_torch_osd_*`` and
``test_torch_client`` files use.  Tolerance 0: every comparison is exact.
"""

from __future__ import annotations

import hashlib
import importlib
import inspect
import pathlib
import re
import sys
import types

import pytest

TESTS = pathlib.Path(__file__).parent
ROOT = TESTS.parent
REF, PORT = "ceph_tpu", "ceph_tpu_torch"
BOTH = (REF, PORT)

# --------------------------------------------------- the reference's backoff

_BAD_BASES = "class BackoffGiveUp(TimeoutError, asyncio.TimeoutError):"


def install_ref_backoff(mp: pytest.MonkeyPatch) -> types.ModuleType:
    """Put a copy of ``ceph_tpu.common.backoff`` with only
    ``BackoffGiveUp``'s base list replaced into ``sys.modules`` (and onto
    ``ceph_tpu.common``) for as long as ``mp`` lasts."""
    path = ROOT / "ceph_tpu" / "common" / "backoff.py"
    src = path.read_text()
    assert src.count(_BAD_BASES) == 1
    mod = types.ModuleType("ceph_tpu.common.backoff")
    mod.__file__ = str(path)
    mp.setitem(sys.modules, "ceph_tpu.common.backoff", mod)
    exec(compile(src.replace(_BAD_BASES, "class BackoffGiveUp(TimeoutError):"),
                 str(path), "exec"), mod.__dict__)
    import ceph_tpu.common
    mp.setattr(ceph_tpu.common, "backoff", mod, raising=False)
    return mod


@pytest.fixture
def ref_backoff(monkeypatch):
    return install_ref_backoff(monkeypatch)


# ------------------------------------------------------ the port on the CPU

def cpu_defaults(mp: pytest.MonkeyPatch) -> None:
    """Make ``device="cpu"`` the default of every port entry point a
    reference test builds (clusters, OSDs, clients, Objecters) for as long
    as ``mp`` lasts: the reference's tests never name a device."""
    from ceph_tpu_torch.client.objecter import Objecter
    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.qa.cluster import Cluster
    for fn in (Objecter.__init__, Rados.__init__, OSD.__init__,
               Cluster.__init__):
        names = list(inspect.signature(fn).parameters)
        defaults = list(fn.__defaults__)
        i = names.index("device") - (len(names) - len(defaults))
        defaults[i] = "cpu"
        mp.setattr(fn, "__defaults__", tuple(defaults))


def port_source(src: str) -> str:
    """A reference test's source with ``ceph_tpu`` read as the port.  The
    reference's schedule explorer (``devtools``, not ported) stays: it
    runs any coroutine."""
    src = re.sub(r"\bceph_tpu\.(?!devtools)", "ceph_tpu_torch.", src)
    src = src.replace("from ceph_tpu import", "from ceph_tpu_torch import")
    return re.sub(r"^from (test_\w+) import", r"from _port_\1 import", src,
                  flags=re.M)


def case_module(name: str, root: str):
    """The reference test module ``name`` (``tests/<name>.py``) for one
    package: the file itself, or its port reading."""
    if root == REF:
        if str(TESTS) not in sys.path:
            sys.path.insert(0, str(TESTS))
        return importlib.import_module(name)
    modname = f"_port_{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = TESTS / f"{name}.py"
    src = port_source(path.read_text())
    for dep in re.findall(r"^from _port_(test_\w+) import", src, re.M):
        case_module(dep, PORT)
    mod = types.ModuleType(modname)
    mod.__file__ = str(path)
    sys.modules[modname] = mod
    try:
        exec(compile(src, str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


# ------------------------------------------------------------ observations

def _summary(v):
    """A comparable, compact form of an IoCtx result."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        return ("bytes", len(b), hashlib.sha256(b).hexdigest()[:16])
    if isinstance(v, dict):
        return ("dict", tuple(sorted((repr(k), repr(_summary(x)))
                                     for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return ("list", tuple(_summary(x) for x in v))
    if v is None or isinstance(v, (int, str, bool, float)):
        return v
    return type(v).__name__


def _arg(v):
    if isinstance(v, (bytes, bytearray)):
        return ("bytes", len(v))
    if callable(v):
        return "callable"
    if isinstance(v, dict):
        return ("dict", len(v))
    return v if isinstance(v, (int, str, type(None))) else type(v).__name__


#: IoCtx coroutines whose outcome is recorded
RECORDED = ("write_full", "write", "truncate", "read", "remove", "create",
            "stat", "getxattr", "setxattr", "cmpxattr", "assert_exists",
            "omap_set", "omap_rm_keys", "omap_get", "list_objects",
            "snap_create", "snap_remove", "rollback", "list_snaps",
            "selfmanaged_rollback", "exec")

#: xattrs that hold an epoch, a version or a clock stamp: left out
STAMPED_XATTRS = ("_v", "_ver", "version", "_mtime", "mtime")


def store_image(osds) -> dict:
    """Every client object on every OSD's store (PG meta objects and the
    map collection left out): data digest and the xattrs that carry no
    epoch or clock."""
    out = {}
    for i, osd in sorted(osds.items()):
        s = osd.store
        objs = []
        for cid in s.list_collections():
            if cid.name == "meta":          # maps and superblock: stamped
                continue
            for soid in s.collection_list(cid):
                if soid.name.startswith("_"):   # pg meta: epochs in omap
                    continue
                try:
                    data = s.read(cid, soid)
                    attrs = s.getattrs(cid, soid)
                except Exception as e:          # noqa: BLE001
                    objs.append((str(cid), repr(soid), type(e).__name__))
                    continue
                keep = sorted((k, hashlib.sha256(bytes(v)).hexdigest()[:12])
                              for k, v in attrs.items()
                              if k not in STAMPED_XATTRS)
                objs.append((cid.name, soid.name, soid.snap,
                             hashlib.sha256(bytes(data)).hexdigest()[:16],
                             keep))
        out[i] = sorted(objs, key=repr)
    return out


class Observer:
    """Records, for one run of a case in one package, every IoCtx call's
    outcome and the store image at each cluster stop."""

    def __init__(self):
        self.calls = []
        self.images = []

    def install(self, mp: pytest.MonkeyPatch, root: str) -> None:
        rados = importlib.import_module(root + ".client.rados")
        cluster = importlib.import_module(root + ".qa.cluster")
        for name in RECORDED:
            orig = getattr(rados.IoCtx, name)
            mp.setattr(rados.IoCtx, name, self._wrap(name, orig))
        stop = cluster.Cluster.stop
        obs = self

        async def stop_and_image(cl):
            obs.images.append(store_image(cl.osds))
            return await stop(cl)

        mp.setattr(cluster.Cluster, "stop", stop_and_image)

    def _wrap(self, name, orig):
        calls = self.calls

        async def wrapper(io, *args, **kw):
            key = (name, io.pool_name, tuple(_arg(a) for a in args),
                   tuple(sorted((k, _arg(v)) for k, v in kw.items())))
            try:
                res = await orig(io, *args, **kw)
            except Exception as e:
                calls.append(key + (("raise", type(e).__name__,
                                     getattr(e, "retcode", None)),))
                raise
            calls.append(key + (("ok", _summary(res)),))
            return res

        wrapper.__name__ = name
        return wrapper

    def result(self):
        # concurrent ops finish in any order and polling loops repeat a
        # call a number of times the clock decides: compare the set
        return sorted(set(self.calls), key=repr), self.images


def run_case(name: str, case: str, root: str, *args):
    """Run ``tests/<name>.py::<case>`` in one package; returns its
    observations.  The reference runs with the repaired ``backoff``, the
    port on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        if root == REF:
            install_ref_backoff(mp)
        else:
            cpu_defaults(mp)
        obs = Observer()
        obs.install(mp, root)
        getattr(case_module(name, root), case)(*args)
        return obs.result()


#: what the client reads back (data, sizes, attributes, listings)
READS = ("read", "stat", "getxattr", "cmpxattr", "assert_exists",
         "omap_get", "list_objects", "list_snaps")


def both(name: str, case: str, *args, polled: bool = False):
    """Run a reference case in both packages and require equal
    observations; returns the port's.  ``polled`` marks a case that
    retries writes until the cluster's clock-driven state changes (a
    quota flag, a down-out): which attempts fail there is the clock's
    choice, so only what the client read back and the stores are
    compared."""
    want = run_case(name, case, REF, *args)
    got = run_case(name, case, PORT, *args)
    if polled:
        assert [c for c in got[0] if c[0] in READS] == \
            [c for c in want[0] if c[0] in READS]
    else:
        assert got[0] == want[0]
    assert got[1] == want[1]
    return got


def cases(name: str):
    mod = case_module(name, REF)
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and inspect.isfunction(f)
                  and f.__module__ == name)


# ------------------------------------------------------- tests/test_osd.py

#: cases that poll the cluster's clock-driven state with writes
POLLED = {"test_pool_quota_full_flag_blocks_writes"}


@pytest.mark.parametrize("case", cases("test_osd"))
def test_osd_case_matches_reference(case):
    both("test_osd", case, polled=case in POLLED)
