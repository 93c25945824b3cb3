"""The port's block-image service (``ceph_tpu_torch.services.rbd``) against
the JAX package's, case by case.

Every case of ``tests/test_rbd.py`` but ``test_rbd_cli_and_bench_on_cluster``
(it drives ``tools/vstart`` and the ``rbd`` CLI, which the port does not
carry yet) runs once per package: the reference test module as it is,
with the repaired ``backoff`` (``test_torch_osd.install_ref_backoff``), and
its port reading on the CPU.  Both must pass their own assertions, and
their observations must be equal: every ``IoCtx`` call's outcome and the
stores at each cluster's stop.  Tolerance 0.

The services stamp what they store with the clock and with random
tokens: a CephFS inode's mtime, an RGW object's data name (``time_ns``),
an upload id, a GC tag, a lock cookie, a messenger's nonce (it is part of
an RBD lock owner's name).  ``pin_services`` gives both runs of a case
the same clock, one that advances by a fixed step on each read from a
start the test takes once, and the same seeded tokens, so that the two
packages store the same bytes.  This module also holds that harness for
the other service files (``test_torch_rgw*``, ``test_torch_cephfs``,
``test_torch_mirror``, ``test_torch_mgr``).
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import random
import sys
import time
import types

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_cls import pin_cls  # noqa: E402
from test_torch_osd import (BOTH, PORT, REF, case_module, cases,  # noqa: E402
                            run_case)

#: the seeds of the pinned tokens: messenger nonces and connection ids,
#: CephFS and MDS tid bases (``random.getrandbits``); lock cookies, Swift
#: tokens and GC tags (``os.urandom``)
BITS_SEED, BYTES_SEED = 11, 12
#: the pinned clock's step per read (s)
TICK_S = 1e-3
#: the service modules that read the clock for what they store
CLOCKED = ("mds", "rgw", "rgw_gc", "rgw_usage")
#: the MDS's journal flush period in a pinned run (s): its 1 s timer
#: fires as many times as the host's load stretches a case, each flush
#: an IoCtx write; the cases flush where they mean to (a restart, a
#: shutdown), so the timer is left to no case
MDS_FLUSH_S = 3600.0


def pin_services(mp: pytest.MonkeyPatch, root: str, t0: float) -> None:
    """For as long as ``mp`` lasts: ``root``'s class tags pinned
    (``pin_cls``); the MDS's flush timer at ``MDS_FLUSH_S``;
    ``random.getrandbits`` seeded, its values of full
    width (a nonce's digits never vary); the clocked service modules'
    ``time`` a clock that starts at ``t0`` and advances ``TICK_S`` on
    each read; the services' random tokens seeded."""
    pin_cls(mp, root)
    mds = importlib.import_module(f"{root}.services.mds").MDS.__init__
    names = list(inspect.signature(mds).parameters)
    defaults = list(mds.__defaults__)
    defaults[names.index("log_flush_interval")
             - (len(names) - len(defaults))] = MDS_FLUSH_S
    mp.setattr(mds, "__defaults__", tuple(defaults))
    bits = random.Random(BITS_SEED)
    mp.setattr(random, "getrandbits",
               lambda b: (1 << (b - 1)) | bits.getrandbits(b - 1))
    ticks = itertools.count(1)
    clock = types.SimpleNamespace(
        time=lambda: t0 + next(ticks) * TICK_S,
        time_ns=lambda: int(t0) * 10 ** 9
        + next(ticks) * int(TICK_S * 1e9),
        monotonic=time.monotonic, strftime=time.strftime,
        gmtime=time.gmtime, strptime=time.strptime)
    for name in CLOCKED:
        mp.setattr(importlib.import_module(f"{root}.services.{name}"),
                   "time", clock)
    usage = importlib.import_module(f"{root}.services.rgw_usage").UsageLog
    mp.setattr(usage.__init__, "__defaults__",
               tuple(clock.time if d is time.time else d
                     for d in usage.__init__.__defaults__))
    tokens = np.random.default_rng(BYTES_SEED)
    rbd = importlib.import_module(f"{root}.services.rbd")
    mp.setattr(rbd, "os_urandom_hex", lambda n=8: tokens.bytes(n).hex())
    gc = importlib.import_module(f"{root}.services.rgw_gc")
    mp.setattr(gc, "os", types.SimpleNamespace(urandom=tokens.bytes))


def observe(name: str, case: str, root: str, t0: float):
    """``run_case`` with ``root``'s services pinned from ``t0``."""
    with pytest.MonkeyPatch.context() as mp:
        pin_services(mp, root, t0)
        return run_case(name, case, root)


def shape(obs):
    """What a run did whatever order concurrent requests took: each
    ``IoCtx`` call's kind, pool and object, and each store's object
    names."""
    calls, images = obs
    return (sorted({c[:2] + c[2][:1] for c in calls}, key=repr),
            [{i: sorted({o[:3] for o in objs}, key=repr)
              for i, objs in image.items()} for image in images])


def both_services(name: str, case: str, concurrent: bool = False):
    """Run a reference service case in both packages on the same pinned
    clock and tokens; their observations must be equal.  Returns the
    port's.  ``concurrent`` marks a case whose service takes concurrent
    requests from several clients in the order they arrive (an MDS
    serving two mounts' creates): that order, and with it the inode
    numbers and the journal's bytes, is the scheduler's choice, so the
    runs' shapes are compared."""
    t0 = float(int(time.time()))
    want = observe(name, case, REF, t0)
    got = observe(name, case, PORT, t0)
    if concurrent:
        assert shape(got) == shape(want)
        return got
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got


# ------------------------------------------------------- tests/test_rbd.py

#: the one case that waits for the port's tools (vstart, the rbd CLI)
RBD_TOOLS = "test_rbd_cli_and_bench_on_cluster"
RBD_CASES = [c for c in cases("test_rbd") if c != RBD_TOOLS]


def test_the_cases_are_the_reference_modules_but_the_vstart_cli():
    assert sorted(RBD_CASES + [RBD_TOOLS]) == cases("test_rbd")
    assert len(RBD_CASES) == 19


@pytest.mark.parametrize("case", RBD_CASES)
def test_rbd_case_matches_reference(case):
    both_services("test_rbd", case)


def test_the_port_modules_are_their_own():
    """The port reading runs the port's service, not the reference's."""
    for root in BOTH:
        mod = case_module("test_rbd", root)
        assert mod.RBD.__module__ == root + ".services.rbd"
        assert mod.Layout.__module__ == root + ".services.striper"


def test_the_services_package_exports_the_references_names():
    ref = importlib.import_module("ceph_tpu.services")
    port = importlib.import_module("ceph_tpu_torch.services")
    assert port.__all__ == ref.__all__
    for name in ref.__all__:
        assert getattr(port, name).__module__.startswith("ceph_tpu_torch.")
    assert importlib.import_module("ceph_tpu_torch.utils").__doc__ is None


def test_a_pinned_run_stores_the_same_bytes_twice():
    """The pins make a run repeatable: the same case twice in the port on
    one start gives equal observations (so a difference between the
    packages is theirs, not the clock's)."""
    t0 = float(int(time.time()))
    first = observe("test_rbd", "test_rbd_snapshot_on_ec_pool", PORT, t0)
    assert observe("test_rbd", "test_rbd_snapshot_on_ec_pool", PORT,
                   t0) == first
