"""The port's write-back cache and striper (``client/object_cacher``,
``client/rados_striper``, ``services/striper``) against the JAX
package's.

``tests/test_client_cache.py``'s five cases without RBD (the cached RBD
image waits for the port's ``services/rbd``) run in both packages: the
reference test module as it is, with the repaired ``backoff``
(``test_torch_osd.install_ref_backoff``: its cache's flusher and its
cluster both import it), and its port reading on the CPU.  Both must
pass their own assertions, and their observations must be equal: each
``FakeBackend``'s read and write counts and objects, each cache's stats,
every ``IoCtx`` call's outcome (object lists included) and the stores at
the cluster's stop.  Tolerance 0.
"""

from __future__ import annotations

import hashlib
import importlib
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import (BOTH, PORT, REF, case_module,  # noqa: E402
                            install_ref_backoff, run_case)

CASES = ("test_cacher_writeback_and_hits",
         "test_cacher_flusher_ages_out_dirty",
         "test_cacher_dirty_limit_throttles_and_overwrite_composes",
         "test_cacher_trims_clean_lru",
         "test_striper_over_cluster")


def observe(case: str, root: str):
    """Run one case in one package: its IoCtx outcomes and store images,
    and every FakeBackend's and ObjectCacher's end state."""
    mod = case_module("test_client_cache", root)
    oc = importlib.import_module(root + ".client.object_cacher").ObjectCacher
    backends, cachers = [], []
    with pytest.MonkeyPatch.context() as mp:
        be_init, oc_init = mod.FakeBackend.__init__, oc.__init__

        def fake_init(self):
            be_init(self)
            backends.append(self)

        def cacher_init(self, *a, **kw):
            oc_init(self, *a, **kw)
            cachers.append(self)

        mp.setattr(mod.FakeBackend, "__init__", fake_init)
        mp.setattr(oc, "__init__", cacher_init)
        calls, images = run_case("test_client_cache", case, root)
    fakes = [(be.reads, be.writes,
              sorted((k, hashlib.sha256(v).hexdigest()[:16])
                     for k, v in be.objects.items())) for be in backends]
    stats = [dict(c.stats) for c in cachers]
    return calls, images, fakes, stats


def test_the_cases_are_the_reference_modules_but_rbd():
    mod = case_module("test_client_cache", REF)
    names = sorted(n for n in vars(mod) if n.startswith("test_"))
    assert sorted(CASES + ("test_rbd_cached_image_writeback",)) == names


@pytest.mark.parametrize("case", CASES)
def test_client_cache_case_matches_reference(case):
    want = observe(case, REF)
    got = observe(case, PORT)
    assert got == want
    if case == "test_striper_over_cluster":
        assert got[0] and got[1]          # IoCtx calls and store images
    else:
        assert got[2] and got[3]          # a backend and a cache


def test_the_port_modules_are_their_own():
    """The port reading runs the port's classes, not the reference's."""
    for root in BOTH:
        mod = case_module("test_client_cache", root)
        assert mod.ObjectCacher.__module__ == root + ".client.object_cacher"
        assert mod.RadosStriper.__module__ == root + ".client.rados_striper"
        assert mod.Layout.__module__ == root + ".services.striper"


@pytest.mark.parametrize("offset,length", [(0, 1), (4095, 2), (10, 70000),
                                           (123456, 1 << 20)])
def test_file_to_extents_matches_the_reference(offset, length):
    from ceph_tpu.client.rados_striper import DEFAULT_LAYOUT as ref_default
    from ceph_tpu.services import striper as ref
    from ceph_tpu_torch.client.rados_striper import DEFAULT_LAYOUT
    from ceph_tpu_torch.services import striper
    assert tuple(DEFAULT_LAYOUT) == tuple(ref_default)
    for lay in ((4096, 2, 16384), (65536, 4, 1 << 20), tuple(ref_default)):
        want = ref.file_to_extents(ref.Layout(*lay), offset, length)
        got = striper.file_to_extents(striper.Layout(*lay), offset, length)
        assert [tuple(e) for e in got] == [tuple(e) for e in want]
        want = ref.extents_by_object(ref.Layout(*lay), offset, length)
        got = striper.extents_by_object(striper.Layout(*lay), offset, length)
        assert {k: [tuple(e) for e in v] for k, v in got.items()} == \
            {k: [tuple(e) for e in v] for k, v in want.items()}


def test_a_seeded_cache_workload_matches_the_reference():
    """256 writes of 16 KiB at seeded offsets over 16 objects, reads in
    between, through each package's cache on a backend that records
    every call: the calls, the bytes and the stats agree."""
    import asyncio

    def run(root):
        oc = importlib.import_module(root + ".client.object_cacher")
        log, objects = [], {}

        async def read(oid, off, length):
            log.append(("r", oid, off, length))
            return objects.get(oid, b"")[off:off + length]

        async def write(oid, off, data):
            log.append(("w", oid, off, len(data)))
            cur = bytearray(objects.get(oid, b""))
            cur.extend(b"\0" * max(0, off + len(data) - len(cur)))
            cur[off:off + len(data)] = data
            objects[oid] = bytes(cur)

        async def go():
            rng = np.random.default_rng(40)
            c = oc.ObjectCacher(read, write, max_dirty=1 << 20,
                                max_bytes=2 << 20, max_dirty_age=30.0)
            c.start()
            got = []
            for i in range(256):
                oid = f"o{int(rng.integers(16))}"
                off = int(rng.integers(32)) * 16384
                await c.write(oid, off, bytes([i % 256]) * 16384)
                if i % 16 == 15:
                    got.append(await c.read(oid, off // 2, 20000))
            await c.flush_all()
            stats = dict(c.stats)
            await c.stop()
            return got, stats
        got, stats = asyncio.run(go())
        return log, sorted(objects.items()), got, stats

    with pytest.MonkeyPatch.context() as mp:
        install_ref_backoff(mp)          # the reference cache's flusher
        want = run(REF)
    assert run(PORT) == want
