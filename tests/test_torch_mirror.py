"""The port's rbd-mirror (``ceph_tpu_torch.services.rbd_mirror``) and its
journal (``ceph_tpu_torch.journal``) against the JAX package's, case by
case.

Every case of ``tests/test_mirror.py`` runs once per package on the same
pinned clock and tokens (``test_torch_rbd.both_services``), with equal
observations: every ``IoCtx`` call's outcome (the journal's header omap,
its data objects, the secondary image's objects) and the stores at each
cluster's stop.  The journal events cross between the packages as the
same bytes.  Tolerance 0.
"""

from __future__ import annotations

import asyncio
import importlib
import sys

import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import BOTH, PORT, REF, case_module, cases  # noqa: E402
from test_torch_rbd import both_services  # noqa: E402

MIRROR_CASES = cases("test_mirror")


def test_the_cases_are_the_reference_modules():
    assert len(MIRROR_CASES) == 3


@pytest.mark.parametrize("case", MIRROR_CASES)
def test_mirror_case_matches_reference(case):
    both_services("test_mirror", case)


def test_the_port_modules_are_their_own():
    for root in BOTH:
        mod = case_module("test_mirror", root)
        assert mod.ImageReplayer.__module__ == root + ".services.rbd_mirror"
        assert mod.Journaler.__module__ == root + ".journal.journaler"


EVENTS = (("encode_write_event", (123456789, b"\0\1" * 3000)),
          ("encode_write_event", (0, b"")),
          ("encode_discard_event", (4096, 1 << 22)),
          ("encode_resize_event", (1 << 30,)),
          ("encode_snap_event", (True, "s1")),
          ("encode_snap_event", (False, "snap-ü")))


@pytest.mark.parametrize("name,args", EVENTS)
def test_journal_events_are_the_references_bytes(name, args):
    ref = importlib.import_module(REF + ".services.rbd_mirror")
    port = importlib.import_module(PORT + ".services.rbd_mirror")
    assert getattr(port, name)(*args) == getattr(ref, name)(*args)


def test_an_event_of_one_package_applies_in_the_other():
    """``apply_event`` decodes the other package's bytes into the same
    image call."""
    for writer, reader in ((REF, PORT), (PORT, REF)):
        w = importlib.import_module(writer + ".services.rbd_mirror")
        r = importlib.import_module(reader + ".services.rbd_mirror")
        seen = []

        class Img:
            size = 1 << 20

            async def write(self, off, data):
                seen.append(("write", off, data))

            async def discard(self, off, n):
                seen.append(("discard", off, n))

            async def resize(self, n):
                seen.append(("resize", n))

            async def snap_create(self, name):
                seen.append(("snap_create", name))

            async def snap_remove(self, name):
                seen.append(("snap_remove", name))

        async def go():
            for name, args in EVENTS:
                await r.apply_event(Img(), getattr(w, name)(*args))
        asyncio.run(go())
        assert seen == [("write", 0, b""), ("discard", 4096, 1 << 22),
                        ("resize", 1 << 30), ("snap_create", "s1"),
                        ("snap_remove", "snap-ü")]
