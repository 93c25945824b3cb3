"""Peering and PG metadata in the port's OSD core against the JAX
package's: every case of ``tests/test_peering.py`` and
``tests/test_pg_meta.py`` runs once per package, and the observations
(every ``IoCtx`` outcome, the stores at each cluster stop) must be equal.
The harness is ``test_torch_osd``'s.  Tolerance 0."""

import pytest

from test_torch_osd import both, cases


@pytest.mark.parametrize("case", cases("test_peering"))
def test_peering_case_matches_reference(case):
    both("test_peering", case)


@pytest.mark.parametrize("case", cases("test_pg_meta"))
def test_pg_meta_case_matches_reference(case):
    both("test_pg_meta", case)


def test_cancelled_waiter_leaves_the_shared_map_fetch_whole():
    """PGs that miss the same map epoch share one fetch of it.  A waiter
    whose peering is superseded is cancelled; that must neither cancel
    the fetch under its owner (whose ``set_result`` then raised) nor
    cancel the other waiters (whose PGs then never went active)."""
    import asyncio
    import concurrent.futures
    import logging
    import threading
    import types

    from ceph_tpu_torch.osd.daemon import OSD

    async def run():
        release = asyncio.Event()
        fetched = []

        async def command(cmd, timeout):
            fetched.append(cmd["epoch"])
            await release.wait()
            return types.SimpleNamespace(outbl=b"")

        osd = types.SimpleNamespace(
            store=types.SimpleNamespace(exists=lambda cid, oid: False),
            monc=types.SimpleNamespace(command=command),
            logger=logging.getLogger("test"),
            _map_fetch_lock=threading.Lock(),
            _map_fetches={})
        owner = asyncio.ensure_future(OSD.ensure_map_history(osd, 1, 2))
        await asyncio.sleep(0)
        doomed = asyncio.ensure_future(OSD.ensure_map_history(osd, 1, 2))
        other = asyncio.ensure_future(OSD.ensure_map_history(osd, 1, 2))
        await asyncio.sleep(0)
        assert isinstance(osd._map_fetches[1], concurrent.futures.Future)
        doomed.cancel()
        await asyncio.sleep(0)
        release.set()
        await asyncio.wait_for(asyncio.gather(owner, other), 5.0)
        assert doomed.cancelled()
        assert fetched == [1] and osd._map_fetches == {}

    asyncio.run(run())
