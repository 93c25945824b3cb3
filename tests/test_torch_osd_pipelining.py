"""The per-PG op window, the sharded data plane and shared-memory
extents in the port's OSD core against the JAX package's: every case of
``tests/test_pipelining.py`` and ``tests/test_extents.py``, and the
cluster cases of ``tests/test_shards.py`` that need no process lane, run
once per package; the observations (every ``IoCtx`` outcome, the stores
at each cluster stop) must be equal.  The harness is
``test_torch_osd``'s.  Tolerance 0."""

import pytest

from test_torch_osd import PORT, REF, both, case_module, cases, run_case

#: test_shards' cluster cases without process lanes (the lane transport,
#: osd/lanes and osd/laneipc, is not ported)
SHARD_CASES = ("test_sharded_inline_cluster_rw_and_home_shard_pinning",
               "test_sharded_threaded_cluster_rw_and_teardown",
               "test_objecter_corked_batching_one_handoff_many_replies",
               "test_objecter_batching_off_is_unbatched",
               "test_single_shard_plane_is_disabled_legacy_dispatch")


@pytest.mark.parametrize("case", cases("test_pipelining"))
def test_pipelining_case_matches_reference(case):
    both("test_pipelining", case)


@pytest.mark.parametrize("case", SHARD_CASES)
def test_shards_cluster_case_matches_reference(case):
    both("test_shards", case)


def _extents_case(root, case, caplog):
    """One test_extents case in one package, its ``pool`` fixture built
    from that package's module."""
    mod = case_module("test_extents", root)
    fn = getattr(mod, case)
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    if "pool" not in params:
        return run_case("test_extents", case, root)
    gen = mod.pool._get_wrapped_function()()
    pool = next(gen)
    try:
        args = [pool if p == "pool" else caplog for p in params]
        return run_case("test_extents", case, root, *args)
    finally:
        next(gen, None)


@pytest.mark.parametrize("case", cases("test_extents"))
def test_extents_case_matches_reference(case, caplog):
    want = _extents_case(REF, case, caplog)
    caplog.clear()
    assert _extents_case(PORT, case, caplog) == want
