"""The port's sharded RGW bucket index (``ceph_tpu_torch.services.rgw``
over ``ceph_tpu_torch.cls.rgw``) against the JAX package's, case by case.

Every case of ``tests/test_rgw_shard.py`` runs once per package on the
same pinned clock and tokens (``test_torch_rbd.both_services``), with
equal observations: every ``IoCtx`` call's outcome (each shard object's
omap included) and the stores at each cluster's stop.  Tolerance 0.
"""

from __future__ import annotations

import sys

import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import cases  # noqa: E402
from test_torch_rbd import both_services  # noqa: E402

SHARD_CASES = cases("test_rgw_shard")


def test_the_cases_are_the_reference_modules():
    assert len(SHARD_CASES) == 5


@pytest.mark.parametrize("case", SHARD_CASES)
def test_rgw_shard_case_matches_reference(case):
    both_services("test_rgw_shard", case)


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_shard_names_and_keys_match_the_reference(n):
    from ceph_tpu.cls import rgw as ref_cls
    from ceph_tpu.services import rgw as ref
    from ceph_tpu_torch.cls import rgw as port_cls
    from ceph_tpu_torch.services import rgw as port
    keys = [f"k{i:03d}/x" for i in range(64)] + ["", "a" * 300, "ü/ß"]
    assert [port_cls.shard_of_key(k, n) for k in keys] == \
        [ref_cls.shard_of_key(k, n) for k in keys]
    for layout in (None, {"shards": n}, {"shards": n, "gen": 3}):
        assert [port._owning_oid("b", k, layout) for k in keys] == \
            [ref._owning_oid("b", k, layout) for k in keys]
        assert port._shard_oids("b", layout) == ref._shard_oids("b", layout)
