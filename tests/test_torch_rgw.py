"""The port's S3 gateway (``ceph_tpu_torch.services.rgw`` with ``rgw_gc``,
``rgw_usage`` and ``rgw_sync``) against the JAX package's, case by case.

Every case of ``tests/test_rgw.py`` runs once per package on the same
pinned clock and tokens (``test_torch_rbd.both_services``): the
reference test module as it is, with the repaired ``backoff``, and its
port reading on the CPU.  Both must pass their own assertions, and
their observations must be equal: every ``IoCtx`` call's outcome (object
names, omap entries and bytes) and the stores at each cluster's stop.
Tolerance 0.
"""

from __future__ import annotations

import sys

import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import BOTH, case_module, cases  # noqa: E402
from test_torch_rbd import both_services  # noqa: E402

RGW_CASES = cases("test_rgw")


def test_the_cases_are_the_reference_modules():
    assert len(RGW_CASES) == 19


@pytest.mark.parametrize("case", RGW_CASES)
def test_rgw_case_matches_reference(case):
    both_services("test_rgw", case)


def test_the_port_modules_are_their_own():
    for root in BOTH:
        mod = case_module("test_rgw", root)
        assert mod.S3Gateway.__module__ == root + ".services.rgw"
        gw_mod = sys.modules[root + ".services.rgw"]
        assert gw_mod.ObjectOperationError.__module__ == \
            root + ".client.objecter"


def test_the_index_shard_option_is_the_references():
    """``S3Gateway`` reads ``rgw_bucket_index_shards`` from its client's
    config: the port's option table carries it with the reference's type
    and default."""
    from ceph_tpu.common import config as ref
    from ceph_tpu_torch.common import config as port

    def opt(mod):
        o = next(o for o in mod.DEFAULT_OPTIONS
                 if o.name == "rgw_bucket_index_shards")
        return o.type, o.default
    assert opt(port) == opt(ref) == ("int", 1)
