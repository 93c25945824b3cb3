"""The port's manager (``ceph_tpu_torch.services.mgr``: the module host,
its dashboard and balancer) against the JAX package's.

- ``tests/test_mgr_tools.py``'s mgr case and its two mon-side cases (the
  reweight by utilization the balancer applies, the fsmap an MDS
  registers in) run once per package on the same pinned clock and tokens
  (``test_torch_rbd.both_services``), with equal observations.
- The balancer's evaluation and the dashboard's routes, on a recording
  stand-in for the client's mon commands: the same commands and the same
  answers in both packages.

Tolerance 0.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_osd import PORT, REF, cases  # noqa: E402
from test_torch_rbd import both_services  # noqa: E402

#: the cases of tests/test_mgr_tools.py that drive the mgr or the mon
#: state it reads; the rest hold lockdep and two tools the port tests of
#: earlier slices hold (test_torch_common, test_torch_tools,
#: test_torch_store_tools)
MGR_CASES = ("test_mgr_dashboard_and_balancer_over_cluster",
             "test_reweight_by_utilization_moves_weight",
             "test_fsmap_registration_and_config_key")


def test_the_cases_are_the_reference_modules():
    assert set(MGR_CASES) <= set(cases("test_mgr_tools"))


@pytest.mark.parametrize("case", MGR_CASES)
def test_mgr_case_matches_reference(case):
    both_services("test_mgr_tools", case)


def _pg_dump(seed):
    rng = np.random.default_rng(seed)
    stats = {}
    for pg in range(int(rng.integers(1, 64))):
        acting = [int(x) for x in rng.choice(12, 3, replace=False)]
        if rng.random() < 0.1:
            acting[-1] = -1
        stats[f"1.{pg:x}"] = {"acting": acting, "state": "active+clean"}
    return {"pg_stats": stats}


class _Admin:
    """A client's ``mon_command``, answering from fixed JSON and
    recording each command."""

    def __init__(self, replies):
        self.replies = replies
        self.sent = []

    async def mon_command(self, cmd):
        self.sent.append(json.dumps(cmd, sort_keys=True))
        return type("Ack", (), {"outs": json.dumps(
            self.replies.get(cmd["prefix"], {}))})()


@pytest.mark.parametrize("seed", range(4))
def test_the_balancer_and_dashboard_answer_as_the_references(seed):
    def run(root):
        mgr_mod = importlib.import_module(root + ".services.mgr")
        replies = {"pg dump": _pg_dump(seed),
                   "health": {"status": "HEALTH_OK"},
                   "osd dump": {"epoch": seed},
                   "status": {"fsid": "x", "seed": seed}}
        admin = _Admin(replies)
        mgr = mgr_mod.Mgr(admin)

        async def go():
            bal = mgr.get_module("balancer")
            dash = mgr.get_module("dashboard")
            ev = await bal.evaluate()
            routes = [await dash._route(p)
                      for p in ("/health", "/pgmap", "/osds", "/")]
            return json.dumps(ev, sort_keys=True), routes
        return asyncio.run(go()), admin.sent
    assert run(PORT) == run(REF)
