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
