"""Scrub and repair in the port's OSD core against the JAX package's:
every case of ``tests/test_scrub.py`` runs once per package, and the
observations (every ``IoCtx`` outcome, the stores at each cluster stop)
must be equal.  The harness is ``test_torch_osd``'s.  Tolerance 0."""

import pytest

from test_torch_osd import both, cases


@pytest.mark.parametrize("case", cases("test_scrub"))
def test_scrub_case_matches_reference(case):
    both("test_scrub", case)
