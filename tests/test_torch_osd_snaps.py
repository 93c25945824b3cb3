"""Snapshots, watch/notify and cache tiering in the port's OSD core
against the JAX package's: every case of ``tests/test_snaps.py`` and
``tests/test_tiering.py`` runs once per package, and the observations
(every ``IoCtx`` outcome, the stores at each cluster stop) must be equal.
The harness is ``test_torch_osd``'s.  Tolerance 0."""

import pytest

from test_torch_osd import both, cases


@pytest.mark.parametrize("case", cases("test_snaps"))
def test_snaps_case_matches_reference(case):
    both("test_snaps", case)


@pytest.mark.parametrize("case", cases("test_tiering"))
def test_tiering_case_matches_reference(case):
    both("test_tiering", case)
