"""The port's cut-multigrid CG iteration counts at 80^2 (and, marked
slow, 160^2) against live gdm under x64, in float64 on the CPU: the
step85 stiffness and implicit-heat systems of gdm's
tests/test_cut_multigrid.py at rel 1e-8, each count equal to gdm's and
to chip_smoke.py's constants; and, marked slow, live gdm's count at
256^2 (14, where gdm's documents say 26).  Apart from tests/test_torch_cut_multigrid.py
because gdm's two solves at 80^2 take about 40 s on one CPU worker."""

import pytest

from test_torch_cut_multigrid import _counts, check_counts


def test_mg_cg_counts_match_gdm_80():
    check_counts(80)


@pytest.mark.slow
def test_mg_cg_counts_match_gdm_160():
    check_counts(160)


@pytest.mark.slow
def test_mg_cg_counts_match_live_gdm_256():
    """At 256^2 gdm's documents give 26 iterations (BASELINE.md round 5,
    the comment in tests/test_cut_multigrid.py); live gdm under x64
    takes 14, and so does the port."""
    counts = _counts(256)
    assert counts["step85"] == (14, 14), counts
