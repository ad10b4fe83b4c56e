"""The LDP and secure-aggregation cells of the scenario matrix on the
port's distributed step against the reference's, four ranks, on the CPU:
``tests/test_torch_train_scenarios.py``'s launch and gates, cut over two
launches so that the two halves run side by side.
"""
import pytest

pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from test_torch_train_scenarios import LDP_CELLS, check_cell, launch  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch(tmp_path_factory, LDP_CELLS, [])


@pytest.mark.parametrize("name", LDP_CELLS)
def test_scenario_cell_matches_reference_step(runs, name):
    check_cell(runs, name)
