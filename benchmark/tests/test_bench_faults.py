"""Runs of the harness on the CPU with the program broken underneath: each
fault a spectrum cell can have makes ``correct`` come out false, and the
unbroken run comes out true.  The look for a card is skipped (the harness
is driven below ``run.py``) and the cells are the tiny ones of
:mod:`tiny`, added as files only."""

import os

import pytest

import tiny

PLANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plants.py")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


def run(root, workload, plant=None):
    res, proc = tiny.run_cpu(root, workload, plant=plant and f"{PLANTS}:{plant}")
    assert res is not None, proc.stderr[-4000:]
    return res


@pytest.mark.parametrize("workload", ["tiny_spectrum", "tiny_dp_spectrum"])
def test_unbroken_run_is_correct(root, workload):
    res = run(root, workload)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["info"]["queries_compared"] > 0
    # a reading the cell gives no limit is reported, not compared
    limits = tiny.TINY_CELLS[workload]["limits"]
    assert set(res["checks"]) == set(limits)
    assert set(res["info"]["not_compared"]) == {"top_gap", "bulk_gap", "abs_gap", "zeros_off"} - set(limits)


@pytest.mark.parametrize("workload,plant", [
    ("tiny_spectrum", "stale"),
    ("tiny_spectrum", "half_batch"),
    ("tiny_spectrum", "altered"),
    ("tiny_dp_spectrum", "stale"),
    ("tiny_dp_spectrum", "half_batch"),
    ("tiny_dp_spectrum", "altered"),
    ("tiny_dp_spectrum", "exchange_left_out"),
])
def test_fault_makes_the_run_incorrect(root, workload, plant):
    res = run(root, workload, plant)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] > 0
    over = [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]
    assert over, res["checks"]
