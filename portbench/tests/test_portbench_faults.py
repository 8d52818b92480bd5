"""A run with its timed path broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of the run driven at a
small size on the CPU, each fault the cell can have planted in the
program's path. One chip a cell: no exchange between chips to leave out.
"""
import pytest

from portbench.tests import _small

FAULTS = [
    ("phi4mini-train-s2048", "unchanged"),   # the step returns its state
    ("phi4mini-train-s2048", "half"),        # half the batch, mean of rest
    ("resnet18-train-b512", "unchanged"),
    ("resnet18-train-b512", "half"),
    ("resnet18-q8-b1000", "answer"),          # an answer altered
    ("phi4mini-prefill-s256-2048", "answer"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    r = _small.run(cell, fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", _small.CELLS)
def test_sound_run_is_correct_and_well_formed(cell):
    r = _small.run(cell)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    assert {"build_s", "cell_s"} <= set(r["setup_parts"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
