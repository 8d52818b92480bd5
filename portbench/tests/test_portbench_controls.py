"""Each cell's control, the reference computed a precision below what
the configuration states and put in the program's place, fails one of
the cell's limits; so does each fault of a training cell read in the
reference. At small sizes, through each driver's `controls()` and
`faults()` as portbench/tools/calibrate.py reads them at the cells'
sizes on the chip; a control that exists only on the card (TF32) runs
there."""
import pytest
import torch

from portbench.harness import registry, spans, timing
from portbench.tests import _small


def _cells():
    """Every cell; those whose control exists only on the card marked."""
    return [pytest.param(c, marks=pytest.mark.cuda)
            if getattr(_small.cell_parts(c)[2], "control_on_card", False)
            else c for c in _small.CELLS]


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


def _work(cell):
    config, traffic, Cell = _small.cell_parts(cell)
    device = _small.CPU
    if getattr(Cell, "control_on_card", False):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the control exists only on "
                        "the card")
        device = torch.device("cuda", 0)
    work = Cell(config, traffic, 9, device, spans.Spans())
    timing.closed_loop(work.call, 0.1, device, first=work.first_call)
    work.release()
    return work


@pytest.mark.parametrize("cell", _cells())
def test_control_fails(cell):
    work = _work(cell)
    limits = registry.Bench().limits(cell)["limits"]
    numbers = work.controls()["control"]
    assert _fails(numbers, limits), numbers


@pytest.mark.parametrize("cell", [
    c for c in _small.CELLS if hasattr(_small.cell_parts(c)[2], "faults")])
def test_each_fault_read_in_the_reference_fails(cell):
    config, traffic, Cell = _small.cell_parts(cell)
    work = Cell(config, traffic, 9, _small.CPU, spans.Spans())
    work.release()
    limits = registry.Bench().limits(cell)["limits"]
    faults = work.faults()
    assert faults
    for name, numbers in faults.items():
        assert _fails(numbers, limits), (name, numbers)
