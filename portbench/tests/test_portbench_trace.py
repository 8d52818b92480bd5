"""The trace's reduction on made-up events: busy time as a union of
intervals, each device operation attributed to the innermost named range
on its launching host op's stack, idle gaps to the next launch's host
activity."""
from portbench.harness import trace
from portbench.harness.trace import Ev


def host(name, a, b, corr, thread=1):
    return Ev(name, False, a, b, thread, corr, 0)


def dev(name, a, b, linked):
    return Ev(name, True, a, b, 0, 0, linked)


def test_union():
    busy, merged = trace.union_s([(0, 10), (5, 20), (30, 40)])
    assert busy == 30e-9 and merged == [[0, 20], [30, 40]]


def test_attribute_innermost_label_and_gaps():
    events = [
        dev(trace.MARKER, 0, 5, 0),
        host("portbench.step", 10, 1000, 1),
        host("portbench.cadc", 20, 100, 2),
        host("aten::mm", 30, 40, 3),
        host("portbench.optimizer", 200, 300, 4),
        host("aten::add_", 210, 220, 5),
        # the autograd thread: a backward node and a recompute inside it
        host("CadcMatmulFnBackward", 400, 600, 6, thread=2),
        host("portbench.layer", 410, 500, 7, thread=2),
        host("aten::softmax", 420, 430, 8, thread=2),
        dev("k1g", 100, 150, 3),
        dev("adam", 300, 340, 5),
        dev("softmax", 500, 520, 8),
        dev("k2", 520, 600, 6),
        dev("lost", 700, 710, 99),
    ]
    labels = ["portbench.step", "portbench.cadc", "portbench.optimizer",
              "portbench.layer", "CadcMatmulFnBackward"]
    by, gaps = trace.attribute(events, labels)
    assert by["portbench.cadc"] == 50e-9
    assert by["portbench.optimizer"] == 40e-9
    assert by["portbench.layer"] == 20e-9
    assert by["CadcMatmulFnBackward"] == 80e-9
    assert by["unlinked"] == 10e-9
    g = dict(gaps)
    assert g["portbench.optimizer / aten::add_"] == 150e-9
    assert g["portbench.layer / aten::softmax"] == 160e-9
    assert g["unlinked"] == 100e-9


def test_operations_before_the_markers_do_not_count():
    events = [dev("early", 0, 50, 0), dev(trace.MARKER, 60, 70, 0),
              dev("k", 80, 90, 0)]
    t0, after = trace._after_markers(events)
    assert t0 == 70 and [e.name for e in after] == ["k"]


def test_a_launch_from_outside_torch_sits_in_its_range():
    """A ctypes kernel launch has no torch op around it: its runtime call
    (same correlation id as the kernel) places it in the range."""
    events = [
        host("portbench.q8", 10, 100, 1),
        host("cudaLaunchKernel", 20, 25, 555),
        host("aten::round", 40, 60, 2),
        host("cudaLaunchKernel", 45, 50, 556),
        Ev("q8_tap_kernel", True, 30, 80, 0, 555, 0),
        Ev("round_kernel", True, 80, 90, 0, 556, 2),
    ]
    by, gaps = trace.attribute(events, ["portbench.q8"])
    assert by == {"portbench.q8": 60e-9}
