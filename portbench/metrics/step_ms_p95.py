"""step_ms_p95: the 95th percentile of every step's or batch's time in
the window, each the gap between consecutive end-of-call CUDA events
recorded with no synchronize."""
from portbench.harness import timing


def read(run):
    return timing.p95(run.window.call_ms)
