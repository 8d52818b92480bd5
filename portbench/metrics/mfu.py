"""mfu.<cell kind>: the whole step's model FLOPs a second over the
measured window (the cell's model_flops) as a share of the chip's peak
for the configuration's dtype (%, the peaks in harness/costs.py)."""
from portbench.harness import costs


def read(run):
    w, work = run.window, run.work
    first = work.first_call
    flops = sum(work.model_flops(i) for i in range(first, first + w.calls))
    return 100.0 * flops / w.seconds / costs.PEAK_OPS[work.peak_dtype]
