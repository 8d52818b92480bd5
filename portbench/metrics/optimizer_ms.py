"""optimizer_ms.<cell kind>: device ms a step of the operations launched
inside the benchmark's range around Optimizer.update (train/optimizer.py
AdamW, the clip included), from the layer window's trace."""
from portbench.harness import spans

LABELS = (spans.OPTIMIZER,)


def read(run):
    s = run.label_s(LABELS)
    return 1e3 * s if s > 0 else None
