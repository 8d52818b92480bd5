"""cadc_roofline.<cell kind>: the CADC products' share of their roofline
(%): kernels/ops.py's float entries (K1 / K1g, K3) in the forward and the
remat recompute, and the autograd nodes of their Functions (K2, the tap
conv backward) in the backward."""
from portbench.harness import spans
from portbench.metrics._roofline import share

LABELS = (spans.CADC, "CadcMatmulFnBackward", "CadcConv2dFnBackward")


def read(run):
    return share(run, "cadc", LABELS)
