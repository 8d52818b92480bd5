"""conv_roofline.<cell kind>: the share of their roofline (%) of the CADC
convs and FC layer: kernels/ops.py's float entries (K3, the FC's K1g) in
the forward, and the autograd nodes of their Functions (the tap conv
backward, K2) in the backward. The same reading as cadc_roofline, named
for the layer it reads in the CNN cells."""
from portbench.metrics.cadc_roofline import LABELS, read  # noqa: F401
