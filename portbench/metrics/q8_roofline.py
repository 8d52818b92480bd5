"""q8_roofline.<cell kind>: the int8 CADC products' share of their
roofline (%): kernels/ops.py's cadc_conv2d_q8 (K5) and cadc_matmul_q8
(K4) against the int8 peak and the bytes of int8 codes in, fp32 out."""
from portbench.harness import spans
from portbench.metrics._roofline import share

LABELS = (spans.Q8,)


def read(run):
    return share(run, "q8", LABELS)
