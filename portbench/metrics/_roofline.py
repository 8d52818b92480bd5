"""The share of a layer's products' roofline: the least time the
yardstick's count of the traced units' products of `kind` needs
(harness/costs.py) over the device time of the operations launched in
that layer's ranges. None where the layer ran nothing."""
from portbench.harness import costs


def share(run, kind: str, labels) -> float:
    spent = run.label_s(labels)
    if spent <= 0 or not run.layer_calls:
        return None
    need = sum(costs.least_s(p for p in run.work.products(i) if p.kind == kind)
               for i in run.layer_calls) / len(run.layer_calls)
    if need <= 0:
        return None
    return 100.0 * need / spent
