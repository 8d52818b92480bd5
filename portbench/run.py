"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA device. It
measures `repro_torch` (under src/); see portbench/harness/main.py for
the result line and PERF.md for the cells and metrics.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHECKOUT = os.path.dirname(_HERE)
# the script's own folder off the path (its subfolders are not top-level
# packages); the checkout (portbench) and src (repro_torch) on it
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
for _p in (os.path.join(_CHECKOUT, "src"), _CHECKOUT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
