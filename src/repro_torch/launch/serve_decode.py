"""Continuous-batching serving over the CADC decode path.

    python -m repro_torch.launch.serve_decode [--device cpu]

Twin of examples/serve_decode.py. Serves a smoke-size gemma3 (5:1
local:global attention, MQA) through the serve CLI (launch/serve.py): 8
synthetic Poisson requests over 4 slots, so the run exercises admission
queueing, finished-sequence eviction and slot / paged-block reuse — once
with dense matmuls and once with CADC linears plus live psum-sparsity
telemetry, printing throughput for both. On a CUDA device (the default)
the CADC linears run K1 and the attention K6; tests/test_torch_serve.py
holds the paged caches bitwise to the dense ones.
"""
from __future__ import annotations

import argparse

from repro_torch import device as device_lib
from repro_torch.launch import serve as serve_cli


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=device_lib.DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    out = []
    for cadc in (False, True):
        argv_ = ["--arch", "gemma3_1b", "--smoke", "--slots", "4",
                 "--requests", "8", "--rate", "0.5",
                 "--prompt-len", "16", "--gen", "16",
                 "--device", args.device]
        if cadc:
            argv_ += ["--cadc", "--telemetry-every", "4"]
        out.append(serve_cli.main(argv_))
    return out


if __name__ == "__main__":
    main()
