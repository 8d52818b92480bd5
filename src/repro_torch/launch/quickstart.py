"""Quickstart: the CADC op in a minute.

    python -m repro_torch.launch.quickstart [--device cpu]

Twin of examples/quickstart.py. Shows the paper's eq. (4) on one linear
layer: the crossbar partitioning, the dendritic f(), the psum sparsity it
induces, and the CADC matmul kernel (K1, csrc/cadc_matmul.cu) agreeing
with the sequential oracle (kernels/ref.py). On a CUDA device (the
default) K1 runs through kernels.ops.cadc_matmul and its launches are
counted; with --device cpu the run takes the kernel's plain version and
says so. Fails unless every check holds.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as device_lib
from repro_torch.core import cadc, sparsity
from repro_torch.kernels import cadc_matmul as cm
from repro_torch.kernels import ops, ref

XBAR = 64                           # physical crossbar rows (64 x 64)
KERNEL_TOL = 1e-3                   # the JAX quickstart's kernel bound


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=device_lib.DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(8, 512, generator=gen).to(dev)             # [B, D]
    w = (torch.randn(512, 256, generator=gen) / 22.6).to(dev)

    # --- vanilla crossbar-partitioned matmul (paper eq. 3) ---------------
    s = cadc.num_segments(512, XBAR)
    y_v, ps_v = cadc.vconv_matmul(x, w, crossbar_size=XBAR,
                                  return_psums=True)
    print(f"contraction D=512 split into S={s} crossbars of {XBAR} rows")
    print(f"vConv: psums/output={s}, psum sparsity="
          f"{float(sparsity.psum_sparsity(ps_v)):.1%}  (nothing to skip)")
    # exactness: vConv is the plain matmul (partitioning is linear)
    if not torch.allclose(y_v, x @ w, atol=1e-4):
        raise RuntimeError("vConv differs from the plain matmul")

    # --- CADC: dendritic f() per crossbar BEFORE accumulation (eq. 4) ----
    y_c, ps_c = cadc.cadc_matmul(x, w, crossbar_size=XBAR, fn="relu",
                                 return_psums=True)
    rho = float(sparsity.psum_sparsity(ps_c))
    print(f"CADC : psum sparsity={rho:.1%} -> zero-compressed to "
          f"{1 + (1 - rho) * 8:.1f} bits/psum (8b psums + bitmask), "
          f"{rho:.0%} of accumulations skipped")

    # --- the kernel (K1 on a CUDA device, its plain version on the CPU) --
    y_ref = ref.cadc_matmul_ref(x, w, crossbar_size=XBAR, fn="relu")
    before = cm.cadc_matmul_cuda.launches
    with torch.no_grad():
        y_k = ops.cadc_matmul(x, w, crossbar_size=XBAR, fn="relu")
    launches = cm.cadc_matmul_cuda.launches - before
    err = float((y_k.float() - y_ref).abs().max())
    if dev.type == "cuda":
        what = f"K1 (CUDA kernel, {launches} launch)"
        if launches != 1:
            raise RuntimeError(f"K1 launched {launches} times, not once")
    else:
        what = "K1's plain version (--device cpu: no kernel runs)"
    print(f"{what} max|err| vs oracle: {err:.2e}")
    if not err < KERNEL_TOL:
        raise RuntimeError(f"the CADC matmul is {err} from the oracle")

    # --- all four dendritic functions ------------------------------------
    for fn in ("relu", "sublinear", "supralinear", "tanh"):
        y, ps = cadc.cadc_matmul(x, w, crossbar_size=XBAR, fn=fn,
                                 return_psums=True)
        print(f"  f()={fn:12s} sparsity="
              f"{float(sparsity.psum_sparsity(ps)):.1%} "
              f"|y|={float(y.abs().mean()):.3f}")

    print("OK")
    return {"device": str(dev), "kernel_err": err, "launches": launches,
            "sparsity": rho}


if __name__ == "__main__":
    main()
