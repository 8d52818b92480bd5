#!/usr/bin/env python3
"""K5's int8 tap kernel under edited tile tables and edited bodies, on one
card.

    python3 tools/profile_k5_variants.py [--set tiles|diag] [--out PATH]

Builds copies of csrc/cadc_conv.cu whose `q8_tap_by_tile` table (tile,
warp tile, ring stages) or kernel body is edited, one nvcc per copy, all
at once, into build/k5_variants/, and times each copy's launches at every
tap-aligned conv shape of a VGG-16 and a ResNet-18 q8 eval batch (batch
128, crossbar 64, relu, no gate, the [Cout, D] codes made once) with
chip_smoke.device_ms (a CUDA graph over inputs rotating through copies that
hold 3x the L2). Sets:

  tiles  s3 / s4 / s6: the tiles 128 x 64 (warps of 64 x 32), 64 x 64,
         64 x 32 and 32 x 32 (warps of 32 x 32) with 3, 4 or 6 ring
         stages; w32: 128 x 64 in warps of 32 x 32, 4 stages; t128:
         128 x 128 in warps of 64 x 32, 3 stages. Every copy's output is
         checked bitwise against the plain version.
  diag   s3; s3 with each k-tile's tap and channel found by two integer
         divisions (divide) in place of the cursor that steps with the
         loads (the same function: checked bitwise); and s3 without the y
         store (nostore), with the mma replaced by an xor of its operands
         (nomma), with one segment end instead of one per segment
         (oneepi), and with all three (nothing): what each part of the
         kernel costs (timing only: no longer K5).

Prints each shape's times, the sum over a batch of each copy at its best
tile and, last, the card's name and power limit; --out writes the record
as JSON. Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

OUT_DIR = os.path.join(REPO, "build", "k5_variants")


def _tiles(stages, wide_warp=64):
    return [(128, 64, wide_warp, 32, stages), (64, 64, 32, 32, stages),
            (64, 32, 32, 32, stages), (32, 32, 32, 32, stages)]


_NO_STORE = ("      const int m = m0 + wm0 + mi * 16 + h * 8 + g;\n"
             "      if (m >= p.M) continue;",
             "      const int m = m0 + wm0 + mi * 16 + h * 8 + g;\n"
             "      if (m >= p.M || p.M > 0) continue;")
_NO_MMA = ("          mma_s8(ps[mi][ni], a[mi], b[ni][0], b[ni][1]);",
           "          ps[mi][ni][0] += a[mi][0] ^ b[ni][0] ^ a[mi][3] ^ "
           "b[ni][1];")
_ONE_EPI = ("    if (++ks != kts && t + 1 != T) continue;",
            "    if (++ks, t + 1 != T) continue;")
_DIVIDE = ("  int i = 0, j = 0, c0 = chunk * 16;\n"
           "  auto load = [&](int t, int slot) {\n"
           "    unsigned char* as = smem8 + slot * C::kStageBytes;\n"
           "    unsigned char* bs = as + C::kABytes;\n"
           "    const int d0 = t * C::kRow;\n",
           "  auto load = [&](int t, int slot) {\n"
           "    unsigned char* as = smem8 + slot * C::kStageBytes;\n"
           "    unsigned char* bs = as + C::kABytes;\n"
           "    const int d0 = t * C::kRow;\n"
           "    const int tap = d0 / p.Cin;\n"
           "    int c0 = d0 - tap * p.Cin + chunk * 16;\n"
           "    int i = tap / p.K2, j = tap - i * p.K2;\n")
_DIAG_TILES = _tiles(3)[:3]
SETS = {
    "tiles": {"s3": (_tiles(3), []), "s4": (_tiles(4), []),
              "s6": (_tiles(6), []),
              "w32": ([(128, 64, 32, 32, 4)], []),
              "t128": ([(128, 128, 64, 32, 3)], [])},
    "diag": {"s3": (_DIAG_TILES, []),
             "divide": (_DIAG_TILES, [_DIVIDE]),
             "nostore": (_DIAG_TILES, [_NO_STORE]),
             "nomma": (_DIAG_TILES, [_NO_MMA]),
             "oneepi": (_DIAG_TILES, [_ONE_EPI]),
             "nothing": (_DIAG_TILES, [_NO_STORE, _NO_MMA, _ONE_EPI])},
}


# the diag copies that no longer compute K5
TIMING_ONLY = ("nostore", "nomma", "oneepi", "nothing")


def build(variants: dict) -> dict:
    """{name: loaded library} of every variant, built all at once."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "cadc_conv.cu").read_text()
    start = src.index("{", src.index("int q8_tap_by_tile(")) + 1
    end = src.index("return static_cast<int>(cudaErrorInvalidValue);", start)
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (tiles, subs) in variants.items():
        table = "".join(
            f"\n  if (bm == {bm} && bn == {bn}) return launch_q8_tap<{bm}, "
            f"{bn}, {wm}, {wn}, kKT, {st}, kGate>(p, stream);"
            for bm, bn, wm, wn, st in tiles)
        text = src[:start] + table + "\n  " + src[end:]
        for old, new in subs:
            if old not in text:
                sys.exit(f"profile_k5_variants: {name}: no {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", os.path.join(OUT_DIR, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            sys.exit(f"profile_k5_variants: {name} failed to build:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so"))
        lib.cadc_conv_q8_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19 + [ctypes.c_void_p])
        lib.cadc_conv_q8_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    import chip_smoke as cs
    from repro_torch.kernels import cadc_conv as cc

    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="tiles", choices=sorted(SETS))
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_k5_variants: needs a GPU")
    variants = SETS[args.set]
    libs = build(variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = torch.tensor(0.0123, device=dev)
    xbar = 64
    record = {}
    for model in ("vgg16", "resnet18"):
        shapes = {}
        for c in cs.conv_layers(model):
            if cc.tap_aligned(c[3], xbar):
                shapes[c[1:]] = shapes.get(c[1:], 0) + 1
        for (b, h, cin, k, cout, s, pad), count in shapes.items():
            oh = cs.conv_out_hw(h, k, s, pad)
            pt, pl, _, _ = cc._geometry((b, h, h, cin), (k, k, cin, cout),
                                        (s, s), pad)
            w = cs._codes(gen, dev, (k, k, cin, cout), -1, 2)
            wt = cc.q8_tap_weights(w)

            def make():
                return (cs._codes(gen, dev, (b, h, h, cin), -7, 8),)

            xs = [make()]
            xs += cs.rotation(make, xs[0][0].numel())[1:]
            pick = itertools.cycle(xs).__next__
            reps = max(20, len(xs))
            y = torch.empty(b, oh, oh, cout, device=dev)
            want, _ = cc.cadc_conv2d_q8_torch(
                xs[0][0], w, scale, crossbar_size=xbar, fn="relu",
                stride=(s, s), padding=pad)
            row = {}
            for name, lib in libs.items():
                for bm, bn, *_ in variants[name][0]:
                    def call(lib=lib, bm=bm, bn=bn, x=None):
                        x = pick()[0] if x is None else x
                        code = lib.cadc_conv_q8_launch(
                            x.data_ptr(), w.data_ptr(), wt.data_ptr(),
                            scale.data_ptr(), y.data_ptr(), None, b, h, h,
                            cin, k, k, cout, oh, oh, s, s, pt, pl, xbar,
                            1, 0, 1, bm, bn,
                            torch.cuda.current_stream().cuda_stream)
                        if code:
                            sys.exit(f"{name} {bm}x{bn}: CUDA error {code}")

                    call(x=xs[0][0])
                    torch.cuda.synchronize()
                    if name not in TIMING_ONLY and not torch.equal(y, want):
                        sys.exit(f"{name} {bm}x{bn}: differs from the plain "
                                 f"version")
                    row[f"{name}:{bm}x{bn}"] = cs.device_ms(call, reps)
            key = f"{model} B{b} H{h} C{cin} K{k} O{cout} s{s}"
            record[key] = {"count": count, "m": b * oh * oh, "ms": row}
            best = min(row, key=row.get)
            print(f"{key} x{count} (M {b * oh * oh}): best {best} "
                  f"{row[best]:.4f}; " + ", ".join(
                      f"{n} {v:.4f}" for n, v in row.items()), flush=True)
            del xs
    sums = {}
    for model in ("vgg16", "resnet18"):
        for name in variants:
            sums[f"{model} {name}"] = sum(
                r["count"] * min(v for n, v in r["ms"].items()
                                 if n.startswith(name + ":"))
                for key, r in record.items() if key.startswith(model))
            print(f"{model} per q8 eval batch, {name} at its best tile per "
                  f"shape: {sums[f'{model} {name}']:.4f} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "set": args.set, "xbar": xbar,
                       "shapes": record, "sums": sums}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
