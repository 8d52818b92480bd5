"""The yardstick's frozen counts: peaks, and the operations and bytes of a
product, whatever kernel or plan computes it.

Peaks: one NVIDIA H100 SXM (data sheet, dense rates, 700 W). A product
is counted once from its shapes: a forward 2·M·D·N operations, a
backward (dx and dw) 4·M·D·N; every operand read once and every result
written once, at the dtype the step holds it. Its least time is the
larger of its operations over the peak of its dtype and its bytes over
the HBM bandwidth.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Optional

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
SIZE = {"bfloat16": 2, "float32": 4, "int8": 1}


class Product(NamedTuple):
    """One product of a step: its layer kind ("cadc", "q8"), operations,
    bytes, and the dtype whose peak bounds its operations."""
    kind: str
    ops: float
    bytes: float
    dtype: str


def matmul(kind: str, m: int, d: int, n: int, dtype: str, *,
           out_dtype: Optional[str] = None,
           backward: bool = False) -> Product:
    """x [m, d] @ w [d, n] -> y [m, n]; backward: g [m, n], x and w read,
    dx [m, d] and dw [d, n] written."""
    s, so = SIZE[dtype], SIZE[out_dtype or dtype]
    if backward:
        return Product(kind, 4.0 * m * d * n,
                       float((m * n + m * d + d * n) * s
                             + (m * d + d * n) * s), dtype)
    return Product(kind, 2.0 * m * d * n,
                   float((m * d + d * n) * s + m * n * so), dtype)


def conv_out(size: int, stride: int) -> int:
    """SAME padding: ceil(size / stride)."""
    return -(-size // stride)


def conv(kind: str, b: int, h: int, w: int, cin: int, cout: int, k: int,
         stride: int, dtype: str, *, out_dtype: Optional[str] = None,
         backward: bool = False, dx: bool = True) -> Product:
    """A k x k SAME conv, NHWC: m = b·OH·OW rows, d = k·k·cin, n = cout;
    the bytes of the activation itself (read once), not of its patches.
    backward with dx=False: dw alone (an input that takes no gradient)."""
    oh, ow = conv_out(h, stride), conv_out(w, stride)
    m, d, n = b * oh * ow, k * k * cin, cout
    s, so = SIZE[dtype], SIZE[out_dtype or dtype]
    x, wt, y = b * h * w * cin, d * n, m * n
    if backward:
        if not dx:
            return Product(kind, 2.0 * m * d * n,
                           float((y + x) * s + wt * s), dtype)
        return Product(kind, 4.0 * m * d * n,
                       float((y + x + wt) * s + (x + wt) * s), dtype)
    return Product(kind, 2.0 * m * d * n, float((x + wt) * s + y * so),
                   dtype)


def least_s(products: Iterable[Product]) -> float:
    """The least time the products need on one chip."""
    return sum(max(p.ops / PEAK_OPS[p.dtype], p.bytes / HBM_BYTES_PER_S)
               for p in products)
