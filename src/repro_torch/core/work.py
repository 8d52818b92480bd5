"""The work a step executes: the tally that launch/dryrun.py `count_cost`
opens, and the hooks by which the port's CADC products add to it.

A CADC product is one unit of work, whichever route runs it (the CUDA
kernels K1 / K1g and K2, their plain versions, the inline einsum of the
LM's plain linear, core.cadc.cadc_einsum_segments): its FLOPs and bytes
come from its shapes and dtypes (`product_work`; the gate formats'
bytes: kernels/cadc_matmul.py `product_cost`), and the aten ops it runs
inside are not counted again. Two hooks mark it:

  * `counted(kind, cost)`, a decorator on a function that is one product
    (a kernel's wrapper and its plain version carry the same one);
  * `product(run, cost, *tensors, **params)` where the routes split and
    their surroundings differ (layers.linear_apply, the TP linears): the
    route's forward and, under autograd, its whole backward are one unit
    each, so the ops around the split are the same on every route.

Units nest: the outermost one counts. When no tally is open, each hook is
one read of a module global and a call: no sync and no allocation.
"""
from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor
# (forward, backward) of one product: each (flops, bytes)
Cost = Tuple[Tuple[int, int], Tuple[int, int]]


class Tally:
    """What a step executed: FLOPs and bytes (aten ops outside units plus
    the units), the aten ops' calls by name, the units by kind."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.ops = collections.Counter()       # aten op -> calls
        self.op_flops = collections.Counter()  # aten op -> FLOPs
        self.units = collections.Counter()     # kind -> units
        self.unit_flops = 0
        self.unit_bytes = 0
        self.depth = 0                         # > 0 inside a unit

    def add_op(self, name: str, flops: int, nbytes: int) -> None:
        self.ops[name] += 1
        self.op_flops[name] += flops
        self.flops += flops
        self.bytes += nbytes

    @contextlib.contextmanager
    def unit(self, kind: str, flops: int, nbytes: int):
        """One unit of `kind` while open (counted where it is the
        outermost); the ops inside are not counted."""
        if self.depth == 0:
            self.units[kind] += 1
            self.unit_flops += flops
            self.unit_bytes += nbytes
            self.flops += flops
            self.bytes += nbytes
        with self.hidden():
            yield

    @contextlib.contextmanager
    def hidden(self):
        """Count no op and no unit while open."""
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "units": dict(self.units), "unit_flops": self.unit_flops,
                "unit_bytes": self.unit_bytes,
                "ops": dict(sorted(self.ops.items())),
                "op_flops": {k: v for k, v in sorted(self.op_flops.items())
                             if v}}


_ACTIVE: Optional[Tally] = None


@contextlib.contextmanager
def open_tally():
    """Make a new Tally the one the hooks add to while open."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a work tally is already open")
    _ACTIVE = Tally()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = None


def quiet():
    """A context in which an open tally counts nothing: a collective's
    call, and the ops a backend runs inside it (gloo's reduce-scatter
    splits and copies; NCCL runs none); comm.record counts the
    collectives. A no-op with no tally open."""
    if _ACTIVE is None:
        return contextlib.nullcontext()
    return _ACTIVE.hidden()


def product_work(m: int, d: int, n: int, *, x_size: int, w_size: int,
                 gate_bytes: int = 0, need_dx: bool = True,
                 need_dw: bool = True, recompute: bool = False,
                 bwd_size: int = 4) -> Cost:
    """(forward, backward) (flops, bytes) of a CADC product of x [m, d] and
    w [d, n] (d in whole segments), as K1g and K2 do it. Forward: 2 m d n
    FLOPs; x and w read (elements of x_size / w_size bytes), the fp32 y
    and `gate_bytes` of gate written. Backward: 2 m d n FLOPs for each of
    dx and dw wanted, and again to recompute the psums where no gate was
    saved (`recompute`); g, x, w (elements of `bwd_size` bytes: 4 where K2
    reads fp32, 2 where its tensor-core route reads bf16) and the gate
    read, the fp32 dx and dw written."""
    mdn = 2 * m * d * n
    fwd = (mdn, m * d * x_size + d * n * w_size + 4 * m * n + gate_bytes)
    bwd = (mdn * (int(need_dx) + int(need_dw) + int(recompute)),
           bwd_size * (m * n + m * d + d * n) + gate_bytes
           + 4 * m * d * int(need_dx) + 4 * d * n * int(need_dw))
    return fwd, bwd


def counted(kind: str, cost: Callable[..., Tuple[int, int]]):
    """Decorate a function that is one CADC product of `kind`: while a
    tally is open, a call is one unit of cost(*args, **kwargs) (flops,
    bytes). The decorated function's `unit` is (kind, cost)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tally = _ACTIVE
            if tally is None:
                return fn(*args, **kwargs)
            with tally.unit(kind, *cost(*args, **kwargs)):
                return fn(*args, **kwargs)
        call.unit = (kind, cost)
        return call
    return wrap


def _keep(t):
    return t


class _Product(torch.autograd.Function):
    """A product's route as one node: the forward builds the route's own
    graph on detached inputs inside a "cadc_fwd" unit, the backward runs
    that graph inside a "cadc_bwd" unit. The inner graph keeps what it
    saves (the identity saved-tensor hooks): under a non-reentrant
    checkpoint no unpack inside the unit starts the layer's recompute,
    which another node's unpack starts and which counts as the forward it
    is."""

    @staticmethod
    def forward(ctx, run, params, tally, cost, *inputs):
        with tally.unit("cadc_fwd", *cost[0]):
            leaves = tuple(t.detach().requires_grad_() if t.requires_grad
                           else t for t in inputs)
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
                out = run(*leaves, **params)
            ctx.inner = (out, leaves)
            ctx.tally, ctx.cost = tally, cost
            # never read back: saved through the open hooks, as the
            # kernels' Function saves its operands, so that a checkpoint's
            # recompute (which ends after the last saved tensor) runs
            # this product again, as it runs K1g again
            ctx.save_for_backward(*inputs)
            return out.detach()

    @staticmethod
    def backward(ctx, g):
        out, leaves = ctx.inner
        del ctx.inner
        want = [t for t in leaves if t.requires_grad]
        with ctx.tally.unit("cadc_bwd", *ctx.cost[1]):
            grads = iter(torch.autograd.grad(out, want, g,
                                             allow_unused=True))
            return (None, None, None, None,
                    *(next(grads) if t.requires_grad else None
                      for t in leaves))


def product(run: Callable[..., Tensor], cost: Callable[..., Cost],
            *tensors: Tensor, **params) -> Tensor:
    """run(*tensors, **params), one CADC product: while a tally is open,
    its forward is one "cadc_fwd" unit of cost(*tensors, **params)[0]
    and, where a tensor wants a gradient, its backward one "cadc_bwd" unit
    of cost(...)[1] (module docstring). Inside another unit, or with no
    tally, run as is."""
    tally = _ACTIVE
    if tally is None or tally.depth:
        return run(*tensors, **params)
    c = cost(*tensors, **params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Product.apply(run, params, tally, c, *tensors)
    with tally.unit("cadc_fwd", *c[0]):
        return run(*tensors, **params)
