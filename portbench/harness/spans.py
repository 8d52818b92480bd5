"""The benchmark's own profiler ranges, placed from outside the program.

* `portbench.step`: each unit of work (the harness, around each call);
* `portbench.optimizer`: `Optimizer.update` of the optimizer the
  benchmark builds and hands to the step builder (`wrap_optimizer`);
* `portbench.cadc`: the float CADC entries of `kernels/ops.py`
  (`cadc_matmul`, `cadc_conv2d`), and `portbench.q8` the int8 ones
  (`cadc_matmul_q8`, `cadc_conv2d_q8`);
* `portbench.layer`: an LM layer's forward (`transformer._layer_train`),
  which under remat runs again inside the backward node that first
  reads its saved tensors: the range keeps the recompute's operations
  out of that node's;

patched onto their modules while the layer window runs (`install`).

The ranges are open only while `Spans.on` is set, so the measured window
runs the program as it is.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

STEP = "portbench.step"
OPTIMIZER = "portbench.optimizer"
CADC = "portbench.cadc"
Q8 = "portbench.q8"
LAYER = "portbench.layer"
ENTRIES = (("repro_torch.kernels.ops", "cadc_matmul", CADC),
           ("repro_torch.kernels.ops", "cadc_conv2d", CADC),
           ("repro_torch.kernels.ops", "cadc_matmul_q8", Q8),
           ("repro_torch.kernels.ops", "cadc_conv2d_q8", Q8),
           ("repro_torch.models.lm.transformer", "_layer_train", LAYER))


class Spans:
    def __init__(self):
        self.on = False

    def range(self, label: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(label)

    def wrap_optimizer(self, opt):
        """The same optimizer, its update inside `portbench.optimizer`."""
        from repro_torch.train.optimizer import Optimizer

        def update(*a, **kw):
            with self.range(OPTIMIZER):
                return opt.update(*a, **kw)

        return Optimizer(opt.init, update)

    @contextlib.contextmanager
    def install(self):
        """Ranges on, and the entries wrapped, inside the block."""
        import importlib

        from torch.profiler import record_function

        saved: List[Tuple[object, str, Callable]] = []
        for module, name, label in ENTRIES:
            mod = importlib.import_module(module)
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with record_function(_label):
                    return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
        self.on = True
        try:
            yield
        finally:
            self.on = False
            for mod, name, fn in saved:
                setattr(mod, name, fn)
