"""ResNet-18 at the paper's 4/2/4b point: int8 inference over a test set.

Each call is `resnet18.apply(params, state, images, Ctx(q8 mode),
train=False)` under no_grad, as `train/loop.py` `make_eval_step` runs
it, with the q8 mode `chip_smoke.py` `q8_modes()` builds: CADC,
crossbar 64, relu, quant 4/2/4b, q8_fused (K5 on every conv, K4 on the
FC, the quantizers in PyTorch). Parameters and BN statistics: fp32 from
the seed (drivers/_cnn.py). Traffic: a `batches` x `batch` test set,
batch i mod batches.

The check holds every batch's logits, as the window last produced them,
to the plain reference (reference/cnn.py `forward_q8`), which works the
codes and scales out again from the fp32 parameters.
"""
from __future__ import annotations

import torch

from portbench.drivers import _cnn
from portbench.harness import compare, costs
from portbench.reference import cnn as ref_cnn


def mode_of(c: dict):
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.common import LayerMode

    q = c["q8"]
    return LayerMode(impl=c["impl"], crossbar_size=c["crossbar_size"],
                     fn=c["dendritic_fn"], kernel=c["kernel"],
                     quant=QuantConfig(input_bits=q["input_bits"],
                                       weight_bits=q["weight_bits"],
                                       adc_bits=q["adc_bits"]),
                     q8_fused=True)


class Cell:
    unit = "images"
    peak_dtype = "int8"

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans, fault=None):
        from repro_torch.models.cnn import resnet18
        from repro_torch.models.common import Ctx

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.fault = device, fault
        self.mode, self.ctx = mode_of(config), Ctx
        self.apply = resnet18.apply
        self.params, self.state = _cnn.draw(config, seed, device)
        self.batches = _cnn.images(config, traffic, seed, device)
        self.kept = {}
        for i in range(2):
            self.call(i)
        self.first_call = 2

    def call(self, i: int) -> int:
        j = i % len(self.batches)
        with torch.no_grad():
            logits, _ = self.apply(self.params, self.state,
                                   self.batches[j]["image"],
                                   self.ctx(self.mode), train=False)
        if self.fault == "answer":
            logits = logits.clone()
            logits[0, 0] += logits[0].abs().max()
        self.kept[j] = logits
        return self.traffic["batch"]

    # -- the yardstick's view of a batch --------------------------------
    def products(self, i: int) -> list:
        """K5 on every conv, K4 on the FC: int8 codes in, fp32 out."""
        c, b = self.config, self.traffic["batch"]
        out = [costs.conv("q8", b, hw, hw, cin, cout, k, stride, "int8",
                          out_dtype="float32")
               for _, hw, cin, cout, k, stride in _cnn.convs(c)]
        out.append(costs.matmul("q8", b, _cnn.fc_in(c), c["num_classes"],
                                "int8", out_dtype="float32"))
        return out

    def model_flops(self, i: int) -> float:
        return _cnn.forward_flops(self.config) * self.traffic["batch"]

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        del self.params, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def controls(self) -> dict:
        """The control: the reference with every fp32 stage in bf16 (its
        codes are exact), in the program's place."""
        return {"control": self.check(bf16=True)}

    def check(self, bf16: bool = False) -> dict:
        """logit_err: every batch's logits against the reference's, max
        |diff| over max |ref| (bf16: the control in the program's place)."""
        p, s = _cnn.draw(self.config, self.seed, self.device)
        errs = []
        for j, batch in enumerate(self.batches):
            want = ref_cnn.forward_q8(p, s, batch["image"], self.config)
            got = (ref_cnn.forward_q8(p, s, batch["image"], self.config,
                                      bf16=True) if bf16 else self.kept[j])
            errs.append(compare.rel_err(got, want))
        return {"logit_err": max(errs)}
