"""ResNet-18 CADC training: `train/loop.py` `make_train_step` steps back
to back.

The step is `make_train_step(resnet18.apply, mode, adamw(lr))` with the
configuration's LayerMode (CADC, crossbar, relu, kernels 'auto': K3 and
the FC's K1g forward, the tap conv backward and K2 backward), fp32, TF32
off. Traffic: a replay set of image batches (drivers/_cnn.py); step i
takes batch i mod batches.

Set-up runs the first three steps through the window's own call and
keeps each step's loss, each leaf's gradient norm as AdamW got it at
step 1 (m1 = (1 - b1) g), each leaf's change after step 3, and each BN
running statistic's change after step 3; the check runs the plain
reference (reference/cnn.py) over the same batches from the same draw.
"""
from __future__ import annotations

import torch

from portbench.drivers import _cnn, _train
from portbench.harness import costs
from portbench.reference import cnn as ref_cnn

CHECKED = 3


def mode_of(c: dict):
    from repro_torch.models.common import LayerMode

    return LayerMode(impl=c["impl"], crossbar_size=c["crossbar_size"],
                     fn=c["dendritic_fn"], kernel=c["kernel"])


class Cell(_train.Checked):
    unit = "images"
    peak_dtype = "float32"
    # the control: every product in TF32 (fp32 with TF32 off stated),
    # which exists only on the card
    CONTROL = {"tf32": True}
    control_on_card = True

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans, fault=None):
        from repro_torch.models.cnn import resnet18
        from repro_torch.train import loop, optimizer

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.fault = device, fault
        t = config["train"]
        self.b1 = t["b1"]
        opt = optimizer.adamw(t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                              weight_decay=t["weight_decay"])
        self.step_fn = loop.make_train_step(resnet18.apply, mode_of(config),
                                            spans.wrap_optimizer(opt))
        self.params, self.state = _cnn.draw(config, seed, device)
        self.order = [k for k, _ in _cnn.leaves(self.params)]
        self.opt_state = opt.init(self.params)
        self.batches = _cnn.images(config, traffic, seed, device)
        self.losses = []
        for i in range(CHECKED):
            self.call(i)
            self.losses.append(self.last_loss)
            if i == 0:
                self.grad1 = _cnn.norms(self.opt_state["m"]) / (1 - self.b1)
        p0, s0 = _cnn.draw(config, seed, device)
        self.delta = _cnn.delta_norms(self.params, p0).tolist()
        self.state_delta = _cnn.delta_norms(self.state, s0).tolist()
        del p0, s0
        self.losses = torch.stack(self.losses).tolist()
        self.grad1 = self.grad1.tolist()
        self.first_call = CHECKED

    def batch(self, i: int) -> dict:
        b = self.batches[i % len(self.batches)]
        if self.fault == "half":
            n = b["label"].shape[0] // 2
            b = {k: v[:n] for k, v in b.items()}
        return b

    def call(self, i: int) -> int:
        params, state, opt_state, metrics = self.step_fn(
            self.params, self.state, self.opt_state, self.batch(i), i)
        if self.fault != "unchanged":
            self.params, self.state, self.opt_state = params, state, \
                opt_state
        self.last_loss = metrics["loss"]
        return self.traffic["batch"]

    # -- the yardstick's view of a step -------------------------------
    def products(self, i: int) -> list:
        """Each conv forward and backward (the stem's backward: dw only,
        the image takes no gradient), the FC forward and backward."""
        c, b = self.config, self.traffic["batch"]
        out = []
        for name, hw, cin, cout, k, stride in _cnn.convs(c):
            out.append(costs.conv("cadc", b, hw, hw, cin, cout, k, stride,
                                  "float32"))
            out.append(costs.conv("cadc", b, hw, hw, cin, cout, k, stride,
                                  "float32", backward=True,
                                  dx=name != "stem"))
        m, d, n = b, _cnn.fc_in(c), c["num_classes"]
        out.append(costs.matmul("cadc", m, d, n, "float32"))
        out.append(costs.matmul("cadc", m, d, n, "float32", backward=True))
        return out

    def model_flops(self, i: int) -> float:
        """3x the forward FLOPs of the convs and the FC."""
        return 3.0 * _cnn.forward_flops(self.config) * self.traffic["batch"]

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        del self.params, self.state, self.opt_state, self.step_fn
        self.last_loss = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def records(self) -> dict:
        return {**super().records(), "state": self.state_delta}

    def reference(self, tf32: bool = False, half: bool = False) -> dict:
        """The reference's three steps over the same batches (tf32: the
        control, its products in TF32; half: half of each batch)."""
        p, s = _cnn.draw(self.config, self.seed, self.device)
        return ref_cnn.train(p, s, self.batches[:CHECKED], self.config,
                             tf32=tf32, half=half,
                             regen=lambda: _cnn.draw(self.config, self.seed,
                                                     self.device))
