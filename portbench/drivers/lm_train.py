"""LM training: the port's FSDP train step at one rank, steps back to back.

The step is `launch/steps.py` `make_fsdp_train_step`, built as
`launch/train.py` builds it: a process group of one rank (NCCL on the
card), `make_local_mesh(1)`, the leaves' "data" dims, and
`make_optimizer(cfg)` (here inside the benchmark's optimizer range). At
one rank every leaf's block is the whole leaf, so the weights go in as
drawn. Traffic: a replay set of `batches` token blocks [rows, seq + 1]
drawn uniformly over the vocab from the seed on the device; step i takes
block i mod batches (inputs [:, :-1], labels [:, 1:]), cut into `micro`
microbatches.

Set-up runs the first three steps through the same call the window uses
(they compile and warm every shape), and keeps what the check needs:
each step's loss, each leaf's gradient norm as the optimizer got it at
step 1 (from AdamW's first moment: m1 = (1 - b1) g), and each leaf's
change after step 3 (against the weights drawn again from the seed).
The check runs the plain reference (reference/lm.py) over the same three
blocks from the same draw, once the program's state is gone.
"""
from __future__ import annotations

import torch

from portbench.drivers import _lm, _train
from portbench.harness import costs
from portbench.reference import lm as ref_lm

CHECKED = 3


class Cell(_train.Checked):
    unit = "tokens"
    # the control: every product's operands in fp8 e4m3 (bf16 stated)
    CONTROL = {"rnd": ref_lm.fp8}

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans, fault=None):
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch import steps
        from repro_torch.launch.train import join_group
        from repro_torch.parallel import fsdp

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.fault = device, fault
        cfg = self.cfg = _lm.arch(config, traffic)
        self._made_group = join_group(device)
        mesh = mesh_lib.make_local_mesh(1)
        shape = steps.abstract_params(cfg)
        base = steps.make_optimizer(cfg)
        self.b1 = 0.9   # make_optimizer's AdamW (train/optimizer.adamw)
        self.step_fn = steps.make_fsdp_train_step(
            cfg, mesh, fsdp.data_dims(shape, cfg, mesh),
            optimizer=spans.wrap_optimizer(base), n_micro=traffic["micro"])
        self.rows_vocab = cfg.padded_vocab
        w = _lm.draw(config, seed, device, self.rows_vocab)
        self.order = list(w)
        self.params = _lm.program_tree(w, cfg)
        _lm.check_layout(_lm.shapes(self.params), cfg)
        del w
        self.opt_state = base.init(self.params)
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        rows, seq = traffic["rows"], traffic["seq"]
        self.blocks = torch.randint(
            0, config["vocab_size"], (traffic["batches"], rows, seq + 1),
            generator=gen, device=device)
        self.tokens_per_step = rows * seq

        # the checked steps, through the window's own call
        vocab = config["vocab_size"]
        self.losses = []
        for i in range(CHECKED):
            self.call(i)
            self.losses.append(self.last_loss)
            if i == 0:
                self.grad1 = _lm.leaf_norms(self.opt_state["m"], vocab) \
                    / (1 - self.b1)
        w0 = _lm.draw(config, seed, device, self.rows_vocab)
        self.delta = _lm.delta_norms(self.params, w0, self.order, vocab)
        del w0
        self.losses = torch.stack(self.losses).tolist()
        self.grad1, self.delta = self.grad1.tolist(), self.delta.tolist()
        self.first_call = CHECKED

    def batch(self, i: int) -> dict:
        t = self.blocks[i % self.blocks.shape[0]]
        if self.fault == "half":
            t = t[: t.shape[0] // 2]
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def call(self, i: int) -> int:
        params, opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.batch(i), i)
        if self.fault != "unchanged":
            self.params, self.opt_state = params, opt_state
        self.last_loss = metrics["loss"]
        return self.tokens_per_step

    # -- the yardstick's view of a step -------------------------------
    def products(self, i: int) -> list:
        """The CADC products of a step: each linear of each layer, per
        micro, forward (twice under remat: the recompute) and backward."""
        t, c = self.traffic, self.config
        m = t["rows"] * t["seq"] // t["micro"]
        fwd = 2 if c["remat"] else 1
        out = []
        for d_in, d_out in _lm.layer_shapes(c).values():
            one = [costs.matmul("cadc", m, d_in, d_out, c["dtype"])] * fwd
            one.append(costs.matmul("cadc", m, d_in, d_out, c["dtype"],
                                    backward=True))
            out += one * (t["micro"] * c["num_hidden_layers"])
        return out

    peak_dtype = "bfloat16"

    def model_flops(self, i: int) -> float:
        """PaLM's count a token, 6·N + 12·L·(heads·head_dim)·S, N the
        linears' weights and the tied embedding once; no recompute."""
        c, n = self.config, _lm.dims(self.config)
        weights = sum(a * b for a, b in _lm.layer_shapes(c).values())
        big_n = n["layers"] * weights + n["v"] * n["d"]
        per_token = (6 * big_n + 12 * n["layers"] * n["h"] * n["hd"]
                     * self.traffic["seq"])
        return per_token * self.tokens_per_step

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        from torch import distributed as dist

        del self.params, self.opt_state, self.step_fn
        self.last_loss = None
        if self._made_group:
            dist.destroy_process_group()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rnd=None, half=False) -> dict:
        """The reference's three steps over the same blocks (rnd: the
        control's rounding of every product's operands; half: the
        reference with half of each batch left out)."""
        c, t = self.config, self.traffic
        w = ref_lm.weights(_lm.draw(c, self.seed, self.device))
        batches = [self.blocks[i] for i in range(CHECKED)]
        return ref_lm.train(w, batches, c, micro=t["micro"], rnd=rnd,
                            half=half,
                            regen=lambda: ref_lm.weights(_lm.draw(
                                c, self.seed, self.device)))
