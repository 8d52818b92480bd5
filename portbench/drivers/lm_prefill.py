"""Serving prefill: the port's batched prefill step over ragged prompts.

The step is `launch/steps.py` `make_batched_prefill_step(cfg)` on the
compute-dtype parameters `cast_compute(params, cfg)`, as the serve
engine holds them, called as the engine calls it (tokens [prompts,
S_pad] int64, zero past each prompt; `lengths` int32). Traffic: a
replay set of `calls` calls of `prompts` prompts. The lengths are the
same for every seed: prompts x calls quantiles of a log-uniform law on
[min_len, max_len], sorted and dealt so that each call holds one from
each of `prompts` strata (so each call pads to nearly the same length);
the seed orders the calls and the rows in them, and draws the token ids
(uniform over the vocab, on the device). Each call pads to its longest
prompt, rounded up to `pad_multiple`. Set-up runs one call of each
padded length the traffic has (its shapes) and the checked calls.

The check takes the call that holds the longest prompt and one more
drawn from the seed, as the window last produced them, and holds each
prompt's last-position logits and every layer's (k, v) over its own
positions to the plain reference run on that prompt alone
(reference/lm.py `prefill`).
"""
from __future__ import annotations

import torch

from portbench.drivers import _lm
from portbench.harness import compare, costs
from portbench.reference import lm as ref_lm


def lengths(t: dict) -> list:
    """The traffic's prompt lengths, ascending."""
    n = t["prompts"] * t["calls"]
    lo, hi = t["min_len"], t["max_len"]
    return sorted(round(lo * (hi / lo) ** ((i + 0.5) / n)) for i in range(n))


def calls(t: dict, seed: int) -> list:
    """[(row lengths) of each call], in the seed's order."""
    ls, k = lengths(t), t["calls"]
    gen = torch.Generator().manual_seed(seed)
    out = []
    for j in range(k):
        rows = [ls[j + k * r] for r in range(t["prompts"])]
        perm = torch.randperm(len(rows), generator=gen).tolist()
        out.append([rows[p] for p in perm])
    order = torch.randperm(k, generator=gen).tolist()
    return [out[j] for j in order]


class Cell:
    unit = "tokens"
    peak_dtype = "bfloat16"

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans, fault=None):
        from repro_torch.launch import steps

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.fault = device, fault
        cfg = self.cfg = _lm.arch(config, traffic)
        w = _lm.draw(config, seed, device, cfg.padded_vocab)
        tree = _lm.program_tree(w, cfg)
        # held to the port's layout by the check, after the window: the
        # serving path itself builds no tree on the meta device
        self.layout = _lm.shapes(tree)
        del w
        self.params = steps.cast_compute(tree, cfg)
        del tree
        self.step_fn = steps.make_batched_prefill_step(cfg)
        self.shapes = calls(traffic, seed)
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        pad = traffic["pad_multiple"]
        self.batches = []
        for rows in self.shapes:
            s_pad = -(-max(rows) // pad) * pad
            toks = torch.randint(0, config["vocab_size"], (len(rows), s_pad),
                                 generator=gen, device=device)
            live = torch.arange(s_pad, device=device)[None, :] < torch.tensor(
                rows, device=device)[:, None]
            self.batches.append(({"tokens": toks * live},
                                 torch.tensor(rows, dtype=torch.int32,
                                              device=device)))
        longest = max(range(len(self.shapes)),
                      key=lambda j: max(self.shapes[j]))
        other = [j for j in range(len(self.shapes)) if j != longest]
        pick = torch.randint(0, len(other), (1,),
                             generator=torch.Generator().manual_seed(seed + 3))
        self.sample = [longest, other[int(pick)]] if other else [longest]
        self.kept = {}
        warm = {self._s_pad(j): j for j in range(len(self.batches))}
        for j in sorted(set(warm.values()) | set(self.sample)):
            self.call(j)
        self.first_call = len(self.batches)

    def call(self, i: int) -> int:
        j = i % len(self.batches)
        batch, lens = self.batches[j]
        _, last, contribs = self.step_fn(self.params, batch, lens)
        if j in self.sample:
            if self.fault == "answer":
                last = last.clone()
                last[0, 0] += last[0].abs().max()
            self.kept[j] = (last, contribs)
        return sum(self.shapes[j])

    # -- the yardstick's view of a call ---------------------------------
    def _s_pad(self, i: int) -> int:
        return self.batches[i % len(self.batches)][0]["tokens"].shape[1]

    def products(self, i: int) -> list:
        """K1 on each linear of each layer over the call's padded rows."""
        c = self.config
        m = len(self.shapes[0]) * self._s_pad(i)
        return [costs.matmul("cadc", m, a, b, c["dtype"])
                for a, b in _lm.layer_shapes(c).values()
                ] * c["num_hidden_layers"]

    def model_flops(self, i: int) -> float:
        """Each prompt's useful work: 2·(the layers' weights) a token, the
        causal attention's 2·H·hd·L·(L + 1) a layer, and the head at the
        last position only; padding is not counted."""
        c, n = self.config, _lm.dims(self.config)
        weights = sum(a * b for a, b in _lm.layer_shapes(c).values())
        total = 0.0
        for ln in self.shapes[i % len(self.shapes)]:
            total += n["layers"] * (2 * weights * ln
                                    + 2 * n["h"] * n["hd"] * ln * (ln + 1))
            total += 2 * n["v"] * n["d"]
        return total

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        del self.params, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_weights(self) -> dict:
        w = _lm.draw(self.config, self.seed, self.device)
        dt = getattr(torch, self.config["dtype"])
        return {k: v.to(dt) for k, v in w.items()}

    def check(self) -> dict:
        _lm.check_layout(self.layout, self.cfg)
        return numbers(self.rows(self.reference_weights()))

    def controls(self) -> dict:
        """The control: the reference with every product's operands in
        fp8 e4m3 (bf16 stated), in the program's place."""
        w = self.reference_weights()

        def rows():
            for _, _, prompt in self.prompts():
                got, got_kv = ref_lm.prefill(w, prompt, self.config,
                                             ref_lm.fp8)
                want, want_kv = ref_lm.prefill(w, prompt, self.config)
                yield got, got_kv, want, want_kv

        return {"control": numbers(rows())}

    def prompts(self):
        """(call, row, the prompt's tokens) of the sample."""
        for j in self.sample:
            tokens = self.batches[j][0]["tokens"]
            for r, ln in enumerate(self.shapes[j]):
                yield j, r, tokens[r, :ln]

    def rows(self, w):
        """(got logits, got (k, v) by layer, the reference's) a prompt."""
        for j, r, prompt in self.prompts():
            last, contribs = self.kept[j]
            ln = prompt.shape[0]
            want, ref_kv = ref_lm.prefill(w, prompt, self.config)
            yield (last[r], [(k[r, :ln], v[r, :ln]) for k, v in contribs],
                   want, ref_kv)


def numbers(rows) -> dict:
    """logit_err: each prompt's last-position logits against the
    reference's, max |diff| over max |ref|; kv_err: each layer's k and v
    over the prompt's positions, ||diff|| over ||ref||. The worst prompt
    (and layer) of the sample."""
    logit, kv = [], []
    for got, got_kv, want, want_kv in rows:
        logit.append(compare.rel_err(got, want))
        for (k, v), (rk, rv) in zip(got_kv, want_kv):
            kv.append(max(compare.norm_err(k, rk), compare.norm_err(v, rv)))
    return {"logit_err": max(logit), "kv_err": max(kv)}
