"""Small sizes of the benchmark's cells for the CPU tests: every width
cut, the program's plain PyTorch paths (kernels 'auto' on CPU tensors)."""
import argparse
import time

import torch

# fp32 on the wire: the plain path's psums are then fp32, as the card's
# kernels keep them (its bf16 path rounds psums to bf16)
LM = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
          intermediate_size=128, vocab_size=512, num_hidden_layers=2,
          crossbar_size=32, dtype="float32", bf16_wire=False)
CNN = dict(width=8, image_hw=8, crossbar_size=16)
TRAFFIC = {
    "phi4mini-train-s2048": dict(rows=4, seq=32, micro=2, batches=4),
    "phi4mini-prefill-s256-2048": dict(prompts=3, calls=3, min_len=8,
                                       max_len=40, pad_multiple=8),
    "resnet18-train-b512": dict(batch=8, batches=4),
    "resnet18-q8-b1000": dict(batch=8, batches=3),
}
CELLS = tuple(TRAFFIC)
SEED = 2 ** 31 + 5
CPU = torch.device("cpu")


def config_over(cell: str) -> dict:
    return LM if cell.startswith("phi4") else CNN


def run(cell: str, fault=None, seed: int = SEED, bench=None) -> dict:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.2,
                              trace=0)
    from portbench.harness import main

    return main.run_cell(args, t_start=time.perf_counter(), device=CPU,
                         bench=bench, config_over=config_over(cell),
                         traffic_over=TRAFFIC[cell], fault=fault)


def cell_parts(cell: str):
    """(config, traffic, driver Cell class) at the small size."""
    from portbench.harness import registry

    b = registry.Bench()
    spec = b.cell(cell)
    config = {**b.config(spec["config"]), **config_over(cell)}
    traffic = {**b.traffic(spec["traffic"]), **TRAFFIC[cell]}
    return config, traffic, b.driver(traffic["driver"]).Cell
