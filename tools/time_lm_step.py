"""Time the gemma3-1b LM train step of one checkout on the card.

    python3 tools/time_lm_step.py TREE

TREE is a checkout (a `git archive` unpacked under build/). Runs its
launch/train.py at full width (CADC relu at crossbar 256, 8 x 1024 tokens
in 4 micros, 5 steps) at one rank on NCCL, then 4 more steps of the CLI's
step timed by CUDA events, the peak memory, and the twin of
examples/lm_cadc_train.py (200 steps, wall seconds). Prints one line
"AB {json}". Compare two checkouts only within one call, in turns:
parent, change, change, parent.
"""
import json, os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(tree, "src"))
import torch
import torch.distributed as dist
from repro_torch.kernels import _build
from repro_torch.launch import train, lm_cadc_train

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
_build.build()
build_s = time.perf_counter() - t0
dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                        device_id=dev)
out = train.main(["--arch", "gemma3_1b", "--cadc", "--crossbar", "256",
                  "--steps", "5", "--batch", "8", "--seq", "1024",
                  "--microbatch", "4", "--log-every", "1", "--device", "cuda"])
step, state = out["train_step"], [out["params"], out["opt_state"]]
from repro_torch.data import synthetic
data = synthetic.make_lm_dataset(synthetic.LMTokenSpec(
    vocab_size=out["cfg"].vocab_size, seq_len=1024), device=dev)
ev = []
for i in range(4):
    b = train.make_batch(data(5 + i, 8)["tokens"], out["cfg"], 1024)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    state[0], state[1], m = step(state[0], state[1], b, 5 + i)
    e.record(); torch.cuda.synchronize()
    ev.append(s.elapsed_time(e))
peak = torch.cuda.max_memory_allocated()
del out, step, state
torch.cuda.empty_cache()
t0 = time.perf_counter()
lm_cadc_train.main(["--steps", "200", "--device", "cuda"])
twin = time.perf_counter() - t0
dist.destroy_process_group()
print("AB " + json.dumps({"tree": sys.argv[1], "event_step_ms": ev, "peak_gib": peak / 2**30,
                          "twin_s": twin, "build_s": build_s}), flush=True)
