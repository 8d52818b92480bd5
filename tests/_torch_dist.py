"""Run a function on N gloo ranks of one process group, each rank a spawned
process, for the port's multi-rank tests on the CPU.

    run_ranks(fn, world, tmp_path, *args, timeout=120) -> [fn's result a rank]

The ranks meet through a FileStore under the test's tmp_path (no port, so
parallel test workers never collide) and run fn(rank, world, *args) with
one CPU thread each. fn must be importable by the children (a module-level
function) and return something picklable. Every wait is bounded: a rank
that raises, dies or hangs in a collective past `timeout` fails the test,
and every child still alive is killed.

This module imports no JAX: the children start with torch alone.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
import uuid


def _child(fn, rank, world, store_path, args, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = {}
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} ranks "
                                   f"still running after {timeout} s")
            try:
                rank, ok, result = out.get(timeout=min(left, 2.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{result}")
            results[rank] = result
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# rank bodies of tests/test_torch_parallel.py (module-level: the children
# import them)
# ---------------------------------------------------------------------------

def tp_cadc_rank(rank, world, x, w, xbar):
    """tp_cadc_linear at fp32 and bf16 wire and tp_vconv_linear on this
    rank, the dtypes handed to all_reduce, and whether a weight of 6
    segments is refused over 4 ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import tp_cadc

    x = torch.from_numpy(x)
    w_seg = tp_cadc.segment_weights(torch.from_numpy(w), xbar)
    wire, real = [], dist.all_reduce

    def spy(t, *a, **k):
        wire.append(str(t.dtype))
        return real(t, *a, **k)

    dist.all_reduce = spy
    try:
        y32 = tp_cadc.tp_cadc_linear(x, w_seg, fn="relu", wire_dtype=None)
        wire32 = wire[:]
        y16 = tp_cadc.tp_cadc_linear(x, w_seg, fn="relu")
        wire16 = wire[len(wire32):]
        yv = tp_cadc.tp_vconv_linear(x, w_seg)
    finally:
        dist.all_reduce = real
    try:
        tp_cadc.tp_cadc_linear(x[:, :6 * xbar], w_seg[:6])
        refused = False
    except ValueError:
        refused = True
    return {"y32": y32.numpy(), "y16": y16.numpy(), "yv": yv.numpy(),
            "wire32": wire32, "wire16": wire16, "refused": refused,
            "dtypes": (str(y32.dtype), str(y16.dtype))}


def ternary_rank(rank, world, w, x):
    """ternary_linear with the int8 code shards gathered over the group,
    the dtype on the wire; and DTensor's local block under
    sharding.placements against fsdp.shard, for two specs."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import comm, fsdp, sharding
    from repro_torch.parallel import ternary_store as ts

    w, x = torch.from_numpy(w), torch.from_numpy(x)
    t = ts.encode(w)
    rows = w.shape[0] // world
    local = {"codes": t["codes"][rank * rows:(rank + 1) * rows],
             "scale": t["scale"]}
    wire, real = [], comm._all_gather

    def spy(out, src, *a, **k):
        wire.append(str(src.dtype))
        return real(out, src, *a, **k)

    comm._all_gather = spy
    try:
        y = ts.ternary_linear(x, local, gather_codes=True)
    finally:
        comm._all_gather = real
    mesh = mesh_lib.Mesh(("data", "model"), (world, 1))
    dm = mesh_lib.device_mesh(mesh, "cpu")
    same = []
    for spec in (sharding.P("data", "model"), sharding.P(None, "data")):
        dt = distribute_tensor(w, dm, sharding.placements(spec, mesh))
        same.append(torch.equal(dt.to_local(), fsdp.shard(
            w, sharding.data_dim(spec), rank, world)))
    return {"y": y.numpy(), "wire": wire, "dtensor_same": same}
