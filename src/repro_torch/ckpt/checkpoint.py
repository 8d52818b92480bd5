"""Local step-atomic checkpoints. Port of repro.ckpt.checkpoint.

  * one .npz a step: leaf i as `leaf_<i>`, and `__names__`, a JSON list
    of each leaf's path in the JAX package's `jax.tree_util.keystr` form
    ("['params']['conv1']['w']"), in its flatten order: dict keys sorted,
    list and tuple items by index, NamedTuple fields by name (".k"). A
    file written by either package restores in the other;
  * written to `<dir>/tmp.<step>.npz`, fsynced, then os.replace'd to
    `<dir>/step_<step>.npz`: a crashed writer leaves the newest complete
    checkpoint intact, and a stray tmp file is never read;
  * keep_k garbage collection;
  * `restore` onto any target tree of the same structure, each tensor on
    its target leaf's device (dtypes follow the saved arrays).

Trees are nested dicts, lists, tuples and NamedTuples of torch tensors
(or numpy arrays).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any
_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(keystr piece, child) pairs of an inner node in the JAX flatten
    order; None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree: PyTree) -> Tuple[List[str], List[Any]]:
    names, leaves = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            names.append(path)
            leaves.append(node)
            return
        for piece, child in kids:
            walk(child, path + piece)

    walk(tree, "")
    return names, leaves


def _unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """`leaves` (in _flatten order) rebuilt into the structure of `like`;
    dicts keep like's own key order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                 for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: PyTree, *, keep_k: int = 3) -> str:
    """Atomically write the checkpoint of `step`; keep the newest keep_k."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names, leaves = _flatten(tree)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.npz")
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    arrays["__names__"] = np.array(json.dumps(names))
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic on POSIX
    _gc(ckpt_dir, keep_k)
    return final


def _gc(ckpt_dir: str, keep_k: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_k] if keep_k > 0 else []:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.npz"))
        except OSError:
            pass


def all_steps(ckpt_dir: str) -> List[int]:
    """Steps with a complete checkpoint in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = _STEP_RE.match(fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: PyTree, *, step: Optional[int] = None
            ) -> Tuple[int, PyTree]:
    """Restore the newest (or the given) step onto the structure of `like`:
    (step, tree). Names and shapes must match `like`'s (ValueError
    otherwise); a tensor leaf lands on the device of like's leaf."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    with np.load(path, allow_pickle=False) as z:
        names = json.loads(str(z["__names__"]))
        arrays = [z[f"leaf_{i}"] for i in range(len(names))]
    want_names, want_leaves = _flatten(like)
    if names != want_names:
        raise ValueError(
            "checkpoint/target structure mismatch:\n"
            f"  saved  : {names[:5]}...\n  target : {want_names[:5]}...")
    leaves = []
    for n, have, want in zip(names, arrays, want_leaves):
        if have.shape != tuple(np.shape(want)):
            raise ValueError(f"shape mismatch at {n}: {have.shape} vs "
                             f"{tuple(np.shape(want))}")
        leaves.append(torch.as_tensor(have, device=want.device)
                      if isinstance(want, torch.Tensor) else have)
    return step, _unflatten(like, leaves)
