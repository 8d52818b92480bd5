"""The numbers that decide `correct`: gaps between what the program's
timed path produced and what the plain reference gives for the same
inputs. Every gap is a share of the reference's own scale, so a limit
reads the same at any width."""
from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under AdamW by round-off alone: its change is not compared
STILL = 1e-3


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Optional[Sequence[bool]] = None) -> Dict[int, float]:
    """Each kept leaf's |‖prog‖ - ‖ref‖| over the larger of its reference
    norm and the median leaf's, by leaf index."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return {i: abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx}


def leaf_gap(prog: Sequence[float], ref: Sequence[float],
             keep: Optional[Sequence[bool]] = None) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(prog, ref, keep).values())


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """loss_gap: the worst step's |loss - ref| / |ref|, loss1_gap: step
    1's (a cell's limits file says which it compares); grad_gap: step 1's
    gradient as the optimizer got it, by leaf norms; update_gap: the
    change after the checked steps, by leaf norms, over the leaves the
    reference's gradient moves (STILL); state_gap: the BN statistics'
    change, by leaf norms."""
    med = statistics.median(ref["grad"])
    keep = [g >= STILL * med for g in ref["grad"]]
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    out = {"loss_gap": max(loss), "loss1_gap": loss[0],
           "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
           "update_gap": leaf_gap(prog["delta"], ref["delta"], keep)}
    if "state" in ref:
        out["state_gap"] = leaf_gap(prog["state"], ref["state"])
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| over ||want||."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))
