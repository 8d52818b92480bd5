"""What the training drivers share: the check of the first steps against
the plain reference, the control's readings and the faults' readings.

A training cell keeps, from its set-up's checked steps, `losses`,
`grad1` (each leaf's gradient norm as the optimizer got it at step 1),
`delta` (each leaf's change after the checked steps) and `order` (the
leaves' names), and gives `reference(**how)`: the reference's steps over
the same batches, where `how` names the control's change (`CONTROL`) or
a fault's (`FAULTS`).
"""
from __future__ import annotations

import statistics
from typing import Dict, Optional

from portbench.harness import compare


class Checked:
    # keyword arguments of `reference` that make the control
    CONTROL: Dict[str, object] = {}
    # faults read in the reference put in the program's place
    FAULTS: Dict[str, Dict[str, object]] = {"half": {"half": True}}
    _ref: Optional[dict] = None

    def records(self) -> dict:
        return {"loss": self.losses, "grad": self.grad1, "delta": self.delta}

    def ref(self) -> dict:
        """The reference's steps, computed once."""
        if self._ref is None:
            self._ref = self.reference()
        return self._ref

    def check(self) -> dict:
        return self.numbers(self.ref())

    def numbers(self, ref: dict) -> dict:
        return compare.train_numbers(self.records(), ref)

    def controls(self) -> dict:
        """The control's numbers: the reference a precision below the
        configuration's, in the program's place."""
        return {"control": compare.train_numbers(
            self.reference(**self.CONTROL), self.ref())}

    def faults(self) -> dict:
        """Each fault's numbers, read in the reference put in the
        program's place."""
        return {name: compare.train_numbers(self.reference(**how),
                                            self.ref())
                for name, how in self.FAULTS.items()}

    def look(self) -> dict:
        """Where the gaps come from: each step's loss gap, and the leaves
        with the worst change and gradient gaps."""
        ref = self.ref()
        med = statistics.median(ref["grad"])
        keep = [g >= compare.STILL * med for g in ref["grad"]]
        upd = compare.leaf_gaps(self.delta, ref["delta"], keep)
        grad = compare.leaf_gaps(self.grad1, ref["grad"])
        top = sorted(upd, key=lambda i: -upd[i])[:3]
        return {"loss_steps": [abs(a - b) / abs(b) for a, b in
                               zip(self.losses, ref["loss"])],
                "update_worst": [[self.order[i], upd[i]] for i in top],
                "grad_worst": [self.order[max(grad, key=grad.get)],
                               max(grad.values())]}
