"""A run measures the PyTorch port alone: the JAX package and JAX itself
must not be loaded in the process. Module names are compared by their
top-level part (before the first dot) whole, so `repro_torch` is not
`repro`."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class JaxLoaded(RuntimeError):
    pass


def loaded(modules=None) -> list:
    """The forbidden top-level names present in `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def check(when: str) -> None:
    found = loaded()
    if found:
        raise JaxLoaded(f"{', '.join(found)} loaded in the run ({when})")
