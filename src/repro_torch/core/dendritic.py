"""Dendritic nonlinearities f() applied to per-crossbar partial sums.

Port of repro.core.dendritic. Paper (CADC, Sec. III-A): f(x) = 0 for
x <= 0, f(x) = g(x) for x > 0 with g in {ReLU(x), sqrt(x) (sublinear),
k*x^2 (supralinear), tanh(x)}.

Every fn is written as a `where` on x > 0, so f'(0) = 0 — the subgradient
convention of the kernels' saved gate (relu's gate is the indicator
p > 0, so an exact-zero psum passes no gradient). Each registered
nonlinearity carries its derivative f'() (`grad(name)`): the serve
telemetry uses it to count the psums the dendritic gate switches off, and
the CADC kernels' backward multiplies the cotangent by it per segment.
`gate_dtype(name)` is the narrowest storage of that gate (torch.bool for
relu's indicator, None for identity — nothing to save — and float32 for
curved fns); `gate_packing(name)` marks indicator gates the kernels may
bit-pack into uint32 words. The five built-in fns have ids in the CUDA
kernels (kernels/cadc_matmul.py FN_IDS); a fn added with `register()`
runs on the plain path only.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

Tensor = torch.Tensor

# Default supralinear curvature (the paper leaves k free).
SUPRALINEAR_K = 1.0
_SQRT_EPS = 1e-12


def identity(x: Tensor) -> Tensor:
    """vConv: no dendritic nonlinearity (plain psum accumulation)."""
    return x


def relu(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, torch.zeros_like(x))


def _sqrt(x: Tensor) -> Tensor:
    """The correctly rounded square root, as IEEE sqrt in XLA and CUDA.
    torch's vectorized float32 sqrt on the CPU is not correctly rounded
    (it misses by an ulp on ~1% of inputs), so CPU tensors take the root
    in float64, which rounds back to the correctly rounded float32."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def sublinear(x: Tensor) -> Tensor:
    """f(x) = sqrt(x + eps) for x > 0 else 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, _sqrt(safe + _SQRT_EPS), torch.zeros_like(x))


def supralinear(x: Tensor, k: float = SUPRALINEAR_K) -> Tensor:
    """f(x) = k * x^2 for x > 0 else 0."""
    return torch.where(x > 0, k * torch.square(x), torch.zeros_like(x))


def tanh(x: Tensor) -> Tensor:
    """f(x) = tanh(x) for x > 0 else 0."""
    return torch.where(x > 0, torch.tanh(x), torch.zeros_like(x))


DENDRITIC_FNS: Dict[str, Callable[[Tensor], Tensor]] = {
    "identity": identity,  # == vConv
    "relu": relu,
    "sublinear": sublinear,
    "supralinear": supralinear,
    "tanh": tanh,
}


def identity_grad(x: Tensor) -> Tensor:
    return torch.ones_like(x)


def relu_grad(x: Tensor) -> Tensor:
    """Indicator x > 0."""
    return (x > 0).to(x.dtype)


def sublinear_grad(x: Tensor) -> Tensor:
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, 0.5 / _sqrt(safe + _SQRT_EPS),
                       torch.zeros_like(x))


def supralinear_grad(x: Tensor, k: float = SUPRALINEAR_K) -> Tensor:
    return torch.where(x > 0, 2.0 * k * x, torch.zeros_like(x))


def tanh_grad(x: Tensor) -> Tensor:
    t = torch.tanh(x)
    return torch.where(x > 0, 1.0 - t * t, torch.zeros_like(x))


DENDRITIC_GRADS: Dict[str, Callable[[Tensor], Tensor]] = {
    "identity": identity_grad,
    "relu": relu_grad,
    "sublinear": sublinear_grad,
    "supralinear": supralinear_grad,
    "tanh": tanh_grad,
}


# Narrowest dtype that represents f'(psum) exactly. None => the gate is
# constant 1 and the backward saves and applies nothing.
GATE_DTYPES: Dict[str, Optional[torch.dtype]] = {
    "identity": None,
    "relu": torch.bool,
    "sublinear": torch.float32,
    "supralinear": torch.float32,
    "tanh": torch.float32,
}

# Whether f'(psum) is a {0,1} indicator that the kernels may pack 32 to a
# uint32 word (bit b of word w = column 32w + b).
GATE_PACKING: Dict[str, bool] = {
    "identity": False,
    "relu": True,
    "sublinear": False,
    "supralinear": False,
    "tanh": False,
}


def get(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return DENDRITIC_FNS[name]
    except KeyError:
        raise ValueError(
            f"unknown dendritic fn {name!r}; choose from {sorted(DENDRITIC_FNS)}"
        ) from None


def grad(name: str) -> Callable[[Tensor], Tensor]:
    """f'() for a registered nonlinearity (raises for unregistered names)."""
    get(name)  # uniform unknown-name error
    try:
        return DENDRITIC_GRADS[name]
    except KeyError:
        raise ValueError(
            f"dendritic fn {name!r} has no registered derivative; pass "
            f"grad_fn= to dendritic.register()"
        ) from None


def gate_dtype(name: str) -> Optional[torch.dtype]:
    """Storage dtype of f'(psum) for the kernels' backward (None => no
    gate). Raises for fns without a registered derivative, as grad()."""
    get(name)
    try:
        return GATE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dendritic fn {name!r} has no registered derivative; pass "
            f"grad_fn= to dendritic.register()"
        ) from None


def gate_packing(name: str) -> bool:
    """True when f'(psum) is a {0,1} indicator the kernels may bit-pack.
    Never raises for a fn registered without a derivative: packing is
    simply off."""
    get(name)
    return GATE_PACKING.get(name, False)


# Called with the fn name on every (re-)registration, so a module that
# caches per fn name can drop what it cached.
_REGISTER_HOOKS: List[Callable[[str], None]] = []


def on_register(hook: Callable[[str], None]) -> None:
    _REGISTER_HOOKS.append(hook)


def register(name: str, fn: Callable[[Tensor], Tensor],
             grad_fn: Optional[Callable[[Tensor], Tensor]] = None, *,
             gate: Optional[torch.dtype] = torch.float32,
             gate_packing: bool = False) -> None:
    """Register a dendritic f() (and optionally f') under `name`.

    With grad_fn, the kernels' backward differentiates through the new fn
    on the plain path (the CUDA kernels take only the built-in fns).
    gate_packing=True opts the fn into bit-packed gates — valid only when
    grad_fn returns exact {0, 1} indicators."""
    DENDRITIC_FNS[name] = fn
    if grad_fn is not None:
        if gate is None:
            raise ValueError(
                "gate=None is reserved for identity-like fns; pass a dtype "
                "(e.g. torch.float32, or torch.bool for indicator "
                "derivatives)")
        DENDRITIC_GRADS[name] = grad_fn
        GATE_DTYPES[name] = gate
        GATE_PACKING[name] = bool(gate_packing)
    else:
        if gate_packing:
            raise ValueError("gate_packing requires a grad_fn")
        DENDRITIC_GRADS.pop(name, None)
        GATE_DTYPES.pop(name, None)
        GATE_PACKING.pop(name, None)
    for hook in _REGISTER_HOOKS:
        hook(name)
