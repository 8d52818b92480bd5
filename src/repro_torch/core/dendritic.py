"""Dendritic nonlinearities f() applied to per-crossbar partial sums.

Port of repro.core.dendritic. Paper (CADC, Sec. III-A): f(x) = 0 for
x <= 0, f(x) = g(x) for x > 0 with g in {ReLU(x), sqrt(x) (sublinear),
k*x^2 (supralinear), tanh(x)}.

Every fn is written as a `where` on x > 0, so f'(0) = 0 — the subgradient
convention of the JAX kernels' saved gate. Each registered nonlinearity
carries its derivative f'() (`grad(name)`); the serve telemetry uses it to
count the psums the dendritic gate switches off. The five built-in fns
have ids in the CUDA CADC-matmul kernel (kernels/cadc_matmul.py FN_IDS);
a fn added with `register()` runs on the plain path only.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

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


def sublinear(x: Tensor) -> Tensor:
    """f(x) = sqrt(x + eps) for x > 0 else 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe + _SQRT_EPS), torch.zeros_like(x))


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
    return torch.where(x > 0, 0.5 / torch.sqrt(safe + _SQRT_EPS),
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


def register(name: str, fn: Callable[[Tensor], Tensor],
             grad_fn: Optional[Callable[[Tensor], Tensor]] = None) -> None:
    """Register a dendritic f() (and optionally f') under `name`."""
    DENDRITIC_FNS[name] = fn
    if grad_fn is not None:
        DENDRITIC_GRADS[name] = grad_fn
    else:
        DENDRITIC_GRADS.pop(name, None)
