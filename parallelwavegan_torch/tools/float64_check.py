"""Float64 as the arbiter between a kernel route and its plain f32 route.

Both f32 routes, through the hand-written kernels and through their plain
PyTorch versions, sum in their own orders, and both lie some way from the
exact function. Held against each other alone, the distance between two f32
routes says nothing about which is at fault; a third route, the plain one in
float64, decides. Two rules, each raising ``AssertionError``:

``hold_to_float64``
    one output of a kernel lies at most ``factor`` (2) times as far from
    float64 as the plain f32 version's output, max |a - e| / (1 + max |e|)
    (``chip_smoke.py`` holds the stack forward and every output of its
    backward to it at the training shape);
``gradient_gate``
    for every generator parameter, with k, p and e its gradients through the
    kernels, the plain f32 route and the plain float64 route,
    ||k - e||inf <= max(2 ||p - e||inf, a), where a = 2e-3 max |p| + 2e-5 of
    the largest |p| of any parameter is the allowance the kernel route was
    once held to against the plain route alone. The plain f32 route itself
    can lie several allowances from float64 (the STFT loss divides by small
    magnitudes and takes logs), so k - p alone cannot gate. Where each route
    computes the gradient at its own point (its own forward outputs), e is
    float64's gradient at that point, one for k and one for p: the loss's
    curvature then does not turn each route's forward rounding into a
    gradient difference that neither route's backward made.

Pure torch: ``chip_smoke.py`` applies both on the card, the CPU tests hold
the rules themselves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def rel_err(a: torch.Tensor, exact: torch.Tensor) -> float:
    """max |a - exact| / (1 + max |exact|), in float64."""
    e = exact.double()
    return ((a.double() - e).abs().max() / (1 + e.abs().max())).item()


def hold_to_float64(what: str, kernel: torch.Tensor, plain: torch.Tensor,
                    exact: torch.Tensor, factor: float = 2.0) -> tuple:
    """(kernel's, plain's) rel_err against ``exact``; raises when the
    kernel's is more than ``factor`` times the plain version's."""
    if not (torch.isfinite(kernel).all() and torch.isfinite(plain).all()):
        raise AssertionError(f"{what}: non-finite values")
    k, p = rel_err(kernel, exact), rel_err(plain, exact)
    if not k <= factor * p:
        raise AssertionError(
            f"{what}: the kernel lies {k:.3e} (of 1 + max) from float64, "
            f"more than {factor} x the plain version's {p:.3e}")
    return k, p


def _inf_norm(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> float:
    a = a.double()
    return (a if b is None else a - b.double()).abs().max().item()


def gradient_gate(grads_k: Dict[str, Optional[torch.Tensor]],
                  grads_p: Dict[str, Optional[torch.Tensor]],
                  grads_e: Dict[str, Optional[torch.Tensor]],
                  what: str = "generator gradient",
                  grads_e_p: Optional[Dict[str, Optional[torch.Tensor]]] = None
                  ) -> dict:
    """Apply the gradient rule of the module docstring to every parameter
    (name -> gradient; None where the loss does not reach it, in all three).
    ``grads_e_p`` is float64's gradient at the plain route's point where it
    differs from the kernel route's (``grads_e``); by default ``grads_e``.

    Returns the worst ratios with the parameter each is on: ``kp``
    (||k - p|| / a, reported, not a gate), ``pe`` (||p - e|| / a) with
    ``plain_outside`` (how many parameters the plain f32 route puts outside
    a), ``ke`` (||k - e|| / a) and ``gate`` (||k - e|| / max(2 ||p - e||,
    a), which must stay <= 1). Raises AssertionError on the first
    parameter past it, naming ``what``."""
    grads_e_p = grads_e if grads_e_p is None else grads_e_p
    present = [n for n, g in grads_p.items() if g is not None]
    for name in grads_p:
        if (grads_k[name] is None, grads_e[name] is None,
                grads_e_p[name] is None) != (grads_p[name] is None,) * 3:
            raise AssertionError(f"{name}: a gradient is missing from one "
                                 f"route only")
    largest = max(_inf_norm(grads_p[n]) for n in present)
    out = {"kp": (0.0, None), "pe": (0.0, None), "ke": (0.0, None),
           "gate": (0.0, None), "plain_outside": 0,
           "parameters": len(present)}
    for name in present:
        k, p, e = grads_k[name], grads_p[name], grads_e[name]
        a = 2e-3 * _inf_norm(p) + 2e-5 * largest
        kp, pe, ke = (_inf_norm(k, p), _inf_norm(p, grads_e_p[name]),
                      _inf_norm(k, e))
        gate = ke / max(2 * pe, a)
        for key, ratio in (("kp", kp / a), ("pe", pe / a), ("ke", ke / a),
                           ("gate", gate)):
            if ratio > out[key][0]:
                out[key] = (ratio, name)
        out["plain_outside"] += pe > a
        if not gate <= 1.0:
            raise AssertionError(
                f"{what} on {name}: the kernels lie {ke:.3e} "
                f"from float64, past max(2 x the plain route's {pe:.3e}, "
                f"the allowance {a:.3e})")
    return out
