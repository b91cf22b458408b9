"""The float64 arbiter of ``chip_smoke.py``'s generator gradient check and of
the stack backward's accuracy check (``tools/float64_check.py``), on made-up
gradients: the rules pass and raise where they should."""

import numpy as np
import pytest
import torch

from parallelwavegan_torch.tools.float64_check import (
    gradient_gate,
    hold_to_float64,
    rel_err,
)

SHAPES = {"upsample.conv_1.kernel_v": (1, 9), "conv_layers_0.conv.kernel_v":
          (3, 64, 128), "conv_layers_0.conv.bias": (128,),
          "last_conv_1.kernel_g": (1,), "first_conv.kernel_v": (1, 1, 64)}


def _routes(spread: float, seed: int = 0):
    """(p, e, a): plain f32 gradients p, float64 gradients e lying
    ``spread`` allowances from p in every parameter (an unused parameter
    has None in both), and each parameter's allowance a."""
    rng = np.random.default_rng(seed)
    e = {n: torch.from_numpy(rng.standard_normal(s)).double()
         for n, s in SHAPES.items()}
    largest = max(v.abs().max().item() for v in e.values())
    # the allowance of the plain route's gradients (a of the gate), taken
    # on e: the offsets below move p by far less than 2e-3 of its scale
    a = {n: 2e-3 * v.abs().max().item() + 2e-5 * largest
         for n, v in e.items()}
    p = {}
    for n, v in e.items():
        direction = torch.from_numpy(rng.uniform(-1, 1, v.shape))
        direction = direction / direction.abs().max()
        p[n] = (v + spread * a[n] * direction).float()
    p["unused"] = e["unused"] = None
    return p, e, a


@pytest.mark.parametrize("spread", [0.3, 4.0], ids=["inside_a", "past_a"])
def test_gate_passes_when_the_kernels_equal_the_plain_route(spread):
    p, e, _ = _routes(spread)
    k = {n: None if v is None else v.clone() for n, v in p.items()}
    out = gradient_gate(k, p, e)
    assert out["kp"][0] == 0.0 and out["parameters"] == len(SHAPES)
    assert out["gate"][0] <= 0.5 + 1e-6
    assert out["plain_outside"] == (len(SHAPES) if spread > 1 else 0)


@pytest.mark.parametrize("spread", [0.3, 4.0], ids=["inside_a", "past_a"])
def test_gate_passes_when_the_kernels_lie_as_far_from_float64_as_plain(
        spread):
    """k on the other side of e, as far as p: |k - e| = |p - e|."""
    p, e, _ = _routes(spread)
    k = {n: None if v is None else (2 * e[n] - p[n].double()).float()
         for n, v in p.items()}
    out = gradient_gate(k, p, e)
    assert 0.25 < out["gate"][0] <= 0.5 + 1e-4  # k rounded to f32
    assert out["kp"][0] == pytest.approx(2 * out["pe"][0], rel=1e-3)


def test_gate_raises_when_the_kernels_lie_three_times_as_far():
    """k = e + 3 (p - e), with p - e past the allowance."""
    p, e, _ = _routes(4.0)
    k = {n: None if v is None else (e[n] + 3 * (p[n].double() - e[n])).float()
         for n, v in p.items()}
    with pytest.raises(AssertionError, match="generator gradient on"):
        gradient_gate(k, p, e)


@pytest.mark.parametrize("name", ["upsample.conv_1.kernel_v",
                                  "conv_layers_0.conv.bias"])
def test_gate_raises_when_one_parameter_is_off_by_ten_allowances(name):
    p, e, a = _routes(0.3)
    k = {n: None if v is None else v.clone() for n, v in p.items()}
    k[name].view(-1)[0] += 10 * a[name]
    with pytest.raises(AssertionError, match=name):
        gradient_gate(k, p, e)
    k[name].view(-1)[0] -= 10 * a[name]
    assert gradient_gate(k, p, e)["gate"][0] <= 1.0


def test_gate_refuses_a_gradient_missing_from_one_route():
    p, e, _ = _routes(0.3)
    k = dict(p, **{"first_conv.kernel_v": None})
    with pytest.raises(AssertionError, match="missing"):
        gradient_gate(k, p, e)


@pytest.mark.parametrize("factor,raises", [(1.0, False), (1.9, False),
                                           (3.0, True)])
def test_hold_to_float64_allows_twice_the_plain_error(factor, raises):
    rng = np.random.default_rng(1)
    exact = torch.from_numpy(rng.standard_normal((4, 300))) * 3
    noise = torch.from_numpy(rng.uniform(-1, 1, (4, 300))) * 1e-4
    plain = (exact + noise).float()
    kernel = (exact - factor * noise).float()
    if raises:
        with pytest.raises(AssertionError, match="float64"):
            hold_to_float64("dx", kernel, plain, exact)
    else:
        k, p = hold_to_float64("dx", kernel, plain, exact)
        assert k == pytest.approx(factor * p, rel=0.1)
        assert rel_err(plain, exact) == p
