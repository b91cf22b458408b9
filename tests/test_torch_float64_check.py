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


@pytest.mark.parametrize("own_point", [True, False],
                         ids=["each_its_own_point", "float64s_point"])
def test_gate_holds_each_route_to_float64_at_its_own_point(own_point):
    """k computed at another point than p, whose float64 gradient lies 10
    allowances from p's (a loss's curvature times the routes' forward
    rounding), and k as far from it as p from its own: held each to its
    own point the routes pass; held to p's point k fails."""
    p, e, a = _routes(0.3)
    e_k = {n: None if v is None else v + 10 * a[n] for n, v in e.items()}
    k = {n: None if v is None else (e_k[n] + p[n].double() - e[n]).float()
         for n, v in p.items()}
    if own_point:
        out = gradient_gate(k, p, e_k, grads_e_p=e)
        assert out["gate"][0] <= 0.5 + 1e-4
        assert out["ke"][0] == pytest.approx(out["pe"][0], rel=1e-3)
    else:
        with pytest.raises(AssertionError, match="generator gradient on"):
            gradient_gate(k, p, e)


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


def test_gate_decides_discriminator_kinks_by_float64():
    """chip_smoke's gate takes each discriminator LeakyReLU's branch from
    the first route that reaches the call (float64): on that route the
    module computes what it computes alone; on another route an input that
    its own rounding put on the other side of 0 takes the decided slope;
    each call of a term is keyed by its order, and the module's own
    activations come back after."""
    import chip_smoke
    from parallelwavegan_torch.models import HiFiGANPeriodDiscriminator

    dis = HiFiGANPeriodDiscriminator(period=2, channels=4, kernel_sizes=(3, 3),
                                     downsample_scales=(2, 1),
                                     max_downsample_channels=8,
                                     generator=torch.Generator().manual_seed(0))
    own = [m.act for m in dis.modules() if hasattr(m, "act")]
    x = torch.randn((1, 64, 1), generator=torch.Generator().manual_seed(1))
    want = dis(x)
    decided = {}
    first = chip_smoke._DecidedDiscriminator(dis, decided)
    got = first.at("adversarial")(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert list(decided) == [("adversarial", 0)]
    assert len(decided[("adversarial", 0)]) == 2  # two convs, two acts
    first.restore()
    assert [m.act for m in dis.modules() if hasattr(m, "act")] == own
    # another route: the first conv's outputs flipped in sign take the
    # decided slope, so its first activation equals the deciding route's
    # negated; the second call of the term is a new key
    other = chip_smoke._DecidedDiscriminator(dis, decided)
    conv = dis.convs[0]
    h = conv(x.reshape(1, 32, 2, 1))
    mask = decided[("adversarial", 0)][0]
    act = [m.act for m in dis.modules() if hasattr(m, "act")][0]
    other.state.update(key=("adversarial", 0), i=0)
    np.testing.assert_allclose(act(-h).detach().numpy(),
                               -torch.where(mask, h, 0.1 * h).detach().numpy(),
                               rtol=1e-6)
    call = other.at("feature matching")
    call(x)
    call(2 * x)
    assert ("feature matching", 1) in decided
    other.restore()
    assert [m.act for m in dis.modules() if hasattr(m, "act")] == own


@pytest.mark.parametrize("slope", [0.1, 0.0], ids=["leaky_relu", "relu"])
def test_gate_decides_generator_kinks_by_float64(slope):
    """chip_smoke's gate takes the branches of G's LeakyReLUs and ReLUs
    from float64 as it takes D's (ROADMAP C-4): a pre-activation that f32
    rounds to 0 (1 + 2^-24 x 0.75 - 1, summed in order) takes the negative
    slope on the f32 routes alone, which scales their gradient of the
    first weights by the slope; decided by float64, every route takes its
    slope, and G's own activation comes back after."""
    from functools import partial

    import chip_smoke
    import torch.nn.functional as F
    from torch import nn

    class Tiny(nn.Module):
        def __init__(self):
            super().__init__()
            self.w1 = nn.Parameter(torch.ones(3))
            self.w2 = nn.Parameter(torch.full((1,), 2.0))
            self.act = (partial(F.leaky_relu, negative_slope=slope)
                        if slope else F.relu)

        def forward(self, x):
            pre = x[..., 0] * self.w1[0] + x[..., 1] * self.w1[1] \
                + x[..., 2] * self.w1[2]
            return (self.act(pre)[..., None] * self.w2,)

    class Critic(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(1))

        def forward(self, y):
            return (y * self.w).sum()

    gen, dis = Tiny(), Critic()
    own = gen.act
    x = torch.tensor([[[1.0, 0.75 * 2.0 ** -24, -1.0]]])
    b = {"x": x, "y": torch.zeros(1, 1, 1)}
    routes = chip_smoke.gate_routes(gen, dis, b)
    # undecided, f32 and float64 part at the kink
    for r, taken in (("p", slope), ("e", 1.0)):
        g, _, rb = routes[r]
        grad = torch.autograd.grad(g(rb["x"])[0].sum(), g.w1)[0]
        torch.testing.assert_close(grad.double(), taken * 2.0 * rb["x"][
            0, 0].double(), rtol=1e-6, atol=0)
    got = chip_smoke.gate_gradients(
        routes, lambda g, rb: g(rb["x"]),
        {"sum": lambda outs, d, rb, kinks: outs[0].sum()},
        lambda outs, d, rb: d(outs[0]))
    for r in "kp":
        torch.testing.assert_close(got[r]["own"]["w1"].double(),
                                   got["e"]["own"]["w1"], rtol=1e-6, atol=0)
        torch.testing.assert_close(got[r]["held"]["w1"].double(),
                                   got["e"]["held"]["w1"], rtol=1e-6, atol=0)
    assert gen.act is own
    assert all(getattr(g.act, "func", g.act) is getattr(own, "func", own)
               for g, _, _ in routes.values())


def test_pwg_gate_decides_kinks_and_branches_by_float64(monkeypatch):
    """chip_smoke's step 6 gate (PWG v1) on gate_gradients: the STFT loss's
    kinks, G's two tail ReLUs (the generator's ``act``) and D's
    LeakyReLUs are decided by float64 and handed to every route, each
    gate_window is its own pair of windows and offset of the loader's
    batch, and hold_gate passes; narrow widths, 2,048-sample windows, the
    recipe's losses, all routes on the CPU."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "GATE_SAMPLES", 2048)
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.criterion import build_criterion

    config = dict(chip_smoke.PWG_V1)
    config["generator_params"] = dict(
        config["generator_params"], layers=3, stacks=3, residual_channels=8,
        gate_channels=16, skip_channels=8)
    config["discriminator_params"] = dict(
        config["discriminator_params"], layers=3, conv_channels=8)
    _, gen, dis, _, _ = init_train_state(config, 0, "cpu")
    g = torch.Generator().manual_seed(2)
    B, T = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SAMPLES
    frames = T // chip_smoke.HOP + 4
    batch = {"y": 0.1 * torch.randn((B, T, 1), generator=g),
             "z": torch.randn((B, T, 1), generator=g),
             "c": torch.randn((B, frames, 80), generator=g)}
    windows = [chip_smoke.gate_window(batch, n) for n in range(3)]
    assert all(w["y"].shape == (chip_smoke.GATE_BATCH,
                                chip_smoke.GATE_SAMPLES, 1) for w in windows)
    assert not torch.equal(windows[0]["y"], windows[1]["y"])
    routes = chip_smoke.gate_routes(gen, dis, windows[1])
    decided = []
    real = chip_smoke._DecidedDiscriminator.__init__

    def spy(self, module, table):
        real(self, module, table)
        decided.append((module, table))

    chip_smoke._DecidedDiscriminator.__init__ = spy
    try:
        got = chip_smoke.gate_gradients(
            routes, *chip_smoke.pwg_gate_losses(build_criterion(config)))
    finally:
        chip_smoke._DecidedDiscriminator.__init__ = real
    table = decided[0][1]
    assert len(table[("generator",)]) == 2  # the tail's two ReLUs
    assert any(key[0] in ("adversarial", "d_loss") for key in table
               if key != ("generator",))
    assert gen.act is torch.nn.functional.relu
    gate = chip_smoke.hold_gate("pwg small", got, chip_smoke.GATE_SAMPLES,
                                chip_smoke.GATE_BATCH)
    assert set(gate) == {"own_gate", "cot_gate", "held_gate", "d_gate"}
